"""Kernel 2, the affine quantizer, on the CPU: its plain version
(``kernels/quantize/ref.py``) and the port's ``core.quantization.quantize``
against the JAX reference, bit for bit; the wrapper's dim merging, which
decides what the CUDA kernel indexes; and, on a card, the kernel against
its plain version (marked ``cuda``).

Every comparison is bitwise: the quantizer is a correctly rounded divide,
a separately rounded add, round-half-to-even and a clamp, in float32 in
both packages. The inputs put values on the .5 boundaries of the code grid
(exact multiples of the scale by k + 0.5), past both clip edges, and at 0.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import QParams, quantize  # noqa: E402
from repro_torch.kernels.quantize import ops  # noqa: E402
from repro_torch.kernels.quantize.ref import quantize_ref  # noqa: E402
from test_torch_parity import load_reference  # noqa: E402


@pytest.fixture(scope="module")
def ref():
    load_reference()
    import repro.core.quantization as jq
    import repro.kernels.quantize.ops as jops
    import repro.kernels.quantize.ref as jref
    return jq, jops, jref


@pytest.fixture
def cuda():
    """Skips the test unless a CUDA device is present (decided at run
    time, never at collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU has only the plain version")
    return torch.device("cuda")


def _values(rng, shape, scale) -> np.ndarray:
    """float32 values in ``shape`` around the code grid of ``scale``
    (broadcast against ``shape``): a third on half-code boundaries
    ``(k + 0.5) * s``, a few far past +-clip, the rest normal."""
    s = np.broadcast_to(np.asarray(scale, np.float32), shape)
    x = rng.normal(size=shape).astype(np.float32) * 60 * s
    half = rng.integers(-140, 140, shape).astype(np.float32) + 0.5
    pick = rng.random(shape)
    x = np.where(pick < 0.33, half * s, x)
    x = np.where(pick > 0.97, np.sign(x) * 500 * s, x)
    return np.where(pick > 0.995, 0.0, x).astype(np.float32)


def _bf16(a: np.ndarray):
    """``a`` rounded to bfloat16: (numpy float32 of the rounded values,
    the torch bfloat16 tensor)."""
    t = torch.from_numpy(a).to(torch.bfloat16)
    return t.float().numpy(), t


# per-channel forms the port quantizes every call: (x shape, scale shape,
# the reference's QParams axis)
FORMS = {
    "dense (K, N), axis 1": ((48, 40), (40,), 1),
    "conv (Cout, C, kh, kw), axis 0": ((8, 6, 3, 3), (8,), 0),
    "grouped (E, K, N), (E, 1, N)": ((5, 24, 16), (5, 1, 16), None),
}


@pytest.mark.parametrize("n", [1, 1000, 1024, 3001])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_per_tensor_matches_reference_kernel(ref, n, dtype):
    """Per tensor, any length (the reference pads to blocks of 1024):
    the plain version equals ``quantize_ref`` and the interpret-mode
    Pallas kernel through ``quantize_op``, bit for bit."""
    import jax.numpy as jnp
    _, jops, jref = ref
    rng = np.random.default_rng(n)
    scale, zp = np.float32(0.0173), np.float32(3.0)
    x = _values(rng, (n,), scale)
    if dtype == "bfloat16":
        x, xt = _bf16(x)
        xj = jnp.asarray(x).astype(jnp.bfloat16)
    else:
        xt, xj = torch.from_numpy(x), jnp.asarray(x)
    got = quantize_ref(xt, torch.tensor(scale), torch.tensor(zp)).numpy()
    for want in (jref.quantize_ref(xj, jnp.float32(scale), jnp.float32(zp)),
                 jops.quantize_op(xj, scale, zp, interpret=True)):
        assert np.array_equal(got, np.asarray(want))
    if n > 1:                       # both clip edges were reached
        assert got.min() == -128 and got.max() == 127


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_per_channel_matches_reference(ref, form, dtype):
    """The three broadcast forms, with a nonzero per-channel zero point
    where the reference has an axis: the port's ``quantize`` equals
    ``repro.core.quantization.quantize``, bit for bit."""
    import jax.numpy as jnp
    jq = ref[0]
    shape, sshape, axis = FORMS[form]
    rng = np.random.default_rng(len(shape))
    scale = (rng.random(sshape) * 0.05 + 1e-3).astype(np.float32)
    sb = scale if axis is None else scale.reshape(
        [-1 if d == axis else 1 for d in range(len(shape))])
    x = _values(rng, shape, sb)
    if axis is None:
        zp = np.zeros((), np.float32)
    else:
        zp = rng.integers(-4, 5, sshape).astype(np.float32)
    if dtype == "bfloat16":
        x, xt = _bf16(x)
        xj = jnp.asarray(x).astype(jnp.bfloat16)
    else:
        xt, xj = torch.from_numpy(x), jnp.asarray(x)
    want = jq.quantize(xj, jq.QParams(scale=jnp.asarray(scale),
                                      zero_point=jnp.asarray(zp), bits=8,
                                      axis=axis))
    got = quantize(xt, QParams(scale=torch.from_numpy(scale),
                               zero_point=torch.from_numpy(zp), bits=8,
                               axis=axis))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


def _as_the_kernel_reads(x, s, z):
    """The quantizer computed through the wrapper's merged geometry: each
    operand read from its storage at the offsets the kernel computes from
    ``merged_dims`` (row-major over the merged sizes, outermost first)."""
    shape = tuple(x.shape)
    dims = ops.merged_dims(shape, x.stride(), s.expand(shape).stride(),
                           z.expand(shape).stride())
    sizes = [d[0] for d in dims] or [1]
    idx = np.indices(sizes).reshape(len(sizes), -1)
    vals = []
    for i, t in enumerate((x, s, z)):
        st = np.array([d[1][i] for d in dims] or [0])
        storage = torch.as_strided(
            t, (t.untyped_storage().nbytes() // t.element_size(),), (1,), 0)
        off = t.storage_offset() + (st[:, None] * idx).sum(0)
        vals.append(storage[torch.from_numpy(off)])
    return quantize_ref(*vals).reshape(shape)


@pytest.mark.parametrize("case", ["per tensor", "dense axis 1", "conv axis 0",
                                  "grouped", "transposed x", "sliced x"])
def test_merged_geometry_reads_the_right_elements(case):
    """What the CUDA kernel indexes is decided here, in Python: reading
    every operand at the merged offsets gives the plain quantizer's codes,
    and the forms the port uses merge to few dims (no copy of the scale,
    zero point or a strided ``x``)."""
    g = torch.Generator().manual_seed(3)
    base = torch.randn((12, 10, 8), generator=g) * 3
    zero = torch.tensor(0.0)
    if case == "per tensor":
        x, s, z, rank = base, torch.tensor(0.02), torch.tensor(1.0), 1
    elif case == "dense axis 1":
        x = base.reshape(120, 8)
        s, z, rank = torch.rand(8, generator=g)[None] * 0.05, zero, 2
    elif case == "conv axis 0":
        x = base.reshape(12, 10, 2, 4)
        s = (torch.rand(12, generator=g) * 0.05).reshape(12, 1, 1, 1)
        z, rank = torch.arange(12.0).reshape(12, 1, 1, 1), 2
    elif case == "grouped":
        x = base
        s, z, rank = torch.rand((12, 1, 8), generator=g) * 0.05, zero, 3
    elif case == "transposed x":
        x = base.reshape(120, 8).t()
        s, z, rank = torch.rand((8, 1), generator=g) * 0.05, zero, 2
    else:
        x = base[:, 2:7, ::2]
        s, z, rank = torch.tensor(0.03), zero, 2   # (12, 20), stride 2
    shape = tuple(x.shape)
    dims = ops.merged_dims(shape, x.stride(), s.expand(shape).stride(),
                           z.expand(shape).stride())
    assert len(dims) == rank
    assert torch.equal(_as_the_kernel_reads(x, s, z),
                       quantize_ref(x, s, z))


def test_cpu_takes_the_plain_version_and_counts_nothing():
    x = torch.randn(100)
    before = ops.quantize.launches
    got = ops.quantize(x, torch.tensor(0.01), torch.tensor(0.0))
    assert torch.equal(got, quantize_ref(x, 0.01, 0.0))
    assert ops.quantize.launches == before


@pytest.mark.cuda
def test_cuda_quantize_matches_plain_version(cuda):
    """Kernel 2 against its plain version on the card, bit for bit, in each
    broadcast form and dtype, with a strided operand."""
    rng = np.random.default_rng(5)
    for shape, sshape, axis in FORMS.values():
        scale = (rng.random(sshape) * 0.05 + 1e-3).astype(np.float32)
        sb = scale if axis is None else scale.reshape(
            [-1 if d == axis else 1 for d in range(len(shape))])
        x = torch.from_numpy(_values(rng, shape, sb)).to(cuda)
        s = torch.from_numpy(sb).to(cuda)
        z = torch.full_like(s, 2.0)
        for xt in (x, x.to(torch.bfloat16), x.transpose(0, -1)):
            sx = s if xt.shape == x.shape else s.transpose(0, -1)
            zx = z if xt.shape == x.shape else z.transpose(0, -1)
            before = ops.quantize.launches
            got = ops.quantize(xt, sx, zx)
            torch.cuda.synchronize()
            assert ops.quantize.launches == before + 1
            assert torch.equal(got, quantize_ref(xt, sx, zx))
    with pytest.raises(ValueError):
        ops.quantize(torch.zeros(4, dtype=torch.float16, device=cuda),
                     torch.tensor(1.0, device=cuda),
                     torch.tensor(0.0, device=cuda))

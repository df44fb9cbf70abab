"""Each kernel module of the port against the JAX reference on the CPU.

On a CPU tensor a wrapper runs its kernel's plain PyTorch version, so these
tests hold that version (and the wrapper's shape handling) against the
reference's Pallas kernel in interpret mode, bitwise: K not a multiple of
128, N below 128, stride 2, 1x1 VALID, dilation, channel counts that are not
multiples of 32, and the raw int32 accumulator (``emit_acc``). The CUDA
kernels themselves are held against the same plain versions by the tests
marked ``cuda`` (skipped without a card) and by ``chip_smoke.py``.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (ApproxConfig, acu_operand, build_lut,  # noqa: E402
                              get_multiplier, make_acu, quantize,
                              symmetric_qparams)
from repro_torch.core.acu import resolve_conv_padding  # noqa: E402
from repro_torch.kernels import runtime  # noqa: E402
from repro_torch.kernels.fused_lut_conv.ops import fused_lut_conv  # noqa: E402
from repro_torch.kernels.fused_lut_conv.ref import fused_lut_conv_ref  # noqa: E402
from repro_torch.kernels.fused_lut_dense.ops import fused_lut_dense  # noqa: E402
from repro_torch.kernels.fused_lut_dense.ref import fused_lut_dense_ref  # noqa: E402
from repro_torch.kernels.lut_matmul.ops import lut_matmul  # noqa: E402
from repro_torch.kernels.lut_matmul.ref import lut_matmul_ref  # noqa: E402
from test_torch_parity import load_reference  # noqa: E402

MULT = "mul8s_1L2H"
LUT = build_lut(get_multiplier(MULT))
OFF = 128


@pytest.fixture(scope="module")
def ref():
    load_reference()
    import repro.kernels.fused_lut_conv.ops as conv_ops
    import repro.kernels.fused_lut_dense.ops as dense_ops
    import repro.kernels.lut_matmul.ops as mm_ops
    return mm_ops, dense_ops, conv_ops


@pytest.fixture
def cuda():
    """Skips the test unless a CUDA device is present (decided at run
    time, never at collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU has only the plain versions")
    return torch.device("cuda")


def _codes(rng, shape):
    return rng.integers(-128, 128, shape).astype(np.int32)


@pytest.mark.parametrize("mkn", [(5, 27, 16), (40, 144, 10), (7, 130, 33)])
def test_lut_matmul_matches_reference(ref, mkn):
    import jax.numpy as jnp
    m, k, n = mkn
    rng = np.random.default_rng(m)
    a, w = _codes(rng, (m, k)), _codes(rng, (k, n))
    want = np.asarray(ref[0].lut_matmul(jnp.asarray(a), jnp.asarray(w),
                                        jnp.asarray(LUT), OFF))
    got = lut_matmul(torch.from_numpy(a), torch.from_numpy(w),
                     torch.from_numpy(LUT), OFF)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    # chunking over rows and K is invisible in the int32 sum
    tiny = lut_matmul_ref(torch.from_numpy(a), torch.from_numpy(w),
                          torch.from_numpy(LUT).reshape(-1), OFF, 256,
                          k_chunk=3)
    assert np.array_equal(tiny.numpy(), want)


@pytest.mark.parametrize("mkn", [(6, 27, 16), (33, 64, 10), (4, 200, 130)])
@pytest.mark.parametrize("emit_acc", [False, True])
def test_fused_lut_dense_matches_reference(ref, mkn, emit_acc):
    import jax.numpy as jnp
    m, k, n = mkn
    rng = np.random.default_rng(k)
    x = (rng.normal(size=(m, k)) * 2).astype(np.float32)
    wq = _codes(rng, (k, n))
    xs = np.float32(np.abs(x).max() / 127)
    ws = rng.uniform(0.01, 0.1, n).astype(np.float32)
    want = np.asarray(ref[1].fused_lut_dense(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(LUT), OFF, xs,
        np.float32(0), jnp.asarray(ws), emit_acc=emit_acc))
    got = fused_lut_dense(torch.from_numpy(x), torch.from_numpy(wq),
                          torch.from_numpy(LUT), OFF, torch.tensor(xs),
                          torch.tensor(0.0), torch.from_numpy(ws),
                          emit_acc=emit_acc)
    assert np.array_equal(got.numpy(), want)


CONV_GEOMS = [  # (x_shape, w_shape, stride, padding, dilation)
    ((2, 3, 8, 8), (5, 3, 3, 3), (1, 1), "SAME", (1, 1)),      # stem-like
    ((1, 6, 9, 9), (4, 6, 3, 3), (2, 2), "SAME", (1, 1)),      # stride 2
    ((2, 5, 8, 8), (7, 5, 1, 1), (2, 2), "VALID", (1, 1)),     # 1x1 shortcut
    ((1, 40, 6, 6), (3, 40, 3, 3), (1, 1), "SAME", (1, 1)),    # C=40
    ((1, 4, 10, 10), (6, 4, 3, 3), (1, 1), "SAME", (2, 2)),    # dilation 2
]


@pytest.mark.parametrize("geom", CONV_GEOMS,
                         ids=["stem", "stride2", "shortcut1x1", "c40",
                              "dilation2"])
def test_fused_lut_conv_matches_reference(ref, geom):
    import jax.numpy as jnp
    xs_, ws_, stride, padding, dilation = geom
    rng = np.random.default_rng(sum(xs_))
    x = rng.normal(size=xs_).astype(np.float32)
    w = rng.normal(size=ws_).astype(np.float32)
    xqp = symmetric_qparams(torch.tensor(np.abs(x).max()), 8)
    wqp = symmetric_qparams(torch.from_numpy(np.abs(w).max(axis=(1, 2, 3))),
                            8, axis=0)
    wq = acu_operand(quantize(torch.from_numpy(w), wqp), wqp)
    pad = resolve_conv_padding(padding, xs_, ws_, stride, dilation)
    args = (xqp.scale.numpy(), np.float32(0), wqp.scale.numpy())
    for emit_acc in (False, True):
        want = np.asarray(ref[2].fused_lut_conv(
            jnp.asarray(x), jnp.asarray(wq.numpy()), jnp.asarray(LUT), OFF,
            *args, stride=stride, padding=pad, dilation=dilation,
            emit_acc=emit_acc))
        got = fused_lut_conv(torch.from_numpy(x), wq, torch.from_numpy(LUT),
                             OFF, xqp.scale, torch.tensor(0.0), wqp.scale,
                             stride=stride, padding=pad, dilation=dilation,
                             emit_acc=emit_acc)
        assert got.shape == want.shape
        assert np.array_equal(got.numpy(), want), emit_acc


def test_conv_geometry_helpers_match_reference(ref):
    from repro_torch.kernels.fused_lut_conv.ops import (conv_out_size,
                                                        conv_padded_geometry)
    for args in [(32, 3, 1, 1, (1, 1)), (32, 3, 2, 1, (0, 1)),
                 (16, 1, 2, 1, (0, 0)), (10, 3, 1, 2, (2, 2))]:
        assert conv_out_size(*args) == ref[2].conv_out_size(*args)
    g = (13, 11, 3, 3, 2, 1, 1, 2, ((1, 1), (2, 2)), 4)
    assert conv_padded_geometry(*g) == ref[2].conv_padded_geometry(*g)


# ---------------------------------------------------------------------------
# build helpers (CPU) and the CUDA kernels against their plain versions
# ---------------------------------------------------------------------------

def test_source_hash_tracks_sources_and_headers(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text("// a")
    (tmp_path / "h.cuh").write_text("// h")
    monkeypatch.setattr(runtime, "CSRC", tmp_path)
    h0 = runtime.source_hash("k")
    (tmp_path / "h.cuh").write_text("// h2")
    h1 = runtime.source_hash("k")
    (tmp_path / "k.cu").write_text("// b")
    assert len({h0, h1, runtime.source_hash("k")}) == 3
    assert runtime.library_path("k").name == f"k-{runtime.source_hash('k')}.so"


def test_every_kernel_source_has_a_signature():
    names = {p.stem for p in runtime.CSRC.glob("*.cu")}
    assert names == set(runtime.SIGNATURES) == {
        "lut_matmul", "fused_lut_dense", "fused_lut_conv"}


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        runtime.nvcc_path()


def test_cpu_tensors_never_launch():
    before = (lut_matmul.launches, fused_lut_dense.launches,
              fused_lut_conv.launches)
    cfg = ApproxConfig(acu=make_acu(MULT, "lut", use_kernels=True,
                                    fused=True))
    from repro_torch.core import conv2d
    with torch.inference_mode():
        conv2d(torch.randn(1, 3, 6, 6), torch.randn(4, 3, 3, 3), cfg=cfg)
    assert (lut_matmul.launches, fused_lut_dense.launches,
            fused_lut_conv.launches) == before


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions(cuda):
    """On a card: each kernel launches (its counter rises) and equals its
    plain version bitwise, f32 and int32 outputs."""
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    l16 = runtime.lut_to_int16(torch.from_numpy(LUT)).to(cuda)
    l32 = torch.from_numpy(LUT).reshape(-1).to(cuda)
    a = torch.randint(-128, 128, (300, 27), generator=g, device=cuda,
                      dtype=torch.int32)
    w = torch.randint(-128, 128, (27, 16), generator=g, device=cuda,
                      dtype=torch.int32)
    n0 = lut_matmul.launches
    assert torch.equal(lut_matmul(a, w, l16, OFF),
                       lut_matmul_ref(a, w, l32, OFF, 256))
    assert lut_matmul.launches == n0 + 1
    x = torch.randn((300, 27), generator=g, device=cuda)
    xs, xz = torch.tensor(0.02, device=cuda), torch.tensor(0.0, device=cuda)
    ws = torch.rand(16, generator=g, device=cuda)
    for emit in (False, True):
        assert torch.equal(
            fused_lut_dense(x, w, l16, OFF, xs, xz, ws, emit_acc=emit),
            fused_lut_dense_ref(x, w, l32, OFF, 256, xs, xz, ws,
                                emit_acc=emit))
    img = torch.randn((2, 16, 9, 9), generator=g, device=cuda)
    wq = torch.randint(-128, 128, (8, 16, 3, 3), generator=g, device=cuda,
                       dtype=torch.int32)
    ws8 = torch.rand(8, generator=g, device=cuda)
    for emit in (False, True):
        kw = dict(stride=(2, 2), padding=((0, 1), (0, 1)), emit_acc=emit)
        assert torch.equal(
            fused_lut_conv(img, wq, l16, OFF, xs, xz, ws8, **kw),
            fused_lut_conv_ref(img, wq, l32, OFF, 256, xs, xz, ws8, **kw))
    torch.cuda.synchronize()

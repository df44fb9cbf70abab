"""Kernel 13's tensor-core arithmetic on the CPU: the 3xTF32 split that
``csrc/err_matmul.cu`` runs (``kernels/err_matmul/ref.py:
err_matmul_tf32_ref``), its tile picker and shared-memory model.

The emulation splits every table value as the kernel does (``hi``: the
top 11 significant bits, to nearest, by Veltkamp's split; ``lo``: the rest,
read as TF32) and sums ``(lo.hi + hi.lo) + hi.hi``; a TF32 product is exact
in float32. It is held
against the reference's plain LOWRANK route (``_lowrank_matmul_jnp``) and
its interpret-mode ``err_matmul`` kernel within ``summation_bound``, and
where ``lut_agreement_bound`` is below 0.5 it rounds to the LUT GEMM (as
``tests/test_torch_modes.py`` holds the port's plain version). One plain
TF32 pass (the lo terms dropped) lies further from the reference: the
split is real.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import make_acu  # noqa: E402
from repro_torch.kernels.err_matmul.ops import (  # noqa: E402
    SMEM_PER_BLOCK, err_smem, err_tile)
from repro_torch.kernels.err_matmul.ref import (  # noqa: E402
    err_matmul_ref, err_matmul_tf32_ref, lut_agreement_bound,
    summation_bound, tf32_split)
from test_torch_parity import load_reference  # noqa: E402

MULT = "mul8s_1L2H"


@pytest.fixture(scope="module")
def ref():
    return load_reference()


def _codes(rng, shape):
    return rng.integers(-128, 128, shape).astype(np.int32)


def test_tf32_split_gives_tf32_values():
    """hi is the value rounded to 11 significant bits (to nearest) and lo
    the rest with its low 13 bits dropped: both are TF32 values (no bit
    below the 10th of the mantissa); the sign is kept."""
    one = 2.0 ** -10                        # a TF32 ulp at 1
    x = torch.tensor([1.0, 1 + one, 1 + one / 4, -(1 + 3 * one / 4)],
                     dtype=torch.float32)
    hi, lo = tf32_split(x)
    assert hi.tolist() == [1.0, 1 + one, 1.0, -(1 + one)]
    assert lo.tolist() == [0.0, 0.0, one / 4, one / 4]
    for part in tf32_split(torch.randn(1000) * 37):
        assert not bool((part.view(torch.int32) & 0x1FFF).any())


def test_tf32_split_keeps_22_bits():
    """``hi + lo`` is the value to within 2^-22 of it, ``hi`` alone only
    to within 2^-11."""
    t = torch.randn(10000, dtype=torch.float32) * 100
    hi, lo = tf32_split(t)
    err3 = ((hi.double() + lo.double()) - t.double()).abs()
    err1 = (hi.double() - t.double()).abs()
    assert bool((err3 <= 2.0 ** -22 * t.double().abs()).all())
    assert bool((err1 <= 2.0 ** -11 * t.double().abs()).all())
    assert float(err1.max()) > 100 * float(err3.max())


@pytest.mark.parametrize("mkn", [(7, 27, 10), (40, 200, 24), (33, 64, 16)])
def test_3xtf32_within_bound(ref, mkn):
    """At rank 8, the 3xTF32 emulation against the reference's plain
    route and its interpret-mode kernel: every element within the
    summation bound; where the LUT agreement bound is below 0.5, round(y)
    is the LUT GEMM's integer (some elements at K <= 64)."""
    import jax.numpy as jnp
    j = ref.core.make_acu(MULT, "lowrank")
    jk = ref.core.make_acu(MULT, "lowrank", use_pallas=True, interpret=True)
    t = make_acu(MULT, "lowrank")
    f, g = t.device_factors("cpu")
    rng = np.random.default_rng(sum(mkn) + 1)
    a, w = _codes(rng, mkn[:2]), _codes(rng, mkn[1:])
    at, wt = torch.from_numpy(a), torch.from_numpy(w)
    got = err_matmul_tf32_ref(at, wt, f, g, t.offset)
    assert got.dtype == torch.float32 and got.shape == (mkn[0], mkn[2])
    bound = summation_bound(at, wt, f, g, t.offset)
    lut = make_acu(MULT, "lut").matmul(at, wt)
    near = lut_agreement_bound(got, at, wt, f, g, t.offset,
                               t.lowrank.max_abs_err) < 0.5
    assert bool(near.any()) or mkn[1] > 64
    assert torch.equal(torch.round(got)[near].to(torch.int32), lut[near])
    for want in (j._lowrank_matmul_jnp(jnp.asarray(a), jnp.asarray(w)),
                 jk.matmul(jnp.asarray(a), jnp.asarray(w))):
        diff = (got.double() - torch.from_numpy(np.array(want)).double()
                ).abs()
        assert bool((diff <= bound).all())


def test_plain_tf32_lies_further_at_k27(ref):
    """At K = 27 (ResNet-20's stem), one TF32 pass (lo terms dropped) lies
    at least 100 times further from the reference than the 3xTF32 split,
    a measurable part of a unit of the integer result; the split stays
    within a few float32 roundings of it."""
    import jax.numpy as jnp
    j = ref.core.make_acu(MULT, "lowrank")
    t = make_acu(MULT, "lowrank")
    f, g = t.device_factors("cpu")
    rng = np.random.default_rng(27)
    a, w = _codes(rng, (300, 27)), _codes(rng, (27, 16))
    at, wt = torch.from_numpy(a), torch.from_numpy(w)
    want = torch.from_numpy(np.array(
        j._lowrank_matmul_jnp(jnp.asarray(a), jnp.asarray(w)))).double()
    y3 = err_matmul_tf32_ref(at, wt, f, g, t.offset)
    y1 = err_matmul_tf32_ref(at, wt, f, g, t.offset, passes=1)
    yf = err_matmul_ref(at, wt, f, g, t.offset)
    d3 = float((y3.double() - want).abs().max())
    d1 = float((y1.double() - want).abs().max())
    df = float((yf.double() - want).abs().max())
    assert d1 > 100 * d3 and d1 > 0.01
    assert d3 <= 4 * max(df, 2.0 ** -10)


@pytest.mark.parametrize("rank", [1, 4, 5, 12])
def test_3xtf32_other_ranks_within_bound(rank):
    """Ranks other than 8 (the kernel walks k * r in groups of 8, the
    tail zeroed): the emulation within the summation bound of the plain
    version, at a ragged shape."""
    t = make_acu(MULT, "lowrank", rank=rank)
    f, g = t.device_factors("cpu")
    rng = np.random.default_rng(rank)
    at = torch.from_numpy(_codes(rng, (50, 37)))
    wt = torch.from_numpy(_codes(rng, (37, 21)))
    got = err_matmul_tf32_ref(at, wt, f, g, t.offset)
    want = err_matmul_ref(at, wt, f, g, t.offset)
    assert bool(((got.double() - want.double()).abs()
                 <= summation_bound(at, wt, f, g, t.offset)).all())


@pytest.mark.parametrize("M,N,bn,wm", [
    (262144, 16, 16, 32), (65536, 32, 32, 32), (16384, 64, 64, 32),
    (256, 10, 16, 16), (17, 70, 64, 16)])
def test_err_tile_follows_n(M, N, bn, wm):
    """The column tile follows N (16, 32, 64); 32 rows a warp at
    ResNet-20's wave shapes, 16 where the tiles are too few for the SMs;
    every tile fits a block's shared memory at rank 8."""
    assert err_tile(M, N, 132) == (bn, wm)
    bm = (4 if bn == 64 else 8) * wm
    assert err_smem(256, 8, bm, bn) <= SMEM_PER_BLOCK


def test_err_smem_grows_with_rank():
    """At rank 8 the tables hold two copies of each row's 8 ranks split
    into hi and lo (32 floats); at other ranks one row of r floats."""
    assert err_smem(256, 8, 256, 16) - err_smem(256, 4, 256, 16) == \
        2 * 256 * (32 - 4) * 4
    assert err_smem(256, 64, 128, 64) <= SMEM_PER_BLOCK

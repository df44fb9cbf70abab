"""Every ACU emulation mode of the port against the JAX reference on the
CPU: the closed forms, the error factorisation, each mode's elementwise
product and unfused GEMM, the planners' routes and audit lines for
non-LUT ACUs, ``approx_dense`` / ``conv2d`` forward and backward on each
mode, and kernel 13 (``err_matmul``).

EXACT, FACTORED, FUNCTIONAL and LUT are integer work: bitwise. LOWRANK has
a float32 result summed in another order in each package (and on the
card), so it is held to the summation bound of
``kernels/err_matmul/ref.py: summation_bound``: every element within
``(K*(r+1) + 2) * 2^-24 * S`` of the other, ``S`` the two sums over
absolute values; and where ``lut_agreement_bound`` is below 0.5 it rounds
to the LUT GEMM's integer (rank 8 reconstructs ``mul8s_1L2H``'s error
table to 6.7e-6).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (ApproxConfig, approx_dense, conv2d,  # noqa: E402
                              conv_plan_report, factorize_error,
                              get_multiplier, make_acu, rank_for_fidelity,
                              trunc_masks)
from repro_torch.core import multipliers as tmul  # noqa: E402
from repro_torch.core.acu import (AcuMode, AttnSpec, ConvSpec,  # noqa: E402
                                  attn_plan, conv_plan, matmul_bwd_plan,
                                  matmul_plan)
from repro_torch.kernels.err_matmul.ops import err_matmul  # noqa: E402
from repro_torch.kernels.err_matmul.ref import (  # noqa: E402
    err_matmul_ref, lut_agreement_bound, summation_bound)
from test_torch_parity import load_reference  # noqa: E402


@pytest.fixture(scope="module")
def ref():
    return load_reference()


@pytest.fixture
def cuda():
    """Skips the test unless a CUDA device is present (decided at run
    time, never at collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU has only the plain versions")
    return torch.device("cuda")


# (mode, multiplier) of each integer mode; LUT at lut_chunk=0, the paper's
# one-gather baseline
INT_MODES = [("exact", "mul8s_exact"), ("factored", "mul8s_trunc2"),
             ("functional", "mul8s_1L2H"), ("functional", "mul8s_mitchell"),
             ("lut", "mul8s_1L2H")]
INT_IDS = [f"{m}-{n}" for m, n in INT_MODES]


def _pair(ref, name, mode, **kw):
    """The reference's ACU and the port's, for one multiplier and mode."""
    j = ref.core.make_acu(name, mode, **kw)
    t = make_acu(name, mode, **kw)
    if mode == "lut":
        j = dataclasses.replace(j, lut_chunk=0)
        t = dataclasses.replace(t, lut_chunk=0)
    return j, t


def _codes(rng, shape, bits=8):
    return rng.integers(-(1 << (bits - 1)), 1 << (bits - 1), shape
                        ).astype(np.int32)


# ---------------------------------------------------------------------------
# closed forms and the factorisation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(tmul.REGISTRY))
def test_closed_forms_on_tensors_bitwise(ref, name):
    """The closed forms take tensors and return int32 tensors equal to the
    reference's products: the full grid at 8 bits, a sampled one with the
    edges at 12."""
    import jax.numpy as jnp
    mt, mj = get_multiplier(name), ref.core.get_multiplier(name)
    vals = np.arange(mt.lo, mt.hi + 1)
    if mt.bits == 8:
        a, w = np.repeat(vals, len(vals)), np.tile(vals, len(vals))
    else:
        rng = np.random.default_rng(12)
        edge = np.array([mt.lo, mt.lo + 1, -1, 0, 1, mt.hi - 1, mt.hi])
        a = np.concatenate([rng.integers(mt.lo, mt.hi + 1, 8192),
                            np.repeat(edge, len(edge))])
        w = np.concatenate([rng.integers(mt.lo, mt.hi + 1, 8192),
                            np.tile(edge, len(edge))])
    got = mt(torch.from_numpy(a.astype(np.int32)),
             torch.from_numpy(w.astype(np.int32)))
    want = np.asarray(mj(jnp.asarray(a, jnp.int32), jnp.asarray(w, jnp.int32)))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_factorize_error_bitwise(ref):
    for name, rank in (("mul8s_1L2H", 8), ("mul8s_1L2H", 2),
                       ("mul8s_mitchell", 4)):
        lt = factorize_error(get_multiplier(name), rank)
        lj = ref.core.lut.factorize_error(ref.core.get_multiplier(name), rank)
        assert lt.rank == lj.rank
        assert np.array_equal(lt.f, lj.f) and np.array_equal(lt.g, lj.g)
        assert lt.f.dtype == np.float32 and lt.f.shape == (256, rank)
        for k in ("max_abs_err", "mean_abs_err", "exact_frac", "energy"):
            assert getattr(lt, k) == getattr(lj, k), (name, rank, k)


def test_rank_for_fidelity_and_trunc_masks_bitwise(ref):
    for name in ("mul8s_1L2H", "mul8s_trunc3"):
        lt = rank_for_fidelity(get_multiplier(name), max_rank=8)
        lj = ref.core.lut.rank_for_fidelity(ref.core.get_multiplier(name),
                                            max_rank=8)
        assert lt.rank == lj.rank and np.array_equal(lt.f, lj.f)
        assert lt.exact_frac == lj.exact_frac
    lr = factorize_error(get_multiplier("mul8s_1L2H"), 8)
    assert lr.exact_frac == 1.0 and lr.max_abs_err < 1e-5
    for name in tmul.REGISTRY:
        assert trunc_masks(get_multiplier(name)) == \
            ref.core.lut.trunc_masks(ref.core.get_multiplier(name))


# ---------------------------------------------------------------------------
# each mode's product and GEMM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,name", INT_MODES, ids=INT_IDS)
def test_mul_bitwise(ref, mode, name):
    """``Acu.mul`` over the full 8-bit operand grid."""
    import jax.numpy as jnp
    j, t = _pair(ref, name, mode)
    vals = np.arange(-128, 128, dtype=np.int32)
    a, w = vals[:, None], vals[None, :]
    got = t.mul(torch.from_numpy(a), torch.from_numpy(w))
    want = np.asarray(j.mul(jnp.asarray(a), jnp.asarray(w)))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode,name", INT_MODES, ids=INT_IDS)
def test_unfused_gemm_bitwise(ref, mode, name):
    """The unfused GEMM of each integer mode, K not a multiple of the
    FUNCTIONAL chunk (32) nor of 8."""
    import jax.numpy as jnp
    j, t = _pair(ref, name, mode)
    rng = np.random.default_rng(3)
    for m, k, n in ((12, 23, 9), (40, 200, 24)):
        a, w = _codes(rng, (m, k)), _codes(rng, (k, n))
        want = np.asarray(j.matmul(jnp.asarray(a), jnp.asarray(w)))
        got = t.matmul(torch.from_numpy(a), torch.from_numpy(w))
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode,name", [("functional", "mul12s_2KM"),
                                       ("exact", "mul12s_exact"),
                                       ("factored", "mul12s_trunc3")])
def test_12bit_gemm_and_mul_bitwise(ref, mode, name):
    """12-bit codes on a sampled grid: ``mul12s_2KM`` FUNCTIONAL (the
    Table 2 row), EXACT and FACTORED; products up to 2^22, so the int32
    sums over K = 70 may wrap, and must wrap the same way."""
    import jax.numpy as jnp
    j, t = _pair(ref, name, mode)
    rng = np.random.default_rng(12)
    a, w = _codes(rng, (6, 70), 12), _codes(rng, (70, 5), 12)
    got = t.matmul(torch.from_numpy(a), torch.from_numpy(w))
    want = np.asarray(j.matmul(jnp.asarray(a), jnp.asarray(w)))
    assert np.array_equal(got.numpy(), want)
    got = t.mul(torch.from_numpy(a[:5, :5]), torch.from_numpy(w[:5]))
    want = np.asarray(j.mul(jnp.asarray(a[:5, :5]), jnp.asarray(w[:5])))
    assert np.array_equal(got.numpy(), want)


def test_12bit_lut_request_is_functional(ref):
    """A LUT request above 10 bits falls back to FUNCTIONAL (paper §3.4),
    whose m00 is the closed form's product at (0, 0)."""
    for name in ("mul12s_2KM", "mul12s_mitchell"):
        t, j = make_acu(name, "lut"), ref.core.make_acu(name, "lut")
        assert t.mode == AcuMode.FUNCTIONAL and t.lut is None
        assert t.m00() == j.m00()


def _lowrank_operands(rng, m, k, n):
    a, w = _codes(rng, (m, k)), _codes(rng, (k, n))
    return a, w, torch.from_numpy(a), torch.from_numpy(w)


def _hold_lowrank(got: torch.Tensor, want: np.ndarray, at, wt, acu) -> float:
    """``got`` within the summation bound of ``want``; where the LUT
    agreement bound is below 0.5, ``round(got)`` is the LUT GEMM. Returns
    the share of elements that second check covers."""
    f, g = acu.device_factors("cpu")
    diff = (got.to(torch.float64) - torch.from_numpy(want).to(torch.float64)
            ).abs()
    assert bool((diff <= summation_bound(at, wt, f, g, acu.offset)).all())
    lut = make_acu(acu.multiplier.name, "lut").matmul(at, wt)
    near = lut_agreement_bound(got, at, wt, f, g, acu.offset,
                               acu.lowrank.max_abs_err) < 0.5
    assert torch.equal(torch.round(got)[near].to(torch.int32), lut[near])
    return float(near.to(torch.float64).mean())


@pytest.mark.parametrize("mkn", [(40, 200, 24), (7, 27, 10), (33, 64, 16)])
def test_lowrank_within_bound(ref, mkn):
    """LOWRANK at rank 8: the port's plain route and the kernel's plain
    version against the reference's ``_lowrank_matmul_jnp`` and its
    interpret-mode ``err_matmul`` kernel. The LUT agreement bound grows
    with K: at K = 200 it covers no element, at K <= 64 some."""
    import jax.numpy as jnp
    j, t = _pair(ref, "mul8s_1L2H", "lowrank")
    jk = ref.core.make_acu("mul8s_1L2H", "lowrank", use_pallas=True,
                           interpret=True)
    tk = make_acu("mul8s_1L2H", "lowrank", use_kernels=True)
    assert np.array_equal(t.lowrank.f, j.lowrank.f)
    rng = np.random.default_rng(sum(mkn))
    a, w, at, wt = _lowrank_operands(rng, *mkn)
    want_plain = np.asarray(j.matmul(jnp.asarray(a), jnp.asarray(w)))
    want_kernel = np.asarray(jk.matmul(jnp.asarray(a), jnp.asarray(w)))
    for got in (t.matmul(at, wt), tk.matmul(at, wt)):
        assert got.dtype == torch.float32 and got.shape == mkn[::2]
        for want in (want_plain, want_kernel):
            covered = _hold_lowrank(got, want, at, wt, t)
            assert covered > 0 or mkn[1] > 64


def test_lowrank_mul_within_bound(ref):
    import jax.numpy as jnp
    j, t = _pair(ref, "mul8s_1L2H", "lowrank")
    vals = np.arange(-128, 128, dtype=np.int32)
    got = t.mul(torch.from_numpy(vals[:, None]), torch.from_numpy(vals[None]))
    want = np.asarray(j.mul(jnp.asarray(vals[:, None]),
                            jnp.asarray(vals[None])))
    lut = make_acu("mul8s_1L2H", "lut").lut
    # one product: r = 8 products and sums of |f||g| <= 2^7 * 2^8 each
    assert np.abs(got.numpy() - want).max() <= 10 * 2.0 ** -24 * 2 ** 16
    assert np.array_equal(np.round(got.numpy()).astype(np.int32), lut)


# ---------------------------------------------------------------------------
# kernel 13: the >8-bit refusal, and the reference fault it avoids
# ---------------------------------------------------------------------------

def test_err_matmul_refuses_wide_codes():
    a = torch.zeros((4, 8), dtype=torch.int32)
    f = torch.zeros((4096, 2))
    with pytest.raises(ValueError, match="int8"):
        err_matmul(a, a.t().contiguous(), f, f, 2048)
    with pytest.raises(ValueError, match="differ"):
        err_matmul(a, a.t().contiguous(), f, torch.zeros((4096, 3)), 2048)


def test_reference_err_matmul_wraps_wide_codes(ref):
    """Why the port refuses: with 12-bit codes (zero tables, so only the
    exact term is left) the reference kernel casts to int8 and misses the
    integer product by millions."""
    import jax.numpy as jnp
    from repro.kernels.err_matmul.ops import err_matmul as ref_err_matmul
    rng = np.random.default_rng(0)
    a, w = _codes(rng, (8, 16), 12), _codes(rng, (16, 8), 12)
    f = jnp.zeros((4096, 2), jnp.float32)
    got = np.asarray(ref_err_matmul(jnp.asarray(a), jnp.asarray(w), f, f,
                                    2048, interpret=True))
    exact = a.astype(np.int64) @ w.astype(np.int64)
    assert np.abs(got - exact).max() > 1e6
    # the port's plain version takes the same codes exactly
    plain = err_matmul_ref(torch.from_numpy(a), torch.from_numpy(w),
                           torch.zeros((4096, 2)), torch.zeros((4096, 2)),
                           2048)
    assert np.array_equal(plain.numpy(), exact.astype(np.float32))


# ---------------------------------------------------------------------------
# planners
# ---------------------------------------------------------------------------

SMALL_SPEC = ConvSpec(x_shape=(2, 8, 12, 12), w_shape=(8, 8, 3, 3),
                      padding=((1, 1), (1, 1)))


@pytest.mark.parametrize("mode,name", [("functional", "mul8s_1L2H"),
                                       ("lowrank", "mul8s_1L2H"),
                                       ("exact", "mul8s_exact"),
                                       ("factored", "mul8s_trunc2")])
def test_planners_route_non_lut_acus(ref, mode, name):
    """A fused request on a non-LUT ACU resolves unfused (dense), to
    ``im2col`` with the reference's audit line (conv) and to ``dense``
    (attention), as in ``tests/test_acu.py``."""
    acu = make_acu(name, mode, use_kernels=True, fused=True)
    assert not matmul_plan(acu).fused and not matmul_plan(acu, fused=True).fused
    plan = conv_plan(acu, SMALL_SPEC, fused=True)
    assert plan.route == "im2col" and plan.fn is None
    assert plan.report == (
        f"fused conv needs LUT mode + use_kernels + a built table (have "
        f"mode={mode}, use_kernels=True)",)
    assert conv_plan(acu, SMALL_SPEC, fused=False).report == ()
    with pytest.raises(ValueError, match="fused_conv route unavailable"):
        conv_plan(acu, SMALL_SPEC, route="fused_conv")
    attn = attn_plan(acu, AttnSpec(hq=4, hkv=2))
    assert attn.route == "dense" and attn.fn is None
    assert attn.report[0].startswith(f"fused attention needs LUT mode + "
                                     f"use_kernels + a built table (have "
                                     f"mode={mode}")
    # the same plan report keys as the reference's
    keys = ("route", "bwd_route", "mode", "fused", "gemm", "tiling",
            "partition")
    cfg_t = ApproxConfig(acu=acu)
    cfg_j = ref.core.ApproxConfig(acu=ref.core.make_acu(
        name, mode, use_pallas=True, fused=True))
    rt = conv_plan_report((2, 8, 12, 12), (8, 8, 3, 3), cfg_t)
    rj = ref.core.conv_plan_report((2, 8, 12, 12), (8, 8, 3, 3), cfg_j)
    assert {k: rt[k] for k in keys} == {k: rj[k] for k in keys}
    assert [s.replace("use_kernels", "use_pallas") for s in rt["report"]] \
        == rj["report"]


def test_make_acu_modes(ref):
    """Every mode builds; m00 and the mode fields follow the reference."""
    for mode, name in INT_MODES + [("lowrank", "mul8s_1L2H")]:
        t, j = make_acu(name, mode), ref.core.make_acu(name, mode)
        assert t.mode.value == j.mode.value == mode
        assert t.m00() == j.m00() and t.mask == j.mask
        assert (t.lowrank is None) == (j.lowrank is None)
    assert make_acu("mul8s_1L2H", "lowrank", rank=4).lowrank.rank == 4
    with pytest.raises(ValueError, match="no algebraic factorization"):
        make_acu("mul8s_1L2H", "factored")


def test_matmul_bwd_plan_each_mode(ref):
    """The approximate backward GEMM of every non-LUT mode: quantize
    outside, the mode's GEMM, one dequant, as the reference's."""
    import jax.numpy as jnp
    rng = np.random.default_rng(9)
    a = (rng.normal(size=(9, 30)) * 2).astype(np.float32)
    b = (rng.normal(size=(30, 7)) * 0.01).astype(np.float32)
    sa, sb = np.float32(np.abs(a).max() / 127), np.float32(
        np.abs(b).max() / 127)
    for mode, name in INT_MODES + [("lowrank", "mul8s_1L2H")]:
        j, t = _pair(ref, name, mode)
        gj = np.asarray(ref.core.acu.matmul_bwd_plan(j, fused=True)[0](
            jnp.asarray(a), jnp.asarray(b), sa, sb))
        gt = matmul_bwd_plan(t, fused=True)[0](
            torch.from_numpy(a), torch.from_numpy(b), torch.tensor(sa),
            torch.tensor(sb))
        if mode == "lowrank":
            # the accumulators within the summation bound (< 1e-3 here),
            # times the combined scale
            np.testing.assert_allclose(gt.numpy(), gj, rtol=0,
                                       atol=1e-3 * float(sa * sb) * 2)
        else:
            assert np.array_equal(gt.numpy(), gj), mode


# ---------------------------------------------------------------------------
# approx_dense and conv2d on each mode, forward and backward
# ---------------------------------------------------------------------------

ALL_MODES = INT_MODES + [("lowrank", "mul8s_1L2H")]
ALL_IDS = INT_IDS + ["lowrank-mul8s_1L2H"]


@pytest.mark.parametrize("approx_bwd", [False, True], ids=["ste", "approx"])
@pytest.mark.parametrize("mode,name", ALL_MODES, ids=ALL_IDS)
def test_approx_ops_each_mode(ref, mode, name, approx_bwd):
    """``approx_dense`` (with bias) and ``conv2d`` (im2col route) outputs
    and gradients against ``jax.value_and_grad`` of the reference's.

    Integer modes: outputs bitwise; with ``approx_bwd`` the gradients are
    integer GEMMs with one dequant, bitwise too, except the conv input
    gradient, whose dequantized patch gradients are scattered back to the
    image (col2im) in float32 in another order; that one, and the exact
    STE backward (a float32 GEMM summed in another order), are held to
    rtol 1e-5 and atol 1e-6 of the largest entry. LOWRANK: every accumulator within its
    summation bound (below 1e-2 at these sizes), so outputs and gradients
    within 1e-2 times the combined scale, or the float32 tolerance."""
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 3, 8, 8)).astype(np.float32)
    wc = rng.normal(size=(5, 3, 3, 3)).astype(np.float32)
    xd = rng.normal(size=(7, 33)).astype(np.float32)
    wd = rng.normal(size=(33, 6)).astype(np.float32)
    bd = rng.normal(size=6).astype(np.float32)
    j, t = _pair(ref, name, mode)
    jc = ref.core.ApproxConfig(acu=j, approx_bwd=approx_bwd)
    tc = ApproxConfig(acu=t, approx_bwd=approx_bwd)

    def jloss(xd_, wd_, x_, wc_):
        y1 = ref.core.approx_dense(xd_, wd_, jnp.asarray(bd), jc)
        y2 = ref.core.conv2d(x_, wc_, cfg=jc)
        return (y1 ** 2).sum() + (y2 ** 2).sum(), (y1, y2)

    (_, (y1j, y2j)), gj = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                             has_aux=True)(
        *map(jnp.asarray, (xd, wd, x, wc)))
    leaves = [torch.from_numpy(v).requires_grad_(True)
              for v in (xd, wd, x, wc)]
    y1 = approx_dense(leaves[0], leaves[1], torch.from_numpy(bd), tc)
    y2 = conv2d(leaves[2], leaves[3], cfg=tc)
    ((y1 ** 2).sum() + (y2 ** 2).sum()).backward()
    outs = [(y1.detach().numpy(), np.asarray(y1j)),
            (y2.detach().numpy(), np.asarray(y2j))]
    grads = [(t_.grad.numpy(), np.asarray(g_)) for t_, g_ in zip(leaves, gj)]
    if mode == "lowrank":
        for got, want in outs + grads:
            np.testing.assert_allclose(got, want, rtol=1e-4,
                                       atol=1e-4 * np.abs(want).max())
        return
    for got, want in outs:
        assert np.array_equal(got, want)
    for i, (got, want) in enumerate(grads):
        if approx_bwd and i != 2:
            assert np.array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5,
                                       atol=1e-6 * np.abs(want).max())


def test_kernel_acus_fall_back_on_cpu_tensors():
    """``use_kernels`` ACUs of every mode run their plain versions on CPU
    tensors (no launch), equal to the plain ACUs'."""
    from repro_torch.kernels.lut_matmul.ops import lut_matmul
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(6, 40)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(40, 9)).astype(np.float32))
    before = (err_matmul.launches, lut_matmul.launches)
    for mode, name in ALL_MODES:
        kern = ApproxConfig(acu=make_acu(name, mode, use_kernels=True))
        plain = ApproxConfig(acu=make_acu(name, mode))
        assert torch.equal(approx_dense(x, w, None, kern),
                           approx_dense(x, w, None, plain)), mode
    assert (err_matmul.launches, lut_matmul.launches) == before


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_err_matmul_matches_plain_version(cuda):
    """On a card: kernel 13 launches and stays within the summation bound
    of its plain version; where the LUT agreement bound is below 0.5 it
    rounds to ``lut_matmul``'s result. EXACT's ``_int_mm`` route and the
    FUNCTIONAL closed form give the CPU's integers."""
    from repro_torch.core.approx_ops import exact_f32
    acu = make_acu("mul8s_1L2H", "lowrank", use_kernels=True)
    lut_acu = make_acu("mul8s_1L2H", "lut", use_kernels=True)
    f, g = acu.device_factors(cuda)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    for m, k, n in ((300, 27, 16), (4096, 144, 32), (17, 130, 70)):
        a = torch.randint(-128, 128, (m, k), generator=gen, device=cuda,
                          dtype=torch.int32)
        w = torch.randint(-128, 128, (k, n), generator=gen, device=cuda,
                          dtype=torch.int32)
        n0 = err_matmul.launches
        y = err_matmul(a, w, f, g, acu.offset)
        assert err_matmul.launches == n0 + 1
        with exact_f32():
            yp = err_matmul_ref(a, w, f, g, acu.offset)
            bound = summation_bound(a, w, f, g, acu.offset)
            near = lut_agreement_bound(y, a, w, f, g, acu.offset,
                                       acu.lowrank.max_abs_err) < 0.5
        assert bool(((y.double() - yp.double()).abs() <= bound).all())
        lut = lut_acu.matmul(a, w)
        assert torch.equal(torch.round(y)[near].to(torch.int32), lut[near])
        for mode, name in (("exact", "mul8s_exact"),
                           ("functional", "mul8s_1L2H")):
            t = make_acu(name, mode)
            assert torch.equal(t.matmul(a, w).cpu(),
                               t.matmul(a.cpu(), w.cpu()))
    # the approximate backward of a LOWRANK kernel ACU runs kernel 13 too:
    # one forward and two gradient GEMMs
    x = torch.randn((64, 40), generator=gen, device=cuda, requires_grad=True)
    wt = torch.randn((40, 24), generator=gen, device=cuda,
                     requires_grad=True)
    n0 = err_matmul.launches
    approx_dense(x, wt, None, ApproxConfig(acu=acu, approx_bwd=True)
                 ).sum().backward()
    assert err_matmul.launches == n0 + 3
    assert bool(torch.isfinite(x.grad).all() and torch.isfinite(wt.grad).all())
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("rank", [1, 4, 5, 12])
def test_cuda_err_matmul_other_ranks(cuda, rank):
    """On a card: kernel 13 at ranks other than 8 walks k * r in groups of
    8 (the MMA's depth) with the tail zeroed; one launch a call, within
    the summation bound of its plain version, and at ResNet-20's stem
    (K = 27, the LUT agreement bound below 0.5 almost everywhere) it
    rounds to lut_matmul's integers where the bound says it must."""
    from repro_torch.core.approx_ops import exact_f32
    acu = make_acu("mul8s_1L2H", "lowrank", rank=rank, use_kernels=True)
    lut_acu = make_acu("mul8s_1L2H", "lut", use_kernels=True)
    f, g = acu.device_factors(cuda)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(rank)
    for m, k, n in ((2048, 27, 16), (513, 130, 33)):
        a = torch.randint(-128, 128, (m, k), generator=gen, device=cuda,
                          dtype=torch.int32)
        w = torch.randint(-128, 128, (k, n), generator=gen, device=cuda,
                          dtype=torch.int32)
        n0 = err_matmul.launches
        y = err_matmul(a, w, f, g, acu.offset)
        assert err_matmul.launches == n0 + 1
        with exact_f32():
            yp = err_matmul_ref(a, w, f, g, acu.offset)
            bound = summation_bound(a, w, f, g, acu.offset)
            near = lut_agreement_bound(y, a, w, f, g, acu.offset,
                                       acu.lowrank.max_abs_err) < 0.5
        assert bool(((y.double() - yp.double()).abs() <= bound).all())
        lut = lut_acu.matmul(a, w)
        assert torch.equal(torch.round(y)[near].to(torch.int32), lut[near])
    torch.cuda.synchronize()

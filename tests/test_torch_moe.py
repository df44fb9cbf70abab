"""The port's MoE slice against the JAX reference on the CPU: kernel 10's
plain version (``kernels/fused_lut_grouped``), ``grouped_plan``,
``approx_grouped_dense`` and its STE, and the MoE layer
(``models/moe.py``), mirroring ``tests/test_moe.py`` and
``tests/test_moe_grouped.py`` without their mesh cases.

The reference's ACU is ``make_acu(..., use_pallas=True, interpret=True,
fused=True)``, so its grouped route runs the Pallas kernel in interpret
mode and its per-expert route the fused dense kernel. Inputs come from
numpy seeds.

Tolerances, with their reasons:

* integer work and everything downstream of it (kernel 10, the grouped
  GEMM on both routes, dispatch, experts and combine fed the reference's
  routing): bitwise. bfloat16 against the reference run op by op
  (``jax.disable_jit``): compiled, it fuses bfloat16 roundings
  (``test_torch_lm.py``).
* the router (``_route``): a float32 product and a softmax whose ``exp``
  rounds an ulp apart from XLA's, so within rtol 1e-6; the chosen experts
  must be equal. That is why the layer tests feed the reference's routing
  into the port's dispatch.
* STE gradients: float32 einsums summed in another order, rtol 1e-5.
* the exact-multiplier LUT MoE against the float MoE: quantization error,
  rtol 0.1 / atol 0.05, as the reference's own test.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core import (ApproxConfig, GroupedSpec,  # noqa: E402
                              approx_grouped_dense, build_lut,
                              get_multiplier, grouped_plan, make_acu)
from repro_torch.kernels.fused_lut_grouped.ops import (  # noqa: E402
    fused_lut_grouped)
from repro_torch.kernels.fused_lut_grouped.ref import (  # noqa: E402
    fused_lut_grouped_ref)
from repro_torch.models import moe as TM  # noqa: E402
from test_torch_parity import load_reference  # noqa: E402

MULT = "mul8s_1L2H"
LUT = build_lut(get_multiplier(MULT))
# exact product + 7: M[0, x] = 7, so a dead row that were computed and then
# masked would carry K * 7 + ... before the mask; the registry table has
# LUT[0, x] = 0 and would not show it
_V = np.arange(-128, 128, dtype=np.int32)
BIASED_LUT = (_V[:, None] * _V[None, :] + 7).astype(np.int32)

# (G, E, C, K, N, biased, counts), the reference's six edge cases
CASES = {
    "ragged": (4, 4, 24, 33, 14, False, None),
    "blocks": (8, 4, 24, 33, 14, False, None),
    "biased_m00": (4, 4, 24, 33, 14, True, None),
    "ktile": (4, 4, 24, 600, 14, False, None),
    "empty_experts": (6, 3, 16, 40, 9, True, [0, 16, 3, 0, 16, 5]),
    "all_to_one": (4, 4, 32, 40, 9, False, [32, 0, 0, 0]),
}

CFG_MOE = dict(name="t", family="moe", n_layers=1, d_model=32, n_heads=2,
               n_kv_heads=2, d_ff=16, vocab_size=64, pattern=("attn_moe",),
               n_experts=4, moe_top_k=2, moe_capacity=8.0, dtype="float32")


@pytest.fixture(scope="module")
def ref():
    load_reference()
    import repro.configs.base as jbase
    import repro.core as jcore
    import repro.core.acu as jacu
    import repro.kernels.fused_lut_grouped.ops as jgops
    import repro.models.moe as jmoe
    import repro.models.transformer as jtrans
    return SimpleNamespace(base=jbase, core=jcore, acu=jacu, gops=jgops,
                           moe=jmoe, trans=jtrans)


def _acfgs(ref, mult=MULT):
    """The reference's ACU (interpret-mode Pallas) and the port's."""
    j = ref.core.ApproxConfig(acu=ref.core.make_acu(
        mult, "lut", use_pallas=True, interpret=True, fused=True))
    return j, ApproxConfig(acu=make_acu(mult, "lut", use_kernels=True,
                                        fused=True))


def _grouped_operands(G, E, C, K, N, seed, counts=None):
    """Dispatch-shaped numpy operands: activations zeroed past each
    group's count, int8-range weight codes, per-expert scales."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(G, C, K)).astype(np.float32)
    if counts is None:
        counts = rng.integers(0, C + 1, size=(G,))
    counts = np.asarray(counts, np.int32)
    mask = np.arange(C)[None, :] < counts[:, None]
    x = x * mask[..., None]
    wq = rng.integers(-128, 128, (E, K, N)).astype(np.int32)
    ws = (rng.random((E, N)) * 0.01 + 1e-3).astype(np.float32)
    xs = np.float32(np.abs(x).max() / 127)
    return x, wq, ws, xs, counts, mask


def _t(a):
    return torch.from_numpy(np.array(a))


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    return np.asarray(a).view(np.int32)


# ---------------------------------------------------------------------------
# kernel 10's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("emit_acc", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_grouped_kernel_matches_reference(ref, case, emit_acc):
    """The plain kernel (through the wrapper, on CPU tensors) equals the
    reference's interpret-mode kernel bit for bit, dequantized and raw."""
    import jax.numpy as jnp
    G, E, C, K, N, biased, counts = CASES[case]
    x, wq, ws, xs, counts, _ = _grouped_operands(G, E, C, K, N,
                                                 seed=G + C + K + N,
                                                 counts=counts)
    lut = BIASED_LUT if biased else LUT
    want = ref.gops.fused_lut_grouped(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(lut), 128, xs, 0.0,
        jnp.asarray(ws), jnp.asarray(counts), bits=8, interpret=True,
        emit_acc=emit_acc)
    got = fused_lut_grouped(_t(x), _t(wq), _t(lut), 128, xs, 0.0, _t(ws),
                            _t(counts), emit_acc=emit_acc)
    assert got.dtype == (torch.int32 if emit_acc else torch.float32)
    assert np.array_equal(_bits(got), _bits(want))


def test_grouped_kernel_biased_dead_rows_exact_zero():
    """Rows past a group's count are never accumulated: under the biased
    table a computed-then-masked row would not be 0 before the mask, and
    the int32 accumulator shows it is 0 in integer space; the dequantized
    output is the one combined-scale multiply of it."""
    x, wq, ws, xs, counts, mask = _grouped_operands(4, 2, 16, 40, 9, seed=3,
                                                    counts=[3, 16, 0, 7])
    lut = _t(BIASED_LUT)
    acc = fused_lut_grouped(_t(x), _t(wq), lut, 128, xs, 0.0, _t(ws),
                            _t(counts), emit_acc=True)
    assert acc.dtype == torch.int32
    assert not acc[torch.from_numpy(~mask)].any()
    assert acc[torch.from_numpy(mask)].abs().min() > 0   # bias: never 0 here
    out = fused_lut_grouped(_t(x), _t(wq), lut, 128, xs, 0.0, _t(ws),
                            _t(counts))
    dq = acc.float() * (torch.tensor(xs) * _t(ws))[torch.arange(4) % 2][:, None]
    want = torch.where(torch.from_numpy(mask)[..., None], dq, 0.0)
    assert np.array_equal(_bits(out), _bits(want))


def test_grouped_kernel_bfloat16_activations():
    """bfloat16 activations are widened exactly: the same result as their
    float32 values."""
    x, wq, ws, xs, counts, _ = _grouped_operands(6, 3, 8, 40, 12, seed=4)
    xb = _t(x).to(torch.bfloat16)
    a = fused_lut_grouped(xb, _t(wq), _t(LUT), 128, xs, 0.0, _t(ws),
                          _t(counts))
    b = fused_lut_grouped(xb.float(), _t(wq), _t(LUT), 128, xs, 0.0, _t(ws),
                          _t(counts))
    assert torch.equal(a, b)


def test_grouped_wrapper_rejects_bad_shapes():
    x, wq, ws, xs, counts, _ = _grouped_operands(6, 3, 8, 40, 12, seed=4)
    with pytest.raises(ValueError, match="multiple of experts"):
        fused_lut_grouped(_t(x)[:5], _t(wq), _t(LUT), 128, xs, 0.0, _t(ws),
                          _t(counts)[:5])
    with pytest.raises(ValueError, match="inner dims"):
        fused_lut_grouped(_t(x)[..., :39], _t(wq), _t(LUT), 128, xs, 0.0,
                          _t(ws), _t(counts))
    with pytest.raises(ValueError, match="counts"):
        fused_lut_grouped(_t(x), _t(wq), _t(LUT), 128, xs, 0.0, _t(ws),
                          _t(counts)[:4])


@pytest.fixture
def cuda():
    """Skips the test unless a CUDA device is present (decided at run
    time, never at collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU has only the plain versions")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_grouped_kernel_matches_plain_version(cuda):
    """On a card: kernel 10 launches (its counter rises) and equals its
    plain version bit for bit on every edge case, float32 and bfloat16
    activations, dequantized and raw, with the counts left on the card."""
    from repro_torch.kernels import runtime
    before = fused_lut_grouped.launches
    n = 0
    for name, (G, E, C, K, N, biased, counts) in CASES.items():
        x, wq, ws, xs, counts, _ = _grouped_operands(G, E, C, K, N, seed=G,
                                                     counts=counts)
        lut = torch.from_numpy(BIASED_LUT if biased else LUT)
        l16 = runtime.lut_to_int16(lut).to(cuda)
        args = [_t(a).to(cuda) for a in (x, wq)]
        for dt in (torch.float32, torch.bfloat16):
            xd = args[0].to(dt)
            for emit in (False, True):
                got = fused_lut_grouped(xd, args[1], l16, 128, xs, 0.0,
                                        _t(ws).to(cuda), _t(counts).to(cuda),
                                        emit_acc=emit)
                want = fused_lut_grouped_ref(
                    xd.cpu(), _t(wq), lut.reshape(-1), 128, 256, xs, 0.0,
                    _t(ws), _t(counts), emit_acc=emit)
                torch.cuda.synchronize()
                assert torch.equal(got.cpu(), want), (name, dt, emit)
                n += 1
    assert fused_lut_grouped.launches == before + n


# ---------------------------------------------------------------------------
# grouped_plan and approx_grouped_dense
# ---------------------------------------------------------------------------

def test_grouped_plan_routes_and_audit(ref):
    """The kernel ACU resolves to ``fused_grouped`` whatever ``fused``
    says; a non-kernel ACU falls back to ``vmap`` with an audit line; a
    pinned route that cannot be served raises; ``describe()`` has the
    reference's keys and values."""
    spec = GroupedSpec(n_experts=4, cap=24, d_in=33, d_out=14, n_blocks=2)
    jspec = ref.acu.GroupedSpec(n_experts=4, cap=24, d_in=33, d_out=14,
                                n_blocks=2)
    jacfg, tacfg = _acfgs(ref)
    plan = grouped_plan(tacfg.acu, spec)
    assert plan.route == "fused_grouped"
    assert plan.describe() == ref.acu.grouped_plan(jacfg.acu,
                                                   jspec).describe()
    unfused = make_acu(MULT, "lut", use_kernels=True, fused=False)
    assert grouped_plan(unfused, spec).route == "fused_grouped"
    for acu in (make_acu(MULT, "lut"), make_acu(MULT, "exact"),
                make_acu(MULT, "lowrank", use_kernels=True)):
        fb = grouped_plan(acu, spec)
        assert fb.route == "vmap" and "per-expert vmapped" in fb.report[0]
        with pytest.raises(ValueError, match="fused_grouped route "
                                             "unavailable"):
            grouped_plan(acu, spec, route="fused_grouped")
    pinned = grouped_plan(tacfg.acu, spec, route="vmap")
    assert pinned.route == "vmap" and pinned.report == (
        "route pinned to per-expert vmap by caller",)
    jd = ref.acu.grouped_plan(jacfg.acu, jspec, route="vmap").describe()
    assert pinned.describe() == jd
    with pytest.raises(ValueError, match="no direct kernel"):
        pinned()
    with pytest.raises(ValueError, match="unknown grouped route"):
        grouped_plan(tacfg.acu, spec, route="tiled")
    with pytest.raises(TypeError, match="mesh must be"):
        grouped_plan(tacfg.acu, spec, mesh=object())


def _approx_operands(nb=2, E=4, C=24, K=33, N=14, seed=0):
    rng = np.random.default_rng(seed)
    G = nb * E
    x = rng.normal(size=(G, C, K)).astype(np.float32)
    w = rng.normal(size=(E, K, N)).astype(np.float32)
    counts = rng.integers(0, C + 1, size=(G,)).astype(np.int32)
    mask = np.arange(C)[None, :] < counts[:, None]
    return x * mask[..., None], w, counts, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", [None, "vmap"])
def test_approx_grouped_dense_matches_reference(ref, route, dtype):
    """Both routes of the port equal the reference's, bit for bit, and
    each other; bfloat16 against the reference run op by op."""
    import jax
    import jax.numpy as jnp
    x, w, counts, mask = _approx_operands(seed=5)
    jacfg, tacfg = _acfgs(ref)
    jx, jw = (jnp.asarray(a, jnp.dtype(dtype)) for a in (x, w))
    with jax.disable_jit():
        want = ref.core.approx_grouped_dense(jx, jw, jacfg,
                                             jnp.asarray(counts),
                                             route=route)
    tx, tw = (_t(a.astype(jnp.float32)).to(getattr(torch, dtype))
              for a in (jx, jw))
    got = approx_grouped_dense(tx, tw, tacfg, _t(counts), route=route)
    assert got.dtype == tx.dtype
    assert np.array_equal(_bits(got), _bits(jnp.asarray(want, jnp.float32)))
    other = approx_grouped_dense(tx, tw, tacfg, _t(counts),
                                 route="vmap" if route is None else None)
    assert torch.equal(got, other)
    assert not got.float()[torch.from_numpy(~mask)].any()


@pytest.mark.parametrize("route", [None, "vmap"])
def test_approx_grouped_ste_grads_match_reference(ref, route):
    """The STE gradients of both operands against the reference's, within
    float32 rtol 1e-5; dead rows carry no gradient."""
    import jax
    import jax.numpy as jnp
    x, w, counts, mask = _approx_operands(seed=7)
    jacfg, tacfg = _acfgs(ref)
    N = w.shape[2]

    def jloss(x, w):
        return (ref.core.approx_grouped_dense(
            x, w, jacfg, jnp.asarray(counts), route=route)
            * jnp.arange(N)).sum()

    jgx, jgw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                               jnp.asarray(w))
    tx, tw = (_t(a).requires_grad_(True) for a in (x, w))
    (approx_grouped_dense(tx, tw, tacfg, _t(counts), route=route)
     * torch.arange(N)).sum().backward()
    for got, want in ((tx.grad, jgx), (tw.grad, jgw)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    assert not tx.grad[torch.from_numpy(~mask)].any()
    assert float(tw.grad.abs().sum()) > 0


def test_approx_grouped_rejects_fake_quant_only_and_bad_groups():
    x, w, counts, _ = _approx_operands(seed=1)
    acu = make_acu(MULT, "lut", use_kernels=True, fused=True)
    with pytest.raises(ValueError, match="fake-quant"):
        approx_grouped_dense(_t(x), _t(w), ApproxConfig(
            acu=acu, fake_quant_only=True), _t(counts))
    with pytest.raises(ValueError, match="multiple of experts"):
        approx_grouped_dense(_t(x)[:7], _t(w), ApproxConfig(acu=acu),
                             _t(counts)[:7])


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

def _moe(ref, dtype="float32", **kw):
    """The test config of both packages and the reference's parameters
    (``_init_moe``, group 0) on both sides."""
    import jax
    jcfg = ref.base.ModelConfig(**dict(CFG_MOE, dtype=dtype, **kw))
    tcfg = ModelConfig(**dict(CFG_MOE, dtype=dtype, **kw))
    jp = jax.tree.map(lambda a: a[0], ref.trans._init_moe(
        jax.random.PRNGKey(0), jcfg, 1))
    tp = {k: _t(np.asarray(v.astype(np.float32))).to(
        torch.float32 if k == "router" else tcfg.param_dtype)
        for k, v in jp.items()}
    return jcfg, tcfg, jp, tp


def _tokens(b, s, d, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=(b, s, d))
            * scale).astype(np.float32)


@pytest.mark.parametrize("t", [1, 2, 3, 8, 24, 32, 128, 256, 512, 6400])
def test_dispatch_geometry_matches_reference(ref, t):
    """Block count, tokens per block and capacity (half-to-even round),
    including the non-power-of-2 fallback (t = 24 -> 8 blocks), for the
    test config and granite-moe-3b-a800m."""
    import repro.configs as jconfigs
    from repro_torch.configs import get_config
    for tcfg, jcfg in ((ModelConfig(**CFG_MOE), ref.base.ModelConfig(
            **CFG_MOE)), (get_config("granite-moe-3b-a800m"),
                          jconfigs.get_config("granite-moe-3b-a800m"))):
        assert TM.dispatch_geometry(tcfg, t) == \
            ref.moe.dispatch_geometry(jcfg, t)
    geo = TM.dispatch_geometry(ModelConfig(**CFG_MOE), 24)
    assert (geo["n_blocks"], geo["tokens_per_block"]) == (8, 3)


def test_route_matches_reference(ref):
    import jax.numpy as jnp
    jcfg, tcfg, jp, tp = _moe(ref)
    xf = _tokens(1, 48, 32).reshape(48, 32)
    want = ref.moe._route(jnp.asarray(xf), jp["router"], 2)
    got = TM._route(_t(xf), tp["router"], 2)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=0)
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))
    # ties go to the lower index, as jax.lax.top_k
    probs, top_p, top_e = TM._route(torch.zeros((2, 32)), tp["router"], 2)
    assert top_e.tolist() == [[0, 1], [0, 1]]


def _port_fed(ref, xj, jp, tp, tcfg, acfg):
    """The port's dispatch, experts and combine on the reference's tokens
    ``xj`` (B, S, D), fed the reference's routing of them (computed in the
    caller's jit mode)."""
    import jax.numpy as jnp
    b, s, d = xj.shape
    t, k = b * s, tcfg.moe_top_k
    _, top_p, top_e = ref.moe._route(xj.reshape(t, d), jp["router"], k)
    xf = _t(np.asarray(xj.astype(jnp.float32))).to(tcfg.param_dtype)
    xf = xf.reshape(t, d)
    geo = TM.dispatch_geometry(tcfg, t)
    xe, counts, keep, src = TM.dispatch(xf, _t(top_e).long(), geo)
    ye = TM._expert_ffn(xe, tp, acfg, counts)
    return TM.combine(ye, keep, src, _t(top_p), t, k).reshape(b, s, d)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", ["fused_grouped", "vmap"])
def test_moe_block_fed_reference_routing_bitwise(ref, route, dtype):
    """Dispatch, the three grouped expert GEMMs and combine, fed the
    reference's routing: the reference's moe_block bit for bit; bfloat16
    against its op-by-op run. t = 24 tokens: 8 dispatch blocks of 3."""
    import jax
    import jax.numpy as jnp
    jcfg, tcfg, jp, tp = _moe(ref, dtype)
    jacfg, tacfg = _acfgs(ref)
    if route == "vmap":       # a non-kernel ACU audits to the vmap route
        jacfg = ref.core.ApproxConfig(acu=ref.core.make_acu(MULT, "lut"))
        tacfg = ApproxConfig(acu=make_acu(MULT, "lut"))
    xj = jnp.asarray(_tokens(2, 12, 32, seed=1), jnp.dtype(dtype))
    with jax.disable_jit(), torch.inference_mode():
        want = ref.moe.moe_block(xj, jp, jcfg, jacfg)
        got = _port_fed(ref, xj, jp, tp, tcfg, tacfg)
    assert got.dtype == tcfg.param_dtype
    assert np.array_equal(_bits(got), _bits(jnp.asarray(want, jnp.float32)))


@pytest.mark.parametrize("route", ["exact", "fake_quant"])
def test_moe_block_float_paths_match_reference(ref, route):
    """The float MoE (no ACU) and the per-expert QAT composition
    (``fake_quant_only``): float32 products summed in another order, so
    within rtol 1e-5 of the output's scale, fed the reference's routing
    and with the port's own."""
    import jax.numpy as jnp
    jcfg, tcfg, jp, tp = _moe(ref)
    jacfg = tacfg = None
    if route == "fake_quant":
        jacfg, tacfg = (dataclasses.replace(a, fake_quant_only=True)
                        for a in _acfgs(ref))
    x = _tokens(2, 12, 32, seed=2)
    want = np.asarray(ref.moe.moe_block(jnp.asarray(x), jp, jcfg, jacfg))
    got = _port_fed(ref, jnp.asarray(x), jp, tp, tcfg, tacfg).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    got2 = TM.moe_block(_t(x), tp, tcfg, tacfg).numpy()
    assert np.abs(got2 - want).max() <= 1e-5 * np.abs(want).max()


def test_moe_stats_match_reference(ref):
    """``aux_loss`` equals router_aux_loss bit for bit (one routing serves
    both) and the reference's within rtol 1e-6; ``dropped_frac`` is 0 at
    ample capacity."""
    import jax.numpy as jnp
    jcfg, tcfg, jp, tp = _moe(ref)
    x = _tokens(2, 8, 32, seed=3)
    out, stats = TM.moe_block(_t(x), tp, tcfg, None, return_stats=True)
    alone = TM.router_aux_loss(_t(x), tp["router"], 4, 2)
    assert torch.equal(stats["aux_loss"], alone)
    _, jstats = ref.moe.moe_block(jnp.asarray(x), jp, jcfg, None,
                                  return_stats=True)
    np.testing.assert_allclose(float(stats["aux_loss"]),
                               float(jstats["aux_loss"]), rtol=1e-6)
    assert float(stats["dropped_frac"]) == 0.0
    assert out.shape == x.shape


def test_dropped_frac_at_low_capacity(ref):
    """moe_capacity=0.25 forces drops (t = 24: 8 blocks of 3 tokens, one
    slot per expert): ``dropped_frac`` equals the reference's, and an
    independent first-come-first-served replay of the routing."""
    import jax.numpy as jnp
    jcfg, tcfg, jp, tp = _moe(ref, moe_capacity=0.25)
    x = _tokens(2, 12, 32, seed=4)
    jacfg, tacfg = _acfgs(ref)
    out, stats = TM.moe_block(_t(x), tp, tcfg, tacfg, return_stats=True)
    jout, jstats = ref.moe.moe_block(jnp.asarray(x), jp, jcfg, jacfg,
                                     return_stats=True)
    assert bool(torch.isfinite(out).all())
    geo = TM.dispatch_geometry(tcfg, 24)
    _, _, top_e = TM._route(_t(x).reshape(24, 32), tp["router"], 2)
    dropped = 0
    for blk in top_e.reshape(geo["n_blocks"], -1).tolist():
        used = np.zeros(4, int)
        for e in blk:
            dropped += used[e] >= geo["capacity"]
            used[e] += 1
    assert dropped > 0
    assert float(stats["dropped_frac"]) == float(jstats["dropped_frac"]) \
        == pytest.approx(dropped / 48, abs=1e-7)
    assert bool(np.isfinite(np.asarray(jout)).all())


def test_moe_block_exact_lut_vs_float():
    """With the exact multiplier's table the grouped MoE matches the float
    MoE within quantization error: the dispatch -> grouped GEMM -> combine
    path is wired right."""
    tcfg = ModelConfig(**CFG_MOE)
    g = torch.Generator().manual_seed(0)
    p = {"router": torch.randn((32, 4), generator=g) * 32 ** -0.5,
         "w_gate": torch.randn((4, 32, 16), generator=g) * 32 ** -0.5,
         "w_up": torch.randn((4, 32, 16), generator=g) * 32 ** -0.5,
         "w_down": torch.randn((4, 16, 32), generator=g) * 16 ** -0.5}
    x = torch.randn((2, 8, 32), generator=g) * 0.1
    acfg = ApproxConfig(acu=make_acu("mul8s_exact", "lut", use_kernels=True,
                                     fused=True))
    out = TM.moe_block(x, p, tcfg, acfg)
    want = TM.moe_block(x, p, tcfg, None)
    assert bool(torch.isfinite(out).all())
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=0.1,
                               atol=0.05)


def test_moe_block_grads_and_dense_reference():
    """Gradients through the grouped STE reach every parameter the route
    uses; the float MoE equals every expert computed densely and combined
    with the top-k weights."""
    tcfg = ModelConfig(**CFG_MOE)
    g = torch.Generator().manual_seed(1)
    p = {"router": torch.randn((32, 4), generator=g) * 32 ** -0.5,
         "w_gate": torch.randn((4, 32, 16), generator=g) * 32 ** -0.5,
         "w_up": torch.randn((4, 32, 16), generator=g) * 32 ** -0.5,
         "w_down": torch.randn((4, 16, 32), generator=g) * 16 ** -0.5}
    x = torch.randn((2, 8, 32), generator=g)
    acfg = ApproxConfig(acu=make_acu(MULT, "lut", use_kernels=True,
                                     fused=True))
    q = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    (TM.moe_block(x, q, tcfg, acfg) ** 2).sum().backward()
    for k in ("w_gate", "w_up", "w_down"):
        assert bool(torch.isfinite(q[k].grad).all())
        assert float(q[k].grad.abs().max()) > 0

    xf = x.reshape(16, 32)
    _, top_p, top_e = TM._route(xf, p["router"], 2)
    outs = torch.stack([(TM.silu(xf @ p["w_gate"][e]) * (xf @ p["w_up"][e]))
                        @ p["w_down"][e] for e in range(4)], 1)
    wts = torch.zeros((16, 4)).scatter(1, top_e, top_p)
    dense = (wts[..., None] * outs).sum(1).reshape(2, 8, 32)
    np.testing.assert_allclose(TM.moe_block(x, p, tcfg, None).numpy(),
                               dense.numpy(), rtol=1e-4, atol=1e-4)


def test_router_aux_loss_balanced_lower():
    """A balanced random router scores a lower aux loss than a skewed
    one."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((1, 512, 32), generator=g).abs() + 0.5
    balanced = torch.randn((32, 4), generator=g) * 0.1
    skewed = torch.zeros((32, 4))
    skewed[:, 0], skewed[:, 1] = 1.0, 0.5
    assert float(TM.router_aux_loss(x, balanced, 4, 2)) < \
        float(TM.router_aux_loss(x, skewed, 4, 2))

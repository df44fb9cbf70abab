"""The Mamba block on the CPU: the port's ``_ssm_scan``, ``softplus`` and
``mamba_block`` against the JAX reference's, at the reference's
``test_blocks.py`` block config (d 32, d_inner 64, d_state 4, d_conv 3),
with the reference's parameters carried over by ``load_jax_params``.
jamba-v0.1-52b's model is held in ``test_torch_mamba_lm.py`` and its
engines in ``test_torch_mamba_engines.py``.

Tolerances, with their reasons:

* The selective scan, against the reference's ``associative_scan`` run op
  by op (``jax.disable_jit``): bitwise. The port reproduces the
  recursion's pairings, and every multiply and add rounds on its own in
  both. Compiled, XLA contracts ``a2 * b1 + b2`` into one FMA, which moves
  each combine by at most half an ulp of its product; an output passes
  through at most ``2 * ceil(log2 S)`` combines, every ``|a| <= 1`` and
  every partial ``b`` is at most ``sum_t |dBx_t|``, so the compiled scan is
  held within ``2 * ceil(log2 S) * eps * max sum_t |dBx_t|``.
* ``softplus``: bfloat16 bitwise op by op; float32 within 2 ulp of the
  largest value (XLA's ``exp`` and ``log1p`` round an ulp apart from
  PyTorch's).
* The block in float32: outputs and states within ``LOGIT_TOL`` (1e-5) of
  the largest value. XLA's ``exp``, ``log1p`` and logistic round an ulp or
  two apart from PyTorch's, and the ``C``-contraction sums 16 products in
  another order; one flipped activation code would move a value by a
  table step times two scales, far beyond it.
* The block in bfloat16: outputs and the conv tail bitwise against the
  reference run op by op; the float32 SSM state within ``LOGIT_TOL``.
"""
from __future__ import annotations

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.models import mamba as TM  # noqa: E402
from repro_torch.models.transformer import load_jax_params  # noqa: E402
from test_torch_lm import LOGIT_TOL, _acfgs, _np  # noqa: E402
from test_torch_parity import load_reference  # noqa: E402

EPS = float(np.finfo(np.float32).eps)
# the reference's test_blocks.py block config
MCFG = dict(name="m", family="hybrid", n_layers=1, d_model=32, n_heads=2,
            n_kv_heads=2, d_ff=64, vocab_size=64, pattern=("mamba",),
            mamba_d_state=4, mamba_d_conv=3, dtype="float32")


@pytest.fixture(scope="module")
def ref():
    load_reference()
    import repro.configs as jconfigs
    import repro.models.layers as jlayers
    import repro.models.mamba as jmamba
    import repro.models.transformer as jtrans
    return jconfigs, jlayers, jtrans, jmamba


def _block_params(ref, cfg_kw, seed=0):
    """One layer's mamba leaves from the reference's ``_init_mamba``, for
    both packages (``dt_bias`` raised so that softplus works away from its
    tail, ``conv_b`` and ``Dskip`` drawn: the init leaves them flat)."""
    import jax
    import repro.configs.base as jbase
    jcfg = jbase.ModelConfig(**cfg_kw)
    jp = jax.tree.map(lambda a: np.asarray(a[0]),
                      ref[2]._init_mamba(jax.random.PRNGKey(seed), jcfg, 1))
    rng = np.random.default_rng(seed)
    for name in ("dt_bias", "conv_b", "Dskip"):
        jp[name] = rng.normal(size=jp[name].shape).astype(jp[name].dtype)
    return jcfg, jp, load_jax_params(jp, device="cpu")


def _state_pair(b, cfg, rng):
    conv = rng.normal(size=(b, cfg.mamba_d_conv - 1,
                            cfg.mamba_d_inner)).astype(np.float32)
    ssm = rng.normal(size=(b, cfg.mamba_d_inner,
                           cfg.mamba_d_state)).astype(np.float32)
    return conv, ssm


def _close(got, want, tol=LOGIT_TOL):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape
    assert np.abs(g - w).max() <= tol * np.abs(w).max()


# ---------------------------------------------------------------------------
# the scan and the activations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h0", ["none", "zeros", "random"])
@pytest.mark.parametrize("s", [1, 2, 7, 16, 33])
def test_ssm_scan_matches_reference(ref, s, h0):
    """Bitwise against the reference's associative scan op by op; within
    the FMA bound (module docstring) against it compiled."""
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(s)
    dA = np.exp(-rng.uniform(0, 2, (2, s, 8, 4))).astype(np.float32)
    dBx = rng.normal(size=(2, s, 8, 4)).astype(np.float32)
    h = {"none": None, "zeros": np.zeros((2, 8, 4), np.float32),
         "random": rng.normal(size=(2, 8, 4)).astype(np.float32)}[h0]
    args_j = [jnp.asarray(dA), jnp.asarray(dBx),
              None if h is None else jnp.asarray(h)]
    with jax.disable_jit():
        want = np.asarray(ref[3]._ssm_scan(*args_j))
    compiled = np.asarray(jax.jit(ref[3]._ssm_scan)(*args_j))
    got = TM._ssm_scan(torch.from_numpy(dA), torch.from_numpy(dBx),
                       None if h is None else torch.from_numpy(h)).numpy()
    assert np.array_equal(got, want)
    folded = np.abs(dBx).sum(1) + (0 if h is None else np.abs(h))
    bound = 2 * max(1, math.ceil(math.log2(s))) * EPS * folded.max()
    assert np.abs(got - compiled).max() <= bound


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softplus_matches_reference(ref, dtype):
    """``jax.nn.softplus``'s op chain: bfloat16 bitwise op by op, float32
    within 2 ulp of the largest value; far above F.softplus's threshold
    of 20 too."""
    import jax
    import jax.numpy as jnp
    x = np.random.default_rng(3).normal(size=2000).astype(np.float32) * 12
    x[:3] = (np.nan, 30.0, -30.0)
    xj = jnp.asarray(x, dtype)
    with jax.disable_jit():
        want = _np(jax.nn.softplus(xj))
    got = _np(TM.softplus(torch.from_numpy(_np(xj)).to(getattr(torch,
                                                              dtype))))
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    if dtype == "bfloat16":
        assert np.array_equal(got[ok], want[ok])
    else:
        scale = np.abs(want[ok]).max()
        assert np.abs(got[ok] - want[ok]).max() <= 2 * EPS * scale


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["exact", "fused"])
def test_mamba_block_prefill_then_decode(ref, route):
    """A 9-token prefill without a state, then a 5-token prefill from a
    random state and one decode step, against the reference's
    ``mamba_block`` on the same route: outputs and states within
    ``LOGIT_TOL``."""
    import jax.numpy as jnp
    jcfg, jp, tp = _block_params(ref, MCFG)
    cfg = ModelConfig(**MCFG)
    jacfg, tacfg = _acfgs(ref, route)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 9, 32)).astype(np.float32)
    conv, ssm = _state_pair(2, cfg, rng)
    jstate = ref[3].MambaState(conv=jnp.asarray(conv), ssm=jnp.asarray(ssm))
    with torch.inference_mode():
        y0, st0 = TM.mamba_block(torch.from_numpy(x), tp, cfg, tacfg)
        st = TM.MambaState(torch.from_numpy(conv.copy()),
                           torch.from_numpy(ssm.copy()))
        y1, st = TM.mamba_block(torch.from_numpy(x[:, :5]), tp, cfg, tacfg,
                                state=st)
        y2, st = TM.mamba_block(torch.from_numpy(x[:, 5:6]), tp, cfg, tacfg,
                                state=st, decode=True)
    wy0, wst0 = ref[3].mamba_block(jnp.asarray(x), jp, jcfg, jacfg)
    wy1, wst = ref[3].mamba_block(jnp.asarray(x[:, :5]), jp, jcfg, jacfg,
                                  state=jstate)
    wy2, wst = ref[3].mamba_block(jnp.asarray(x[:, 5:6]), jp, jcfg, jacfg,
                                  state=wst, decode=True)
    for g, w in ((y0, wy0), (st0.conv, wst0.conv), (st0.ssm, wst0.ssm),
                 (y1, wy1), (y2, wy2), (st.conv, wst.conv),
                 (st.ssm, wst.ssm)):
        _close(g, w)


def test_mamba_block_bfloat16_bitwise_op_by_op(ref):
    """bfloat16, exact GEMMs: a prefill from a state and a decode step
    give the reference's outputs and conv tail, run op by op, bit for bit
    (the conv's products and partial sums, softplus, silu and the casts
    round as the reference's do); the float32 SSM state within
    ``LOGIT_TOL`` (its float32 ``exp`` rounds an ulp apart from XLA's)."""
    import jax
    import jax.numpy as jnp
    kw = dict(MCFG, dtype="bfloat16")
    jcfg, jp, tp = _block_params(ref, kw)
    cfg = ModelConfig(**kw)
    rng = np.random.default_rng(10)
    xj = jnp.asarray(rng.normal(size=(2, 7, 32)), jnp.bfloat16)
    conv, ssm = _state_pair(2, cfg, rng)
    conv_j = jnp.asarray(conv, jnp.bfloat16)
    with jax.disable_jit():
        st = ref[3].MambaState(conv=conv_j, ssm=jnp.asarray(ssm))
        w1, st = ref[3].mamba_block(xj[:, :6], jp, jcfg, None, state=st)
        w2, st = ref[3].mamba_block(xj[:, 6:], jp, jcfg, None, state=st,
                                    decode=True)
    bf = torch.bfloat16
    x = torch.from_numpy(_np(xj)).to(bf)
    tst = TM.MambaState(torch.from_numpy(_np(conv_j)).to(bf),
                        torch.from_numpy(ssm.copy()))
    with torch.inference_mode():
        g1, tst = TM.mamba_block(x[:, :6], tp, cfg, None, state=tst)
        g2, tst = TM.mamba_block(x[:, 6:], tp, cfg, None, state=tst,
                                 decode=True)
    for g, w in ((g1, w1), (g2, w2), (tst.conv, st.conv)):
        assert g.dtype == bf
        assert np.array_equal(g.view(torch.int16).numpy(),
                              np.asarray(w).view(np.int16))
    _close(tst.ssm, st.ssm)


def test_mamba_parallel_vs_stepwise(ref):
    """Mirror of ``test_blocks.py::test_mamba_parallel_vs_stepwise``: the
    scan (prefill) equals the token-by-token recurrence (decode), at the
    reference test's tolerance; and the scan's output is the reference's
    within ``LOGIT_TOL``."""
    import jax.numpy as jnp
    jcfg, jp, tp = _block_params(ref, MCFG)
    cfg = ModelConfig(**MCFG)
    x = np.random.default_rng(5).normal(size=(2, 6, 32)).astype(np.float32)
    xt = torch.from_numpy(x)
    y_par, st_par = TM.mamba_block(xt, tp, cfg, None)
    st = TM.MambaState(conv=torch.zeros((2, cfg.mamba_d_conv - 1,
                                         cfg.mamba_d_inner)),
                       ssm=torch.zeros((2, cfg.mamba_d_inner,
                                        cfg.mamba_d_state)))
    outs = []
    for t in range(6):
        y, st = TM.mamba_block(xt[:, t:t + 1], tp, cfg, None, state=st,
                               decode=True)
        outs.append(y)
    y_seq = torch.cat(outs, dim=1)
    np.testing.assert_allclose(y_par.detach().numpy(), y_seq.numpy(),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(st_par.ssm.numpy(), st.ssm.numpy(),
                               rtol=2e-3, atol=2e-3)
    want, _ = ref[3].mamba_block(jnp.asarray(x), jp, jcfg, None)
    _close(y_par, want)


def test_mamba_state_carries_context(ref):
    """Mirror of ``test_blocks.py::test_mamba_state_carries_context``: a
    6-token prefix through the state, then the rest as decode (one call of
    four tokens, the scan seeded by the state), equals the full sequence;
    and the tail equals the reference's."""
    import jax.numpy as jnp
    jcfg, jp, tp = _block_params(ref, MCFG)
    cfg = ModelConfig(**MCFG)
    x = np.random.default_rng(6).normal(size=(1, 10, 32)).astype(np.float32)
    xt = torch.from_numpy(x)
    y_full, _ = TM.mamba_block(xt, tp, cfg, None)
    st = TM.MambaState(conv=torch.zeros((1, 2, cfg.mamba_d_inner)),
                       ssm=torch.zeros((1, cfg.mamba_d_inner, 4)))
    _, st = TM.mamba_block(xt[:, :6], tp, cfg, None, state=st)
    y_tail, _ = TM.mamba_block(xt[:, 6:], tp, cfg, None, state=st,
                               decode=True)
    np.testing.assert_allclose(y_full[:, 6:].detach().numpy(),
                               y_tail.detach().numpy(), rtol=2e-3, atol=2e-3)
    jst = ref[3].MambaState(conv=jnp.zeros((1, 2, cfg.mamba_d_inner)),
                            ssm=jnp.zeros((1, cfg.mamba_d_inner, 4)))
    _, jst = ref[3].mamba_block(jnp.asarray(x[:, :6]), jp, jcfg, None,
                                state=jst)
    want, _ = ref[3].mamba_block(jnp.asarray(x[:, 6:]), jp, jcfg, None,
                                 state=jst, decode=True)
    _close(y_tail, want)


def test_mamba_state_written_in_place(ref):
    """Given views of a cache, the block writes the new conv tail and SSM
    state into them and returns those views; without a state it returns
    fresh tensors holding the same values."""
    _, _, tp = _block_params(ref, MCFG)
    cfg = ModelConfig(**MCFG)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(2, 5, 32)).astype(np.float32))
    cache = TM.MambaState(conv=torch.zeros((3, 2, 2, cfg.mamba_d_inner)),
                          ssm=torch.zeros((3, 2, cfg.mamba_d_inner, 4)))
    view = TM.MambaState(conv=cache.conv[1], ssm=cache.ssm[1])
    with torch.inference_mode():
        y, st = TM.mamba_block(x, tp, cfg, None, state=view)
        y_fresh, fresh = TM.mamba_block(
            x, tp, cfg, None,
            state=TM.MambaState(torch.zeros_like(view.conv),
                                torch.zeros_like(view.ssm)))
    assert st.conv is view.conv and st.ssm is view.ssm
    assert torch.equal(cache.conv[1], fresh.conv)
    assert torch.equal(cache.ssm[1], fresh.ssm)
    assert torch.equal(cache.conv[1], TM.mamba_block(
        x, tp, cfg, None)[1].conv)
    assert not cache.ssm[0].any() and not cache.ssm[2].any()
    assert torch.equal(y, y_fresh)

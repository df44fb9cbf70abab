"""The rest of Table 2's models and tasks against the JAX reference on the
CPU: the RNN family (LSTM, GRU and RNN cells, ``lstm`` over a sequence,
with gradients), the SqueezeNet-style CNN, the VAE and the GAN, and the
text-classification and blob tasks. Mirrors ``tests/test_rnn.py``.

Tolerance. Every GEMM goes through ``approx_dense``: on the same inputs
its output is the reference's bit for bit (integer modes) or within the
LOWRANK summation bound. What differs is the float glue between GEMMs:
``sigmoid``, ``tanh``, ``exp`` and ``log`` round differently in XLA and in
PyTorch (a few ulp each), and the exact STE gradients sum in another
order. Outputs are held to ``rtol 1e-5, atol 1e-6`` (relative to the
largest entry for gradients: ``GRAD_TOL``). An activation code that flipped
because of such an ulp would move a gate or a logit by one LUT step times
the two scales (1e-3 or more at these sizes) and fail this bound loudly;
on these inputs none flips.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import ApproxConfig, make_acu  # noqa: E402
from repro_torch.core.approx_ops import approx_dense  # noqa: E402
from repro_torch.data.pipeline import blob_task, text_cls_task  # noqa: E402
from repro_torch.models import rnn as trnn  # noqa: E402
from repro_torch.models import vision as tv  # noqa: E402
from test_torch_parity import load_reference  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
GRAD_TOL = 1e-5       # of the gradient's largest entry

# (mode, multiplier) per config; None is exact float
CONFIGS = [(None, None), ("exact", "mul8s_exact"), ("lut", "mul8s_1L2H"),
           ("lowrank", "mul8s_1L2H")]
CONFIG_IDS = ["float", "exact", "lut", "lowrank"]


@pytest.fixture(scope="module")
def ref():
    ref = load_reference()
    import importlib
    importlib.import_module("repro.models.rnn")
    importlib.import_module("repro.data.pipeline")
    return ref


def _cfgs(ref, mode, name):
    if mode is None:
        return None, None
    return (ref.core.ApproxConfig(acu=ref.core.make_acu(name, mode)),
            ApproxConfig(acu=make_acu(name, mode)))


def _params(params) -> dict:
    return trnn.load_jax_params({k: np.asarray(v) for k, v in params.items()},
                                device="cpu")


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _grads_close(got: dict, want: dict):
    for k in want:
        w = np.asarray(want[k])
        _close(got[k], w, rtol=0, atol=GRAD_TOL * max(np.abs(w).max(), 1e-30))


# ---------------------------------------------------------------------------
# RNN family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,name", CONFIGS, ids=CONFIG_IDS)
def test_cells_match_reference(ref, mode, name):
    """One step of each cell from the same state: the gate GEMMs bitwise
    (integer modes) and the cells' outputs within the float tolerance."""
    import jax
    import jax.numpy as jnp
    jr = ref.models.rnn
    key = jax.random.PRNGKey(0)
    jc, tc = _cfgs(ref, mode, name)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 8)).astype(np.float32)
    h = rng.normal(size=(3, 16)).astype(np.float32) * 0.5
    c = rng.normal(size=(3, 16)).astype(np.float32)
    xt, ht, ct = map(torch.from_numpy, (x, h, c))
    xj, hj, cj = map(jnp.asarray, (x, h, c))
    pl, pg, pr = (jr.init_lstm(key, 8, 16), jr.init_gru(key, 8, 16),
                  jr.init_rnn(key, 8, 16))
    tl, tg, tr_ = _params(pl), _params(pg), _params(pr)
    if mode not in (None, "lowrank"):
        got = approx_dense(ht, tl["wh"], tl["b"], tc).numpy()
        want = np.asarray(ref.core.approx_dense(hj, pl["wh"], pl["b"], jc))
        assert np.array_equal(got, want)
    h1t, c1t = trnn.lstm_cell(xt, ht, ct, tl, tc)
    h1j, c1j = jr.lstm_cell(xj, hj, cj, pl, jc)
    _close(h1t, h1j)
    _close(c1t, c1j)
    _close(trnn.gru_cell(xt, ht, tg, tc), jr.gru_cell(xj, hj, pg, jc))
    _close(trnn.rnn_cell(xt, ht, tr_, tc), jr.rnn_cell(xj, hj, pr, jc))


@pytest.mark.parametrize("mode,name", CONFIGS, ids=CONFIG_IDS)
def test_lstm_and_gradients_match_reference(ref, mode, name):
    """``lstm`` (a loop over time) against the reference's scan, and the
    gradients of a loss through it against ``jax.grad`` (the STE's exact
    backward on the approximate configs)."""
    import jax
    import jax.numpy as jnp
    jr = ref.models.rnn
    jc, tc = _cfgs(ref, mode, name)
    pj = jr.init_lstm(jax.random.PRNGKey(0), 8, 16)
    xs = np.random.default_rng(0).normal(size=(4, 6, 8)).astype(np.float32)
    want = jr.lstm(jnp.asarray(xs), pj, jc)
    gj = jax.grad(lambda p: (jr.lstm(jnp.asarray(xs), p, jc) ** 2).sum())(pj)
    pt = {k: v.requires_grad_(True) for k, v in _params(pj).items()}
    got = trnn.lstm(torch.from_numpy(xs), pt, tc)
    (got ** 2).sum().backward()
    assert got.shape == (4, 16)
    _close(got.detach(), want)
    _grads_close({k: v.grad for k, v in pt.items()}, gj)


def test_lstm_cell_manual():
    p = trnn.init_lstm(0, 4, 3, device="cpu")
    x = torch.randn(2, 4, generator=torch.Generator().manual_seed(0))
    h, c = torch.zeros(2, 3), torch.zeros(2, 3)
    h1, c1 = trnn.lstm_cell(x, h, c, p, None)
    gates = x @ p["wx"] + h @ p["wh"] + p["b"]
    i, f, g, o = torch.chunk(gates, 4, -1)
    c_ref = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_ref = torch.sigmoid(o) * torch.tanh(c_ref)
    _close(h1, h_ref)
    _close(c1, c_ref)


def test_lstm_loop_equals_cell_steps():
    p = trnn.init_lstm(0, 4, 3, device="cpu")
    xs = torch.randn(2, 5, 4, generator=torch.Generator().manual_seed(1))
    h, c = torch.zeros(2, 3), torch.zeros(2, 3)
    for t in range(5):
        h, c = trnn.lstm_cell(xs[:, t], h, c, p, None)
    assert torch.equal(trnn.lstm(xs, p), h)


def test_lstm_approx_runs_and_grads():
    """Every mode's ACU in the loop, with kernels asked for (CPU tensors
    take the plain versions): finite gradients for every parameter."""
    xs = torch.randn(4, 6, 8, generator=torch.Generator().manual_seed(2))
    for mode, name in CONFIGS[1:] + [("functional", "mul8s_1L2H"),
                                     ("factored", "mul8s_trunc2")]:
        acfg = ApproxConfig(acu=make_acu(name, mode, use_kernels=True,
                                         fused=True))
        p = {k: v.requires_grad_(True)
             for k, v in trnn.init_lstm(0, 8, 16, device="cpu").items()}
        (trnn.lstm(xs, p, acfg) ** 2).sum().backward()
        assert all(bool(torch.isfinite(v.grad).all()) for v in p.values())


def test_inits_shapes_and_devices():
    for init, gates in ((trnn.init_lstm, 4), (trnn.init_gru, 3),
                        (trnn.init_rnn, 1)):
        p = init(3, 5, 7, device="cpu")
        assert p["wx"].shape == (5, gates * 7) and p["b"].shape == (gates * 7,)
        assert p["wh"].device.type == "cpu"
        assert torch.equal(p["wx"], init(3, 5, 7, device="cpu")["wx"])


# ---------------------------------------------------------------------------
# SqueezeNet, VAE, GAN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,name", CONFIGS[:3], ids=CONFIG_IDS[:3])
def test_squeezenet_matches_reference(ref, mode, name, monkeypatch):
    """Every conv output bitwise on the integer configs (the fire modules'
    1x1 and 3x3 convs, the concat, the max-pools); the logits within the
    float tolerance (the global mean pool sums in another order)."""
    import jax
    import jax.numpy as jnp
    from test_torch_parity import _record
    jv = ref.models.vision
    jc, tc = _cfgs(ref, mode, name)
    params = jv.init_squeezenet(jax.random.PRNGKey(2), width=4)
    x = np.random.default_rng(2).normal(size=(2, 3, 8, 8)).astype(
        np.float32)
    j_outs = _record(monkeypatch, jv)
    yj = np.asarray(jv.squeezenet_forward(params, jnp.asarray(x), jc))
    t_outs = _record(monkeypatch, tv)
    tp = tv.load_jax_params({k: np.asarray(v) for k, v in params.items()},
                            device="cpu")
    with torch.inference_mode():
        yt = tv.squeezenet_forward(tp, torch.from_numpy(x), tc).numpy()
    assert len(t_outs) == len(j_outs) == 10
    for i, (a, b) in enumerate(zip(t_outs, j_outs)):
        if mode is None:
            _close(a, b, rtol=1e-4, atol=1e-5 * np.abs(b).max())
        else:
            assert np.array_equal(a, b), f"conv {i}"
    _close(yt, yj, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mode,name", CONFIGS, ids=CONFIG_IDS)
def test_vae_matches_reference(ref, mode, name):
    """The VAE with the reference's noise draw fed in: reconstruction, mu,
    logvar and the loss within the float tolerance, and the loss's
    gradients within ``GRAD_TOL``."""
    import jax
    import jax.numpy as jnp
    jv = ref.models.vision
    jc, tc = _cfgs(ref, mode, name)
    key = jax.random.PRNGKey(3)
    params = jv.init_vae(key, d_in=64, d_h=32, d_z=8)
    x = np.clip(np.random.default_rng(3).normal(size=(5, 64)) * 0.3 + 0.5,
                0, 1).astype(np.float32)
    eps = np.asarray(jax.random.normal(key, (5, 8)))
    recon_j, mu_j, lv_j = jv.vae_forward(params, jnp.asarray(x), key, jc)
    assert np.array_equal(np.asarray(jax.random.normal(key, mu_j.shape)),
                          eps)
    lj, gj = jax.value_and_grad(jv.vae_loss)(params, jnp.asarray(x), key, jc)
    tp = {k: v.requires_grad_(True)
          for k, v in tv.load_jax_params(
              {k: np.asarray(v) for k, v in params.items()},
              device="cpu").items()}
    recon, mu, lv = tv.vae_forward(tp, torch.from_numpy(x),
                                   torch.from_numpy(eps), tc)
    for a, b in ((recon, recon_j), (mu, mu_j), (lv, lv_j)):
        _close(a.detach(), b)
    lt = tv.vae_loss(tp, torch.from_numpy(x), torch.from_numpy(eps), tc)
    lt.backward()
    _close(lt.detach(), lj)
    _grads_close({k: v.grad for k, v in tp.items()}, gj)


def test_vae_draws_noise_from_a_generator():
    p = tv.init_vae(0, d_in=16, d_h=8, d_z=4, device="cpu")
    x = torch.rand(3, 16, generator=torch.Generator().manual_seed(0))
    r1 = tv.vae_forward(p, x, torch.Generator().manual_seed(5))[0]
    r2 = tv.vae_forward(p, x, torch.Generator().manual_seed(5))[0]
    r3 = tv.vae_forward(p, x, torch.Generator().manual_seed(6))[0]
    assert torch.equal(r1, r2) and not torch.equal(r1, r3)


@pytest.mark.parametrize("mode,name", CONFIGS, ids=CONFIG_IDS)
def test_gan_matches_reference(ref, mode, name):
    import jax
    import jax.numpy as jnp
    jv = ref.models.vision
    jc, tc = _cfgs(ref, mode, name)
    params = jv.init_gan(jax.random.PRNGKey(4), d_z=8, d_h=32, d_out=64)
    z = np.random.default_rng(4).normal(size=(5, 8)).astype(np.float32)
    tp = tv.load_jax_params({k: np.asarray(v) for k, v in params.items()},
                            device="cpu")
    img_j = jv.gan_generator(params, jnp.asarray(z), jc)
    img_t = tv.gan_generator(tp, torch.from_numpy(z), tc)
    _close(img_t, img_j)
    # the discriminator on the same images: its input is bitwise equal
    d_j = jv.gan_discriminator(params, img_j, jc)
    d_t = tv.gan_discriminator(tp, torch.from_numpy(np.asarray(img_j)), tc)
    _close(d_t, d_j, rtol=1e-5, atol=1e-5)
    assert d_t.shape == (5, 1)


def test_init_shapes_match_reference(ref):
    import jax
    jv = ref.models.vision
    key = jax.random.PRNGKey(0)
    for ji, ti, kw in ((jv.init_squeezenet, tv.init_squeezenet,
                        dict(width=4)),
                       (jv.init_vae, tv.init_vae, dict(d_in=64, d_h=32)),
                       (jv.init_gan, tv.init_gan, dict(d_h=32))):
        pj, pt = ji(key, **kw), ti(0, device="cpu", **kw)
        assert {k: tuple(v.shape) for k, v in pt.items()} == \
            {k: tuple(v.shape) for k, v in pj.items()}


# ---------------------------------------------------------------------------
# tasks
# ---------------------------------------------------------------------------

def test_tasks_match_reference(ref):
    jp = ref.data.pipeline
    for jt, tt, kw, bkw in ((jp.text_cls_task, text_cls_task,
                             dict(vocab=200, n_classes=2),
                             dict(seq=24, seed=3)),
                            (jp.blob_task, blob_task, {}, dict(seed=4))):
        ij, it = jt(**kw)(8, **bkw), tt(**kw)(8, **bkw)
        for _ in range(3):
            bj, bt = next(ij), next(it)
            assert bj.keys() == bt.keys()
            for k in bj:
                assert bj[k].dtype == bt[k].dtype
                assert np.array_equal(bj[k], bt[k])

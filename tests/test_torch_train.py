"""The port's training slice against the JAX reference on the CPU.

The same numpy inputs go through both packages: the ``fake_quant`` STE,
the per-op VJPs of ``approx_dense`` and ``conv2d`` under the three
regimes, SGD and AdamW updates, and ``Trainer.fit`` on a small ResNet.
The reference's kernels run in Pallas interpret mode, the port's wrappers
their plain versions (CPU tensors).

The three regimes:

* ``exact``: the paper's, ``approx_bwd=False``: approximate forward on the
  fused kernels, exact float32 STE backward on the fake-quantized
  residuals. Float32 GEMM and col2im sums run in another order than XLA's,
  so the gradients match within ``rtol=1e-5``, not bitwise. A K-term dot
  product summed in another order moves by up to about ``K * eps`` times
  the sum of its terms' magnitudes, which for an entry near cancellation
  is large relative to the entry itself, so the absolute part scales with
  the tensor: ``atol = 1e-6 * max|grad|``.
* ``approx_fused``: ApproxTrain, ``approx_bwd=True`` on the fused ACU:
  dense gradients on ``fused_lut_bwd``, the conv weight gradient on
  ``fused_lut_conv_bwd_w``, the conv input gradient on ``fused_lut_bwd``
  with an integer col2im. Integer accumulators and the same float
  roundings on both sides: bitwise.
* ``approx_unfused``: ApproxTrain on the unfused ACU: both gradients
  quantized outside and run on ``lut_matmul``. The dense gradients, the
  conv weight gradient and the conv patch gradient are bitwise; the conv
  input gradient then goes through the float col2im (the adjoint of the
  im2col, ``F.fold`` here and a transposed patch convolution in XLA), whose
  sums of up to kh*kw dequantized terms run in another order: within
  ``rtol=1e-6, atol`` 4 ulp of the largest gradient.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (ApproxConfig, affine_qparams,  # noqa: E402
                              approx_dense, conv2d, fake_quantize, make_acu,
                              symmetric_qparams)
from repro_torch.data.pipeline import image_task  # noqa: E402
from repro_torch.optim.adamw import (SGD, AdamW, cosine_schedule,  # noqa: E402
                                     global_norm, load_jax_state)
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
from test_torch_parity import load_reference  # noqa: E402

MULT = "mul8s_1L2H"
REGIMES = {   # name: (make_acu flags, approx_bwd)
    "exact": (dict(use_kernels=True, fused=True), False),
    "approx_fused": (dict(use_kernels=True, fused=True), True),
    "approx_unfused": (dict(use_kernels=True), True),
}
F32_EPS = float(np.finfo(np.float32).eps)


@pytest.fixture(scope="module")
def ref():
    r = load_reference()
    import repro.optim.adamw  # noqa: F401
    import repro.train.trainer  # noqa: F401
    return r


def _configs(ref, regime: str):
    """The port's ApproxConfig for ``regime`` and the reference's."""
    kw, approx_bwd = REGIMES[regime]
    t = ApproxConfig(acu=make_acu(MULT, "lut", **kw), approx_bwd=approx_bwd)
    j = ref.core.ApproxConfig(
        acu=ref.core.make_acu(MULT, "lut",
                              use_pallas=kw.get("use_kernels", False),
                              fused=kw.get("fused", False)),
        approx_bwd=approx_bwd)
    return t, j


def _vjp_reference(fn, args, ct):
    import jax
    import jax.numpy as jnp
    y, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in args])
    return np.asarray(y), [np.asarray(g) for g in vjp(jnp.asarray(ct))]


def _vjp_port(fn, args, ct):
    ts = [torch.from_numpy(a.copy()).requires_grad_(True) for a in args]
    y = fn(*ts)
    y.backward(torch.from_numpy(ct))
    return y.detach().numpy(), [t.grad.numpy() for t in ts]


# ---------------------------------------------------------------------------
# the fake_quant STE
# ---------------------------------------------------------------------------

def test_fake_quant_ste_bitwise(ref):
    """Value and STE gradient bitwise, clip edges included: the gradient
    passes where ``x / s + z`` lies in ``[lo, hi]`` and is 0 outside."""
    import jax.numpy as jnp
    q = ref.core.quantization
    rng = np.random.default_rng(7)
    # scale 0.125 exactly: x = 15.875 and -16 sit on the edges, 15.9375 and
    # -16.0625 half a step outside
    edge = np.array([15.875, 15.9375, 16.5, -16.0, -16.0625, -40.0, 0.0625],
                    np.float32)
    x = np.concatenate([edge, (rng.normal(size=57) * 9).astype(np.float32)])
    g = rng.normal(size=x.shape).astype(np.float32)
    xs = np.abs(rng.normal(size=(8, 5)) * 3).astype(np.float32) + 0.1
    cases = [
        (x, g, symmetric_qparams(torch.tensor(15.875), 8),
         q.symmetric_qparams(jnp.float32(15.875), 8)),
        (x, g, affine_qparams(torch.tensor(-3.0), torch.tensor(9.5), 8),
         q.affine_qparams(jnp.float32(-3.0), jnp.float32(9.5), 8)),
        (xs * 2 - 3, rng.normal(size=xs.shape).astype(np.float32),
         symmetric_qparams(torch.from_numpy(xs.max(axis=0)), 8, axis=1),
         q.symmetric_qparams(jnp.asarray(xs.max(axis=0)), 8, axis=1)),
    ]
    for xv, gv, qt, qj in cases:
        yj, (gj,) = _vjp_reference(lambda a: q.fake_quantize(a, qj), [xv], gv)
        yt, (gt,) = _vjp_port(lambda a: fake_quantize(a, qt), [xv], gv)
        assert np.array_equal(yt, yj) and np.array_equal(gt, gj)
    assert gt.dtype == np.float32
    _, (g_edge,) = _vjp_port(lambda a: fake_quantize(a, cases[0][2]), [x], g)
    assert np.array_equal(g_edge[:7] != 0, [True, False, False, True, False,
                                            False, True])


def test_fake_quant_only_path_has_the_ste_gradient(ref):
    """The QAT fake-quant route of ``approx_dense`` is differentiable now,
    and its gradients are the reference's (a float GEMM: float32
    rounding)."""
    from repro_torch.core import make_acu as mk
    rng = np.random.default_rng(11)
    x = rng.normal(size=(6, 9)).astype(np.float32)
    w = rng.normal(size=(9, 4)).astype(np.float32)
    ct = rng.normal(size=(6, 4)).astype(np.float32)
    cfg_t = ApproxConfig(acu=mk(MULT), fake_quant_only=True)
    cfg_j = ref.core.ApproxConfig(acu=ref.core.make_acu(MULT),
                                  fake_quant_only=True)
    _, gj = _vjp_reference(
        lambda a, b: ref.core.approx_dense(a, b, None, cfg_j), [x, w], ct)
    _, gt = _vjp_port(lambda a, b: approx_dense(a, b, None, cfg_t), [x, w],
                      ct)
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# per-op VJPs under the three regimes
# ---------------------------------------------------------------------------

def _assert_grads(regime, got, want, *, conv_gx=False):
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and a.dtype == b.dtype
        if regime == "exact":
            np.testing.assert_allclose(a, b, rtol=1e-5,
                                       atol=1e-6 * np.abs(b).max())
        elif regime == "approx_unfused" and conv_gx and i == 0:
            np.testing.assert_allclose(
                a, b, rtol=1e-6, atol=4 * F32_EPS * np.abs(b).max())
        else:
            assert np.array_equal(a, b), f"gradient {i} of {regime}"


@pytest.mark.parametrize("regime", sorted(REGIMES))
@pytest.mark.parametrize("mkn", [(6, 20, 5), (33, 64, 10)])
def test_approx_dense_vjp_matches_reference(ref, regime, mkn):
    m, k, n = mkn
    rng = np.random.default_rng(m + k)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) * 0.3).astype(np.float32)
    b = rng.normal(size=n).astype(np.float32)
    ct = rng.normal(size=(m, n)).astype(np.float32)
    cfg_t, cfg_j = _configs(ref, regime)
    import jax.numpy as jnp
    yj, gj = _vjp_reference(
        lambda a, c: ref.core.approx_dense(a, c, jnp.asarray(b), cfg_j),
        [x, w], ct)
    yt, gt = _vjp_port(
        lambda a, c: approx_dense(a, c, torch.from_numpy(b), cfg_t), [x, w],
        ct)
    assert np.array_equal(yt, yj)
    _assert_grads(regime, gt, gj)


CONV_GEOMS = [  # (x_shape, w_shape, stride, padding)
    ((2, 3, 8, 8), (4, 3, 3, 3), (1, 1), "SAME"),
    ((2, 4, 9, 9), (6, 4, 3, 3), (2, 2), "SAME"),       # asymmetric pads
    ((2, 4, 8, 8), (5, 4, 1, 1), (2, 2), "VALID"),
    ((1, 3, 7, 6), (4, 3, 3, 2), (1, 2), ((2, 0), (1, 1))),
]


@pytest.mark.parametrize("regime", sorted(REGIMES))
@pytest.mark.parametrize("geom", CONV_GEOMS,
                         ids=["same3x3", "stride2", "shortcut1x1", "rect"])
def test_conv2d_vjp_matches_reference(ref, regime, geom):
    xs, ws, stride, padding = geom
    rng = np.random.default_rng(sum(xs) + sum(ws))
    x = rng.normal(size=xs).astype(np.float32)
    w = (rng.normal(size=ws) * 0.3).astype(np.float32)
    b = rng.normal(size=ws[0]).astype(np.float32)
    cfg_t, cfg_j = _configs(ref, regime)
    import jax.numpy as jnp
    yj0 = np.asarray(ref.core.conv2d(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b), stride=stride,
                                     padding=padding, cfg=cfg_j))
    ct = rng.normal(size=yj0.shape).astype(np.float32)
    yj, gj = _vjp_reference(
        lambda a, c: ref.core.conv2d(a, c, jnp.asarray(b), stride=stride,
                                     padding=padding, cfg=cfg_j), [x, w], ct)
    yt, gt = _vjp_port(
        lambda a, c: conv2d(a, c, torch.from_numpy(b), stride=stride,
                            padding=padding, cfg=cfg_t), [x, w], ct)
    assert np.array_equal(yt, yj)
    _assert_grads(regime, gt, gj, conv_gx=True)


def test_only_requested_gradients_are_computed(monkeypatch):
    """The stem's input is the image: no input gradient is computed for
    it, in either backward."""
    import repro_torch.core.approx_ops as ao
    calls = []
    inner = ao._banded_conv_bwd

    def spy(*args):
        bwd = inner(*args)

        def wrapped(g, xf, wf, need_gx, need_gw):
            calls.append((need_gx, need_gw, xf is None, wf is None))
            return bwd(g, xf, wf, need_gx, need_gw)
        return wrapped

    monkeypatch.setattr(ao, "_banded_conv_bwd", spy)
    cfg, _ = REGIMES["approx_fused"]
    acfg = ApproxConfig(acu=make_acu(MULT, "lut", **cfg), approx_bwd=True)
    w = torch.randn(4, 3, 3, 3, requires_grad=True)
    conv2d(torch.randn(2, 3, 6, 6), w, cfg=acfg).sum().backward()
    assert calls == [(False, True, False, True)] and w.grad is not None


def test_conv_plan_names_the_backward_route():
    from repro_torch.core import conv_plan_report
    for kw, bwd in [(dict(use_kernels=True, fused=True), "banded"),
                    (dict(use_kernels=True), None), (dict(), None)]:
        rep = conv_plan_report((2, 16, 32, 32), (16, 16, 3, 3),
                               ApproxConfig(acu=make_acu(MULT, "lut", **kw)))
        assert rep["bwd_route"] == bwd


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

SHAPES = {"w": (7, 5), "b": (5,), "conv": (4, 3, 3, 3)}


def _tree(rng, scale=1.0):
    return {k: (rng.normal(size=s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _optimizers(ref, name):
    jo = ref.optim.adamw
    if name == "sgd":
        return SGD(lr=1e-3), jo.SGD(lr=1e-3)
    if name == "sgd_momentum_clip":
        return (SGD(lr=1e-2, momentum=0.9, clip_norm=0.5),
                jo.SGD(lr=1e-2, momentum=0.9, clip_norm=0.5))
    if name == "adamw":
        return AdamW(lr=3e-3), jo.AdamW(lr=3e-3)
    return (AdamW(lr=cosine_schedule(1e-2, 2, 6), weight_decay=0.05,
                  clip_norm=None),
            jo.AdamW(lr=jo.cosine_schedule(1e-2, 2, 6), weight_decay=0.05,
                     clip_norm=None))


@pytest.mark.parametrize("name", ["sgd", "sgd_momentum_clip", "adamw",
                                  "adamw_cosine_wd"])
def test_optimizer_updates_match_reference(ref, name):
    """One and three updates from the same grads, params and state, held to
    float32 rounding (``rtol=2e-6``): XLA may fuse the moment updates'
    multiply and add, and its pow, sqrt and cos round like PyTorch's only
    most of the time. Plain SGD has one multiply and one subtract per
    element and matches bitwise."""
    import jax
    import jax.numpy as jnp
    topt, jopt = _optimizers(ref, name)
    rng = np.random.default_rng(3)
    p0 = _tree(rng)
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    pt = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    sj, st = jopt.init(pj), topt.init(pt)
    for step in range(3):
        g = _tree(rng, scale=0.5)
        pj, sj = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, sj,
                             pj)
        pt, st = topt.update({k: torch.from_numpy(v) for k, v in g.items()},
                             st, pt)
        if step in (0, 2):
            for k in SHAPES:
                a, b = pt[k].numpy(), np.asarray(pj[k])
                if name == "sgd":
                    assert np.array_equal(a, b), (step, k)
                np.testing.assert_allclose(a, b, rtol=2e-6, atol=1e-7)
    assert int(st.step) == int(sj.step) == 3
    # the reference's state carries across and continues identically
    cont = load_jax_state(jax.tree.map(np.asarray, sj), device="cpu")
    for field in cont._fields[1:]:
        for k in SHAPES:
            np.testing.assert_allclose(
                getattr(cont, field)[k].numpy(),
                np.asarray(getattr(sj, field)[k]), rtol=2e-6, atol=1e-7)
    assert int(cont.step) == 3


def test_global_norm_and_schedule_match_reference(ref):
    import jax.numpy as jnp
    jo = ref.optim.adamw
    tree = _tree(np.random.default_rng(5))
    np.testing.assert_allclose(
        float(global_norm({k: torch.from_numpy(v) for k, v in tree.items()})),
        float(jo.global_norm({k: jnp.asarray(v) for k, v in tree.items()})),
        rtol=1e-6)
    lt, lj = cosine_schedule(1e-3, 3, 20), jo.cosine_schedule(1e-3, 3, 20)
    for s in range(0, 25):
        np.testing.assert_allclose(float(lt(torch.tensor(s))),
                                   float(lj(jnp.asarray(s))), rtol=1e-6)


# ---------------------------------------------------------------------------
# Trainer.fit on a small ResNet
# ---------------------------------------------------------------------------

def _xent_torch(logits, labels):
    logz = torch.logsumexp(logits, -1)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    return (logz - gold).mean()


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_trainer_fit_matches_reference(ref, regime):
    """Width-4 ResNet, one block per stage, 8x8 images, batch 4, 3 SGD
    steps (lr 1e-3, momentum 0.9), the same batches and starting
    parameters through both packages' ``Trainer``.

    Losses agree within 1e-5 relative. Parameters: the forward codes and
    the integer gradient sums agree bit for bit, but the float glue (mean
    pool, log-sum-exp, bias-gradient sums) rounds differently, and a
    float32 ulp moved across a rounding boundary flips one code. One
    gradient-code flip moves one gradient entry by at most one LUT step
    times the two scales, ``dL * sa * sb`` with ``dL`` the table's largest
    step between neighbouring codes (2^8 here: at most 2 * 128), and
    ``sa * sb <= amax_a * amax_b / 127^2``, about ``|g|_max * 2 / 127`` of
    the layer's largest gradient. Through 3 momentum steps a gradient
    change reaches the parameter at most ``lr * (1 + 1.9 + 2.71)`` times.
    The bound allows four such flips per entry, ``lr * 5.61 * 8 / 127 *
    |g|_max``, plus float32 rounding of the parameter, ``rtol=1e-5``; the
    exact regime's float32 backward stays within that as well.
    """
    import jax
    import jax.numpy as jnp
    import repro_torch.models.vision as tv
    jv = ref.models.vision
    cfg_t, cfg_j = _configs(ref, regime)
    params = jv.init_resnet(jax.random.PRNGKey(0), width=4, n_blocks=1)
    task = image_task(size=8)

    def loss_j(p, batch):
        logits = jv.resnet_forward(p, batch["image"], cfg_j, n_blocks=1)
        logz = jax.nn.logsumexp(logits, -1)
        gold = jnp.take_along_axis(logits, batch["label"][:, None], -1)[:, 0]
        return (logz - gold).mean()

    def loss_t(p, batch):
        logits = tv.resnet_forward(p, torch.from_numpy(batch["image"]),
                                   cfg_t, n_blocks=1)
        return _xent_torch(logits, torch.from_numpy(batch["label"]).long())

    params = {k: np.asarray(v) for k, v in params.items()}
    jt = ref.train.trainer
    j_sgd = ref.optim.adamw.SGD(lr=1e-3, momentum=0.9)
    jtr = jt.Trainer(loss_j, j_sgd, jt.TrainerConfig(log_every=1))
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    pj, _ = jtr.fit(pj, j_sgd.init(pj), task(4), 3)

    t_sgd = SGD(lr=1e-3, momentum=0.9)
    ttr = Trainer(loss_t, t_sgd, TrainerConfig(log_every=1))
    p0 = tv.load_jax_params(params, device="cpu")
    after_first = {}

    def hook(step, p, consumed):
        if step == 1:
            after_first.update({k: v.clone() for k, v in p.items()})

    pt, _ = ttr.fit(p0, t_sgd.init(p0), task(4), 3, step_hook=hook)

    lj = [h["loss"] for h in jtr.history]
    lt = [h["loss"] for h in ttr.history]
    assert len(lt) == len(lj) == 3 and ttr.consumed == jtr.consumed == 3
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    assert [h["step"] for h in ttr.history] == [1, 2, 3]
    for k in params:
        a, b = pt[k].numpy(), np.asarray(pj[k])
        # the step-1 update lr * g bounds |g|_max of this tensor
        g_max = float(np.abs(after_first[k].numpy()
                             - params[k]).max()) / 1e-3
        atol = 1e-3 * 5.61 * 8 / 127 * g_max
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=atol + 1e-7,
                                   err_msg=f"{regime} {k}")


def test_trainer_microbatches_average_gradients():
    """``microbatch=2`` on a batch of 4: the mean of the two microbatch
    gradients (float32 sum, tensor divisor), the same loss as one pass up
    to float32 rounding; a batch the count does not divide raises."""
    w0 = torch.tensor([[0.5, -1.0], [2.0, 0.25]])

    def loss_fn(p, batch):
        x = torch.from_numpy(batch["x"])
        return ((x @ p["w"]) ** 2).mean()

    x = np.random.default_rng(2).normal(size=(4, 2)).astype(np.float32)
    runs = {}
    for micro in (0, 2):
        opt = SGD(lr=0.1)
        tr = Trainer(loss_fn, opt, TrainerConfig(microbatch=micro,
                                                 log_every=1))
        p = {"w": w0.clone()}
        p, _ = tr.fit(p, opt.init(p), iter([{"x": x}]), 1)
        runs[micro] = (tr.history[0]["loss"], p["w"])
    np.testing.assert_allclose(runs[2][0], runs[0][0], rtol=1e-6)
    torch.testing.assert_close(runs[2][1], runs[0][1], rtol=1e-6, atol=1e-7)
    tr = Trainer(loss_fn, SGD(), TrainerConfig(microbatch=3))
    with pytest.raises(ValueError, match="does not divide"):
        tr.fit({"w": w0.clone()}, SGD().init({"w": w0}), iter([{"x": x}]), 1)


@pytest.mark.parametrize("field,value", [("mesh", "somewhere"),
                                         ("dp_axes", ("pod", "data"))])
def test_trainer_refuses_unported_options(field, value):
    """The data-parallel step runs on a mesh of ranks
    (``tests/test_torch_dp_train.py``). Still refused: a ``mesh`` that is
    no mesh (``TypeError``), and ``dp_axes`` over a shape-only production
    mesh, which has no ranks to run on."""
    from repro_torch.launch.mesh import make_production_mesh
    if field == "mesh":
        with pytest.raises(TypeError, match="RankMesh"):
            Trainer(lambda p, b: None, SGD(), TrainerConfig(mesh=value))
        return
    with pytest.raises(NotImplementedError,
                       match="ROADMAP.md, queue 1, item 16c"):
        Trainer(lambda p, b: None, SGD(),
                TrainerConfig(mesh=make_production_mesh(), dp_axes=value))


@pytest.mark.parametrize("field", ["ckpt_dir", "damping"])
def test_trainer_takes_checkpoints_and_damping(tmp_path, field):
    """``ckpt_dir`` and ``damping`` are ported: a short fit with either
    trains, checkpoints land on disk, the damped run logs its schedule."""
    from repro_torch.optim.damping import DampingConfig
    from repro_torch.train.checkpoint import latest_step
    value = (str(tmp_path) if field == "ckpt_dir"
             else DampingConfig(warmup_updates=1))
    x = np.random.default_rng(2).normal(size=(4, 2)).astype(np.float32)
    tr = Trainer(lambda p, b: ((torch.from_numpy(b["x"]) @ p["w"]) ** 2
                               ).mean(), SGD(lr=0.1),
                 TrainerConfig(log_every=1, ckpt_every=2, **{field: value}))
    p = {"w": torch.ones(2, 2)}
    tr.fit(p, SGD().init(p), iter([{"x": x}] * 8), 3)
    assert [h["step"] for h in tr.history] == [1, 2, 3]
    assert not torch.equal(p["w"], torch.ones(2, 2))
    if field == "ckpt_dir":
        assert latest_step(str(tmp_path)) == 3
    else:
        assert tr.damp_state.updates == 3 and "accum" in tr.history[-1]


def test_fail_hook_error_propagates():
    """No checkpoint to roll back to: a failing step raises, as in the
    reference without ``ckpt_dir``."""
    def boom(step):
        if step == 1:
            raise RuntimeError("node lost")

    w = {"w": torch.ones(2)}
    tr = Trainer(lambda p, b: (p["w"] ** 2).sum(), SGD(lr=0.1))
    with pytest.raises(RuntimeError, match="node lost"):
        tr.fit(w, SGD().init(w), iter([{}] * 3), 3, fail_hook=boom)

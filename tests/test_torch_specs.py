"""The port's step specs (``launch/specs.py``) against the JAX reference's
``build_step`` on the CPU.

Both packages build the step of a reduced config (2 layers, float32) on
their one-device host mesh and run it on the same numbers: the
reference's parameters (``jax.random``) carried over by
``load_jax_params``, token ids and frames from a numpy seed. Compared:

* train: the loss, the optimizer's moments and each parameter's update
  after one AdamW step, with one microbatch and with the reference's
  statically unrolled accumulation over two (``pick_microbatches`` pinned
  to 2 in both packages: at a CPU-sized shape it returns 1);
* prefill: the last position's logits and the cache it writes; decode,
  fed that cache: the logits.

Tolerances, with their reasons: the logits within ``LOGIT_TOL`` (1e-5) of
their scale and the loss within rtol 1e-5, as ``tests/test_torch_lm.py``
(float32 GEMMs and softmax summed in another order). The moments ``mu``
(``(1 - b1) g``, ``g`` the clipped mean gradient, so it carries the
microbatches' accumulation) and ``nu`` within ``MOMENT_TOL`` (1e-5) of
their leaf's largest magnitude, for the same reason. Each parameter's
update ``p_new - p_old`` within ``UPDATE_TOL`` (0.05) of ``lr`` plus two
float32 spacings of the weight: AdamW's first step moves a weight by about
``lr * g / |g|``, so a missing update, a wrong sign or the gradient of one
microbatch lies ``lr`` or more away. Left out of that check by rule: the
elements whose reference gradient is not zero but within ``1e-4`` of the
leaf's largest, where ``g / |g|`` may turn on a rounding of ``g``; at
least 98 % of the elements are held. The port's step updates its
parameters in place and ``load_jax_params`` shares memory with the arrays
it is given, so it is given copies of the reference's parameters, and the
weights before the step are kept apart. The reference is loaded in
fixtures only.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh  # noqa: E402
from repro_torch.models.transformer import load_jax_params  # noqa: E402
from repro_torch.tree import leaves, leaves_with_names, unflatten  # noqa: E402

LOGIT_TOL = 1e-5
MOMENT_TOL = 1e-5
UPDATE_TOL = 0.05
B, S = 4, 16


@pytest.fixture(scope="module")
def ref():
    from test_torch_parity import load_reference
    load_reference()
    import jax
    import repro.configs as RC
    import repro.configs.shapes as RSHAPES
    import repro.launch.mesh as RMESH
    import repro.launch.specs as RS
    import repro.models.transformer as RT
    import repro.models.whisper as RW
    return dict(jax=jax, configs=RC, shapes=RSHAPES, mesh=RMESH, specs=RS,
                T=RT, W=RW)


def _inputs(cfg, kind, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    frames = rng.standard_normal((B, cfg.enc_ctx, cfg.d_model)) \
        .astype(np.float32)
    return toks, labels, frames


def _ref_params(ref, arch):
    jax = ref["jax"]
    rcfg = ref["configs"].reduced_config(arch)
    fam = ref["W"] if rcfg.enc_dec else ref["T"]
    params = fam.init_params(jax.random.PRNGKey(0), rcfg)
    return rcfg, params, jax.tree.map(np.array, params)   # copies


def _run_ref(ref, rcfg, kind, args):
    jax = ref["jax"]
    bundle = ref["specs"].build_step(rcfg, ref["shapes"].ShapeSpec(
        "t", S, B, kind), ref["mesh"].make_host_mesh())
    return jax.jit(bundle.fn)(*args)


def _close_logits(got, want):
    got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()


def _held_update(old, new, want, lr, g_ref):
    """The elements of one leaf whose update lies off the reference's by
    more than ``UPDATE_TOL * lr`` plus two float32 spacings of the
    weight, among those whose reference gradient is zero or not within
    rounding of zero; returns their count and the count checked."""
    big = np.abs(g_ref).max()
    held = (g_ref == 0) | (np.abs(g_ref) > 1e-4 * big)
    off = np.abs((new.astype(np.float64) - old) - (want.astype(np.float64)
                                                   - old))
    lim = UPDATE_TOL * lr + 2 * np.spacing(np.abs(want))
    return int((held & (off > lim)).sum()), int(held.sum())


# the reference microbatches decoder-only models only
@pytest.mark.parametrize("arch,n_micro", [("smollm-135m", 1),
                                          ("smollm-135m", 2),
                                          ("whisper-small", 1)])
def test_train_step_matches_reference(ref, monkeypatch, arch, n_micro):
    cfg = reduced_config(arch)
    rcfg, rparams, np_params = _ref_params(ref, arch)
    toks, labels, frames = _inputs(cfg, "train")
    jnp = ref["jax"].numpy
    batch = (frames, toks, labels) if cfg.enc_dec else (toks, labels)
    ropt = ref["specs"].make_optimizer(rcfg)
    tm = lambda t: dict(leaves_with_names(ref["jax"].tree.map(np.asarray, t)))
    monkeypatch.setattr(ref["specs"], "pick_microbatches",
                        lambda *a: n_micro)
    rnew, rstate, rloss = _run_ref(ref, rcfg, "train", (
        rparams, ropt.init(rparams), *map(jnp.asarray, batch)))

    monkeypatch.setattr(specs, "pick_microbatches", lambda *a: n_micro)
    bundle = specs.build_step(cfg, ShapeSpec("t", S, B, "train"),
                              make_host_mesh())
    assert bundle.meta.get("n_microbatches", 1) == n_micro
    old = {n: a.copy() for n, a in leaves_with_names(np_params)}
    params = load_jax_params(np_params, device="cpu")
    args = specs.materialize(bundle, "cpu", params=params)
    args = args[:2] + tuple(torch.from_numpy(a) for a in batch)
    new_params, new_state, loss = bundle.fn(*args)
    assert new_params is params          # updated in place, as donated
    assert int(new_state.step) == 1
    np.testing.assert_allclose(loss.item(), float(rloss), rtol=1e-5)

    for moment in ("mu", "nu"):
        want = tm(getattr(rstate, moment))
        for name, m in leaves_with_names(getattr(new_state, moment)):
            w = want[name]
            assert m.shape == w.shape, name
            assert np.abs(m.numpy() - w).max() <= \
                MOMENT_TOL * np.abs(w).max(), (moment, name)
    lr = float(ropt.lr(jnp.asarray(1)))
    want, g_ref = tm(rnew), tm(rstate.mu)
    n_off = n_held = n_all = 0
    for name, p in leaves_with_names(new_params):
        off, held = _held_update(old[name], p.detach().numpy(),
                                 want[name], lr, g_ref[name])
        n_off, n_held, n_all = n_off + off, n_held + held, n_all + p.numel()
    assert n_off == 0
    assert n_held >= 0.98 * n_all


def test_microbatched_loss_combines_as_the_step(ref):
    """The step's loss and the gradients it hands the optimizer, with two
    microbatches, equal ``loss_fn`` and its gradients on each half
    combined as the step combines them (``0 + l_i / n`` in float32, ``n``
    a tensor), bitwise."""
    from repro_torch.models.transformer import init_params, loss_fn
    cfg = reduced_config("smollm-135m")
    step = specs.TrainStep(lambda p, tk, lb: loss_fn(p, tk, lb, cfg),
                           specs.make_optimizer(cfg), 2, make_host_mesh())
    params = init_params(0, cfg, device="cpu")
    toks, labels, _ = (torch.from_numpy(a) for a in _inputs(cfg, "train"))
    n = torch.tensor(2.0)
    want = torch.zeros((), dtype=torch.float32)
    want_g = [torch.zeros(p.shape, dtype=torch.float32)
              for p in leaves(params)]
    for i in range(2):
        sl = slice(i * B // 2, (i + 1) * B // 2)
        live = [p.detach().requires_grad_(True) for p in leaves(params)]
        li = loss_fn(unflatten(params, live), toks[sl], labels[sl], cfg)
        for a, g in zip(want_g, torch.autograd.grad(li, live)):
            a.add_(g / n)
        want = want + li.detach() / n
    st = step.begin(params)
    for i in range(2):
        sl = slice(i * B // 2, (i + 1) * B // 2)
        step.micro(st, toks[sl], labels[sl])
    assert torch.equal(st["loss"], want)
    assert all(torch.equal(a, g) for a, g in zip(st["acc"], want_g))
    opt_state = specs.make_optimizer(cfg).init(params)
    _, _, loss = step(params, opt_state, toks, labels)
    assert torch.equal(loss, want)


@pytest.mark.parametrize("arch", ["smollm-135m", "whisper-small"])
def test_serve_steps_match_reference(ref, arch):
    """Prefill then decode, fed the prefill's cache, in both packages."""
    jnp = ref["jax"].numpy
    cfg = reduced_config(arch)
    rcfg, rparams, np_params = _ref_params(ref, arch)
    toks, _, frames = _inputs(cfg, "prefill", seed=1)
    fam = ref["W"] if rcfg.enc_dec else ref["T"]
    rcache = fam.init_cache(rcfg, B, S)
    pre = (jnp.asarray(frames),) if cfg.enc_dec else ()
    rlog, rcache = _run_ref(ref, rcfg, "prefill",
                            (rparams, rcache, *pre, jnp.asarray(toks)))

    params = load_jax_params(np_params, device="cpu")
    pb = specs.build_step(cfg, ShapeSpec("p", S, B, "prefill"),
                          make_host_mesh())
    _, cache, *_ = specs.materialize(pb, "cpu", params=params)
    ppre = (torch.from_numpy(frames),) if cfg.enc_dec else ()
    log, cache = pb.fn(params, cache, *ppre, torch.from_numpy(toks))
    _close_logits(log, rlog)
    for got, want in zip(leaves(cache), ref["jax"].tree.leaves(rcache)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()))

    nxt = np.asarray(rlog).argmax(-1).astype(np.int32)[:, None]
    if cfg.enc_dec:
        renc = ref["W"].encode(rparams, jnp.asarray(frames), rcfg)
        from repro_torch.models import whisper as W
        enc = W.encode(params, torch.from_numpy(frames), cfg)
    pos = S - 1
    rdec = (renc,) if cfg.enc_dec else ()
    rlog2, _ = _run_ref(ref, rcfg, "decode",
                        (rparams, rcache, *rdec, jnp.asarray(nxt),
                         jnp.asarray(pos, jnp.int32)))
    db = specs.build_step(cfg, ShapeSpec("d", S, B, "decode"),
                          make_host_mesh())
    dec = (enc,) if cfg.enc_dec else ()
    log2, _ = db.fn(params, cache, *dec, torch.from_numpy(nxt),
                    torch.tensor(pos, dtype=torch.int32))
    _close_logits(log2, rlog2)


def test_bundle_specs_and_materialize():
    """The bundle's arguments are ``meta``, its specs line up with them
    leaf for leaf, ``materialize`` gives real tensors of the same shapes
    and dtypes, and only a one-device mesh runs the step."""
    cfg = reduced_config("rwkv6-3b")
    for kind in ("train", "prefill", "decode"):
        shape = ShapeSpec("x", S, B, kind)
        bundle = specs.build_step(cfg, shape, make_host_mesh())
        assert all(t.device.type == "meta" for t in leaves(list(bundle.args)))
        for arg, spec in zip(bundle.args, bundle.specs):
            assert len(leaves(arg)) == len(leaves(spec))
            for t, sp in zip(leaves(arg), leaves(spec)):
                assert len(sp) == t.dim()
        real = specs.materialize(bundle, "cpu", seed=3)
        assert [(tuple(t.shape), t.dtype) for t in leaves(list(real))] == \
            [(tuple(t.shape), t.dtype) for t in leaves(list(bundle.args))]
        pod = specs.build_step(cfg, shape, make_production_mesh())
        with pytest.raises(NotImplementedError, match="item 16c"):
            pod.fn(*specs.materialize(pod, "cpu"))
    decode = specs.build_step(cfg, ShapeSpec("x", S, B, "decode"),
                              make_host_mesh())
    assert int(specs.materialize(decode, "cpu")[-1]) == S - 1


def test_make_acfg_is_the_launchers():
    """One ``make_acfg``: the launchers import it from ``launch/specs.py``
    and it builds the kernel ACU."""
    from repro_torch.launch import serve, train
    assert serve.make_acfg is specs.make_acfg is train.make_acfg
    acfg = specs.make_acfg("mul8s_1L2H:lowrank:4")
    assert acfg.acu.mode.value == "lowrank" and acfg.acu.use_kernels
    assert specs.make_acfg("mul8s_1L2H").acu.mode.value == "lut"
    assert specs.make_acfg(None) is None

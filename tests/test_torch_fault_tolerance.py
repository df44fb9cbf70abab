"""The port's ``Trainer`` with checkpoints: failure injection, restore and
deterministic resume, mirroring ``tests/test_fault_tolerance.py``, and
against the reference's ``Trainer`` on the CPU.

The problem is the reference test's: a linear-softmax LM on the Markov
task, its parameters drawn here from a numpy seed so both packages start
from the same values. A run that crashes between checkpoints (the rolled
back batches replay) and a fresh restart (a new ``Trainer`` and a new
iterator) end bitwise equal to the port's own uninterrupted run, with
sync and async saves. Against the reference's trainer the parameters
agree within float32 rounding (``FIT_TOL``): the two compute the same
float32 products and sums in other orders. Also: ``microbatch=2`` on
bfloat16 parameters sums the two gradients in float32, as the
reference's scan carry does, and an LM's nested bfloat16 parameters train
through ``loss_fn`` and resume bitwise.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.data.pipeline import MarkovLM  # noqa: E402
from repro_torch.optim.adamw import SGD, AdamW  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402
from test_torch_parity import load_reference  # noqa: E402

# final parameters against the reference trainer's, as a fraction of each
# leaf's largest entry: float32 rounding of the same sums in other orders,
# carried through 22 AdamW steps (observed 1.9e-7)
FIT_TOL = 2e-6


@pytest.fixture(scope="module")
def ref():
    r = load_reference()
    import repro.optim.adamw  # noqa: F401
    import repro.train.trainer  # noqa: F401
    return r


def init_problem(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"emb": (rng.normal(size=(32, 16)) * 0.1).astype(np.float32),
            "out": (rng.normal(size=(16, 32)) * 0.1).astype(np.float32)}


def loss_port(params, batch):
    tokens = torch.as_tensor(batch["tokens"]).long()
    labels = torch.as_tensor(batch["labels"]).long()
    logits = params["emb"][tokens] @ params["out"]
    logz = torch.logsumexp(logits, -1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return (logz - gold).mean()


def loss_reference(params, batch):
    import jax
    import jax.numpy as jnp
    logits = params["emb"][batch["tokens"]] @ params["out"]
    logz = jax.nn.logsumexp(logits, -1)
    gold = jnp.take_along_axis(logits, batch["labels"][..., None],
                               -1)[..., 0]
    return (logz - gold).mean()


def make_problem():
    """Tiny linear-softmax LM on the Markov task (the port's side)."""
    lm = MarkovLM(vocab=32, seed=0)
    params = {k: torch.from_numpy(v) for k, v in init_problem().items()}
    return lm, params, loss_port


def fresh(params):
    return tree_map(torch.clone, params)


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))


def _losses(tr):
    return [h["loss"] for h in tr.history if "loss" in h]


def _restores(tr):
    return sum("restored" in h.get("event", "") for h in tr.history)


def test_training_reduces_loss(tmp_path):
    lm, params, loss_fn = make_problem()
    opt = AdamW(lr=1e-2)
    tr = Trainer(loss_fn, opt,
                 TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=10,
                               log_every=5, async_ckpt=False))
    tr.fit(params, opt.init(params), lm.batches(16, 32), n_steps=60)
    losses = _losses(tr)
    assert losses[-1] < losses[0] - 0.3


def test_failure_injection_recovers(tmp_path):
    lm, params, loss_fn = make_problem()
    cfg = TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=5, log_every=5,
                        max_failures=3, async_ckpt=False)
    opt = AdamW(lr=1e-2)
    tr = Trainer(loss_fn, opt, cfg)
    crashed = {"n": 0}

    def fail_hook(step):
        if step in (12, 23) and crashed["n"] < 2:
            crashed["n"] += 1
            raise RuntimeError("simulated node failure")

    tr.fit(params, opt.init(params), lm.batches(16, 32), n_steps=40,
           fail_hook=fail_hook)
    assert crashed["n"] == 2 and _restores(tr) == 2
    losses = _losses(tr)
    assert losses[-1] < losses[0]


def test_too_many_failures_raises(tmp_path):
    lm, params, loss_fn = make_problem()
    cfg = TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=2,
                        max_failures=1, async_ckpt=False)
    opt = SGD(lr=1e-2)
    tr = Trainer(loss_fn, opt, cfg)

    def always_fail(step):
        if step >= 5:
            raise RuntimeError("persistent failure")

    with pytest.raises(RuntimeError, match="persistent failure"):
        tr.fit(params, opt.init(params), lm.batches(8, 16), n_steps=20,
               fail_hook=always_fail)
    assert _restores(tr) == 1


def test_failure_before_the_first_checkpoint_raises(tmp_path):
    lm, params, loss_fn = make_problem()
    opt = SGD(lr=1e-2)
    tr = Trainer(loss_fn, opt, TrainerConfig(ckpt_dir=str(tmp_path),
                                             ckpt_every=5))

    def boom(step):
        if step == 2:
            raise RuntimeError("node lost")

    with pytest.raises(RuntimeError, match="before first checkpoint"):
        tr.fit(params, opt.init(params), lm.batches(8, 16), n_steps=6,
               fail_hook=boom)


def test_elastic_restart_resumes(tmp_path):
    """A second Trainer (fresh process stand-in) resumes from the ckpt,
    written into the parameters it is given, in place."""
    lm, params, loss_fn = make_problem()
    opt = AdamW(lr=1e-2)
    cfg = TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=10,
                        async_ckpt=False)
    p1 = fresh(params)
    p1, _ = Trainer(loss_fn, opt, cfg).fit(p1, opt.init(p1),
                                           lm.batches(16, 32), n_steps=20)
    tr2 = Trainer(loss_fn, opt, cfg)
    p2 = fresh(params)
    p2r, o2, start, extra = tr2.restore_or_init(p2, opt.init(p2))
    assert start == 20 and extra == {"consumed": 20}
    assert p2r is p2 and _equal(p2, p1) and int(o2.step) == 20
    tr2.fit(p2, o2, lm.batches(16, 32), n_steps=30)
    assert _losses(tr2) and tr2.consumed == 30


@pytest.mark.parametrize("async_ckpt", [False, True])
def test_failure_resume_is_deterministic(tmp_path, async_ckpt):
    """Rolled-back batches replay from the buffer: a run that crashes and
    restores ends bitwise equal to the run that never crashed, optimizer
    state included, with exactly the planted restores."""
    lm, params, loss_fn = make_problem()
    opt = AdamW(lr=1e-2)

    def run(ckpt_dir, fail_hook=None):
        cfg = TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=5, log_every=5,
                            max_failures=3, async_ckpt=async_ckpt)
        tr = Trainer(loss_fn, opt, cfg)
        p0 = fresh(params)
        p, st = tr.fit(p0, opt.init(p0), lm.batches(16, 32), n_steps=22,
                       fail_hook=fail_hook)
        return p, st, tr

    p_clean, s_clean, tr_clean = run(str(tmp_path / "clean"))
    crashed = {"n": 0}

    def fail_hook(step):
        # crash mid-interval so un-checkpointed batches must replay
        if step in (7, 13) and crashed["n"] < 2:
            crashed["n"] += 1
            raise RuntimeError("simulated node failure")

    p_crash, s_crash, tr_crash = run(str(tmp_path / "crash"), fail_hook)
    assert crashed["n"] == 2 and _restores(tr_crash) == 2
    assert _restores(tr_clean) == 0
    assert tr_crash.consumed == tr_clean.consumed == 22
    assert _equal(p_clean, p_crash) and _equal(s_clean, s_crash)


def test_fresh_restart_matches_uninterrupted(tmp_path):
    """Kill-and-restart (new Trainer + fresh iterator) fast-forwards the
    iterator by the manifest's consumed count and lands bitwise on the
    uninterrupted run."""
    lm, params, loss_fn = make_problem()
    opt = AdamW(lr=1e-2)
    batches = lambda: lm.batches(16, 32, seed=7)

    def cfg(name):
        return TrainerConfig(ckpt_dir=str(tmp_path / name), ckpt_every=10)

    p0 = fresh(params)
    p_clean, s_clean = Trainer(loss_fn, opt, cfg("clean")).fit(
        p0, opt.init(p0), batches(), n_steps=30)
    p1 = fresh(params)
    Trainer(loss_fn, opt, cfg("killed")).fit(p1, opt.init(p1), batches(),
                                             n_steps=20)
    tr2 = Trainer(loss_fn, opt, cfg("killed"))
    p2 = fresh(params)
    p_res, s_res = tr2.fit(p2, opt.init(p2), batches(), n_steps=30)
    assert tr2.consumed == 30 and _restores(tr2) == 0
    assert _equal(p_clean, p_res) and _equal(s_clean, s_res)


def test_fit_matches_the_reference_trainer(ref, tmp_path):
    """22 AdamW steps with a planted failure on both sides: the same
    losses and final parameters as the reference's ``Trainer`` within
    float32 rounding, the same consumed count and restores."""
    import jax.numpy as jnp
    jt = ref.train.trainer
    lm = MarkovLM(vocab=32, seed=0)
    params = init_problem()

    def fail_hook(step, seen=set()):
        if step == 7 and step not in seen:
            seen.add(step)
            raise RuntimeError("simulated node failure")

    jopt = ref.optim.adamw.AdamW(lr=1e-2)
    jtr = jt.Trainer(loss_reference, jopt, jt.TrainerConfig(
        ckpt_dir=str(tmp_path / "j"), ckpt_every=5, log_every=1,
        async_ckpt=False))
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    pj, _ = jtr.fit(pj, jopt.init(pj), lm.batches(16, 32), 22,
                    fail_hook=fail_hook)

    opt = AdamW(lr=1e-2)
    ttr = Trainer(loss_port, opt, TrainerConfig(
        ckpt_dir=str(tmp_path / "t"), ckpt_every=5, log_every=1,
        async_ckpt=False))
    pt = {k: torch.from_numpy(v.copy()) for k, v in params.items()}

    def fail_hook_t(step, seen=set()):
        if step == 7 and step not in seen:
            seen.add(step)
            raise RuntimeError("simulated node failure")

    pt, _ = ttr.fit(pt, opt.init(pt), lm.batches(16, 32), 22,
                    fail_hook=fail_hook_t)
    assert ttr.consumed == jtr.consumed == 22
    assert _restores(ttr) == _restores(jtr) == 1
    np.testing.assert_allclose(_losses(ttr), _losses(jtr), rtol=1e-5)
    for k in params:
        want = np.asarray(pj[k])
        np.testing.assert_allclose(pt[k].numpy(), want, rtol=0,
                                   atol=FIT_TOL * np.abs(want).max())


# ---------------------------------------------------------------------------
# bfloat16 parameters
# ---------------------------------------------------------------------------

def test_bf16_microbatch_grads_sum_in_float32(ref):
    """``microbatch=2`` on a bfloat16 parameter: each microbatch's gradient
    is bfloat16 (a float32 row sum rounded), and the two are summed in
    float32 from zero and halved, bitwise the reference's scan carry. A
    bfloat16 sum of the same two gradients differs."""
    import jax.numpy as jnp
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(4, 64)) * 3).astype(np.float32)
    w0 = rng.normal(size=64).astype(np.float32)

    def loss_j(p, b):
        return jnp.sum(b["x"] * p["w"].astype(jnp.float32))

    def loss_t(p, b):
        return torch.sum(torch.as_tensor(b["x"]) * p["w"].float())

    jt = ref.train.trainer
    jtr = jt.Trainer(loss_j, ref.optim.adamw.SGD(),
                     jt.TrainerConfig(microbatch=2))
    xb = {"x": jnp.asarray(x).reshape(2, 2, 64)}
    lj, gj, _ = jtr._grads_and_stats(
        {"w": jnp.asarray(w0, jnp.bfloat16)}, xb, 2)
    ttr = Trainer(loss_t, SGD(), TrainerConfig(microbatch=2))
    pt = {"w": torch.from_numpy(w0).to(torch.bfloat16)}
    lt, gt, _ = ttr._grads_and_stats(pt, {"x": x.reshape(2, 2, 64)}, 2)
    assert gt["w"].dtype == torch.float32
    assert np.array_equal(gt["w"].numpy(), np.asarray(gj["w"]))
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-6)
    g1, g2 = (torch.from_numpy(x[2 * i:2 * i + 2].sum(0)).to(torch.bfloat16)
              for i in range(2))
    assert not torch.equal(((g1 + g2) / 2).float(), gt["w"])


def test_lm_bf16_trains_through_loss_fn_and_resumes(tmp_path):
    """An LM's nested bfloat16 parameters through ``loss_fn`` on the fused
    LUT ACU: a run with a planted failure between checkpoints and a fresh
    restart end bitwise equal to the uninterrupted run."""
    import dataclasses
    from repro_torch.configs import reduced_config
    from repro_torch.core import ApproxConfig, make_acu
    from repro_torch.models.transformer import init_params, loss_fn
    cfg = dataclasses.replace(reduced_config("smollm-135m"), n_layers=2,
                              vocab_size=64, vocab_pad_mult=16,
                              dtype="bfloat16")
    assert cfg.param_dtype == torch.bfloat16
    acfg = ApproxConfig(acu=make_acu("mul8s_1L2H", "lut", use_kernels=True,
                                     fused=True))
    params = init_params(0, cfg, device="cpu")
    lm = MarkovLM(vocab=cfg.vocab_size, seed=0)
    opt = AdamW(lr=1e-3, weight_decay=0.01)
    lf = lambda p, b: loss_fn(p, torch.as_tensor(b["tokens"]),
                              torch.as_tensor(b["labels"]), cfg, acfg)

    def run(name, n_steps, fail_hook=None):
        tr = Trainer(lf, opt, TrainerConfig(ckpt_dir=str(tmp_path / name),
                                            ckpt_every=2, log_every=1))
        p = fresh(params)
        p, st = tr.fit(p, opt.init(p), lm.batches(2, 8), n_steps,
                       fail_hook=fail_hook)
        return p, st, tr

    p_a, s_a, tr_a = run("a", 5)
    assert leaves(p_a)[0].dtype == torch.bfloat16
    assert not _equal(p_a, params)
    crashed = []

    def fail_hook(step):
        if step == 3 and not crashed:
            crashed.append(step)
            raise RuntimeError("simulated node failure")

    p_b, s_b, tr_b = run("b", 5, fail_hook)
    run("c", 3)
    p_c, s_c, tr_c = run("c", 5)
    assert _restores(tr_b) == 1 and _restores(tr_a) == _restores(tr_c) == 0
    assert tr_a.consumed == tr_b.consumed == tr_c.consumed == 5
    assert _equal(p_a, p_b) and _equal(s_a, s_b)
    assert _equal(p_a, p_c) and _equal(s_a, s_c)


def test_launcher_trains_and_resumes(tmp_path, capsys):
    """``launch/train.py`` on the reduced config on the CPU: 3 steps
    through the fused LUT ACU checkpoint at the last; a second run to 5
    resumes there (the consumed count carries over) and checkpoints at 5."""
    from repro_torch.launch.train import main
    from repro_torch.train.checkpoint import latest_step
    args = ["--reduced", "--device", "cpu", "--batch", "2", "--seq", "8",
            "--approx", "mul8s_1L2H:lut", "--ckpt", str(tmp_path)]
    tr = main(args + ["--steps", "3"])
    assert latest_step(str(tmp_path)) == 3 and tr.consumed == 3
    assert tr.history[-1]["step"] == 3 and np.isfinite(tr.history[-1]["loss"])
    tr = main(args + ["--steps", "5"])
    assert latest_step(str(tmp_path)) == 5 and tr.consumed == 5
    assert [h["step"] for h in tr.history] == [5]
    assert "'step': 5" in capsys.readouterr().out
    import json
    man = json.load(open(tmp_path / "step_00000005" / "manifest.json"))
    assert man["extra"] == {"consumed": 5}
    assert man["leaves"][0] == "[0]['embed']" and "[1].step" in man["leaves"]

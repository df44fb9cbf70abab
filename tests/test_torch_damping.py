"""Gradient-noise batch damping and int8 error-feedback compression in the
port (``repro_torch.optim.damping``, ``repro_torch.optim.compression``)
against the JAX reference on the CPU, mirroring the single-device cases of
``tests/test_damping.py`` and ``tests/test_compression.py``.

``update_state`` is host-side Python float arithmetic: on the same stats
it equals the reference's exactly, field for field. ``compress`` is
bitwise the reference's on the same float32 input. The damped trainer
takes the reference trainer's ``accum`` schedule and ``consumed`` count
on the same problem, and a damped kill-and-resume replays the schedule
and the parameters bitwise. The mesh cases (``compressed_psum``,
``shard_noise_stats``) wait for ROADMAP item 16.
"""
from __future__ import annotations

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.optim import damping as D  # noqa: E402
from repro_torch.optim.adamw import SGD  # noqa: E402
from repro_torch.optim.compression import (EFState, compress,  # noqa: E402
                                           decompress, init_ef)
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
from test_torch_fault_tolerance import (init_problem, loss_port,  # noqa: E402
                                        loss_reference)
from test_torch_parity import load_reference  # noqa: E402


@pytest.fixture(scope="module")
def ref():
    r = load_reference()
    import repro.optim.compression  # noqa: F401
    import repro.optim.damping  # noqa: F401
    import repro.train.trainer  # noqa: F401
    return r


# ---------------------------------------------------------------------------
# estimator math
# ---------------------------------------------------------------------------

def test_noise_scale_inverts_the_noise_model():
    s_true, g2_true = 48.0, 3.0
    for b_small, b_big in [(2, 4), (8, 64), (1, 7)]:
        s, g2 = D.noise_scale(g2_true + s_true / b_small,
                              g2_true + s_true / b_big, b_small, b_big)
        assert abs(s - s_true) < 1e-9 and abs(g2 - g2_true) < 1e-9


def test_noise_scale_statistical_recovery():
    """Monte-Carlo: i.i.d. per-sample gradients with known mean/variance."""
    rng = np.random.default_rng(0)
    dim, g = 64, rng.normal(size=64)
    sigma2, b_small, b_big, trials = 4.0, 4, 32, 4000
    noise = rng.normal(scale=np.sqrt(sigma2), size=(trials, b_big, dim))
    per = g[None, None] + noise
    small_sq = float((per[:, :b_small].mean(1) ** 2).sum(-1).mean())
    big_sq = float((per.mean(1) ** 2).sum(-1).mean())
    s, g2 = D.noise_scale(small_sq, big_sq, b_small, b_big)
    assert abs(s - sigma2 * dim) / (sigma2 * dim) < 0.1
    assert abs(g2 - float((g ** 2).sum())) / float((g ** 2).sum()) < 0.1


def test_tree_sqnorm_and_microbatch_stats():
    t = {"a": torch.tensor([3.0, 4.0]), "b": {"c": torch.tensor([[2.0]])}}
    assert float(D.tree_sqnorm(t)) == 29.0
    st = D.microbatch_noise_stats(torch.tensor(40.0),
                                  {"w": torch.tensor([1.0, 2.0])},
                                  b_small=4, b_big=16)
    assert float(st.gsq_small) == 10.0 and float(st.gsq_big) == 5.0
    assert (st.b_small, st.b_big) == (4, 16)


def _stats(b_noise, b_small=4, b_big=8, g2=1.0):
    """Stats whose exact two-point inversion yields S = b_noise * g2."""
    s = b_noise * g2
    return D.NoiseStats(gsq_small=g2 + s / b_small, gsq_big=g2 + s / b_big,
                        b_small=b_small, b_big=b_big)


def test_schedule_growth_is_rate_limited():
    cfg = D.DampingConfig(accum_max=16, warmup_updates=2, ema=0.0,
                          max_growth=2)
    st = D.update_state(D.init_state(cfg), cfg, _stats(1024.0), batch_size=8)
    assert st.accum == 1                       # warming up
    seen = []
    for _ in range(6):
        st = D.update_state(st, cfg, _stats(1024.0), batch_size=8)
        seen.append(st.accum)
    assert seen == [2, 4, 8, 16, 16, 16]


def test_schedule_grow_only_and_shrink():
    cfg = D.DampingConfig(accum_max=8, warmup_updates=0, ema=0.0)
    st = D.update_state(D.DampingState(accum=4), cfg, _stats(1.0),
                        batch_size=8)
    assert st.accum == 4                       # grow_only: no shrink
    cfg2 = D.DampingConfig(accum_max=8, warmup_updates=0, ema=0.0,
                           grow_only=False)
    st2 = D.update_state(D.DampingState(accum=4), cfg2, _stats(1.0),
                         batch_size=8)
    assert st2.accum == 2


def test_residual_energy_inflates_noise():
    cfg = D.DampingConfig(warmup_updates=0, ema=0.0, residual_weight=1.0)
    quiet = _stats(b_noise=4.0)
    plain = D.update_state(D.init_state(cfg), cfg, quiet, batch_size=1)
    loud = D.update_state(D.init_state(cfg), cfg,
                          quiet._replace(resid_sq=10.0), batch_size=1)
    assert loud.b_noise > plain.b_noise


def test_state_json_roundtrip():
    cfg = D.DampingConfig()
    st = D.update_state(D.init_state(cfg), cfg, _stats(64.0), batch_size=8)
    st2 = D.DampingState.from_dict(json.loads(json.dumps(st.to_dict())))
    assert st2 == st
    assert (D.update_state(st, cfg, _stats(64.0), batch_size=8)
            == D.update_state(st2, cfg, _stats(64.0), batch_size=8))


@pytest.mark.parametrize("cfg_kw", [
    dict(), dict(ema=0.5, warmup_updates=1, accum_max=8),
    dict(grow_only=False, warmup_updates=0, max_growth=3, target_frac=0.5),
    dict(residual_weight=0.25, ema=0.3)])
def test_update_state_equals_the_reference(ref, cfg_kw):
    """The same NoiseStats sequence through both packages' schedules: every
    state equal, field for field, as Python floats."""
    jd = ref.optim.damping
    cfg_t, cfg_j = D.DampingConfig(**cfg_kw), jd.DampingConfig(**cfg_kw)
    st_t, st_j = D.init_state(cfg_t), jd.init_state(cfg_j)
    rng = np.random.default_rng(len(cfg_kw) + 7)
    for _ in range(12):
        b_small = int(rng.integers(1, 8))
        b_big = b_small * int(rng.integers(2, 5))
        vals = [float(v) for v in rng.uniform(0.1, 40.0, 3)]
        st_t = D.update_state(st_t, cfg_t, D.NoiseStats(
            vals[0], vals[1], b_small, b_big, vals[2]), batch_size=b_big)
        st_j = jd.update_state(st_j, cfg_j, jd.NoiseStats(
            vals[0], vals[1], b_small, b_big, vals[2]), batch_size=b_big)
        assert st_t.to_dict() == st_j.to_dict()
        assert type(st_t.b_noise) is float


# ---------------------------------------------------------------------------
# trainer integration (single device)
# ---------------------------------------------------------------------------

def _regression_problem(noise=2.0, dim=8, seed=0):
    """Noisy linear regression: per-sample gradient noise is controllable."""
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=(dim,)).astype(np.float32)

    def batches(batch, seed=1):
        r = np.random.default_rng(seed)
        while True:
            x = r.normal(size=(batch, dim)).astype(np.float32)
            y = (x @ w_true + noise * r.normal(size=batch)).astype(np.float32)
            yield {"x": x, "y": y}

    def loss_fn(params, b):
        pred = torch.as_tensor(b["x"]) @ params["w"] + params["b"]
        return torch.mean((pred - torch.as_tensor(b["y"])) ** 2)

    params = {"w": torch.zeros(dim), "b": torch.zeros(())}
    return params, loss_fn, batches


def _copy(p):
    return {k: v.clone() for k, v in p.items()}


def test_microbatch_matches_full_batch():
    params, loss_fn, batches = _regression_problem()
    outs = []
    for k in (0, 2, 4):
        opt = SGD(lr=0.05)
        tr = Trainer(loss_fn, opt, TrainerConfig(microbatch=k, log_every=1))
        p = _copy(params)
        outs.append(tr.fit(p, opt.init(p), batches(16, seed=3), n_steps=5)[0])
    for p in outs[1:]:
        for k in p:
            np.testing.assert_allclose(outs[0][k].numpy(), p[k].numpy(),
                                       rtol=2e-5, atol=2e-6)


def test_microbatch_loss_accumulator_is_float32():
    params, loss_fn, batches = _regression_problem()
    bf16_loss = lambda p, b: loss_fn(p, b).to(torch.bfloat16)
    tr = Trainer(bf16_loss, SGD(lr=0.05),
                 TrainerConfig(microbatch=4, log_every=1))
    tr.fit(params, SGD(lr=0.05).init(params), batches(16, seed=3),
           n_steps=1)
    assert np.isfinite(tr.history[0]["loss"])


def test_damping_forbids_fixed_microbatch():
    params, loss_fn, _ = _regression_problem()
    with pytest.raises(ValueError, match="damping"):
        Trainer(loss_fn, SGD(lr=0.05),
                TrainerConfig(microbatch=4, damping=D.DampingConfig()))


def test_damped_trainer_grows_effective_batch():
    params, loss_fn, batches = _regression_problem(noise=8.0)
    cfg = TrainerConfig(log_every=1, damping=D.DampingConfig(
        accum_max=8, warmup_updates=1, ema=0.5))
    tr = Trainer(loss_fn, SGD(lr=0.01), cfg)
    tr.fit(params, SGD(lr=0.01).init(params), batches(4, seed=2),
           n_steps=12)
    assert tr.damp_state.accum > 1 and tr.consumed > 12
    accums = [h["accum"] for h in tr.history if "accum" in h]
    assert accums == sorted(accums)            # grow_only is monotone


def test_damped_resume_matches_uninterrupted(tmp_path):
    """Kill-and-resume of a DAMPED run: parameters bitwise, the consumed
    count and the schedule state equal to the uninterrupted run's."""
    params, loss_fn, batches = _regression_problem(noise=6.0)
    dcfg = D.DampingConfig(accum_max=4, warmup_updates=1, ema=0.5)
    opt = SGD(lr=0.01)

    def mk(ckpt):
        return Trainer(loss_fn, opt, TrainerConfig(
            ckpt_dir=ckpt, ckpt_every=5, async_ckpt=False, log_every=1,
            damping=dcfg))

    tr0 = mk(str(tmp_path / "clean"))
    p = _copy(params)
    p_clean, _ = tr0.fit(p, opt.init(p), batches(4, seed=2), n_steps=20)
    tr1 = mk(str(tmp_path / "killed"))
    p = _copy(params)
    tr1.fit(p, opt.init(p), batches(4, seed=2), n_steps=10)
    tr2 = mk(str(tmp_path / "killed"))
    p = _copy(params)
    p_res, _ = tr2.fit(p, opt.init(p), batches(4, seed=2), n_steps=20)
    assert tr2.consumed == tr0.consumed and tr2.damp_state == tr0.damp_state
    assert tr0.damp_state.accum > 1
    for k in p_clean:
        assert torch.equal(p_clean[k], p_res[k])


def test_damped_schedule_matches_the_reference_trainer(ref):
    """The Markov LM problem under damping through both trainers: the same
    ``accum`` after every step and the same ``consumed``."""
    import jax.numpy as jnp
    from repro_torch.data.pipeline import MarkovLM
    kw = dict(accum_max=8, warmup_updates=1, ema=0.5)
    lm = MarkovLM(vocab=32, seed=0)
    params = init_problem()
    jt = ref.train.trainer
    jopt = ref.optim.adamw.SGD(lr=0.05)
    jtr = jt.Trainer(loss_reference, jopt, jt.TrainerConfig(
        log_every=1, damping=ref.optim.damping.DampingConfig(**kw)))
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    jtr.fit(pj, jopt.init(pj), lm.batches(4, 16), 8)
    opt = SGD(lr=0.05)
    ttr = Trainer(loss_port, opt, TrainerConfig(
        log_every=1, damping=D.DampingConfig(**kw)))
    pt = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ttr.fit(pt, opt.init(pt), lm.batches(4, 16), 8)
    acc_t = [h["accum"] for h in ttr.history]
    acc_j = [h["accum"] for h in jtr.history]
    assert acc_t == acc_j and max(acc_t) > 1
    assert ttr.consumed == jtr.consumed > 8
    np.testing.assert_allclose([h["b_noise"] for h in ttr.history],
                               [h["b_noise"] for h in jtr.history],
                               rtol=1e-3)


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

def test_compress_roundtrip_bound():
    g = torch.from_numpy(
        (np.random.default_rng(0).normal(size=128) * 5).astype(np.float32))
    q, scale = compress(g)
    assert q.dtype == torch.int8
    assert float((decompress(q, scale) - g).abs().max()) \
        <= float(scale) / 2 + 1e-6


def test_compress_external_amax_roundtrip_bound():
    g = torch.from_numpy(
        np.random.default_rng(1).normal(size=128).astype(np.float32))
    amax = g.abs().max() * 4.0                 # another worker's larger amax
    q, scale = compress(g, amax)
    assert float(scale) == float(torch.maximum(amax, torch.tensor(1e-12))
                                 * (1.0 / 127.0))
    assert float((decompress(q, scale) - g).abs().max()) \
        <= float(scale) / 2 + 1e-6


@pytest.mark.parametrize("case", ["normal", "wide", "tiny", "external"])
def test_compress_bitwise_the_reference(ref, case):
    """Codes, scale and the decompressed values bitwise the reference's,
    with values placed on the codes' rounding boundaries."""
    import jax.numpy as jnp
    jc = ref.optim.compression
    rng = np.random.default_rng(len(case))
    g = rng.normal(size=4096).astype(np.float32)
    if case == "wide":
        g = g * np.float32(3e4)
    if case == "tiny":
        g = g * np.float32(1e-14)
    amax = None
    if case == "external":
        amax = np.float32(np.abs(g).max() * 1.7)
    # half-code points of the grid (ties of the rounding)
    bound = max(float(np.abs(g).max()) if amax is None else float(amax),
                1e-12)
    g[:64] = (np.arange(64) - 31.5).astype(np.float32) * np.float32(
        bound / 127.0)
    qt, st = compress(torch.from_numpy(g),
                      None if amax is None else torch.tensor(amax))
    qj, sj = jc.compress(jnp.asarray(g),
                         None if amax is None else jnp.float32(amax))
    assert np.array_equal(qt.numpy(), np.asarray(qj))
    assert np.array_equal(st.numpy(), np.asarray(sj))
    assert np.array_equal(decompress(qt, st).numpy(),
                          np.asarray(jc.decompress(qj, sj)))


def test_ef_sgd_converges_like_exact():
    """EF-compressed SGD reaches the same quadratic minimum."""
    target = torch.from_numpy(
        np.random.default_rng(2).normal(size=16).astype(np.float32))
    x_ef, x_ex = torch.zeros(16), torch.zeros(16)
    resid = init_ef({"w": x_ef}).residual["w"]
    for _ in range(60):
        g_ef = (x_ef - target) + resid
        q, s = compress(g_ef)
        sent = decompress(q, s)
        resid = g_ef - sent
        x_ef = x_ef - 0.2 * sent
        x_ex = x_ex - 0.2 * (x_ex - target)
    assert float(torch.linalg.norm(x_ef - target)) < 0.05
    assert float(torch.linalg.norm(x_ef - x_ex)) < 0.05
    assert isinstance(EFState(residual={"w": resid}), tuple)

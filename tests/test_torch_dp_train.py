"""Data-parallel training on a mesh of ranks: ``optim/compression.py:
compressed_psum``, ``optim/damping.py: shard_noise_stats`` and the
trainer's data-parallel step (``TrainerConfig(mesh=, dp_axes=)``).

The port's mirror of ``tests/test_damping.py``'s mesh cases (the stats
pair, the damped step against the one-process oracle, the damped fit) and
of ``tests/test_compression.py``'s psum round trip, plus a resume with the
EF residual. The module starts its 8 gloo ranks once
(``tests/mesh_cases.py``, the 2 x 4 ``(data, model)`` mesh;
``dp_axes=("data",)``, so 2 data-parallel ranks, each model column a
replica of the same step).

What is exact: the int32 sum of int8 codes makes the all-reduced mean the
same bits in any reduction order, so the data-parallel step equals a
one-process oracle that replays it (per-shard gradients, the shared amax,
the int32 sum x scale / W, the same AdamW) bitwise, and a run cut after 4
steps and resumed from its checkpoint (EF residual included), or rolled
back in process after a planted failure, ends bitwise equal to the run
that never stopped. Against the reference, which runs its own step under
XLA: the codes and scales of ``compress`` bitwise, the oracle's
parameters within ``REF_RTOL`` (AdamW's moment updates round like XLA's
only most of the time, ``tests/test_torch_train.py``).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mesh_cases as mc  # noqa: E402
from test_torch_parity import load_reference  # noqa: E402

REF_RTOL = 1e-5


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_ckpt")
    return mc.spawn_cases("dp", extra={"ckpt_root": str(root)})


def test_compressed_psum_stats_pair(ranks):
    """``with_stats`` gives the free estimator pair (the mean per-rank
    |g|^2, |mean|^2) and the residual energy, the same on every rank;
    shards that disagree widen the gap."""
    g = np.random.default_rng(0).normal(size=(2, 16)).astype(np.float32)
    r0 = ranks[0]["stats_pair"]
    for r in ranks:
        assert r["stats_pair"]["stats"] == r0["stats"]
        assert np.array_equal(r["stats_pair"]["summed"], r0["summed"])
    small, big = r0["stats"]["gsq_small"], r0["stats"]["gsq_big"]
    assert small == pytest.approx(float((g ** 2).sum(1).mean()), rel=1e-5)
    assert big == pytest.approx(float((r0["summed"] ** 2).sum()), rel=1e-5)
    assert small > big
    assert np.isfinite(r0["stats"]["resid_sq"])
    # shard_noise_stats: the same pair from the raw gradients and the mean
    assert r0["pair"] == (small, big, 4, 8)
    # each data rank keeps its own residual: g_i - decompress(code_i)
    from repro_torch.optim.compression import compress, decompress
    amax = torch.tensor(np.abs(g).max())
    for rank, r in enumerate(ranks):
        gi = torch.from_numpy(g[rank // 4])
        q, s = compress(gi, amax)
        assert np.array_equal(r["stats_pair"]["resid"],
                              (gi - decompress(q, s)).numpy())


def test_psum_path_roundtrips_through_compress(ranks):
    """Over a group of one, what ``compressed_psum`` sends is exactly
    ``decompress(compress(g))``, the reference's bits, and the residual is
    what int8 dropped, within half a code step."""
    import jax.numpy as jnp
    load_reference()
    from repro.optim import compression as jc
    from repro_torch.optim.compression import compress, decompress
    g = np.random.default_rng(3).normal(size=(64,)).astype(np.float32) * 3
    q, s = compress(torch.from_numpy(g))
    sent = decompress(q, s).numpy()
    want = np.asarray(jc.decompress(*jc.compress(jnp.asarray(g))))
    for r in ranks:
        assert np.array_equal(r["one_worker"]["sent"], sent)
        assert np.array_equal(r["one_worker"]["sent"], want)
        assert np.array_equal(r["one_worker"]["resid"], g - sent)
        assert np.abs(r["one_worker"]["resid"]).max() <= float(s) / 2 + 1e-6


def _oracle():
    """The data-parallel step replayed in one process: each data rank's
    gradient of its 4 rows, one amax over both, the int8 codes summed as
    int32, x scale / W, and the same AdamW."""
    from repro_torch.optim.adamw import AdamW
    from repro_torch.optim.compression import compress
    from repro_torch.tree import leaves, unflatten
    params0, batches = mc.regression_problem(noise=4.0)
    batch = next(batches(8, seed=5))
    W = 2
    params = {k: torch.from_numpy(v.copy()) for k, v in params0.items()}
    per = []
    for i in range(W):
        live = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        shard = {k: torch.from_numpy(v[i * 4:(i + 1) * 4])
                 for k, v in batch.items()}
        gs = torch.autograd.grad(mc.port_loss(live, shard), leaves(live))
        per.append(list(gs))
    mean = []
    for li in range(len(per[0])):
        gs = [per[w][li].to(torch.float32) for w in range(W)]
        amax = torch.max(torch.stack([torch.max(torch.abs(g)) for g in gs]))
        qs = [compress(g, amax) for g in gs]
        q_sum = sum(q.to(torch.int32) for q, _ in qs)
        mean.append(q_sum.to(torch.float32)
                    * (qs[0][1] / torch.tensor(float(W))))
    opt = AdamW(lr=1e-2)
    p, o = opt.update(unflatten(params, mean), opt.init(params), params)
    return leaves(p), leaves(o), batch


def test_dp_damped_step_bitwise_matches_single_device_oracle(ranks):
    """The acceptance pin: one data-parallel step on the 2 x 4 mesh is the
    one-process oracle's, bitwise, on every rank; and within
    ``REF_RTOL`` of the reference's own oracle."""
    import jax
    import jax.numpy as jnp
    p_one, o_one, batch = _oracle()
    for r in ranks:
        got = r["dp_step"]
        for a, b in zip(got["params"], p_one):
            assert np.array_equal(a, b.numpy())
        for a, b in zip(got["opt"], o_one):
            assert np.array_equal(a, np.asarray(b))
    load_reference()
    from repro.optim.adamw import AdamW as JAdamW
    from repro.optim.compression import compress as jcompress
    params0, _ = mc.regression_problem(noise=4.0)

    def jloss(p, b):
        return jnp.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)
    jp = {k: jnp.asarray(v) for k, v in params0.items()}
    per = [jax.grad(jloss)(jp, {k: jnp.asarray(v[i * 4:(i + 1) * 4])
                               for k, v in batch.items()}) for i in range(2)]
    mean = {}
    for k in jp:
        gs = [p[k] for p in per]
        amax = jnp.max(jnp.stack([jnp.max(jnp.abs(g)) for g in gs]))
        qs = [jcompress(g, amax) for g in gs]
        mean[k] = sum(q.astype(jnp.int32) for q, _ in qs).astype(
            jnp.float32) * (qs[0][1] / 2)
    opt = JAdamW(lr=1e-2)
    want, _ = opt.update(mean, opt.init(jp), jp)
    for a, k in zip(ranks[0]["dp_step"]["params"], sorted(jp)):
        np.testing.assert_allclose(a, np.asarray(want[k]), rtol=REF_RTOL,
                                   atol=0)


def test_dp_damped_trainer_runs_and_grows(ranks):
    """A damped data-parallel fit: the schedule updates from the mesh's
    per-rank noise pair and the loss falls, the same on every rank."""
    r0 = ranks[0]["dp_damped_fit"]
    assert r0["updates"] > 0 and r0["b_noise"] > 0
    assert r0["losses"][-1] < r0["losses"][0]
    for r in ranks:
        assert r["dp_damped_fit"] == r0


def test_dp_resume_with_ef_residual_is_bitwise(ranks):
    """Rank 0 writes each checkpoint with every data rank's EF residual
    stacked (the reference's third tree); a fresh trainer resumed from
    step 4 and a run rolled back after a planted failure end bitwise equal
    to the run that never stopped, residuals included."""
    for r in ranks:
        res = r["dp_resume"]
        assert res["consumed"][0] == res["consumed"][1]
        for a, b in zip(res["full"], res["resumed"]):
            assert np.array_equal(a, b)
        for a, b in zip(res["full"], res["failed"]):
            assert np.array_equal(a, b)
        for a, b in zip(res["resid_full"], res["resid_resumed"]):
            assert np.array_equal(a, b)
        # the residual the checkpoint carried was not zero
        assert any(np.abs(a).max() > 0 for a in res["resid_at_cut"])
        # (params, opt_state, residual): the reference's keystr names
        assert "[2]['w']" in res["names"] and "[2]['b']" in res["names"]
        assert "[0]['w']" in res["names"]

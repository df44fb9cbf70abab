"""The port's checkpoints (``repro_torch.train.checkpoint``) against the
JAX reference's on the CPU.

Mirrors ``tests/test_checkpoint.py`` (round trip, retention, the async
saver and its submit/drain race, atomicity) and adds what the two
packages share: the manifest's leaf names and order for the same
``(params, AdamWState)``, float32 checkpoints read across both ways,
bfloat16 leaves written byte for byte as the reference writes them and
read back bitwise (the reference cannot read them back: ROADMAP fault 6),
an async snapshot taken before ``submit`` returns, and a writer error
re-raised on ``wait`` instead of a hang (fault 7).
"""
from __future__ import annotations

import json
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.train import checkpoint as C  # noqa: E402
from test_torch_parity import load_reference  # noqa: E402


@pytest.fixture(scope="module")
def ref():
    r = load_reference()
    import repro.optim.adamw  # noqa: F401
    import repro.train.checkpoint  # noqa: F401
    return r


def make_tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((4, 8), generator=g),
            "nested": {"b": torch.arange(6).reshape(2, 3),
                       "c": (torch.ones(3), torch.zeros(()))}}


def _leaves(tree):
    from repro_torch.tree import leaves
    return leaves(tree)


def _equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def test_roundtrip(tmp_path):
    tree = make_tree(0)
    C.save(str(tmp_path), 7, tree)
    assert C.latest_step(str(tmp_path)) == 7
    restored, man = C.restore(str(tmp_path), 7, tree)
    assert man["step"] == 7 and man["extra"] == {}
    assert isinstance(restored["nested"]["c"], tuple)
    for a, b in zip(_leaves(tree), _leaves(restored)):
        assert _equal(a, b)


def test_retention(tmp_path):
    tree = {"x": torch.ones(2)}
    for s in (1, 2, 3, 4, 5):
        C.save(str(tmp_path), s, tree, keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step_00000004", "step_00000005"]


def test_async_saver(tmp_path):
    saver = C.AsyncSaver()
    tree = make_tree(1)
    saver.submit(str(tmp_path), 3, tree)
    saver.submit(str(tmp_path), 4, tree)   # supersedes queued older writes
    saver.wait()
    assert C.latest_step(str(tmp_path)) == 4


def test_async_saver_submit_drain_race(tmp_path):
    """Many rapid submit/wait cycles: the newest step is always on disk
    after ``wait``."""
    saver = C.AsyncSaver()
    tree = {"x": torch.ones(2)}
    for step in range(1, 120):
        saver.submit(str(tmp_path), step, tree, keep=3)
        if step % 3 == 0:
            saver.wait()
            assert C.latest_step(str(tmp_path)) == step, step
    saver.wait()
    assert C.latest_step(str(tmp_path)) == 119
    assert saver.last_saved_step == 119


def test_restore_follows_the_templates_device(tmp_path):
    """Each restored leaf lands on its template leaf's device, whatever
    device the checkpoint was written from."""
    tree = make_tree(2)
    C.save(str(tmp_path), 1, tree)
    like = {"a": tree["a"].to("meta"), "nested": tree["nested"]}
    restored, _ = C.restore(str(tmp_path), 1, like)
    assert restored["a"].device.type == "meta"
    assert restored["a"].dtype == tree["a"].dtype
    assert restored["a"].shape == tree["a"].shape
    for a, b in zip(_leaves(tree["nested"]), _leaves(restored["nested"])):
        assert _equal(a, b) and b.device.type == "cpu"


def test_atomicity_no_tmp_left(tmp_path):
    C.save(str(tmp_path), 9, {"x": torch.ones(4)})
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))


def test_restore_refuses_a_mismatched_tree(tmp_path):
    C.save(str(tmp_path), 1, {"x": torch.ones(4)})
    with pytest.raises(ValueError, match="shape"):
        C.restore(str(tmp_path), 1, {"x": torch.ones(5)})
    with pytest.raises(ValueError, match="leaves"):
        C.restore(str(tmp_path), 1, {"x": torch.ones(4), "y": torch.ones(1)})


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

def _lm_like_params(rng):
    """An LM's nested layout, small."""
    f = lambda *s: (rng.normal(size=s) * 0.1).astype(np.float32)
    return {"embed": f(16, 8), "final_norm": {"w": f(1, 8)},
            "groups": {"b0": {"attn": {"wq": f(2, 8, 8), "wk": f(2, 8, 4)},
                              "mlp": {"w_up": f(2, 8, 12)},
                              "norm1": {"w": f(2, 8)}}}}


def _torch_tree(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _state_pair(ref, params):
    """The same AdamW state after one update in both packages."""
    import jax.numpy as jnp
    from repro_torch.tree import tree_map
    pj = tree_map(jnp.asarray, params)
    pt = _torch_tree(params)
    jo, to = ref.optim.adamw.AdamW(lr=1e-2), AdamW(lr=1e-2)
    gj = tree_map(lambda a: jnp.asarray(a) * 0.5, params)
    pj, sj = jo.update(gj, jo.init(pj), pj)
    pt, st = to.update(tree_map(lambda a: torch.from_numpy(a * 0.5), params),
                       to.init(pt), pt)
    return (pj, sj), (pt, st)


def test_manifest_names_match_the_reference(ref, tmp_path):
    """Same tree, same leaf names in the same order, same files: the
    manifest's ``keystr`` names, ``"[1].step"``, ``"[1].mu[...]"``."""
    (pj, sj), (pt, st) = _state_pair(ref, _lm_like_params(
        np.random.default_rng(0)))
    ref.train.checkpoint.save(str(tmp_path / "j"), 1, (pj, sj))
    C.save(str(tmp_path / "t"), 1, (pt, st))
    man = [json.load(open(tmp_path / w / "step_00000001" / "manifest.json"))
           for w in ("j", "t")]
    assert man[0] == man[1]
    names = man[1]["leaves"]
    assert names[0] == "[0]['embed']"
    assert "[0]['groups']['b0']['attn']['wq']" in names
    assert len(names) == 19 and names[5:8] == [
        "[0]['groups']['b0']['norm1']['w']", "[1].step", "[1].mu['embed']"]
    assert names[-1] == "[1].nu['groups']['b0']['norm1']['w']"


def test_float32_checkpoints_read_across(ref, tmp_path):
    """A float32 checkpoint written by the reference restores in the port
    to equal values, and the port's restores in the reference."""
    params = _lm_like_params(np.random.default_rng(1))
    (pj, sj), (pt, st) = _state_pair(ref, params)
    ref.train.checkpoint.save(str(tmp_path / "j"), 3, (pj, sj),
                              extra={"consumed": 3})
    tree, man = C.restore(str(tmp_path / "j"), 3, (pt, st))
    assert man["extra"] == {"consumed": 3}
    import jax
    for a, b in zip(_leaves(tree), jax.tree.leaves((pj, sj))):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert tree[1].step.dtype == torch.int32 and int(tree[1].step) == 1
    C.save(str(tmp_path / "t"), 3, (pt, st))
    back, _ = ref.train.checkpoint.restore(str(tmp_path / "t"), 3, (pj, sj))
    for a, b in zip(jax.tree.leaves(back), _leaves((pt, st))):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_nested_optimizer_state_matches_the_reference(ref):
    """AdamW on an LM's nested tree: one update in each package leaves the
    same leaves in the same order, within float32 rounding; the
    reference's state carries over through ``load_jax_state`` exactly."""
    import jax
    from repro_torch.optim.adamw import load_jax_state
    (pj, sj), (pt, st) = _state_pair(ref, _lm_like_params(
        np.random.default_rng(3)))
    for a, b in zip(_leaves((pt, st)), jax.tree.leaves((pj, sj))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-6,
                                   atol=1e-7)
    cont = load_jax_state(jax.tree.map(np.asarray, sj), device="cpu")
    assert set(cont.mu["groups"]["b0"]) == {"attn", "mlp", "norm1"}
    for a, b in zip(_leaves(cont), jax.tree.leaves(sj)):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_bfloat16_leaves(ref, tmp_path):
    """The port writes a bfloat16 leaf's file byte for byte as the
    reference does (raw bits under ``'<V2'``); a reference-written one
    restores in the port bitwise, a port-written one round-trips bitwise;
    a raw 2-byte leaf into a float32 template raises."""
    import jax.numpy as jnp
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(5, 7)) * 3).astype(np.float32)
    xj = jnp.asarray(x, dtype=jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    assert np.array_equal(np.asarray(xj).view(np.int16),
                          xt.view(torch.int16).numpy())
    tree_t = {"w": xt, "s": torch.zeros((), dtype=torch.bfloat16)}
    ref.train.checkpoint.save(str(tmp_path / "j"), 1,
                              {"w": xj, "s": jnp.zeros((), jnp.bfloat16)})
    C.save(str(tmp_path / "t"), 1, tree_t)
    for leaf in ("leaf_00000.npy", "leaf_00001.npy"):
        raw = [open(tmp_path / w / "step_00000001" / leaf, "rb").read()
               for w in ("j", "t")]
        assert raw[0] == raw[1]
    for where in ("j", "t"):
        got, _ = C.restore(str(tmp_path / where), 1, tree_t)
        assert got["w"].dtype == torch.bfloat16
        assert torch.equal(got["w"].view(torch.int16), xt.view(torch.int16))
        assert got["s"].shape == ()
    with pytest.raises(ValueError, match="2-byte"):
        C.restore(str(tmp_path / "j"), 1, {"w": torch.zeros(5, 7),
                                           "s": torch.zeros(())})


def test_async_snapshot_is_taken_at_submit(tmp_path):
    """The in-place optimizer rewrites the parameters right after
    ``submit``: the checkpoint holds the values at ``submit``."""
    w = torch.arange(1 << 16, dtype=torch.float32)
    want = w.clone()
    saver = C.AsyncSaver()
    saver.submit(str(tmp_path), 1, {"w": w})
    w.add_(1.0)
    saver.wait()
    got, _ = C.restore(str(tmp_path), 1, {"w": w})
    assert torch.equal(got["w"], want)


def test_writer_error_reraises_instead_of_hanging(tmp_path):
    """A save into a path that is a file fails in the writer thread: the
    next ``wait`` raises it (once) within a time limit, and the saver
    writes the next snapshot."""
    blocker = tmp_path / "a_file"
    blocker.write_text("x")
    saver = C.AsyncSaver()
    saver.submit(str(blocker), 1, {"x": torch.ones(2)})
    outcome = {}

    def waiter():
        try:
            saver.wait()
            outcome["err"] = None
        except Exception as e:  # noqa: BLE001
            outcome["err"] = e

    t = threading.Thread(target=waiter, daemon=True)
    t.start()
    t.join(timeout=10.0)
    assert not t.is_alive(), "wait() hung after a failed save"
    assert isinstance(outcome["err"], OSError)
    saver.wait()                      # raised once, then clear
    good = tmp_path / "good"
    saver.submit(str(good), 2, {"x": torch.ones(2)})
    saver.wait()
    assert C.latest_step(str(good)) == 2 and saver.last_saved_step == 2


def test_writer_error_reraises_on_submit(tmp_path):
    blocker = tmp_path / "a_file"
    blocker.write_text("x")
    saver = C.AsyncSaver()
    saver.submit(str(blocker), 1, {"x": torch.ones(2)})
    saver._thread.join(timeout=10.0)
    with pytest.raises(OSError):
        saver.submit(str(tmp_path / "good"), 2, {"x": torch.ones(2)})

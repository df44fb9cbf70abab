"""The port's LM serving engines against the JAX reference's on the CPU, and
the engines' own behaviours, at ``reduced_config("smollm-135m")`` with the
fused ``mul8s_1L2H`` ACU (every GEMM on kernel 3's plain version, attention
on kernel 8's or 9's).

The reference's ACU is built with ``use_pallas=True, interpret=True``:
with the default ``use_pallas=False`` its attention plan is ``dense`` and
the comparison would hold nothing of kernels 8 and 9.

The paged engine zeroes a pool block when it allocates it (the reference
does not), so a recycled block's stale K/V cannot reach the K/V scales or,
under a biased multiplier, the masked keys' ``LUT[0, v]`` terms. Both
allocators hand the most recently freed block out first, so a block freed
by a finished request is reused by the next one that crosses a block
boundary, and the two engines then see different K/V scales (qwen2.5-14b's
reduced config shows it from its third decode step). Against the
reference, :func:`_fresh_blocks` therefore puts freed blocks at the back
of both free lists: the pool is large enough that no block is handed out
twice, and zeroing is invisible. Paged math does not depend on which
physical block holds a logical one (``test_paged_model_equals_contiguous``);
``test_paged_blocks_zeroed`` holds the zeroing rule itself.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.core import ApproxConfig, make_acu  # noqa: E402
from repro_torch.models.transformer import (apply_model,  # noqa: E402
                                            init_cache, init_params)
from repro_torch.serve.engine import (BlockAllocator,  # noqa: E402
                                      ContinuousServeEngine,
                                      PagedContinuousServeEngine, Request,
                                      ServeEngine, _bucket, kv_block_bytes,
                                      poisson_arrivals)
from test_torch_parity import load_reference  # noqa: E402

MULT = "mul8s_1L2H"
CPU = dict(device="cpu")


def _acfg():
    return ApproxConfig(acu=make_acu(MULT, "lut", use_kernels=True,
                                     fused=True))


def _reqs(specs):
    return [Request(prompt=np.asarray(p, np.int32), max_new_tokens=n)
            for p, n in specs]


@pytest.fixture(scope="module")
def cfg():
    return reduced_config("smollm-135m")


@pytest.fixture(scope="module")
def params(cfg):
    return init_params(0, cfg, device="cpu")


def _specs(vocab: int):
    rng = np.random.default_rng(1)
    return [(rng.integers(1, vocab, n).astype(np.int32), m)
            for n, m in ((5, 6), (11, 4), (20, 7), (3, 5), (17, 6))]


ENGINES = {"wave": ("ServeEngine", dict(slots=2)),
           "continuous": ("ContinuousServeEngine", dict(slots=2)),
           "paged": ("PagedContinuousServeEngine", dict(slots=5,
                                                        block_size=8))}


def _fresh_blocks(monkeypatch, jengine) -> None:
    """Freed pool blocks go to the back of the free list, in the reference's
    allocator and the port's alike (module docstring)."""
    def release(self, blk: int) -> bool:
        assert self._rc[blk] > 0, blk
        self._rc[blk] -= 1
        if self._rc[blk] == 0:
            self._free.insert(0, blk)
            return True
        return False
    for cls in (jengine.BlockAllocator, BlockAllocator):
        monkeypatch.setattr(cls, "release", release)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("engine", list(ENGINES))
def test_engines_give_reference_tokens(engine, dtype, monkeypatch):
    """Five requests of mixed lengths and budgets: the port's engine emits
    the reference engine's greedy tokens, request for request, with the
    reference's parameters. bfloat16 compares tokens: the compiled
    reference fuses bfloat16 roundings (``test_torch_lm.py``), which moves
    logits but, for these requests, no argmax."""
    engine_parity(engine, dtype, "smollm-135m", monkeypatch)


def engine_parity(engine: str, dtype: str, arch: str, monkeypatch,
                  op_by_op: bool = False, perturb=None, **overrides) -> None:
    """The port's engine against the reference's on :func:`_specs`, at
    ``reduced_config(arch)`` in ``dtype`` (with ``overrides`` of its
    fields, in both packages), tokens equal request for request.
    ``op_by_op`` runs the reference engine under ``jax.disable_jit``;
    ``perturb`` maps the reference's initial parameters to the ones both
    packages serve (leaves the init leaves at 0 would never exercise)."""
    import contextlib
    import jax
    load_reference()
    import repro.configs as jconfigs
    import repro.core as jcore
    import repro.models.transformer as jtrans
    import repro.serve.engine as jengine
    from repro_torch.models.transformer import load_jax_params
    _fresh_blocks(monkeypatch, jengine)
    jcfg = dataclasses.replace(jconfigs.reduced_config(arch), dtype=dtype,
                               **overrides)
    tcfg = dataclasses.replace(reduced_config(arch), dtype=dtype,
                               **overrides)
    jp = jtrans.init_params(jax.random.PRNGKey(0), jcfg)
    if perturb is not None:
        jp = perturb(jp)
    tp = load_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    jacfg = jcore.ApproxConfig(acu=jcore.make_acu(
        MULT, "lut", use_pallas=True, interpret=True, fused=True))
    name, kw = ENGINES[engine]
    specs = _specs(tcfg.vocab_size)
    with jax.disable_jit() if op_by_op else contextlib.nullcontext():
        want = getattr(jengine, name)(jp, jcfg, max_seq=64, acfg=jacfg,
                                      **kw).run(
            [jengine.Request(prompt=p.copy(), max_new_tokens=m)
             for p, m in specs])
    eng = globals()[name](tp, tcfg, max_seq=64, acfg=_acfg(), **kw, **CPU)
    got = eng.run(_reqs(specs))
    for w, g in zip(want, got):
        assert list(g.out) == list(w.out)
    if engine != "wave":
        assert eng.stats["tokens"] == sum(m for _, m in specs)


def engine_repeats(engine: str, arch: str, **overrides) -> None:
    """One port engine at ``reduced_config(arch)`` in float32 (with
    ``overrides``) serves :func:`_specs` twice: the same tokens both
    times, each request its whole budget, and (but the wave engine) the
    second run's ``stats`` counting only its own tokens. ``run`` starts
    from fresh caches, slot states and blocks, so nothing of the first
    run reaches the second."""
    cfg = dataclasses.replace(reduced_config(arch), dtype="float32",
                              **overrides)
    params = init_params(0, cfg, device="cpu")
    name, kw = ENGINES[engine]
    eng = globals()[name](params, cfg, max_seq=64, acfg=_acfg(), **kw, **CPU)
    specs = _specs(cfg.vocab_size)
    first = [list(r.out) for r in eng.run(_reqs(specs))]
    second = [list(r.out) for r in eng.run(_reqs(specs))]
    assert second == first
    assert [len(o) for o in first] == [m for _, m in specs]
    if engine != "wave":
        assert eng.stats["tokens"] == sum(m for _, m in specs)


def _straightline(params, cfg, acfg, prompt, n_new, max_seq):
    """One request decoded by direct apply_model calls, with the continuous
    engine's bucketed, left-padded prefill."""
    bucket = _bucket(len(prompt))
    off = bucket - len(prompt)
    toks = np.zeros((1, bucket), np.int64)
    toks[0, off:] = prompt
    valid = torch.zeros((1, max_seq), dtype=torch.bool)
    valid[0, off:] = True
    kw = dict(pos_offset=torch.tensor([off]), pad_mask=valid)
    cache = init_cache(cfg, 1, max_seq, device="cpu")
    with torch.inference_mode():
        logits, _ = apply_model(params, torch.from_numpy(toks), cfg,
                                acfg=acfg, cache=cache, cache_pos=0,
                                last_only=True, **kw)
        out, pos = [], bucket
        cur = int(logits[0, -1].argmax())
        for _ in range(n_new - 1):
            out.append(cur)
            logits, _ = apply_model(params, torch.tensor([[cur]]), cfg,
                                    acfg=acfg, cache=cache,
                                    cache_pos=torch.tensor([pos]),
                                    decode=True, **kw)
            cur = int(logits[0, -1].argmax())
            pos += 1
    return out + [cur]


def test_continuous_matches_straightline_decode(cfg, params):
    """A slots=1 continuous engine emits the tokens of direct apply_model
    calls with the same bucketed prefill (the activation scales depend on
    the padding, so the straight line pads identically)."""
    prompt, n_new, max_seq = [5, 17, 3, 99, 23], 5, 32
    want = _straightline(params, cfg, _acfg(), prompt, n_new, max_seq)
    eng = ContinuousServeEngine(params, cfg, slots=1, max_seq=max_seq,
                                acfg=_acfg(), **CPU)
    assert list(eng.run(_reqs([(prompt, n_new)]))[0].out) == want


def test_wave_budget_and_no_trailing_decode(cfg, params, monkeypatch):
    """N tokens take the prefill and N - 1 decode calls, and a budget past
    max_seq is cut to max_seq - prompt length."""
    import repro_torch.serve.engine as eng_mod
    calls = []
    inner = eng_mod.apply_model

    def counting(*a, **k):
        calls.append(k.get("decode", False))
        return inner(*a, **k)

    monkeypatch.setattr(eng_mod, "apply_model", counting)
    done = ServeEngine(params, cfg, slots=2, max_seq=8, **CPU).run(
        _reqs([([3, 1], 10)]))
    assert len(done[0].out) == 6 and calls.count(True) == 5
    reqs = _reqs([([i + 1, i + 2], 3 + i) for i in range(5)])
    done = ServeEngine(params, cfg, slots=2, max_seq=32, **CPU).run(reqs)
    assert [len(r.out) for r in done] == [3, 4, 5, 6, 7]


def test_continuous_per_request_budget_exact(cfg, params):
    budgets = [1, 9, 2, 7, 3]
    eng = ContinuousServeEngine(params, cfg, slots=3, max_seq=32,
                                acfg=_acfg(), **CPU)
    done = eng.run(_reqs([([i + 1, i + 2], b)
                          for i, b in enumerate(budgets)]))
    assert [len(r.out) for r in done] == budgets
    assert eng.stats["tokens"] == sum(budgets)


def test_over_length_rejected_both_engines(cfg, params):
    """A prompt longer than max_seq is rejected at admission with an empty
    output and does not disturb the request beside it."""
    ok = [5, 17, 3]
    solo = ContinuousServeEngine(params, cfg, slots=2, max_seq=16,
                                 **CPU).run(_reqs([(ok, 4)]))[0].out
    for mk in (lambda: ContinuousServeEngine(params, cfg, slots=2,
                                             max_seq=16, **CPU),
               lambda: PagedContinuousServeEngine(params, cfg, slots=2,
                                                  max_seq=16, block_size=8,
                                                  **CPU)):
        eng = mk()
        done = eng.run(_reqs([(np.arange(1, 20), 4), (ok, 4)]))
        assert len(done[0].out) == 0 and eng.stats["rejected"] == 1
        assert list(done[1].out) == list(solo)


def test_paged_prefix_reuse_bitwise(cfg, params):
    """A warm admission (a full-prompt hit, and a partial prefix hit)
    emits exactly a cold engine's tokens: shared blocks hold the K/V a cold
    prefill writes, and the copy-on-write snapshot replays the cached first
    token."""
    rng = np.random.default_rng(2)
    base = rng.integers(1, cfg.vocab_size, 20).tolist()
    ext = base + rng.integers(1, cfg.vocab_size, 5).tolist()

    def mk():
        return PagedContinuousServeEngine(params, cfg, slots=2, max_seq=64,
                                          block_size=8, acfg=_acfg(), **CPU)

    cold_a = list(mk().run(_reqs([(base, 6)]))[0].out)
    cold_b = list(mk().run(_reqs([(ext, 6)]))[0].out)
    eng = mk()
    done = eng.run(_reqs([(base, 6), (base, 6), (ext, 6)]))
    assert [list(r.out) for r in done] == [cold_a, cold_a, cold_b]
    assert eng.stats["full_prompt_hits"] == 1
    assert eng.stats["prefix_hit_blocks"] > 0


def test_paged_preemption_resumes_exactly(cfg, params):
    """Under memory pressure the youngest request is preempted, keeps its
    tokens and resumes from prompt + emitted: every output equals the
    never-preempted one."""
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, cfg.vocab_size, 15).astype(np.int32)
               for _ in range(4)]
    refs = [list(ContinuousServeEngine(params, cfg, slots=1, max_seq=40,
                                       **CPU).run(_reqs([(p, 20)]))[0].out)
            for p in prompts]
    # 7 blocks = null + scratch + 5 usable; a finished request spans 5
    eng = PagedContinuousServeEngine(
        params, cfg, slots=2, max_seq=40, block_size=8, prefix_cache=False,
        hbm_budget=7 * kv_block_bytes(cfg, 8), **CPU)
    done = eng.run([Request(prompt=p, max_new_tokens=20) for p in prompts])
    assert [list(r.out) for r in done] == refs
    assert eng.stats["preemptions"] > 0


def test_paged_blocks_zeroed(cfg, params):
    """A block handed out again holds zeros in every layer's K and V
    pool, whatever it held before."""
    eng = PagedContinuousServeEngine(params, cfg, slots=2, max_seq=32,
                                     block_size=8, **CPU)
    eng.run(_reqs([([5, 6, 7], 2)]))        # builds the pool and allocator
    pools = list(eng._pools())
    blk = eng.alloc.alloc()
    with torch.inference_mode():          # the engine's pools are inference
        for pool in pools:                # tensors
            pool[:, :, blk] = 3.0
        eng.alloc.release(blk)
        got = eng._get_block()
    assert got == blk
    for pool in pools:
        assert bool((pool[:, :, got] == 0).all())


def test_allocator_and_helpers_match_reference(cfg):
    load_reference()
    import repro.configs as jconfigs
    import repro.serve.engine as jengine
    jcfg = jconfigs.reduced_config("smollm-135m")
    assert np.array_equal(poisson_arrivals(9, 0.7, seed=3),
                          jengine.poisson_arrivals(9, 0.7, seed=3))
    for bs in (8, 16):
        assert kv_block_bytes(cfg, bs) == jengine.kv_block_bytes(jcfg, bs)
    big = dataclasses.replace(cfg, dtype="bfloat16")
    assert kv_block_bytes(big, 16) == jengine.kv_block_bytes(
        dataclasses.replace(jcfg, dtype="bfloat16"), 16)
    assert [_bucket(n) for n in (1, 8, 9, 200)] == \
        [jengine._bucket(n) for n in (1, 8, 9, 200)]
    a = BlockAllocator(5)
    b1, b2 = a.alloc(), a.alloc()
    assert (b1, b2, a.n_used, a.n_free) == (2, 3, 2, 1)
    a.ref(b1)
    assert not a.release(b1) and a.release(b1) and a.n_free == 2


@pytest.mark.parametrize("mode", [[], ["--continuous"], ["--paged"]])
def test_launcher_serves_on_cpu(mode, capsys):
    from repro_torch.launch.serve import main
    done = main(["--reduced", "--approx", "mul8s_1L2H:lut", "--requests",
                 "3", "--new-tokens", "3", "--slots", "2", "--device",
                 "cpu", *mode])
    assert [len(r.out) for r in done] == [3, 3, 3]
    out = capsys.readouterr().out
    assert "tok/s" in out
    if mode == ["--paged"]:
        assert "attn_plan.route: fused_attn_paged" in out


def test_lm_entry_points_refuse_missing_gpu(cfg, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: init_params(0, cfg),
                 lambda: ServeEngine({}, cfg),
                 lambda: ContinuousServeEngine({}, cfg),
                 lambda: PagedContinuousServeEngine({}, cfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()

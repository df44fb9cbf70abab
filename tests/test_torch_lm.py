"""The port's LM substrate (configs, layers, transformer) against the JAX
reference on the CPU, at ``reduced_config("smollm-135m")`` (2 layers, d 64,
4 heads over 1 KV head, head_dim 16, vocab 224) with the reference's
parameters carried over by ``load_jax_params``.

Tolerances, with their reasons:

* float32 logits, ``LOGIT_TOL`` of the logits' scale: every GEMM's codes
  are the reference's bit for bit, and the attention kernel's float glue
  (``exp``, the normalizer's summation order) rounds a few ulp apart
  (``test_torch_attention.py``); two layers and the head carry that to a
  few hundred ulp of the logits at most, while one flipped activation code
  would move a logit by a whole table step times two scales (about 1e-2
  here), which the bound would catch.
* bfloat16 logits: bitwise against the reference run op by op
  (``jax.disable_jit``). Compiled, the reference's ``lax.scan`` body fuses
  bfloat16 roundings away, and differs from its own op-by-op run; that
  run, not the fused one, is what each op of the port reproduces.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import (ARCH_NAMES, get_config,  # noqa: E402
                                 reduced_config)
from repro_torch.core import ApproxConfig, make_acu  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.transformer import (apply_model,  # noqa: E402
                                            init_cache, init_paged_cache,
                                            init_params, load_jax_params)
from test_torch_parity import load_reference  # noqa: E402

MULT = "mul8s_1L2H"
LOGIT_TOL = 1e-5
ROUTES = {"exact": None, "lut": dict(),
          "unfused": dict(use_kernels=True),
          "fused": dict(use_kernels=True, fused=True)}


@pytest.fixture(scope="module")
def ref():
    load_reference()
    import repro.configs as jconfigs
    import repro.models.layers as jlayers
    import repro.models.transformer as jtrans
    return jconfigs, jlayers, jtrans


def _cfgs(ref, dtype="float32", arch="smollm-135m"):
    jconfigs = ref[0]
    return (dataclasses.replace(jconfigs.reduced_config(arch), dtype=dtype),
            dataclasses.replace(reduced_config(arch), dtype=dtype))


def _params(ref, jcfg):
    import jax
    jp = ref[2].init_params(jax.random.PRNGKey(0), jcfg)
    return jp, load_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


def _acfgs(ref, route):
    """The reference's ACU (Pallas in interpret mode where the route uses
    kernels, so attention reaches kernels 8 and 9) and the port's."""
    kw = ROUTES[route]
    if kw is None:
        return None, None
    load_reference()
    import repro.core as jcore
    j = jcore.ApproxConfig(acu=jcore.make_acu(
        MULT, "lut", use_pallas=kw.get("use_kernels", False),
        interpret=True, fused=kw.get("fused", False)))
    return j, ApproxConfig(acu=make_acu(MULT, "lut", **kw))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    import jax.numpy as jnp
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_configs_match_reference(ref):
    jconfigs = ref[0]
    assert ARCH_NAMES == jconfigs.ARCH_NAMES
    for name in ARCH_NAMES:
        for get in ("get_config", "reduced_config"):
            t = dataclasses.asdict(globals()[get](name))
            j = dataclasses.asdict(getattr(jconfigs, get)(name))
            assert t == j, (name, get)
        c, jc = get_config(name), jconfigs.get_config(name)
        assert (c.n_params(), c.n_active_params(), c.vocab_padded,
                c.n_groups) == (jc.n_params(), jc.n_active_params(),
                                jc.vocab_padded, jc.n_groups)
    assert get_config("smollm-135m").param_dtype == torch.bfloat16
    assert reduced_config("smollm-135m").param_dtype == torch.float32
    with pytest.raises(KeyError):
        get_config("gpt-5")


def test_init_params_layout_matches_reference(ref):
    import jax
    jcfg, cfg = _cfgs(ref, "bfloat16")
    jp = ref[2].init_params(jax.random.PRNGKey(0), jcfg)
    tp = init_params(0, cfg, device="cpu")
    jl = jax.tree_util.tree_flatten_with_path(jp)[0]
    flat = {}

    def walk(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                flat[path + (k,)] = v
    walk(tp)
    want = {tuple(p.key for p in path): leaf for path, leaf in jl}
    assert set(flat) == set(want)
    for key, leaf in want.items():
        assert tuple(flat[key].shape) == leaf.shape, key
        assert str(flat[key].dtype).split(".")[-1] == str(leaf.dtype), key
    loaded = load_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    emb = loaded["embed"]
    assert emb.dtype == torch.bfloat16 and np.array_equal(
        emb.view(torch.int16).numpy(), np.asarray(jp["embed"]).view(np.int16))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_rope_silu(ref, dtype):
    """bfloat16: bitwise. float32: XLA's rsqrt, cos, sin and exp round an
    ulp or two apart from PyTorch's, so within 8 ulp of the largest
    value."""
    import jax
    import jax.numpy as jnp
    jl = ref[1]
    rng = np.random.default_rng(1)
    jdt = jnp.dtype(dtype)

    def pair(a):
        j = jnp.asarray(a, jdt)
        t = torch.from_numpy(np.asarray(j.astype(jnp.float32)))
        return j, t.to(getattr(torch, dtype))

    xj, xt = pair(rng.normal(size=(2, 5, 4, 16)))
    wj, wt = pair(rng.normal(size=16))
    bj, bt = pair(rng.normal(size=16))
    pos = rng.integers(0, 300, (2, 5))
    for a, b in ((jl.rms_norm(xj, wj), TL.rms_norm(xt, wt)),
                 (jl.rms_norm(xj, wj, plus_one=True),
                  TL.rms_norm(xt, wt, plus_one=True)),
                 (jl.layer_norm(xj, wj, bj), TL.layer_norm(xt, wt, bt)),
                 (jl.apply_rope(xj, jnp.asarray(pos)),
                  TL.apply_rope(xt, torch.from_numpy(pos))),
                 (jax.nn.silu(xj), TL.silu(xt))):
        a, b = _np(a), _np(b)
        if dtype == "bfloat16":
            assert np.array_equal(a, b)
        else:
            eps = float(np.finfo(np.float32).eps)
            assert np.abs(a - b).max() <= 8 * eps * np.abs(a).max()


@pytest.mark.parametrize("case", ["causal", "window", "vector_offset",
                                  "pad_mask", "chunked"])
def test_gqa_attention_matches_reference(ref, case):
    """The exact attention: float32 einsums, so summation order differs;
    held to 1e-5 relative."""
    import jax.numpy as jnp
    jl = ref[1]
    rng = np.random.default_rng(2)
    s_len, t_len = (8, 8) if case == "chunked" else (3, 11)
    q = rng.normal(size=(2, s_len, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, t_len, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, t_len, 2, 16)).astype(np.float32)
    kw = dict(causal=True)
    jkw, tkw = {}, {}
    if case == "window":
        kw["window"] = 4
        jkw["q_offset"] = tkw["q_offset"] = 8
    if case == "vector_offset":
        off = np.array([8, 3])
        jkw["q_offset"], tkw["q_offset"] = jnp.asarray(off), \
            torch.from_numpy(off)
    if case == "pad_mask":
        pm = np.ones((2, t_len), bool)
        pm[1, :4] = False
        jkw["pad_mask"], tkw["pad_mask"] = jnp.asarray(pm), \
            torch.from_numpy(pm)
        jkw["q_offset"] = tkw["q_offset"] = 8
    if case == "chunked":
        kw.update(chunk=4, causal_blocking=True)
    want = jl.gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            **kw, **jkw)
    got = TL.gqa_attention(*[torch.from_numpy(a) for a in (q, k, v)], **kw,
                           **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _prefill_decode(apply, init, params, cfg, acfg, toks, **kw):
    cache = init(cfg, 2, 32, **kw)
    logits, cache = apply(params, toks[0], cfg, acfg=acfg, cache=cache,
                          cache_pos=0)
    step, _ = apply(params, toks[1], cfg, acfg=acfg, cache=cache,
                    cache_pos=toks[0].shape[1], decode=True)
    return logits, step


@pytest.mark.parametrize("route", list(ROUTES))
def test_apply_model_float32_logits(ref, route):
    """Prefill (12 tokens) and one decode step of the port's apply_model
    against the reference's, on each ACU route and the exact path."""
    import jax.numpy as jnp
    jcfg, cfg = _cfgs(ref)
    jp, tp = _params(ref, jcfg)
    jacfg, tacfg = _acfgs(ref, route)
    rng = np.random.default_rng(0)
    toks = [rng.integers(1, cfg.vocab_size, (2, n)) for n in (12, 1)]
    want = _prefill_decode(ref[2].apply_model, ref[2].init_cache, jp, jcfg,
                           jacfg, [jnp.asarray(t, jnp.int32) for t in toks])
    with torch.inference_mode():
        got = _prefill_decode(apply_model, init_cache, tp, cfg, tacfg,
                              [torch.from_numpy(t) for t in toks],
                              device="cpu")
    for w, g in zip(want, got):
        w, g = _np(w), _np(g)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= LOGIT_TOL * np.abs(w).max()
        assert np.array_equal(g.argmax(-1), w.argmax(-1))


def test_apply_model_bfloat16_bitwise_op_by_op(ref):
    """bfloat16, fused ACU: prefill and decode logits equal the reference
    run op by op, bit for bit (module docstring)."""
    import jax
    import jax.numpy as jnp
    jcfg, cfg = _cfgs(ref, "bfloat16")
    jp, tp = _params(ref, jcfg)
    jacfg, tacfg = _acfgs(ref, "fused")
    rng = np.random.default_rng(0)
    toks = [rng.integers(1, cfg.vocab_size, (2, n)) for n in (12, 1)]
    with jax.disable_jit():
        want = _prefill_decode(ref[2].apply_model, ref[2].init_cache, jp,
                               jcfg, jacfg,
                               [jnp.asarray(t, jnp.int32) for t in toks])
    with torch.inference_mode():
        got = _prefill_decode(apply_model, init_cache, tp, cfg, tacfg,
                              [torch.from_numpy(t) for t in toks],
                              device="cpu")
    for w, g in zip(want, got):
        assert g.dtype == torch.bfloat16
        assert np.array_equal(g.view(torch.int16).numpy(),
                              np.asarray(w).view(np.int16))


def test_paged_model_equals_contiguous():
    """Paged KV is a layout, not a change of math: block-aligned chunked
    prefill and a decode step through a permuted page table give the
    contiguous cache's logits bit for bit (same kernel body, gathered
    blocks holding the same values)."""
    cfg = reduced_config("smollm-135m")
    params = init_params(0, cfg, device="cpu")
    acfg = ApproxConfig(acu=make_acu(MULT, "lut", use_kernels=True,
                                     fused=True))
    prompt = torch.from_numpy(np.random.default_rng(5).integers(
        1, cfg.vocab_size, (1, 16)))
    with torch.inference_mode():
        cache = init_cache(cfg, 1, 32, device="cpu")
        a, _ = apply_model(params, prompt[:, :8], cfg, acfg=acfg,
                           cache=cache, cache_pos=0)
        b, _ = apply_model(params, prompt[:, 8:], cfg, acfg=acfg,
                           cache=cache, cache_pos=8)
        c, _ = apply_model(params, prompt[:, :1], cfg, acfg=acfg,
                           cache=cache, cache_pos=torch.tensor([16]))
        pool = init_paged_cache(cfg, 6, 8, device="cpu")
        pt = torch.tensor([[3, 5, 2, 0]], dtype=torch.int32)
        pa, _ = apply_model(params, prompt[:, :8], cfg, acfg=acfg,
                            cache=pool, cache_pos=0, page_table=pt)
        pb, _ = apply_model(params, prompt[:, 8:], cfg, acfg=acfg,
                            cache=pool, cache_pos=8, page_table=pt)
        pc, _ = apply_model(params, prompt[:, :1], cfg, acfg=acfg,
                            cache=pool, cache_pos=torch.tensor([16]),
                            page_table=pt)
    # the contiguous cache holds 32 positions in one 128-key block, the
    # pool 8-key blocks: p is relative to the running max at the end of
    # each block, so only a single-block prefix compares bitwise
    assert torch.equal(a, pa)
    for x, y in ((b, pb), (c, pc)):
        assert x.shape == y.shape and torch.isfinite(y).all()
    # the K/V written through the table: the first chunk in every layer;
    # the second in layer 0 only (layer 1's input went through attention)
    k, v = pool["groups"]["b0"]["attn"]
    kc, vc = cache["groups"]["b0"]["attn"]
    for blk, lo, layers in ((3, 0, 2), (5, 8, 1)):
        for pool_t, cont in ((k, kc), (v, vc)):
            assert torch.equal(pool_t[:layers, :, blk],
                               cont[:layers, 0, lo:lo + 8].transpose(1, 2))

"""whisper-small on the CPU: the port's ``models/whisper.py`` (``_sinusoid``,
``init_params``, ``encode``, ``decode`` with its cache, ``loss_fn``,
``init_cache``), the cross-attention path of ``attention_block`` and the
plain-GELU MLP, at ``reduced_config("whisper-small")`` (2 encoder and 2
decoder layers, d 64, 4 heads over 4 KV heads, d_ff 256, enc_ctx 16,
vocab 211, 128 learned positions) against the JAX reference, with the
reference's parameters carried over by ``load_jax_params``.

Tolerances, with their reasons:

* ``_sinusoid``: within ``4 * n * eps`` for n positions. ``log(10000)``
  and the divide are the reference's float32 ops, but XLA's ``exp``,
  ``sin`` and ``cos`` round an ulp or two apart from PyTorch's, and an ulp
  of an angle of up to n rad moves its sine by up to ``n * eps``.
* float32 encoder outputs and logits: within ``LOGIT_TOL`` (1e-5) of the
  largest value, every row, on the exact, LUT and fused routes, against
  the compiled reference: its ``tanh``, ``exp`` and ``rsqrt`` round an ulp
  or two apart, and the exact GEMMs and attention sum in another order
  (measured: 6.1e-7 exact, 2.6e-7 on the LUT routes); one flipped code
  would move a logit by a table step times two scales, about 1e-2 here.
* bfloat16 on the LUT route: bitwise against the reference run op by op.
  The GELU follows ``jax.nn.gelu``'s op chain, each op rounded in
  bfloat16 (``layers.gelu``); ``F.gelu`` rounds once.
* The mirrors of the reference's own tests keep their tolerances.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import whisper as TW  # noqa: E402
from repro_torch.models.transformer import load_jax_params  # noqa: E402
from repro_torch.tree import leaves_with_names  # noqa: E402
from test_torch_lm import LOGIT_TOL, _acfgs, _cfgs, _np  # noqa: E402
from test_torch_parity import load_reference  # noqa: E402

ARCH = "whisper-small"
EPS = float(np.finfo(np.float32).eps)


@pytest.fixture(scope="module")
def ref():
    load_reference()
    import repro.configs as jconfigs
    import repro.models.layers as jlayers
    import repro.models.whisper as jwhisper
    return jconfigs, jlayers, jwhisper


def _setup(ref, dtype="float32", batch=2):
    """Configs, the reference's parameters in both packages and stub frames
    (rounded to the model's dtype, the same values for both)."""
    import jax
    import jax.numpy as jnp
    jcfg, cfg = _cfgs(ref, dtype, arch=ARCH)
    jp = ref[2].init_params(jax.random.PRNGKey(0), jcfg)
    tp = load_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(0)
    jfr = jnp.asarray(rng.normal(size=(batch, cfg.enc_ctx, cfg.d_model)),
                      jcfg.param_dtype)
    tfr = torch.from_numpy(_np(jfr)).to(cfg.param_dtype)
    return jcfg, cfg, jp, tp, jfr, tfr


def _run(W, params, frames, toks, cfg, acfg, as_tensor, init_kw):
    """Encode, a 6-token prefill into a fresh cache and one decode step;
    returns (enc_out, prefill logits, step logits)."""
    enc = W.encode(params, frames, cfg, acfg)
    cache = W.init_cache(cfg, frames.shape[0], 16, **init_kw)
    a, cache = W.decode(params, as_tensor(toks[0]), enc, cfg, acfg=acfg,
                        cache=cache)
    b, _ = W.decode(params, as_tensor(toks[1]), enc, cfg, acfg=acfg,
                    cache=cache, cache_pos=toks[0].shape[1])
    return enc, a, b


def _both(ref, route, dtype="float32", op_by_op=False):
    import contextlib
    import jax
    import jax.numpy as jnp
    jcfg, cfg, jp, tp, jfr, tfr = _setup(ref, dtype)
    jacfg, tacfg = _acfgs(ref, route)
    rng = np.random.default_rng(1)
    toks = [rng.integers(1, cfg.vocab_size, (2, n)) for n in (6, 1)]
    with jax.disable_jit() if op_by_op else contextlib.nullcontext():
        want = _run(ref[2], jp, jfr, toks, jcfg, jacfg,
                    lambda t: jnp.asarray(t, jnp.int32), {})
    with torch.inference_mode():
        got = _run(TW, tp, tfr, toks, cfg, tacfg, torch.from_numpy,
                   dict(device="cpu"))
    return want, got


# ---------------------------------------------------------------------------
# positions, parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d", [(16, 64), (1500, 768), (7, 10)])
def test_sinusoid_matches_reference(ref, n, d):
    want = np.asarray(ref[2]._sinusoid(n, d))
    got = TW._sinusoid(n, d, device="cpu")
    assert got.dtype == torch.float32 and got.shape == want.shape
    # the angles themselves: log(10000) and the divide in float32
    step = np.float32(np.log(np.float32(10000.0))) / np.float32(d // 2 - 1)
    assert np.float32(step) == np.float32(
        torch.log(torch.tensor(10000.0)) / torch.tensor(float(d // 2 - 1)))
    # an ulp of an angle of up to n rad moves its sine by n * eps
    tol = 4 * EPS * max(1.0, float(n))
    assert np.abs(got.numpy() - want).max() <= tol


def test_init_params_tree_matches_reference(ref):
    """``init_params``: the reference's leaves, ``keystr`` names, shapes and
    dtypes in bfloat16 (``cross_attn`` without QKV biases); the
    reference's own numbers load bit for bit."""
    import jax
    jcfg, cfg = _cfgs(ref, "bfloat16", arch=ARCH)
    jp = ref[2].init_params(jax.random.PRNGKey(0), jcfg)
    want = {jax.tree_util.keystr(path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(jp)[0]}
    got = dict(leaves_with_names(TW.init_params(0, cfg, device="cpu")))
    assert set(got) == set(want)
    for name, leaf in want.items():
        assert tuple(got[name].shape) == leaf.shape, name
        assert str(got[name].dtype).split(".")[-1] == str(leaf.dtype), name
    assert not any("cross_attn']['b" in n for n in got)
    loaded = dict(leaves_with_names(
        load_jax_params(jax.tree.map(np.asarray, jp), device="cpu")))
    for name, leaf in want.items():
        a = np.asarray(leaf)
        b = loaded[name]
        if a.dtype.name == "bfloat16":
            assert np.array_equal(b.view(torch.int16).numpy(),
                                  a.view(np.int16)), name
        else:
            assert np.array_equal(b.numpy(), a), name


# ---------------------------------------------------------------------------
# encode, decode, loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["exact", "lut", "fused"])
def test_encode_decode_float32(ref, route):
    """The encoder output, a 6-token prefill's logits and one decode step's
    against the reference's, within ``LOGIT_TOL`` on every row."""
    want, got = _both(ref, route)
    for w, g in zip(want, got):
        w, g = _np(w), _np(g)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= LOGIT_TOL * np.abs(w).max()
    for w, g in zip(want[1:], got[1:]):
        assert np.array_equal(_np(g).argmax(-1), _np(w).argmax(-1))


def test_encode_decode_bfloat16_bitwise_op_by_op(ref):
    """bfloat16 on the LUT route: encoder output and logits equal the
    reference run op by op, bit for bit."""
    want, got = _both(ref, "lut", "bfloat16", op_by_op=True)
    for w, g in zip(want, got):
        assert g.dtype == torch.bfloat16
        assert np.array_equal(g.view(torch.int16).numpy(),
                              np.asarray(w).view(np.int16))


@pytest.mark.parametrize("route", ["exact", "fused"])
def test_loss_fn_matches_reference(ref, route):
    import jax.numpy as jnp
    jcfg, cfg, jp, tp, jfr, tfr = _setup(ref)
    jacfg, tacfg = _acfgs(ref, route)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 9))
    want = ref[2].loss_fn(jp, jfr, jnp.asarray(toks[:, :-1], jnp.int32),
                          jnp.asarray(toks[:, 1:], jnp.int32), jcfg, jacfg)
    with torch.inference_mode():
        got = TW.loss_fn(tp, tfr, torch.from_numpy(toks[:, :-1]),
                         torch.from_numpy(toks[:, 1:]), cfg, tacfg)
    assert abs(float(got) - float(want)) <= LOGIT_TOL * abs(float(want))


def test_whisper_decode_matches_full():
    """Mirror of ``test_models.py::test_whisper_decode_matches_full``:
    prefill + one decode step equals the full decoder pass, at the
    reference test's tolerance."""
    cfg = reduced_config(ARCH)
    p = TW.init_params(0, cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (1, 9), generator=gen)
    frames = torch.randn((1, cfg.enc_ctx, cfg.d_model), generator=gen)
    with torch.inference_mode():
        enc = TW.encode(p, frames, cfg)
        full, _ = TW.decode(p, toks, enc, cfg)
        cache = TW.init_cache(cfg, 1, 12, device="cpu")
        _, cache = TW.decode(p, toks[:, :8], enc, cfg, cache=cache,
                             cache_pos=0)
        step, _ = TW.decode(p, toks[:, 8:], enc, cfg, cache=cache,
                            cache_pos=8)
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, 8].numpy(),
                               rtol=2e-2, atol=2e-2)


def test_smoke_forward_and_step_whisper(ref):
    """Mirror of ``test_models.py::test_smoke_forward_and_step`` at whisper:
    finite logits of the padded vocab, a finite loss with finite gradients
    for every leaf through ``loss_fn``, the loss the reference's within
    ``LOGIT_TOL``."""
    import jax.numpy as jnp
    jcfg, cfg, jp, tp, jfr, tfr = _setup(ref)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 16))
    tt = torch.from_numpy(toks)
    with torch.no_grad():
        logits, _ = TW.decode(tp, tt, TW.encode(tp, tfr, cfg), cfg)
    assert logits.shape[-1] == cfg.vocab_padded
    assert torch.isfinite(logits).all()
    named = leaves_with_names(tp)
    for _, leaf in named:
        leaf.requires_grad_(True)
    loss = TW.loss_fn(tp, tfr, tt[:, :-1], tt[:, 1:], cfg)
    loss.backward()
    assert torch.isfinite(loss)
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for _, t in named), [n for n, t in named if t.grad is None]
    want = ref[2].loss_fn(jp, jfr, jnp.asarray(toks[:, :-1], jnp.int32),
                          jnp.asarray(toks[:, 1:], jnp.int32), jcfg)
    assert abs(loss.item() - float(want)) <= LOGIT_TOL * abs(float(want))


# ---------------------------------------------------------------------------
# cross-attention, the cache, GELU, learned positions
# ---------------------------------------------------------------------------

def test_cross_attention_exact_under_acu(monkeypatch):
    """With the fused ACU, only the decoder's cached self-attention reaches
    the approximate attention (kernel 8's plain version here): the encoder's
    self-attention and every cross-attention take the exact
    ``gqa_attention``, non-causal over all enc_ctx keys, with no RoPE."""
    from repro_torch.core import ApproxConfig, make_acu
    cfg = reduced_config(ARCH)
    p = TW.init_params(0, cfg, device="cpu")
    acfg = ApproxConfig(acu=make_acu("mul8s_1L2H", "lut", use_kernels=True,
                                     fused=True))
    calls = {"approx": 0, "exact": []}
    approx, exact = TL.approx_attention, TL.gqa_attention

    def spy_approx(*a, **k):
        calls["approx"] += 1
        return approx(*a, **k)

    def spy_exact(q, k, v, **kw):
        calls["exact"].append((q.shape[1], k.shape[1], kw["causal"]))
        return exact(q, k, v, **kw)

    monkeypatch.setattr(TL, "approx_attention", spy_approx)
    monkeypatch.setattr(TL, "gqa_attention", spy_exact)
    gen = torch.Generator().manual_seed(1)
    frames = torch.randn((2, cfg.enc_ctx, cfg.d_model), generator=gen)
    toks = torch.randint(0, cfg.vocab_size, (2, 5), generator=gen)
    t = cfg.enc_ctx
    with torch.inference_mode():
        enc = TW.encode(p, frames, cfg, acfg)
        assert calls == {"approx": 0,
                         "exact": [(t, t, False)] * cfg.n_enc_layers}
        calls["exact"].clear()
        cache = TW.init_cache(cfg, 2, 16, device="cpu")
        TW.decode(p, toks[:, :4], enc, cfg, acfg=acfg, cache=cache)
        TW.decode(p, toks[:, 4:], enc, cfg, acfg=acfg, cache=cache,
                  cache_pos=4)
    assert calls["approx"] == 2 * cfg.n_layers
    assert calls["exact"] == ([(4, t, False)] * cfg.n_layers
                              + [(1, t, False)] * cfg.n_layers)


def test_cache_k_and_v_distinct(ref):
    """The reference's ``init_cache`` returns one array as K and V; the
    port's are two tensors, so a decode writes different K and V (V would
    otherwise overwrite K)."""
    jcfg, cfg, jp, tp, jfr, tfr = _setup(ref)
    jk, jv = ref[2].init_cache(jcfg, 2, 16)["groups"]["self"]
    cache = TW.init_cache(cfg, 2, 16, device="cpu")
    k, v = cache["groups"]["self"]
    assert k.shape == jk.shape and v.shape == jv.shape
    assert k.data_ptr() != v.data_ptr() and not k.is_set_to(v)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        1, cfg.vocab_size, (2, 3)))
    with torch.inference_mode():
        TW.decode(tp, toks, TW.encode(tp, tfr, cfg), cfg, cache=cache)
    assert k[:, :, :3].abs().sum() > 0 and v[:, :, :3].abs().sum() > 0
    assert not torch.equal(k[:, :, :3], v[:, :, :3])
    assert not k[:, :, 3:].any() and not v[:, :, 3:].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlp_matches_reference(ref, dtype):
    """``layers.gelu`` against ``jax.nn.gelu`` op by op, and the plain-GELU
    ``mlp_block`` (biases drawn) on the LUT route: bfloat16 bitwise;
    float32 within 4 ulp of the largest value (XLA's ``tanh`` rounds an
    ulp apart). ``F.gelu(approximate="tanh")`` rounds bfloat16 once and
    differs."""
    import jax
    import jax.numpy as jnp
    import torch.nn.functional as F
    jcfg, cfg = _cfgs(ref, dtype, arch=ARCH)
    rng = np.random.default_rng(5)
    xj = jnp.asarray(rng.normal(size=(4, 6, cfg.d_model)) * 3, dtype)
    x = torch.from_numpy(_np(xj)).to(cfg.param_dtype)
    mlp = {"w_up": rng.normal(size=(cfg.d_model, cfg.d_ff)) * 0.1,
           "b_up": rng.normal(size=cfg.d_ff),
           "w_down": rng.normal(size=(cfg.d_ff, cfg.d_model)) * 0.1,
           "b_down": rng.normal(size=cfg.d_model)}
    jm = {n: jnp.asarray(a, dtype) for n, a in mlp.items()}
    tm = {n: torch.from_numpy(_np(a)).to(cfg.param_dtype)
          for n, a in jm.items()}
    jacfg, tacfg = _acfgs(ref, "lut")
    with jax.disable_jit():
        want = [jax.nn.gelu(xj), ref[1].mlp_block(xj, jm, jcfg, jacfg)]
    got = [TL.gelu(x), TL.mlp_block(x, tm, cfg, tacfg)]
    for w, g in zip(want, got):
        w, g = _np(w), _np(g)
        if dtype == "bfloat16":
            assert np.array_equal(g, w)
        else:
            assert np.abs(g - w).max() <= 4 * EPS * np.abs(w).max()
    if dtype == "bfloat16":
        once = _np(F.gelu(x, approximate="tanh"))
        assert not np.array_equal(once, _np(want[0]))


@pytest.mark.parametrize("pos", [0, 5, 120, 125, 300])
def test_dec_pos_clamps_like_dynamic_slice(ref, pos):
    """The learned positions of a decode call start at ``cache_pos``,
    clamped so that the slice fits (``dynamic_slice``): an int and a 0-d
    tensor ``cache_pos`` alike; never an error, never a read past the
    end."""
    import jax
    import jax.numpy as jnp
    table = np.random.default_rng(6).normal(size=(128, 8)).astype(np.float32)
    for s in (1, 4):
        want = np.asarray(jax.lax.dynamic_slice_in_dim(
            jnp.asarray(table), jnp.asarray(pos), s, axis=0))
        for cp in (pos, torch.tensor(pos)):
            got = TW._dec_positions(torch.from_numpy(table), cp, s)
            assert np.array_equal(got.numpy(), want)

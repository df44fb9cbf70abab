"""Scoring an LM through ``loss_fn``, the port against the JAX reference
on the CPU: ``cross_entropy``, ``loss_fn`` at smollm-135m and gemma2-27b
reduced (the cache-less forward, with ``attn_impl`` ``chunked`` and
``flash``), ``MarkovLM``'s token stream, and Qwen2-VL's M-RoPE
(``apply_mrope`` and qwen2-vl-72b reduced ``apply_model``). The
reference's parameters are carried over by ``load_jax_params``.

Tolerances, with their reasons (``test_torch_lm.py`` states
``LOGIT_TOL``):

* ``cross_entropy``: 1e-6 of the loss; both take ``logsumexp - gold`` in
  float32 and only the sums' order differs.
* ``loss_fn``'s logits, against the compiled reference: exact GEMMs,
  every row within ``LOGIT_TOL`` on both ``attn_impl`` values (kernel 11
  scales q before ``q @ k.T``, the chunked path after: an ulp apart).
  Approximate GEMMs (the LUT ACU, bitwise in both packages): the compiled
  reference flips an activation code against its own op-by-op run (one
  row of gemma2-27b reduced moves by 0.039 of logits up to 3.6, 1.35 of
  the head's largest one-code steps; the port's rows, chunked and flash,
  are within 1e-6 of the op-by-op run). So at most ``FLIP_ROWS`` row may
  exceed ``LOGIT_TOL``, each of its logits by at most ``FLIP_CODES`` of
  the head's largest one-code step, ``max_n xs * ws[n] * max_k max_a
  |LUT[a + 1, w_kn] - LUT[a, w_kn]|`` (the final softcap's slope is at
  most 1): an upstream flip reaches the head as a shift of one or two of
  its input codes. Every argmax is equal.
* gradients of ``loss_fn`` (the chunked path under autograd): float32
  sums in another order, 1e-4 of each leaf's largest entry.
* M-RoPE: float32 within 8 ulp of the largest value (``cos``/``sin``
  round apart), bfloat16 bitwise; qwen2-vl-72b reduced float32 logits
  within ``LOGIT_TOL``, bfloat16 bitwise against the reference run op by
  op (``jax.disable_jit``), no ACU (the LUT routes share every GEMM with
  the other configs; M-RoPE is what is new).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import ApproxConfig, make_acu  # noqa: E402
from repro_torch.data.pipeline import MarkovLM  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.transformer import (apply_model,  # noqa: E402
                                            loss_fn)
from test_torch_lm import LOGIT_TOL, MULT, _cfgs, _np, _params, ref  # noqa: E402
from lm_arch_cases import FLIP_ROWS  # noqa: E402

__all__ = ["ref"]        # the fixture, shared with test_torch_lm.py

SCORE_ARCHS = ["smollm-135m", "gemma2-27b"]
FLIP_CODES = 2


def _acfgs(route):
    """The reference's LUT ACU (its plain LUT GEMM, bitwise equal to its
    fused kernel) and the port's fused kernel ACU (the kernels' plain
    versions on the CPU); ``exact``: none."""
    if route == "exact":
        return None, None
    import repro.core as jcore
    return (jcore.ApproxConfig(acu=jcore.make_acu(MULT, "lut")),
            ApproxConfig(acu=make_acu(MULT, "lut", use_kernels=True,
                                      fused=True)))


def _batch(cfg, seed=0, seq=24):
    """A (2, seq) batch of tokens and labels, seq past gemma2's reduced
    window of 8."""
    b = next(MarkovLM(cfg.vocab_size, seed=seed).batches(2, seq))
    return b["tokens"], b["labels"]


@pytest.fixture(scope="module")
def reference(ref):
    """(port config, port parameters, reference logits, reference loss)
    per (arch, route), computed once by one jitted call of the reference's
    ``loss_fn``; its logits are taken where its ``cross_entropy``
    receives them."""
    import jax
    import jax.numpy as jnp

    @functools.lru_cache(maxsize=None)
    def get(arch, route):
        jcfg, cfg = _cfgs(ref, arch=arch)
        jp, tp = _params(ref, jcfg)
        jacfg, _ = _acfgs(route)
        inner = ref[1].cross_entropy

        def loss_and_logits(params, toks, labels):
            seen = []

            def recording(logits, *a):
                seen.append(logits)
                return inner(logits, *a)

            ref[1].cross_entropy = recording
            try:
                loss = ref[2].loss_fn(params, toks, labels, jcfg, acfg=jacfg)
            finally:
                ref[1].cross_entropy = inner
            return loss, seen[0]

        loss, logits = jax.jit(loss_and_logits)(
            jp, *(jnp.asarray(a) for a in _batch(cfg)))
        return cfg, tp, _np(logits), float(loss)

    return get


def _head_steps(x: torch.Tensor, w: torch.Tensor, acfg) -> np.ndarray:
    """Per logit, how far one activation code of the head's input moving
    by one step moves it: ``xs * ws[n] * max_k max_a |LUT[a + 1, w_kn] -
    LUT[a, w_kn]|`` (the head's quantizers as ``approx_dense`` builds
    them)."""
    from repro_torch.core import acu_operand, quantize, symmetric_qparams
    acu = acfg.acu
    xs = symmetric_qparams(torch.clamp_min(x.abs().amax(), 1e-6), 8).scale
    wqp = symmetric_qparams(torch.clamp_min(w.abs().amax(dim=0), 1e-9), 8,
                            axis=1)
    wq = acu_operand(quantize(w, wqp), wqp).numpy() + acu.offset
    step = np.abs(np.diff(acu.lut.astype(np.int64), axis=0)).max(axis=0)
    return float(xs) * wqp.scale.numpy() * step[wq].max(axis=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_matches_reference(ref, dtype):
    """Padded vocab columns masked (33 of 40 valid), labels anywhere in
    the valid vocab."""
    import jax.numpy as jnp
    rng = np.random.default_rng(4)
    logits = (rng.normal(size=(2, 5, 40)) * 4).astype(np.float32)
    labels = rng.integers(0, 33, (2, 5))
    jdt = jnp.dtype(dtype)
    jlog = jnp.asarray(logits, jdt)
    want = float(ref[1].cross_entropy(jlog, jnp.asarray(labels), 33))
    tlog = torch.from_numpy(np.array(jlog.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = TL.cross_entropy(tlog, torch.from_numpy(labels), 33)
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-6 * abs(want)
    # the padded columns count for nothing, whatever they hold
    tlog[..., 33:] = 1e4
    assert float(TL.cross_entropy(tlog, torch.from_numpy(labels), 33)) \
        == float(got)


def _spy(monkeypatch) -> list:
    """Records every call of kernel 11's wrapper from the layers."""
    calls = []
    inner = TL.flash_attention

    def spy(*a, **k):
        calls.append(a[0].shape)
        return inner(*a, **k)

    monkeypatch.setattr(TL, "flash_attention", spy)
    return calls


@pytest.mark.parametrize("impl", ["chunked", "flash"])
@pytest.mark.parametrize("route", ["exact", "lut"])
@pytest.mark.parametrize("arch", SCORE_ARCHS)
def test_loss_fn_matches_reference(reference, monkeypatch, arch, route,
                                   impl):
    """The port's ``loss_fn`` (and its logits) against the reference's,
    no ACU and the LUT ACU, each ``attn_impl``, within the module
    docstring's bounds; with ``flash`` every layer's attention runs kernel
    11 (its plain version here), once per layer and forward, and
    ``chunked`` never reaches it."""
    calls = _spy(monkeypatch)
    head = {}
    inner = TL.lm_head

    def lm_head(x, w, acfg, softcap=None):
        head.update(x=x, w=w)
        return inner(x, w, acfg, softcap=softcap)

    monkeypatch.setattr(TL, "lm_head", lm_head)
    cfg, tp, want_logits, want_loss = reference(arch, route)
    cfg = dataclasses.replace(cfg, attn_impl=impl)
    _, tacfg = _acfgs(route)
    toks, labels = (torch.from_numpy(a) for a in _batch(cfg))
    with torch.no_grad():
        logits, _ = apply_model(tp, toks, cfg, acfg=tacfg)
        loss = loss_fn(tp, toks, labels, cfg, acfg=tacfg)
    assert len(calls) == (2 * cfg.n_layers if impl == "flash" else 0)
    got = _np(logits)
    assert got.shape == want_logits.shape
    diff = np.abs(got - want_logits)
    err = diff.max(-1)
    beyond = err > LOGIT_TOL * np.abs(want_logits).max()
    if route == "exact":
        assert not beyond.any()
    else:
        assert int(beyond.sum()) <= FLIP_ROWS
        steps = _head_steps(head["x"], head["w"], tacfg)
        assert (diff[beyond] <= FLIP_CODES * steps.max()).all()
    assert np.array_equal(got.argmax(-1), want_logits.argmax(-1))
    bound = 2 * err.mean() + 1e-6 * abs(want_loss)
    assert abs(float(loss) - want_loss) <= bound
    assert float(loss) == float(TL.cross_entropy(logits, labels,
                                                 cfg.vocab_size))


def test_loss_fn_gradient_matches_jax_grad(ref, monkeypatch):
    """qwen2-vl-72b reduced (M-RoPE), no ACU, ``attn_impl="flash"``: under
    autograd every layer takes the chunked path (kernel 11 has no
    backward), and every parameter's gradient is ``jax.grad``'s within
    1e-4 of the leaf's largest entry."""
    import jax
    import jax.numpy as jnp
    calls = _spy(monkeypatch)
    jcfg, cfg = _cfgs(ref, arch="qwen2-vl-72b")
    cfg = dataclasses.replace(cfg, attn_impl="flash")
    jp, tp = _params(ref, jcfg)
    toks, labels = _batch(cfg, seed=1)
    want = jax.jit(jax.grad(functools.partial(ref[2].loss_fn, cfg=jcfg)))(
        jp, jnp.asarray(toks), jnp.asarray(labels))
    leaves = {}

    def walk(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                leaves[path + (k,)] = v.requires_grad_(True)
    walk(tp)
    loss = loss_fn(tp, torch.from_numpy(toks), torch.from_numpy(labels), cfg)
    loss.backward()
    assert not calls
    flat = {tuple(p.key for p in path): np.asarray(g) for path, g in
            jax.tree_util.tree_flatten_with_path(want)[0]}
    assert set(flat) == set(leaves)
    for key, g in flat.items():
        got = leaves[key].grad.numpy()
        assert np.abs(got - g).max() <= 1e-4 * np.abs(g).max(), key


def test_markov_lm_batches_bitwise(ref):
    """The same seeds give the reference's chain and batches, bit for
    bit."""
    load = __import__("repro.data.pipeline", fromlist=["MarkovLM"])
    want = load.MarkovLM(1000, seed=3).batches(4, 33, seed=5)
    got = MarkovLM(1000, seed=3).batches(4, 33, seed=5)
    for _ in range(3):
        w, g = next(want), next(got)
        for key in ("tokens", "labels"):
            assert g[key].dtype == w[key].dtype == np.int32
            assert np.array_equal(g[key], w[key])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mrope_matches_reference(ref, dtype):
    """Three distinct position streams over sections (4, 2, 2) of a head
    dim of 16; with equal streams M-RoPE is RoPE, bit for bit."""
    import jax.numpy as jnp
    rng = np.random.default_rng(6)
    jdt = jnp.dtype(dtype)
    xj = jnp.asarray(rng.normal(size=(2, 5, 4, 16)), jdt)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        getattr(torch, dtype))
    pos = rng.integers(0, 300, (3, 2, 5))
    want = _np(ref[1].apply_mrope(xj, jnp.asarray(pos), (4, 2, 2)))
    got = _np(TL.apply_mrope(xt, torch.from_numpy(pos), (4, 2, 2)))
    if dtype == "bfloat16":
        assert np.array_equal(got, want)
    else:
        eps = float(np.finfo(np.float32).eps)
        assert np.abs(got - want).max() <= 8 * eps * np.abs(want).max()
    same = torch.from_numpy(pos[:1]).expand(3, 2, 5)
    assert torch.equal(TL.apply_mrope(xt, same, (4, 2, 2)),
                       TL.apply_rope(xt, same[0]))


def test_qwen2_vl_apply_model_float32_logits(ref):
    """qwen2-vl-72b reduced (M-RoPE, QKV biases), no ACU: logits within
    ``LOGIT_TOL`` of the reference's, every argmax equal."""
    import jax.numpy as jnp
    jcfg, cfg = _cfgs(ref, arch="qwen2-vl-72b")
    jp, tp = _params(ref, jcfg)
    jacfg, tacfg = _acfgs("exact")
    toks, _ = _batch(cfg, seed=2, seq=12)
    want = _np(ref[2].apply_model(jp, jnp.asarray(toks), jcfg,
                                  acfg=jacfg)[0])
    with torch.no_grad():
        got = _np(apply_model(tp, torch.from_numpy(toks), cfg,
                              acfg=tacfg)[0])
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


def test_qwen2_vl_apply_model_bfloat16_bitwise_op_by_op(ref):
    """bfloat16, no ACU: the logits equal the reference run op by op, bit
    for bit (M-RoPE in float32, rounded to bfloat16 as the reference
    rounds it)."""
    import jax
    import jax.numpy as jnp
    jcfg, cfg = _cfgs(ref, "bfloat16", arch="qwen2-vl-72b")
    jp, tp = _params(ref, jcfg)
    toks, _ = _batch(cfg, seed=2, seq=12)
    with jax.disable_jit():
        want = ref[2].apply_model(jp, jnp.asarray(toks), jcfg)[0]
    with torch.no_grad():
        got = apply_model(tp, torch.from_numpy(toks), cfg)[0]
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy(),
                          np.asarray(want).view(np.int16))

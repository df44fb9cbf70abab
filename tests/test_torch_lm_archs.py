"""The other dense decoder LMs of the config zoo (no experts, no recurrent
layers) against the JAX reference on the CPU: gemma2-27b (local and global
layers, attention and final softcaps, post-norms, (1+w) RMS norm, GeGLU),
qwen2.5-14b (QKV biases) and command-r-plus-104b (the parallel block with
layer norm), each at its ``reduced_config``, with the reference's
parameters carried over by ``load_jax_params``.

Tolerances, with their reasons (``test_torch_lm.py`` holds SmolLM-135M to
the same ``LOGIT_TOL`` on every row):

* exact attention (the ``exact`` and ``lut`` routes): every row within
  ``LOGIT_TOL`` of the compiled reference.
* approximate attention (the ``fused`` route, kernel 8's plain version):
  against the reference run op by op. Compiled, the reference flips codes
  against its own op-by-op run (seven rows of gemma2-27b's prefill, by up
  to 0.07). Where an ulp of the attention output sits on an activation's
  rounding boundary, one code of the next GEMM flips and moves that row by
  a table step times two scales (0.0106 of logits up to 3.6 in
  command-r-plus-104b's prefill, traced to one code of layer 1's output
  projection). So at most ``FLIP_ROWS`` = 1 row per
  call may exceed ``LOGIT_TOL``, by at most ``FLIP_ROW_TOL`` = 1e-2 of the
  logits' scale (three such steps); every argmax is equal.
* the engines: the reference engines' greedy tokens, request for request
  (``test_torch_lm_serve.engine_parity``).
"""
from __future__ import annotations

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.models.transformer import apply_model, init_cache  # noqa: E402
from test_torch_lm import (LOGIT_TOL, _acfgs, _cfgs, _np,  # noqa: E402
                           _params, _prefill_decode, ref)
from test_torch_lm_serve import ENGINES, engine_parity  # noqa: E402

OTHER_ARCHS = ["gemma2-27b", "qwen2.5-14b", "command-r-plus-104b"]
# the unfused GEMM route reaches the same attention as the fused one, and
# test_torch_lm.py holds it against the reference for SmolLM-135M
ARCH_ROUTES = ["exact", "lut", "fused"]
FLIP_ROWS = 1
FLIP_ROW_TOL = 1e-2

__all__ = ["ref"]        # the fixture, shared with test_torch_lm.py


@pytest.mark.parametrize("arch", OTHER_ARCHS)
@pytest.mark.parametrize("route", ARCH_ROUTES)
def test_apply_model_other_archs_float32_logits(ref, route, arch):
    """Prefill (12 tokens) and one decode step of the port's apply_model
    against the reference's, exact, with approximate GEMMs, and with
    approximate GEMMs and attention, within the module docstring's
    bounds."""
    import jax
    import jax.numpy as jnp
    jcfg, cfg = _cfgs(ref, arch=arch)
    jp, tp = _params(ref, jcfg)
    jacfg, tacfg = _acfgs(ref, route)
    approx_attn = route == "fused"
    rng = np.random.default_rng(0)
    toks = [rng.integers(1, cfg.vocab_size, (2, n)) for n in (12, 1)]
    with jax.disable_jit() if approx_attn else contextlib.nullcontext():
        want = _prefill_decode(ref[2].apply_model, ref[2].init_cache, jp,
                               jcfg, jacfg,
                               [jnp.asarray(t, jnp.int32) for t in toks])
    with torch.inference_mode():
        got = _prefill_decode(apply_model, init_cache, tp, cfg, tacfg,
                              [torch.from_numpy(t) for t in toks],
                              device="cpu")
    for w, g in zip(want, got):
        w, g = _np(w), _np(g)
        assert g.shape == w.shape
        err = np.abs(g - w).max(-1)
        scale = np.abs(w).max()
        flips = int((err > LOGIT_TOL * scale).sum())
        assert flips <= (FLIP_ROWS if approx_attn else 0)
        assert err.max() <= FLIP_ROW_TOL * scale
        assert np.array_equal(g.argmax(-1), w.argmax(-1))


@pytest.mark.parametrize("arch", OTHER_ARCHS)
@pytest.mark.parametrize("engine", list(ENGINES))
def test_engines_give_reference_tokens_other_archs(engine, arch,
                                                   monkeypatch):
    """Five requests of mixed lengths and budgets through each engine with
    the fused ACU: the reference engine's greedy tokens."""
    engine_parity(engine, "float32", arch, monkeypatch)

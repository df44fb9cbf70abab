"""The shared cases of ``test_torch_lm_arch_*.py``: the other dense decoder
LMs of the config zoo (no experts, no recurrent layers) against the JAX
reference on the CPU, each at its ``reduced_config``, with the reference's
parameters carried over by ``load_jax_params``. Each architecture has a
file of its own (gemma2-27b, qwen2.5-14b, command-r-plus-104b), so that
``--dist loadfile`` runs them on three workers.

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
import torch

from repro_torch.models.transformer import apply_model, init_cache
from test_torch_lm import (LOGIT_TOL, _acfgs, _cfgs, _np, _params,
                           _prefill_decode)
from test_torch_lm_serve import ENGINES, engine_parity

# the unfused GEMM route reaches the same attention as the fused one, and
# test_torch_lm.py holds it against the reference for SmolLM-135M
ARCH_ROUTES = ["exact", "lut", "fused"]
FLIP_ROWS = 1
FLIP_ROW_TOL = 1e-2
ARCH_ENGINES = list(ENGINES)


def float32_logits_case(ref, route, arch):
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


def engine_case(engine, arch, monkeypatch):
    """Five requests of mixed lengths and budgets through each engine with
    the fused ACU: the reference engine's greedy tokens."""
    engine_parity(engine, "float32", arch, monkeypatch)

"""The MoE decoder LMs of the config zoo against the JAX reference on the
CPU: granite-moe-3b-a800m (40 experts, top-8; reduced: 8 experts, top-2,
GQA 4 over 1) and olmoe-1b-7b (64 experts, QK-norm; reduced: 8 experts,
top-2), each at its ``reduced_config`` with the reference's parameters
carried over by ``load_jax_params``.

Tolerances, with their reasons (``lm_arch_cases.py`` states them in
full):

* the exact path: every row within ``LOGIT_TOL`` of the compiled
  reference.
* approximate GEMMs (``lut``: the grouped GEMM's per-expert route; ``fused``:
  kernel 10's and kernel 8's plain versions, against the reference run op
  by op): the router's softmax rounds an ulp apart from XLA's, and so can
  the attention kernel's float glue; where such an ulp sits on an
  activation's rounding boundary one code of the next GEMM flips. So at most
  ``FLIP_ROWS`` = 1 row per call may exceed ``LOGIT_TOL``, by at most
  ``FLIP_ROW_TOL`` of the logits' scale; every argmax is equal.
* the engines (``test_torch_moe_engine_{wave,continuous,paged}.py``, one
  file each): the reference engines' greedy tokens, request for request,
  at the reduced config's ample capacity (8.0) and at 1.0, where tokens
  drop. MoE outputs depend on the batch (capacity is per dispatch block,
  padding rows are routed too), so equal tokens also show that the engines
  feed the reference's batches. At capacity 1.0 the reference engines run
  op by op: compiled, the wave engine's reference flips one code in layer
  1's approximate attention at the fourth token of the third request (its
  MoE input moves by 7e-3 and the token changes), which its own op-by-op
  run does not do; the port reproduces the op-by-op run, as everywhere
  (``test_torch_lm.py``).
"""
from __future__ import annotations

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.models.transformer import (apply_model,  # noqa: E402
                                            init_cache, init_params,
                                            load_jax_params)
from test_torch_lm import (LOGIT_TOL, _acfgs, _cfgs, _np,  # noqa: E402
                           _params, _prefill_decode, ref)
from lm_arch_cases import FLIP_ROW_TOL, FLIP_ROWS  # noqa: E402

MOE_ARCHS = ["granite-moe-3b-a800m", "olmoe-1b-7b"]

__all__ = ["ref"]        # the fixture, shared with test_torch_lm.py


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_params_layout_and_load(ref, arch):
    """``init_params`` builds the reference's leaves (router (g, d, E)
    float32; w_gate/w_up (g, E, d, f) and w_down (g, E, f, d) in bfloat16)
    at its scales, and ``load_jax_params`` carries every leaf over bit for
    bit."""
    import jax
    jcfg, cfg = _cfgs(ref, "bfloat16", arch)
    jp = ref[2].init_params(jax.random.PRNGKey(0), jcfg)
    tp = init_params(0, cfg, device="cpu")
    want = {tuple(p.key for p in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(jp)[0]}
    got = dict(_leaves(tp))
    assert set(got) == set(want)
    for key, leaf in want.items():
        assert tuple(got[key].shape) == leaf.shape, key
        assert str(got[key].dtype).split(".")[-1] == str(leaf.dtype), key
    moe = tp["groups"]["b0"]["mlp"]
    g, d, f, e = cfg.n_groups, cfg.d_model, cfg.d_ff, cfg.n_experts
    assert (tuple(moe["router"].shape), moe["router"].dtype) == \
        ((g, d, e), torch.float32)
    assert tuple(moe["w_down"].shape) == (g, e, f, d)
    for name, scale in (("router", d ** -0.5), ("w_gate", d ** -0.5),
                        ("w_down", f ** -0.5)):
        std = float(moe[name].float().std())
        assert abs(std / scale - 1) < 0.15, (name, std, scale)
    loaded = dict(_leaves(load_jax_params(jax.tree.map(np.asarray, jp),
                                          device="cpu")))
    for key, leaf in want.items():
        a = np.asarray(leaf)
        t = loaded[key]
        if t.dtype == torch.bfloat16:
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  a.view(np.int16)), key
        else:
            assert np.array_equal(t.numpy(), a), key


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("route", ["exact", "lut", "fused"])
def test_apply_model_moe_float32_logits(ref, route, arch):
    """Prefill (12 tokens) and one decode step of the port's apply_model
    against the reference's, exact, with approximate GEMMs, and with
    approximate GEMMs and attention, within the module docstring's
    bounds."""
    import jax
    import jax.numpy as jnp
    jcfg, cfg = _cfgs(ref, arch=arch)
    jp, tp = _params(ref, jcfg)
    jacfg, tacfg = _acfgs(ref, route)
    rng = np.random.default_rng(0)
    toks = [rng.integers(1, cfg.vocab_size, (2, n)) for n in (12, 1)]
    op_by_op = route == "fused"
    with jax.disable_jit() if op_by_op else contextlib.nullcontext():
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
        assert flips <= (0 if route == "exact" else FLIP_ROWS)
        assert err.max() <= FLIP_ROW_TOL * scale
        assert np.array_equal(g.argmax(-1), w.argmax(-1))

"""jamba-v0.1-52b on the CPU: the port's ``init_params``, ``init_cache``,
``apply_model`` and ``loss_fn`` at ``reduced_config("jamba-v0.1-52b")``
(8 layers: 3 ``mamba``, 4 ``mamba_moe``, 1 ``attn``; d 64, d_inner 128,
d_state 16, 4 heads over 1 KV head, 8 experts top-2 of d_ff 32, vocab 211)
against the JAX reference, with the reference's parameters carried over
by ``load_jax_params``.

Tolerances, with their reasons: float32 logits within ``LOGIT_TOL`` (1e-5)
of the largest, every row, on the exact, LUT and fused routes. XLA's
``exp``, ``log1p``, ``tanh`` and ``rsqrt`` round an ulp or two apart from
PyTorch's, and the ``C``-contraction and the exact GEMMs sum in another
order; eight layers carry that to a few hundred ulp (measured: 1.8e-6
exact, 2.2e-7 on the LUT routes), while one flipped activation code would
move a logit by a table step times two scales, about 1e-2 here. The
mirrors of the reference's own tests keep their tolerances.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.models.transformer import (apply_model,  # noqa: E402
                                            init_cache, init_paged_cache,
                                            init_params, loss_fn)
from repro_torch.serve.engine import PagedContinuousServeEngine  # noqa: E402
from repro_torch.tree import leaves_with_names  # noqa: E402
from test_torch_lm import (LOGIT_TOL, _acfgs, _cfgs, _np,  # noqa: E402
                           _params, _prefill_decode)
from test_torch_mamba import EPS, ref  # noqa: E402

ARCH = "jamba-v0.1-52b"

__all__ = ["ref"]        # the fixture, shared with test_torch_mamba.py


@pytest.mark.parametrize("route", ["exact", "lut", "fused"])
def test_apply_model_jamba_float32_logits(ref, route):
    """Prefill (12 tokens) and one decode step of jamba's apply_model
    against the reference's, every row within ``LOGIT_TOL``."""
    import jax.numpy as jnp
    jcfg, cfg = _cfgs(ref, arch=ARCH)
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


def test_decode_matches_full_forward_jamba():
    """Mirror of ``test_models.py::test_decode_matches_full_forward`` at
    jamba: prefill + one decode step equals the full forward, at the
    reference test's tolerance."""
    cfg = reduced_config(ARCH)
    p = init_params(0, cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (1, 9)))
    with torch.inference_mode():
        full, _ = apply_model(p, toks, cfg)
        cache = init_cache(cfg, 1, 12, device="cpu")
        apply_model(p, toks[:, :8], cfg, cache=cache, cache_pos=0)
        step, _ = apply_model(p, toks[:, 8:], cfg, cache=cache, cache_pos=8,
                              decode=True)
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, 8].numpy(),
                               rtol=2e-2, atol=2e-2)


def test_smoke_forward_and_step_jamba(ref):
    """Mirror of ``test_models.py::test_smoke_forward_and_step`` at jamba:
    finite logits of the padded vocab, and a finite loss with finite
    gradients for every leaf through ``loss_fn``; the loss is the
    reference's within ``LOGIT_TOL``."""
    import jax.numpy as jnp
    jcfg, cfg = _cfgs(ref, arch=ARCH)
    jp, tp = _params(ref, jcfg)
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 16))
    tt = torch.from_numpy(toks)
    with torch.no_grad():
        logits, _ = apply_model(tp, tt, cfg)
    assert logits.shape[-1] == cfg.vocab_padded
    assert torch.isfinite(logits).all()
    for leaf in [t for _, t in leaves_with_names(tp)]:
        leaf.requires_grad_(True)
    loss = loss_fn(tp, tt[:, :-1], tt[:, 1:], cfg)
    loss.backward()
    assert torch.isfinite(loss)
    named = leaves_with_names(tp)
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for _, t in named), [n for n, t in named if t.grad is None]
    want = ref[2].loss_fn(jp, jnp.asarray(toks[:, :-1], jnp.int32),
                          jnp.asarray(toks[:, 1:], jnp.int32), jcfg)
    assert abs(float(loss) - float(want)) <= LOGIT_TOL * abs(float(want))


def test_cache_tree_names_match_reference(ref):
    """``MambaState`` is a NamedTuple: the port's tree helpers give the
    reference cache's leaves in ``jax.tree.leaves`` order under its
    ``keystr`` names, with its shapes and dtypes."""
    import jax
    jcfg, cfg = _cfgs(ref, "bfloat16", arch=ARCH)
    jc = ref[2].init_cache(jcfg, 2, 16)
    want = [(jax.tree_util.keystr(path), leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(jc)[0]]
    got = leaves_with_names(init_cache(cfg, 2, 16, device="cpu"))
    assert [n for n, _ in got] == [n for n, _ in want]
    assert any(".ssm" in n for n, _ in got)
    for (_, g), (_, w) in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).split(".")[-1] == str(w.dtype)


def test_init_params_layout_matches_reference_jamba(ref):
    """``init_params`` gives the reference's tree (mamba leaves included),
    shapes and dtypes in bfloat16."""
    import jax
    jcfg, cfg = _cfgs(ref, "bfloat16", arch=ARCH)
    jp = ref[2].init_params(jax.random.PRNGKey(0), jcfg)
    want = {jax.tree_util.keystr(path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(jp)[0]}
    got = dict(leaves_with_names(init_params(0, cfg, device="cpu")))
    assert set(got) == set(want)
    for name, leaf in want.items():
        assert tuple(got[name].shape) == leaf.shape, name
        assert str(got[name].dtype).split(".")[-1] == str(leaf.dtype), name
    # log(1 .. d_state): XLA's log and PyTorch's round an ulp apart
    a_log = got["['groups']['b0']['mamba']['A_log']"].numpy()
    w_log = np.asarray(want["['groups']['b0']['mamba']['A_log']"])
    assert np.abs(a_log - w_log).max() <= 2 * EPS * np.abs(w_log).max()


def test_paged_cache_refuses_jamba():
    """The paged cache pages attention KV only: jamba's mamba layers are
    refused, by the cache and by the paged engine, as the reference's
    ``init_paged_cache`` refuses them."""
    cfg = reduced_config(ARCH)
    with pytest.raises(NotImplementedError, match="mamba"):
        init_paged_cache(cfg, 8, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="mamba"):
        PagedContinuousServeEngine(init_params(0, cfg, device="cpu"), cfg,
                                   slots=2, max_seq=32, block_size=8,
                                   device="cpu")


"""The PyTorch port against the JAX reference, end to end on the CPU.

Holds the lazy reference loader every ``test_torch_*`` file uses, and the
slice as a whole: a tiny ResNet and a tiny CNN, the reference's parameters
carried over with ``load_jax_params``, through the three LUT ACU routes
(plain LUT GEMM, unfused kernels, fused kernels) of both packages. Every
conv output must be bitwise equal; the logits must be within the bound
below and agree on the argmax.

Logit bound: the global mean pool sums in a different order in the two
packages, so a pooled activation may differ by 1 ulp. Through the head's
activation amax that moves the activation scale by at most 1 ulp, and a
pooled value or the scale moving by 1 ulp can move each activation code by
at most one step. So each logit may move by at most
``xs * ws[n] * sum_k max_a |LUT[a+1, w_kn] - LUT[a, w_kn]|`` plus a few ulp
of the logit for the rescaled dequant product.
"""
from __future__ import annotations

import dataclasses
import importlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")


def load_reference():
    """Import the JAX reference (``repro``) and return the package.

    Under jax 0.9 ``repro.core.quantization`` tests ``x in
    batching.primitive_batchers`` at import, and the object there no longer
    supports ``in``. For the import only, the module attribute is swapped for
    a proxy whose ``__contains__`` says yes and that forwards item access;
    the original object is restored afterwards, whatever happens. The
    reference itself is not changed.

    Call it from fixtures or test bodies only, never at module import: every
    test worker imports every test module while collecting.
    """
    from jax.interpreters import batching

    if "repro.core" not in sys.modules:
        # a failed import (another test module's, at collection) leaves the
        # submodules that did load behind, bound to a package object that
        # is gone: drop them so they load again under the new package
        for name in [m for m in sys.modules if m.startswith("repro.core.")]:
            del sys.modules[name]
    original = batching.primitive_batchers

    class _Proxy:
        def __contains__(self, key):
            return True

        def __getitem__(self, key):
            return original[key]

        def __setitem__(self, key, value):
            original[key] = value

    batching.primitive_batchers = _Proxy()
    try:
        for name in ("repro.core", "repro.models.vision",
                     "repro.serve.engine"):
            importlib.import_module(name)
    finally:
        batching.primitive_batchers = original
    return sys.modules["repro"]


@pytest.fixture(scope="module")
def ref():
    return load_reference()


def test_loader_restores_primitive_batchers():
    from jax.interpreters import batching
    before = batching.primitive_batchers
    load_reference()
    assert batching.primitive_batchers is before
    load_reference()          # idempotent once the package is imported
    assert batching.primitive_batchers is before


def _jax_params(params) -> dict:
    return {k: np.asarray(v) for k, v in params.items()}


def _record(monkeypatch, module):
    """Record every conv2d_block output of ``module``'s forwards."""
    outs = []
    inner = module.conv2d_block

    def recording(*args, **kwargs):
        y = inner(*args, **kwargs)
        outs.append(np.asarray(y))
        return y

    monkeypatch.setattr(module, "conv2d_block", recording)
    return outs


def _head_bound(tp, x_pool: torch.Tensor, acu) -> np.ndarray:
    """The stated logit bound (module docstring), from the port's head."""
    from repro_torch.core import acu_operand, quantize, symmetric_qparams
    w = tp["head"]
    xs = symmetric_qparams(torch.clamp_min(x_pool.abs().amax(), 1e-6), 8)
    wqp = symmetric_qparams(torch.clamp_min(w.abs().amax(dim=0), 1e-9), 8,
                            axis=1)
    wq = acu_operand(quantize(w, wqp), wqp).numpy() + acu.offset
    lut = acu.lut.astype(np.int64)
    step = np.abs(np.diff(lut, axis=0)).max(axis=0)      # per table column
    per_n = step[wq].sum(axis=0)                         # (N,)
    return float(xs.scale) * wqp.scale.numpy() * per_n


ROUTES = [dict(), dict(use_kernels=True),
          dict(use_kernels=True, fused=True)]


def _acus(ref, kw, lut_chunk=256):
    """The reference's ACU for one route and the port's counterpart."""
    from repro_torch.core import make_acu
    j = ref.core.make_acu("mul8s_1L2H", "lut",
                          use_pallas=kw.get("use_kernels", False),
                          fused=kw.get("fused", False))
    t = make_acu("mul8s_1L2H", "lut", **kw)
    return (dataclasses.replace(j, lut_chunk=lut_chunk),
            dataclasses.replace(t, lut_chunk=lut_chunk))


@pytest.mark.parametrize("route", ROUTES, ids=["lut", "unfused", "fused"])
def test_resnet_matches_reference(ref, route, monkeypatch):
    import jax
    import jax.numpy as jnp
    import repro_torch.models.vision as tv
    from repro_torch.core import ApproxConfig

    jv = ref.models.vision
    params = jv.init_resnet(jax.random.PRNGKey(0), width=4, n_blocks=1)
    x = np.random.default_rng(0).normal(size=(2, 3, 8, 8)).astype(np.float32)

    # the plain LUT route runs the one-gather baseline (lut_chunk=0) here and
    # the K-chunked default in the CNN test: both plain routes are covered
    jacu, acu = _acus(ref, route, lut_chunk=0)
    j_outs = _record(monkeypatch, jv)
    yj = np.asarray(jv.resnet_forward(params, jnp.asarray(x),
                                      ref.core.ApproxConfig(acu=jacu),
                                      n_blocks=1))
    t_outs = _record(monkeypatch, tv)
    head_in = _capture_head_input(monkeypatch, tv)
    tp = tv.load_jax_params(_jax_params(params), device="cpu")
    with torch.inference_mode():
        yt = tv.resnet_forward(tp, torch.from_numpy(x), ApproxConfig(acu=acu),
                               n_blocks=1).numpy()

    assert len(t_outs) == len(j_outs) == 9     # stem, 3x2 convs, 2 shortcuts
    for i, (a, b) in enumerate(zip(t_outs, j_outs)):
        assert a.shape == b.shape and np.array_equal(a, b), f"conv {i}"
    bound = _head_bound(tp, head_in[0], acu)
    assert np.all(np.abs(yt - yj) <= bound + 4 * np.finfo(np.float32).eps
                  * np.abs(yj))
    assert np.array_equal(yt.argmax(-1), yj.argmax(-1))


def _capture_head_input(monkeypatch, tv):
    """Record the input of the port's dense head (the pooled features)."""
    seen = []
    inner = tv.approx_dense

    def capture(xh, *args, **kwargs):
        seen.append(xh)
        return inner(xh, *args, **kwargs)

    monkeypatch.setattr(tv, "approx_dense", capture)
    return seen


@pytest.mark.parametrize("route", ROUTES, ids=["lut", "unfused", "fused"])
def test_cnn_matches_reference(ref, route, monkeypatch):
    import jax
    import jax.numpy as jnp
    import repro_torch.models.vision as tv
    from repro_torch.core import ApproxConfig

    jv = ref.models.vision
    params = jv.init_cnn(jax.random.PRNGKey(1), width=4, img=8)
    x = np.random.default_rng(1).normal(size=(2, 3, 8, 8)).astype(np.float32)
    jacu, acu = _acus(ref, route)
    j_outs = _record(monkeypatch, jv)
    yj = np.asarray(jv.cnn_forward(params, jnp.asarray(x),
                                   ref.core.ApproxConfig(acu=jacu)))
    t_outs = _record(monkeypatch, tv)
    tp = tv.load_jax_params(_jax_params(params), device="cpu")
    with torch.inference_mode():
        yt = tv.cnn_forward(tp, torch.from_numpy(x),
                            ApproxConfig(acu=acu)).numpy()
    assert len(t_outs) == len(j_outs) == 3
    for i, (a, b) in enumerate(zip(t_outs, j_outs)):
        assert np.array_equal(a, b), f"conv {i}"
    # no mean pool on this path: max pools and flatten are exact, so the
    # dense layers see bitwise-equal inputs and the logits match bitwise
    assert np.array_equal(yt, yj)

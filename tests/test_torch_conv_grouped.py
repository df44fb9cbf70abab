"""Grouped, depthwise and separable convs against the JAX reference on the
CPU: ``conv2d(groups=...)`` and ``separable_conv2d``, on the LUT ACU with
the fused kernels (their plain versions here) and on EXACT at 12 bits,
bitwise in the forward and within float32 rounding in the STE gradients.

The depthwise route is one GEMM against a block-diagonal weight. Under a
table with ``M[0, x] != 0`` its structural zeros add their table entries,
so the biased case shows that the port reproduces them instead of skipping
them (ROADMAP observation (a)). The grouped route runs one GEMM per group,
each with its own activation scale, as the reference's ``vmap`` does.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (ApproxConfig, conv2d, make_acu,  # noqa: E402
                              separable_conv2d)
from repro_torch.core.acu import ConvSpec, conv_plan  # noqa: E402
from test_torch_parity import load_reference  # noqa: E402

_V = np.arange(-128, 128, dtype=np.int32)
BIASED_LUT = (_V[:, None] * _V[None, :] + 7).astype(np.int32)


@pytest.fixture(scope="module")
def ref():
    return load_reference()


def _cfgs(ref, acu: str):
    """(port config, reference config) for one ACU: the fused LUT kernels,
    the same under a biased table, or EXACT at 12 bits."""
    if acu == "exact12":
        return (ApproxConfig(acu=make_acu("mul12s_exact", "exact"),
                             a_bits=12, w_bits=12),
                ref.core.ApproxConfig(
                    acu=ref.core.make_acu("mul12s_exact", "exact"),
                    a_bits=12, w_bits=12))
    name = "mul8s_exact" if acu == "biased" else "mul8s_1L2H"
    t = make_acu(name, "lut", use_kernels=True, fused=True)
    j = ref.core.make_acu(name, "lut", use_pallas=True, fused=True)
    if acu == "biased":
        t = dataclasses.replace(t, lut=BIASED_LUT, _tables={})
        j = dataclasses.replace(j, lut=BIASED_LUT)
    return ApproxConfig(acu=t), ref.core.ApproxConfig(acu=j)


# name: (x_shape, w_shape, groups, stride, padding, dilation)
CASES = {
    "groups2": ((2, 8, 9, 9), (6, 4, 3, 3), 2, (1, 1), "SAME", (1, 1)),
    "groups4_stride2": ((2, 8, 10, 10), (8, 2, 3, 3), 4, (2, 2), "SAME",
                        (1, 1)),
    "depthwise": ((2, 6, 9, 8), (6, 1, 3, 3), 6, (1, 1), "SAME", (1, 1)),
    "depthwise_mult2_dil2": ((1, 4, 11, 11), (8, 1, 3, 3), 4, (1, 1),
                             "VALID", (2, 2)),
}


def _run(fn_t, fn_j, args, grad: bool):
    """The port's output (and its gradients of ``sum(y * r)``) and the
    reference's, as numpy arrays; the reference runs its forward once."""
    import jax
    import jax.numpy as jnp
    ts = [torch.from_numpy(a).requires_grad_(grad) for a in args]
    y_t = fn_t(*ts)
    y_j, vjp = jax.vjp(fn_j, *map(jnp.asarray, args))
    out = [(y_t.detach().numpy(), np.asarray(y_j))]
    if grad:
        r = np.random.default_rng(99).normal(
            size=tuple(y_t.shape)).astype(np.float32)
        (y_t * torch.from_numpy(r)).sum().backward()
        out += [(t.grad.numpy(), np.asarray(g))
                for t, g in zip(ts, vjp(jnp.asarray(r)))]
    return out


@pytest.mark.parametrize("acu", ["lut_fused", "exact12"])
@pytest.mark.parametrize("name", list(CASES))
def test_grouped_conv_matches_reference(ref, name, acu):
    """Forward bitwise with a bias; the STE gradients of x, w and b within
    float32 rounding (sums in another order)."""
    x_shape, w_shape, groups, stride, padding, dil = CASES[name]
    rng = np.random.default_rng(sum(x_shape) + groups)
    x = rng.normal(size=x_shape).astype(np.float32)
    w = rng.normal(size=w_shape).astype(np.float32)
    b = rng.normal(size=w_shape[0]).astype(np.float32)
    cfg_t, cfg_j = _cfgs(ref, acu)
    kw = dict(stride=stride, padding=padding, dilation=dil, groups=groups)
    (y, want), *grads = _run(
        lambda x, w, b: conv2d(x, w, b, cfg=cfg_t, **kw),
        lambda x, w, b: ref.core.conv2d(x, w, b, cfg=cfg_j, **kw),
        (x, w, b), grad=True)
    assert y.shape == want.shape and np.array_equal(y, want)
    for got, exp in grads:
        np.testing.assert_allclose(got, exp, rtol=1e-5, atol=1e-5)
    route = conv_plan(cfg_t.acu, ConvSpec(x_shape, w_shape, groups=groups),
                      fused=True).route
    assert route == ("im2col_depthwise" if w_shape[1] == 1
                     else "im2col_grouped")


def test_depthwise_biased_table_counts_structural_zeros(ref):
    """Under M[0, x] = 7 every structural zero of the block-diagonal weight
    adds a table entry: the port's output equals the reference's bitwise,
    and differs from a per-channel conv that skips them."""
    x_shape, w_shape, groups, stride, padding, dil = CASES["depthwise"]
    rng = np.random.default_rng(17)
    x = rng.normal(size=x_shape).astype(np.float32)
    w = rng.normal(size=w_shape).astype(np.float32)
    cfg_t, cfg_j = _cfgs(ref, "biased")
    kw = dict(padding=padding, groups=groups)
    [(y, want)] = _run(lambda x, w: conv2d(x, w, cfg=cfg_t, **kw),
                       lambda x, w: ref.core.conv2d(x, w, cfg=cfg_j, **kw),
                       (x, w), grad=False)
    assert np.array_equal(y, want)
    # channel by channel (no structural zeros): a different answer
    per_ch = torch.cat([conv2d(torch.from_numpy(x[:, c:c + 1]),
                               torch.from_numpy(w[c:c + 1]), cfg=cfg_t,
                               padding=padding)
                        for c in range(x_shape[1])], dim=1)
    assert not np.array_equal(per_ch.numpy(), y)


@pytest.mark.parametrize("acu", ["lut_fused", "exact12"])
def test_separable_conv2d_matches_reference(ref, acu):
    """Depthwise 3x3 with a stride, then a 1x1 conv with a bias: forward
    bitwise, gradients within float32 rounding."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 4, 10, 10)).astype(np.float32)
    w_dw = rng.normal(size=(4, 1, 3, 3)).astype(np.float32)
    w_pw = rng.normal(size=(6, 4, 1, 1)).astype(np.float32)
    b = rng.normal(size=6).astype(np.float32)
    cfg_t, cfg_j = _cfgs(ref, acu)
    (y, want), *grads = _run(
        lambda *a: separable_conv2d(*a, stride=(2, 2), cfg=cfg_t),
        lambda *a: ref.core.approx_ops.separable_conv2d(
            *a, stride=(2, 2), cfg=cfg_j),
        (x, w_dw, w_pw, b), grad=True)
    assert y.shape == (2, 6, 5, 5) and np.array_equal(y, want)
    for got, exp in grads:
        np.testing.assert_allclose(got, exp, rtol=1e-5, atol=1e-5)


def test_grouped_exact_conv_without_acu(ref):
    """cfg=None: the float conv with groups, as the reference's lax conv."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 8, 8, 8)).astype(np.float32)
    w = rng.normal(size=(8, 2, 3, 3)).astype(np.float32)
    [(y, want)] = _run(lambda x, w: conv2d(x, w, groups=4),
                       lambda x, w: ref.core.conv2d(x, w, groups=4),
                       (x, w), grad=False)
    np.testing.assert_allclose(y, want, rtol=1e-5, atol=1e-5)

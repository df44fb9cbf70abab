"""The CUDA loops of kernel 12 (``csrc/wkv.cu``'s sequence kernel) and of
its backward (``csrc/wkv_bwd.cu``), mirrored on the CPU by
``kernels/wkv/ref.py: wkv_tiled_ref`` and ``wkv_bwd_tiled_ref``: the same
16-step sub-chunks, slots, tiles and summation order (16 lanes, each over
hd / 16 entries in order, then halves first).

* the backward's mirror against ``wkv_bwd_ref`` (the plain version the CPU
  takes) at T = 1, 255, 256, 257 and 1024, head dim 16, with a nonzero
  ``ds_t``: every state it restores bitwise the forward's, ``ds0``
  bitwise (both carry dS by the same multiply and add), the other
  gradients within ``GRAD_TOL`` of their largest entry (the row and column
  sums run in another order);
* the mirror against ``jax.grad`` of the reference's recurrence
  (``repro.kernels.wkv.ref.wkv_ref``, one head): within ``JAX_TOL`` (XLA
  contracts the state's multiply and add into an FMA, so the reference's
  states, and through them every gradient, move by a few ulp);
* the forward's mirror against ``wkv_ref``: ``S_T`` and the chunk
  boundaries bitwise, ``out`` within ``out_bound``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels.wkv.ref import (out_bound, wkv_bwd_ref,
                                         wkv_bwd_tiled_ref, wkv_ref,
                                         wkv_tiled_ref)
from test_torch_rwkv import _recurrence

CHUNK = 256          # the reference's rwkv_chunk
GRAD_TOL = 1e-5      # of a gradient's largest entry: summation order only
JAX_TOL = 1e-5       # of a gradient's largest entry: order and XLA's FMAs


def _rel(got: torch.Tensor, want) -> float:
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _case(seed, bh, t, hd, h):
    rng = np.random.default_rng(seed)
    arrays = _recurrence(rng, bh, t, hd, h)
    dout = rng.normal(size=(bh, t, hd)).astype(np.float32)
    ds_t = rng.normal(size=(bh, hd, hd)).astype(np.float32)
    return [torch.from_numpy(a) for a in arrays + (dout, ds_t)]


@pytest.mark.parametrize("t", [1, 255, 256, 257, 1024])
def test_backward_mirror_matches_plain_version(t):
    """Sub-chunks of 16 in chunks of 256, the last one short where T is
    not a multiple: restored states and ds0 bitwise, the rest within
    ``GRAD_TOL``."""
    h, hd, b = 2, 16, 2
    r, k, v, w, u, s0, dout, ds_t = _case(t, b * h, t, hd, h)
    _, _, bounds = wkv_ref(r, k, v, w, u, s0, chunk=CHUNK)
    want = wkv_bwd_ref(r, k, v, w, u, bounds, dout, ds_t, CHUNK)
    *got, states = wkv_bwd_tiled_ref(r, k, v, w, u, bounds, dout, ds_t,
                                     CHUNK, keep_states=True)
    s = s0
    for step in range(t):
        assert torch.equal(states[:, step], s), step
        s = (w[:, step, :, None] * s
             + k[:, step, :, None] * v[:, step, None, :])
    assert torch.equal(got[5], want[5])
    for name, g, w_ in zip(("dr", "dk", "dv", "dw", "du"), got, want):
        assert _rel(g, w_) <= GRAD_TOL, name


@pytest.mark.parametrize("t", [1, 257])
def test_backward_mirror_matches_jax_grad(t):
    """One head, rows of it: the mirror's gradients of
    ``sum(out * dout) + sum(S_T * ds_t)`` against ``jax.grad`` of the
    reference's scan (its pure-jnp oracle, which needs nothing else of the
    reference)."""
    import jax
    import jax.numpy as jnp
    from repro.kernels.wkv.ref import wkv_ref as jax_wkv_ref
    bh, hd = 3, 16
    r, k, v, w, u, s0, dout, ds_t = _case(100 + t, bh, t, hd, 1)

    def loss(r_, k_, v_, w_, u_, s0_):
        out, s_t = jax_wkv_ref(r_, k_, v_, w_, u_[0], s0_)
        return (jnp.sum(out * jnp.asarray(dout.numpy()))
                + jnp.sum(s_t * jnp.asarray(ds_t.numpy())))

    want = jax.grad(loss, argnums=tuple(range(6)))(
        *(jnp.asarray(a.numpy()) for a in (r, k, v, w, u, s0)))
    _, _, bounds = wkv_ref(r, k, v, w, u, s0, chunk=CHUNK)
    got = wkv_bwd_tiled_ref(r, k, v, w, u, bounds, dout, ds_t, CHUNK)
    # the mirror's (dr, dk, dv, dw, du, ds0) and jax's (r, k, v, w, u, s0)
    for name, g, w_ in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got, want):
        assert _rel(g, np.asarray(w_)) <= JAX_TOL, name


@pytest.mark.parametrize("t", [1, 17, 300])
def test_forward_mirror_matches_plain_version(t):
    """The sequence kernel's order: the state and the chunk boundaries
    bitwise, ``out`` within ``out_bound``."""
    h, hd, b = 2, 16, 2
    r, k, v, w, u, s0, _, _ = _case(200 + t, b * h, t, hd, h)
    want = wkv_ref(r, k, v, w, u, s0, chunk=CHUNK)
    got = wkv_tiled_ref(r, k, v, w, u, s0, chunk=CHUNK)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert bool(((got[0] - want[0]).abs()
                 <= out_bound(r, k, v, w, u, s0)).all())

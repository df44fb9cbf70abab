"""The backward of kernel 12 (the WKV recurrence, ``kernels/wkv``).

* ``wkv_bwd_ref`` (the plain version, chunked: each chunk's states
  restored from its boundary state) against autograd through the plain
  forward ``wkv_ref``, at T = 1, at a T that is not a multiple of the
  chunk and at several chunk lengths: within ``GRAD_TOL`` of each
  gradient's largest entry (the two differ only in the order of their
  float32 sums);
* ``wkv(...)`` carries that backward on the CPU, raises ``ValueError`` for
  a gradient through the in-place ``state_out=`` serving path, and its
  ``meta`` shape rule counts the backward as ``wkv_bwd``;
* ``models/rwkv.py: time_mix`` and ``transformer.loss_fn`` at rwkv6-3b
  reduced (float32, the exact route) against ``jax.grad`` of the
  reference's, with ``perturb`` making ``bonus`` and ``lora_B_*`` nonzero:
  every leaf's gradient within ``MODEL_TOL`` of its largest entry;
* on the card (marked ``cuda``): the CUDA backward ``csrc/wkv_bwd.cu``
  against ``wkv_bwd_ref`` within ``CUDA_TOL``, with ``du`` bitwise equal
  across two runs and every state it restores bitwise the forward's.
"""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.wkv import ops as wkv_ops
from repro_torch.kernels.wkv.ref import wkv_bwd_ref, wkv_ref
from repro_torch.models import rwkv as TR
from repro_torch.models.transformer import loss_fn
from test_torch_rwkv import _cfgs, _params, _recurrence
from test_torch_rwkv import ref  # noqa: F401  (the module fixture)

GRAD_TOL = 1e-5      # of a gradient's largest entry: summation order only
MODEL_TOL = 1e-4     # whole model: float32 glue around the recurrence
CUDA_TOL = 1e-4      # the CUDA backward: its sums run in another order


def _t(*arrays, grad=False):
    return [torch.from_numpy(a).requires_grad_(grad) for a in arrays]


def _close(got, want, tol):
    got = got.detach().double().numpy()
    want = want.detach().double().numpy() if isinstance(want, torch.Tensor) \
        else np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("t,chunk", [(1, 256), (7, 3), (16, 16), (21, 8),
                                     (9, 256)])
def test_wkv_bwd_ref_matches_autograd(t, chunk):
    """dr, dk, dv, dw, du and ds0 of ``wkv_bwd_ref`` against autograd
    through ``wkv_ref``, with a nonzero gradient on the final state."""
    rng = np.random.default_rng(t * 31 + chunk)
    h, hd, b = 2, 8, 3
    arrays = _recurrence(rng, b * h, t, hd, h)
    dout = rng.normal(size=(b * h, t, hd)).astype(np.float32)
    ds_t = rng.normal(size=(b * h, hd, hd)).astype(np.float32)
    r, k, v, w, u, s0 = _t(*arrays, grad=True)
    out, s_t = wkv_ref(r, k, v, w, u, s0)
    want = torch.autograd.grad(
        (out * torch.from_numpy(dout)).sum()
        + (s_t * torch.from_numpy(ds_t)).sum(), [r, k, v, w, u, s0])
    with torch.no_grad():
        _, s_t2, bounds = wkv_ref(r, k, v, w, u, s0, chunk=chunk)
        assert torch.equal(s_t2, s_t)
        assert bounds.shape[0] == -(-t // chunk)
        got = wkv_bwd_ref(r, k, v, w, u, bounds, torch.from_numpy(dout),
                          torch.from_numpy(ds_t), chunk)
    for g, w_ in zip(got, want):
        _close(g, w_, GRAD_TOL)


def test_wkv_autograd_function_on_the_cpu():
    """``wkv`` with inputs that require a gradient runs ``_WKV``: the same
    output as without one, gradients within ``GRAD_TOL`` of autograd
    through the plain forward; ``state_out=`` with a gradient raises."""
    rng = np.random.default_rng(5)
    b, t, h, hd = 2, 11, 3, 4
    r, k, v = (rng.normal(size=(b, t, h, hd)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.05, 0.95, (b, t, h, hd)).astype(np.float32)
    u = rng.normal(size=(h, hd)).astype(np.float32)
    s0 = rng.normal(size=(b, h, hd, hd)).astype(np.float32)
    args = _t(r, k, v, w, u, s0, grad=True)
    out, s_t = wkv_ops.wkv(*args, chunk=4)
    assert out.grad_fn is not None and s_t.grad_fn is not None
    with torch.no_grad():
        out0, s_t0 = wkv_ops.wkv(*args)
    assert torch.equal(out, out0) and torch.equal(s_t, s_t0)
    got = torch.autograd.grad((out ** 2).sum() + s_t.sum(), args)

    fold = lambda a: a.transpose(1, 2).reshape(b * h, t, hd)  # noqa: E731
    o2, s2 = wkv_ref(fold(args[0]), fold(args[1]), fold(args[2]),
                     fold(args[3]), args[4], args[5].reshape(b * h, hd, hd))
    o2 = o2.reshape(b, h, t, hd).transpose(1, 2)
    want = torch.autograd.grad((o2 ** 2).sum() + s2.sum(), args)
    for g, w_ in zip(got, want):
        _close(g, w_, GRAD_TOL)

    with pytest.raises(ValueError, match="state_out"):
        wkv_ops.wkv(*args, state_out=torch.empty(b, h, hd, hd))
    with torch.no_grad():    # the serving path stays as it was
        st = torch.empty(b, h, hd, hd)
        _, back = wkv_ops.wkv(*args, state_out=st)
        assert back is st and torch.equal(st, s_t0)


def test_wkv_backward_meta_rule():
    """On ``meta`` the backward reports ``wkv_bwd``: 14 hd^2 FLOPs a token
    and head (3 to restore the state, 11 for the reverse pass with the
    ``u kv`` part of ``a`` taken as O(hd) terms; an FMA counts two, as the
    forward's 7); bytes for the operands, the
    chunk-boundary states and ``dout`` read once and the gradients, ``du``
    and ``ds0`` written once (the kernel keeps its restored states on chip,
    so they move no bytes); and gradients of the inputs' shapes."""
    b, t, h, hd = 2, 300, 3, 16
    args = [torch.empty(b, t, h, hd, device="meta", requires_grad=True)
            for _ in range(4)]
    u = torch.empty(h, hd, device="meta", requires_grad=True)
    s0 = torch.empty(b, h, hd, hd, device="meta")
    tally = runtime.WorkTally()
    with runtime.tally_work(tally):
        out, s_t = wkv_ops.wkv(*args, u, s0)
        grads = torch.autograd.grad(out.sum(), [*args, u])
    assert tally.by_kernel["wkv"].calls == 1
    assert tally.by_kernel["wkv_bwd"].calls == 1
    assert tally.by_kernel["wkv_bwd"].flops == 14 * b * t * h * hd * hd
    nc = -(-t // wkv_ops.CHUNK)
    # read: r k v w dout, u, the boundaries, dS_T (autograd's zeros for
    # the unused S_T); written: the four gradients, du, ds0
    assert tally.by_kernel["wkv_bwd"].bytes == 4 * (
        5 * b * t * h * hd + h * hd + nc * b * h * hd * hd + b * h * hd * hd
        + 4 * b * t * h * hd + h * hd + b * h * hd * hd)
    assert [tuple(g.shape) for g in grads] == [(b, t, h, hd)] * 4 + [(h, hd)]


def _flat(tree, path=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, path + (k,)))
        else:
            out[path + (k,)] = v
    return out


def _jax_flat(tree):
    import jax
    return {tuple(p.key for p in path): np.asarray(g) for path, g in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("seq", [1, 9])
def test_time_mix_gradient_matches_jax_grad(ref, seq):  # noqa: F811
    """One layer's time mix from no state, float32: the gradient of
    ``sum(out * g)`` with respect to the input and every leaf of the
    layer (``bonus``, ``lora_B_*`` and ``decay_base`` included) within
    ``MODEL_TOL`` of ``jax.grad``'s. ``rwkv_chunk`` 4 makes the 9-token
    case three chunks, the last one short."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    jcfg, cfg = _cfgs(ref)
    jcfg = dataclasses.replace(jcfg, rwkv_chunk=4)
    cfg = dataclasses.replace(cfg, rwkv_chunk=4)
    jp, tp = _params(ref, jcfg)
    jblk = jax.tree.map(lambda a: a[0], jp["groups"]["b0"]["rwkv"])
    tblk = {k: v[0].detach().clone().requires_grad_(True)
            for k, v in tp["groups"]["b0"]["rwkv"].items()}
    rng = np.random.default_rng(seq)
    x = rng.normal(size=(2, seq, cfg.d_model)).astype(np.float32)
    g = rng.normal(size=(2, seq, cfg.d_model)).astype(np.float32)

    def jloss(p, x):
        y, _, _ = ref["rwkv"].time_mix(x, p, jcfg, None, state=None)
        return jnp.sum(y * g)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jblk, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    y, _, _ = TR.time_mix(tx, tblk, cfg, None, state=None)
    (y * torch.from_numpy(g)).sum().backward()
    _close(tx.grad, np.asarray(jgx), MODEL_TOL)
    for name, want in jgp.items():
        got = tblk[name].grad
        if not np.abs(np.asarray(want)).max():
            assert got is None or not got.abs().max(), name
            continue
        _close(got, np.asarray(want), MODEL_TOL)
    # at T = 1 the decay only reaches the final state, not the output
    decay = ("lora_B_w", "decay_base") if seq > 1 else ()
    for name in ("bonus", "lora_B_r") + decay:
        assert tblk[name].grad.abs().max() > 0, name


def test_loss_fn_gradient_matches_jax_grad(ref):  # noqa: F811
    """rwkv6-3b reduced, float32, no ACU: every parameter's gradient of
    ``loss_fn`` within ``MODEL_TOL`` of ``jax.grad``'s, nonzero and finite
    for every rwkv leaf."""
    import jax
    import jax.numpy as jnp
    jcfg, cfg = _cfgs(ref)
    jp, tp = _params(ref, jcfg)
    rng = np.random.default_rng(3)
    toks = rng.integers(1, cfg.vocab_size, (2, 13)).astype(np.int32)
    labels = rng.integers(1, cfg.vocab_size, (2, 13)).astype(np.int32)
    want = _jax_flat(jax.jit(jax.grad(functools.partial(
        ref["trans"].loss_fn, cfg=jcfg)))(jp, jnp.asarray(toks),
                                          jnp.asarray(labels)))
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in _flat(tp).items()}
    tree = {}
    for path, leaf in leaves.items():
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = leaf
    loss_fn(tree, torch.from_numpy(toks).long(),
            torch.from_numpy(labels).long(), cfg).backward()
    assert set(want) == set(leaves)
    for key, g in want.items():
        got = leaves[key].grad
        assert got is not None, key
        _close(got, g, MODEL_TOL)
        if "rwkv" in key:
            assert torch.isfinite(got).all() and got.abs().max() > 0, key


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU has only the plain version")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("t,chunk", [(1, 256), (255, 256), (256, 256),
                                     (300, 256), (37, 8)])
def test_cuda_wkv_bwd_matches_plain_version(cuda, t, chunk):
    """The CUDA backward against ``wkv_bwd_ref`` on the same saved
    boundaries, and its ``du`` the same bits in two runs; at the reduced
    configs' chunk of 8 too (not a multiple of the sequence kernel's
    16-step tile)."""
    rng = np.random.default_rng(t)
    b, h, hd = 2, 4, 64
    r, k, v = (rng.normal(size=(b, t, h, hd)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.05, 0.95, (b, t, h, hd)).astype(np.float32)
    u = rng.normal(size=(h, hd)).astype(np.float32)
    s0 = rng.normal(size=(b, h, hd, hd)).astype(np.float32)
    dout = rng.normal(size=(b, t, h, hd)).astype(np.float32)
    cpu = _t(r, k, v, w, u, s0)
    dev = [a.to(cuda) for a in cpu]
    _, _, bounds = wkv_ops._forward(*dev, None, chunk)
    n0 = wkv_ops.wkv_bwd.launches
    states = torch.empty((b * h, t, hd, hd), device=cuda)
    got = wkv_ops.wkv_bwd(*dev[:5], bounds, torch.from_numpy(dout).to(cuda),
                          None, chunk, states_out=states)
    again = wkv_ops.wkv_bwd(*dev[:5], bounds,
                            torch.from_numpy(dout).to(cuda), None, chunk)
    assert wkv_ops.wkv_bwd.launches == n0 + 2
    assert torch.equal(got[4], again[4])
    # every state the kernel restores is the forward's, bit for bit
    fold = lambda a: a.transpose(1, 2).reshape(b * h, t, hd)  # noqa: E731
    s, (fk, fv, fw) = cpu[5].reshape(b * h, hd, hd), map(fold, cpu[1:4])
    for step in range(t):
        assert torch.equal(states[:, step].cpu(), s), step
        s = fw[:, step, :, None] * s + fk[:, step, :, None] \
            * fv[:, step, None, :]
    want = wkv_ops.wkv_bwd(*cpu[:5], bounds.cpu(), torch.from_numpy(dout),
                           None, chunk)
    for g, w_ in zip(got, want):
        _close(g.cpu(), w_, CUDA_TOL)

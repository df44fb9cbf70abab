"""Optimizers (port of ``repro.optim.adamw``): AdamW and SGD, global-norm
clipping and the cosine schedule, over the port's parameter trees: nested
dicts of tensors (an LM's ``{"embed", "groups": {"b0": {"attn": ...}}}``)
or flat ones, leaves in the reference's order (:mod:`repro_torch.tree`:
dict keys sorted at every level), which keeps ``global_norm``'s float32 sum
in the reference's order.

State is float32 whatever the parameter dtype. The update arithmetic runs
in the reference's order, one rounding per operation as written there:
``b1*m + (1-b1)*g``, the bias corrections ``1 - b1**step``,
``(m/bc1) / (sqrt(v/bc2) + eps)``, clipping by ``min(1, clip/(gn +
1e-9))``, ``p - lr*u``. Every divisor is a float32 tensor on the operand's
device: PyTorch on CUDA turns a divide by a Python scalar into a multiply
by its reciprocal, and ``scalar / tensor`` into ``reciprocal(tensor) *
scalar``.

``update`` works in place: it writes the new moments into the state's
tensors and the new values into the parameter tensors it is given, and
returns them (the reference's jitted step donates the same buffers). A
training step so never holds a second copy of the parameters or the
state.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.kernels.runtime import resolve_device
from repro_torch.tree import leaves, tree_map


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def global_norm(tree) -> torch.Tensor:
    """``sqrt(sum_leaves sum(g^2))``, leaves in the reference's order."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in leaves(tree)))


def _clipped(grads, clip_norm: Optional[float]) -> list:
    """The gradients' leaves in float32, clipped to ``clip_norm``."""
    grads = [g.to(torch.float32) for g in leaves(grads)]
    if clip_norm is None:
        return grads
    gn = global_norm(grads)
    scale = torch.clamp_max(torch.div(_f32(clip_norm, gn),
                                      gn + _f32(1e-9, gn)), 1.0)
    return [g * scale for g in grads]


def _lr(lr, step: torch.Tensor) -> torch.Tensor:
    return lr(step) if callable(lr) else _f32(lr, step)


def _zeros_f32(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=leaves(params)[0].device)


def _matched(grads: list, params) -> list:
    ps = leaves(params)
    if len(ps) != len(grads):
        raise ValueError(f"{len(grads)} gradients for {len(ps)} parameters")
    return ps


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32 scalar
    mu: dict
    nu: dict


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: Optional[float] = 1.0

    def init(self, params) -> AdamWState:
        zeros = _zeros_f32(params)
        return AdamWState(step=_step0(params), mu=zeros,
                          nu=tree_map(torch.clone, zeros))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        grads = _clipped(grads, self.clip_norm)
        ps = _matched(grads, params)
        mu, nu = leaves(state.mu), leaves(state.nu)
        step = state.step + 1
        b1, b2 = self.b1, self.b2
        for m, v, g in zip(mu, nu, grads):
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
        stepf = step.to(torch.float32)
        bc1 = 1 - torch.pow(_f32(b1, stepf), stepf)
        bc2 = 1 - torch.pow(_f32(b2, stepf), stepf)
        lr = _lr(self.lr, step)
        for p, m, v in zip(ps, mu, nu):
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p.to(torch.float32)
            p.copy_(p.to(torch.float32) - lr * u)
        return params, AdamWState(step=step, mu=state.mu, nu=state.nu)


class SGDState(NamedTuple):
    step: torch.Tensor      # int32 scalar
    momentum: dict


@dataclasses.dataclass(frozen=True)
class SGD:
    """Paper §5.1 retrains with SGD, lr 1e-4."""

    lr: Callable | float = 1e-4
    momentum: float = 0.0
    clip_norm: Optional[float] = None

    def init(self, params) -> SGDState:
        return SGDState(step=_step0(params), momentum=_zeros_f32(params))

    @torch.no_grad()
    def update(self, grads, state: SGDState, params):
        grads = _clipped(grads, self.clip_norm)
        ps = _matched(grads, params)
        step = state.step + 1
        lr = _lr(self.lr, step)
        m = grads
        if self.momentum:
            m = leaves(state.momentum)
            for mm, g in zip(m, grads):
                mm.mul_(self.momentum).add_(g)
        for p, g in zip(ps, m):
            p.copy_(p.to(torch.float32) - lr * g)
        return params, SGDState(step=step, momentum=state.momentum)


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1):
    """Linear warmup to ``base_lr``, then cosine decay to ``min_frac *
    base_lr`` at ``total``; ``lr(step)`` takes and returns tensors."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = torch.div(base_lr * step, _f32(max(warmup, 1), step))
        prog = torch.clamp(torch.div(step - warmup,
                                     _f32(max(total - warmup, 1), step)),
                           0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5 *
                         (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return lr


def load_jax_state(state, device=None) -> SGDState | AdamWState:
    """The reference's optimizer state (an ``SGDState`` / ``AdamWState``
    NamedTuple of numpy arrays, e.g. ``jax.tree.map(np.asarray, st)``) as
    the port's, float32 on ``device`` (``cuda`` unless given)."""
    dev = resolve_device(device)
    fields = state._asdict()
    step = torch.tensor(int(np.asarray(fields["step"])), dtype=torch.int32,
                        device=dev)

    def tensors(tree):
        return tree_map(lambda v: torch.from_numpy(
            np.array(v, dtype=np.float32)).to(dev), tree)

    if "momentum" in fields:
        return SGDState(step=step, momentum=tensors(fields["momentum"]))
    return AdamWState(step=step, mu=tensors(fields["mu"]),
                      nu=tensors(fields["nu"]))

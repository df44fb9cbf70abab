"""Training loop, single device (port of ``repro.train.trainer``).

``Trainer.fit`` drives ``(params, opt_state)`` through a loss function:
per step it draws a batch, takes the loss and the gradients of the
parameters (``loss.backward()`` on leaf tensors in place of
``jax.value_and_grad``), optionally accumulated over microbatches with a
float32 loss accumulator, and applies the optimizer (which updates in
place, see :mod:`repro_torch.optim.adamw`). It keeps the reference's
``history`` records, ``log_every``, the straggler watchdog, ``step_hook``,
``fail_hook`` and the consumed-batch count.

With approximate layers (``ApproxConfig``) the same loop retrains through
the approximate forward and the STE backward, exact or approximate as the
config says. Checkpointing and failure recovery (``ckpt_dir``), gradient-
noise batch damping (``damping``) and data parallelism (``mesh``) are not
ported: asking for one raises ``NotImplementedError`` naming its ROADMAP
item, so a step failure simply propagates, as in the reference without a
checkpoint directory.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator, Optional

import torch

from repro_torch.core.acu import not_ported
from repro_torch.optim.adamw import SGD, AdamW


@dataclasses.dataclass
class TrainerConfig:
    microbatch: int = 0          # 0 = no accumulation (fixed split of a batch)
    step_timeout_s: Optional[float] = None   # watchdog (logged, not killed)
    log_every: int = 10
    ckpt_dir: Optional[str] = None           # not ported (item 13)
    damping: Optional[object] = None         # not ported (item 13)
    mesh: Optional[object] = None            # not ported (item 16)


class Trainer:
    """Drives (params, opt_state) through ``loss_fn(params, batch) ->
    scalar tensor`` with ``optimizer``. ``params`` is a dict of float
    tensors; ``batch`` is whatever the iterator yields (a dict of arrays
    with a leading batch dimension when ``microbatch`` splits it)."""

    def __init__(self, loss_fn: Callable, optimizer: AdamW | SGD,
                 cfg: Optional[TrainerConfig] = None):
        cfg = TrainerConfig() if cfg is None else cfg
        if cfg.ckpt_dir is not None:
            raise not_ported("checkpointing and failure recovery "
                             "(TrainerConfig.ckpt_dir)", "queue 1, item 13")
        if cfg.damping is not None:
            raise not_ported("gradient-noise batch damping "
                             "(TrainerConfig.damping)", "queue 1, item 13")
        if cfg.mesh is not None:
            raise not_ported("the data-parallel step (TrainerConfig.mesh)",
                             "queue 1, item 16")
        self.loss_fn = loss_fn
        self.opt = optimizer
        self.cfg = cfg
        self.history: list[dict] = []
        self.consumed = 0

    def _grads(self, params: dict, batch, n_micro: int):
        """Loss (float32) and the mean gradients over ``n_micro``
        microbatches; ``batch`` leaves are ``(n_micro, b, ...)`` when
        ``n_micro > 1``. Gradients sum in ``.grad`` across the backward
        passes, microbatch by microbatch, as the reference's scan adds
        them."""
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in params.items()}
        loss = None
        for i in range(n_micro):
            mb = batch if n_micro == 1 else {k: v[i] for k, v in batch.items()}
            li = self.loss_fn(leaves, mb)
            li.backward()
            li = li.detach().to(torch.float32)
            loss = li if loss is None else loss + li
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in leaves.items()}
        if n_micro > 1:
            # a tensor divisor: CUDA turns a divide by a Python number into
            # a reciprocal multiply, which rounds differently
            nm = torch.tensor(float(n_micro), device=loss.device)
            loss = loss / nm
            grads = {k: g / nm.to(g.device) for k, g in grads.items()}
        return loss, grads

    def fit(self, params: dict, opt_state, batches: Iterator, n_steps: int,
            *, fail_hook: Optional[Callable[[int], None]] = None,
            step_hook: Optional[Callable] = None):
        """Run ``n_steps`` optimizer steps; returns ``(params,
        opt_state)``. ``fail_hook(step)`` runs before each step (failure
        injection); ``step_hook(step, params, consumed)`` after it."""
        c = self.cfg
        it = iter(batches)
        k = c.microbatch if c.microbatch and c.microbatch > 1 else 1
        consumed = 0
        for step in range(n_steps):
            batch = next(it)
            consumed += 1
            if k > 1:
                batch = _split_micro(batch, k)
            t0 = time.monotonic()
            if fail_hook is not None:
                fail_hook(step)
            loss, grads = self._grads(params, batch, k)
            params, opt_state = self.opt.update(grads, opt_state, params)
            loss = float(loss)
            dt = time.monotonic() - t0
            done = step + 1
            if step_hook is not None:
                step_hook(done, params, consumed)
            if c.step_timeout_s and dt > c.step_timeout_s:
                self.history.append(
                    {"step": done, "event": f"straggler: {dt:.1f}s"})
            if done % c.log_every == 0 or done == n_steps:
                self.history.append({"step": done, "loss": loss, "dt": dt,
                                     "consumed": consumed})
        self.consumed = consumed
        return params, opt_state


def _split_micro(batch: dict, k: int) -> dict:
    """Reshape a flat batch into ``k`` stacked microbatches, validating
    divisibility loudly (a silent ``reshape(k, -1, ...)`` would accept, and
    misassemble, a batch ``k`` does not divide)."""
    def one(x):
        if x.shape[0] % k != 0:
            raise ValueError(
                f"microbatch={k} does not divide batch dim {x.shape[0]} "
                f"(leaf shape {tuple(x.shape)}); pick a divisor of the "
                f"batch size")
        return x.reshape(k, x.shape[0] // k, *x.shape[1:])
    return {name: one(x) for name, x in batch.items()}

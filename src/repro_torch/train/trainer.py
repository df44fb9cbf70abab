"""Fault-tolerant training loop (port of ``repro.train.trainer``).

``Trainer.fit`` drives ``(params, opt_state)`` through ``loss_fn(params,
batch) -> scalar tensor``. ``params`` is a tree of tensors (nested dicts,
as an LM's, or a flat dict); the optimizer updates it in place
(:mod:`repro_torch.optim.adamw`). Per step:

* gradient accumulation: each microbatch's gradient is taken on its own
  (``torch.autograd.grad``) and summed, in order, into float32
  accumulators that start at zero, as the reference's ``lax.scan`` carry
  does; bfloat16 parameters so never sum their gradients in bfloat16;
* gradient-noise batch damping (``damping``, :mod:`repro_torch.optim.
  damping`): each step folds ``accum`` whole data batches, and the sum of
  the microbatches' |g|^2 beside |mean|^2 feeds the schedule;
* checkpoints (``ckpt_dir``, :mod:`repro_torch.train.checkpoint`), async
  by default, and automatic restore-and-continue when a step raises (the
  node-failure surface). Resume is deterministic: the manifest records the
  consumed-batch count and the damping state; after an in-process failure
  every parameter and state leaf is overwritten in place from the last
  durable checkpoint and the batches drawn since it replay from a bounded
  buffer; a fresh restart fast-forwards its iterator. A resumed run so
  ends bitwise equal to the run that never failed;
* the straggler watchdog, ``step_hook`` and ``fail_hook``.

With approximate layers (``ApproxConfig``) the same loop retrains through
the approximate forward and the STE backward.

Data parallelism (``TrainerConfig(mesh=RankMesh, dp_axes=...)``): every
rank runs ``fit`` with the same global batches; the step cuts this rank's
rows by its ``dp_axes`` coordinate (the reference's ``P(ax)`` in-spec),
takes their gradients, all-reduces them through the int8 error-feedback
``compressed_psum`` (int32 code sums: the mean is the same bits in any
reduction order) and updates the replicated parameters with the mean. The
loss is averaged over the ranks, the per-rank damping scalars are gathered
and folded on the host in rank order in float64, and ``gsq_big`` is taken
on the replicated mean. Each rank's EF residual rides in the checkpoint
as the reference's third tree, stacked over the ranks; rank 0 writes the
checkpoint and every rank reads it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.optim import compression as compression_lib
from repro_torch.optim import damping as damping_lib
from repro_torch.optim.adamw import SGD, AdamW
from repro_torch.parallel.sharding import rank_mesh
from repro_torch.train import checkpoint as ckpt_lib


@dataclasses.dataclass
class TrainerConfig:
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep: int = 3
    microbatch: int = 0          # 0 = no accumulation (fixed split of a batch)
    max_failures: int = 3
    step_timeout_s: Optional[float] = None   # watchdog (logged, not killed)
    log_every: int = 10
    async_ckpt: bool = True
    # gradient-noise batch damping: each optimizer step consumes ``accum``
    # whole data batches; mutually exclusive with a fixed ``microbatch``
    damping: Optional[damping_lib.DampingConfig] = None
    # data parallelism over ``dp_axes`` of a mesh of ranks
    # (launch/mesh.py: RankMesh, or a MeshContext over one; the trainer
    # keeps the RankMesh), gradients all-reduced by the int8
    # error-feedback compressed_psum
    mesh: Optional[object] = None
    dp_axes: tuple[str, ...] = ("data",)


class Trainer:
    """Drives (params, opt_state) through a loss function with recovery."""

    def __init__(self, loss_fn: Callable, optimizer: AdamW | SGD,
                 cfg: Optional[TrainerConfig] = None):
        cfg = TrainerConfig() if cfg is None else cfg
        self._dp_workers = 1
        self._ef_resid = None         # this rank's EF residual (data-parallel)
        if cfg.mesh is not None:
            cfg = dataclasses.replace(
                cfg, mesh=rank_mesh(cfg.mesh, "the data-parallel step"))
            missing = [a for a in cfg.dp_axes if a not in cfg.mesh.shape]
            if missing or not cfg.dp_axes:
                raise ValueError(f"dp_axes {cfg.dp_axes} are not axes of "
                                 f"the mesh {cfg.mesh.shape}")
            self._dp_workers = cfg.mesh.group_size(cfg.dp_axes)
        if cfg.damping is not None and cfg.microbatch > 1:
            raise ValueError("damping drives the accumulation factor itself; "
                             "set microbatch=0 when damping is enabled")
        self.loss_fn = loss_fn
        self.opt = optimizer
        self.cfg = cfg
        self.saver = ckpt_lib.AsyncSaver()
        self.history: list[dict] = []
        self.consumed = 0
        self.damp_state = None

    # ------------------------------------------------------------------
    # one step
    # ------------------------------------------------------------------

    def _grads_and_stats(self, params, batch, n_micro: int):
        """Loss (float32), mean gradients and the sum of per-microbatch
        |g|^2 (None unless damping wants it). ``batch`` leaves are
        ``(n_micro, b, ...)`` when ``n_micro > 1``."""
        want_sq = self.cfg.damping is not None
        live = [p.detach().requires_grad_(True) for p in T.leaves(params)]
        ptree = T.unflatten(params, live)

        def grads_of(mb):
            loss = self.loss_fn(ptree, mb)
            gs = torch.autograd.grad(loss, live, allow_unused=True)
            return loss.detach().to(torch.float32), [
                torch.zeros_like(p) if g is None else g
                for p, g in zip(live, gs)]

        if n_micro == 1:
            loss, grads = grads_of(batch)
            sq = damping_lib.tree_sqnorm(grads) if want_sq else None
            return loss, T.unflatten(params, grads), sq
        dev = live[0].device
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        sq = torch.zeros((), dtype=torch.float32, device=dev)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in live]
        for i in range(n_micro):
            li, gs = grads_of(T.tree_map(lambda v: v[i], batch))
            loss = loss + li
            for a, g in zip(acc, gs):
                a.add_(g)
            if want_sq:
                sq = sq + damping_lib.tree_sqnorm(gs)
            del gs
        # a tensor divisor: CUDA turns a divide by a Python number into a
        # reciprocal multiply, which rounds differently
        nm = torch.tensor(float(n_micro), device=dev)
        for a in acc:
            a.div_(nm)
        return loss / nm, T.unflatten(params, acc), sq if want_sq else None

    def _run_step(self, params, opt_state, batch, n_micro: int):
        if self.cfg.mesh is not None:
            return self._run_dp_step(params, opt_state, batch, n_micro)
        loss, grads, micro_sqsum = self._grads_and_stats(params, batch,
                                                         n_micro)
        stats = None
        if micro_sqsum is not None:
            stats = {"micro_sqsum": micro_sqsum,
                     "gsq_big": damping_lib.tree_sqnorm(grads)}
        params, opt_state = self.opt.update(grads, opt_state, params)
        return params, opt_state, loss, stats

    # ------------------------------------------------------------------
    # the data-parallel step
    # ------------------------------------------------------------------

    def _local_rows(self, batch, n_micro: int):
        """This rank's rows of the global batch: the leading dim (dim 1 of
        stacked microbatches) cut by the rank's ``dp_axes`` coordinate."""
        mesh, w = self.cfg.mesh, self._dp_workers
        idx = mesh.axis_index(self.cfg.dp_axes)
        dim = 1 if n_micro > 1 else 0

        def cut(x):
            if x.shape[dim] % w:
                raise ValueError(f"{w} data-parallel ranks do not divide "
                                 f"batch dim {x.shape[dim]} (leaf shape "
                                 f"{tuple(x.shape)})")
            rows = x.shape[dim] // w
            return x.narrow(dim, idx * rows, rows)
        return T.tree_map(cut, batch)

    def _run_dp_step(self, params, opt_state, batch, n_micro: int):
        mesh, axes, w = self.cfg.mesh, self.cfg.dp_axes, self._dp_workers
        if self._ef_resid is None:
            self._ef_resid = self._init_ef(params)
        loss, grads, _ = self._grads_and_stats(
            params, self._local_rows(batch, n_micro), n_micro)
        mean, ef = compression_lib.compressed_psum(
            grads, compression_lib.EFState(residual=self._ef_resid), axes,
            mesh=mesh)
        self._ef_resid = ef.residual
        nw = torch.tensor(float(w), dtype=torch.float32, device=loss.device)
        loss = mesh.all_gather(loss.reshape(1), axes).sum() / nw
        # per-rank scalars, gathered to the host in rank order (folded in
        # float64 by _damping_update); |mean|^2 on the replicated mean
        local = mesh.all_gather(torch.stack([
            damping_lib.tree_sqnorm(grads),
            damping_lib.tree_sqnorm(ef.residual)]).reshape(1, 2),
            axes).tolist()
        stats = {"local_sq": [a for a, _ in local],
                 "resid_sq": [b for _, b in local],
                 "gsq_big": damping_lib.tree_sqnorm(mean)}
        params, opt_state = self.opt.update(mean, opt_state, params)
        return params, opt_state, loss, stats

    def _init_ef(self, params):
        return T.tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)

    def _writer(self) -> bool:
        """Whether this process writes checkpoints (rank 0 of a mesh)."""
        return self.cfg.mesh is None or self.cfg.mesh.rank == 0

    def _ckpt_tree(self, params, opt_state):
        """What a checkpoint holds: ``(params, opt_state)``, and on a mesh
        the EF residual of every data-parallel rank stacked on a leading
        axis, the reference's third tree (its ``keystr`` names ``[2]...``).
        Collective: every rank calls it."""
        if self.cfg.mesh is None:
            return (params, opt_state)
        if self._ef_resid is None:
            self._ef_resid = self._init_ef(params)
        mesh, axes = self.cfg.mesh, self.cfg.dp_axes
        stacked = T.tree_map(lambda r: mesh.all_gather(r[None], axes, 0),
                             self._ef_resid)
        return (params, opt_state, stacked)

    # ------------------------------------------------------------------
    # checkpoint state
    # ------------------------------------------------------------------

    def _restore_into(self, step: int, params, opt_state) -> dict:
        """Overwrites every leaf of ``(params, opt_state)`` in place from
        checkpoint ``step`` (on a mesh, this rank's EF residual too);
        returns its manifest."""
        live = (params, opt_state)
        like = live
        if self.cfg.mesh is not None:
            w = self._dp_workers
            like = live + (T.tree_map(lambda p: torch.zeros(
                (w,) + tuple(p.shape), dtype=torch.float32,
                device=p.device), params),)
        tree, man = ckpt_lib.restore(self.cfg.ckpt_dir, step, like)
        with torch.no_grad():
            for dst, src in zip(T.leaves(live), T.leaves(tree[:2])):
                dst.copy_(src)
        if self.cfg.mesh is not None:
            idx = self.cfg.mesh.axis_index(self.cfg.dp_axes)
            self._ef_resid = T.tree_map(lambda r: r[idx].clone(), tree[2])
        return man

    def restore_or_init(self, params, opt_state):
        """Returns ``(params, opt_state, start_step, manifest_extra)``: the
        newest checkpoint in ``ckpt_dir`` written into ``params`` and
        ``opt_state`` in place, or both as given; the extra dict carries
        the consumed-batch count and the damping state."""
        c = self.cfg
        if c.ckpt_dir:
            step = ckpt_lib.latest_step(c.ckpt_dir)
            if step is not None:
                man = self._restore_into(step, params, opt_state)
                return params, opt_state, man["step"], man.get("extra", {})
        return params, opt_state, 0, {}

    # ------------------------------------------------------------------

    def fit(self, params, opt_state, batches: Iterator, n_steps: int,
            *, fail_hook: Optional[Callable[[int], None]] = None,
            step_hook: Optional[Callable] = None):
        """Run to optimizer step ``n_steps``; on step failure restore the
        last checkpoint and continue (up to ``cfg.max_failures``),
        replaying the rolled-back batches. Returns ``(params, opt_state)``.
        ``fail_hook(step)`` runs before each step (failure injection);
        ``step_hook(step, params, consumed)`` after it."""
        c = self.cfg
        if c.mesh is not None and self._ef_resid is None:
            self._ef_resid = self._init_ef(params)
        params, opt_state, start, extra = self.restore_or_init(
            params, opt_state)
        step = start
        consumed = int(extra.get("consumed", 0))
        damp = None
        if c.damping is not None:
            damp = (damping_lib.DampingState.from_dict(extra["damping"])
                    if extra.get("damping") else
                    damping_lib.init_state(c.damping))

        it = iter(batches)
        for _ in range(consumed):     # fresh-restart fast-forward: skip
            next(it)                  # batches the checkpoint trained on
        replay_buf: list[tuple[int, object]] = []   # since last durable ckpt
        replay_pending: list[tuple[int, object]] = []
        saved_consumed: dict[int, int] = {}         # ckpt step -> consumed
        if c.ckpt_dir and start > 0:
            saved_consumed[start] = consumed

        def draw():
            nonlocal consumed
            if replay_pending:
                idx, b = replay_pending.pop(0)
                assert idx == consumed, (idx, consumed)
            else:
                b = next(it)
                if c.ckpt_dir:   # no ckpt -> no rollback -> no replay need
                    replay_buf.append((consumed, b))
            consumed += 1
            return b

        def trim_replay():
            durable = (self.saver.last_saved_step
                       if c.async_ckpt and self._writer()
                       else max(saved_consumed, default=None))
            if durable is None or durable not in saved_consumed:
                return
            keep_from = saved_consumed[durable]
            while replay_buf and replay_buf[0][0] < keep_from:
                replay_buf.pop(0)

        failures = 0
        while step < n_steps:
            n_micro, batch, batch_rows = self._next_batch(draw, damp)
            t0 = time.monotonic()
            try:
                if fail_hook is not None:
                    fail_hook(step)  # failure injection point
                params, opt_state, loss, stats = self._run_step(
                    params, opt_state, batch, n_micro)
                loss = float(loss)
            except Exception as e:  # noqa: BLE001 — node-failure surface
                failures += 1
                if failures > c.max_failures or not c.ckpt_dir:
                    raise
                self.saver.wait()   # in-flight snapshot becomes durable
                if c.mesh is not None:
                    c.mesh.barrier()    # ... before any rank looks
                restored = ckpt_lib.latest_step(c.ckpt_dir)
                if restored is None:
                    raise RuntimeError(
                        "failure before first checkpoint") from e
                man = self._restore_into(restored, params, opt_state)
                step = man["step"]
                extra = man.get("extra", {})
                back_to = int(extra.get("consumed", 0))
                if damp is not None:
                    damp = (damping_lib.DampingState.from_dict(
                        extra["damping"]) if extra.get("damping") else
                        damping_lib.init_state(c.damping))
                # every batch drawn after the checkpoint replays, in draw
                # order (replay_buf is append-ordered and never re-appends
                # a replayed batch, so this filter is exact)
                replay_pending = [(i, b) for i, b in replay_buf
                                  if i >= back_to]
                consumed = back_to
                self.history.append(
                    {"step": step,
                     "event": f"restored after {type(e).__name__}"})
                continue
            dt = time.monotonic() - t0
            step += 1
            if step_hook is not None:   # eval/curve hook (benchmarks)
                step_hook(step, params, consumed)
            if damp is not None and step % c.damping.check_every == 0:
                damp = self._damping_update(damp, stats, n_micro, batch_rows)
            if c.step_timeout_s and dt > c.step_timeout_s:
                self.history.append(
                    {"step": step, "event": f"straggler: {dt:.1f}s"})
            if step % c.log_every == 0 or step == n_steps:
                h = {"step": step, "loss": loss, "dt": dt,
                     "consumed": consumed}
                if damp is not None:
                    h.update(accum=damp.accum, b_noise=damp.b_noise)
                self.history.append(h)
            if c.ckpt_dir and (step % c.ckpt_every == 0 or step == n_steps):
                extra_out = {"consumed": consumed}
                if damp is not None:
                    extra_out["damping"] = damp.to_dict()
                saved_consumed[step] = consumed
                tree = self._ckpt_tree(params, opt_state)
                if not self._writer():
                    pass
                elif c.async_ckpt:
                    self.saver.submit(c.ckpt_dir, step, tree,
                                      extra=extra_out, keep=c.keep)
                else:
                    ckpt_lib.save(c.ckpt_dir, step, tree,
                                  extra=extra_out, keep=c.keep)
                trim_replay()
        self.saver.wait()
        if c.mesh is not None:
            c.mesh.barrier()        # rank 0's last checkpoint is durable
        self.consumed = consumed
        self.damp_state = damp
        return params, opt_state

    # ------------------------------------------------------------------
    # batch shaping + damping plumbing
    # ------------------------------------------------------------------

    def _next_batch(self, draw, damp):
        """Draw and shape the next step's input: ``(n_micro, batch,
        batch_rows)``, ``batch_rows`` the rows of ONE drawn data batch (the
        unit the damping schedule multiplies by ``accum``; None without
        damping)."""
        c = self.cfg
        if damp is None:
            batch = draw()
            k = c.microbatch if c.microbatch and c.microbatch > 1 else 1
            if k > 1:
                batch = _split_micro(batch, k)
            return k, batch, None
        if damp.accum == 1:
            batch = draw()
            rows = _leading_rows(batch)
            if rows % 2 == 0:   # free noise pair: split the batch in two
                return 2, _split_micro(batch, 2), rows
            return 1, batch, rows
        drawn = [draw() for _ in range(damp.accum)]
        rows = _leading_rows(drawn[0])
        return damp.accum, T.tree_map(lambda *xs: _stack(xs), *drawn), rows

    def _damping_update(self, damp, stats, n_micro, batch_rows):
        total = batch_rows * (damp.accum if damp.accum > 1 else 1)
        if self.cfg.mesh is not None:
            # the mesh pair: each rank's gradient against the all-reduced
            # mean, the per-rank scalars folded in rank order in float64
            w = self._dp_workers
            if total % w != 0 or total // w == total:
                return damp
            st = damping_lib.NoiseStats(
                gsq_small=float(np.asarray(stats["local_sq"],
                                           np.float64).sum() / w),
                gsq_big=float(stats["gsq_big"]),
                b_small=total // w, b_big=total,
                resid_sq=float(np.asarray(stats["resid_sq"],
                                          np.float64).sum() / w))
            return damping_lib.update_state(damp, self.cfg.damping, st,
                                            batch_rows)
        if n_micro < 2:
            return damp    # no pair this step (odd batch at accum=1)
        st = damping_lib.NoiseStats(
            gsq_small=float(stats["micro_sqsum"]) / n_micro,
            gsq_big=float(stats["gsq_big"]),
            b_small=total // n_micro, b_big=total)
        return damping_lib.update_state(damp, self.cfg.damping, st,
                                        batch_rows)


def _leading_rows(batch) -> int:
    return int(T.leaves(batch)[0].shape[0])


def _stack(xs):
    if isinstance(xs[0], torch.Tensor):
        return torch.stack(xs)
    return np.stack(xs)


def _split_micro(batch, k: int):
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
    return T.tree_map(one, batch)

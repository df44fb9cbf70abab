"""Meshes (port of ``repro.launch.mesh``).

* :class:`MeshShape` describes a production mesh by its shape alone: the
  axis names and sizes that the planner, ``launch/specs.py`` and the
  dry-run read. It touches no device or process group and cannot run. The
  one H100 is the 1 x 1 host mesh.
* :class:`RankMesh` (:func:`make_host_multi_mesh`) is a mesh that runs: the
  ranks of the initialized default ``torch.distributed`` process group,
  laid out row-major over the axes, with one process group for every
  tuple of axes a sharding rule can name, and the three collectives the
  mesh runtime (``parallel/acu_shard.py``, the data-parallel trainer)
  uses: :meth:`RankMesh.psum`, :meth:`RankMesh.pmax` and
  :meth:`RankMesh.all_gather`.
* :func:`spawn_ranks` starts such a group of N processes on one host: the
  port's counterpart of the reference's
  ``--xla_force_host_platform_device_count=N``.
"""
from __future__ import annotations

import itertools
import math
import os
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence

import torch


class MeshShape:
    """A mesh by its shape alone: ``shape`` maps each axis name to its
    size, in order."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"MeshShape({self.shape})"


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape({"pod": 2, "data": 16, "model": 16})
    return MeshShape({"data": 16, "model": 16})


def make_host_mesh() -> MeshShape:
    """The one-device mesh (1 x 1, the production axis names): one H100."""
    return MeshShape({"data": 1, "model": 1})


class RankMesh:
    """The ranks of the default process group as a mesh: rank ``r`` sits at
    the row-major coordinates of ``r`` over ``shape`` (axis name -> size,
    in order). Every process group a collective can name (one per
    non-empty tuple of axes, and per coordinate of the other axes) is
    built here, in the same order on every rank, as ``new_group``
    requires. Exposes what :class:`~repro_torch.parallel.sharding.
    MeshContext` reads (``shape``, ``axis_names``, ``size``) and this
    rank's coordinate on each axis (``coords``).

    Collectives on a gloo group run on host tensors: a CUDA tensor is
    copied to the host, reduced, and copied back (gloo on one card goes
    through the host). ``collective_s`` sums the wall seconds this rank
    spent in collectives (copies included), ``collective_calls`` counts
    them."""

    def __init__(self, shape: dict):
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError("RankMesh needs an initialized default "
                               "process group (see spawn_ranks)")
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        world = dist.get_world_size()
        if world < self.size:
            raise RuntimeError(
                f"mesh {tuple(self.shape.values())} needs {self.size} ranks, "
                f"the process group has {world}; start it with "
                f"spawn_ranks(..., n={self.size})")
        if world > self.size:
            raise RuntimeError(f"mesh {tuple(self.shape.values())} has "
                               f"{self.size} places for {world} ranks")
        self.rank = dist.get_rank()
        self.backend = dist.get_backend()
        self.collective_s = 0.0
        self.collective_calls = 0
        sizes = tuple(self.shape.values())
        self._coords_of = list(itertools.product(*(range(n) for n in sizes)))
        self.coords = dict(zip(self.axis_names, self._coords_of[self.rank]))
        self._groups: dict[tuple[str, ...], tuple[object, list[int]]] = {}
        for k in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, k):
                rest = [a for a in self.axis_names if a not in axes]
                for fixed in itertools.product(
                        *(range(self.shape[a]) for a in rest)):
                    ranks = [r for r, c in enumerate(self._coords_of)
                             if all(c[self.axis_names.index(a)] == f
                                    for a, f in zip(rest, fixed))]
                    group = dist.new_group(ranks)
                    if self.rank in ranks:
                        self._groups[axes] = (group, ranks)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"RankMesh({self.shape}, rank={self.rank})"

    def _axes(self, axes: Sequence[str]) -> tuple[str, ...]:
        """``axes`` restricted to this mesh's axes, in mesh order (a rule
        may name an axis, like ``"pod"``, that the mesh lacks)."""
        want = set(axes)
        return tuple(a for a in self.axis_names if a in want)

    def axis_index(self, axes: Sequence[str]) -> int:
        """This rank's linear index along ``axes`` (row-major, in the
        order given), as the reference's ``axis_index`` fold."""
        r = 0
        for a in axes:
            if a in self.shape:
                r = r * self.shape[a] + self.coords[a]
        return r

    def group_size(self, axes: Sequence[str]) -> int:
        return math.prod(self.shape[a] for a in self._axes(axes))

    def _run(self, fn, x: torch.Tensor) -> torch.Tensor:
        """``fn`` on ``x``, staged through the host for gloo; timed."""
        t0 = time.perf_counter()
        if self.backend == "gloo" and x.device.type != "cpu":
            out = fn(x.cpu()).to(x.device)
        else:
            out = fn(x)
        self.collective_s += time.perf_counter() - t0
        self.collective_calls += 1
        return out

    def _reduce(self, x: torch.Tensor, axes, op) -> torch.Tensor:
        import torch.distributed as dist
        axes = self._axes(axes)
        if not axes:
            return x
        group, _ = self._groups[axes]

        def go(t):
            t = t.clone()
            dist.all_reduce(t, op=op, group=group)
            return t
        return self._run(go, x)

    def psum(self, x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        """The sum over the group of ``axes``; for integer tensors, the
        same bits whatever the reduction order."""
        import torch.distributed as dist
        return self._reduce(x, axes, dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        import torch.distributed as dist
        return self._reduce(x, axes, dist.ReduceOp.MAX)

    def all_gather(self, x: torch.Tensor, axes: Sequence[str],
                   dim: int = 0) -> torch.Tensor:
        """The blocks of the group of ``axes``, concatenated along ``dim``
        in the row-major order of the axes (the mesh's order)."""
        import torch.distributed as dist
        axes = self._axes(axes)
        if not axes:
            return x
        group, ranks = self._groups[axes]

        def go(t):
            t = t.contiguous()
            parts = [torch.empty_like(t) for _ in ranks]
            dist.all_gather(parts, t, group=group)
            return torch.cat(parts, dim)
        return self._run(go, x)

    def barrier(self) -> None:
        import torch.distributed as dist
        dist.barrier()


def make_host_multi_mesh(shape=(2, 4)) -> RankMesh:
    """A ``(data, model)`` mesh over the ranks of the initialized default
    process group (:func:`spawn_ranks`). Raises ``RuntimeError`` when the
    group has fewer than ``prod(shape)`` ranks, as the reference raises
    when fewer host devices exist."""
    import torch.distributed as dist
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < need:
        raise RuntimeError(
            f"host mesh {tuple(shape)} needs {need} ranks, found {have}; "
            f"start them with spawn_ranks(..., n={need})")
    return RankMesh(dict(zip(("data", "model"), shape)))


# read by the BLAS libraries when a rank imports them
_THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def _rank_main(rank: int, n: int, init_file: str, backend: str,
               device: str, threads: int, fn: Callable, args: tuple,
               out_dir: str) -> None:
    import torch.distributed as dist
    torch.set_num_threads(threads)
    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
    path = os.path.join(out_dir, f"rank{rank}")
    try:
        dist.init_process_group(backend, init_method=f"file://{init_file}",
                                world_size=n, rank=rank)
        try:
            result = fn(*args)
        finally:
            dist.destroy_process_group()
        torch.save(result, path + ".pt.tmp")
        os.replace(path + ".pt.tmp", path + ".pt")
    except BaseException:
        with open(path + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn_ranks(fn: Callable, n: int, *, args: tuple = (),
                backend: str = "gloo", device: str = "cpu",
                threads: int = 1, timeout: float = 600.0) -> list:
    """Run ``fn(*args)`` in ``n`` processes that form one process group,
    and return each rank's result, in rank order.

    The processes start with the ``spawn`` method (``fn`` must be
    importable) and meet through a ``file://`` init method in a fresh
    temporary directory, so that several groups on one host (parallel test
    workers) never collide on a port. ``backend`` and ``device`` are
    explicit: ``gloo`` on ``cpu`` is the CPU mesh of the tests; on one
    card every rank runs on ``cuda`` and the group is gloo too, because
    NCCL refuses two ranks on one device. A rank that raises makes this
    raise ``RuntimeError`` with its traceback, after every other rank has
    been stopped. Each rank runs ``threads`` host threads (PyTorch's and,
    through the environment it starts with, the BLAS libraries')."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_ranks_") as tmp:
        init_file = os.path.join(tmp, "init")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, n, init_file, backend, device, threads,
                                   fn, args, tmp))
                 for r in range(n)]
        saved = {k: os.environ.get(k) for k in _THREAD_VARS}
        os.environ.update({k: str(threads) for k in _THREAD_VARS})
        try:
            for p in procs:
                p.start()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        deadline = time.monotonic() + timeout
        failed: Optional[str] = None
        try:
            while any(p.is_alive() for p in procs):
                bad = [(r, p.exitcode) for r, p in enumerate(procs)
                       if p.exitcode not in (None, 0)]
                if bad:
                    failed = f"rank {bad[0][0]} exited with {bad[0][1]}"
                    break
                if time.monotonic() > deadline:
                    failed = f"ranks did not finish within {timeout} s"
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join()
        errs = []
        for r, p in enumerate(procs):
            err = os.path.join(tmp, f"rank{r}.err")
            if os.path.exists(err):
                with open(err) as f:
                    errs.append(f"rank {r}:\n{f.read()}")
            elif p.exitcode != 0 and failed is None:
                failed = f"rank {r} exited with {p.exitcode}"
        if errs or failed:
            raise RuntimeError("; ".join(filter(None, [failed])) + "\n"
                               + "\n".join(errs))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]

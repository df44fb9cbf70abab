"""Checkpointing (port of ``repro.train.checkpoint``): one ``.npy`` file a
leaf and a JSON manifest.

The files are the reference's: ``step_XXXXXXXX/leaf_NNNNN.npy`` in leaf
order and ``manifest.json`` holding ``step``, ``leaves`` (each leaf's
``jax.tree_util.keystr`` name, :mod:`repro_torch.tree`) and ``extra``. A
float32 or integer checkpoint written by either package reads in the
other.

* ``save`` is atomic: it writes a ``.tmp`` directory and renames it, then
  keeps the newest ``keep`` checkpoints.
* A bfloat16 leaf is written as the reference writes it: its raw 2-byte
  bits under the descr ``'<V2'`` (numpy has no bfloat16). ``restore``
  reads such a leaf back by the template leaf's dtype, bit for bit, and
  raises ``ValueError`` when that dtype is not 2 bytes wide; the
  reference's own ``restore`` cannot read it (ROADMAP fault 6).
* ``AsyncSaver`` writes on a background thread. ``submit`` copies the
  tree to the host before it returns, so the in-place optimizer cannot
  change a queued snapshot. An error in the writer is kept and re-raised
  by the next ``submit`` or ``wait``; the reference's writer dies with it
  and its ``wait`` spins (ROADMAP fault 7).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree as T

_RAW2 = "<V2"     # the reference's descr for a bfloat16 leaf


def _host(leaf, copy: bool) -> Any:
    """A leaf on the host: a CPU tensor (a copy when ``copy``) or a numpy
    array."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=copy)
    return np.array(leaf) if copy else np.asarray(leaf)


def _write_leaf(path: str, leaf) -> None:
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        bits = leaf.contiguous().view(torch.int16).numpy()
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": _RAW2, "fortran_order": False,
                    "shape": bits.shape})
            f.write(bits.astype("<i2", copy=False).tobytes())
        return
    arr = leaf.numpy() if isinstance(leaf, torch.Tensor) else leaf
    np.save(path, np.asarray(arr))


def save(ckpt_dir: str, step: int, tree, *, extra: Optional[dict] = None,
         keep: int = 3) -> str:
    """Synchronous atomic save; returns the final directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    names = []
    for i, (name, leaf) in enumerate(T.leaves_with_names(tree)):
        _write_leaf(os.path.join(tmp, f"leaf_{i:05d}.npy"),
                    _host(leaf, copy=False))
        names.append(name)
    manifest = {"step": step, "leaves": names, "extra": extra or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _retain(ckpt_dir, keep)
    return final


class AsyncSaver:
    """Single-slot background writer: a save in flight never blocks
    training; a newer snapshot supersedes a queued older one.

    The pending slot, the drainer's liveness and the writer's error share
    one lock: ``_drain`` clears ``_running`` under the lock before it
    exits, and ``submit`` and ``wait`` start a drainer whenever a snapshot
    waits without one, so no snapshot is left without a writer and
    ``wait`` never spins on a dead thread. A failed ``save`` ends the
    drainer and keeps its exception (the snapshot queued behind it stays
    queued); the next ``submit`` or ``wait`` raises it once.

    ``last_saved_step`` is the newest step whose ``save`` has completed
    (None before the first): the trainer trims its replay buffer there.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._pending: Optional[tuple] = None
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._error: Optional[BaseException] = None
        self.last_saved_step: Optional[int] = None

    def _raise_error(self) -> None:
        """Under the lock: re-raise the writer's kept error, once."""
        err, self._error = self._error, None
        if err is not None:
            raise err

    def _start(self) -> None:
        """Under the lock: a drainer for the pending snapshot."""
        if not self._running and self._pending is not None:
            self._running = True
            self._thread = threading.Thread(target=self._drain, daemon=True)
            self._thread.start()

    def submit(self, ckpt_dir: str, step: int, tree, extra=None,
               keep: int = 3):
        host_tree = T.tree_map(lambda x: _host(x, copy=True), tree)
        with self._lock:
            self._raise_error()
            self._pending = (ckpt_dir, step, host_tree, extra, keep)
            self._start()

    def _drain(self):
        while True:
            with self._lock:
                if self._pending is None or self._error is not None:
                    self._running = False
                    return
                job, self._pending = self._pending, None
            try:
                save(job[0], job[1], job[2], extra=job[3], keep=job[4])
            except BaseException as e:  # noqa: BLE001 — kept for the caller
                with self._lock:
                    self._error = e
                continue
            with self._lock:
                self.last_saved_step = job[1]

    def wait(self):
        while True:
            with self._lock:
                self._raise_error()
                t = self._thread
                if not self._running:
                    self._start()
                    t = self._thread if self._running else None
            if t is None:
                return
            t.join()


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _read_leaf(path: str, name: str, like) -> torch.Tensor:
    a = np.load(path)
    shape = tuple(like.shape)
    if a.shape != shape:
        raise ValueError(f"checkpoint leaf {name} has shape {a.shape}, the "
                         f"tree's leaf {shape}")
    if a.dtype.kind == "V":
        dtype = like.dtype if isinstance(like, torch.Tensor) else None
        if dtype is None or dtype.itemsize != a.dtype.itemsize:
            raise ValueError(
                f"checkpoint leaf {name} holds raw {a.dtype.itemsize}-byte "
                f"values (a bfloat16 leaf's bits); the tree's leaf has dtype "
                f"{getattr(like, 'dtype', type(like))}, which cannot take "
                f"them")
        t = torch.from_numpy(a.view("<i2").copy()).view(dtype)
    else:
        t = torch.from_numpy(a)
    return t.to(like.device) if isinstance(like, torch.Tensor) else t


def restore(ckpt_dir: str, step: int, tree_like):
    """Load the leaves into the structure of ``tree_like``, each a tensor
    on the template leaf's device in its saved dtype, or the template
    leaf's for a raw 2-byte leaf. Returns ``(tree, manifest)``."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    named = T.leaves_with_names(tree_like)
    if len(named) != len(manifest["leaves"]):
        raise ValueError(f"checkpoint {d} holds {len(manifest['leaves'])} "
                         f"leaves, the tree {len(named)}")
    arrs = [_read_leaf(os.path.join(d, f"leaf_{i:05d}.npy"), name, like)
            for i, (name, like) in enumerate(named)]
    return T.unflatten(tree_like, arrs), manifest


def _retain(ckpt_dir: str, keep: int):
    steps = sorted([d for d in os.listdir(ckpt_dir) if d.startswith("step_")
                    and not d.endswith(".tmp")])
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)

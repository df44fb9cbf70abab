"""Synthetic deterministic data (port of ``repro.data.pipeline``: the
Markov LM token stream, the vision, text-classification and blob tasks),
and the host side of the input pipeline: ``shard_batch`` places a batch
on the device and ``Prefetcher`` keeps a bounded queue of placed batches
ahead of the consumer. The generators are pure numpy, so the same seeds
give the reference's batches exactly."""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch.kernels.runtime import resolve_device
from repro_torch.parallel.sharding import rank_mesh


class MarkovLM:
    """Token streams from a fixed random order-1 Markov chain with
    heavy-tailed transitions: each token has ``branching`` successors,
    the k-th drawn with weight 1/k."""

    def __init__(self, vocab: int, seed: int = 0, branching: int = 8):
        rng = np.random.default_rng(seed)
        self.vocab = vocab
        self.succ = rng.integers(0, vocab, (vocab, branching))
        w = 1.0 / np.arange(1, branching + 1)
        self.probs = w / w.sum()

    def sample(self, rng: np.random.Generator, batch: int,
               seq: int) -> np.ndarray:
        out = np.empty((batch, seq + 1), np.int32)
        out[:, 0] = rng.integers(0, self.vocab, batch)
        for t in range(seq):
            choice = rng.choice(self.succ.shape[1], size=batch, p=self.probs)
            out[:, t + 1] = self.succ[out[:, t], choice]
        return out

    def batches(self, batch: int, seq: int, seed: int = 1) -> Iterator[dict]:
        """Endless ``{"tokens", "labels"}`` batches of (batch, seq) int32,
        the labels the tokens shifted by one."""
        rng = np.random.default_rng(seed)
        while True:
            chunk = self.sample(rng, batch, seq)
            yield {"tokens": chunk[:, :-1], "labels": chunk[:, 1:]}


def image_task(n_classes: int = 10, size: int = 32, channels: int = 3,
               seed: int = 0):
    """Class-conditional image patterns + noise (a CIFAR stand-in)."""
    rng = np.random.default_rng(seed)
    bases = rng.normal(size=(n_classes, channels, size, size)).astype(
        np.float32)

    def batches(batch: int, noise: float = 0.8,
                seed: int = 1) -> Iterator[dict]:
        r = np.random.default_rng(seed)
        while True:
            y = r.integers(0, n_classes, batch)
            x = bases[y] + noise * r.normal(
                size=(batch, channels, size, size)).astype(np.float32)
            yield {"image": x.astype(np.float32), "label": y.astype(np.int32)}

    return batches


def text_cls_task(vocab: int = 1000, n_classes: int = 2, seed: int = 0):
    """Class-dependent token distributions (an IMDB stand-in)."""
    rng = np.random.default_rng(seed)
    class_logits = rng.normal(size=(n_classes, vocab)).astype(
        np.float32) * 1.5

    def batches(batch: int, seq: int = 64, seed: int = 1) -> Iterator[dict]:
        r = np.random.default_rng(seed)
        probs = np.exp(class_logits)
        probs /= probs.sum(-1, keepdims=True)
        while True:
            y = r.integers(0, n_classes, batch)
            toks = np.stack([r.choice(vocab, size=seq, p=probs[c])
                             for c in y])
            yield {"tokens": toks.astype(np.int32),
                   "label": y.astype(np.int32)}

    return batches


def blob_task(size: int = 28, n_classes: int = 10, seed: int = 0):
    """Digit-like blobs for the VAE / GAN (an MNIST stand-in)."""
    rng = np.random.default_rng(seed)
    cx, cy = rng.uniform(6, size - 6, (2, n_classes))
    r0 = rng.uniform(2, 6, n_classes)
    yy, xx = np.mgrid[0:size, 0:size]

    def batches(batch: int, seed: int = 1) -> Iterator[dict]:
        r = np.random.default_rng(seed)
        while True:
            y = r.integers(0, n_classes, batch)
            d2 = (xx[None] - cx[y, None, None]) ** 2 + \
                (yy[None] - cy[y, None, None]) ** 2
            img = (d2 < r0[y, None, None] ** 2).astype(np.float32)
            img = np.clip(img + 0.1 * r.normal(size=img.shape), 0, 1)
            yield {"image": img.reshape(batch, -1).astype(np.float32),
                   "label": y.astype(np.int32)}

    return batches


# ---------------------------------------------------------------------------
# device placement + bounded prefetch
# ---------------------------------------------------------------------------

def shard_batch(batch: dict, sharding=None, device=None) -> dict:
    """A batch of numpy arrays as tensors on ``device`` (``cuda`` unless
    given). ``sharding`` is the reference's argument: under a mesh of
    ranks (``launch/mesh.py: RankMesh``, or a ``MeshContext`` over one)
    every rank holds the whole global batch on its device, and the
    data-parallel step cuts its rows (``train/trainer.py``)."""
    if sharding is not None:
        rank_mesh(sharding, "placing a batch")
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.asarray(v)).to(dev)
            for k, v in batch.items()}


class Prefetcher:
    """Bounded-depth background prefetch: a persistently slow producer can
    never stall consumers by more than ``depth`` steps (straggler bound).

    A producer exception rides the queue as a sentinel and re-raises on
    the consumer thread, and stays raised; exhaustion becomes a persistent
    ``StopIteration``. ``close()`` unblocks a producer stuck on a full
    queue: the producer only waits on ``put`` with a timeout and re-checks
    the stop flag, and ``close`` drains the queue until the thread exits.
    """

    def __init__(self, it: Iterator[dict], depth: int = 2, sharding=None,
                 device=None):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.it = it
        if sharding is not None:
            rank_mesh(sharding, "placing a batch")
        self.sharding = sharding
        self.device = resolve_device(device)
        self._stop = threading.Event()
        self._err: BaseException | None = None
        self._done = False
        self.t = threading.Thread(target=self._run, daemon=True)
        self.t.start()

    def _put(self, item) -> bool:
        """Stop-aware bounded put; False when the prefetcher was closed."""
        while not self._stop.is_set():
            try:
                self.q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _run(self):
        try:
            for b in self.it:
                if self._stop.is_set():
                    return
                if not self._put(("item", shard_batch(b, self.sharding,
                                                      self.device))):
                    return
        except BaseException as e:  # noqa: BLE001 — must reach the consumer
            self._put(("error", e))
        else:
            self._put(("end", None))

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        if self._err is not None:
            raise self._err
        if self._done:
            raise StopIteration
        kind, val = self.q.get()
        if kind == "item":
            return val
        if kind == "error":
            self._err = val
            raise val
        self._done = True
        raise StopIteration

    def close(self):
        self._stop.set()
        while self.t.is_alive():
            try:
                self.q.get_nowait()
            except queue.Empty:
                pass
            self.t.join(timeout=0.05)

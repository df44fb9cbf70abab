"""Calibration (port of ``repro.core.calibration``, paper §3.2.1).

Observers collect statistics over a representative subset of the data (the
paper uses about two batches); calibrators turn them into a ``calib_max``
or a (min, max). The paper's default is the 99.9-percentile histogram
calibrator; MSE and entropy (KL) calibrators are the alternatives it
mentions. As in the reference, the statistics are numpy on the host: a
tensor argument is copied to the host once per ``update``, and the
resulting :class:`QParams` hold float32 tensors on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .quantization import QParams, affine_qparams, symmetric_qparams


def _host(x, dtype=np.float32) -> np.ndarray:
    """``x`` as a numpy array on the host (a tensor is read once)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, dtype=dtype)


@dataclasses.dataclass
class HistogramObserver:
    """Single-pass |x| histogram with geometric range expansion.

    Bins cover [0, range]; when a batch exceeds the range, existing counts
    are re-binned into the doubled range (counts merge pairwise), so
    percentile queries stay consistent without a second pass.
    """

    n_bins: int = 2048
    range: float = 0.0
    counts: Optional[np.ndarray] = None
    xmin: float = 0.0
    xmax: float = 0.0

    def update(self, x) -> None:
        x = _host(x).ravel()
        if x.size == 0:
            return
        self.xmin = min(self.xmin, float(x.min()))
        self.xmax = max(self.xmax, float(x.max()))
        amax = float(np.abs(x).max())
        if self.counts is None:
            self.counts = np.zeros(self.n_bins, dtype=np.int64)
            self.range = max(amax, 1e-12)
        while amax > self.range:
            # double the range; merge counts pairwise into the lower half
            merged = self.counts.reshape(-1, 2).sum(axis=1)
            nc = np.zeros_like(self.counts)
            nc[: self.n_bins // 2] = merged
            self.counts = nc
            self.range *= 2.0
        idx = np.minimum(
            (np.abs(x) / self.range * self.n_bins).astype(np.int64),
            self.n_bins - 1)
        np.add.at(self.counts, idx, 1)

    # -- calibrators ------------------------------------------------------

    def _require_data(self) -> None:
        if self.counts is None:
            raise ValueError("observer saw no data")

    def percentile_max(self, pct: float = 99.9) -> float:
        """The smallest |x| bound covering ``pct``% of observed values."""
        self._require_data()
        cdf = np.cumsum(self.counts)
        k = int(np.searchsorted(cdf, pct / 100.0 * cdf[-1]))
        k = min(k, self.n_bins - 1)
        return float((k + 1) / self.n_bins * self.range)

    def mse_max(self, bits: int, n_grid: int = 64) -> float:
        """The clip bound minimising the expected squared quantization
        error under the observed |x| histogram (grid search)."""
        self._require_data()
        centers = (np.arange(self.n_bins) + 0.5) / self.n_bins * self.range
        probs = self.counts / max(self.counts.sum(), 1)
        hi = (1 << (bits - 1)) - 1
        best, best_err = self.range, np.inf
        for frac in np.linspace(0.2, 1.0, n_grid):
            cmax = frac * self.range
            scale = cmax / hi
            q = np.clip(np.round(centers / scale), 0, hi) * scale
            err = float((probs * (centers - q) ** 2).sum())
            if err < best_err:
                best, best_err = cmax, err
        return best

    def entropy_max(self, bits: int, n_grid: int = 48) -> float:
        """TensorRT-style KL calibrator: the clip bound whose quantized
        distribution minimises KL(P || Q) against the histogram."""
        self._require_data()
        n_levels = 1 << (bits - 1)
        counts = self.counts.astype(np.float64)
        best, best_kl = self.range, np.inf
        start = max(n_levels, self.n_bins // 8)
        for stop in np.linspace(start, self.n_bins, n_grid).astype(int):
            p = counts[:stop].copy()
            p[-1] += counts[stop:].sum()  # clipped mass
            if p.sum() == 0:
                continue
            # quantize the first `stop` bins into n_levels buckets
            edges = np.linspace(0, stop, n_levels + 1).astype(int)
            q = np.zeros(stop)
            for i in range(n_levels):
                lo, hi_ = edges[i], max(edges[i + 1], edges[i] + 1)
                seg = p[lo:hi_]
                nz = (seg > 0).sum()
                if nz:
                    q[lo:hi_] = np.where(seg > 0, seg.sum() / nz, 0)
            mask = p > 0
            qq = np.where(q > 0, q, 1e-12)
            kl = float((p[mask] * np.log(p[mask] / qq[mask])).sum() / p.sum())
            if kl < best_kl:
                best_kl, best = kl, stop / self.n_bins * self.range
        return best


@dataclasses.dataclass
class PerChannelObserver:
    """Per-channel absolute-max observer (weights)."""

    axis: int = 0
    amax: Optional[np.ndarray] = None

    def update(self, w) -> None:
        w = _host(w)
        red = tuple(i for i in range(w.ndim) if i != self.axis)
        cur = np.abs(w).max(axis=red) if red else np.abs(w)
        self.amax = cur if self.amax is None else np.maximum(self.amax, cur)


def calibrate_activation(obs: HistogramObserver, bits: int,
                         method: str = "percentile", affine: bool = True,
                         pct: float = 99.9) -> QParams:
    if method == "percentile":
        cmax = obs.percentile_max(pct)
    elif method == "mse":
        cmax = obs.mse_max(bits)
    elif method == "entropy":
        cmax = obs.entropy_max(bits)
    elif method == "max":
        cmax = obs.range if obs.counts is not None else 1.0
    else:
        raise ValueError(f"unknown calibration method {method!r}")
    if affine and obs.xmin < 0 < obs.xmax:
        lo = max(obs.xmin, -cmax)
        hi = min(obs.xmax, cmax)
        return affine_qparams(torch.tensor(lo, dtype=torch.float32),
                              torch.tensor(hi, dtype=torch.float32), bits)
    return symmetric_qparams(torch.tensor(cmax, dtype=torch.float32), bits)


def calibrate_weight(w, bits: int, axis: int = 0) -> QParams:
    obs = PerChannelObserver(axis=axis)
    obs.update(w)
    return symmetric_qparams(torch.from_numpy(obs.amax.astype(np.float32)),
                             bits, axis=axis)

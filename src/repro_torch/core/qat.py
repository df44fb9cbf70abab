"""Quantization flow orchestration (port of ``repro.core.qat``, paper Fig.
1 / Fig. 2): the call-site registry that calibration fills, and per-channel
weight qparams for a parameter tree. Retraining itself is the trainer's
(``train/trainer.py``) with the STE of ``approx_ops``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from .calibration import (HistogramObserver, calibrate_activation,
                          calibrate_weight)
from .quantization import QParams


@dataclasses.dataclass
class SiteStats:
    """Calibration state for one approximate GEMM call site."""

    observer: HistogramObserver = dataclasses.field(
        default_factory=HistogramObserver)
    qparams: Optional[QParams] = None


class CalibrationRegistry:
    """Collects activation statistics per named call site.

    Models call ``registry.observe(name, x)`` in their forward pass while
    calibrating; ``finalize(bits, method)`` then turns every site's
    histogram into QParams.
    """

    def __init__(self) -> None:
        self.sites: Dict[str, SiteStats] = {}

    def observe(self, name: str, x):
        self.sites.setdefault(name, SiteStats()).observer.update(x)
        return x

    def finalize(self, bits: int, method: str = "percentile",
                 affine: bool = True, pct: float = 99.9) -> Dict[str, QParams]:
        out = {}
        for name, st in self.sites.items():
            st.qparams = calibrate_activation(st.observer, bits, method=method,
                                              affine=affine, pct=pct)
            out[name] = st.qparams
        return out


def _flatten_with_path(tree, prefix=()):
    """(path, leaf) pairs of nested dicts / lists / tuples, dict keys in
    sorted order and each path entry spelled as JAX spells a key path
    (``['name']``, ``[0]``), so the keys below equal the reference's."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten_with_path(tree[k], prefix + (f"[{k!r}]",))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten_with_path(v, prefix + (f"[{i}]",))
    else:
        yield prefix, tree


def calibrate_weights_tree(params, bits: int, axis: int = -1) -> dict:
    """Per-channel symmetric QParams for every 2-D weight leaf, keyed by
    the leaf's path (``"['lstm']/['wx']"``)."""
    out = {}
    for path, leaf in _flatten_with_path(params):
        if isinstance(leaf, torch.Tensor) and leaf.dim() == 2:
            out["/".join(path)] = calibrate_weight(
                leaf, bits, axis=leaf.dim() - 1 if axis == -1 else axis)
    return out

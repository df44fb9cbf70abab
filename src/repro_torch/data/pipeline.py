"""Synthetic deterministic data (port of ``repro.data.pipeline``: the
vision task so far). Pure numpy, so the same seeds give the reference's
batches exactly."""
from __future__ import annotations

from typing import Iterator

import numpy as np


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

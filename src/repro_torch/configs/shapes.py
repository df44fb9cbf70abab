"""Assigned input shapes and per-(arch x shape) eligibility (port of
``repro.configs.shapes``)."""
from __future__ import annotations

import dataclasses

from .base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def eligible(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Whether this (arch, shape) cell runs; reason when skipped (per spec:
    long_500k only for sub-quadratic families)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "long_500k skipped: pure full-attention architecture"
    return True, ""


def cells(configs: dict[str, ModelConfig]):
    """All (arch, shape) cells with eligibility — the 40-cell matrix."""
    out = []
    for aname, cfg in configs.items():
        for sname, sh in SHAPES.items():
            ok, why = eligible(cfg, sh)
            out.append((aname, sname, ok, why))
    return out

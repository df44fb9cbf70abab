"""Int8 error-feedback gradient compression (port of
``repro.optim.compression``): per-leaf int8 codes on one scale, the
residual kept and re-injected next step (Karimireddy et al.). Its use, the
data-parallel all-reduce ``compressed_psum``, waits for the mesh (ROADMAP
item 16).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.tree import tree_map


class EFState(NamedTuple):
    residual: dict  # same structure as grads, float32


def init_ef(grads_like) -> EFState:
    return EFState(residual=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32,
                              device=g.device), grads_like))


def compress(g: torch.Tensor, amax: Optional[torch.Tensor] = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 -> (int8 codes, scale), bitwise the reference's: the scale
    ``bound * (1/127)`` and the codes ``round(g * (127 / bound))`` (the
    multiply form; ``127 / bound`` a correctly rounded divide, which
    ``127.0 / tensor`` in PyTorch is not). ``amax`` overrides the bound."""
    g = g.to(torch.float32)
    if amax is None:
        amax = torch.max(torch.abs(g))
    bound = torch.maximum(amax.to(torch.float32),
                          torch.tensor(1e-12, dtype=torch.float32,
                                       device=g.device))
    scale = bound * (1.0 / 127.0)
    inv_scale = torch.div(torch.tensor(127.0, dtype=torch.float32,
                                       device=g.device), bound)
    q = torch.clamp(torch.round(g * inv_scale), -127, 127).to(torch.int8)
    return q, scale


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale

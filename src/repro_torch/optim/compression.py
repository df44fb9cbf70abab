"""Int8 error-feedback gradient compression (port of
``repro.optim.compression``): per-leaf int8 codes on one scale, the
residual kept and re-injected next step (Karimireddy et al.), and its use,
the data-parallel all-reduce :func:`compressed_psum` over a mesh of ranks
(``launch/mesh.py: RankMesh``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.tree import leaves, tree_map, unflatten


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


def compressed_psum(grads, ef: EFState, axis_name, *, mesh,
                    with_stats: bool = False):
    """Error-feedback int8 all-reduce over the ``axis_name`` group of
    ``mesh`` (a name or a tuple of names; every rank calls it with its own
    gradients).

    The scales' bound is the max over the group first, so every rank codes
    on one grid; each rank's residual keeps what int8 dropped. The int8
    codes are summed as int32 (integer addition is associative, so the
    mean is the same bits whatever the reduction order) and ``scale / n``
    is applied once, afterwards. Quantization goes through
    :func:`compress` / :func:`decompress`. All leaves travel in one max and
    one sum.

    ``with_stats=True`` also returns the free noise pair as float32
    scalars: ``gsq_small``, the mean over ranks of each rank's raw |g|^2
    (before the residual is added), ``gsq_big``, |mean|^2 of the sum, and
    ``resid_sq``, the mean residual energy; the per-rank terms are
    gathered and summed in rank order.
    """
    axes = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    flat_g = leaves(grads)
    flat_r = leaves(ef.residual)
    dev = flat_g[0].device
    n = torch.tensor(float(mesh.group_size(axes)), dtype=torch.float32,
                     device=dev)
    g_raw = [g.to(torch.float32) for g in flat_g]
    g_in = [g + r for g, r in zip(g_raw, flat_r)]
    amax = mesh.pmax(torch.stack([torch.max(torch.abs(g)) for g in g_in]),
                     axes)
    coded = [compress(g, a) for g, a in zip(g_in, amax)]
    new_r = [g - decompress(q, s) for g, (q, s) in zip(g_in, coded)]
    q_sum = mesh.psum(torch.cat([q.reshape(-1).to(torch.int32)
                                 for q, _ in coded]), axes)
    summed, at = [], 0
    for g, (q, scale) in zip(g_in, coded):
        part = q_sum[at:at + q.numel()].reshape(q.shape)
        at += q.numel()
        summed.append(part.to(torch.float32) * (scale / n))
    out = unflatten(grads, summed)
    new_ef = EFState(residual=unflatten(ef.residual, new_r))
    if not with_stats:
        return out, new_ef

    def sq(ts):
        return sum(torch.sum(torch.square(t)) for t in ts)

    def mean_over(t):
        return mesh.all_gather(t.reshape(1), axes).sum() / n

    stats = {"gsq_small": mean_over(sq(g_raw)), "gsq_big": sq(summed),
             "resid_sq": mean_over(sq(new_r))}
    return out, new_ef, stats

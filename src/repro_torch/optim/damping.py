"""Gradient-noise batch damping (port of ``repro.optim.damping``).

The gradient noise scale ``B_noise = S / |G|^2``, with ``E[|G_B|^2] =
|G|^2 + S / B``, is estimated from gradient norms at two batch sizes
(McCandlish et al., "An Empirical Model of Large-Batch Training"):

    |G|^2 ~= (B_big |G_big|^2 - B_small |G_small|^2) / (B_big - B_small)
    S     ~= (|G_small|^2 - |G_big|^2) / (1/B_small - 1/B_big)

The trainer's microbatch loop holds each microbatch's gradient before it
adds it in, so the pair costs no extra gradient pass (B_small: microbatch
rows, B_big: the accumulated batch). The schedule is host-side and
integer-valued: the trainer folds ``accum`` whole data batches into one
optimizer step, and the state round-trips through the checkpoint
manifest's ``extra`` as plain JSON, so a resumed run replays the exact
schedule. On a mesh of ranks, :func:`shard_noise_stats` gives the pair
from each rank's own gradient and the summed mean.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.tree import leaves


def tree_sqnorm(tree) -> torch.Tensor:
    """Sum of squared entries over every leaf (float32), leaves in the
    reference's order."""
    return sum(torch.sum(torch.square(g.to(torch.float32)))
               for g in leaves(tree))


class NoiseStats(NamedTuple):
    """One step's raw small/large-batch gradient-norm pair.

    ``gsq_small`` is the MEAN over the small-batch estimates of |g_i|^2;
    ``gsq_big`` is |mean_i g_i|^2; ``resid_sq`` is the error-feedback
    residual energy (0 when compression is off)."""

    gsq_small: torch.Tensor | float
    gsq_big: torch.Tensor | float
    b_small: int
    b_big: int
    resid_sq: torch.Tensor | float = 0.0


def noise_scale(gsq_small: float, gsq_big: float, b_small: int, b_big: int
                ) -> tuple[float, float]:
    """Unbiased (S, |G|^2) estimates from a two-batch-size norm pair.
    Either can go negative; consumers EMA them and clamp at the ratio."""
    assert b_big > b_small > 0, (b_small, b_big)
    g2 = (b_big * gsq_big - b_small * gsq_small) / (b_big - b_small)
    s = (gsq_small - gsq_big) / (1.0 / b_small - 1.0 / b_big)
    return float(s), float(g2)


def microbatch_noise_stats(micro_sqsum, grads_mean, b_small: int,
                           b_big: int) -> NoiseStats:
    """Stats from the trainer's accumulation loop: ``micro_sqsum`` is the
    sum of per-microbatch |g_i|^2 over ``n = b_big // b_small``
    microbatches."""
    n = b_big // b_small
    return NoiseStats(gsq_small=micro_sqsum / n,
                      gsq_big=tree_sqnorm(grads_mean),
                      b_small=b_small, b_big=b_big)


# ---------------------------------------------------------------------------
# schedule
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DampingConfig:
    """Batch-damping policy. ``accum`` counts whole data batches folded into
    one optimizer step, so effective batch = accum * batch_size."""

    accum_min: int = 1
    accum_max: int = 16
    ema: float = 0.8              # EMA decay for the S and |G|^2 estimates
    check_every: int = 1          # steps between schedule updates
    warmup_updates: int = 2       # estimates folded in before first growth
    grow_only: bool = True        # monotone schedule (QAT recovery posture)
    max_growth: int = 2           # accum can at most double per update
    residual_weight: float = 0.0  # EF residual energy blended into S
    target_frac: float = 1.0      # aim effective batch = frac * B_noise


@dataclasses.dataclass
class DampingState:
    """EMA'd noise estimates and the integer schedule position; plain
    Python numbers, so ``to_dict``/``from_dict`` round-trip through the
    manifest's JSON bit for bit."""

    accum: int = 1
    updates: int = 0
    ema_s: float = 0.0
    ema_g2: float = 0.0
    ema_resid: float = 0.0
    b_noise: float = 0.0          # last smoothed S/|G|^2 (diagnostics)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "DampingState":
        return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls)})


def init_state(cfg: DampingConfig) -> DampingState:
    return DampingState(accum=cfg.accum_min)


def update_state(state: DampingState, cfg: DampingConfig, stats: NoiseStats,
                 batch_size: int) -> DampingState:
    """Fold one step's stats into the EMAs and move the integer schedule:
    host-side float arithmetic, so equal stats give equal transitions."""
    s, g2 = noise_scale(float(stats.gsq_small), float(stats.gsq_big),
                        int(stats.b_small), int(stats.b_big))
    resid = float(stats.resid_sq)
    if cfg.residual_weight:
        # what int8 dropped is gradient content the step didn't apply:
        # count it as extra per-sample noise at the small batch size
        s = s + cfg.residual_weight * resid * int(stats.b_small)
    k = state.updates + 1
    # debiased EMA (Adam-style) so early estimates aren't pulled toward 0
    ema_s = cfg.ema * state.ema_s + (1 - cfg.ema) * s
    ema_g2 = cfg.ema * state.ema_g2 + (1 - cfg.ema) * g2
    ema_resid = cfg.ema * state.ema_resid + (1 - cfg.ema) * resid
    bias = 1.0 - cfg.ema ** k
    b_noise = max(ema_s / bias, 0.0) / max(ema_g2 / bias, 1e-20)

    accum = state.accum
    if k >= cfg.warmup_updates:
        want = cfg.target_frac * b_noise / max(batch_size, 1)
        target = int(min(max(round(want), cfg.accum_min), cfg.accum_max))
        if target > state.accum:                      # rate-limited growth
            accum = min(target, state.accum * cfg.max_growth)
        elif target < state.accum and not cfg.grow_only:
            accum = max(target, state.accum // cfg.max_growth, cfg.accum_min)
    return DampingState(accum=accum, updates=k, ema_s=ema_s, ema_g2=ema_g2,
                        ema_resid=ema_resid, b_noise=b_noise)


def shard_noise_stats(grads, grads_mean, axis_name, b_local: int,
                      n_workers: int, *, mesh) -> NoiseStats:
    """The per-rank vs summed-mean pair on a mesh of ranks: ``grads`` is
    this rank's gradient of its own rows, ``grads_mean`` the already
    all-reduced mean (both free: the step has them). One gather of a
    scalar is added; the ranks' |g|^2 are summed in rank order.
    ``gsq_big`` is taken on the mean, which every rank holds whole, so
    every rank (and a one-process oracle given the same mean) reduces it
    in the same order."""
    axes = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    local = tree_sqnorm(grads)
    small = mesh.all_gather(local.reshape(1), axes).sum() / torch.tensor(
        float(n_workers), dtype=torch.float32, device=local.device)
    return NoiseStats(gsq_small=small, gsq_big=tree_sqnorm(grads_mean),
                      b_small=b_local, b_big=int(b_local) * int(n_workers))

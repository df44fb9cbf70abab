"""Sharding planner: assigns partition specs to every param / optimizer-state /
cache / batch leaf, by leaf name + tensor role, with divisibility fallbacks
(port of ``repro.parallel.planner``; it reads mesh shapes only, so it plans
the production meshes of ``launch/mesh.py`` without their devices).

Modes:
* ``train``  — FSDP(data) x TP(model): TP on the semantically-shardable dim
  (heads when H % axis == 0, d_ff, vocab, experts), FSDP on the other dim.
* ``serve``  — TP(model) only; params replicated over data (batch shards DP).
* ``long``   — serve + context parallelism: KV-cache/state sequence dim over
  ``data`` (batch=1 cannot use it).

Every decision that falls back (heads not divisible, experts not divisible)
is recorded in the returned ``report`` so the plan is auditable.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel.sharding import P
from repro_torch.tree import leaves_with_names, unflatten


@dataclasses.dataclass
class Plan:
    mesh: Any                  # a mesh shape (``launch.mesh.MeshShape``)
    specs: Any                 # tree of P, shaped like the planned tree
    report: list[str]


def _axis(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def _fits(dim: int, mesh, axes: tuple[str, ...]) -> bool:
    n = math.prod(_axis(mesh, a) for a in axes) if axes else 1
    return n > 1 and dim % n == 0


def batch_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def batch_spec(mesh, global_batch: int, extra_dims: int = 1) -> P:
    ba = batch_axes(mesh)
    if not _fits(global_batch, mesh, ba):
        ba = ba[1:] if len(ba) > 1 and _fits(global_batch, mesh, ba[1:]) else ()
    lead = ba if ba else None
    return P(lead, *([None] * extra_dims))


def param_specs(cfg: ModelConfig, params, mesh, mode: str = "train") -> Plan:
    """Walk the param pytree; assign (TP, FSDP) per leaf by name."""
    report: list[str] = []
    fsdp = ("data",) if (mode == "train" and "data" in mesh.axis_names) else ()
    if mode == "serve" and "data" in mesh.axis_names:
        # TP-only replicates weights across the data axis; when that exceeds
        # the HBM budget (v5e 16 GiB minus activations), also shard weights
        # over data — ZeRO-inference (per-layer all-gather, memory-feasible).
        dtype_bytes = 2 if cfg.dtype == "bfloat16" else 4
        per_dev = cfg.n_params() * dtype_bytes / _axis(mesh, "model")
        if per_dev > 10e9:
            fsdp = ("data",)
            report.append(f"serve: params {per_dev/2**30:.1f} GiB/device under "
                          f"TP-only -> weight FSDP over data (ZeRO-inference)")
    heads_ok = _fits(cfg.n_heads, mesh, ("model",))
    kv_ok = _fits(cfg.n_kv_heads, mesh, ("model",))
    experts_ok = cfg.n_experts and _fits(cfg.n_experts, mesh, ("model",))
    if not heads_ok:
        report.append(f"heads {cfg.n_heads} %% model axis != 0 -> attention "
                      f"projections replicated on TP (TP lives on d_ff/vocab)")
    if cfg.n_experts and not experts_ok:
        report.append(f"experts {cfg.n_experts} %% model axis != 0 -> "
                      f"TP-in-expert (d_ff {cfg.d_ff})")

    def fs(dim_size: int) -> Optional[tuple]:
        return fsdp if fsdp and dim_size % _axis(mesh, "data") == 0 else None

    def mdl(dim_size: int, want: bool = True) -> Optional[tuple]:
        return ("model",) if want and _fits(dim_size, mesh, ("model",)) else None

    def leaf_spec(path: str, leaf) -> P:
        shp = leaf.shape
        nd = len(shp)
        name = path.split("'")[-2] if "'" in path else path  # last dict key

        def grouped(*dims):  # prepend None for the group-stack axis if present
            return P(*([None] * (nd - len(dims)) + list(dims)))

        # ---- embeddings / head -------------------------------------------
        if name == "embed":
            return P(mdl(shp[0]), fs(shp[1]))
        if name == "lm_head":
            return P(fs(shp[0]), mdl(shp[1]))
        if name == "dec_pos":
            return P(None, None)
        # ---- attention ----------------------------------------------------
        if name in ("wq", "wk", "wv"):
            n_h = cfg.n_heads if name == "wq" else cfg.n_kv_heads
            ok = heads_ok if name == "wq" else kv_ok
            return grouped(fs(shp[-2]), mdl(shp[-1], ok))
        if name == "wo":
            return grouped(mdl(shp[-2], heads_ok), fs(shp[-1]))
        if name in ("bq", "bk", "bv"):
            ok = heads_ok if name == "bq" else kv_ok
            return grouped(mdl(shp[-1], ok))
        if name == "bo":
            return grouped(None)
        # ---- dense MLP ------------------------------------------------------
        if name in ("w_gate", "w_up") and nd <= 3:
            return grouped(fs(shp[-2]), mdl(shp[-1]))
        if name == "w_down" and nd <= 3:
            return grouped(mdl(shp[-2]), fs(shp[-1]))
        if name in ("b_up",):
            return grouped(mdl(shp[-1]))
        # ---- MoE ------------------------------------------------------------
        if name in ("w_gate", "w_up") and nd == 4:   # (g, E, D, F)
            if experts_ok:
                return P(None, ("model",), fs(shp[2]), None)
            return P(None, None, fs(shp[2]), mdl(shp[3]))
        if name == "w_down" and nd == 4:             # (g, E, F, D)
            if experts_ok:
                return P(None, ("model",), None, fs(shp[3]))
            return P(None, None, mdl(shp[2]), fs(shp[3]))
        if name == "router":
            return grouped(None, None)
        # ---- mamba ----------------------------------------------------------
        if name == "in_proj":
            return grouped(fs(shp[-2]), mdl(shp[-1]))
        if name == "x_proj":
            return grouped(mdl(shp[-2]), None)
        if name == "dt_proj":
            return grouped(None, mdl(shp[-1]))
        if name in ("conv_w",):
            return grouped(None, mdl(shp[-1]))
        if name in ("conv_b", "dt_bias", "Dskip"):
            return grouped(mdl(shp[-1]))
        if name == "A_log":
            return grouped(mdl(shp[-2]), None)
        if name == "out_proj":
            return grouped(mdl(shp[-2]), fs(shp[-1]))
        # ---- rwkv -----------------------------------------------------------
        if name in ("Wr", "Wk", "Wv", "Wg", "Wo", "Wr_cm"):
            # wkv heads (40) don't divide the axis; keep head locality by
            # replicating time-mix projections, TP on channel-mix below
            return grouped(fs(shp[-2]), mdl(shp[-1], heads_ok))
        if name == "Wk_cm":
            return grouped(fs(shp[-2]), mdl(shp[-1]))
        if name == "Wv_cm":
            return grouped(mdl(shp[-2]), fs(shp[-1]))
        if name in ("Wdecay_A", "Wdecay_B", "lora_A") or name.startswith("lora_B"):
            return grouped(None, None)
        # ---- everything else (norms, scalars, mus) ------------------------
        return P(*([None] * nd))

    specs = [leaf_spec(name, leaf) for name, leaf in leaves_with_names(params)]
    return Plan(mesh=mesh, specs=unflatten(params, specs), report=report)


def cache_specs(cfg: ModelConfig, cache, mesh, *, global_batch: int,
                long_context: bool = False) -> Plan:
    """KV/SSM cache sharding for serving.

    Default: batch -> (pod, data), kv-heads -> model (when divisible, else
    head_dim -> model, else seq -> model). long_context (batch=1): sequence
    dim -> data (context parallelism), heads/head_dim -> model.
    """
    report: list[str] = []
    ba = batch_axes(mesh)
    b_ok = _fits(global_batch, mesh, ba)
    if not b_ok and len(ba) > 1 and _fits(global_batch, mesh, ba[1:]):
        ba = ba[1:]
        b_ok = True
    if not b_ok:
        ba = ()
        report.append(f"batch {global_batch} not divisible -> replicated batch")

    def leaf_spec(path: str, leaf) -> P:
        shp = leaf.shape
        nd = len(shp)
        bspec = ba if ba else None
        if nd == 5 and "attn" in path:            # (g, B, S, Hkv, hd)
            seq = ("data",) if (long_context and "data" in mesh.axis_names
                                and shp[2] % _axis(mesh, "data") == 0) else None
            if _fits(shp[3], mesh, ("model",)):
                return P(None, bspec, seq, ("model",), None)
            # kv heads don't divide: split-KV decode — shard the sequence dim
            # over model (softmax denominators all-reduce; avoids the
            # involuntary-full-remat path that head_dim sharding triggers)
            if seq is None and _fits(shp[2], mesh, ("model",)):
                return P(None, bspec, ("model",), None, None)
            return P(None, bspec, seq, None, None)
        if "mamba" in path:
            if nd == 4 and "conv" in path:        # (g, B, dc-1, di)
                return P(None, bspec, None,
                         ("model",) if _fits(shp[3], mesh, ("model",)) else None)
            if nd == 4:                            # ssm (g, B, di, ds)
                return P(None, bspec,
                         ("model",) if _fits(shp[2], mesh, ("model",)) else None,
                         None)
        if "rwkv" in path:
            if nd == 5:                            # wkv (g, B, H, hd, hd)
                if _fits(shp[2], mesh, ("model",)):
                    return P(None, bspec, ("model",), None, None)
                if _fits(shp[3], mesh, ("model",)):
                    return P(None, bspec, None, ("model",), None)
                return P(None, bspec, None, None, None)
            if nd == 4:                            # shift (g, B, 1, D)
                return P(None, bspec, None,
                         ("model",) if _fits(shp[3], mesh, ("model",)) else None)
        # whisper self-attn cache: (L, B, S, H, hd)
        if nd == 5:
            return P(None, bspec, None,
                     ("model",) if _fits(shp[3], mesh, ("model",)) else None, None)
        return P(*([None] * nd))

    specs = [leaf_spec(name, leaf) for name, leaf in leaves_with_names(cache)]
    return Plan(mesh=mesh, specs=unflatten(cache, specs), report=report)


# ---------------------------------------------------------------------------
# approximate-GEMM partitions (core/acu.py matmul_plan routes)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GemmPartition:
    """Resolved mesh partition for one ACU GEMM: ``a (M, K) @ w (K, N)``.

    ``rows``/``cols``/``k`` are mesh-axis tuples (possibly empty). The product
    LUT is always replicated (``acu_lut`` rule; it is <= 256 KiB). A non-empty
    ``k`` means contraction sharding: both operands split on K and the int32
    partial accumulators are psum-reduced over ``k`` before dequant.
    ``report`` carries the audited fallback decisions that shaped this
    partition (inspectable on ``MatmulPlan.partition`` in the dispatch path).
    """

    rows: tuple[str, ...]
    cols: tuple[str, ...]
    k: tuple[str, ...]
    n_rows: int
    n_cols: int
    n_k: int
    report: tuple[str, ...] = ()

    @property
    def total(self) -> int:
        return self.n_rows * self.n_cols * self.n_k

    @staticmethod
    def _dim(axes: tuple[str, ...]):
        return None if not axes else (axes[0] if len(axes) == 1 else axes)

    def a_spec(self) -> P:
        return P(self._dim(self.rows), self._dim(self.k))

    def w_spec(self) -> P:
        return P(self._dim(self.k), self._dim(self.cols))

    def out_spec(self) -> P:
        return P(self._dim(self.rows), self._dim(self.cols))


def acu_gemm_partition(ctx, *, float_accum: bool = False
                       ) -> tuple[GemmPartition, list[str]]:
    """Resolve the ``acu_rows``/``acu_cols``/``acu_k`` logical rules of an
    active :class:`~repro.parallel.sharding.MeshContext` into a
    :class:`GemmPartition`, with the planner's usual audited fallbacks:

    * each mesh axis is claimed by at most one GEMM dim — ``k`` first (it is
      an explicit opt-in), then ``cols``, then ``rows``;
    * ``float_accum`` (LOWRANK: the SVD correction makes partial accumulators
      real-valued) drops ``k``: a float psum would not be bit-exact against
      the single-device oracle.
    """
    report: list[str] = []
    k = ctx.axes_for("acu_k")
    if k and float_accum:
        report.append("acu_k dropped: float accumulator (LOWRANK) cannot "
                      "psum bit-exactly; K replicated")
        k = ()
    used = set(k)
    cols = tuple(a for a in ctx.axes_for("acu_cols") if a not in used)
    if len(cols) != len(ctx.axes_for("acu_cols")):
        report.append("acu_cols overlaps acu_k -> shared axes dropped from "
                      "cols (contraction sharding wins)")
    used.update(cols)
    rows = tuple(a for a in ctx.axes_for("acu_rows") if a not in used)
    part = GemmPartition(rows=rows, cols=cols, k=k,
                         n_rows=ctx.axis_prod(rows),
                         n_cols=ctx.axis_prod(cols),
                         n_k=ctx.axis_prod(k),
                         report=tuple(report))
    return part, report


def bwd_gemm_partitions(part: GemmPartition
                        ) -> tuple[GemmPartition, GemmPartition]:
    """Permuted partitions for the *approximate* STE backward GEMMs.

    Each backward GEMM is a forward-shaped GEMM with the forward partition's
    roles permuted — no new mesh axes are claimed, so the residuals arrive
    already sharded the way the forward left them:

    * ``gx = g (M, N) @ wf.T (N, K)``: output rows stay on the forward's
      ``rows`` axes, output columns land on the forward's ``k`` axes, and the
      contraction runs over the forward's ``cols`` axes.
    * ``gw = xf.T (K, M) @ g (M, N)``: rows over the forward's ``k`` axes,
      columns over the forward's ``cols`` axes, contraction over the
      forward's ``rows`` axes.

    A non-empty contraction (``k``) dim means int32 partial accumulators
    psum before dequant with the shard-padding corrected exactly once —
    the same discipline as an ``acu_k``-sharded forward. Under the default
    rules (rows over ``("pod", "data")``, cols over ``("model",)``) both
    backward GEMMs are contraction-sharded even though the forward is not.
    """
    gx = GemmPartition(rows=part.rows, cols=part.k, k=part.cols,
                       n_rows=part.n_rows, n_cols=part.n_k, n_k=part.n_cols,
                       report=("bwd gx: forward partition, cols<->k swapped",))
    gw = GemmPartition(rows=part.k, cols=part.cols, k=part.rows,
                       n_rows=part.n_k, n_cols=part.n_cols, n_k=part.n_rows,
                       report=("bwd gw: forward partition, rows<->k swapped",))
    return gx, gw


def acu_conv_partition(ctx, *, float_accum: bool = False
                       ) -> tuple[GemmPartition, list[str]]:
    """The ``acu_conv`` partition rule: resolve ``acu_conv_rows`` /
    ``acu_conv_cols`` / ``acu_conv_k`` into a :class:`GemmPartition` for one
    approximate conv — ``rows`` shards the batch x output-pixel dim (the GEMM
    M of the implicit im2col; when the batch alone cannot fill the rows
    axes, ``acu_shard.wrap_fused_conv`` splits each image into halo'd
    output-row *bands* over the spare ways — batch x band partitioning),
    ``cols`` the output channels, ``k`` the input-channel contraction
    (opt-in; int32 psum before dequant). The product LUT is always
    replicated (``acu_lut``). Same audited-fallback discipline as
    :func:`acu_gemm_partition`: one mesh axis per conv dim, ``k`` claims
    first, and a float accumulator (LOWRANK) drops ``k``.
    """
    report: list[str] = []
    k = ctx.axes_for("acu_conv_k")
    if k and float_accum:
        report.append("acu_conv_k dropped: float accumulator (LOWRANK) "
                      "cannot psum bit-exactly; channels replicated")
        k = ()
    used = set(k)
    cols = tuple(a for a in ctx.axes_for("acu_conv_cols") if a not in used)
    if len(cols) != len(ctx.axes_for("acu_conv_cols")):
        report.append("acu_conv_cols overlaps acu_conv_k -> shared axes "
                      "dropped from cols (contraction sharding wins)")
    used.update(cols)
    rows = tuple(a for a in ctx.axes_for("acu_conv_rows") if a not in used)
    part = GemmPartition(rows=rows, cols=cols, k=k,
                         n_rows=ctx.axis_prod(rows),
                         n_cols=ctx.axis_prod(cols),
                         n_k=ctx.axis_prod(k),
                         report=tuple(report))
    return part, report


def acu_attn_partition(ctx, *, hq: int, hkv: int
                       ) -> tuple[GemmPartition, list[str]]:
    """Resolve the ``acu_attn_rows`` / ``acu_attn_heads`` logical rules for
    one approximate attention site: ``rows`` shards the batch dim (serving
    slots), ``cols`` the **KV** heads — each shard owns whole GQA groups
    (its ``rep = hq // hkv`` query heads per KV head ride along), so the
    kernel's ``b // rep`` index map stays local and there are no
    collectives. ``k`` is always empty: the online softmax is sequential
    over KV blocks and the float (m, l, acc) rescale cannot psum
    bit-exactly. Same audited-fallback discipline as the GEMM/conv
    partitions: head axes that do not divide ``hkv`` are dropped (reported)
    and the batch padding is handled by the wrap.
    """
    report: list[str] = []
    cols = ctx.axes_for("acu_attn_heads")
    while cols and hkv % ctx.axis_prod(cols) != 0:
        cols = cols[:-1]
    if len(cols) != len(ctx.axes_for("acu_attn_heads")):
        report.append(f"kv heads {hkv} %% acu_attn_heads axes != 0 -> heads "
                      f"{'partially sharded' if cols else 'replicated'} "
                      f"(GQA groups must stay whole per shard)")
    used = set(cols)
    rows = tuple(a for a in ctx.axes_for("acu_attn_rows") if a not in used)
    part = GemmPartition(rows=rows, cols=cols, k=(),
                         n_rows=ctx.axis_prod(rows),
                         n_cols=ctx.axis_prod(cols),
                         n_k=1,
                         report=tuple(report))
    return part, report


def acu_grouped_partition(ctx, *, n_experts: int, n_blocks: int
                          ) -> tuple[GemmPartition, list[str]]:
    """Resolve the ``acu_grouped_rows`` / ``acu_grouped_experts`` /
    ``acu_grouped_k`` logical rules for one MoE grouped ragged GEMM site:
    ``cols`` shards the expert dim (expert parallelism — each shard runs the
    grouped kernel over its expert slice with its slice of the groupinfo),
    ``rows`` the dispatch-block dim ``nb`` (token parallelism: dispatch
    blocks are independent capacity buffers), ``k`` the contraction (opt-in;
    the masked int32 partial accumulators psum before dequant). Same
    audited-fallback discipline as the attention partition: expert/block
    axes that do not divide their dim are dropped (reported) rather than
    padded — a fractional expert per shard would split a group's contiguous
    capacity strip.
    """
    report: list[str] = []
    k = ctx.axes_for("acu_grouped_k")
    used = set(k)
    cols = tuple(a for a in ctx.axes_for("acu_grouped_experts")
                 if a not in used)
    if len(cols) != len(ctx.axes_for("acu_grouped_experts")):
        report.append("acu_grouped_experts overlaps acu_grouped_k -> shared "
                      "axes dropped from experts (contraction sharding wins)")
    while cols and n_experts % ctx.axis_prod(cols) != 0:
        cols = cols[:-1]
        report.append(f"experts {n_experts} %% acu_grouped_experts axes != 0 "
                      f"-> experts {'partially sharded' if cols else 'replicated'} "
                      f"(each shard needs whole experts)")
    used.update(cols)
    rows = tuple(a for a in ctx.axes_for("acu_grouped_rows") if a not in used)
    while rows and n_blocks % ctx.axis_prod(rows) != 0:
        rows = rows[:-1]
        report.append(f"dispatch blocks {n_blocks} %% acu_grouped_rows axes "
                      f"!= 0 -> blocks "
                      f"{'partially sharded' if rows else 'replicated'}")
    part = GemmPartition(rows=rows, cols=cols, k=k,
                         n_rows=ctx.axis_prod(rows),
                         n_cols=ctx.axis_prod(cols),
                         n_k=ctx.axis_prod(k),
                         report=tuple(report))
    return part, report


def opt_state_specs(param_plan: Plan, opt_state) -> Any:
    """Optimizer moments shard exactly like their params; scalars replicate."""
    pspecs = param_plan.specs
    import repro_torch.optim.adamw as O
    if isinstance(opt_state, O.AdamWState):
        return O.AdamWState(step=P(), mu=pspecs, nu=pspecs)
    if isinstance(opt_state, O.SGDState):
        return O.SGDState(step=P(), momentum=pspecs)
    raise TypeError(type(opt_state))

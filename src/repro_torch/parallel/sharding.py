"""Logical-axis sharding: models annotate tensors with *logical* axes; an
active :class:`MeshContext` maps them to mesh axes with divisibility checks
(port of ``repro.parallel.sharding``).

Model code stays mesh-agnostic: ``shard(x, "batch", None, "mlp")`` is an
identity when no mesh is active or the mesh has one device. Under a mesh of
ranks (``launch/mesh.py: RankMesh``) every rank holds the whole global
tensor (the mesh runtime is SPMD on global operands: each ACU plan cuts its
own blocks and gathers its result), so a layout hint changes no value and
:func:`shard` checks it and returns ``x``. A :class:`~repro_torch.launch.
mesh.MeshShape` of more than one device has no ranks to run on: there
:func:`shard` raises.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Optional, Sequence

_STATE = threading.local()


class P(tuple):
    """A partition spec: one entry per tensor dim, each ``None``
    (replicated), a mesh-axis name, or a tuple of names (the dim split over
    their product), with the semantics of ``jax.sharding.PartitionSpec``.
    A tuple subclass, so trees (``repro_torch.tree``) keep it as a leaf."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


# default logical-axis -> mesh-axes rules. "batch" spans pod+data so one rule
# set covers both single-pod and multi-pod meshes (missing axes are dropped).
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "seq": (),                 # replicated by default; "seq_shard" opts in
    "seq_shard": ("data",),    # context parallelism (long-context KV/state)
    "embed": (),
    "embed_fsdp": ("data",),   # FSDP dim for params/optimizer state
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "mlp": ("model",),
    "vocab": ("model",),
    "experts": ("model",),     # expert parallelism
    "expert_blocks": ("pod", "data"),  # block-local MoE dispatch (token-parallel)
    "expert_cap": ("data",),   # MoE dispatch capacity dim (token-parallel)
    "expert_mlp": ("model",),  # TP-in-expert when EP doesn't divide
    "tokens": ("pod", "data"),  # flattened token rows (B*S order, batch-major)
    "conv_dim": ("model",),
    "state": (),
    # ---- quantized ACU GEMM operands (core/acu.py matmul_plan routes) ----
    # The (2^b, 2^b) product table is <= 256 KiB and replicates to every
    # device; activation code rows shard like tokens, weight code columns
    # like any TP output dim. "acu_k" opts in to contraction sharding: the
    # K dim of both operands splits over the named axes and the int32
    # partial accumulators are psum-reduced before dequant.
    "acu_rows": ("pod", "data"),   # activation / output rows (M)
    "acu_cols": ("model",),        # weight / output columns (N)
    "acu_k": (),                   # contraction dim (K); empty = replicated
    "acu_lut": (),                 # product table: always replicated
    # ---- approximate conv (core/acu.py conv_plan routes): batch x
    # output-pixel rows shard like tokens, output channels like any TP
    # output dim; "acu_conv_k" opts in to input-channel contraction
    # sharding (int32 psum before dequant).
    "acu_conv_rows": ("pod", "data"),  # batch x output-row-band rows
    "acu_conv_cols": ("model",),       # output channels (Cout)
    "acu_conv_k": (),                  # input channels (C); empty = replicated
    # ---- approximate attention (core/acu.py attn_plan routes): batch rows
    # shard like tokens, KV heads like any TP head dim (whole GQA groups
    # per shard). No contraction sharding: the online softmax is sequential
    # in KV and bit-exactness forbids re-associating the float rescale.
    "acu_attn_rows": ("pod", "data"),  # batch rows (B)
    "acu_attn_heads": ("model",),      # KV heads (GQA groups stay whole)
    # ---- grouped ragged MoE GEMM (core/acu.py grouped_plan routes): experts
    # over "model", dispatch blocks over the token axes; "acu_grouped_k"
    # opts in to contraction sharding (int32 psum before dequant).
    "acu_grouped_rows": ("pod", "data"),  # dispatch blocks (nb)
    "acu_grouped_experts": ("model",),    # experts (E)
    "acu_grouped_k": (),                  # contraction dim; empty = replicated
}


def _prod(mesh, axes: Sequence[str]) -> int:
    return math.prod(mesh.shape[a] for a in axes)


@dataclasses.dataclass
class MeshContext:
    mesh: object          # anything with ``shape`` (dict), ``axis_names``, ``size``
    rules: dict[str, tuple[str, ...]]

    def spec(self, *logical: Optional[str],
             dim_sizes: Sequence[int] | None = None) -> P:
        """Partition spec for one tensor; rules that don't divide are
        dropped, and a mesh axis is used by at most one dim (first wins)."""
        parts = []
        used: set[str] = set()
        for i, name in enumerate(logical):
            if name is None:
                parts.append(None)
                continue
            axes = [a for a in self.rules.get(name, ())
                    if a in self.mesh.axis_names and a not in used]
            if not axes:
                parts.append(None)
                continue
            if dim_sizes is not None and dim_sizes[i] % _prod(self.mesh,
                                                              axes) != 0:
                # try progressively smaller prefixes before replicating
                while axes:
                    axes = axes[:-1]
                    if axes and dim_sizes[i] % _prod(self.mesh, axes) == 0:
                        break
                if not axes:
                    parts.append(None)
                    continue
            used.update(axes)
            parts.append(tuple(axes) if len(axes) > 1 else axes[0])
        return P(*parts)

    def axes_for(self, logical: str) -> tuple[str, ...]:
        """Mesh axes a logical rule resolves to on *this* mesh (missing mesh
        axes dropped, order preserved)."""
        return tuple(a for a in self.rules.get(logical, ())
                     if a in self.mesh.axis_names)

    def axis_prod(self, axes: Sequence[str]) -> int:
        return _prod(self.mesh, axes) if axes else 1

    @property
    def size(self) -> int:
        return int(self.mesh.size)


def current_mesh_context() -> Optional[MeshContext]:
    return getattr(_STATE, "ctx", None)


@contextlib.contextmanager
def use_mesh(mesh, rules: dict[str, tuple[str, ...]] | None = None):
    prev = getattr(_STATE, "ctx", None)
    _STATE.ctx = MeshContext(mesh=mesh, rules={**DEFAULT_RULES, **(rules or {})})
    try:
        yield _STATE.ctx
    finally:
        _STATE.ctx = prev


@contextlib.contextmanager
def use_mesh_context(ctx: MeshContext):
    """Activate an existing :class:`MeshContext` verbatim — no DEFAULT_RULES
    re-merge, so a context whose ``rules`` dict deliberately omits keys (a
    missing rule means *replicated*) keeps exactly that meaning."""
    prev = getattr(_STATE, "ctx", None)
    _STATE.ctx = ctx
    try:
        yield ctx
    finally:
        _STATE.ctx = prev


def mesh_context(mesh) -> Optional[MeshContext]:
    """A ``mesh`` argument -> the ``MeshContext`` it names, or None for
    local work: ``None`` reads the active ``use_mesh`` context, ``False``
    forces local, a ``RankMesh`` or a shape-only ``MeshShape`` gets the
    default rules; anything else raises ``TypeError``."""
    from repro_torch.launch.mesh import MeshShape, RankMesh
    if mesh is False:
        return None
    if mesh is None:
        return current_mesh_context()
    if isinstance(mesh, MeshContext):
        return mesh
    if isinstance(mesh, (RankMesh, MeshShape)):
        return MeshContext(mesh=mesh, rules=dict(DEFAULT_RULES))
    raise TypeError(f"mesh must be None, False, a MeshContext, a RankMesh "
                    f"or a MeshShape, got {type(mesh).__name__}")


def rank_mesh(mesh, what: str):
    """The ``RankMesh`` that ``mesh`` (one, or a ``MeshContext`` over one)
    runs ``what`` on. A shape-only ``MeshShape`` has no ranks and raises
    ``NotImplementedError`` naming ROADMAP item 16c; anything else raises
    ``TypeError``."""
    from repro_torch.launch.mesh import MeshShape, RankMesh
    m = mesh.mesh if isinstance(mesh, MeshContext) else mesh
    if isinstance(m, RankMesh):
        return m
    if isinstance(m, MeshShape):
        from repro_torch.core.acu import not_ported
        raise not_ported(f"{what} over the shape-only mesh {m!r} (a "
                         f"MeshShape has no ranks; use launch/mesh.py: "
                         f"make_host_multi_mesh)", "queue 1, item 16c")
    raise TypeError(f"mesh must be a RankMesh (launch/mesh.py) or a "
                    f"MeshContext over one, got {type(m).__name__}")


def shard(x, *logical: Optional[str]):
    """Annotate ``x`` with logical axes: the identity without an active
    mesh or on a mesh of one device; under a mesh of ranks, the layout is
    resolved (``MeshContext.spec`` with the tensor's sizes, which drops
    what does not divide) and ``x`` returned as it is; under a shape-only
    mesh of more devices, raises ``NotImplementedError``."""
    ctx = current_mesh_context()
    if ctx is None or ctx.size == 1:
        return x
    if len(logical) != x.dim():
        raise ValueError(f"{len(logical)} logical axes for a tensor of "
                         f"{x.dim()} dims")
    rank_mesh(ctx, f"sharding over {ctx.size} devices")
    ctx.spec(*logical, dim_sizes=tuple(x.shape))
    return x

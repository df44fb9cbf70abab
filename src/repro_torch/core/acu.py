"""Approximate Compute Units (port of ``repro.core.acu``).

An :class:`Acu` packages one approximate multiplier with an emulation mode:

* ``FUNCTIONAL``: the multiplier's closed form per scalar product, on the
  operands' device, reduced in K chunks of 32 (the paper's unoptimised
  baseline regime).
* ``LUT``: the (2^b, 2^b) product table, gathered either by the plain
  PyTorch LUT GEMM (``use_kernels=False``; ``lut_chunk=0`` is the paper's
  one-gather baseline) or by the hand-written CUDA kernels
  (``use_kernels=True``; ``fused=True`` for the single-kernel quantize ->
  LUT GEMM -> dequant routes). Bit-exact.
* ``LOWRANK``: an exact integer product plus a rank-r SVD correction of the
  error table (``kernels/err_matmul`` with ``use_kernels``). Near-exact,
  with a float32 result.
* ``FACTORED``: the truncation family's exact fast path, ``M[a,w] = (a & m)
  (w & m)``, one masked integer GEMM.
* ``EXACT``: no approximation (quantization only).

All GEMMs consume shifted-code integer operands (``code - zero_point``).
EXACT and FACTORED are integer GEMMs the reference leaves to XLA outside
any kernel; here they are a library call: ``torch._int_mm`` on int8 codes
(EXACT at up to 8 bits, on a card), a float64 product cast back to int32
(every other case on a card), ``torch.matmul`` on int32 on the CPU.

Dispatch is two-level, as in the reference: :func:`matmul_plan` (dense
GEMMs), :func:`matmul_bwd_plan` (the approximate STE gradient GEMMs),
:func:`conv_plan` (conv2d sites, with the backward route it implies),
:func:`attn_plan` (attention over a contiguous or paged KV cache) and
:func:`grouped_plan` (an MoE layer's expert GEMMs) resolve (mode, bits,
use_kernels, fused) to a route; a fused request on a non-LUT ACU resolves
unfused, a conv to ``im2col``, attention to ``dense`` and the expert GEMMs
to ``vmap``, each audited as in the reference. A conv takes the route the
reference's planner gives it, the whole-image or the banded fused kernel
by the reference's VMEM budget.

Every plan takes ``mesh``: ``None`` reads the active ``use_mesh`` context,
``False`` forces a local plan, a :class:`~repro_torch.parallel.sharding.
MeshContext` or a mesh pins one; anything else raises ``TypeError``. Under
a mesh of ranks (``launch/mesh.py: RankMesh``) a plan runs SPMD on global
operands through ``parallel/acu_shard.py``'s wraps, bitwise equal to the
local plan, and ``describe()["partition"]`` names its partition. Under a
shape-only ``MeshShape`` of more devices the partition is resolved and
reported, and calling the plan raises ``NotImplementedError``: such a mesh
has no ranks to run on.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import runtime
from repro_torch.parallel.sharding import mesh_context
from .lut import LowRankError, build_lut, factorize_error, trunc_masks
from .multipliers import Multiplier, get_multiplier


class AcuMode(enum.Enum):
    FUNCTIONAL = "functional"
    LUT = "lut"
    LOWRANK = "lowrank"
    FACTORED = "factored"
    EXACT = "exact"


def not_ported(what: str, queue: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md, {queue})")


# elements of one (rows, K-chunk, N) product block of the FUNCTIONAL GEMM:
# 64 MiB of int32 whatever the shape
_FUNCTIONAL_CHUNK_ELEMS = 1 << 24


def _int_mm_padded(a8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """``torch._int_mm`` of int8 operands on a card, padded with code 0 to
    its shape rules (more than 16 rows; K and N multiples of 8). A code-0
    row or column adds nothing to an exact product."""
    m, k = a8.shape
    n = w8.shape[1]
    pm, pk, pn = max(17 - m, 0), (-k) % 8, (-n) % 8
    if pm or pk:
        a8 = F.pad(a8, (0, pk, 0, pm))
    if pk or pn:
        w8 = F.pad(w8, (0, pn, 0, pk))
    return torch._int_mm(a8.contiguous(), w8.contiguous())[:m, :n]


def int_matmul(a: torch.Tensor, w: torch.Tensor, *,
               as_int8: bool) -> torch.Tensor:
    """The integer GEMM of EXACT and FACTORED: ``sum_k a * w`` in int32
    (wrapping as an int32 sum does). ``as_int8`` casts the operands to int8
    first, as the reference does for EXACT codes of at most 8 bits (a code
    outside int8 wraps there too)."""
    if a.device.type == "meta":         # shape rule: no data to multiply
        (m, k), n = a.shape, w.shape[1]
        runtime.count_work("int_mm", flops=2 * m * k * n,
                           bytes_=(m * k + k * n) * (1 if as_int8 else 4)
                           + m * n * 4)
        return runtime.meta_empty(m, n, dtype=torch.int32)
    if as_int8:
        a, w = a.to(torch.int8), w.to(torch.int8)
        if a.device.type == "cuda":
            return _int_mm_padded(a, w)
    if a.device.type == "cpu":
        return torch.matmul(a.to(torch.int32), w.to(torch.int32))
    from repro_torch.kernels.err_matmul.ref import exact_int_product
    return exact_int_product(a, w)


@dataclasses.dataclass(frozen=True)
class Acu:
    multiplier: Multiplier
    mode: AcuMode
    lut: Optional[np.ndarray] = None          # (2^b, 2^b) int32
    lowrank: Optional[LowRankError] = None    # LOWRANK factors
    mask: Optional[int] = None                # FACTORED operand mask
    use_kernels: bool = False                 # route GEMMs through CUDA kernels
    lut_chunk: int = 256                      # K-chunk for LUT gathers; 0 = the
                                              # paper's unoptimised baseline
                                              # (one (M, K, N) gather)
    fused: bool = False                       # default routing for approx_ops:
                                              # single-kernel quantize->LUT
                                              # GEMM->dequant (LUT + kernels)
    # device copies of the table and the factors, built once per device
    # (the table int32 for the plain versions, int16 for the kernels'
    # shared memory)
    _tables: dict = dataclasses.field(default_factory=dict, compare=False,
                                      repr=False, hash=False)
    # attention plans resolved so far, by (spec, a_bits); not an init
    # field, so dataclasses.replace starts an empty one
    _plans: dict = dataclasses.field(default_factory=dict, init=False,
                                     compare=False, repr=False, hash=False)

    @property
    def bits(self) -> int:
        return self.multiplier.bits

    @property
    def offset(self) -> int:
        return -self.multiplier.lo  # code shift into table index space

    def m00(self) -> int:
        """The product at shifted codes (0, 0): what every padded-K entry
        adds to an accumulator (0 for the exact-at-zero modes)."""
        if self.mode == AcuMode.LUT and self.lut is not None:
            return int(np.asarray(self.lut)[self.offset, self.offset])
        if self.mode in (AcuMode.EXACT, AcuMode.FACTORED, AcuMode.LOWRANK):
            return 0
        return int(self.multiplier(0, 0))

    def _device(self, device) -> torch.device:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev

    def device_lut(self, device) -> torch.Tensor:
        """The table on ``device``, flat: int32 on the CPU (plain versions),
        int16 on a CUDA device (the kernels' shared-memory copy, range
        checked once here)."""
        from repro_torch.kernels.runtime import lut_to_int16
        dev = self._device(device)
        key = str(dev)
        table = self._tables.get(key)
        if table is None:
            flat = torch.from_numpy(np.ascontiguousarray(
                self.lut, dtype=np.int32).reshape(-1))
            if dev.type == "cuda":
                flat = lut_to_int16(flat)
            table = self._tables[key] = flat.to(dev)
        return table

    def device_factors(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """The LOWRANK factors ``(f, g)`` on ``device``, float32
        (n_codes, r)."""
        dev = self._device(device)
        key = ("lowrank", str(dev))
        fg = self._tables.get(key)
        if fg is None:
            fg = self._tables[key] = tuple(
                torch.from_numpy(np.ascontiguousarray(t, np.float32)).to(dev)
                for t in (self.lowrank.f, self.lowrank.g))
        return fg

    # ------------------------------------------------------------------
    # elementwise multiply
    # ------------------------------------------------------------------
    def mul(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """The ACU's product of shifted codes ``a`` and ``w`` (broadcast):
        int32, float32 for LOWRANK."""
        if self.mode == AcuMode.EXACT:
            return a.to(torch.int32) * w.to(torch.int32)
        if self.mode == AcuMode.FACTORED:
            return (a & self.mask) * (w & self.mask)
        if self.mode == AcuMode.LUT:
            n = self.multiplier.n_codes
            tab = self.device_lut(a.device).to(torch.int32)
            return tab[(a.long() + self.offset) * n + (w.long() + self.offset)]
        if self.mode == AcuMode.LOWRANK:
            f, g = self.device_factors(a.device)
            exact = a.to(torch.float32) * w.to(torch.float32)
            return exact + (f[a.long() + self.offset]
                            * g[w.long() + self.offset]).sum(-1)
        return self.multiplier(a, w)

    # ------------------------------------------------------------------
    # GEMM: out[m, n] = sum_k M[a[m, k], w[k, n]]
    # ------------------------------------------------------------------
    def matmul(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Approximate GEMM on integer operands: int32, or float32 for
        LOWRANK. The unfused route of :func:`matmul_plan`."""
        return matmul_plan(self, fused=False)(a, w)

    def _lut_matmul_torch(self, a: torch.Tensor, w: torch.Tensor,
                          k_chunk: int = 256) -> torch.Tensor:
        """Plain PyTorch LUT GEMM, K-chunked (and row-chunked, so the
        gather index tensor stays small at any M)."""
        from repro_torch.kernels.lut_matmul.ref import lut_matmul_ref
        return lut_matmul_ref(a, w, self.device_lut(a.device),
                              self.offset, self.multiplier.n_codes,
                              k_chunk=k_chunk)

    def _lowrank_matmul_torch(self, a: torch.Tensor,
                              w: torch.Tensor) -> torch.Tensor:
        """Plain LOWRANK GEMM, the reference's arithmetic: the exact term
        on int8 codes in int32 (up to 8 bits) or on bfloat16-rounded codes
        in float32 (above: 12-bit codes round there, as in the reference),
        plus the gathered ``(M, K*r) @ (K*r, N)`` correction in float32."""
        from repro_torch.kernels.err_matmul.ref import error_correction
        from .approx_ops import exact_f32
        f, g = self.device_factors(a.device)
        with exact_f32():
            if self.bits <= 8:
                exact = int_matmul(a, w, as_int8=True).to(torch.float32)
            else:
                exact = torch.matmul(
                    a.to(torch.bfloat16).to(torch.float32),
                    w.to(torch.bfloat16).to(torch.float32))
            return exact + error_correction(a, w, f, g, self.offset)

    def _functional_matmul_torch(self, a: torch.Tensor, w: torch.Tensor,
                                 k_chunk: int = 32) -> torch.Tensor:
        """FUNCTIONAL GEMM: the closed form on every (m, k, n) product, in
        K chunks of ``k_chunk`` (K padded with code 0, the pad's ``M[0,
        0]`` subtracted after) and row chunks that bound the product block.
        int32 throughout, wrapping as the reference's int32 sums do (its
        ``jnp.int64`` accumulator is int32 without x64)."""
        m, k = a.shape
        n = w.shape[1]
        acc = torch.zeros((m, n), dtype=torch.int32, device=a.device)
        if k == 0:
            return acc
        k_chunk = min(k_chunk, k)
        pad = (-k) % k_chunk
        a = F.pad(a.to(torch.int32), (0, pad))
        w = F.pad(w.to(torch.int32), (0, 0, 0, pad))
        rows = max(1, _FUNCTIONAL_CHUNK_ELEMS // (k_chunk * max(n, 1)))
        for m0 in range(0, m, rows):
            blk = acc[m0:m0 + rows]
            for k0 in range(0, k + pad, k_chunk):
                prods = self.multiplier(a[m0:m0 + rows, k0:k0 + k_chunk, None],
                                        w[None, k0:k0 + k_chunk, :])
                blk += prods.sum(dim=1, dtype=torch.int32)
        if pad:
            acc -= pad * int(self.multiplier(0, 0))
        return acc


def _sharded(ctx, make: Callable[[], Callable]) -> Callable:
    """``make()``'s wrap where the mesh has ranks; under a shape-only mesh
    a callable that refuses (``parallel/sharding.py: rank_mesh``)."""
    from repro_torch.launch.mesh import RankMesh
    from repro_torch.parallel.sharding import rank_mesh
    if isinstance(ctx.mesh, RankMesh):
        return make()

    def refuse(*args, **kwargs):
        rank_mesh(ctx, "running a plan")
    return refuse


def describe_partition(part, kind: str = "gemm") -> Optional[str]:
    """A partition as the reference's ``describe()`` prints it, for a GEMM
    or conv, an attention (``"heads"``) or a grouped (``"blocks"``)
    plan."""
    if part is None:
        return None
    if kind == "heads":
        return (f"rows{part.rows}x heads{part.cols} "
                f"({part.n_rows}x{part.n_cols} way)")
    rows, cols = ("blocks", "experts") if kind == "blocks" else ("rows",
                                                                 "cols")
    return (f"{rows}{part.rows}x {cols}{part.cols}x k{part.k} "
            f"({part.n_rows}x{part.n_cols}x{part.n_k} way)")


def _lut_kernels(acu: Acu) -> bool:
    """Whether the LUT kernels (fused dense, fused conv, attention) can
    serve this ACU."""
    return acu.mode == AcuMode.LUT and acu.use_kernels and acu.lut is not None


# ---------------------------------------------------------------------------
# explicit dispatch layer: (mode, bits, use_kernels, fused) -> callable
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MatmulPlan:
    """A resolved GEMM route for one ACU.

    ``fused=False`` plans consume shifted integer operands and return the
    raw accumulator, int32 (float32 for LOWRANK): ``plan(a, w)``.
    ``fused=True`` plans run quantize -> LUT GEMM -> dequant in one kernel:
    ``plan(x, wq, x_scale, x_zp, w_scale) -> float32``. ``partition`` is
    the mesh partition the plan runs under (None: local), ``ctx`` its
    ``MeshContext``.
    """

    mode: AcuMode
    bits: int
    use_kernels: bool
    fused: bool
    fn: Callable[..., torch.Tensor]
    partition: Optional[object] = None     # parallel.planner.GemmPartition
    ctx: Optional[object] = None

    def __call__(self, *args) -> torch.Tensor:
        return self.fn(*args)


def _resolve_unfused(acu: Acu) -> Callable[[torch.Tensor, torch.Tensor],
                                           torch.Tensor]:
    """The unfused integer-operand GEMM for ``acu``: per mode, the CUDA
    kernel (LUT: ``lut_matmul``; LOWRANK: ``err_matmul``) with
    ``use_kernels``, else the plain PyTorch version."""
    if acu.mode == AcuMode.EXACT:
        as_int8 = acu.bits <= 8
        return lambda a, w: int_matmul(a, w, as_int8=as_int8)
    if acu.mode == AcuMode.FACTORED:
        return lambda a, w: int_matmul(a & acu.mask, w & acu.mask,
                                       as_int8=False)
    if acu.mode == AcuMode.LUT:
        if acu.lut is None:
            raise ValueError("LUT-mode ACU has no table")
        if acu.use_kernels:
            from repro_torch.kernels.lut_matmul.ops import lut_matmul
            return lambda a, w: lut_matmul(a, w, acu.device_lut(a.device),
                                           acu.offset)
        if acu.lut_chunk == 0:
            return lambda a, w: acu._lut_matmul_torch(
                a, w, k_chunk=max(1, a.shape[1]))
        return lambda a, w: acu._lut_matmul_torch(a, w, k_chunk=acu.lut_chunk)
    if acu.mode == AcuMode.LOWRANK:
        if acu.use_kernels:
            from repro_torch.kernels.err_matmul.ops import err_matmul
            return lambda a, w: err_matmul(a, w, *acu.device_factors(a.device),
                                           acu.offset)
        return acu._lowrank_matmul_torch
    return acu._functional_matmul_torch


def matmul_plan(acu: Acu, *, a_bits: Optional[int] = None,
                fused: Optional[bool] = None, mesh=None) -> MatmulPlan:
    """Resolve (mode, bits, use_kernels, fused) into a GEMM callable.

    ``a_bits`` is the activation code width a fused plan clips to (default:
    the ACU's operand width). A fused request that cannot be served (not
    LUT mode, no ``use_kernels``, no table) falls back to the unfused plan,
    as in the reference, so callers can ask for fusion unconditionally.
    Under a mesh (module docstring) rows shard over ``acu_rows``, columns
    over ``acu_cols`` and, opted in, the contraction over ``acu_k`` with
    an int32 sum before the dequant (LOWRANK's float accumulator drops
    ``acu_k``).
    """
    from repro_torch.parallel import acu_shard
    fused = acu.fused if fused is None else fused
    a_bits = acu.bits if a_bits is None else a_bits
    ctx = mesh_context(mesh)
    partition = None
    if ctx is not None:
        partition = acu_shard.resolve_partition(
            ctx, float_accum=acu.mode == AcuMode.LOWRANK)
    if fused and _lut_kernels(acu):
        from repro_torch.kernels.fused_lut_dense.ops import fused_lut_dense

        def fused_call(x, wq, x_scale, x_zp, w_scale, *, emit_acc=False):
            return fused_lut_dense(x, wq, acu.device_lut(x.device),
                                   acu.offset, x_scale, x_zp, w_scale,
                                   bits=a_bits, emit_acc=emit_acc)
        fn = fused_call
        if partition is not None:
            fn = _sharded(ctx, lambda: acu_shard.wrap_fused(
                fused_call, lambda *a: fused_call(*a, emit_acc=True), ctx,
                partition, acu.m00()))
        return MatmulPlan(mode=acu.mode, bits=acu.bits, use_kernels=True,
                          fused=True, fn=fn, partition=partition, ctx=ctx)
    fn = _resolve_unfused(acu)
    if partition is not None:
        base = fn
        fn = _sharded(ctx, lambda: acu_shard.wrap_unfused(
            base, ctx, partition, acu.m00()))
    return MatmulPlan(mode=acu.mode, bits=acu.bits,
                      use_kernels=acu.use_kernels, fused=False, fn=fn,
                      partition=partition, ctx=ctx)


def matmul_bwd_plan(acu: Acu, *, a_bits: Optional[int] = None,
                    fused: Optional[bool] = None, mesh=None
                    ) -> tuple[Callable[..., torch.Tensor],
                               Callable[..., torch.Tensor]]:
    """Resolve the *approximate* STE backward GEMM pair ``(gx_fn, gw_fn)``
    for one ACU; each is ``fn(a, b, sa, sb) -> f32 (M, N)``, the
    approximate GEMM of two float operands quantized per-tensor symmetric
    (zero point 0) with one combined-scale dequant ``acc * (sa * sb)``. The
    caller computes ``sa`` / ``sb`` on the full tensors.

    Fused (LUT + kernels) resolves to the in-kernel-quantizing
    ``fused_lut_bwd`` kernel; every other ACU quantizes outside,
    ``clip(round(a / sa))``, and runs its mode's unfused GEMM (LOWRANK with
    kernels: ``err_matmul``). For LUT the two are bitwise equal. The two
    callables differ only in their mesh partitions: each backward GEMM is
    the forward's with permuted roles (``planner.bwd_gemm_partitions``), so
    ``gx`` sums int32 partials over the forward's cols axes and ``gw`` over
    its rows axes before the one dequant. LOWRANK (a float accumulator)
    computes both locally under a mesh.
    """
    from repro_torch.parallel import acu_shard
    from .quantization import quantize_symmetric
    fused = acu.fused if fused is None else fused
    a_bits = acu.bits if a_bits is None else a_bits
    ctx = mesh_context(mesh)
    gx_part = gw_part = None
    if ctx is not None and acu.mode != AcuMode.LOWRANK:
        fwd_part = acu_shard.resolve_partition(ctx)
        if fwd_part is not None:
            from repro_torch.parallel.planner import bwd_gemm_partitions
            gx_part, gw_part = bwd_gemm_partitions(fwd_part)

    if fused and _lut_kernels(acu):
        from repro_torch.kernels.fused_lut_dense.ops import fused_lut_bwd

        def bwd_call(a, b, sa, sb, *, emit_acc=False):
            return fused_lut_bwd(a, b, acu.device_lut(a.device), acu.offset,
                                 sa, sb, bits=a_bits, emit_acc=emit_acc)

        def route(part):
            if part is None:
                return lambda a, b, sa, sb: bwd_call(a, b, sa, sb)
            return _sharded(ctx, lambda: acu_shard.wrap_fused_bwd(
                bwd_call, lambda *a: bwd_call(*a, emit_acc=True), ctx, part,
                acu.m00()))
        return route(gx_part), route(gw_part)

    base = _resolve_unfused(acu)

    def route(part):
        gemm = base
        if part is not None:
            gemm = _sharded(ctx, lambda: acu_shard.wrap_unfused(
                base, ctx, part, acu.m00()))

        def fn(a, b, sa, sb):
            acc = gemm(quantize_symmetric(a, sa, a_bits),
                       quantize_symmetric(b, sb, a_bits))
            return acc.to(torch.float32) * (sa * sb)
        return fn
    return route(gx_part), route(gw_part)


# ---------------------------------------------------------------------------
# conv planning layer
# ---------------------------------------------------------------------------

def resolve_conv_padding(padding, x_shape, w_shape, stride, dilation
                         ) -> tuple[tuple[int, int], tuple[int, int]]:
    """Normalise SAME/VALID/explicit conv padding to per-edge pairs, with
    XLA's SAME split (lo = total // 2), as the reference does."""
    if not isinstance(padding, str):
        (p0, p1) = tuple(padding)
        return (tuple(p0), tuple(p1))
    if padding.upper() == "VALID":
        return ((0, 0), (0, 0))
    if padding.upper() != "SAME":
        raise ValueError(f"unsupported padding {padding!r}")
    pads = []
    for d in range(2):
        size = x_shape[2 + d]
        eff_k = (w_shape[2 + d] - 1) * dilation[d] + 1
        out = -(-size // stride[d])
        total = max((out - 1) * stride[d] + eff_k - size, 0)
        pads.append((total // 2, total - total // 2))
    return (pads[0], pads[1])


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """Static geometry of one conv2d site. ``x_shape``: (N, Cin, H, W);
    ``w_shape``: (Cout, Cin/groups, kh, kw); ``padding``: explicit
    ((ph_lo, ph_hi), (pw_lo, pw_hi))."""

    x_shape: tuple[int, int, int, int]
    w_shape: tuple[int, int, int, int]
    stride: tuple[int, int] = (1, 1)
    padding: tuple[tuple[int, int], tuple[int, int]] = ((0, 0), (0, 0))
    dilation: tuple[int, int] = (1, 1)
    groups: int = 1

    @property
    def out_spatial(self) -> tuple[int, int]:
        from repro_torch.kernels.fused_lut_conv.ops import conv_out_size
        return (conv_out_size(self.x_shape[2], self.w_shape[2],
                              self.stride[0], self.dilation[0],
                              self.padding[0]),
                conv_out_size(self.x_shape[3], self.w_shape[3],
                              self.stride[1], self.dilation[1],
                              self.padding[1]))

    @property
    def gemm_shape(self) -> tuple[int, int, int]:
        """(M, K, N) of the implicit im2col GEMM."""
        ho, wo = self.out_spatial
        cout, cg, kh, kw = self.w_shape
        return (self.x_shape[0] * ho * wo, cg * kh * kw, cout)


def _conv_geometry_args(spec: ConvSpec) -> tuple:
    _, c, h, w = spec.x_shape
    cout, _, kh, kw = spec.w_shape
    return (c, h, w, cout, kh, kw, spec.stride[0], spec.stride[1],
            spec.dilation[0], spec.dilation[1], spec.padding)


def _fmt_vmem(nbytes: int) -> str:
    """Byte counts in the audit lines, as the reference prints them."""
    if nbytes >= (1 << 20):
        return f"{nbytes >> 20} MiB"
    return f"{nbytes >> 10} KiB"


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """A resolved conv2d route for one ACU at one static geometry.

    ``route`` is one of
    * ``"fused_conv"``: the whole-image fused conv kernel (kernel 5),
      ``fn(x, wq, xs, xz, ws) -> (N, Ho, Wo, Cout) f32``;
    * ``"tiled"``: the banded fused conv kernel (kernel 6), the same ``fn``
      signature and bits; ``tiling`` is its banding on this card
      (:class:`~repro_torch.kernels.fused_lut_conv.ops.TiledKernelTiling`);
    * ``"im2col"``: eager patch extraction + the dense
      :func:`matmul_plan` route (``fn`` is None);
    * ``"im2col_depthwise"`` / ``"im2col_grouped"``: ``groups > 1``, one
      dense GEMM against the block-diagonal weight, or one per group.

    ``bwd_route`` is where the approximate STE backward runs when
    ``ApproxConfig.approx_bwd`` asks for it: ``"banded"`` for both fused
    routes (the weight gradient on ``fused_lut_conv_bwd_w``, the input
    gradient on ``fused_lut_bwd`` with an integer col2im), None for the
    im2col routes, whose backward is the dense STE's. The port's kernel 7
    has no VMEM budget, so it is ``"banded"`` where the reference might
    fall back, with the same bits, and ``bwd_tiling`` is always None.
    ``describe()`` has the reference's keys, so plan reports of the two
    packages can be compared; ``tiling`` names kernel 6's banding and
    ``partition`` the mesh partition: the ``acu_conv`` one for the fused
    routes, the dense GEMM's for the im2col routes (None: local). ``ctx``
    is the ``MeshContext`` the plan runs under.
    """

    mode: AcuMode
    bits: int
    use_kernels: bool
    fused: bool
    route: str
    spec: ConvSpec
    fn: Optional[Callable[..., torch.Tensor]] = None
    report: tuple[str, ...] = ()
    tiling: Optional[object] = None
    bwd_route: Optional[str] = None
    bwd_tiling: Optional[tuple[int, int, int, int]] = None
    partition: Optional[object] = None
    ctx: Optional[object] = None

    def __call__(self, *args) -> torch.Tensor:
        if self.fn is None:
            raise ValueError(f"route {self.route} has no direct kernel")
        return self.fn(*args)

    def describe(self) -> dict:
        m, k, n = self.spec.gemm_shape
        return {
            "route": self.route,
            "bwd_route": self.bwd_route,
            "mode": self.mode.value,
            "fused": self.fused,
            "gemm": f"M={m} K={k} N={n}",
            "tiling": None if self.tiling is None else
                self.tiling.describe(self.spec.out_spatial[0]),
            "partition": describe_partition(self.partition),
            "report": list(self.report) + (list(self.partition.report)
                                           if self.partition else []),
        }


def conv_plan(acu: Acu, spec: ConvSpec, *, a_bits: Optional[int] = None,
              fused: Optional[bool] = None, mesh=None,
              route: Optional[str] = None,
              vmem_budget: Optional[int] = None) -> ConvPlan:
    """Resolve one conv2d site to the route the reference resolves.

    A fused request on a LUT ACU with ``use_kernels`` and a table takes
    ``"fused_conv"`` (kernel 5) when the reference's whole-image VMEM
    estimate fits ``vmem_budget`` (default ``CONV_VMEM_BUDGET``, 12 MiB),
    ``"tiled"`` (kernel 6) when only a band fits, and ``"im2col"`` with an
    audit line when not even a one-row band does (degenerate geometry).
    The budget is the reference's TPU threshold, used here only so that
    both packages take the same route: neither CUDA kernel needs it.
    ``groups > 1`` takes ``"im2col_depthwise"`` (groups == Cin, one input
    channel per group) or ``"im2col_grouped"``; any other conv, or a fused
    request the kernels cannot serve, takes ``"im2col"``, with the
    reference's audit lines in ``report``. ``route`` pins one:
    ``"im2col"`` forces the eager path (the oracle); ``"fused_conv"`` and
    ``"tiled"`` raise where the reference raises, instead of falling back.
    Under a mesh the fused routes run ``parallel/acu_shard.py:
    wrap_fused_conv`` (batch x output-row bands over ``acu_conv_rows``,
    output channels over ``acu_conv_cols``, input channels over an opted-in
    ``acu_conv_k``).
    """
    from repro_torch.kernels.fused_lut_conv import ops as cops
    from repro_torch.parallel import acu_shard
    ctx = mesh_context(mesh)
    if route not in (None, "fused_conv", "tiled", "im2col"):
        raise ValueError(f"unknown conv route {route!r}")
    fused = acu.fused if fused is None else fused
    a_bits = acu.bits if a_bits is None else a_bits
    budget = cops.CONV_VMEM_BUDGET if vmem_budget is None else vmem_budget
    report: list[str] = []
    cout, cin_g, kh, kw = spec.w_shape
    cin = spec.x_shape[1]
    want_fused = fused or route in ("fused_conv", "tiled")
    can_fuse = True
    if spec.groups != 1:
        can_fuse = False
        if want_fused:
            report.append(f"groups={spec.groups}: fused conv serves groups=1 "
                          f"only; grouped route keeps the single-vmapped-GEMM "
                          f"semantics")
    if not _lut_kernels(acu):
        can_fuse = False
        if want_fused and spec.groups == 1:
            report.append(f"fused conv needs LUT mode + use_kernels + a built "
                          f"table (have mode={acu.mode.value}, "
                          f"use_kernels={acu.use_kernels})")
    if route == "im2col":
        can_fuse = False
        report.append("route pinned to eager im2col by caller")

    whole_ok = False
    ref_tiling = None
    if can_fuse and want_fused:
        n_codes = acu.multiplier.n_codes
        geom = _conv_geometry_args(spec)
        est = cops.conv_vmem_bytes(*geom, n_codes)
        whole_ok = est <= budget
        if route == "tiled" or not whole_ok:
            ref_tiling = cops.pick_conv_spatial_tiling(*geom, n_codes,
                                                       budget=budget)
        if not whole_ok:
            if ref_tiling is not None:
                _, bh, _, n_copies = ref_tiling
                ho, _ = spec.out_spatial
                report.append(
                    f"image working set ~{_fmt_vmem(est)} exceeds the "
                    f"{_fmt_vmem(budget)} VMEM budget; spatially tiled over "
                    f"output-row bands (bands of {bh} output rows, "
                    f"{-(-ho // bh)} bands, {n_copies} halo blocks/band)")
            else:
                report.append(
                    f"image working set ~{_fmt_vmem(est)} exceeds the "
                    f"{_fmt_vmem(budget)} VMEM budget and even a one-row "
                    f"band does not fit (degenerate geometry); falling "
                    f"back to eager im2col")
        elif route == "tiled":
            report.append("route pinned to spatially-tiled kernel by caller")

    if route == "fused_conv" and not (can_fuse and whole_ok):
        raise ValueError(f"fused_conv route unavailable: {report}")
    if route == "tiled" and not (can_fuse and ref_tiling is not None):
        raise ValueError(f"tiled route unavailable: {report}")
    serve_tiled = can_fuse and want_fused and ref_tiling is not None \
        and (route == "tiled" or not whole_ok)
    serve_whole = can_fuse and want_fused and whole_ok and route != "tiled"

    if serve_whole or serve_tiled:
        geom_kw = dict(stride=spec.stride, padding=spec.padding,
                       dilation=spec.dilation, bits=a_bits)
        tiling = None
        kernel_fn = cops.fused_lut_conv
        if serve_tiled:
            # what the wrapper picks for the same geometry
            ho, wo = spec.out_spatial
            tiling = cops.pick_tiled_kernel_tiling(
                cin, ho, wo, cout, kh, kw, *spec.stride, *spec.dilation,
                acu.multiplier.n_codes)
            kernel_fn = cops.fused_lut_conv_tiled

        def fused_call(x, wq, xs, xz, ws, *, emit_acc=False, padding=None):
            # ``padding`` overrides the spec's: the banded mesh wrap passes
            # pre-padded row slabs with zero row padding
            kw = dict(geom_kw)
            if padding is not None:
                kw["padding"] = padding
            return kernel_fn(x, wq, acu.device_lut(x.device), acu.offset,
                             xs, xz, ws, emit_acc=emit_acc, **kw)

        partition = None
        fn = fused_call
        if ctx is not None:
            partition = acu_shard.resolve_conv_partition(
                ctx, float_accum=acu.mode == AcuMode.LOWRANK)
        if partition is not None:
            fn = _sharded(ctx, lambda: acu_shard.wrap_fused_conv(
                fused_call, lambda *a, **k: fused_call(*a, emit_acc=True,
                                                       **k),
                ctx, partition, acu.m00(), kh * kw, spec=spec))
        return ConvPlan(mode=acu.mode, bits=acu.bits, use_kernels=True,
                        fused=True,
                        route="tiled" if serve_tiled else "fused_conv",
                        spec=spec, fn=fn, report=tuple(report),
                        tiling=tiling, bwd_route="banded",
                        partition=partition, ctx=ctx)

    if spec.groups == 1:
        r = "im2col"
    elif spec.groups == cin and cin_g == 1:
        r = "im2col_depthwise"
    else:
        r = "im2col_grouped"
    partition = None
    if ctx is not None:
        partition = acu_shard.resolve_partition(
            ctx, float_accum=acu.mode == AcuMode.LOWRANK)
    return ConvPlan(mode=acu.mode, bits=acu.bits, use_kernels=acu.use_kernels,
                    fused=fused, route=r, spec=spec, report=tuple(report),
                    partition=partition, ctx=ctx)


# ---------------------------------------------------------------------------
# attention planning layer: GQA geometry x (mode, bits, use_kernels)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnSpec:
    """Static geometry of one attention site. ``hq``/``hkv``: query / KV
    head counts (``hq % hkv == 0``); ``causal``/``window``/``softcap``: the
    mask and logit statics. ``kv_layout`` is ``"contiguous"`` (per-row
    ``(B, Hkv, Sk, D)`` K/V) or ``"paged"`` (a shared ``(Hkv, P, bk, D)``
    block pool read through a page table); ``bk`` is the pool's block size
    there (the contiguous kernel derives its tiles from the sequence)."""

    hq: int
    hkv: int
    causal: bool = True
    window: Optional[int] = None
    softcap: Optional[float] = None
    bk: Optional[int] = None
    kv_layout: str = "contiguous"


@dataclasses.dataclass(frozen=True)
class AttnPlan:
    """A resolved attention route for one ACU at one static geometry.

    * ``"fused_attn"``: the approximate flash attention kernel (kernel 8),
      ``fn(q, k, v, q_scale, k_scale, v_scale, rowinfo) -> (B, Hq, Sq, D)
      f32`` with ``q`` (B, Hq, Sq, D), ``k``/``v`` (B, Hkv, Sk, D) (views
      are fine), scales computed by the caller on the full tensors and
      ``rowinfo`` (B, 3) int32 ``[q_base, kv_start, kv_len]`` (None = the
      end-aligned default);
    * ``"fused_attn_paged"``: the same over a block pool (kernel 9),
      ``fn(q, k_pool, v_pool, q_scale, k_scale, v_scale, rowinfo,
      page_table)`` with ``(Hkv, P, bk, D)`` pools and a (B, n_logical)
      page table; ``rowinfo`` required;
    * ``"dense"``: the audited fallback (not a LUT ACU on the kernels, or
      no table): ``fn`` is None and the caller keeps its exact float
      attention, gathering pool blocks first when paged.

    ``use_kernels`` plays the part of the reference's ``use_pallas``; a
    CPU tensor takes the kernels' plain versions, as everywhere.
    ``describe()`` has the reference's keys; ``partition`` is the
    ``acu_attn`` partition under a mesh (None: local).
    """

    mode: AcuMode
    bits: int
    use_kernels: bool
    route: str
    spec: AttnSpec
    fn: Optional[Callable[..., torch.Tensor]] = None
    report: tuple[str, ...] = ()
    partition: Optional[object] = None

    def __call__(self, *args) -> torch.Tensor:
        if self.fn is None:
            raise ValueError(f"route {self.route} has no direct kernel")
        return self.fn(*args)

    def describe(self) -> dict:
        return {
            "route": self.route,
            "mode": self.mode.value,
            "heads": f"hq={self.spec.hq} hkv={self.spec.hkv} "
                     f"(rep={self.spec.hq // self.spec.hkv})",
            "kv_layout": self.spec.kv_layout
                + (f" (block={self.spec.bk})"
                   if self.spec.kv_layout == "paged" else ""),
            "mask": f"causal={self.spec.causal} window={self.spec.window} "
                    f"softcap={self.spec.softcap}",
            "partition": describe_partition(self.partition, "heads"),
            "report": list(self.report) + (list(self.partition.report)
                                           if self.partition else []),
        }


def attn_plan(acu: Acu, spec: AttnSpec, *, a_bits: Optional[int] = None,
              mesh=None) -> AttnPlan:
    """Resolve one attention site to a route, with the reference's audited
    fallback: an ACU that cannot run the approximate kernel (not LUT mode,
    no ``use_kernels``, no table) resolves to ``"dense"`` and attention
    stays exact. Under a mesh, batch rows shard over ``acu_attn_rows`` and
    KV heads (whole GQA groups) over ``acu_attn_heads``
    (``acu_shard.wrap_attn``). A plan depends only on static geometry and
    the mesh, so the ACU keeps each one it resolves and hands it out
    again."""
    a_bits = acu.bits if a_bits is None else a_bits
    ctx = mesh_context(mesh)
    key = (spec, a_bits, None if ctx is None else
           (id(ctx.mesh), tuple(sorted(ctx.rules.items()))))
    plan = acu._plans.get(key)
    if plan is None:
        plan = acu._plans[key] = _resolve_attn(acu, spec, a_bits, ctx)
    return plan


def _resolve_attn(acu: Acu, spec: AttnSpec, a_bits: int,
                  ctx=None) -> AttnPlan:
    report: list[str] = []
    if spec.hq % spec.hkv != 0:
        raise ValueError(f"hq={spec.hq} not a multiple of hkv={spec.hkv}")
    if spec.kv_layout not in ("contiguous", "paged"):
        raise ValueError(f"unknown kv_layout {spec.kv_layout!r}")
    paged = spec.kv_layout == "paged"
    if not _lut_kernels(acu):
        report.append(f"fused attention needs LUT mode + use_kernels + a "
                      f"built table (have mode={acu.mode.value}, "
                      f"use_kernels={acu.use_kernels}); attention stays "
                      f"exact")
        if paged:
            report.append("paged KV on the dense route: caller gathers pool "
                          "blocks to a contiguous layout (exact math is "
                          "layout-independent)")
        return AttnPlan(mode=acu.mode, bits=acu.bits,
                        use_kernels=acu.use_kernels, route="dense",
                        spec=spec, report=tuple(report))

    from repro_torch.kernels.flash_attention.ops import (
        approx_flash_attention, approx_flash_attention_paged)
    from repro_torch.parallel import acu_shard
    kw = dict(bits=a_bits, causal=spec.causal, window=spec.window,
              softcap=spec.softcap)
    rep = spec.hq // spec.hkv

    # the kernels on (B, Hq, Sq, D) operands with per-batch-row rowinfo;
    # the head count of the call is q's (a mesh rank's is a slice)
    def attn_call(q, k, v, qs, ks, vs, rowinfo=None):
        b, hq, sq, d = q.shape
        out = approx_flash_attention(
            q, k, v, acu.device_lut(q.device), acu.offset, qs, ks, vs,
            rowinfo=rowinfo, row_heads=hq, **kw)
        return out.reshape(b, hq, sq, d)

    def attn_call_paged(q, k_pool, v_pool, qs, ks, vs, rowinfo, page_table):
        b, hq, sq, d = q.shape
        out = approx_flash_attention_paged(
            q, k_pool, v_pool, acu.device_lut(q.device), acu.offset, qs, ks,
            vs, rowinfo=rowinfo, page_table=page_table, rep=rep,
            row_heads=hq, **kw)
        return out.reshape(b, hq, sq, d)

    partition = None
    if ctx is not None:
        partition = acu_shard.resolve_attn_partition(ctx, hq=spec.hq,
                                                     hkv=spec.hkv)
    fn = attn_call_paged if paged else attn_call
    if partition is not None and paged:
        fn = _sharded(ctx, lambda: acu_shard.wrap_attn_paged(
            attn_call_paged, ctx, partition, hq=spec.hq, hkv=spec.hkv))
    elif partition is not None:
        def make():
            sharded = acu_shard.wrap_attn(attn_call, ctx, partition,
                                          hq=spec.hq, hkv=spec.hkv)

            def fn(q, k, v, qs, ks, vs, rowinfo=None):
                if rowinfo is None:   # end-aligned over the whole keys
                    sq, sk = q.shape[2], k.shape[2]
                    rowinfo = torch.tensor(
                        [sk - sq, 0, sk], dtype=torch.int32,
                        device=q.device).expand(q.shape[0], 3)
                return sharded(q, k, v, qs, ks, vs,
                               rowinfo.to(torch.int32))
            return fn
        fn = _sharded(ctx, make)

    return AttnPlan(mode=acu.mode, bits=acu.bits, use_kernels=True,
                    route="fused_attn_paged" if paged else "fused_attn",
                    spec=spec, fn=fn, report=tuple(report),
                    partition=partition)


# ---------------------------------------------------------------------------
# grouped ragged GEMM plan (MoE expert dispatch)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GroupedSpec:
    """Static geometry of one MoE grouped-GEMM site. ``n_experts``: E;
    ``cap``: capacity rows per (dispatch block, expert) group;
    ``d_in``/``d_out``: the GEMM's contraction and output widths;
    ``n_blocks``: the dispatch block count ``nb`` the router resolved
    (``models/moe.dispatch_geometry``). The grouped operand has ``G =
    n_blocks * n_experts`` groups; group ``g`` multiplies expert ``g %
    n_experts``."""

    n_experts: int
    cap: int
    d_in: int
    d_out: int
    n_blocks: int = 1


@dataclasses.dataclass(frozen=True)
class GroupedPlan:
    """A resolved grouped ragged GEMM route for one ACU at one geometry.

    * ``"fused_grouped"``: the ragged grouped fused LUT-GEMM kernel (kernel
      10), one launch per projection for every group: ``fn(xe, wq, xs, xz,
      ws, counts) -> (G, cap, d_out) f32`` with ``xe`` (G, cap, d_in) float
      dispatched activations, ``wq`` (E, d_in, d_out) shifted int weight
      codes, ``xs``/``xz`` one activation scale shared by every group,
      ``ws`` (E, d_out) per-expert weight scales and ``counts`` (G,) int32
      live rows; rows ``>= counts[g]`` are exactly 0.0.
    * ``"vmap"``: the audited fallback (not a LUT ACU on the kernels, or no
      table): ``fn`` is None and the caller runs the per-expert
      ``approx_dense`` composition masked to the live rows, which is also
      the fused route's bitwise oracle.

    ``use_kernels`` plays the part of the reference's ``use_pallas``.
    ``describe()`` has the reference's keys; ``partition`` is the
    ``acu_grouped`` partition under a mesh (None: local).
    """

    mode: AcuMode
    bits: int
    use_kernels: bool
    route: str
    spec: GroupedSpec
    fn: Optional[Callable[..., torch.Tensor]] = None
    report: tuple[str, ...] = ()
    partition: Optional[object] = None

    def __call__(self, *args) -> torch.Tensor:
        if self.fn is None:
            raise ValueError(f"route {self.route} has no direct kernel")
        return self.fn(*args)

    def describe(self) -> dict:
        s = self.spec
        return {
            "route": self.route,
            "mode": self.mode.value,
            "experts": s.n_experts,
            "cap": s.cap,
            "n_blocks": s.n_blocks,
            "gemm": f"({s.n_blocks}x{s.n_experts}, {s.cap}, {s.d_in}) x "
                    f"({s.n_experts}, {s.d_in}, {s.d_out})",
            "partition": describe_partition(self.partition, "blocks"),
            "report": list(self.report) + (list(self.partition.report)
                                           if self.partition else []),
        }


def grouped_plan(acu: Acu, spec: GroupedSpec, *, a_bits: Optional[int] = None,
                 mesh=None, route: Optional[str] = None) -> GroupedPlan:
    """Resolve one MoE grouped-GEMM site to a route, with the reference's
    audited fallback: an ACU that cannot run the grouped kernel (not LUT
    mode, no ``use_kernels``, no table) resolves to ``"vmap"``. The route
    does not depend on ``fused``. ``route`` pins one: ``"fused_grouped"``
    raises if the kernel cannot serve the ACU, ``"vmap"`` forces the
    per-expert composition (the oracle). Under a mesh, experts shard over
    ``acu_grouped_experts`` and dispatch blocks over ``acu_grouped_rows``
    (``acu_shard.wrap_fused_grouped``)."""
    from repro_torch.parallel import acu_shard
    ctx = mesh_context(mesh)
    a_bits = acu.bits if a_bits is None else a_bits
    if route not in (None, "fused_grouped", "vmap"):
        raise ValueError(f"unknown grouped route {route!r}")
    report: list[str] = []
    can_fuse = _lut_kernels(acu)
    if not can_fuse and route != "vmap":
        report.append(f"fused grouped GEMM needs LUT mode + use_kernels + a "
                      f"built table (have mode={acu.mode.value}, "
                      f"use_kernels={acu.use_kernels}); expert GEMMs stay on "
                      f"the per-expert vmapped route")
    if route == "fused_grouped" and not can_fuse:
        raise ValueError(f"fused_grouped route unavailable: {report}")
    if route == "vmap" or not can_fuse:
        if route == "vmap":
            report.append("route pinned to per-expert vmap by caller")
        return GroupedPlan(mode=acu.mode, bits=acu.bits,
                           use_kernels=acu.use_kernels, route="vmap",
                           spec=spec, report=tuple(report))

    from repro_torch.kernels.fused_lut_grouped.ops import fused_lut_grouped

    def grouped_call(xe, wq, xs, xz, ws, counts, *, emit_acc=False):
        return fused_lut_grouped(xe, wq, acu.device_lut(xe.device),
                                 acu.offset, xs, xz, ws, counts, bits=a_bits,
                                 emit_acc=emit_acc)

    partition = None
    fn = grouped_call
    if ctx is not None:
        partition = acu_shard.resolve_grouped_partition(
            ctx, n_experts=spec.n_experts, n_blocks=spec.n_blocks)
    if partition is not None:
        fn = _sharded(ctx, lambda: acu_shard.wrap_fused_grouped(
            grouped_call, lambda *a: grouped_call(*a, emit_acc=True), ctx,
            partition, acu.m00(), n_experts=spec.n_experts))
    return GroupedPlan(mode=acu.mode, bits=acu.bits, use_kernels=True,
                       route="fused_grouped", spec=spec, fn=fn,
                       report=tuple(report), partition=partition)


def make_acu(name: str, mode: AcuMode | str = AcuMode.LUT, rank: int = 8,
             use_kernels: bool = False, fused: bool = False) -> Acu:
    """Build an ACU from a registered multiplier name.

    Large-bitwidth LUT requests fall back to FUNCTIONAL, as in the
    reference (paper §3.4: a 12-bit table would be 64 MiB). LOWRANK
    factorises the error table at ``rank``; FACTORED needs a truncation
    multiplier and raises ``ValueError`` for any other.
    """
    mult = get_multiplier(name)
    mode = AcuMode(mode) if isinstance(mode, str) else mode
    lut = lowrank = mask = None
    if mode == AcuMode.LUT:
        if mult.bits > 10:
            mode = AcuMode.FUNCTIONAL
        else:
            lut = build_lut(mult)
    if mode == AcuMode.LOWRANK:
        lowrank = factorize_error(mult, rank)
    if mode == AcuMode.FACTORED:
        mask = trunc_masks(mult)
        if mask is None:
            raise ValueError(f"{name} has no algebraic factorization; "
                             f"use LUT or LOWRANK")
    return Acu(multiplier=mult, mode=mode, lut=lut, lowrank=lowrank,
               mask=mask, use_kernels=use_kernels, fused=fused)

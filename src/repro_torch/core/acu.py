"""Approximate Compute Units (port of ``repro.core.acu``, single device,
LUT mode).

An :class:`Acu` packages one approximate multiplier with an emulation mode.
The port runs LUT mode: the (2^b, 2^b) product table, gathered either by
the plain PyTorch LUT GEMM (``use_kernels=False``) or by the hand-written
CUDA kernels (``use_kernels=True``; ``fused=True`` for the single-kernel
quantize -> LUT GEMM -> dequant routes). All GEMMs consume shifted-code
integer operands (``code - zero_point``).

Dispatch is two-level, as in the reference: :func:`matmul_plan` (dense
GEMMs), :func:`matmul_bwd_plan` (the approximate STE gradient GEMMs),
:func:`conv_plan` (conv2d sites, with the backward route it implies) and
:func:`attn_plan` (attention over a contiguous or paged KV cache) resolve
(mode, bits, use_kernels, fused) to a route. The other modes
(EXACT, FUNCTIONAL, LOWRANK, FACTORED), the spatially tiled conv route,
grouped convs and mesh partitions are not ported yet: asking for one
raises ``NotImplementedError`` naming the ROADMAP queue that holds it,
never a different answer.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Optional

import numpy as np
import torch

from .lut import build_lut
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


@dataclasses.dataclass(frozen=True)
class Acu:
    multiplier: Multiplier
    mode: AcuMode
    lut: Optional[np.ndarray] = None          # (2^b, 2^b) int32
    use_kernels: bool = False                 # route GEMMs through CUDA kernels
    lut_chunk: int = 256                      # K-chunk for LUT gathers; 0 = the
                                              # paper's unoptimised baseline
                                              # (one (M, K, N) gather)
    fused: bool = False                       # default routing for approx_ops:
                                              # single-kernel quantize->LUT
                                              # GEMM->dequant (LUT + kernels)
    # device copies of the table, built once per device (int32 for the
    # plain versions, int16 for the kernels' shared memory)
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
        adds to an accumulator."""
        if self.lut is not None:
            return int(np.asarray(self.lut)[self.offset, self.offset])
        return int(self.multiplier(0, 0))

    def device_lut(self, device) -> torch.Tensor:
        """The table on ``device``, flat: int32 on the CPU (plain versions),
        int16 on a CUDA device (the kernels' shared-memory copy, range
        checked once here)."""
        from repro_torch.kernels.runtime import lut_to_int16
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        key = str(dev)
        table = self._tables.get(key)
        if table is None:
            flat = torch.from_numpy(np.ascontiguousarray(
                self.lut, dtype=np.int32).reshape(-1))
            if dev.type == "cuda":
                flat = lut_to_int16(flat)
            table = self._tables[key] = flat.to(dev)
        return table

    def _lut_matmul_torch(self, a: torch.Tensor, w: torch.Tensor,
                          k_chunk: int = 256) -> torch.Tensor:
        """Plain PyTorch LUT GEMM, K-chunked (and row-chunked, so the
        gather index tensor stays small at any M)."""
        from repro_torch.kernels.lut_matmul.ref import lut_matmul_ref
        return lut_matmul_ref(a, w, self.device_lut(a.device),
                              self.offset, self.multiplier.n_codes,
                              k_chunk=k_chunk)


def _require_lut(acu: Acu) -> None:
    if acu.mode != AcuMode.LUT:
        raise not_ported(f"ACU mode {acu.mode.value!r}",
                         "queue 1, item 4 (core/acu.py, dense part)")
    if acu.lut is None:
        raise ValueError("LUT-mode ACU has no table")


def _require_single_device(mesh) -> None:
    if mesh not in (None, False):
        raise not_ported("mesh partitioning", "queue 1, item 16")


# ---------------------------------------------------------------------------
# explicit dispatch layer: (mode, bits, use_kernels, fused) -> callable
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MatmulPlan:
    """A resolved GEMM route for one ACU.

    ``fused=False`` plans consume shifted integer operands and return the
    raw int32 accumulator: ``plan(a, w)``. ``fused=True`` plans run quantize
    -> LUT GEMM -> dequant in one kernel: ``plan(x, wq, x_scale, x_zp,
    w_scale) -> float32``.
    """

    mode: AcuMode
    bits: int
    use_kernels: bool
    fused: bool
    fn: Callable[..., torch.Tensor]

    def __call__(self, *args) -> torch.Tensor:
        return self.fn(*args)


def _resolve_unfused(acu: Acu) -> Callable[[torch.Tensor, torch.Tensor],
                                           torch.Tensor]:
    """The unfused integer-operand GEMM for ``acu``: the CUDA kernel, the
    K-chunked plain version, or (``lut_chunk=0``) the paper's unoptimised
    one-gather baseline."""
    _require_lut(acu)
    if acu.use_kernels:
        from repro_torch.kernels.lut_matmul.ops import lut_matmul
        return lambda a, w: lut_matmul(a, w, acu.device_lut(a.device),
                                       acu.offset)
    if acu.lut_chunk == 0:
        return lambda a, w: acu._lut_matmul_torch(a, w,
                                                  k_chunk=max(1, a.shape[1]))
    return lambda a, w: acu._lut_matmul_torch(a, w, k_chunk=acu.lut_chunk)


def matmul_plan(acu: Acu, *, a_bits: Optional[int] = None,
                fused: Optional[bool] = None, mesh=None) -> MatmulPlan:
    """Resolve (mode, bits, use_kernels, fused) into a GEMM callable.

    ``a_bits`` is the activation code width a fused plan clips to (default:
    the ACU's operand width). A fused request without ``use_kernels`` falls
    back to the unfused plan, as in the reference, so callers can ask for
    fusion unconditionally.
    """
    _require_single_device(mesh)
    _require_lut(acu)
    fused = acu.fused if fused is None else fused
    a_bits = acu.bits if a_bits is None else a_bits
    if fused and acu.use_kernels:
        from repro_torch.kernels.fused_lut_dense.ops import fused_lut_dense

        def fused_call(x, wq, x_scale, x_zp, w_scale, *, emit_acc=False):
            return fused_lut_dense(x, wq, acu.device_lut(x.device),
                                   acu.offset, x_scale, x_zp, w_scale,
                                   bits=a_bits, emit_acc=emit_acc)

        return MatmulPlan(mode=acu.mode, bits=acu.bits, use_kernels=True,
                          fused=True, fn=fused_call)
    return MatmulPlan(mode=acu.mode, bits=acu.bits,
                      use_kernels=acu.use_kernels, fused=False,
                      fn=_resolve_unfused(acu))


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
    ``fused_lut_bwd`` kernel; otherwise the operands are quantized outside,
    ``clip(round(a / sa))``, and run the unfused integer GEMM. The two are
    bitwise equal. Single device: the reference's two callables differ only
    in their mesh partitions, so here they are one function.
    """
    from .quantization import quantize_symmetric
    _require_single_device(mesh)
    _require_lut(acu)
    fused = acu.fused if fused is None else fused
    a_bits = acu.bits if a_bits is None else a_bits
    if fused and acu.use_kernels:
        from repro_torch.kernels.fused_lut_dense.ops import fused_lut_bwd

        def fn(a, b, sa, sb):
            return fused_lut_bwd(a, b, acu.device_lut(a.device), acu.offset,
                                 sa, sb, bits=a_bits)
        return fn, fn

    gemm = _resolve_unfused(acu)

    def fn(a, b, sa, sb):
        acc = gemm(quantize_symmetric(a, sa, a_bits),
                   quantize_symmetric(b, sb, a_bits))
        return acc.to(torch.float32) * (sa * sb)
    return fn, fn


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


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """A resolved conv2d route for one ACU at one static geometry.

    ``route`` is ``"fused_conv"`` (the fused CUDA conv kernel:
    ``fn(x, wq, xs, xz, ws) -> (N, Ho, Wo, Cout) f32``) or ``"im2col"``
    (eager patch extraction + the dense :func:`matmul_plan` route; ``fn``
    is None). ``bwd_route`` is where the approximate STE backward runs when
    ``ApproxConfig.approx_bwd`` asks for it: ``"banded"`` for every fused
    plan (the weight gradient on ``fused_lut_conv_bwd_w``, the input
    gradient on ``fused_lut_bwd`` with an integer col2im), None for im2col
    plans, whose backward is the dense STE's. ``bwd_tiling`` is the
    reference's VMEM banding ``(bh, bn, mc, n_copies)``; the port's
    backward runs one band with no VMEM model, so it is always None.
    ``describe()`` has the reference's keys, so plan reports of the two
    packages can be compared; ``tiling`` and ``partition`` are None (no
    tiled route or mesh yet).
    """

    mode: AcuMode
    bits: int
    use_kernels: bool
    fused: bool
    route: str
    spec: ConvSpec
    fn: Optional[Callable[..., torch.Tensor]] = None
    report: tuple[str, ...] = ()
    bwd_route: Optional[str] = None
    bwd_tiling: Optional[tuple[int, int, int, int]] = None

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
            "tiling": None,
            "partition": None,
            "report": list(self.report),
        }


def conv_plan(acu: Acu, spec: ConvSpec, *, a_bits: Optional[int] = None,
              fused: Optional[bool] = None, mesh=None,
              route: Optional[str] = None) -> ConvPlan:
    """Resolve one conv2d site to a route.

    The rule, with no shared-memory budget in it: a ``groups=1`` conv on a
    LUT ACU with ``use_kernels`` and ``fused`` takes ``"fused_conv"``
    whatever its image size, because the CUDA kernel tiles output pixels
    across the batch and never needs a whole image on chip; its backward
    route is ``"banded"``, for the same reason with no budget either. Every
    other LUT conv takes ``"im2col"`` (recorded in ``report``). ``route`` pins
    one: ``"im2col"`` forces the eager path (the oracle), ``"fused_conv"``
    raises if the kernel cannot serve the request, ``"tiled"`` is not
    ported.
    """
    _require_single_device(mesh)
    if route not in (None, "fused_conv", "tiled", "im2col"):
        raise ValueError(f"unknown conv route {route!r}")
    if route == "tiled":
        raise not_ported("the spatially tiled conv route",
                         "queue 2, kernel 6 (fused_lut_conv_tiled_kernel)")
    if spec.groups != 1:
        raise not_ported(f"grouped conv (groups={spec.groups})",
                         "queue 1, item 6 (the conv slice)")
    _require_lut(acu)
    fused = acu.fused if fused is None else fused
    a_bits = acu.bits if a_bits is None else a_bits
    report: list[str] = []
    want_fused = fused or route == "fused_conv"
    can_fuse = acu.use_kernels
    if want_fused and not can_fuse:
        report.append(f"fused conv needs LUT mode + use_kernels + a built "
                      f"table (have mode={acu.mode.value}, "
                      f"use_kernels={acu.use_kernels})")
    if route == "im2col":
        can_fuse = False
        report.append("route pinned to eager im2col by caller")
    if route == "fused_conv" and not can_fuse:
        raise ValueError(f"fused_conv route unavailable: {report}")

    if want_fused and can_fuse:
        from repro_torch.kernels.fused_lut_conv.ops import fused_lut_conv

        def fused_call(x, wq, xs, xz, ws, *, emit_acc=False):
            return fused_lut_conv(x, wq, acu.device_lut(x.device), acu.offset,
                                  xs, xz, ws, stride=spec.stride,
                                  padding=spec.padding,
                                  dilation=spec.dilation, bits=a_bits,
                                  emit_acc=emit_acc)

        return ConvPlan(mode=acu.mode, bits=acu.bits, use_kernels=True,
                        fused=True, route="fused_conv", spec=spec,
                        fn=fused_call, report=tuple(report),
                        bwd_route="banded")
    return ConvPlan(mode=acu.mode, bits=acu.bits, use_kernels=acu.use_kernels,
                    fused=fused, route="im2col", spec=spec,
                    report=tuple(report))


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
    ``describe()`` has the reference's keys; ``partition`` is None (no
    mesh yet).
    """

    mode: AcuMode
    bits: int
    use_kernels: bool
    route: str
    spec: AttnSpec
    fn: Optional[Callable[..., torch.Tensor]] = None
    report: tuple[str, ...] = ()

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
            "partition": None,
            "report": list(self.report),
        }


def attn_plan(acu: Acu, spec: AttnSpec, *,
              a_bits: Optional[int] = None) -> AttnPlan:
    """Resolve one attention site to a route, with the reference's audited
    fallback: an ACU that cannot run the approximate kernel (not LUT mode,
    no ``use_kernels``, no table) resolves to ``"dense"`` and attention
    stays exact. A plan depends only on static geometry, so the ACU keeps
    each one it resolves and hands it out again."""
    a_bits = acu.bits if a_bits is None else a_bits
    plan = acu._plans.get((spec, a_bits))
    if plan is None:
        plan = acu._plans[spec, a_bits] = _resolve_attn(acu, spec, a_bits)
    return plan


def _resolve_attn(acu: Acu, spec: AttnSpec, a_bits: int) -> AttnPlan:
    report: list[str] = []
    if spec.hq % spec.hkv != 0:
        raise ValueError(f"hq={spec.hq} not a multiple of hkv={spec.hkv}")
    if spec.kv_layout not in ("contiguous", "paged"):
        raise ValueError(f"unknown kv_layout {spec.kv_layout!r}")
    paged = spec.kv_layout == "paged"
    if not (acu.mode == AcuMode.LUT and acu.use_kernels
            and acu.lut is not None):
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
    kw = dict(bits=a_bits, causal=spec.causal, window=spec.window,
              softcap=spec.softcap, row_heads=spec.hq)

    if paged:
        rep = spec.hq // spec.hkv

        def fn(q, k_pool, v_pool, qs, ks, vs, rowinfo, page_table):
            b, hq, sq, d = q.shape
            out = approx_flash_attention_paged(
                q, k_pool, v_pool, acu.device_lut(q.device), acu.offset, qs,
                ks, vs, rowinfo=rowinfo, page_table=page_table, rep=rep,
                **kw)
            return out.reshape(b, hq, sq, d)
    else:
        def fn(q, k, v, qs, ks, vs, rowinfo=None):
            b, hq, sq, d = q.shape
            out = approx_flash_attention(
                q, k, v, acu.device_lut(q.device), acu.offset, qs, ks, vs,
                rowinfo=rowinfo, **kw)
            return out.reshape(b, hq, sq, d)

    return AttnPlan(mode=acu.mode, bits=acu.bits, use_kernels=True,
                    route="fused_attn_paged" if paged else "fused_attn",
                    spec=spec, fn=fn, report=tuple(report))


def make_acu(name: str, mode: AcuMode | str = AcuMode.LUT,
             use_kernels: bool = False, fused: bool = False) -> Acu:
    """Build a LUT-mode ACU from a registered multiplier name.

    Large-bitwidth LUT requests fall back to FUNCTIONAL, as in the
    reference (paper §3.4); the port's planners then refuse that mode, as
    ``make_acu`` refuses the other modes outright.
    """
    mult = get_multiplier(name)
    mode = AcuMode(mode) if isinstance(mode, str) else mode
    if mode != AcuMode.LUT:
        raise not_ported(f"ACU mode {mode.value!r}",
                         "queue 1, item 4 (core/acu.py, dense part)")
    if mult.bits > 10:
        return Acu(multiplier=mult, mode=AcuMode.FUNCTIONAL,
                   use_kernels=use_kernels, fused=fused)
    return Acu(multiplier=mult, mode=mode, lut=build_lut(mult),
               use_kernels=use_kernels, fused=fused)

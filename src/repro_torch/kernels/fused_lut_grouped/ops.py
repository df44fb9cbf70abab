"""Public wrapper of the ragged grouped fused LUT-GEMM kernel
(``csrc/fused_lut_grouped.cu``): all expert GEMMs of one MoE projection in
one launch.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the plain
version in ``ref.py``. Nothing is padded, so the kernel needs no K-pad
correction, and the live-row counts stay on the device: the wrapper never
reads them back.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import runtime
from .ref import fused_lut_grouped_ref


def fused_lut_grouped(x: torch.Tensor, wq: torch.Tensor, lut: torch.Tensor,
                      offset: int, x_scale, x_zp, w_scale,
                      counts: torch.Tensor, *, bits: int = 8,
                      emit_acc: bool = False) -> torch.Tensor:
    """Ragged grouped approximate GEMM over MoE capacity buffers.

    ``x``: (G, C, K) float dispatched activations, G groups of C capacity
    rows (float32 or bfloat16; bfloat16 is widened in-kernel, exactly);
    group ``g`` multiplies expert ``g % E``. ``wq``: (E, K, N) int32 shifted
    weight codes; ``lut``: the product table (int32, or int16 from
    :func:`runtime.lut_to_int16`); ``x_scale``/``x_zp``: per-tensor
    activation qparams shared by every group; ``w_scale``: (E,), (E, N) or
    (E, 1, N) per-expert weight scales; ``counts``: (G,) live rows per
    group. Returns (G, C, N) float32 with rows ``>= counts[g]`` exactly 0.0,
    or the int32 accumulator (dead rows 0) with ``emit_acc=True``.
    """
    n_codes = int(round(lut.numel() ** 0.5))
    G, C, K = x.shape
    E, K2, N = wq.shape
    if K2 != K:
        raise ValueError(f"inner dims differ: x {tuple(x.shape)}, "
                         f"wq {tuple(wq.shape)}")
    if E == 0 or G % E != 0:
        raise ValueError(f"groups {G} not a multiple of experts {E}")
    if tuple(counts.shape) != (G,):
        raise ValueError(f"counts {tuple(counts.shape)}, expected ({G},)")
    if x.device.type == "cpu":
        return fused_lut_grouped_ref(x, wq, lut.reshape(-1), offset, n_codes,
                                     x_scale, x_zp, w_scale, counts,
                                     bits=bits, emit_acc=emit_acc)
    lo = -(1 << (bits - 1))
    hi = (1 << (bits - 1)) - 1
    table = runtime.lut_to_int16(lut)
    if table.data_ptr() % 16:          # the kernel copies it 16 bytes a load
        table = table.clone()
    if x.dtype != torch.bfloat16:
        x = x.to(torch.float32)
    x = x.contiguous()
    wq = wq.contiguous()
    counts = counts.to(torch.int32).contiguous()
    f = dict(dtype=torch.float32, device=x.device)
    xs = torch.as_tensor(x_scale, **f).reshape(1).contiguous()
    xz = torch.as_tensor(x_zp, **f).reshape(1).contiguous()
    ws = torch.as_tensor(w_scale, **f).reshape(E, -1).expand(E, N).contiguous()
    for t, name, dt in ((x, "x", x.dtype), (wq, "wq", torch.int32),
                        (table, "lut", torch.int16),
                        (counts, "counts", torch.int32)):
        runtime.check_cuda_operand(t, name, dt, x.device)
    out = torch.empty((G, C, N), device=x.device,
                      dtype=torch.int32 if emit_acc else torch.float32)
    if out.numel() == 0:
        return out
    lib = runtime.kernel_library("fused_lut_grouped")
    blocks, stream = runtime.launch_config(x)
    lib.check(lib.launch(x.data_ptr(), int(x.dtype == torch.bfloat16),
                         wq.data_ptr(), table.data_ptr(), xs.data_ptr(),
                         xz.data_ptr(), ws.data_ptr(), counts.data_ptr(),
                         out.data_ptr(), int(emit_acc), G, E, C, K, N,
                         n_codes, offset, lo, hi, blocks, stream))
    fused_lut_grouped.launches += 1
    return out


fused_lut_grouped.launches = 0

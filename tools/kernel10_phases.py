#!/usr/bin/env python3
"""Where kernel 10 (``csrc/fused_lut_grouped.cu``) spends a decode step,
phase by phase, on the card.

    python3 tools/kernel10_phases.py

``ncu`` and ``nsys`` do not run on the card's machine, so this builds a
copy of the kernel's source (under ``build/``) with ``clock64`` counters
around the phases of its one-row-group path (the decode path): the start
(table copy and the split), each segment's head and ring prologue, and in
the chunk loop the wait for the next chunk, its quantization, the warp's
sync, loading this chunk's codes, the gathers and issuing the next copies;
then the segment's epilogue and the dead rows. It runs granite-moe-3b-a800m's
decode gate projection (40 experts, 16 dispatch blocks of 1 row, 1536 ->
512, bfloat16, 32 tokens routed to 8 experts each, weight codes quantized
per expert and column from a normal draw) ten times and prints each
phase's clocks per warp per call and its share of a warp's total. The
counters are read by each warp's lane 0; a warp's clocks include the
cycles other warps hold its scheduler. Needs one CUDA card and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PHASES = ["start", "segment head", "ring prologue", "wait", "quantize",
          "warp sync", "codes", "gathers", "issue", "epilogue", "dead rows"]
# (anchor in the source, counter inserted before it, after it)
MARKS = [
    ("  int cur_e = -1;\n", 0, None),
    ("    int tile, c0, c1, slot;", 9, None),
    ("      for (int i = 0; i < S; ++i) issue_w(i);", 1, None),
    ("        if (i + 1 < nck) {\n          cp_wait_upto(S - 2);", 2, None),
    ("          cp_wait_upto(S - 2);  // this lane's part of chunk i + 1 landed",
     None, 3),
    ("          quantize_w(i + 1);", None, 4),
    ("        __syncwarp();  // chunk i's row codes, from every lane", None, 5),
    ("          if (kn == kOwn) {", 6, None),
    ("        __syncwarp();    // every lane is done with chunk i's row codes",
     7, None),
    ("        issue_w(i + S);  // into chunk i's slot: this lane's own part",
     None, 8),
    ("  cp_wait<0>();\n\n  // dead rows", 9, None),
]


def instrumented_source() -> str:
    s = (ROOT / "src/repro_torch/csrc/fused_lut_grouped.cu").read_text()
    s = s.replace("namespace {\n", "__device__ unsigned long long phase_clocks[16];\n"
                  "namespace {\n", 1)
    s = s.replace("grouped_kernel(Params p) {\n",
                  "grouped_kernel(Params p) {\n"
                  "  long long clk[16] = {0};\n"
                  "  long long clk_start = clock64(), clk_last = clk_start;\n"
                  "#define PHASE(i) { const long long c = clock64(); "
                  "clk[i] += c - clk_last; clk_last = c; }\n", 1)
    for anchor, before, after in MARKS:
        if anchor not in s:
            raise SystemExit(f"the kernel's source changed: {anchor!r} not "
                             f"found; update MARKS")
        s = s.replace(anchor, (f"PHASE({before})\n" if before is not None
                               else "") + anchor
                      + (f"\nPHASE({after})" if after is not None else ""), 1)
    end = s.rindex("}\n", 0, s.index("template <int TN, typename T, bool "
                                     "ONE_GROUP>\nint launch("))
    s = (s[:end] + "  PHASE(10)\n  clk[11] = clock64() - clk_start;\n"
         "  if ((threadIdx.x & 31) == 0)\n"
         "    for (int i = 0; i < 12; ++i)\n"
         "      atomicAdd(phase_clocks + i, (unsigned long long)clk[i]);\n"
         + s[end:])
    return s + ('\nextern "C" int read_phase_clocks(unsigned long long* h) {\n'
                "  cudaMemcpyFromSymbol(h, phase_clocks, sizeof(phase_clocks));\n"
                "  unsigned long long z[16] = {0};\n"
                "  return cudaMemcpyToSymbol(phase_clocks, z, sizeof(z));\n}\n")


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kernel10_phases: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import make_acu
    from repro_torch.kernels import runtime
    from repro_torch.kernels.fused_lut_grouped.ops import fused_lut_grouped
    out = runtime.BUILD_DIR / "phases"
    out.mkdir(parents=True, exist_ok=True)
    for h in runtime.CSRC.glob("*.cuh"):
        (out / h.name).write_bytes(h.read_bytes())
    src, lib_path = out / "fused_lut_grouped.cu", out / "fused_lut_grouped.so"
    src.write_text(instrumented_source())
    subprocess.run([runtime.nvcc_path(), *runtime.NVCC_FLAGS, "-o",
                    str(lib_path), str(src)], check=True)
    lib = runtime.KernelLibrary("fused_lut_grouped", lib_path)
    runtime.BUILDER._libs["fused_lut_grouped"] = lib
    read = lib._lib.read_phase_clocks
    read.argtypes = [ctypes.c_void_p]

    dev = torch.device("cuda")
    E, nb, K, N, tokens = 40, 16, 1536, 512, 32
    rng = np.random.default_rng(0)
    cnt = np.zeros((nb, E), np.int32)
    for t in range(tokens):
        cnt[t * nb // tokens, rng.choice(E, 8, replace=False)] = 1
    counts = torch.from_numpy(cnt.reshape(-1)).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    x = torch.randn((nb * E, 1, K), generator=gen, device=dev).to(
        torch.bfloat16)
    w = torch.randn((E, K, N), generator=gen, device=dev)
    ws = w.abs().amax(1) / 127
    wq = torch.clamp(torch.round(w / ws[:, None, :]), -128, 127).to(
        torch.int32)
    xs = x.float().abs().amax() / 127
    zero = torch.zeros((), device=dev)
    lut = runtime.lut_to_int16(torch.from_numpy(
        make_acu("mul8s_1L2H", "lut").lut.reshape(-1)).to(dev))
    call = lambda: fused_lut_grouped(x, wq, lut, 128, xs, zero, ws, counts)
    buf = (ctypes.c_ulonglong * 16)()
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    read(ctypes.addressof(buf))
    reps = 10
    for _ in range(reps):
        call()
    torch.cuda.synchronize()
    read(ctypes.addressof(buf))
    warps = runtime.sm_count(0) * 8 * reps
    total = buf[11] / warps
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(f"kernel 10, granite decode gate ({int(counts.sum())} live rows): "
          f"clocks per warp per call, share of the warp's {total:.0f}")
    for i, name in enumerate(PHASES):
        print(f"  {name:14s} {buf[i] / warps:9.0f}  {buf[i] / warps / total:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

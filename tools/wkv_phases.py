#!/usr/bin/env python3
"""Where kernel 12's backward (``csrc/wkv_bwd.cu``) spends its time at
rwkv6-3b's training shape (B 4 x T 512 x 40 heads x 64), on the card.

    python3 tools/wkv_phases.py

``ncu`` and ``nsys`` do not run on the card's machine, so this builds
copies of the kernel's source (under ``build/wkv_phases/``), each with one
part taken out by a text substitution, and times each beside the whole
kernel in one process with CUDA events: only the row blocks (dr, dk, dw,
du), only the column blocks (dv), the row blocks without pass 1 (no
sub-chunk slots filled), without the restore in pass 2, without the
butterfly's shuffles, and the kernel at other register limits. A variant
computes wrong numbers; only its time is read. Prints each variant's ms,
what ``ptxas -v`` says of it (registers, spills) and, first, the card's
name and power limit. Needs one CUDA card and ``nvcc``.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

B, T, H, HD = 4, 512, 40, 64
ROW_GRID = ("(long long)a.BH * (HD / kRows) +\n"
            "                         (long long)a.BH * (HD < kCols ? 1 : "
            "HD / kCols)")
# (name, [(text in the source, its replacement)])
VARIANTS = [
    ("whole kernel", []),
    ("row blocks only", [(ROW_GRID, "(long long)a.BH * (HD / kRows)")]),
    ("column blocks only", [("    row_block<HD>(a, smem, blockIdx.x);",
                             "    return;")]),
    ("rows, no pass 1", [
        (ROW_GRID, "(long long)a.BH * (HD / kRows)"),
        ("return nq > 1 ? Job{c, 0, 0} : Job{c, 1, nq - 1};",
         "return Job{c, 1, nq - 1};")]),
    ("rows, no restore in pass 2", [
        (ROW_GRID, "(long long)a.BH * (HD / kRows)"),
        ("st[s][e] = wkv_state_step(ww, st[s - 1][e], kk, vv[e]);",
         "st[s][e] = st[s - 1][e] + kk;")]),
    ("rows, no shuffles", [
        (ROW_GRID, "(long long)a.BH * (HD / kRows)"),
        ("k0 = __fadd_rn(k0, __shfl_xor_sync(kFull, s0, 8));",
         "k0 = __fadd_rn(k0, s0);"),
        ("k1 = __fadd_rn(k1, __shfl_xor_sync(kFull, s1, 8));",
         "k1 = __fadd_rn(k1, s1);")]),
    ("at most 128 registers", [
        ("__launch_bounds__(kThreads) wkv_bwd_kernel",
         "__launch_bounds__(kThreads, 4) wkv_bwd_kernel")]),
]


def main() -> int:
    import torch
    from chip_smoke import cuda_ms
    from repro_torch.kernels import runtime
    from repro_torch.kernels.wkv import ops

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    src = (runtime.CSRC / "wkv_bwd.cu").read_text()
    out_dir = ROOT / "build" / "wkv_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for n, (name, subs) in enumerate(VARIANTS):
        s = src
        for old, new in subs:
            if old not in s:
                raise RuntimeError(f"{name}: {old!r} is not in the source")
            s = s.replace(old, new)
        cu, so = out_dir / f"v{n}.cu", out_dir / f"v{n}.so"
        cu.write_text(s)
        procs.append((name, so, subprocess.Popen(
            [runtime.nvcc_path(), *runtime.NVCC_FLAGS, "-Xptxas", "-v",
             "-I", str(runtime.CSRC), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = []
    for name, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            print(log)
            return 1
        use, on = [], False      # the hd 64 kernel's lines
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                on = "wkv_bwd_kernelILi64E" in ln
            elif on and ("Used" in ln or "spill" in ln):
                use.append(ln.split("ptxas info    : ")[-1].strip())
        libs.append((name, runtime.KernelLibrary("wkv_bwd", so), use))

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(29)
    r, k, v, g = (torch.randn((B, T, H, HD), generator=gen, device=dev)
                  for _ in range(4))
    w = torch.rand((B, T, H, HD), generator=gen, device=dev) * 0.9 + 0.05
    u = torch.randn((H, HD), generator=gen, device=dev) * 0.5
    s0 = torch.randn((B, H, HD, HD), generator=gen, device=dev)
    _, _, bounds = ops._forward(r, k, v, w, u, s0, None, ops.CHUNK)
    grads = [torch.empty_like(r) for _ in range(4)]
    ds0 = torch.empty_like(s0)
    du = torch.empty((H, HD), device=dev)
    du_part = torch.empty((B * H, HD), device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def call(lib):
        lib.check(lib.launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), bounds.data_ptr(), g.data_ptr(), None,
            *(x.data_ptr() for x in grads), ds0.data_ptr(),
            du_part.data_ptr(), du.data_ptr(), None, B, T, H, HD, ops.CHUNK,
            stream))

    print(f"wkv_bwd variants at B {B} T {T} {H} heads x {HD} (ms; each "
          f"timed twice, in turns):")
    times = {name: [] for name, _, _ in libs}
    for _ in range(2):
        for name, lib, _ in libs:
            times[name].append(cuda_ms(torch, lambda: call(lib), 10))
    for name, _, use in libs:
        print(f"  {name:28s} " + " / ".join(f"{x:.4f}" for x in times[name])
              + f"   ({'; '.join(use)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Kernel 12 (``csrc/wkv.cu``) and its backward (``csrc/wkv_bwd.cu``) alone
on the card, at rwkv6-3b's 40 heads of 64 (and at head dim 16):

    python3 tools/wkv_probe.py

1. builds both libraries and prints what ``ptxas -v`` says of each kernel
   (registers, shared memory, spills);
2. holds the backward against ``wkv_bwd_ref`` on the same saved chunk
   boundaries, within ``WKV_BWD_TOL`` of each gradient's largest entry,
   with a nonzero ``ds_t``; ``du`` the same bits in two runs; every state
   the kernel restores (``states_out``) bitwise the forward's, walked on
   the card by the plain update;
3. holds the forward against ``wkv_ref``: ``S_T`` and the chunk-boundary
   states bitwise, ``out`` within ``out_bound``, at decode, prefill, the
   training shape and on strided views;
4. times the forward (decode, 32 rows; prefill; the training shapes, with
   and without the chunk boundaries) and the backward at the training
   shapes against their bounds (``ops.wkv_work`` / ``ops.wkv_bwd_work``:
   bytes at ``chip_smoke.HBM_BYTES_PER_S``, FP32 FLOPs, an FMA two, at the
   SMs' FMA lanes x 2 x ``chip_smoke.SPIN_CYCLES_PER_S``);
5. builds a copy of ``csrc/wkv.cu`` (under ``build/wkv_probe/``) whose
   decode calls (T = 1) take the sequence kernel too, checks it at decode
   as in 3, and times it against the decode kernel at 32 rows, in turns.

Prints the card's name and power limit first. Needs one CUDA card and
``nvcc``; exits 1 on a failed check.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

H, HD = 40, 64
DECODE_ROWS = 32
# the launcher's dispatch of decode calls to their own kernel, taken out
# of the copy that times the sequence kernel at decode
STEP_DISPATCH = "if (T == 1) {"
CHECKS = ((16, 3, 1), (16, 3, 257), (64, 2, 1), (64, 2, 255), (64, 2, 256),
          (64, 2, 300), (64, 1, 1024))
FWD_CHECKS = ((16, 3, 1), (16, 3, 300), (64, 32, 1), (64, 1, 16),
              (64, 1, 17), (64, 1, 256), (64, 32, 200), (64, 4, 512),
              (64, 2, 300, True))
TIMED_FWD = ((32, 1), (1, 16), (1, 256), (32, 200), (4, 512), (1, 1024))
TIMED_BWD = ((4, 512), (1, 1024))


def main() -> int:
    import torch
    from chip_smoke import (FP32_LANES, HBM_BYTES_PER_S, SPIN_CYCLES_PER_S,
                            WKV_BWD_TOL, cuda_ms)
    from repro_torch.kernels import runtime
    from repro_torch.kernels.wkv import ops
    from repro_torch.kernels.wkv.ref import out_bound, wkv_bwd_ref, wkv_ref

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    flop_rate = n_sm * FP32_LANES * 2 * SPIN_CYCLES_PER_S
    t0 = time.perf_counter()
    src = (runtime.CSRC / "wkv.cu").read_text()
    if STEP_DISPATCH not in src:
        raise RuntimeError(f"{STEP_DISPATCH!r} is not in csrc/wkv.cu")
    out_dir = ROOT / "build" / "wkv_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / "wkv_seq_decode.cu", out_dir / "wkv_seq_decode.so"
    cu.write_text(src.replace(STEP_DISPATCH, "if (false) {"))
    variant = subprocess.Popen(
        [runtime.nvcc_path(), *runtime.NVCC_FLAGS, "-I", str(runtime.CSRC),
         "-o", str(so), str(cu)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    logs = runtime.BUILDER.build_all(("wkv", "wkv_bwd"))
    vlog, _ = variant.communicate()
    if variant.returncode:
        print(vlog)
        return 1
    seq_lib = runtime.KernelLibrary("wkv", so)
    print(f"built in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "ptxas info" in line and ("Used" in line or "spill" in line
                                         or "Compiling" in line):
                print(f"  {name}: {line.split('ptxas info    : ')[-1]}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(29)
    failed = []

    def operands(b, t, h, hd):
        r, k, v, g = (torch.randn((b, t, h, hd), generator=gen, device=dev)
                      for _ in range(4))
        w = torch.rand((b, t, h, hd), generator=gen, device=dev) * 0.9 + 0.05
        u = torch.randn((h, hd), generator=gen, device=dev) * 0.5
        s0 = torch.randn((b, h, hd, hd), generator=gen, device=dev)
        ds_t = torch.randn((b, h, hd, hd), generator=gen, device=dev)
        return r, k, v, w, u, s0, g, ds_t

    def fold(a):
        b, t, h, hd = a.shape
        return a.transpose(1, 2).reshape(b * h, t, hd)

    print(f"backward against wkv_bwd_ref, chunks of {ops.CHUNK}, within "
          f"{WKV_BWD_TOL} of each gradient's largest entry:")
    for hd, b, t in CHECKS:
        h = 4 if hd == 16 else H
        r, k, v, w, u, s0, g, ds_t = operands(b, t, h, hd)
        _, _, bounds = ops._forward(r, k, v, w, u, s0, None, ops.CHUNK)
        states = torch.empty((b * h, t, hd, hd), device=dev)
        got = ops.wkv_bwd(r, k, v, w, u, bounds, g, ds_t, states_out=states)
        again = ops.wkv_bwd(r, k, v, w, u, bounds, g, ds_t)
        dr, dk, dv, dw, du, ds0 = wkv_bwd_ref(
            fold(r), fold(k), fold(v), fold(w), u, bounds, fold(g),
            ds_t.reshape(b * h, hd, hd), ops.CHUNK)
        unfold = lambda a: a.reshape(b, h, t, hd).transpose(1, 2)  # noqa
        want = (unfold(dr), unfold(dk), unfold(dv), unfold(dw), du,
                ds0.reshape(b, h, hd, hd))
        errs = [float((x.double() - y.double()).abs().max())
                / max(float(y.abs().max()), 1e-30) for x, y in zip(got, want)]
        s, same = s0.reshape(b * h, hd, hd), True
        fk, fv, fw = fold(k), fold(v), fold(w)
        for step in range(t):
            same &= torch.equal(states[:, step], s)
            s = fw[:, step, :, None] * s + fk[:, step, :, None] \
                * fv[:, step, None, :]
        ok = (max(errs) <= WKV_BWD_TOL and bool(same)
              and all(bool(torch.isfinite(x).all()) for x in got)
              and all(torch.equal(x, y) for x, y in zip(got, again)))
        print(f"  hd {hd} B {b} T {t:4d}: worst {max(errs):.2e} (dr dk dv dw "
              f"du ds0 " + " ".join(f"{e:.1e}" for e in errs) + "), restored "
              f"states bitwise {bool(same)}, two runs the same bits: "
              f"{'ok' if ok else 'FAILED'}", flush=True)
        if not ok:
            failed.append(f"backward hd {hd} B {b} T {t}")
        del r, k, v, w, u, s0, g, ds_t, bounds, states, got, again, want

    print("forward against wkv_ref (S_T and the chunk boundaries bitwise, "
          "out within out_bound):")
    for hd, b, t, *strided in FWD_CHECKS:
        h = 4 if hd == 16 else H
        r, k, v, w, u, s0, _, _ = operands(b, t, h, hd)
        if strided:      # r, k, v, w as views into one (b, t, 4, h, hd)
            big = torch.randn((b, t, 4, h, hd), generator=gen, device=dev)
            r, k, v = big[:, :, 0], big[:, :, 1], big[:, :, 2]
            w = torch.sigmoid(big[:, :, 3])
        out, s_t, bounds = ops._forward(r, k, v, w, u, s0, None, ops.CHUNK)
        folded = [fold(a) for a in (r, k, v, w)] + [
            u, s0.reshape(b * h, hd, hd)]
        po, ps, pb = wkv_ref(*folded, chunk=ops.CHUNK)
        diff = (fold(out) - po).abs()
        ok = (torch.equal(s_t.reshape(b * h, hd, hd), ps)
              and torch.equal(bounds, pb)
              and bool((diff <= out_bound(*folded)).all())
              and bool(torch.isfinite(out).all()))
        print(f"  hd {hd} B {b} T {t:4d}{' strided' if strided else ''}: "
              f"max |out diff| {float(diff.max()):.2e}: "
              f"{'ok' if ok else 'FAILED'}", flush=True)
        if not ok:
            failed.append(f"forward hd {hd} B {b} T {t}")
        del r, k, v, w, u, s0, out, s_t, bounds, folded, po, ps, pb, diff

    print(f"times on the card ({H} heads x {HD}):")
    for b, t in TIMED_FWD:
        r, k, v, w, u, s0, g, _ = operands(b, t, H, HD)
        for chunk in ((None,) if t == 1 else (None, ops.CHUNK)):
            fn = lambda: ops._forward(r, k, v, w, u, s0, None, chunk)  # noqa
            ms = cuda_ms(torch, fn, 20 if t == 1 else 10)
            bytes_, flops = ops.wkv_work(r, k, v, w, u, s0, chunk)
            bound = max(bytes_ / HBM_BYTES_PER_S, flops / flop_rate) * 1e3
            print(f"  wkv B {b} T {t}{' with bounds' if chunk else ''}: "
                  f"{ms:.4f} ms, bound {bound:.4f} ms "
                  f"({bytes_ / 1e6:.1f} MB, {flops / 1e9:.3f} G FLOPs), "
                  f"{bound / ms:.3f} of it", flush=True)
        del r, k, v, w, u, s0, g
    for b, t in TIMED_BWD:
        r, k, v, w, u, s0, g, _ = operands(b, t, H, HD)
        _, _, bounds = ops._forward(r, k, v, w, u, s0, None, ops.CHUNK)
        ms = cuda_ms(torch, lambda: ops.wkv_bwd(r, k, v, w, u, bounds, g,
                                                None), 10)
        bytes_, flops = ops.wkv_bwd_work(r, k, v, w, u, bounds, g, None)
        bound = max(bytes_ / HBM_BYTES_PER_S, flops / flop_rate) * 1e3
        print(f"  wkv_bwd B {b} T {t}: {ms:.4f} ms, bound {bound:.4f} ms "
              f"({bytes_ / 1e6:.1f} MB, {flops / 1e9:.3f} G FLOPs), "
              f"{bound / ms:.3f} of it", flush=True)
        del r, k, v, w, u, s0, g, bounds

    # the sequence kernel at decode, against the decode kernel
    b = DECODE_ROWS
    r, k, v, w, u, s0, _, _ = operands(b, 1, H, HD)
    out, s_t = torch.empty_like(r), torch.empty_like(s0)
    stream = torch.cuda.current_stream().cuda_stream
    strides = [st for a in (r, k, v, w) for st in a.stride()[:3]]

    def seq_decode():
        seq_lib.check(seq_lib.launch(
            *(a.data_ptr() for a in (r, k, v, w, u, s0, out, s_t)), None, 0,
            b, 1, H, HD, *strides, stream))

    seq_decode()
    folded = [fold(a) for a in (r, k, v, w)] + [u, s0.reshape(b * H, HD, HD)]
    po, ps = wkv_ref(*folded)
    diff = (fold(out) - po).abs()
    ok = (torch.equal(s_t.reshape(b * H, HD, HD), ps)
          and bool((diff <= out_bound(*folded)).all()))
    step_decode = lambda: ops._forward(r, k, v, w, u, s0, None, None)  # noqa
    times = [cuda_ms(torch, fn, 50) for fn in (step_decode, seq_decode,
                                                seq_decode, step_decode)]
    print(f"  decode, B {b} T 1: the decode kernel {times[0]:.4f} / "
          f"{times[3]:.4f} ms, the sequence kernel {times[1]:.4f} / "
          f"{times[2]:.4f} ms (sequence / decode "
          f"{(times[1] + times[2]) / (times[0] + times[3]):.3f}); the "
          f"sequence kernel's S_T bitwise, out within out_bound (max |out "
          f"diff| {float(diff.max()):.2e}): {'ok' if ok else 'FAILED'}",
          flush=True)
    if not ok:
        failed.append("sequence kernel at decode")
    if failed:
        print("FAILED: " + ", ".join(failed))
        return 1
    print("all checks passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

1. builds the hand-written CUDA kernels from ``src/repro_torch/csrc``;
2. holds each kernel (lut_matmul, fused_lut_dense, fused_lut_conv) against
   its plain PyTorch version on the card, bitwise, at every GEMM shape of a
   ResNet-20 wave of 256 CIFAR-sized images, and times kernel, plain
   version and a ``torch.matmul`` yardstick there;
3. serves 1024 images from ``image_task(size=32)`` through
   ``VisionServeEngine(slots=256)`` with ResNet-20 at full width (random
   weights from a seed), once with the fused ACU (fused conv + fused dense
   kernels) and once with the unfused one (im2col + lut_matmul), each with
   the launch counters set to 0 just before and read just after; checks that
   both give the same logits bit for bit, that one wave equals the plain
   PyTorch forward on the card, and that a small batch equals the CPU run;
   then profiles one wave of each (device time by kernel, idle share);
4. prints one ``{"kernels": [...]}`` line, then the result line.

Exits nonzero, with no result line, when there is no CUDA device, when it
runs outside the repository, or when any phase fails.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MULT = "mul8s_1L2H"
BATCH = 256            # slots of one wave
N_IMAGES = 1024
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet

# every conv of a ResNet-20 wave: (name, cin, hw, cout, k, stride, padding,
# convs of this shape per wave)
CONVS = [
    ("stem", 3, 32, 16, 3, 1, "SAME", 1),
    ("stage0", 16, 32, 16, 3, 1, "SAME", 6),
    ("stage1_down", 16, 32, 32, 3, 2, "SAME", 1),
    ("stage1_shortcut", 16, 32, 32, 1, 2, "VALID", 1),
    ("stage1", 32, 16, 32, 3, 1, "SAME", 5),
    ("stage2_down", 32, 16, 64, 3, 2, "SAME", 1),
    ("stage2_shortcut", 32, 16, 64, 1, 2, "VALID", 1),
    ("stage2", 64, 8, 64, 3, 1, "SAME", 5),
]
HEAD = (BATCH, 64, 10)    # (M, K, N) of the dense head
KERNELS = {
    "lut_matmul": ("src/repro_torch/csrc/lut_matmul.cu",
                   "src/repro/kernels/lut_matmul/kernel.py:56"),
    "fused_lut_dense": ("src/repro_torch/csrc/fused_lut_dense.cu",
                        "src/repro/kernels/fused_lut_dense/kernel.py:179"),
    "fused_lut_conv": ("src/repro_torch/csrc/fused_lut_conv.cu",
                       "src/repro/kernels/fused_lut_conv/kernel.py:153"),
}


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int, warm: int = 2) -> float:
    """Mean device time of one call, from CUDA events around ``reps``
    calls after ``warm`` untimed ones."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def profile_wave(torch, name: str, engine, images, wall_ms: float) -> None:
    """Where one wave's time goes: device time by kernel (torch.profiler,
    device-side events only) against ``wall_ms``, the wave's wall time
    measured without the profiler; the rest is the device's idle share."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run(images)
        traced_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0
            and not e.key.startswith("Activity Buffer")]
    rows.sort(key=lambda r: -r[1])
    if not rows:
        print(f"  profile {name}: no device time in the trace (not measured)")
        return
    busy = sum(r[1] for r in rows)
    print(f"  profile {name} wave: device busy {busy:.3f} ms of {wall_ms:.3f} "
          f"ms wall (untraced), idle share {1 - busy / wall_ms:.3f}; "
          f"traced wall {traced_ms:.3f} ms")
    for key, ms, count in rows[:8]:
        print(f"    {ms:9.3f} ms  {count:4d}x  {key[:90]}")


class Check:
    def __init__(self):
        self.failures: list[str] = []

    def __call__(self, ok: bool, what: str) -> None:
        print(f"  [{'ok' if ok else 'FAIL'}] {what}", flush=True)
        if not ok:
            self.failures.append(what)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import numpy as np
        from repro_torch.core import (ApproxConfig, acu_operand, make_acu,
                                      quantize, symmetric_qparams)
        from repro_torch.core.approx_ops import _conv_qparams, _im2col
        from repro_torch.core.acu import resolve_conv_padding
        from repro_torch.data.pipeline import image_task
        from repro_torch.kernels import runtime
        from repro_torch.kernels.fused_lut_conv.ops import fused_lut_conv
        from repro_torch.kernels.fused_lut_conv.ref import fused_lut_conv_ref
        from repro_torch.kernels.fused_lut_dense.ops import fused_lut_dense
        from repro_torch.kernels.fused_lut_dense.ref import \
            fused_lut_dense_ref
        from repro_torch.kernels.lut_matmul.ops import lut_matmul
        from repro_torch.kernels.lut_matmul.ref import lut_matmul_ref
        from repro_torch.models.vision import init_resnet, resnet_forward
        from repro_torch.serve.engine import VisionServeEngine
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing ({e}); run "
              f"from a checkout of the repository", file=sys.stderr)
        return 1

    check = Check()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}")
    print(nvidia_smi("name,power.limit"), flush=True)
    props = torch.cuda.get_device_properties(0)
    n_sm = props.multi_processor_count

    # -- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    logs = runtime.BUILDER.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({len(logs)} of {len(KERNELS)} libraries compiled)")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # -- 2. kernels against their plain versions, at the wave's shapes ----
    acu = make_acu(MULT, "lut", use_kernels=True, fused=True)
    off, n_codes = acu.offset, acu.multiplier.n_codes
    lut16 = acu.device_lut(dev)
    lut32 = torch.from_numpy(acu.lut.reshape(-1)).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    stats = {k: dict(err=0.0, ms=0.0, plain_ms=0.0, lib_ms=0.0, t_bytes=0.0,
                     t_ops=0.0, bound_ms=0.0) for k in KERNELS}
    lut_bytes = lut16.numel() * 2

    # the SM clock, read while the card is busy with the largest conv
    x0 = torch.randn((BATCH, 16, 32, 32), generator=gen, device=dev)
    w0 = torch.randn((16, 16, 3, 3), generator=gen, device=dev)
    cfg = ApproxConfig(acu=acu)
    xqp, wqp = _conv_qparams(x0, w0, cfg, None, None)
    wq0 = acu_operand(quantize(w0, wqp), wqp)
    pad0 = ((1, 1), (1, 1))
    for _ in range(300):
        fused_lut_conv(x0, wq0, lut16, off, xqp.scale, xqp.zero_point,
                       wqp.scale, padding=pad0)
    clk_mhz = float(nvidia_smi("clocks.sm").split()[0])
    torch.cuda.synchronize()
    print(f"SM clock under load: {clk_mhz:.0f} MHz "
          f"(max {nvidia_smi('clocks.max.sm')}), {n_sm} SMs")
    lookups_per_s = n_sm * 32 * clk_mhz * 1e6

    def account(name, count, ms, plain_ms, lib_ms, bytes_, ops, err):
        s = stats[name]
        t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
        t_ops = ops / lookups_per_s * 1e3
        s["err"] = max(s["err"], err)
        s["ms"] += count * ms
        s["plain_ms"] += count * plain_ms
        s["lib_ms"] += count * lib_ms
        s["t_bytes"] += count * t_bytes
        s["t_ops"] += count * t_ops
        s["bound_ms"] += count * max(t_bytes, t_ops)

    def max_err(a, b):
        return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())

    print("kernel checks at ResNet-20 wave shapes (batch 256):")
    for name, cin, hw, cout, k, stride, padding, count in CONVS:
        x = torch.relu(torch.randn((BATCH, cin, hw, hw), generator=gen,
                                   device=dev))
        w = torch.randn((cout, cin, k, k), generator=gen, device=dev)
        xqp, wqp = _conv_qparams(x, w, cfg, None, None)
        wq = acu_operand(quantize(w, wqp), wqp)
        st = (stride, stride)
        pad = resolve_conv_padding(padding, x.shape, w.shape, st, (1, 1))
        args = (xqp.scale, xqp.zero_point, wqp.scale)
        conv_k = lambda emit=False: fused_lut_conv(
            x, wq, lut16, off, *args, stride=st, padding=pad, emit_acc=emit)
        conv_p = lambda emit=False: fused_lut_conv_ref(
            x, wq, lut32, off, n_codes, *args, stride=st, padding=pad,
            emit_acc=emit)
        yk, yp = conv_k(), conv_p()
        ak, ap = conv_k(True), conv_p(True)
        ok = torch.equal(yk, yp) and torch.equal(ak, ap)
        err = max(max_err(yk, yp), max_err(ak, ap))
        check(ok, f"fused_lut_conv {name}: f32 and int32 outputs bitwise "
                  f"equal to the plain version {tuple(yk.shape)}")
        # the unfused route's GEMM on the same layer
        cols, _ = _im2col(x, k, k, st, pad, (1, 1))
        cols = cols.reshape(-1, cols.shape[-1])
        a = acu_operand(quantize(cols, xqp), xqp)
        wmat = wq.reshape(cout, -1).t().contiguous()
        mk, mp = lut_matmul(a, wmat, lut16, off), \
            lut_matmul_ref(a, wmat, lut32, off, n_codes)
        check(torch.equal(mk, mp), f"lut_matmul {name}: int32 bitwise equal "
                                   f"to the plain version {tuple(mk.shape)}")
        M, K, N = a.shape[0], a.shape[1], cout
        af, wf = a.float(), wmat.float()
        lib = cuda_ms(torch, lambda: torch.matmul(af, wf), 10)
        ms_c = cuda_ms(torch, conv_k, 10)
        ms_cp = cuda_ms(torch, conv_p, 2, warm=1)
        account("fused_lut_conv", count, ms_c, ms_cp, lib,
                x.numel() * 4 + wq.numel() * 4 + lut_bytes + N * 12
                + M * N * 4, M * K * N, err)
        ms_m = cuda_ms(torch, lambda: lut_matmul(a, wmat, lut16, off), 10)
        ms_mp = cuda_ms(torch, lambda: lut_matmul_ref(a, wmat, lut32, off,
                                                      n_codes), 2, warm=1)
        account("lut_matmul", count, ms_m, ms_mp, lib,
                a.numel() * 4 + wmat.numel() * 4 + lut_bytes + M * N * 4,
                M * K * N, max_err(mk, mp))
        print(f"  {name:16s} x{count} GEMM {M}x{K}x{N}: conv {ms_c:.4f} ms "
              f"(plain {ms_cp:.3f}), lut_matmul {ms_m:.4f} ms "
              f"(plain {ms_mp:.3f}), torch.matmul f32 {lib:.4f} ms, "
              f"lookup bound {M * K * N / lookups_per_s * 1e3:.4f} ms",
              flush=True)

    M, K, N = HEAD
    x = torch.relu(torch.randn((M, K), generator=gen, device=dev))
    w = torch.randn((K, N), generator=gen, device=dev)
    xqp = symmetric_qparams(torch.clamp_min(x.abs().amax(), 1e-6), 8)
    wqp = symmetric_qparams(torch.clamp_min(w.abs().amax(dim=0), 1e-9), 8,
                            axis=1)
    wq = acu_operand(quantize(w, wqp), wqp)
    args = (xqp.scale, xqp.zero_point, wqp.scale)
    dense_k = lambda emit=False: fused_lut_dense(x, wq, lut16, off, *args,
                                                 emit_acc=emit)
    dense_p = lambda emit=False: fused_lut_dense_ref(
        x, wq, lut32, off, n_codes, *args, emit_acc=emit)
    yk, yp, ak, ap = dense_k(), dense_p(), dense_k(True), dense_p(True)
    check(torch.equal(yk, yp) and torch.equal(ak, ap),
          f"fused_lut_dense head: f32 and int32 outputs bitwise equal to "
          f"the plain version {tuple(yk.shape)}")
    a = acu_operand(quantize(x, xqp), xqp)
    mk, mp = lut_matmul(a, wq, lut16, off), \
        lut_matmul_ref(a, wq, lut32, off, n_codes)
    check(torch.equal(mk, mp), "lut_matmul head: int32 bitwise equal to "
                               "the plain version")
    af, wf = a.float(), wq.float()
    lib = cuda_ms(torch, lambda: torch.matmul(af, wf), 20)
    head_bytes = M * K * 4 + K * N * 4 + lut_bytes + M * N * 4
    account("fused_lut_dense", 1, cuda_ms(torch, dense_k, 20),
            cuda_ms(torch, dense_p, 5), lib, head_bytes + N * 4 + 8,
            M * K * N, max(max_err(yk, yp), max_err(ak, ap)))
    account("lut_matmul", 1,
            cuda_ms(torch, lambda: lut_matmul(a, wq, lut16, off), 20),
            cuda_ms(torch, lambda: lut_matmul_ref(a, wq, lut32, off,
                                                  n_codes), 5),
            lib, head_bytes, M * K * N, max_err(mk, mp))

    # -- 3. serve ResNet-20 ------------------------------------------------
    print(f"serving {N_IMAGES} images, ResNet-20 (width 16, 3 blocks/stage),"
          f" {MULT}, slots={BATCH}:")
    params = init_resnet(seed=0, device=dev)
    images = next(image_task(size=32)(N_IMAGES))["image"]
    engines = {
        "fused": VisionServeEngine(params, resnet_forward, slots=BATCH,
                                   acfg=ApproxConfig(acu=acu), device=dev),
        "unfused": VisionServeEngine(
            params, resnet_forward, slots=BATCH, device=dev,
            acfg=ApproxConfig(acu=make_acu(MULT, "lut", use_kernels=True))),
    }
    ops = {"lut_matmul": lut_matmul, "fused_lut_dense": fused_lut_dense,
           "fused_lut_conv": fused_lut_conv}
    path_kernels = {"fused": ("fused_lut_conv", "fused_lut_dense"),
                    "unfused": ("lut_matmul",)}
    launches, logits, rates = {}, {}, {}
    for name, eng in engines.items():
        eng.run(images[:BATCH])                    # warm-up wave
        torch.cuda.synchronize()
        for op in ops.values():
            op.launches = 0
        t0 = time.perf_counter()
        logits[name] = eng.run(images)
        dt = time.perf_counter() - t0
        counts = {k: op.launches for k, op in ops.items()}
        rates[name] = N_IMAGES / dt
        print(f"  {name}: {rates[name]:.1f} images/s ({dt:.3f} s for "
              f"{N_IMAGES}), launches {counts}")
        for k in path_kernels[name]:
            launches[k] = counts[k]
            check(counts[k] > 0, f"{name} path launched {k} ({counts[k]}x)")
    waves = N_IMAGES // BATCH
    n_convs = sum(c[-1] for c in CONVS)
    check(launches["fused_lut_conv"] == waves * n_convs
          and launches["fused_lut_dense"] == waves
          and launches["lut_matmul"] == waves * (n_convs + 1),
          f"launch counts match the {n_convs} convs + 1 dense per wave")
    lf, lu = logits["fused"], logits["unfused"]
    check(lf.shape == (N_IMAGES, 10) and bool(np.isfinite(lf).all()),
          f"logits finite, shape {lf.shape}")
    check(np.array_equal(lf, lu), "fused and unfused logits bitwise equal")
    plain = VisionServeEngine(
        params, resnet_forward, slots=BATCH, device=dev,
        acfg=ApproxConfig(acu=make_acu(MULT, "lut", use_kernels=False)))
    lp = plain.run(images[:BATCH])
    check(np.array_equal(lf[:BATCH], lp),
          "one wave's logits equal the plain PyTorch forward on the card")
    small = images[:4]
    cpu_params = {k: v.cpu() for k, v in params.items()}
    on_cpu = VisionServeEngine(cpu_params, resnet_forward, slots=4,
                               acfg=ApproxConfig(acu=acu), device="cpu")
    on_gpu = VisionServeEngine(params, resnet_forward, slots=4,
                               acfg=ApproxConfig(acu=acu), device=dev)
    check(np.array_equal(on_gpu.run(small), on_cpu.run(small)),
          "a 4-image wave gives the same logits on the card and on the CPU")

    for name, eng in engines.items():
        profile_wave(torch, name, eng, images[:BATCH],
                     1e3 * BATCH / rates[name])

    # -- 4. report ---------------------------------------------------------
    rows = []
    for name, (source, replaces) in KERNELS.items():
        s = stats[name]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": s["err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": "operations" if s["t_ops"] >= s["t_bytes"]
            else "bytes",
            "library_ms": s["lib_ms"]})
    print("per wave of 256 images (ms summed over the wave's calls): "
          + ", ".join(f"{r['name']} {r['ms']:.3f} ms vs bound "
                      f"{r['bound_ms']:.3f}" for r in rows))
    print(f"images/s: fused {rates['fused']:.1f}, "
          f"unfused {rates['unfused']:.1f}")
    if check.failures:
        print(f"chip_smoke: {len(check.failures)} check(s) failed",
              file=sys.stderr)
        return 1
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

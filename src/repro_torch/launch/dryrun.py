"""Dry-run: count every (arch x shape) cell's step on ``meta`` tensors and
report its roofline terms on one H100 (port of ``repro.launch.dryrun``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh host --out results.json
  ... --mesh both            (the production meshes' plans, no costs)
  ... --variant causal_blocking       (hillclimb variants, see VARIANTS)

Nothing here touches a device: the step runs on ``meta`` arguments under
``launch/roofline.py``'s counter, at full width and depth. ``--mesh host``
(1 x 1, the one H100, the default) counts the costs. ``pod``, ``multipod``
and ``both`` record the planner's reports and each device's argument bytes
under its partition specs; their cost fields are null, since a mesh of
more devices is not costed yet (ROADMAP.md, queue 1, item 16c).
``--no-probe`` is accepted for the reference's command line and changes
nothing: the reference probes two unrolls because XLA counts a scan body
once, and the port's step runs every layer.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

from repro_torch.configs import ARCH_NAMES, SHAPES, eligible, get_config
from repro_torch.launch import roofline
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.launch.specs import build_step, make_acfg


def _padded_heads(cfg):
    """Pad q heads to a multiple of 16 and kv heads to a divisor of that."""
    h = cfg.n_heads + (-cfg.n_heads) % 16
    kv = cfg.n_kv_heads
    while h % kv != 0:
        kv += 1
    return {"n_heads": h, "n_kv_heads": kv}


# §Perf hillclimb variants: named config transformations. The reference's
# remat and RWKV-chunk variants are left out: they set fields of its scans,
# which the port's models do not read, so their counts would be the
# baseline's.
VARIANTS = {
    "baseline": lambda cfg: cfg,
    # skip fully-masked KV blocks in causal chunked attention (~2x attn FLOPs)
    "causal_blocking": lambda cfg: dataclasses.replace(
        cfg, attn_causal_blocking=True),
    # larger attention chunk: fewer, bigger GEMMs
    "chunk2k": lambda cfg: dataclasses.replace(cfg, attn_chunk=2048),
    "chunk1k": lambda cfg: dataclasses.replace(cfg, attn_chunk=1024),
    # hillclimb #1 baseline reproduction: replicated MoE dispatch buffer
    "moe_replicated_dispatch": lambda cfg: dataclasses.replace(
        cfg, moe_shard_dispatch=False),
    # pad attention heads to the next multiple of the model axis so they
    # shard (zero-weight heads are exact); production would zero-pad weights
    "pad_heads": lambda cfg: dataclasses.replace(
        cfg, **_padded_heads(cfg)),
    "pad_heads_causal": lambda cfg: dataclasses.replace(
        cfg, attn_causal_blocking=True, **_padded_heads(cfg)),
}

MESHES = {"1x1": make_host_mesh, "16x16": make_production_mesh,
          "2x16x16": lambda: make_production_mesh(multi_pod=True)}
MESH_CHOICES = {"host": ("1x1",), "pod": ("16x16",),
                "multipod": ("2x16x16",), "both": ("16x16", "2x16x16")}
COST_KEYS = ("flops", "bytes", "lookups", "coll_bytes", "coll_breakdown",
             "peak_memory", "t_compute", "t_memory", "t_collective",
             "bottleneck", "step_time_lb", "kernels", "model_flops",
             "min_bytes", "t_memory_min", "step_time_min",
             "useful_ratio", "roofline_frac", "memory_analysis")


def count_cell(arch: str, shape_name: str, *, mesh_name: str = "1x1",
               variant: str = "baseline", verbose: bool = True,
               acu: str | None = None) -> dict:
    """Count one cell (on a mesh of one device) or plan it (on a larger
    mesh); returns the roofline record."""
    cfg = VARIANTS[variant](get_config(arch))
    shape = SHAPES[shape_name]
    ok, why = eligible(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": why}
    mesh = MESHES[mesh_name]()
    n_dev = mesh.size
    t0 = time.monotonic()
    bundle = build_step(cfg, shape, mesh, acfg=make_acfg(acu))
    rec = {
        "arch": arch, "shape": shape_name, "variant": variant, "acu": acu,
        "mesh": mesh_name, "n_devices": n_dev, "kind": shape.kind,
        "n_groups": cfg.n_groups,
        "arg_bytes": roofline.per_device_arg_bytes(bundle),
        "plan_report": bundle.meta.get("plan_report", []) +
        bundle.meta.get("cache_report", []),
    }
    if "n_microbatches" in bundle.meta:
        rec["n_microbatches"] = bundle.meta["n_microbatches"]
    if "moe_dispatch" in bundle.meta:   # resolved MoE dispatch geometry
        rec["moe_dispatch"] = bundle.meta["moe_dispatch"]
    if n_dev > 1:
        rec.update({k: None for k in COST_KEYS})
        rec["note"] = ("costs not counted: the steps, collectives and "
                       "costs of a mesh of more than one device are not "
                       "ported (ROADMAP.md, queue 1, item 16c)")
        rec["compile_s"] = round(time.monotonic() - t0, 1)
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} ({mesh_name}, {variant}): "
                  f"args/dev={rec['arg_bytes'] / 2**30:.2f}GiB; "
                  f"{'; '.join(rec['plan_report']) or 'no fallbacks'}",
                  flush=True)
        return rec

    total, out = roofline.count_with_outputs(bundle)
    if "wkv" not in total.kernels:
        # the nested recurrence, where kernel 12's rule did not count it
        dfl, dby = roofline.recurrence_correction(cfg, shape, n_dev)
        total = dataclasses.replace(total, flops=total.flops + dfl,
                                    bytes_accessed=total.bytes_accessed + dby)
    mf = roofline.model_flops(cfg, shape, n_dev)
    donated = sum(roofline.tree_bytes(bundle.args[i])
                  for i in bundle.donate_argnums)
    rec.update({
        **total.as_dict(),
        "model_flops": mf,
        "useful_ratio": mf / total.flops if total.flops else 0.0,
        "roofline_frac": (mf / roofline.PEAK_BF16) / total.step_time
        if total.step_time else 0.0,
        "memory_analysis": {
            "argument_bytes": total.arg_bytes,
            "output_bytes": roofline.tree_bytes(out),
            "temp_bytes": total.peak_memory - total.arg_bytes,
            "alias_bytes": donated,
        },
        "compile_s": round(time.monotonic() - t0, 1),
    })
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} ({mesh_name}, {variant}): "
              f"T_comp={total.t_compute*1e3:.2f}ms T_mem={total.t_memory*1e3:.2f}ms "
              f"T_coll={total.t_collective*1e3:.2f}ms -> {total.bottleneck}; "
              f"T_min={total.step_time_min*1e3:.2f}ms; "
              f"useful={rec['useful_ratio']:.2f} roofline={rec['roofline_frac']:.2%} "
              f"args/dev={total.arg_bytes/2**30:.2f}GiB "
              f"peak={total.peak_memory/2**30:.2f}GiB ({rec['compile_s']}s)",
              flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=list(MESH_CHOICES), default="host")
    ap.add_argument("--variant", default="baseline", choices=list(VARIANTS))
    ap.add_argument("--acu", default=None,
                    help="emulate an ACU on every GEMM: 'mult:mode[:rank]'")
    ap.add_argument("--no-probe", action="store_true",
                    help="accepted for the reference's command line; the "
                         "port counts every layer, so there is no probe")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s) for a in ARCH_NAMES for s in SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch/--shape or --all")

    records = []
    for a, s in cells:
        for mesh_name in MESH_CHOICES[args.mesh]:
            try:
                records.append(count_cell(a, s, mesh_name=mesh_name,
                                          variant=args.variant, acu=args.acu))
            except Exception as e:  # noqa: BLE001 — report, don't abort the sweep
                print(f"[dryrun] FAILED {a} x {s} ({mesh_name}): "
                      f"{type(e).__name__}: {e}", flush=True)
                records.append({"arch": a, "shape": s, "mesh": mesh_name,
                                "error": f"{type(e).__name__}: {e}"})
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
        print(f"[dryrun] wrote {len(records)} records to {args.out}")
    failed = [r for r in records if "error" in r]
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

"""Serving launcher: batched greedy decoding through the port's LM engines.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
        [--reduced] [--approx mul8s_1L2H:lut] [--requests 8] \\
        [--new-tokens 16] [--continuous | --paged] [--arrival-rate 0.5] \\
        [--block-size 16] [--hbm-budget BYTES] [--device cuda]

The flags are the reference launcher's (``repro.launch.serve``), plus
``--device`` (``cuda`` unless given). ``--approx MULT:lut`` builds the
kernel ACU (``use_kernels=True, fused=True``): every GEMM runs the fused
LUT dense kernel and attention the approximate flash attention kernel,
contiguous or paged; in an MoE model (``granite-moe-3b-a800m``,
``olmoe-1b-7b``) every projection's expert GEMMs run the ragged grouped
kernel, one launch each; in ``rwkv6-3b`` the time mix's recurrence runs the
WKV kernel (wave and continuous engines; ``--paged`` raises, as the
reference's paged cache refuses a pattern without attention). Every weight
is quantized on every call by the quantize kernel. The reference
launcher's ACU has ``use_pallas=False``,
so there attention stays exact and only the GEMMs are approximate.
Parameters are random, from seed 0 (``init_params``).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.launch.specs import make_acfg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--approx", default=None)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--continuous", action="store_true")
    ap.add_argument("--paged", action="store_true",
                    help="paged-KV continuous engine (block pool + prefix "
                         "reuse)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="KV block size in tokens (paged only; pow2 >= 8)")
    ap.add_argument("--hbm-budget", type=int, default=None,
                    help="KV pool budget in bytes (paged only; default = "
                         "slots * max_seq contiguous footprint)")
    ap.add_argument("--arrival-rate", type=float, default=None,
                    help="Poisson arrivals per decode step "
                         "(continuous/paged only)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core.acu import AttnSpec, attn_plan
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import (ContinuousServeEngine,
                                          PagedContinuousServeEngine,
                                          Request, ServeEngine,
                                          kv_block_bytes, poisson_arrivals)

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    params = init_params(0, cfg, device=args.device)
    acfg = make_acfg(args.approx)
    max_seq = 256
    if args.paged:
        eng = PagedContinuousServeEngine(
            params, cfg, slots=args.slots, max_seq=max_seq,
            block_size=args.block_size, acfg=acfg,
            hbm_budget=args.hbm_budget, device=args.device)
        bbytes = kv_block_bytes(cfg, args.block_size)
        print(f"paged pool: {eng.n_blocks} blocks x {args.block_size} tok "
              f"({bbytes} B/block, budget {eng.hbm_budget} B, "
              f"{eng.n_logical} logical blocks/slot)")
        if acfg is not None:
            spec = AttnSpec(hq=cfg.n_heads, hkv=cfg.n_kv_heads,
                            bk=args.block_size, kv_layout="paged")
            plan = attn_plan(acfg.acu, spec, a_bits=acfg.a_bits)
            for k, v in plan.describe().items():
                print(f"attn_plan.{k}: {v}")
    else:
        cls = ContinuousServeEngine if args.continuous else ServeEngine
        eng = cls(params, cfg, slots=args.slots, max_seq=max_seq, acfg=acfg,
                  device=args.device)
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(1, cfg.vocab_size,
                                        rng.integers(4, 12)).astype(np.int32),
                    max_new_tokens=args.new_tokens)
            for _ in range(args.requests)]
    slotted = args.continuous or args.paged
    arrivals = None
    if args.arrival_rate is not None:
        if not slotted:
            ap.error("--arrival-rate needs --continuous or --paged")
        arrivals = poisson_arrivals(len(reqs), args.arrival_rate, seed=0)
    t0 = time.monotonic()
    done = eng.run(reqs, arrivals) if slotted else eng.run(reqs)
    dt = time.monotonic() - t0
    n_tok = sum(len(r.out) for r in done)
    print(f"served {len(done)} requests, {n_tok} tokens in {dt:.2f}s "
          f"({n_tok / dt:.1f} tok/s) on {eng.device}")
    if slotted:
        print(f"stats: {eng.stats}")
    for i, r in enumerate(done[:4]):
        print(f"req{i}: {list(r.prompt)[:6]}... -> {list(r.out)[:8]}...")
    return done


if __name__ == "__main__":
    main()

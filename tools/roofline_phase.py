"""Runs ``chip_smoke.py``'s roofline phase alone on the card: builds the
kernels that phase launches (2, 3 and 8), counts the batch cuts in a
worker process and measures SmolLM-135M's whole steps against their
counted bounds, as the whole script does in its phase 14.

Usage, from the repository's root, on a machine with one CUDA card:
  python3 tools/roofline_phase.py
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    t0 = time.time()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    sys.stdout.reconfigure(line_buffering=True)
    import numpy as np
    import torch
    import chip_smoke as CS
    from repro_torch.kernels import runtime
    from repro_torch.kernels.flash_attention.ops import approx_flash_attention
    from repro_torch.kernels.fused_lut_dense.ops import fused_lut_dense
    from repro_torch.kernels.quantize.ops import quantize
    if not torch.cuda.is_available():
        print("roofline_phase: no CUDA device", file=sys.stderr)
        return 1
    print(torch.__version__, torch.version.cuda,
          CS.nvidia_smi("name,power.limit"))
    cuts = CS.start_roofline_cuts()
    t = time.time()
    runtime.BUILDER.build_all(("quantize", "fused_lut_dense",
                               "approx_flash_attention"))
    print("build", round(time.time() - t, 1))
    torch.backends.cuda.matmul.allow_tf32 = False
    check = CS.Check()
    ops = {"quantize": quantize, "fused_lut_dense": fused_lut_dense,
           "approx_flash_attention": approx_flash_attention}
    launches = {k: 0 for k in ops}
    out = CS.roofline_phase(torch, np, torch.device("cuda"), check, ops,
                            launches, cuts)
    print(out)
    print("launches", launches)
    print("failures", check.failures)
    print("total", round(time.time() - t0, 1))
    return 1 if check.failures else 0


if __name__ == "__main__":
    sys.exit(main())

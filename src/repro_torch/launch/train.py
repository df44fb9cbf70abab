"""Training launcher: an LM trained through ``loss_fn`` by the port's
``Trainer``, with checkpoints and failure resume.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        [--steps N] [--batch 8] [--seq 256] [--approx mul8s_1L2H:lut] \\
        [--ckpt DIR] [--reduced] [--device cuda]

The flags are the reference launcher's (``repro.launch.train``), plus
``--device`` (``cuda`` unless given). As there, the vocabulary is cut to
at most 4096 tokens (padded to a multiple of 16), the data is
``MarkovLM(vocab, seed=0)`` behind a ``Prefetcher``, the optimizer AdamW
on a cosine schedule (3e-4, 100 warm-up steps, weight decay 0.01), and the
trainer checkpoints every 100 steps and at the last into ``--ckpt`` (a
directory under the temp dir unless given); a second run with the same
``--ckpt`` resumes from its newest checkpoint. ``--approx MULT:MODE[:RANK]``
builds the kernel ACU (``use_kernels=True, fused=True``): every GEMM's
forward runs the fused LUT dense kernel, the backward the exact STE.
Parameters are random, from seed 0 (``init_params``).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

from repro_torch.launch.specs import make_acfg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--approx", default=None, help="mult:mode[:rank]")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                    "repro_torch_train_ckpt"))
    ap.add_argument("--reduced", action="store_true",
                    help="width-reduced config (CPU-sized)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data.pipeline import MarkovLM, Prefetcher
    from repro_torch.models.transformer import init_params, loss_fn
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    cfg = dataclasses.replace(cfg, vocab_size=min(cfg.vocab_size, 4096),
                              vocab_pad_mult=16)
    acfg = make_acfg(args.approx)

    lm = MarkovLM(vocab=cfg.vocab_size, seed=0)
    params = init_params(0, cfg, device=args.device)
    opt = AdamW(lr=cosine_schedule(3e-4, 100, args.steps), weight_decay=0.01)

    trainer = Trainer(
        lambda p, b: loss_fn(p, b["tokens"], b["labels"], cfg, acfg), opt,
        TrainerConfig(ckpt_dir=args.ckpt, ckpt_every=100, log_every=20))
    data = Prefetcher(lm.batches(args.batch, args.seq), depth=2,
                      device=args.device)
    try:
        trainer.fit(params, opt.init(params), data, args.steps)
    finally:
        data.close()
    for h in trainer.history[-10:]:
        print(h)
    return trainer


if __name__ == "__main__":
    main()

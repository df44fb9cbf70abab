#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

1. builds the fourteen hand-written CUDA kernels from the thirteen sources
   in ``src/repro_torch/csrc`` (one ``nvcc`` per source, all started
   together);
2. holds each forward kernel (lut_matmul, fused_lut_dense, fused_lut_conv)
   against its plain PyTorch version on the card, bitwise, at every GEMM
   shape of a ResNet-20 wave of 256 CIFAR-sized images, with each
   shape's lut_matmul plan and fused_lut_conv tiling, and times kernel,
   plain version and a yardstick there (``F.conv2d`` in f32, TF32 off, for
   fused_lut_conv; ``torch.matmul`` for the others); err_matmul (the
   LOWRANK GEMM, rank 8, on the tensor cores in 3xTF32) at the same shapes
   within its summation bound, rounding to lut_matmul's integers where the
   bound allows, with its FMA and TF32 bounds and how far one plain TF32
   pass (emulated) lies from the summation bound at each shape; at stage
   0 a planted fault (one tile's exact term without its last k) that the
   hold must catch, and its bank-conflict replay (real codes against code
   0 everywhere);
3. does the same for the backward kernels (fused_lut_bwd, float32 and
   emit_acc, with its plan; fused_lut_conv_bwd_w with its tiling; and
   lut_matmul with its stream-K plan at the unfused route's weight-gradient
   shapes) at every gradient GEMM shape of one ResNet-20 training step at
   batch 128;
4. serves 1024 images from ``image_task(size=32)`` through
   ``VisionServeEngine(slots=256)`` with ResNet-20 at full width (random
   weights from a seed), once with the fused ACU (fused conv + fused dense
   kernels) and once with the unfused one (im2col + lut_matmul), each with
   the launch counters set to 0 just before and read just after; checks that
   both give the same logits bit for bit, that one wave equals the plain
   PyTorch forward on the card, and that a small batch equals the CPU run;
   then profiles one wave of each (device time by kernel, idle share);
5. retrains the same ResNet-20 with ``Trainer.fit`` (SGD, lr 1e-3, momentum
   0.9, batch 128) for a few steps in each of the three regimes (exact STE
   backward; approximate backward on the fused ACU; on the unfused ACU),
   each with the launch counters set to 0 just before and read just after
   and checked against the launches one step must make; checks that every
   loss is finite and that one 4-image step gives the CPU's loss and
   gradients; then profiles one step of each regime;
6. serves SmolLM-135M (30 layers, d 576, 9 heads over 3 KV heads, vocab
   49152, bf16, random weights from a seed) with the fused ACU through the
   three LM engines (waves, continuous, paged KV): first holds the
   approximate flash attention kernels (contiguous and paged) against their
   plain versions on the card (every element within the summation-order ulp
   term, at most ATTN_FLIP_ROWS rows beyond it by one code flip), the
   paged kernel's decode path (one item per batch row and KV head) also
   under a biased table, with a planted fault (one batch row's page table
   shifted by one page) shown beyond that tolerance, the contiguous
   kernel's decode path (one item per batch row and KV head, the
   reference's 128-key blocks streamed 32 keys a stage) under both tables
   with left-padded rows, a padded q tile that reaches a block its row
   never sees and a fully masked first block, with a planted fault
   (kv_start shifted by one block) beyond that tolerance and timed against
   the general path and SDPA in the same call, and the fused dense
   kernel bitwise (at M = 32 also its raw accumulator on a biased table),
   at the slice's decode and prefill shapes, with each shape's work plan;
   then serves 64
   requests (prompts of 16 to 200 tokens, 16 of them sharing a 128-token
   prefix, 64 new tokens each) through each engine with the launch counters
   set to 0 just before and checked just after against 30 attention,
   211 dense and 211 quantize launches per model call, every decode call's
   attention on its kernel's decode path and no other; checks one short
   request against the CPU run's tokens; profiles one decode step of each
   KV layout;
6b. holds the fused dense kernel (kernel 3) where its work plan matters:
   prints the plan (tile, items, splits, SMs with work, tile rows past M)
   at every M = 32 GEMM of SmolLM-135M, granite-moe-3b-a800m, rwkv6-3b and
   CNN-224 and checks that each keeps every SM busy with no row past M;
   holds it bitwise, float32 and the raw accumulator on a biased table, at
   M = 1, M = 33, a ragged K, rwkv6-3b's 2560 x 2560 and CNN-224's f1
   (32 x 200,704 x 512, its first and last 32 columns) and f2; shows a
   planted fault (a plan with one K split dropped) caught; times the
   rwkv6-3b GEMM and f1 and f2; and measures bank conflicts: the kernel
   on real codes against codes that put a warp's 32 gathers in 32 banks,
   beside the same measurement on kernel 4 (fused_lut_bwd);
6c. kernels 1 and 5 on the narrow-N core (csrc/lut_narrow.cuh) at
   ResNet-20's widths N = 16, 32 and 64: the bank-conflict replay of each
   and of kernel 4 at the same GEMM shapes, and a planted fault of each
   (kernel 5: a tiling with its last channel group dropped; kernel 1: a
   plan with a stream-K segment dropped), each caught;
6d. kernels 4 and 7 on the narrow-N core: each one's plan or tiling at
   CNN-224's ``approx_bwd`` conv (``CONV_BWD``), both bitwise equal to
   their plain versions there (kernel 4 float32 and emit_acc) and timed
   against the lookup bound and ``torch.matmul``; both on a biased table
   at a ragged shape; a planted fault each (kernel 4: a plan whose first
   item stops one K group short; kernel 7: a tiling that leaves its last
   band of output rows out), each caught; the bank-conflict replay of each
   at ResNet-20's gradient shapes of stages 0, 1 and 2;
7. runs Table 4's emulation-mode ladder on ResNet-20 at full width, one
   wave of 256 images per row through ``VisionServeEngine``: native (no
   ACU), baseline LUT (the plain one-gather LUT GEMM), the LUT engine fused
   (kernels 5 and 3) and unfused (kernel 1), the FUNCTIONAL closed form on
   the card, LOWRANK at rank 8 (kernel 13, ``err_matmul``) and quant-only
   (EXACT); prints ms per wave and the speedup over the baseline, checks
   each row's exact launch counts, that the four integer-exact rows give
   the same logits bit for bit, and that a 4-image batch gives the CPU's
   logits (bitwise for quant-only, within ``LOWRANK_LOGIT_TOL`` for
   LOWRANK); kernel 13 itself is held against its plain version in step
   2, at every GEMM shape of the wave;
8. runs Table 2's accuracy arc as ``benchmarks/table2_accuracy.py``
   defines it (CNN-vgg, ResNet-mini, SqueezeNet-fire, LSTM-textcls and
   VAE-blobs; fp32 pre-training, then quantized, approximate and retrained
   accuracy for ``mul8s_1L2H`` and ``mul8s_bam8`` on the kernel ACU and
   ``mul12s_2KM`` FUNCTIONAL at 12 bits) on the card and prints its CSV
   rows; every loss must be finite;
9. serves granite-moe-3b-a800m (32 layers, d 1536, 24 heads over 8 KV
   heads, 40 experts top-8, d_ff 512 per expert, vocab 49155, bf16, random
   weights from a seed) with the fused ACU: first holds the ragged grouped
   LUT-GEMM kernel (fused_lut_grouped) against its plain version on the
   card, bitwise, at the gate/up and down shapes of a decode step (640
   groups of 1 capacity row) and of prefills of 128 and 512 tokens (2 and
   8 rows), with counts from layer 0's routing and synthetic ones (empty
   experts, all tokens to one expert), and under a biased table with the
   raw accumulator (dead rows 0), printing each shape's work plan; at the
   decode gate it pins the host's copy of the kernel's split
   (bitwise equal) and a planted fault (the split with one K split
   dropped, which must differ), and replays the bank conflicts (real codes
   against codes that put a warp's gathers in 32 banks); holds kernel 8's
   decode path at the
   model's attention as step 6 does; then serves 32 requests (16 to 200
   prompt tokens, 8 sharing a 128-token prefix, 32 new tokens each)
   through the three engines with the counters checked against 96
   grouped, 129 dense, 225 quantize and 32 attention launches per model
   call, every decode call's attention on its decode path; prints layer 0's
   dropped fraction and aux loss at a decode step and a prefill; checks a
   short request's tokens against the CPU on the model cut to 2 layers;
   profiles one decode step and times the per-call expert weight
   quantization;
10. serves rwkv6-3b (32 layers, d 2560, 40 wkv heads x 64, d_ff 8960,
   vocab 65536, bf16, random weights from a seed) with the fused ACU:
   first holds the WKV recurrence kernel (wkv) against its plain version on
   the card at the decode shape and the engines' prefill shapes (the state
   bitwise, the output within the k-sum's summation-order bound), and the
   quantize kernel (kernel 2) bitwise at every weight shape of rwkv6-3b,
   granite-moe-3b-a800m and ResNet-20 in each broadcast form, in float32
   and bfloat16, with values on half-code boundaries and past the clip,
   each on a vector path of ``quantize_plan`` (``vector_launches`` checked
   against the plan), timed per rwkv6-3b decode step against its bytes
   bound and its time before the redesign, then a ragged per-tensor x
   that starts off a 16-byte boundary (the flat path's head and tail) and
   a planted fault (the plan with its last vector dropped, on an output
   poisoned outside the codes); then serves 32 requests (16 to 200 prompt tokens, 32 new tokens each)
   through the wave and continuous engines with the counters checked
   against 257 dense, 257 quantize and 32 wkv launches per model call;
   checks a short request's tokens against the CPU on the model cut to 2
   layers; profiles one decode step;
10a. holds kernel 12's backward (``wkv_bwd_phase``): the CUDA kernel
   ``csrc/wkv_bwd.cu`` against ``wkv_bwd_ref`` on the card on the same
   saved chunk boundaries, at 40 heads x 64 for T 1, 255, 256 and 1024
   (and 4 x 512), within WKV_BWD_TOL of each gradient's largest entry,
   its ``du`` the same bits in two runs, every state it restores
   (``states_out``) bitwise the forward's, timed against its plain version
   and its bound, with the forward's time and bound at 4 x 512; then
   rwkv6-3b at full width, cut to WKV_TRAIN_LAYERS
   layers, trained for WKV_TRAIN_STEPS AdamW steps through ``loss_fn`` on
   the fused ACU at 4 x 512 tokens: every leaf's gradient finite and
   nonzero (``bonus``, ``lora_B_*``, ``decay_base``), one ``wkv`` and one
   ``wkv_bwd`` launch a layer a step;
10b. runs whisper-small (12 + 12 layers, d 768, 12 heads, head_dim 64,
   d_ff 3072, vocab 51865, bf16, random weights from a seed) with the
   fused ACU: kernel 8's decode path held at its self-attention as step 6
   does; the encoder over 4 x 1500 stub frames, an 8-token prefill into
   the decoder's cache and 32 greedy steps, each call's launches counted
   (encode: 72 dense + 72 quantize; each decoder call: 121 dense + 121
   quantize + 12 approx_flash_attention, none for cross-attention, every
   step's on the decode path); ms of the encode and per step, tokens/s,
   peak memory, a profile of one step and the time of the cross K/V that
   every decoder call recomputes; then the card against the CPU on a
   2 + 2-layer cut: float32 logits without the ACU at the full 1500
   frames within ``SCORE_CPU_TOL`` (planted CPU faults, learned
   positions shifted and a causal cross-attention, beyond it) and greedy
   tokens on the fused ACU at 64 frames;
10c. runs jamba-v0.1-52b at full width, its depth cut to one period of
   its pattern (8 layers: 3 mamba, 4 mamba_moe, 1 attn; d 4096, d_inner
   8192, 32 heads over 8, head_dim 128, 16 experts top-2 of d_ff 14336,
   13.3 G parameters, bf16) with the fused ACU: quantize (kernel 2)
   bitwise at every weight shape, the 16 x 4096 x 14336 expert stacks
   included, in float32 and bfloat16; kernel 10 bitwise against its plain
   version on the first and last 64 columns at the decode and prefill
   expert shapes, the model's expert codes bitwise (plans printed; timed
   against torch.bmm and its bound); kernels 2 and 3 at each dense GEMM
   shape (in_proj, x_proj, dt_proj, out_proj, q/o, k/v, gate/up, down,
   head) at M = 8 and 512, the model's codes bitwise and kernel 3's
   output on its first and last 64 columns; kernel 8's decode path at
   head dim 128; 8 requests of 64
   prompt tokens and 16 new tokens through the wave and continuous
   engines (45 dense + 12 grouped + 57 quantize + 1 attention launches
   per model call, every decode call's attention on its decode path);
   the paged engine's refusal; profiles of a decode step and a prefill
   of 8 x 64 and the selective scan's share of that prefill's device
   time; the expert weight glue per call; peak memory; and the reduced
   config's tokens on the card against the CPU's, through both engines;
11. scores gemma2-27b (46 layers, d 4608, 32 heads over 16 KV heads,
   head_dim 128, d_ff 36864, vocab 256000, local layers with a 4096-key
   window, softcaps 50 and 30, bf16, random weights from a seed) through
   ``loss_fn`` with ``attn_impl="flash"`` and the fused ACU: first holds
   the exact flash attention kernel (flash_attention, kernel 11) against
   its plain version on the card, every element within
   ``flash_tolerance``, at the model's local and global layers (and
   against ``gqa_attention(impl="chunked")`` there), at a local layer
   with q scaled 10x (scores where the softcap bites), at a ragged S, at
   Sq < Sk and at SmolLM-135M's heads in float32, and shows that planted
   faults of the plain version (window off by one, softcap dropped, first
   KV tile dropped) lie beyond that tolerance, and so does the kernel
   run on its plan with the heaviest item's last KV tile dropped; times
   kernel, plain version and SDPA (which has no softcap) at the model's
   dtype and on float32 operands (naming the kernel PyTorch ran) at the
   model's shapes, beside the TF32, split-TF32 and FP32 CUDA-core bounds
   and the kernel's time before its redesign; holds
   quantize and fused_lut_dense bitwise at every GEMM shape of the
   forward (M = 4352, full K and N; the plain GEMM on the first and last
   columns); then scores one sequence of 4352 MarkovLM tokens under
   ``torch.no_grad()`` with the counters checked against 46
   flash_attention, 323 dense and 323 quantize launches per forward,
   profiled, and prints the loss, scored tokens/s and peak memory; then
   holds the card against the CPU on the model cut to one local and one
   global layer (float32, no ACU, q projections scaled 10x: logits within
   ``SCORE_CPU_TOL``, and planted faults on the CPU side beyond it);
12. runs ImageNet-scale convs: first holds the banded fused conv kernel
   (fused_lut_conv_tiled, kernel 6) against its plain version and against
   the whole-image kernel (fused_lut_conv), bitwise, f32 and int32, at
   VGG-16's conv1_2 (8x64x224^2 -> 64) and conv2_2 (8x128x112^2 -> 128),
   the CNN's c2 (32x64x112^2 -> 128), stride 2, dilation 2, a band height
   that does not divide Ho and a biased table at odd C (where a planted
   fault, a tiling with its last channel group dropped, must be caught),
   and times kernel 6, kernel 5 (in the same call), the plain version and
   ``F.conv2d`` (f32, TF32 off) at the first three against the gather
   bound, with each one's tiling (kernel 5's too), grid and blocks per SM,
   and kernel 6's bank-conflict replay at c2; holds kernel 5 bitwise at
   CNN-224's c1 and c3 and times it there against ``F.conv2d`` and the
   gather bound; then serves 128 images of
   ``image_task(n_classes=1000,
   size=224)`` through ``VisionServeEngine(slots=32)`` with the CNN at
   VGG-16's stage widths (``init_cnn(width=64, img=224)``) on the fused
   ACU: each conv's route from ``plan_report`` (c2 tiled, as the reference
   routes it), exact launch counts (per wave 2 fused_lut_conv, 1
   fused_lut_conv_tiled, 2 fused_lut_dense, 5 quantize), one wave's
   logits bitwise equal to the unfused ACU's (im2col + lut_matmul), a
   profile of one wave; one ``approx_bwd`` step of conv2d at 2x64x224^2
   -> 64 on the tiled and the whole-image route (gradients bitwise equal,
   launch counts checked); a separable block (depthwise 3x3 on
   8x32x112^2, then 1x1 -> 64) and a groups=4 conv on the fused ACU,
   bitwise equal to the CPU's, launch counts checked;
13. trains SmolLM-135M at full width and depth (bf16, the vocabulary cut
   to 4096 as ``launch/train.py`` cuts it) through ``loss_fn`` with the
   port's ``Trainer`` at batch 8 x 256 tokens on the fused ACU: first
   holds quantize and fused_lut_dense bitwise at every GEMM shape of a
   training step (M = 2048; the tied head's transposed weight view) and
   fused_lut_bwd at every dense gradient shape of an ``approx_bwd`` step
   (the 4096-column head's too), each timed against its plain version, a
   PyTorch call and its bound; runs one step twice from one state
   (gradients bitwise equal, both regimes); then, with AdamW as the
   launcher builds it and a ``Prefetcher`` on the card, an uninterrupted
   run with async checkpoints, the same run with two failures planted
   between checkpoints (the rolled-back batches replay) and a fresh
   restart (a new ``Trainer`` and iterator), all three bitwise equal in
   parameters, optimizer state and consumed count, with exactly the
   planted restores in ``history``; a damped run whose ``accum`` grows,
   and the same with failures planted mid-schedule, bitwise equal; launch
   counts per step (kernels 3 and 2 per GEMM, kernel 4 twice under
   ``approx_bwd``); steps/s and trained tokens/s in both regimes with a
   profile of one step, peak memory, checkpoint bytes and every save's
   and restore's seconds; and the card against the CPU on a two-layer
   float32 cut without the ACU (losses and updates within
   ``SCORE_CPU_TOL``, a planted CPU fault beyond it);
14. measures a whole step against its roofline (``roofline_phase``):
   prints the card's achieved bf16 ``torch.matmul`` rate (8192^3) and
   device-copy bandwidth beside the data-sheet constants of
   ``launch/roofline.py``; builds SmolLM-135M's train_4k, prefill_32k
   and decode_32k steps with ``launch/specs.py: build_step`` at the
   shape's seq_len, the global batch cut to the largest power of two
   whose counted peak (``count_step`` on ``meta``) fits ROOFLINE_MEM and
   whose counted bound is at most ROOFLINE_LB_S (batch 1 if none; the
   cuts are counted in a worker process from the script's start), runs
   each exact (2 warm-up steps, ROOFLINE_STEPS timed with CUDA events)
   and prints the median step, the counted ``CellCost`` of the same cut, ``model_flops``, the roofline share (the eager graph's
   bound ``step_time_lb`` / measured) beside the floor share (the
   algorithmic ``step_time_min`` / measured), neither of which may pass
   1.05, and MFU; the same for the decode step on the fused ACU (kernels
   2, 3 and 8, their launches per step equal to the count's calls); each
   step's output bitwise equal to the direct call (``apply_model``; the
   train step's loss to ``loss_fn`` on its microbatches, combined as the
   step combines them);
14b. runs the mesh runtime (``mesh_phase``): two ranks on the one card
   (``launch/mesh.py: spawn_ranks``, gloo, which goes through the host:
   NCCL refuses two ranks on one device), started after the build; each
   case run under the mesh and as the one-rank call, bitwise: kernel 3 at
   SmolLM-135M's GEMMs (rows over data) and with ``acu_k`` over model at
   a K the axis does not divide on the biased table; kernel 4 at an
   ``approx_bwd`` step's gradients; kernel 10 at granite's expert GEMMs
   (experts over model; ``acu_grouped_k``, its ``emit_acc`` output);
   kernels 8 and 9 at SmolLM's decode; kernels 5, 6 and 7 at ResNet-20's
   stage0 conv and the 1 x 64 x 224 x 224 tiled geometry (output-row
   bands, kernel 7 with ``rmask``); SmolLM-135M data-parallel training
   (global batch MESH_DP_BATCH x 256, MESH_DP_STEPS steps, exact STE on
   the fused ACU) bitwise against a one-process oracle (per-shard
   gradients, the shared amax, int32 sum x scale / W, the same AdamW) and
   a restart from its checkpoint (EF residual included) bitwise equal to
   the run without it; the continuous LM engine (columns over model) and
   ResNet-20's vision engine (rows over data) against their one-rank
   engines; per-step times and the share of collectives;
15. prints the redesigned kernels against their old paths, one
   ``{"kernels": [...]}`` line, then the result line.

Every weight of every approximate GEMM is quantized on every call through
the quantize kernel, so each phase's exact launch counts include it.

Exits nonzero, with no result line, when there is no CUDA device, when it
runs outside the repository, or when any phase fails.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MULT = "mul8s_1L2H"
BATCH = 256            # slots of one wave
N_IMAGES = 1024
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
SPIN_CYCLES_PER_S = 1.98e9  # the SM clock under load (printed by the run)

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
TRAIN_BATCH = 128
TRAIN_STEPS = 10
KERNELS = {
    "lut_matmul": ("src/repro_torch/csrc/lut_matmul.cu",
                   "src/repro/kernels/lut_matmul/kernel.py:56"),
    "fused_lut_dense": ("src/repro_torch/csrc/fused_lut_dense.cu",
                        "src/repro/kernels/fused_lut_dense/kernel.py:179"),
    "fused_lut_conv": ("src/repro_torch/csrc/fused_lut_conv.cu",
                       "src/repro/kernels/fused_lut_conv/kernel.py:153"),
    "fused_lut_bwd": ("src/repro_torch/csrc/fused_lut_bwd.cu",
                      "src/repro/kernels/fused_lut_dense/kernel.py:138"),
    "fused_lut_conv_bwd_w": (
        "src/repro_torch/csrc/fused_lut_conv_bwd_w.cu",
        "src/repro/kernels/fused_lut_conv/kernel.py:289"),
    "approx_flash_attention": (
        "src/repro_torch/csrc/approx_flash_attention.cu",
        "src/repro/kernels/flash_attention/approx.py:250"),
    "approx_flash_attention_paged": (
        "src/repro_torch/csrc/approx_flash_attention.cu",
        "src/repro/kernels/flash_attention/approx.py:431"),
    "err_matmul": ("src/repro_torch/csrc/err_matmul.cu",
                   "src/repro/kernels/err_matmul/kernel.py:55"),
    "fused_lut_grouped": ("src/repro_torch/csrc/fused_lut_grouped.cu",
                          "src/repro/kernels/fused_lut_grouped/kernel.py:113"),
    "quantize": ("src/repro_torch/csrc/quantize.cu",
                 "src/repro/kernels/quantize/kernel.py:27"),
    "wkv": ("src/repro_torch/csrc/wkv.cu",
            "src/repro/kernels/wkv/kernel.py:53"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:76"),
    "fused_lut_conv_tiled": (
        "src/repro_torch/csrc/fused_lut_conv_tiled.cu",
        "src/repro/kernels/fused_lut_conv/kernel.py:387"),
    # no TPU kernel: the reference differentiates its chunked lax.scan
    "wkv_bwd": ("src/repro_torch/csrc/wkv_bwd.cu",
                "src/repro/models/rwkv.py:85"),
}
RANK = 8                   # the LOWRANK rung's factorisation rank
FP32_LANES = 128           # FP32 FMA lanes per SM (Hopper)
TF32_FLOP_PER_S = 495e12   # H100 SXM dense TF32 tensor-core rate
# the launches one wave of each Table 4 ladder row makes (native: none):
# every row with an ACU quantizes its 22 weights on every call, and every
# unfused row its 22 activations too
LADDER_LAUNCHES = {"baseline_lut": {"quantize": 44},
                   "adapt_lut_fused": {"fused_lut_conv": 21,
                                       "fused_lut_dense": 1, "quantize": 22},
                   "adapt_lut_unfused": {"lut_matmul": 22, "quantize": 44},
                   "functional": {"quantize": 44},
                   "lowrank_r8": {"err_matmul": 22, "quantize": 44},
                   "quant_only": {"quantize": 44}}
# LOWRANK logits, card vs CPU, as a fraction of the largest |logit|: every
# GEMM accumulator agrees to well under one unit (the summation bound), so
# the activation codes agree except where a value lies on a rounding
# boundary; each code that flips there moves its downstream accumulators
# by one LUT step, about 1/127 of that layer's range spread over K >= 27
# terms, and a few such flips through 20 layers stay under 2 % of the
# largest logit. A wrong route moves the logits by their own size.
LOWRANK_LOGIT_TOL = 2e-2
# Table 2, as benchmarks/table2_accuracy.py: the three ACU rows
T2_ACUS = ("mul8s_1L2H", "mul8s_hiMRE_bam8", "mul12s_2KM")
# the LM serve phase: SmolLM-135M at full width, bf16; its kernels are held
# and timed at the full model's shapes and counts, its engines serve a cut
# to LM_SERVE_LAYERS of its 30 layers (the script's time limit)
LM_ARCH = "smollm-135m"
LM_SERVE_LAYERS = 10
LM_REQUESTS, LM_SHARED, LM_PREFIX, LM_NEW = 64, 16, 128, 64
LM_SLOTS, LM_MAX_SEQ, LM_BLOCK = 32, 512, 16
LM_WAVE_PROMPT = 200     # the longest prompt: the wave engine's prefill
# the MoE serve phase: granite-moe-3b-a800m at full width, bf16, the LM
# phase's slots, max_seq, paged block and prompt lengths; kernel 10 held
# and timed at the full model's shapes and counts, the engines serving a
# cut to MOE_SERVE_LAYERS of its 32 layers (the script's time limit)
MOE_ARCH = "granite-moe-3b-a800m"
MOE_SERVE_LAYERS = 16
MOE_REQUESTS, MOE_SHARED, MOE_NEW = 32, 8, 32
MOE_CPU_LAYERS = 2       # depth of the card-against-CPU check
# the RWKV serve phase: rwkv6-3b at full width and depth, bf16, the LM
# phase's slots, max_seq and prompt lengths; wave and continuous engines
# (the paged engine pages attention KV only)
RWKV_ARCH = "rwkv6-3b"
RWKV_REQUESTS, RWKV_NEW = 32, 32
RWKV_CPU_LAYERS = 2
# the whisper phase: whisper-small at full width and depth, bf16: the
# encoder over WHISPER_ROWS x enc_ctx (1500) stub frames, a WHISPER_PROMPT-
# token prefill into the decoder's cache, then WHISPER_NEW greedy steps
WHISPER_ARCH = "whisper-small"
WHISPER_ROWS, WHISPER_PROMPT, WHISPER_NEW, WHISPER_MAX_SEQ = 4, 8, 32, 128
WHISPER_CPU_LAYERS = 2   # encoder and decoder layers of the card-vs-CPU cut
WHISPER_CPU_CTX = 64     # frames of the fused-ACU card-vs-CPU check
# the jamba phase: jamba-v0.1-52b at full width, bf16, its depth cut to one
# period of its 8-layer pattern (3 mamba, 4 mamba_moe, 1 attn): the 32
# layers' 51.6 G parameters alone are 96 GiB in bf16, more than the card
JAMBA_ARCH = "jamba-v0.1-52b"
JAMBA_LAYERS = 8
JAMBA_REQUESTS, JAMBA_PROMPT, JAMBA_NEW = 8, 64, 16
JAMBA_SLOTS, JAMBA_MAX_SEQ = 8, 128
JAMBA_COLS = 64          # kernels 3 and 10 plain checks: first, last columns
# the scoring phase: gemma2-27b at full width and depth, bf16, through
# loss_fn with attn_impl="flash" (kernel 11): one sequence of 17 x 256
# tokens, so that 256 query rows lie past the 4096-key window
SCORE_ARCH = "gemma2-27b"
SCORE_TOKENS = 17 * 256
SCORE_CPU_LAYERS = 2     # one local and one global layer
SCORE_CPU_TOKENS = 64
SCORE_CPU_QMUL = 10.0    # q projections scaled: scores reach the softcap
SCORE_COLS = 64          # kernel 3's plain check: first and last columns
# card vs CPU on the 2-layer cut, float32 and no ACU: logits within this
# fraction of the largest |logit|. Every GEMM sums up to 36,864 float32
# products in another order (cuBLAS against the CPU's); such rounding
# errors add like a random walk, a few ulp of the outputs (the sound
# comparison read 2.9e-6 at unit scores and 16 tokens). Planted faults on
# the CPU side (the attention softcap dropped, a window that binds) are
# read on every run, and the script fails unless they lie beyond it.
SCORE_CPU_TOL = 1e-4
# the LM training phase: SmolLM-135M at full width and depth, bf16, with
# launch/train.py's vocabulary cut (4096, padded to 16), batch 8 x 256
# tokens (M = 2048 rows a GEMM), the launcher's AdamW; three runs of
# TRAIN_LM_STEPS steps, checkpoints every TRAIN_LM_EVERY, the failures
# planted before step TRAIN_LM_FAIL_AT (after the first checkpoint)
TRAIN_LM_BATCH, TRAIN_LM_SEQ = 8, 256
TRAIN_LM_STEPS, TRAIN_LM_EVERY, TRAIN_LM_FAIL_AT = 4, 2, 3
# throughput: one step to start the prefetcher, then a window of
# TRAIN_LM_WINDOW steps timed by wall clock (steps / wall, tokens / wall)
TRAIN_LM_WINDOW = 10
# the damped run: the schedule grows accum from its first estimate on
TRAIN_LM_DAMPING = dict(accum_max=4, warmup_updates=1, ema=0.5)
TRAIN_LM_DAMPED_STEPS = 3
# card vs CPU: a 2-layer float32 cut without the ACU, SGD (its update is
# linear in the gradient: AdamW's first step is lr * sign(g), which a
# gradient entry at the rounding level flips by 2 lr), held to
# SCORE_CPU_TOL: losses relative; each parameter within SCORE_CPU_TOL of
# its leaf's largest update, plus one float32 rounding of the parameter a
# step (p - lr * g rounds to the parameter's own ulp: a norm weight near
# 1.0 moved by 1e-4 carries 1e-3 of its update in that rounding alone)
TRAIN_LM_CPU_LAYERS, TRAIN_LM_CPU_BATCH, TRAIN_LM_CPU_SEQ = 2, 2, 32
TRAIN_LM_CPU_STEPS, TRAIN_LM_CPU_LR = 3, 0.1
# the ImageNet-scale conv phase: kernel 6 (fused_lut_conv_tiled) against
# its plain version and kernel 5 at (label, x shape, w shape, stride,
# dilation, pinned band height, table, timed); SAME padding throughout
TILED_CASES = [
    ("VGG-16 conv1_2", (8, 64, 224, 224), (64, 64, 3, 3), 1, 1, 0, "std",
     True),
    ("VGG-16 conv2_2", (8, 128, 112, 112), (128, 128, 3, 3), 1, 1, 0, "std",
     True),
    ("CNN-224 c2", (32, 64, 112, 112), (128, 64, 3, 3), 1, 1, 0, "std",
     True),
    ("stride 2", (8, 64, 112, 112), (128, 64, 3, 3), 2, 1, 0, "std", False),
    ("dilation 2", (8, 64, 56, 56), (64, 64, 3, 3), 1, 2, 0, "std", False),
    ("bh 5 on Ho 56", (8, 64, 56, 56), (64, 64, 3, 3), 1, 1, 5, "std",
     False),
    ("biased, C 37", (4, 37, 56, 56), (48, 37, 3, 3), 1, 1, 0, "biased",
     False),
]
# the VGG-style CNN at VGG-16's stage widths and ImageNet's input, served
# in waves of CNN_SLOTS: per wave c1 and c3 on kernel 5, c2 on kernel 6,
# f1 and f2 on kernel 3, each weight through kernel 2 (unfused: im2col +
# kernel 1 for all five, kernel 2 on weights and activations)
CNN_IMAGES, CNN_SLOTS, CNN_CLASSES = 128, 32, 1000
CNN_WAVE_LAUNCHES = {"fused_lut_conv": 2, "fused_lut_conv_tiled": 1,
                     "fused_lut_dense": 2, "quantize": 5}
CNN_UNFUSED_LAUNCHES = {"lut_matmul": 5, "quantize": 10}
CNN_WIDTH, CNN_IMG = 64, 224
# one approx_bwd conv step (x shape, w shape), banded against whole-image;
# a separable block (x, depthwise w, pointwise w, bias) and a groups=4 conv
# (x, w, bias) on the fused ACU, card against the CPU
CONV_BWD = ((2, 64, 224, 224), (64, 64, 3, 3))
SEPARABLE = [(8, 32, 112, 112), (32, 1, 3, 3), (64, 32, 1, 1), (64,)]
GROUPED = [(8, 64, 56, 56), (64, 16, 3, 3), (64,)]
SMEM_PER_SM = 233_472    # H100: 228 KB per SM, 1 KB of it kept per block
TF32_FLOPS = 495e12      # H100 SXM data sheet, dense TF32 tensor cores
# card vs CPU, one 4-image step: largest gradient difference allowed, as a
# fraction of the tensor's largest entry. exact: float32 sums in another
# order (cuBLAS, cuDNN-free col2im) move entries near cancellation by a
# few ulp of the largest term. approx: the integer sums are exact, but the
# float glue (mean pool, log-sum-exp, bias sums) rounds differently, and a
# gradient code that flips moves one entry by one LUT step times the two
# scales, a few percent of the largest entry at most.
GRAD_TOL = {"exact": 1e-4, "approx_fused": 5e-2, "approx_unfused": 5e-2}
# kernels 8 and 9 against their plain versions on the card: the same expf,
# tanhf and half-to-even rounding give the same codes, so each element is
# held to the summation-order term 4 * bk * eps * max|y| (the normalizer
# and the accumulator sum bk terms per block in another order). At most
# this many query rows may hold elements beyond it, each within one
# probability-code flip: a score on a code boundary whose last ulp the
# reordered sums moved.
ATTN_FLIP_ROWS = 2
# launches of one training step at batch 128, by regime: 21 convs + 1 dense
# forward, each quantizing its weight (and, unfused, its activation) with
# the quantize kernel; the stem has no input gradient; the backward's
# per-tensor quantizers are plain PyTorch
# the roofline phase: SmolLM-135M's three kinds, exact, and the ACU decode
ROOFLINE_ARCH = "smollm-135m"
ROOFLINE_CELLS = (("train_4k", None), ("prefill_32k", None),
                  ("decode_32k", None), ("decode_32k", "mul8s_1L2H:lut"))
ROOFLINE_MEM = 40 * 2 ** 30    # the batch cut: counted peak at most this
ROOFLINE_LB_S = 1.0            # and counted bound at most this, a step
ROOFLINE_STEPS = 5             # timed, after two warm-up steps
ROOFLINE_SHARE_MAX = 1.05      # a share past this means a wrong count
STEP_LAUNCHES = {
    "exact": {"fused_lut_conv": 21, "fused_lut_dense": 1, "quantize": 22},
    "approx_fused": {"fused_lut_conv": 21, "fused_lut_dense": 1,
                     "fused_lut_conv_bwd_w": 21, "fused_lut_bwd": 22,
                     "quantize": 22},
    "approx_unfused": {"lut_matmul": 21 + 21 + 20 + 3, "quantize": 44},
}


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int, warm: int = 2) -> float:
    """Mean device time of one call, from CUDA events around ``reps``
    calls after ``warm`` untimed ones. After a warm-up the card first spins
    (``torch.cuda._sleep``) for longer than the host takes to enqueue the
    ``reps`` calls, so that the events time the card's work and not the
    host's dispatch: a small kernel's wrapper can take longer on the host
    than its kernel on the card. Without a warm-up the host's time is
    included."""
    host_s = float("inf")
    for _ in range(warm):
        t0 = time.perf_counter()
        fn()
        host_s = min(host_s, time.perf_counter() - t0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if warm:
        spin_s = min(2.0 * reps * host_s + 1e-3, 0.5)
        torch.cuda._sleep(int(spin_s * SPIN_CYCLES_PER_S))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def profile(torch, name: str, fn, wall_ms=None, lead: int = 0):
    """Where one call of ``fn`` (a wave, a training step) spends its time:
    device time by kernel (torch.profiler, device-side events only)
    against ``wall_ms``, its wall time measured without the profiler, or,
    when None, the traced call's own wall (the profiler's cost is then in
    it, which a long call of few kernels hides); the rest is the device's
    idle share. ``lead`` launches that many empty spins inside the trace
    before ``fn`` and leaves them out of the rows: late in this script's
    process the CNN-224 wave's trace has lost its first few dozen device
    records (the input copy and the first two convs; one spin ahead of
    them moved that edge by one record). Returns ``fn``'s result, the
    traced wall in ms and the rows (kernel name, device ms, count)."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        if lead:
            for _ in range(lead):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    how = "untraced" if wall_ms is not None else "traced"
    if wall_ms is None:
        wall_ms = traced_ms
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0
            and not e.key.startswith("Activity Buffer")
            and not (lead and "spin_kernel" in e.key)]
    rows.sort(key=lambda r: -r[1])
    if not rows:
        print(f"  profile {name}: no device time in the trace (not measured)")
        return out, traced_ms, rows
    busy = sum(r[1] for r in rows)
    print(f"  profile {name}: device busy {busy:.3f} ms of {wall_ms:.3f} "
          f"ms wall ({how}), idle share {1 - busy / wall_ms:.3f}; "
          f"traced wall {traced_ms:.3f} ms")
    for key, ms, count in rows[:10] + [r for r in rows[10:]
                                       if r[0].startswith("Memcpy")]:
        print(f"    {ms:9.3f} ms  {count:4d}x  {key[:90]}")
    return out, traced_ms, rows


class Check:
    def __init__(self):
        self.failures: list[str] = []

    def __call__(self, ok: bool, what: str) -> None:
        print(f"  [{'ok' if ok else 'FAIL'}] {what}", flush=True)
        if not ok:
            self.failures.append(what)


def lm_requests(np, vocab: int, n: int, shared: int):
    """``n`` requests from a seed: prompts of 16 to 200 tokens, every
    ``n // shared``-th one a shared 128-token prefix plus its own 16 to 72;
    the second is 200 tokens long (the wave engine's prefill)."""
    rng = np.random.default_rng(7)
    prefix = rng.integers(1, vocab, LM_PREFIX)
    top = LM_WAVE_PROMPT + 1
    prompts = []
    for i in range(n):
        if i % (n // shared) == 0:
            tail = rng.integers(1, vocab, rng.integers(16, top - LM_PREFIX))
            prompts.append(np.concatenate([prefix, tail]))
        else:
            prompts.append(rng.integers(1, vocab, rng.integers(16, top)))
    prompts[1] = rng.integers(1, vocab, LM_WAVE_PROMPT)
    return [p.astype(np.int32) for p in prompts]


def lm_engines(E, params, cfg, acfg, dev):
    """The three LM engines at the serve phases' slots, max_seq and paged
    block size."""
    return {
        "wave": E.ServeEngine(params, cfg, slots=LM_SLOTS,
                              max_seq=LM_MAX_SEQ, acfg=acfg, device=dev),
        "continuous": E.ContinuousServeEngine(
            params, cfg, slots=LM_SLOTS, max_seq=LM_MAX_SEQ, acfg=acfg,
            device=dev),
        "paged": E.PagedContinuousServeEngine(
            params, cfg, slots=LM_SLOTS, max_seq=LM_MAX_SEQ,
            block_size=LM_BLOCK, acfg=acfg, device=dev),
    }


def serve_lm(torch, check, E, engines, prompts, n_new, cfg, ops, launches,
             per_call, attention=True, attn_layers=None) -> dict:
    """Serves ``prompts`` (``n_new`` greedy tokens each) through each
    engine after a two-request warm-up, with the launch counters set to 0
    just before and read just after each run. Checks the tokens, that each
    model call launched ``per_call`` (kernel: launches) plus, with
    ``attention``, one attention kernel per attention layer
    (``attn_layers``, all ``cfg.n_layers`` unless given; contiguous or
    paged) and nothing else, and that the paged engine reused the shared
    prefix. Returns tokens/s by engine."""
    attn_kernel = {"wave": "approx_flash_attention",
                   "continuous": "approx_flash_attention",
                   "paged": "approx_flash_attention_paged"}
    calls = [0, 0]           # model calls, of which decode steps
    inner = E.apply_model

    def counted(*a, **k):
        calls[0] += 1
        calls[1] += bool(k.get("decode"))
        return inner(*a, **k)

    E.apply_model = counted
    n_attn = cfg.n_layers if attn_layers is None else attn_layers
    rates = {}
    try:
        for name, eng in engines.items():
            eng.run([E.Request(prompt=prompts[i], max_new_tokens=4)
                     for i in range(2)])             # warm-up
            torch.cuda.synchronize()
            reqs = [E.Request(prompt=p.copy(), max_new_tokens=n_new)
                    for p in prompts]
            for op in ops.values():
                op.launches = 0
                if hasattr(op, "decode_launches"):
                    op.decode_launches = 0
            calls[:] = [0, 0]
            t0 = time.perf_counter()
            eng.run(reqs)
            dt = time.perf_counter() - t0
            counts = {k: op.launches for k, op in ops.items()}
            n_tok = sum(len(r.out) for r in reqs)
            rates[name] = n_tok / dt
            stats = getattr(eng, "stats", {})
            print(f"    {name}: {rates[name]:.1f} tokens/s ({n_tok} tokens "
                  f"in {dt:.3f} s, {calls[0]} model calls), launches "
                  f"{counts}; stats "
                  + str({k: v for k, v in stats.items()
                         if not k.endswith("_sum")}), flush=True)
            check(n_tok == len(prompts) * n_new and all(
                0 <= t < cfg.vocab_padded for r in reqs for t in r.out),
                  f"{name}: {len(prompts)} x {n_new} tokens in the vocab")
            want_call = dict(per_call)
            if attention:
                want_call[attn_kernel[name]] = n_attn
            want = {k: want_call.get(k, 0) * calls[0] for k in ops}
            check(counts == want, f"{name}: launch counts are {want_call} "
                                  f"per model call x {calls[0]} calls")
            if attention:    # every decode call on the decode path, and
                kname = attn_kernel[name]     # nothing else
                dec = ops[kname].decode_launches
                check(dec == n_attn * calls[1],
                      f"{name}: {dec} of {kname}'s {counts[kname]} launches "
                      f"on its decode path = {n_attn} per decode call "
                      f"x {calls[1]} decode calls; the {calls[0] - calls[1]}"
                      f" prefill calls on the general path")
            if name == "paged":
                check(stats["prefix_hit_blocks"] > 0,
                      f"paged: the shared prefix was reused "
                      f"({stats['prefix_hit_blocks']} blocks)")
            for k in ops:
                launches[k] += counts[k]
    finally:
        E.apply_model = inner
    return rates


def biased_lut(np):
    """The exact 8-bit product plus 7, flattened (int32): LUT[0, x] != 0,
    so a padded or masked slot that a kernel sums shows."""
    v = np.arange(-128, 128, dtype=np.int32)
    return (v[:, None] * v[None, :] + 7).reshape(-1)


def dense_phase(torch, np, dev, check, acu, ops, lookups_per_s,
                lut_bytes, n_sm) -> dict:
    """Kernel 3 (fused_lut_dense) as redesigned: its work plan at every
    M = 32 GEMM of SmolLM-135M, granite-moe-3b-a800m, rwkv6-3b and CNN-224
    (all SMs busy, no tile row past M), bitwise checks at M = 1, M = 33, a
    ragged K, rwkv6-3b's and CNN-224's GEMMs (f1's plain GEMM on its first
    and last 32 columns) and the raw accumulator on a biased table, a
    planted fault (a plan with one K split dropped), times by regime, and
    the bank-conflict measurement: the same kernel on real codes and on
    codes that put a warp's 32 gathers in 32 banks, beside the same
    measurement on kernel 4 (fused_lut_bwd). Returns the regime times."""
    from repro_torch.configs import get_config
    from repro_torch.core import acu_operand, quantize, symmetric_qparams
    from repro_torch.kernels.fused_lut_dense.ops import (
        DensePlan, bwd_plan, dense_plan, fused_lut_dense_planned)
    from repro_torch.kernels.fused_lut_dense.ref import fused_lut_dense_ref

    lut16 = acu.device_lut(dev)
    lut32 = torch.from_numpy(acu.lut.reshape(-1)).to(dev)
    b32 = torch.from_numpy(biased_lut(np)).to(dev)
    b16 = b32.to(torch.int16)
    off, n_codes = acu.offset, acu.multiplier.n_codes
    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    t_phase = time.perf_counter()

    def operands(m, k, n):
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        w = torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
        xqp = symmetric_qparams(torch.clamp_min(x.abs().amax().float(),
                                                1e-6), 8)
        wqp = symmetric_qparams(torch.clamp_min(w.abs().amax(dim=0), 1e-9),
                                8, axis=1)
        wq = acu_operand(quantize(w, wqp), wqp).contiguous()
        return x, wq, (xqp.scale, xqp.zero_point, wqp.scale), xqp

    # -- the plan at every M = 32 GEMM of the served models -----------------
    print(f"fused_lut_dense (kernel 3) work plans at M = {LM_SLOTS} on "
          f"{n_sm} SMs (tile, items = segments, splits = most segments on "
          f"one tile, SMs with work, tile rows past M):")
    shapes = []
    for arch in (LM_ARCH, MOE_ARCH, RWKV_ARCH):
        c = get_config(arch)
        q, kv = c.n_heads * c.head_dim, c.n_kv_heads * c.head_dim
        if arch == RWKV_ARCH:
            gl = [("Wr..Wo", c.d_model, c.d_model),
                  ("Wk_cm", c.d_model, c.d_ff), ("Wv_cm", c.d_ff, c.d_model)]
        else:
            gl = [("q/o", c.d_model, q), ("k/v", c.d_model, kv)]
            if arch == LM_ARCH:
                gl += [("gate/up", c.d_model, c.d_ff),
                       ("down", c.d_ff, c.d_model)]
        gl.append(("head", c.d_model, c.vocab_padded))
        shapes += [(f"{arch} {lab}", LM_SLOTS, kk, nn) for lab, kk, nn in gl]
    f1_k = 4 * CNN_WIDTH * (CNN_IMG // 8) ** 2
    shapes += [("CNN-224 f1", CNN_SLOTS, f1_k, 8 * CNN_WIDTH),
               ("CNN-224 f2", CNN_SLOTS, 8 * CNN_WIDTH, CNN_CLASSES)]
    full = []
    for label, m, k, n in shapes:
        sm = dense_plan(m, k, n, n_sm).summary()
        full.append(sm["sms"] == n_sm and sm["rows_past_m"] == 0)
        print(f"  {label:34s} {m}x{k}x{n}: {sm}")
    check(all(full), f"every M = {LM_SLOTS} plan puts work on all {n_sm} "
                     f"SMs and no tile row past M")

    # -- bitwise at the redesign's edge shapes -------------------------------
    cases = [("M = 1", 1, 576, 576, None), ("M = 33", 33, 576, 576, None),
             ("ragged K, N = 200", 32, 570, 200, None),
             ("rwkv6-3b Wr..Wo", LM_SLOTS, 2560, 2560, None),
             ("CNN-224 f2", CNN_SLOTS, 512, CNN_CLASSES, None),
             ("CNN-224 f1", CNN_SLOTS, f1_k, 8 * CNN_WIDTH, 32)]
    for label, m, k, n, cols in cases:
        x, wq, a3, _ = operands(m, k, n)
        same = []
        for l16, l32, emit in ((lut16, lut32, False), (b16, b32, True)):
            yk = ops["fused_lut_dense"](x, wq, l16, off, *a3, emit_acc=emit)
            for cs in ((slice(0, n),) if cols is None else
                       (slice(0, cols), slice(n - cols, n))):
                yp = fused_lut_dense_ref(x, wq[:, cs].contiguous(), l32, off,
                                         n_codes, a3[0], a3[1], a3[2][cs],
                                         emit_acc=emit)
                same.append(torch.equal(yk[:, cs], yp))
            del yk
        sm = dense_plan(m, k, n, n_sm).summary()
        check(all(same), f"fused_lut_dense {label} {m}x{k}x{n}: float32 "
                         f"and emit_acc on a biased table bitwise equal to "
                         f"the plain version"
                         + ("" if cols is None else
                            f" (its first and last {cols} columns)")
                         + f"; plan {sm}")

    # -- planted fault: a plan with one K split dropped ----------------------
    x, wq, a3, _ = operands(LM_SLOTS, 2560, 2560)
    plan = dense_plan(LM_SLOTS, 2560, 2560, n_sm)
    i = int(np.flatnonzero(plan.segments[:, 3] >= 0)[0])
    bad = DensePlan(**{**plan.__dict__,
                       "segments": np.delete(plan.segments, i, axis=0),
                       "offsets": tuple(int(o - (o > i))
                                        for o in plan.offsets)})
    caught = []
    for emit in (False, True):
        yk = fused_lut_dense_planned(x, wq, lut16, off, *a3, plan=bad,
                                     emit_acc=emit)
        caught.append(not torch.equal(yk, fused_lut_dense_ref(
            x, wq, lut32, off, n_codes, *a3, emit_acc=emit)))
    check(all(caught), f"planted fault: the {LM_SLOTS}x2560x2560 plan with "
                       f"segment {i} (tile {plan.segments[i, 0]}, K groups "
                       f"{plan.segments[i, 1]}..{plan.segments[i, 2]}) "
                       f"dropped differs from the plain version, float32 "
                       f"and emit_acc")

    # -- times by regime ------------------------------------------------------
    times = {}
    for label, m, k, n in (("rwkv6-3b GEMM", LM_SLOTS, 2560, 2560),
                           ("CNN-224 f1", CNN_SLOTS, f1_k, 8 * CNN_WIDTH),
                           ("CNN-224 f2", CNN_SLOTS, 8 * CNN_WIDTH,
                            CNN_CLASSES)):
        x, wq, a3, _ = operands(m, k, n)
        ms = cuda_ms(torch, lambda: ops["fused_lut_dense"](x, wq, lut16, off,
                                                           *a3), 10)
        bound = max((m * k * 2 + k * n * 4 + lut_bytes + m * n * 4)
                    / HBM_BYTES_PER_S, m * k * n / lookups_per_s) * 1e3
        times[label] = ms
        print(f"  {label} {m}x{k}x{n}: {ms:.4f} ms, "
              f"{m * k * n / ms / 1e9:.3f} T lookups/s, bound {bound:.4f} ms",
              flush=True)
        del x, wq

    # -- bank conflicts: real codes against conflict-free ones ---------------
    print("  bank conflicts (ms on real codes / ms on codes that put a "
          "warp's gathers in 32 distinct banks; same kernel, same shape):")
    for m, k, n in ((LM_SLOTS, 2560, 2560), (1024, 4608, 4608)):
        plan = dense_plan(m, k, n, n_sm)
        x, wq, a3, xqp = operands(m, k, n)
        # new: a warp gathers one table row at its 32 lanes' columns; lane
        # l's column j reads code 2l + 64 (j % 4): word l + 32 (j % 4),
        # bank l
        col = torch.arange(n, device=dev)
        free_w = (2 * (col % plan.bn // plan.tn) + 64 * (col % plan.tn % 4)
                  - 128).to(torch.int32)[None, :].expand(k, n).contiguous()
        free_x = torch.full((m, k), 0.5, device=dev)
        new = [cuda_ms(torch, lambda: ops["fused_lut_dense"](
            xx, ww, lut16, off, *a3), 10) for xx, ww in
            ((x, wq), (free_x, free_w), (x, wq))]
        # kernel 4 (fused_lut_bwd, on the narrow-N core): conflict-free
        # when every row holds one code and its lanes' columns read codes
        # in distinct banks, as kernel 3's above at kernel 4's own tile
        af = x.float()
        bf = torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
        sa, sb = inline_scale(torch, af), inline_scale(torch, bf)
        free_a = torch.zeros_like(af)
        p4 = bwd_plan(m, k, n, n_sm)
        free_b = conflict_free_codes(
            torch, dev, n, p4.bn, p4.tn,
            (torch.arange(k, device=dev)[:, None] // 4) % 2).expand(
                k, n).float().contiguous()
        one = torch.ones((), device=dev)
        old = [cuda_ms(torch, lambda: ops["fused_lut_bwd"](
            aa, bb, lut16, off, s1, s2, emit_acc=True), 5)
            for aa, bb, s1, s2 in ((af, bf, sa, sb),
                                   (free_a, free_b, one, one),
                                   (af, bf, sa, sb))]
        rn, ro = min(new[0], new[2]) / new[1], min(old[0], old[2]) / old[1]
        times[f"conflicts {m}"] = (rn, ro)
        print(f"    {m}x{k}x{n}: fused_lut_dense {new[0]:.4f} / {new[1]:.4f}"
              f" ms (again {new[2]:.4f}): x{rn:.2f}; kernel 4 "
              f"(fused_lut_bwd) {old[0]:.4f} / {old[1]:.4f} ms (again "
              f"{old[2]:.4f}): x{ro:.2f}", flush=True)
        del x, wq, af, bf, free_a, free_b, free_w, free_x
    torch.cuda.empty_cache()
    print(f"kernel 3 phase: {time.perf_counter() - t_phase:.1f} s")
    return times


def conflict_free_codes(torch, dev, n: int, bn: int, tn: int, group_of):
    """Shifted weight codes that put a warp's gathers in distinct banks on
    the narrow-N core (lut_narrow.cuh), when every row code is one: entry
    (a, b) lies in bank (b / 2) mod 32. At 32 columns and over lane l's
    j-th column reads code 2l + 64 (j % 4) (word l + 32 (j % 4), bank l);
    at 16 the two half-warps walk alternate groups of 4 k, so column c
    reads 2c in one half's groups and 2c + 32 in the other's (banks c and
    16 + c). ``group_of`` gives each k's group parity (a (K, 1) tensor)."""
    col = torch.arange(n, device=dev)[None, :]
    if bn == 16:
        b = 2 * (col % 16) + 32 * group_of
    else:
        b = (2 * (col % bn // tn) + 64 * (col % tn % 4)).expand(
            group_of.shape[0], n)
    return (b - 128).to(torch.int32)


def narrow_phase(torch, np, dev, check, acu, n_sm) -> dict:
    """Kernels 1 and 5 on the narrow-N core at ResNet-20's three widths
    (N = 16, 32, 64; stage 0, 1 and 2 of a wave of 256): the bank-conflict
    replay (ms on real codes over ms on codes that put a warp's gathers in
    distinct banks, same kernel, same shape) of kernel 5, kernel 1 and
    kernel 4 (fused_lut_bwd at the same GEMM shapes), and a planted fault
    of each: kernel 5 with a tiling
    whose last channel group is dropped, kernel 1 with a plan whose split
    segment is dropped (at the stem's weight gradient, K = 131,072).
    Returns the replays."""
    from repro_torch.core import ApproxConfig, acu_operand, quantize
    from repro_torch.core.approx_ops import _conv_qparams, _im2col
    from repro_torch.kernels.fused_lut_conv.ops import (
        fused_lut_conv, pick_conv_kernel_tiling)
    from repro_torch.kernels.fused_lut_conv.ref import fused_lut_conv_ref
    from repro_torch.kernels.fused_lut_dense.ops import (bwd_plan,
                                                         fused_lut_bwd)
    from repro_torch.kernels.lut_matmul.ops import (
        lut_matmul, lut_matmul_planned, lut_plan)
    from repro_torch.kernels.lut_matmul.ref import lut_matmul_ref

    t_phase = time.perf_counter()
    lut16 = acu.device_lut(dev)
    lut32 = torch.from_numpy(acu.lut.reshape(-1)).to(dev)
    off, n_codes = acu.offset, acu.multiplier.n_codes
    cfg = ApproxConfig(acu=acu)
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    replay = {}
    print("narrow-N core: bank conflicts at ResNet-20's widths (ms on real "
          "codes / ms on codes that put a warp's gathers in distinct banks; "
          "real timed twice, the faster kept):")
    for name, cin, hw, cout in (("stage0", 16, 32, 16), ("stage1", 32, 16, 32),
                                ("stage2", 64, 8, 64)):
        x = torch.relu(torch.randn((BATCH, cin, hw, hw), generator=gen,
                                   device=dev))
        w = torch.randn((cout, cin, 3, 3), generator=gen, device=dev)
        xqp, wqp = _conv_qparams(x, w, cfg, None, None)
        wq = acu_operand(quantize(w, wqp), wqp)
        args = (xqp.scale, xqp.zero_point, wqp.scale)
        pad = ((1, 1), (1, 1))
        t5 = pick_conv_kernel_tiling(BATCH, cin, hw, hw, cout, 3, 3, 1, 1, 1,
                                     1, n_codes, n_sm)
        # kernel 5's pairs: tap t, channel group g; the slice parity of
        # pair t * ng + g decides the half-warp at Cout 16
        ng = t5.c4 // 4
        tap = torch.arange(9, device=dev)
        grp = torch.arange(cin, device=dev) // 4
        par = ((tap[None, :] * ng + grp[:, None]) % 2).reshape(-1, 1)
        wfree = conflict_free_codes(torch, dev, cout, t5.bn, t5.tn, par)
        wq_free = wfree.t().reshape(cout, cin, 3, 3).contiguous()
        x_free = torch.full_like(x, 0.5)
        k5 = [cuda_ms(torch, lambda: fused_lut_conv(
            xx, ww, lut16, off, *args, padding=pad), 10)
            for xx, ww in ((x, wq), (x_free, wq_free), (x, wq))]
        # kernel 1 on the same layer's unfused GEMM
        cols, _ = _im2col(x, 3, 3, (1, 1), pad, (1, 1))
        cols = cols.reshape(-1, cols.shape[-1])
        a = acu_operand(quantize(cols, xqp), xqp)
        wmat = wq.reshape(cout, -1).t().contiguous()
        M, K = a.shape
        plan = lut_plan(M, K, cout, n_sm)
        kpar = (torch.arange(K, device=dev)[:, None] // 4) % 2
        wm_free = conflict_free_codes(torch, dev, cout, plan.bn,
                                      plan.bn * plan.ks // 32, kpar)
        wm_free = wm_free.expand(K, cout).contiguous()
        a_free = torch.zeros_like(a)
        k1 = [cuda_ms(torch, lambda: lut_matmul(aa, ww, lut16, off), 10)
              for aa, ww in ((a, wmat), (a_free, wm_free), (a, wmat))]
        # kernel 4 (fused_lut_bwd, on the narrow-N core) at the same
        # GEMM: conflict-free when every row holds one code and its
        # lanes read B codes by its own plan's lane map (at 16 columns the
        # half-warps' alternate groups of 4 k)
        af = cols.float().contiguous()
        bf = wmat.float() * wqp.scale.reshape(1, -1)
        sa = inline_scale(torch, af)
        sb = inline_scale(torch, bf)
        p4 = bwd_plan(M, K, cout, n_sm)
        bf_free = conflict_free_codes(torch, dev, cout, p4.bn, p4.tn,
                                      kpar).expand(K, cout).float() \
            .contiguous()
        one = torch.ones((), device=dev)
        old = [cuda_ms(torch, lambda: fused_lut_bwd(aa, bb, lut16, off, s1,
                                                    s2, emit_acc=True), 10)
               for aa, bb, s1, s2 in ((af, bf, sa, sb),
                                      (torch.zeros_like(af), bf_free, one,
                                       one), (af, bf, sa, sb))]
        r5 = min(k5[0], k5[2]) / k5[1]
        r1 = min(k1[0], k1[2]) / k1[1]
        ro = min(old[0], old[2]) / old[1]
        replay[cout] = (r5, r1, ro)
        print(f"  N = {cout} ({name}, conv {tuple(x.shape)} -> {cout}, GEMM "
              f"{M}x{K}x{cout}): fused_lut_conv {k5[0]:.4f} / {k5[1]:.4f} ms"
              f" (again {k5[2]:.4f}): x{r5:.2f}; lut_matmul {k1[0]:.4f} / "
              f"{k1[1]:.4f} (again {k1[2]:.4f}): x{r1:.2f}; kernel 4 "
              f"(fused_lut_bwd) {old[0]:.4f} / {old[1]:.4f} (again "
              f"{old[2]:.4f}): x{ro:.2f}", flush=True)
        if name == "stage0":    # planted fault: the last channel group
            # (channels 12..15) dropped from kernel 5's tiling
            bad = dataclasses.replace(t5, c4=t5.c4 - 4)
            caught = [not torch.equal(
                fused_lut_conv(x, wq, lut16, off, *args, padding=pad,
                               emit_acc=emit, tiling=bad),
                fused_lut_conv_ref(x, wq, lut32, off, n_codes, *args,
                                   padding=pad, emit_acc=emit))
                for emit in (False, True)]
            check(all(caught), f"fused_lut_conv {name}, planted fault: a "
                               f"tiling with its last channel group dropped "
                               f"(c4 {bad.c4} of {t5.c4}) differs from the "
                               f"plain version, f32 and int32: caught")
        del x, x_free, cols, a, a_free, af, bf, bf_free, wm_free
    # planted fault: kernel 1's plan at the stem's weight gradient with one
    # stream-K segment dropped
    P = TRAIN_BATCH * 32 * 32
    qc = torch.randint(-128, 128, (27, P), generator=gen, device=dev,
                       dtype=torch.int32)
    qg = torch.randint(-128, 128, (P, 16), generator=gen, device=dev,
                       dtype=torch.int32)
    plan = lut_plan(27, P, 16, n_sm)
    i = int(np.flatnonzero(plan.segments[:, 3] >= 0)[0])
    bad = dataclasses.replace(
        plan, segments=np.delete(plan.segments, i, axis=0),
        offsets=tuple(int(o - (o > i)) for o in plan.offsets))
    want = lut_matmul_ref(qc, qg, lut32, off, n_codes)
    good = torch.equal(lut_matmul_planned(qc, qg, lut16, off, plan=plan),
                       want)
    # the tile the fault leaves short is never stored and keeps what the
    # allocator's block held: every free block of its size is first filled
    # with a value no sum gives
    junk = [torch.full_like(want, -(2 ** 31)) for _ in range(4)]
    del junk
    check(good and not torch.equal(lut_matmul_planned(qc, qg, lut16, off,
                                                      plan=bad), want),
          f"lut_matmul 27x{P}x16 (stem weight gradient), planted fault: the "
          f"plan {plan.summary()} with segment {i} (K groups "
          f"{plan.segments[i, 1]}..{plan.segments[i, 2]}) dropped differs "
          f"from the plain version: caught")
    del qc, qg, want
    torch.cuda.empty_cache()
    print(f"narrow-N phase: {time.perf_counter() - t_phase:.1f} s")
    return replay


# kernels 4 and 7 on the old shared core (lut_gemm.cuh, since retired), ms
# per ResNet-20 training step at batch 128, as this script measured them on
# an NVIDIA H100 80GB HBM3 at 700 W: what the redesigned kernels are timed
# against
BWD_OLD_CORE_MS = {"fused_lut_bwd": 5.514, "fused_lut_conv_bwd_w": 7.061}
# kernels 10 and 13 before their redesign, as this script measured them on
# an NVIDIA H100 80GB HBM3 at 700 W: ms per granite-moe-3b-a800m decode step
# (kernel 10) and per ResNet-20 LOWRANK wave of 256 (kernel 13)
K10_K13_BEFORE_MS = {"fused_lut_grouped": 17.770, "err_matmul": 9.925}
# kernels 2 and 11 before their redesign, as this script measured them on
# an NVIDIA H100 80GB HBM3 at 700 W: ms per rwkv6-3b decode step (kernel 2)
# and per gemma2-27b forward of 4352 tokens (kernel 11, 46 layers)
K2_K11_BEFORE_MS = {"quantize": 10.639, "flash_attention": 344.173}


def bwd_phase(torch, np, dev, check, acu, n_sm, lookups_per_s,
              lut_bytes) -> dict:
    """Kernels 4 (fused_lut_bwd) and 7 (fused_lut_conv_bwd_w) as
    redesigned on the narrow-N core: kernel 4's plan and kernel 7's tiling
    at CONV_BWD (their ResNet-20 ones are printed in step 3), both bitwise
    equal to their plain versions there (kernel 4 float32 and emit_acc)
    and timed against the lookup bound and torch.matmul; both on the
    biased table at a ragged shape; a planted fault each (kernel 4: a plan
    whose first item stops one K group short; kernel 7: a tiling that
    leaves its last band of output rows out), each caught; and the
    bank-conflict replay of each (ms on real codes / ms on codes that put
    a warp's gathers in distinct banks, same kernel, same shape) at
    ResNet-20's gradient shapes. Returns the times and replays."""
    from repro_torch.kernels.fused_lut_conv.ops import (
        bwd_w_tiling_for, conv_out_size, fused_lut_conv_bwd_w,
        pick_bwd_w_tiling)
    from repro_torch.kernels.fused_lut_conv.ref import (
        fused_lut_conv_bwd_w_ref)
    from repro_torch.kernels.fused_lut_dense.ops import (bwd_plan,
                                                         fused_lut_bwd)
    from repro_torch.kernels.fused_lut_dense.ref import fused_lut_bwd_ref

    t_phase = time.perf_counter()
    lut16 = acu.device_lut(dev)
    lut32 = torch.from_numpy(acu.lut.reshape(-1)).to(dev)
    b32 = torch.from_numpy(biased_lut(np)).to(dev)
    b16 = b32.to(torch.int16)
    off, n_codes = acu.offset, acu.multiplier.n_codes
    gen = torch.Generator(device=dev)
    gen.manual_seed(22)
    out = {}

    def conv_operands(xshape, cout, k, s, pad):
        n, c, h, w = xshape
        ho = conv_out_size(h, k, s, 1, pad[0])
        wo = conv_out_size(w, k, s, 1, pad[1])
        x = torch.relu(torch.randn(xshape, generator=gen, device=dev))
        g = torch.randn((n, ho, wo, cout), generator=gen, device=dev) * 1e-3
        return x, g, ho, wo, inline_scale(torch, x), inline_scale(torch, g)

    # -- CONV_BWD: both kernels at CNN-224's approx_bwd step ----------------
    (n, c, h, w), (cout, _, k, _) = CONV_BWD
    pad = ((1, 1), (1, 1))
    x, g, ho, wo, sx, sg = conv_operands((n, c, h, w), cout, k, 1, pad)
    geo = dict(ksize=(k, k), padding=pad)
    t7 = pick_bwd_w_tiling(n, c, ho, wo, cout, k, k, 1, 1, 1, 1, n_codes,
                           n_sm)
    print(f"kernel 7 (fused_lut_conv_bwd_w) at CONV_BWD {CONV_BWD}: "
          f"{t7.describe(n, n_sm)}")
    bw_k = lambda: fused_lut_conv_bwd_w(x, g, lut16, off, sx, sg, **geo)
    ak = bw_k()
    check(torch.equal(ak, fused_lut_conv_bwd_w_ref(x, g, lut32, off, n_codes,
                                                   sx, sg, **geo)),
          f"fused_lut_conv_bwd_w CONV_BWD {tuple(ak.shape)}: int32 bitwise "
          f"equal to the plain version")
    P, ckk = n * ho * wo, c * k * k
    cols = torch.randn((ckk, P), generator=gen, device=dev)
    g2 = g.reshape(P, cout)
    lib7 = cuda_ms(torch, lambda: torch.matmul(cols, g2), 5)
    ms7 = cuda_ms(torch, bw_k, 5)
    bound7 = P * ckk * cout / lookups_per_s * 1e3
    out["kernel 7 CONV_BWD"] = (ms7, bound7, lib7)
    del cols, ak
    wf = torch.randn((cout, c, k, k), generator=gen, device=dev) * 0.1
    wfmat = wf.reshape(cout, -1)
    sw = inline_scale(torch, wf)
    p4 = bwd_plan(P, cout, ckk, n_sm, n_codes)
    print(f"kernel 4 (fused_lut_bwd) at CONV_BWD's gx {P}x{cout}x{ckk}: "
          f"{p4.describe()}")
    same = [torch.equal(fused_lut_bwd(g2, wfmat, lut16, off, sg, sw,
                                      emit_acc=e),
                        fused_lut_bwd_ref(g2, wfmat, lut32, off, n_codes, sg,
                                          sw, emit_acc=e))
            for e in (False, True)]
    check(all(same), f"fused_lut_bwd CONV_BWD gx {P}x{cout}x{ckk}: float32 "
                     f"and emit_acc bitwise equal to the plain version")
    lib4 = cuda_ms(torch, lambda: torch.matmul(g2, wfmat), 5)
    ms4 = cuda_ms(torch, lambda: fused_lut_bwd(g2, wfmat, lut16, off, sg, sw,
                                               emit_acc=True), 5)
    bound4 = P * cout * ckk / lookups_per_s * 1e3
    out["kernel 4 CONV_BWD"] = (ms4, bound4, lib4)
    print(f"  CONV_BWD: kernel 7 {ms7:.4f} ms (torch.matmul f32 on the "
          f"im2col matrix {lib7:.4f}, lookup bound {bound7:.4f}); kernel 4 "
          f"gx {ms4:.4f} ms (torch.matmul f32 {lib4:.4f}, lookup bound "
          f"{bound4:.4f})", flush=True)
    del x, g, g2, wf, wfmat

    # -- the biased table at a ragged shape each ----------------------------
    a = torch.randn((1000, 33), generator=gen, device=dev)
    b = torch.randn((33, 150), generator=gen, device=dev) * 0.1
    sa, sb = inline_scale(torch, a), inline_scale(torch, b)
    same = [torch.equal(fused_lut_bwd(a, b, b16, off, sa, sb, emit_acc=e),
                        fused_lut_bwd_ref(a, b, b32, off, n_codes, sa, sb,
                                          emit_acc=e)) for e in (False, True)]
    check(all(same), f"fused_lut_bwd 1000x33x150 on the biased table "
                     f"(LUT[off, off] = 7: the K pad shows): float32 and "
                     f"emit_acc bitwise equal to the plain version; plan "
                     f"{bwd_plan(1000, 33, 150, n_sm, n_codes).summary()}")
    pad_r = ((1, 0), (0, 1))
    x, g, ho, wo, sx, sg = conv_operands((3, 37, 13, 15), 48, 3, 2, pad_r)
    geo = dict(ksize=(3, 3), stride=(2, 2), padding=pad_r)
    check(torch.equal(fused_lut_conv_bwd_w(x, g, b16, off, sx, sg, **geo),
                      fused_lut_conv_bwd_w_ref(x, g, b32, off, n_codes, sx,
                                               sg, **geo)),
          f"fused_lut_conv_bwd_w (3, 37, 13, 15) -> 48, stride 2, padding "
          f"{pad_r}, on the biased table (every out-of-image tap adds 7): "
          f"int32 bitwise equal to the plain version")

    # -- planted faults ------------------------------------------------------
    P = TRAIN_BATCH * 32 * 32
    g2 = torch.randn((P, 16), generator=gen, device=dev) * 1e-3
    wfmat = torch.randn((16, 144), generator=gen, device=dev) * 0.1
    sg, sw = inline_scale(torch, g2), inline_scale(torch, wfmat)
    plan = bwd_plan(P, 16, 144, n_sm, n_codes)
    segs = plan.segments.copy()
    segs[0, 2] -= 1
    bad = dataclasses.replace(plan, segments=segs)
    caught = [not torch.equal(
        fused_lut_bwd(g2, wfmat, lut16, off, sg, sw, emit_acc=e, plan=bad),
        fused_lut_bwd_ref(g2, wfmat, lut32, off, n_codes, sg, sw,
                          emit_acc=e)) for e in (False, True)]
    check(all(caught), f"fused_lut_bwd {P}x16x144 (stage 0's gx), planted "
                       f"fault: its plan with item {segs[0, 0]} stopping "
                       f"at K group {segs[0, 2]} of {plan.groups} differs "
                       f"from the plain version, float32 and emit_acc: "
                       f"caught")
    x, g, ho, wo, sx, sg = conv_operands((TRAIN_BATCH, 16, 32, 32), 16, 3, 1,
                                         ((1, 1), (1, 1)))
    geo = dict(ksize=(3, 3), padding=((1, 1), (1, 1)))
    t7 = pick_bwd_w_tiling(TRAIN_BATCH, 16, ho, wo, 16, 3, 3, 1, 1, 1, 1,
                           n_codes, n_sm)
    bad7 = dataclasses.replace(t7, tiles_h=t7.tiles_h - 1)
    check(not torch.equal(
        fused_lut_conv_bwd_w(x, g, lut16, off, sx, sg, tiling=bad7, **geo),
        fused_lut_conv_bwd_w_ref(x, g, lut32, off, n_codes, sx, sg, **geo)),
          f"fused_lut_conv_bwd_w stage 0, planted fault: its tiling with the "
          f"last band of {t7.bh} output rows left out ({bad7.tiles_h} of "
          f"{t7.tiles_h} bands) differs from the plain version: caught")
    del x, g, g2

    # -- bank conflicts: real codes against conflict-free ones --------------
    print("kernels 4 and 7: bank conflicts at ResNet-20's gradient shapes "
          "(ms on real codes / ms on codes that put a warp's gathers in "
          "distinct banks; real timed twice, the faster kept):")
    one = torch.ones((), device=dev)
    for name, cin, hw, cout in (("stage0", 16, 32, 16),
                                ("stage1", 32, 16, 32),
                                ("stage2", 64, 8, 64)):
        pad = ((1, 1), (1, 1))
        x, g, ho, wo, sx, sg = conv_operands((TRAIN_BATCH, cin, hw, hw),
                                             cout, 3, 1, pad)
        geo = dict(ksize=(3, 3), padding=pad)
        t7 = pick_bwd_w_tiling(TRAIN_BATCH, cin, ho, wo, cout, 3, 3, 1, 1,
                               1, 1, n_codes, n_sm)
        # kernel 7: every x code one (x = 0), the gradient's codes by the
        # lane map: column o of pixel p reads 2 (o % bn) / tn ... (banks of
        # a warp's lanes distinct), at 16 columns the half-warps' alternate
        # groups of 4 pixels 32 apart; an item's pixel groups start at its
        # first pixel, a multiple of 4 and 8 here
        p = torch.arange(ho * wo, device=dev).reshape(ho, wo)
        item_p = (p // wo % t7.bh) * min(t7.bw, wo) + p % wo % t7.bw
        par = ((item_p // 4) % 2).reshape(-1, 1)
        gfree = conflict_free_codes(torch, dev, cout, t7.bn, t7.tn, par)
        gfree = gfree.float().reshape(1, ho, wo, cout).expand(
            TRAIN_BATCH, ho, wo, cout).contiguous()
        x0 = torch.zeros_like(x)
        k7 = [cuda_ms(torch, lambda: fused_lut_conv_bwd_w(
            xx, gg, lut16, off, s1, s2, **geo), 10)
            for xx, gg, s1, s2 in ((x, g, sx, sg), (x0, gfree, one, one),
                                   (x, g, sx, sg))]
        # kernel 4 at the same conv's gx: every A code one (g = 0), B's
        # codes by the lane map (at 16 columns the half-warps' alternate
        # groups of 4 k)
        P, ckk = TRAIN_BATCH * ho * wo, cin * 9
        g2 = g.reshape(P, cout)
        wfmat = torch.randn((cout, ckk), generator=gen, device=dev) * 0.1
        sw = inline_scale(torch, wfmat)
        p4 = bwd_plan(P, cout, ckk, n_sm, n_codes)
        kpar = (torch.arange(cout, device=dev)[:, None] // 4) % 2
        wfree = conflict_free_codes(torch, dev, ckk, p4.bn, p4.tn, kpar)
        wfree = wfree.expand(cout, ckk).float().contiguous()
        g0 = torch.zeros_like(g2)
        k4 = [cuda_ms(torch, lambda: fused_lut_bwd(
            aa, bb, lut16, off, s1, s2, emit_acc=True), 10)
            for aa, bb, s1, s2 in ((g2, wfmat, sg, sw), (g0, wfree, one, one),
                                   (g2, wfmat, sg, sw))]
        if name == "stage2":
            # the cost of two items an SM: the picked tiling against whole
            # images of 32 channels (256 items, one SM in 17 gets one)
            whole = bwd_w_tiling_for(64, ho, wo, cout, 3, 3, 1, 1, 1, 1,
                                     n_codes, ho, wo, 32, t7.bn, t7.tw)
            ms_w = [cuda_ms(torch, lambda: fused_lut_conv_bwd_w(
                x, g, lut16, off, sx, sg, tiling=tl, **geo), 10)
                for tl in (t7, whole, t7)]
            out["kernel 7 whole images"] = (min(ms_w[0], ms_w[2]), ms_w[1])
            print(f"  stage2: kernel 7 on its tiling ({t7.items(TRAIN_BATCH)} "
                  f"items) {ms_w[0]:.4f} ms (again {ms_w[2]:.4f}), on whole "
                  f"images of 32 channels ({whole.items(TRAIN_BATCH)} items) "
                  f"{ms_w[1]:.4f} ms", flush=True)
        r7, r4 = min(k7[0], k7[2]) / k7[1], min(k4[0], k4[2]) / k4[1]
        out[f"conflicts {cout}"] = (r4, r7)
        print(f"  {name}: kernel 7 gw {ckk}x{P}x{cout} {k7[0]:.4f} / "
              f"{k7[1]:.4f} ms (again {k7[2]:.4f}): x{r7:.2f}; kernel 4 gx "
              f"{P}x{cout}x{ckk} {k4[0]:.4f} / {k4[1]:.4f} ms (again "
              f"{k4[2]:.4f}): x{r4:.2f}", flush=True)
        del x, g, x0, gfree, g0, wfree
    torch.cuda.empty_cache()
    print(f"kernels 4 and 7 phase: {time.perf_counter() - t_phase:.1f} s")
    return out


def inline_scale(torch, t):
    """The approximate backward's per-tensor symmetric scale of ``t``."""
    from repro_torch.core import inline_symmetric_scale
    return inline_symmetric_scale(t.abs().amax(), 8)


def attn_work(np, info, sq: int, hq: int, hkv: int, d: int, itemsize: int):
    """(bytes, lookups) one attention call must touch for (B, 3) rows of
    [q_base, kv_start, kv_len]: every real query row reads its visible
    keys (kv_start <= key < kv_len, key <= its position) once in QK and
    once in PV; Q, the visible K/V span of each batch row and the float32
    output cross device memory once."""
    q_pos = info[:, :1] + np.arange(sq)[None, :]
    vis = np.clip(np.minimum(info[:, 2:3], q_pos + 1) - info[:, 1:2], 0,
                  None)
    span = np.clip(np.minimum(info[:, 2], info[:, 0] + sq) - info[:, 1], 0,
                   None)
    lookups = 2 * d * hq * int(vis.sum())
    bytes_ = (len(info) * hq * sq * d * (itemsize + 4)
              + 2 * hkv * d * itemsize * int(span.sum()))
    return bytes_, lookups


def hold_decode_path(torch, np, dev, check, acu, ops, cfg, seed: int):
    """Kernel 8's contiguous decode path at ``cfg``'s decode shape:
    LM_SLOTS rows of one query each over a LM_MAX_SEQ-key bf16 cache read
    in place through its (B, Hkv, S, D) view. Prints the plan; holds the
    path against the plain version (every element within the
    summation-order term, at most ATTN_FLIP_ROWS rows beyond it by one code
    flip) under the standard and a biased table, with left-padded rows, a
    row whose padded q tile of 8 crosses a 128-key block boundary (the
    bound runs a block the row never sees) and a row whose first block is
    all masked; shows a planted fault (kv_start shifted by one block)
    beyond that tolerance; and times the decode path, the general path
    (``general=True``) and SDPA in the same call, beside the call's bound
    (:func:`attn_work`'s bytes at the memory rate or lookups at the gather
    rate). Returns the three times and the bound in ms."""
    import torch.nn.functional as F
    from repro_torch.core import inline_symmetric_scale
    from repro_torch.kernels import runtime
    from repro_torch.kernels.flash_attention import ref as aref
    from repro_torch.kernels.flash_attention.ops import decode_plan

    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kern = ops["approx_flash_attention"]
    off, n_codes = acu.offset, acu.multiplier.n_codes
    b, s = LM_SLOTS, LM_MAX_SEQ
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    pos = rng.integers(16, s // 2 + 8, b)
    pad = rng.integers(0, 8, b)          # the wave engine's left pads
    pos[0] = 124                         # q tile 124..131 reaches block 1
    pos[1], pad[1] = 300, 140            # keys 0..139 masked: block 0 dead
    info = np.stack([pos, pad, pos + 1], 1).astype(np.int32)
    rows = torch.from_numpy(info).to(dev)
    shifted = torch.from_numpy(info + np.array([0, 128, 0], np.int32)).to(dev)
    bf = torch.bfloat16
    q = torch.randn((b, 1, hq, d), generator=gen, device=dev).to(
        bf).transpose(1, 2)
    kc = torch.randn((b, s, hkv, d), generator=gen, device=dev).to(bf)
    vc = torch.randn((b, s, hkv, d), generator=gen, device=dev).to(bf)
    k, v = kc.transpose(1, 2), vc.transpose(1, 2)
    s3 = [inline_symmetric_scale(torch.clamp_min(t.abs().amax(), 1e-6), 8)
          for t in (q, kc, vc)]
    plan = decode_plan(b * hq, 1, d, hq // hkv, hq, 128, 2, n_codes,
                       s // 128, runtime.sm_count(0), paged=False)
    print(f"  approx_flash_attention decode path at {cfg.name}'s decode "
          f"shape ({b} rows, {hq} heads over {hkv}, head_dim {d}, {s}-key "
          f"cache): {plan}")
    check(plan is not None and plan.heads == hq // hkv,
          f"{cfg.name} decode: one item per batch row and KV head")
    pv_scale = aref.attn_scales(*s3, d, 127)[1]
    b32 = torch.from_numpy(biased_lut(np)).to(dev)
    lut32 = torch.from_numpy(acu.lut.reshape(-1)).to(dev)
    lut16 = acu.device_lut(dev)
    for label, l16, l32, info_k in (
            ("standard table", lut16, lut32, rows),
            ("biased table", b32.to(torch.int16), b32, rows),
            ("planted fault: kv_start shifted by one block", lut16, lut32,
             shifted)):
        n0 = (kern.launches, kern.decode_launches)
        yk = kern(q, k, v, l16, off, *s3, rowinfo=info_k, row_heads=hq)
        took = (kern.launches - n0[0], kern.decode_launches - n0[1])
        yp = aref.approx_attention_ref(
            q.reshape(-1, 1, d), k.reshape(-1, s, d), v.reshape(-1, s, d),
            l32, off, *s3, rowinfo=rows.repeat_interleave(hq, 0))
        agree = aref.same_device_agreement(yk, yp, l32, off, 127, pv_scale,
                                           128)
        held = (bool(torch.isfinite(yk).all()) and agree["within_flip"]
                and agree["flip_rows"] <= ATTN_FLIP_ROWS)
        fault = label.startswith("planted")
        check(took == (1, 1) and held != fault,
              f"approx_flash_attention decode path, {cfg.name}, {label}: "
              f"max |diff| {agree['max_err']:.3e}, {agree['flip_rows']} rows"
              f" beyond {agree['ulp_tol']:.3e} (one flip "
              f"{agree['flip_tol']:.3e}): "
              + ("caught, beyond the tolerance" if fault else
                 "within the tolerance") + f"; launches (all, decode) {took}")
    kpos = torch.arange(s, device=dev)
    mask = ((kpos >= rows[:, 1:2, None]) & (kpos < rows[:, 2:3, None])
            & (kpos <= rows[:, :1, None]))[:, None]
    qd, kd, vd = q.contiguous(), k.contiguous(), v.contiguous()
    lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask, enable_gqa=True), 20)
    times = [cuda_ms(torch, lambda g=g: kern(
        q, k, v, lut16, off, *s3, rowinfo=rows, row_heads=hq, general=g), 20)
        for g in (False, True, False)]
    ms_dec = min(times[0], times[2])
    bytes_, lookups = attn_work(np, info, 1, hq, hkv, d, 2)
    gather_per_s = runtime.sm_count(0) * 32 * SPIN_CYCLES_PER_S
    bound = max(bytes_ / HBM_BYTES_PER_S, lookups / gather_per_s) * 1e3
    print(f"    decode path {times[0]:.4f} ms (again {times[2]:.4f}), general "
          f"path {times[1]:.4f} ms ({times[1] / ms_dec:.2f}x the decode "
          f"path), scaled_dot_product_attention {lib:.4f} ms; bound "
          f"{bound:.4f} ms ({bytes_ / 1e6:.1f} MB, {lookups / 1e6:.1f} M "
          f"lookups)", flush=True)
    return ms_dec, times[1], lib, bound


def lm_phase(torch, np, dev, check, acu, ops, launches, account,
             lookups_per_s, lut_bytes, redesign: dict) -> dict:
    """SmolLM-135M on the fused ACU: the slice's kernels at its shapes,
    then 64 requests through each LM engine on a cut to LM_SERVE_LAYERS
    layers. Returns tokens/s by engine;
    kernel 8's decode-path times go into ``redesign``."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.core import (ApproxConfig, acu_operand,
                                  inline_symmetric_scale, quantize,
                                  symmetric_qparams)
    from repro_torch.kernels import runtime
    from repro_torch.kernels.flash_attention import ref as aref
    from repro_torch.kernels.flash_attention.ops import decode_plan
    from repro_torch.kernels.fused_lut_dense.ops import dense_plan
    from repro_torch.kernels.fused_lut_dense.ref import fused_lut_dense_ref
    from repro_torch.models.transformer import (init_cache, init_paged_cache,
                                                init_params)
    from repro_torch.serve import engine as E

    cfg = get_config(LM_ARCH)
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    bf = torch.bfloat16
    acfg = ApproxConfig(acu=acu)
    lut16, lut32 = acu.device_lut(dev), torch.from_numpy(
        acu.lut.reshape(-1)).to(dev)
    off, n_codes = acu.offset, acu.multiplier.n_codes
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    rng = np.random.default_rng(11)
    print(f"SmolLM-135M ({cfg.n_layers} layers, d {cfg.d_model}, {hq} heads "
          f"over {hkv} KV heads, head_dim {d}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_padded}, bf16), {MULT} fused ACU:")

    def sym(t):
        return inline_symmetric_scale(torch.clamp_min(t.abs().amax(), 1e-6),
                                      8)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    # -- kernels 8 and 9 at the decode and prefill shapes -------------------
    b = LM_SLOTS
    pos = rng.integers(16, LM_MAX_SEQ // 2 + 8, b)   # decode positions
    pad = rng.integers(0, 8, b)
    n_log = LM_MAX_SEQ // LM_BLOCK
    n_pool = LM_SLOTS * n_log
    cases = {
        # name: (batch, query rows, rowinfo, paged)
        "decode": (b, 1, np.stack([pos, pad, pos + 1], 1), False),
        "wave prefill": (b, LM_WAVE_PROMPT,
                         np.stack([np.zeros(b, int), pad,
                                   np.full(b, LM_WAVE_PROMPT)], 1), False),
        "paged decode": (b, 1, np.stack([pos, np.zeros(b, int), pos + 1], 1),
                         True),
        "paged prefill chunk": (1, LM_BLOCK,
                                np.array([[LM_PREFIX - LM_BLOCK, 0,
                                           LM_PREFIX]]), True),
    }
    kc = rand(b, LM_MAX_SEQ, hkv, d)
    vc = rand(b, LM_MAX_SEQ, hkv, d)
    k_pool = rand(hkv, n_pool, LM_BLOCK, d)
    v_pool = rand(hkv, n_pool, LM_BLOCK, d)
    print(f"  attention kernels against their plain versions (each element "
          f"within 4*bk*eps*max|y|; at most {ATTN_FLIP_ROWS} rows beyond "
          f"it, by one code flip at most):")
    for name, (nb, sq, info, paged) in cases.items():
        q = rand(nb, sq, hq, d).transpose(1, 2)         # (B, Hq, Sq, D) view
        rows = torch.from_numpy(info.astype(np.int32)).to(dev)
        rows_h = rows.repeat_interleave(hq, dim=0)     # per head: plain
        if paged:
            table = np.zeros((nb, n_log), np.int32)
            for i in range(nb):
                used = -(-int(info[i, 2]) // LM_BLOCK)
                table[i, :used] = rng.choice(np.arange(2, n_pool), used,
                                             replace=False)
            pt = torch.from_numpy(table).to(dev)
            pt_h = pt.repeat_interleave(hq, dim=0)
            ptl = pt.long()
            kname = "approx_flash_attention_paged"
            s3 = [sym(q), sym(k_pool[:, ptl]), sym(v_pool[:, ptl])]
            kern = lambda: ops[kname](
                q, k_pool, v_pool, lut16, off, *s3, rowinfo=rows,
                page_table=pt, rep=hq // hkv, row_heads=hq)
            plain = lambda: aref.approx_attention_paged_ref(
                q.reshape(-1, sq, d), k_pool, v_pool, lut32, off, *s3,
                rowinfo=rows_h, page_table=pt_h, rep=hq // hkv)
            kd = k_pool[:, ptl].reshape(hkv, nb, -1, d).transpose(0, 1)
            vd = v_pool[:, ptl].reshape(hkv, nb, -1, d).transpose(0, 1)
            bk = LM_BLOCK
        else:
            k, v = kc[:nb].transpose(1, 2), vc[:nb].transpose(1, 2)
            kname = "approx_flash_attention"
            s3 = [sym(q), sym(kc[:nb]), sym(vc[:nb])]
            kern = lambda: ops[kname](q, k, v, lut16, off, *s3,
                                      rowinfo=rows, row_heads=hq)
            plain = lambda: aref.approx_attention_ref(
                q.reshape(-1, sq, d), k.reshape(-1, LM_MAX_SEQ, d),
                v.reshape(-1, LM_MAX_SEQ, d), lut32, off, *s3,
                rowinfo=rows_h)
            kd, vd = k, v
            bk = 128
        if name == "paged decode":
            decode_case = (q, pt, pt_h, s3, rows, rows_h)
        yk, yp = kern(), plain()
        pv_scale = aref.attn_scales(*s3, d, 127)[1]
        agree = aref.same_device_agreement(yk, yp, lut32, off, 127, pv_scale,
                                           bk)
        err = agree["max_err"]
        check(bool(torch.isfinite(yk).all()) and agree["within_flip"]
              and agree["flip_rows"] <= ATTN_FLIP_ROWS,
              f"{kname} {name} {tuple(q.shape)}: max |diff| {err:.3e}, "
              f"{agree['flip_rows']} rows beyond {agree['ulp_tol']:.3e} "
              f"(at most {ATTN_FLIP_ROWS}, each within one flip, "
              f"{agree['flip_tol']:.3e}); mean |y| {agree['mean_abs']:.3e}")
        # yardstick: exact attention on the same q/k/v and mask
        kpos = torch.arange(kd.shape[2], device=dev)
        qpos = rows[:, :1, None] + torch.arange(sq, device=dev)[None, :,
                                                                 None]
        mask = ((kpos >= rows[:, 1:2, None]) & (kpos < rows[:, 2:3, None])
                & (kpos <= qpos))[:, None]
        qd, kdd, vdd = q.contiguous(), kd.contiguous(), vd.contiguous()
        lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qd, kdd, vdd, attn_mask=mask, enable_gqa=True), 10)
        reps = 20 if sq == 1 else 5
        ms = cuda_ms(torch, kern, reps)
        pms = cuda_ms(torch, plain, 1, warm=0)
        bytes_, lookups = attn_work(np, info, sq, hq, hkv, d, 2)
        bound = max(bytes_ / HBM_BYTES_PER_S, lookups / lookups_per_s) * 1e3
        print(f"    {name:19s} {kname}: {ms:.4f} ms (plain {pms:.2f}, "
              f"scaled_dot_product_attention {lib:.4f}), bound {bound:.4f} "
              f"ms ({lookups / 1e6:.1f} M lookups, {bytes_ / 1e6:.2f} MB)",
              flush=True)
        if name.endswith("decode"):   # the JSON row: one decode step
            account(kname, cfg.n_layers, ms, pms, lib, bytes_, lookups, err)

    # -- kernel 9's decode path: a biased table, and a planted fault --------
    q, pt, pt_h, s3, rows, rows_h = decode_case
    plan = decode_plan(q.shape[0] * hq, 1, d, hq // hkv, hq, LM_BLOCK, 2,
                       n_codes, n_log, runtime.sm_count(0))
    print(f"  approx_flash_attention_paged decode plan: {plan.items} items "
          f"of {plan.heads} query heads (one per batch row and KV head), "
          f"{plan.per_block} a block, {plan.grid} blocks, {plan.smem} B of "
          f"shared memory")
    b32 = torch.from_numpy(biased_lut(np)).to(dev)
    pv_scale = aref.attn_scales(*s3, d, 127)[1]
    for label, l16, l32, table in (
            ("biased table", b32.to(torch.int16), b32, pt),
            ("planted fault: batch row 0's page table shifted by one page",
             lut16, lut32, torch.cat([pt[:1].roll(1, dims=1), pt[1:]]))):
        yk = ops["approx_flash_attention_paged"](
            q, k_pool, v_pool, l16, off, *s3, rowinfo=rows,
            page_table=table, row_heads=hq, rep=hq // hkv)
        yp = aref.approx_attention_paged_ref(
            q.reshape(-1, 1, d), k_pool, v_pool, l32, off, *s3,
            rowinfo=rows_h, page_table=pt_h, rep=hq // hkv)
        agree = aref.same_device_agreement(yk, yp, l32, off, 127, pv_scale,
                                           LM_BLOCK)
        held = agree["within_flip"] and agree["flip_rows"] <= ATTN_FLIP_ROWS
        fault = label.startswith("planted")
        check(held != fault,
              f"approx_flash_attention_paged decode, {label}: max |diff| "
              f"{agree['max_err']:.3e}, {agree['flip_rows']} rows beyond "
              f"{agree['ulp_tol']:.3e} (one flip {agree['flip_tol']:.3e}): "
              + ("caught, beyond the tolerance" if fault else
                 "within the tolerance"))
    del decode_case

    # -- kernel 8's decode path ---------------------------------------------
    redesign["kernel 8 " + cfg.name] = hold_decode_path(
        torch, np, dev, check, acu, ops, cfg, 12)

    # -- kernel 3 at the LM's GEMM shapes, bitwise --------------------------
    print("  fused_lut_dense at the LM's GEMM shapes, bitwise:")
    gemms = [("q/o", cfg.d_model, hq * d, 2), ("k/v", cfg.d_model, hkv * d, 2),
             ("gate/up", cfg.d_model, cfg.d_ff, 2),
             ("down", cfg.d_ff, cfg.d_model, 1),
             ("head", cfg.d_model, cfg.vocab_padded, 1)]
    b16 = b32.to(torch.int16)
    step_ms = 0.0
    for m_rows in (b, 256):
        for label, kk, nn, per_layer in gemms:
            x = rand(m_rows, kk)
            w = rand(kk, nn) * 0.05
            xqp = symmetric_qparams(torch.clamp_min(x.abs().amax(), 1e-6), 8)
            wqp = symmetric_qparams(torch.clamp_min(w.abs().amax(dim=0),
                                                    1e-9), 8, axis=1)
            wq = acu_operand(quantize(w, wqp), wqp).contiguous()
            a3 = (xqp.scale, xqp.zero_point, wqp.scale)
            kern = lambda: ops["fused_lut_dense"](x, wq, lut16, off, *a3)
            yk = kern()
            yp = fused_lut_dense_ref(x, wq, lut32, off, n_codes, *a3)
            same = torch.equal(yk, yp)
            if m_rows == b:      # the raw accumulator on the biased table
                same = same and torch.equal(
                    ops["fused_lut_dense"](x, wq, b16, off, *a3,
                                           emit_acc=True),
                    fused_lut_dense_ref(x, wq, b32, off, n_codes, *a3,
                                        emit_acc=True))
            plan = dense_plan(m_rows, kk, nn, runtime.sm_count(0)).summary()
            check(same, f"fused_lut_dense {label} {m_rows}x{kk}x{nn}: "
                        f"bitwise equal to the plain version"
                        + (", and emit_acc on a biased table"
                           if m_rows == b else "")
                        + f"; plan {plan}")
            ms = cuda_ms(torch, kern, 10)
            xf, wf = x.float(), w.float()
            lib = cuda_ms(torch, lambda: torch.matmul(xf, wf), 10)
            bound = max((m_rows * kk * 2 + kk * nn * 4 + lut_bytes
                         + m_rows * nn * 4) / HBM_BYTES_PER_S,
                        m_rows * kk * nn / lookups_per_s) * 1e3
            line = (f"    M={m_rows:4d} {label:8s} {kk}x{nn}: {ms:.4f} ms, "
                    f"torch.matmul f32 {lib:.4f} ms, bound {bound:.4f} ms")
            if m_rows == b:              # the JSON row: one decode step
                count = 1 if label == "head" else per_layer * cfg.n_layers
                pms = cuda_ms(torch, lambda: fused_lut_dense_ref(
                    x, wq, lut32, off, n_codes, *a3), 1, warm=0)
                account("fused_lut_dense", count, ms, pms, lib,
                        m_rows * kk * 2 + kk * nn * 4 + lut_bytes
                        + m_rows * nn * 4, m_rows * kk * nn, 0.0)
                line += f" (plain {pms:.2f} ms, x{count} per decode step)"
                step_ms += count * ms
            print(line, flush=True)
    print(f"  fused_lut_dense per SmolLM decode step ({7 * cfg.n_layers + 1} "
          f"GEMMs at M = {b}): {step_ms:.3f} ms")
    del kc, vc, k_pool, v_pool

    # -- serve 64 requests through each engine, depth cut ------------------
    scfg = dataclasses.replace(cfg, n_layers=LM_SERVE_LAYERS)
    params = init_params(0, scfg, device=dev)
    prompts = lm_requests(np, scfg.vocab_size, LM_REQUESTS, LM_SHARED)
    print(f"  full width cut to {scfg.n_layers} of {cfg.n_layers} layers, "
          f"serving {LM_REQUESTS} requests ({LM_SHARED} sharing a "
          f"{LM_PREFIX}-token prefix), {LM_NEW} new tokens each, "
          f"slots={LM_SLOTS}, max_seq={LM_MAX_SEQ}, paged block "
          f"{LM_BLOCK}:")
    n_dense = 7 * scfg.n_layers + 1
    rates = serve_lm(torch, check, E, lm_engines(E, params, scfg, acfg, dev),
                     prompts, LM_NEW, scfg, ops, launches,
                     {"fused_lut_dense": n_dense, "quantize": n_dense})

    # -- one short request on the card and on the CPU ----------------------
    short = [E.Request(prompt=prompts[3][:16].copy(), max_new_tokens=4)]
    on_gpu = E.ContinuousServeEngine(params, scfg, slots=1, max_seq=64,
                                     acfg=acfg, device=dev).run(short)
    def to_cpu(tree):
        return ({k: to_cpu(v) for k, v in tree.items()}
                if isinstance(tree, dict) else tree.cpu())

    cpu_params = to_cpu(params)
    short_cpu = [E.Request(prompt=prompts[3][:16].copy(), max_new_tokens=4)]
    t0 = time.perf_counter()
    on_cpu = E.ContinuousServeEngine(cpu_params, scfg, slots=1, max_seq=64,
                                     acfg=acfg, device="cpu").run(short_cpu)
    print(f"  one 16-token request, 4 new tokens: card {list(on_gpu[0].out)}"
          f", CPU {list(on_cpu[0].out)} ({time.perf_counter() - t0:.1f} s "
          f"on the CPU)")
    check(list(on_gpu[0].out) == list(on_cpu[0].out),
          "a short request gives the same tokens on the card and the CPU")

    # -- profile one decode step of each KV layout ------------------------
    cache = init_cache(scfg, b, LM_MAX_SEQ, device=dev)
    for kv in cache["groups"]["b0"]["attn"]:
        kv.normal_(generator=gen)
    pos_t = torch.from_numpy(pos).to(dev)
    toks = torch.from_numpy(rng.integers(1, scfg.vocab_size,
                                         (b, 1))).to(dev)
    dkw = dict(pos_offset=torch.zeros(b, dtype=torch.long, device=dev),
               pad_mask=torch.ones((b, LM_MAX_SEQ), dtype=torch.bool,
                                   device=dev))
    pool = init_paged_cache(scfg, n_pool + 2, LM_BLOCK, device=dev)
    for kv in pool["groups"]["b0"]["attn"]:
        kv.normal_(generator=gen)
    table = torch.from_numpy(2 + rng.permutation(n_pool).reshape(
        b, n_log).astype(np.int32)).to(dev)
    steps = {
        "contiguous": lambda: E.apply_model(
            params, toks, scfg, acfg=acfg, cache=cache, cache_pos=pos_t,
            decode=True, **dkw),
        "paged": lambda: E.apply_model(
            params, toks, scfg, acfg=acfg, cache=pool, cache_pos=pos_t,
            decode=True, page_table=table),
    }
    with torch.inference_mode():
        for name, step in steps.items():
            step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                step()[0].argmax(-1).cpu()
            wall = (time.perf_counter() - t0) / 5 * 1e3
            profile(torch, f"{name} decode step, {b} rows",
                    lambda: step()[0].argmax(-1).cpu(), wall)
    return rates


def moe_phase(torch, np, dev, check, acu, ops, launches, account,
              lookups_per_s, lut_bytes, redesign: dict) -> dict:
    """granite-moe-3b-a800m on the fused ACU: kernel 10 at the model's
    shapes and kernel 8's decode path at its attention's, then 32 requests
    through each LM engine on a cut to MOE_SERVE_LAYERS layers, the card
    against the CPU on a two-layer cut, and a profile of one decode step.
    Returns tokens/s by engine; kernel 8's decode-path times go into
    ``redesign``."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core import (ApproxConfig, QParams, acu_operand,
                                  inline_symmetric_scale, quantize)
    from repro_torch.core.quantization import device_scalar
    from repro_torch.kernels.fused_lut_grouped.ops import (
        fused_lut_grouped_planned, grouped_plan, split_segments)
    from repro_torch.kernels.fused_lut_grouped.ref import (
        fused_lut_grouped_ref, live_rows, packed_rows)
    from repro_torch.kernels.runtime import lut_to_int16
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import silu
    from repro_torch.serve import engine as E

    cfg = get_config(MOE_ARCH)
    n_exp, k, d, f = cfg.n_experts, cfg.moe_top_k, cfg.d_model, cfg.d_ff
    bf = torch.bfloat16
    acfg = ApproxConfig(acu=acu)
    lut16, lut32 = acu.device_lut(dev), torch.from_numpy(
        acu.lut.reshape(-1)).to(dev)
    off, n_codes = acu.offset, acu.multiplier.n_codes
    zero = device_scalar(0.0, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    print(f"granite-moe-3b-a800m ({cfg.n_layers} layers, d {d}, "
          f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV heads, head_dim "
          f"{cfg.head_dim}, {n_exp} experts top-{k}, d_ff {f} per expert, "
          f"vocab {cfg.vocab_padded}, {cfg.dtype}, {cfg.n_params() / 1e9:.2f} B "
          f"parameters), {MULT} fused ACU:")
    scfg = dataclasses.replace(cfg, n_layers=MOE_SERVE_LAYERS)  # served
    t0 = time.perf_counter()
    params = T.init_params(0, scfg, device=dev)
    torch.cuda.synchronize()
    print(f"  random weights from seed 0 for the served cut to "
          f"{scfg.n_layers} of {cfg.n_layers} layers in "
          f"{time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    mlp0 = {n: t[0] for n, t in params["groups"]["b0"]["mlp"].items()}

    def codes(w):
        """Expert weight codes and scales as approx_grouped_dense makes
        them: per expert and output channel, multiply-form scale."""
        ws = inline_symmetric_scale(
            torch.clamp_min(w.abs().amax(dim=1), 1e-9), 8)
        qp = QParams(scale=ws[:, None, :], zero_point=zero, bits=8)
        return acu_operand(quantize(w, qp), qp), ws

    def act_scale(x):
        return inline_symmetric_scale(torch.clamp_min(x.abs().amax(), 1e-6),
                                      8)

    weights = {n: codes(mlp0[n]) for n in ("w_gate", "w_up", "w_down")}

    def hold(label, x, wname, counts, per_step=0, table=None, emit=False,
             times=None):
        """Kernel 10 against its plain version at one shape, bitwise;
        times kernel, plain version and torch.bmm (f32) at (E, nb*C, K) x
        (E, K, N); accounts ``per_step`` calls of one decode step and puts
        (ms, torch.bmm ms, bound ms) into ``times`` under ``label``."""
        wq, ws = weights[wname]
        G, C, K = x.shape
        N = wq.shape[2]
        nb = G // n_exp
        xs = act_scale(x)
        l16, l32 = (lut16, lut32) if table is None else table
        kern = lambda: ops["fused_lut_grouped"](x, wq, l16, off, xs, zero,
                                                ws, counts, emit_acc=emit)
        plain = lambda: fused_lut_grouped_ref(x, wq, l32, off, n_codes, xs,
                                              zero, ws, counts,
                                              emit_acc=emit)
        yk, yp = kern(), plain()
        dead = ~live_rows(counts, C)
        ok = torch.equal(yk, yp) and not bool(yk[dead].any())
        check(ok, f"fused_lut_grouped {label} G={G} C={C} {K}->{N}"
                  f"{' emit_acc' if emit else ''}: bitwise equal to the "
                  f"plain version, dead rows 0")
        per_e = counts.reshape(nb, n_exp).sum(0)
        live, e_live = int(per_e.sum()), int((per_e > 0).sum())
        xb = x.reshape(nb, n_exp, C, K).transpose(0, 1).reshape(
            n_exp, nb * C, K).float()
        wf = wq.float()
        lib = cuda_ms(torch, lambda: torch.bmm(xb, wf), 10)
        del xb, wf
        ms = cuda_ms(torch, kern, 20)
        pms = cuda_ms(torch, plain, 1, warm=0)
        bytes_ = (live * K * x.element_size() + e_live * K * N * 4
                  + n_exp * N * 4 + l16.numel() * 2 + G * 4 + G * C * N * 4)
        lookups = live * K * N
        bound = max(bytes_ / HBM_BYTES_PER_S, lookups / lookups_per_s) * 1e3
        print(f"    {label:22s} G={G} C={C:2d} {K}->{N}: {ms:.4f} ms (plain "
              f"{pms:.2f}, torch.bmm f32 {lib:.4f}), bound {bound:.4f} ms "
              f"({live} live rows, {lookups / 1e9:.3f} G lookups, "
              f"{bytes_ / 1e6:.1f} MB)", flush=True)
        if per_step:
            account("fused_lut_grouped", per_step, ms, pms, lib, bytes_,
                    lookups, 0.0 if ok else float("inf"))
        if times is not None:
            times[label] = (ms, lib, bound)
        return yk

    # -- kernel 10 at granite's shapes -------------------------------------
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"  fused_lut_grouped (kernel 10) work plans on {n_sm} SMs:")
    for t, label in ((LM_SLOTS, "decode"), (128, "prefill 128"),
                     (512, "prefill 512")):
        geo = M.dispatch_geometry(cfg, t)
        for name, kk, nn in (("gate/up", d, f), ("down", f, d)):
            plan = grouped_plan(n_exp, geo["n_blocks"], geo["capacity"], kk,
                                nn, n_sm, n_codes, 2)
            print(f"    {label} {name}: {plan.describe()}")
    print("  fused_lut_grouped against its plain version (counts from layer "
          "0's routing of random hidden states, and synthetic):")
    step_ms = {}
    for t, label in ((LM_SLOTS, "decode"), (128, "prefill 128"),
                     (512, "prefill 512")):
        geo = M.dispatch_geometry(cfg, t)
        x = torch.randn((t, d), generator=gen, device=dev).to(bf)
        _, _, top_e = M._route(x, mlp0["router"], k)
        xe, counts, _, _ = M.dispatch(x, top_e, geo)
        G, C = geo["n_blocks"] * n_exp, geo["capacity"]
        xg, cnt = xe.reshape(G, C, d), counts.reshape(G)
        step = 2 * cfg.n_layers if label == "decode" else 0
        gate = hold(f"{label} gate", xg, "w_gate", cnt, step, times=step_ms)
        up = hold(f"{label} up", xg, "w_up", cnt, times=step_ms)
        h = silu(gate.to(bf)) * up.to(bf)
        hold(f"{label} down", h, "w_down", cnt, step // 2, times=step_ms)
        if label == "decode":
            b32 = torch.from_numpy(biased_lut(np)).to(dev)
            hold("decode gate, biased", xg, "w_gate", cnt,
                 table=(lut_to_int16(b32), b32), emit=True)
            decode_ops = (xg, cnt)
    geo = M.dispatch_geometry(cfg, 512)
    nb, C = geo["n_blocks"], geo["capacity"]
    G = nb * n_exp
    rng = np.random.default_rng(13)
    synth = {
        "empty experts": np.where(np.arange(G) % n_exp % 5 == 0, 0,
                                  rng.integers(0, C + 1, G)),
        "all to one": np.where(np.arange(G) % n_exp == 0, C, 0),
    }
    for label, cnt in synth.items():
        cnt = torch.from_numpy(cnt.astype(np.int32)).to(dev)
        live = live_rows(cnt, C)[..., None]
        for wname, width in (("w_gate", d), ("w_down", f)):
            x = torch.randn((G, C, width), generator=gen, device=dev).to(bf)
            hold(f"{label} {wname[2:]}", x * live.to(bf), wname, cnt)

    # -- kernel 10: a planted fault, the bank-conflict replay --------------
    xg, cnt = decode_ops
    geo = M.dispatch_geometry(cfg, LM_SLOTS)
    nb, C = geo["n_blocks"], geo["capacity"]
    wq, ws = weights["w_gate"]
    xs = act_scale(xg)
    plan = grouped_plan(n_exp, nb, C, d, f, n_sm, n_codes, 2)
    offsets, segs = split_segments(plan, cnt)
    rows = packed_rows(cnt.cpu(), n_exp, C)
    i = next(i for i, (tl, _, _, slot) in enumerate(segs.tolist())
             if slot >= 0 and rows[plan.tile(tl)[0]].numel())
    bad = (tuple(int(o - (o > i)) for o in offsets),
           np.delete(segs, i, axis=0))
    same, caught = [], []
    for emit in (False, True):
        want = fused_lut_grouped_ref(xg, wq, lut32, off, n_codes, xs, zero,
                                     ws, cnt, emit_acc=emit)
        # poison: the dropped split's tile is never stored
        poison = torch.full_like(want, -2 ** 31 if emit else float("nan"))
        for pinned, got in (((offsets, segs), same), (bad, caught)):
            yk = fused_lut_grouped_planned(xg, wq, lut16, off, xs, zero, ws,
                                           cnt, plan=plan, segments=pinned,
                                           out=poison.clone(), emit_acc=emit)
            got.append(torch.equal(yk, want))
    e_i, _, nt_i = plan.tile(int(segs[i, 0]))
    check(all(same), f"fused_lut_grouped decode gate: the host's split "
                     f"({len(segs)} segments on {plan.grid} blocks), pinned, "
                     f"gives the plain version bit for bit, float32 and "
                     f"emit_acc")
    check(not any(caught), f"fused_lut_grouped decode gate, planted fault: "
                           f"the split with segment {i} (expert {e_i}, "
                           f"column tile {nt_i}, K chunks {segs[i, 1]}.."
                           f"{segs[i, 2]}) dropped differs from the plain "
                           f"version, float32 and emit_acc")
    # conflict-free: every row one code, and lane l's column j of a tile
    # code 2l + 64 j (word l + 32 j, bank l)
    col = torch.arange(f, device=dev)
    free_w = (2 * (col % plan.bn // plan.tn) + 64 * (col % plan.tn % 4)
              - 128).to(torch.int32)[None, None, :].expand(n_exp, d,
                                                            f).contiguous()
    free_x = torch.full_like(xg, 0.5)
    rep = [cuda_ms(torch, lambda: ops["fused_lut_grouped"](
        xx, ww, lut16, off, xs, zero, ws, cnt), 20)
        for xx, ww in ((xg, wq), (free_x, free_w), (xg, wq))]
    step_ms["replay"] = min(rep[0], rep[2]) / rep[1]
    print(f"  fused_lut_grouped decode gate bank-conflict replay: real codes "
          f"{rep[0]:.4f} ms (again {rep[2]:.4f}), conflict-free codes "
          f"{rep[1]:.4f} ms: x{step_ms['replay']:.2f}")
    redesign["kernel 10"] = step_ms
    del free_w, free_x

    # -- kernel 8's decode path at granite's attention --------------------
    redesign["kernel 8 " + cfg.name] = hold_decode_path(
        torch, np, dev, check, acu, ops, cfg, 14)

    # -- serve 32 requests through each engine -----------------------------
    prompts = lm_requests(np, scfg.vocab_size, MOE_REQUESTS, MOE_SHARED)
    per_call = {"fused_lut_grouped": 3 * scfg.n_layers,
                "fused_lut_dense": 4 * scfg.n_layers + 1,
                "quantize": 7 * scfg.n_layers + 1}
    print(f"  full width cut to {scfg.n_layers} of {cfg.n_layers} layers, "
          f"serving {MOE_REQUESTS} requests ({MOE_SHARED} sharing a "
          f"{LM_PREFIX}-token prefix), {MOE_NEW} new tokens each, "
          f"slots={LM_SLOTS}, max_seq={LM_MAX_SEQ}, paged block "
          f"{LM_BLOCK}:")
    rates = serve_lm(torch, check, E, lm_engines(E, params, scfg, acfg, dev),
                     prompts, MOE_NEW, scfg, ops, launches, per_call)

    # -- layer 0's routing statistics at one decode step and one prefill ---
    b = LM_SLOTS
    inner, seen = T.moe_block, []

    def layer0_stats(h, p, cfg_, acfg_):
        if seen:
            return inner(h, p, cfg_, acfg_)
        out, st = inner(h, p, cfg_, acfg_, return_stats=True)
        seen.append({n: float(v) for n, v in st.items()})
        return out

    cache = T.init_cache(scfg, b, LM_MAX_SEQ, device=dev)
    pos = torch.from_numpy(rng.integers(16, LM_MAX_SEQ // 2, b)).to(dev)
    toks = torch.from_numpy(rng.integers(1, scfg.vocab_size, (b, 1))).to(dev)
    prefill = torch.from_numpy(rng.integers(1, scfg.vocab_size,
                                            (1, 256))).to(dev)
    T.moe_block = layer0_stats
    try:
        with torch.inference_mode():
            for label, call in (
                    ("decode step, 32 rows", lambda: T.apply_model(
                        params, toks, scfg, acfg=acfg, cache=cache,
                        cache_pos=pos, decode=True)),
                    ("prefill, 256 tokens", lambda: T.apply_model(
                        params, prefill, scfg, acfg=acfg, last_only=True))):
                seen.clear()
                call()
                t = toks.numel() if label.startswith("decode") else 256
                print(f"  layer 0, {label}: dropped_frac "
                      f"{seen[0]['dropped_frac']:.4f}, aux_loss "
                      f"{seen[0]['aux_loss']:.4f}; dispatch "
                      f"{M.dispatch_geometry(scfg, t)}")
                check(0.0 <= seen[0]["dropped_frac"] < 1.0
                      and np.isfinite(seen[0]["aux_loss"]),
                      f"layer 0 statistics at the {label} are finite")
    finally:
        T.moe_block = inner

    # -- the card against the CPU, two layers -------------------------------
    cut = dataclasses.replace(cfg, n_layers=MOE_CPU_LAYERS)
    small = T.init_params(1, cut, device=dev)
    short = prompts[3][:16]
    on_gpu = E.ContinuousServeEngine(small, cut, slots=1, max_seq=64,
                                     acfg=acfg, device=dev).run(
        [E.Request(prompt=short.copy(), max_new_tokens=4)])

    def to_cpu(tree):
        return ({n: to_cpu(v) for n, v in tree.items()}
                if isinstance(tree, dict) else tree.cpu())

    t0 = time.perf_counter()
    on_cpu = E.ContinuousServeEngine(to_cpu(small), cut, slots=1, max_seq=64,
                                     acfg=acfg, device="cpu").run(
        [E.Request(prompt=short.copy(), max_new_tokens=4)])
    print(f"  full width cut to {MOE_CPU_LAYERS} layers (32 layers of plain "
          f"LUT gathers would take minutes on the CPU), one 16-token "
          f"request, 4 new tokens: card {list(on_gpu[0].out)}, CPU "
          f"{list(on_cpu[0].out)} ({time.perf_counter() - t0:.1f} s on the "
          f"CPU)")
    check(list(on_gpu[0].out) == list(on_cpu[0].out),
          f"granite-moe-3b-a800m cut to {MOE_CPU_LAYERS} layers: the same "
          f"tokens on the card and the CPU")
    del small

    # -- profile one decode step -------------------------------------------
    with torch.inference_mode():
        step = lambda: T.apply_model(params, toks, scfg, acfg=acfg,
                                     cache=cache, cache_pos=pos,
                                     decode=True)[0].argmax(-1).cpu()
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            step()
        wall = (time.perf_counter() - t0) / 3 * 1e3
        profile(torch, f"granite-moe-3b-a800m decode step, {b} rows", step,
                wall)
        mlp = params["groups"]["b0"]["mlp"]
        glue = cuda_ms(torch, lambda: [codes(mlp[n][0]) for n in
                                       ("w_gate", "w_up", "w_down")], 5)
        print(f"  expert weight quantization (scales, codes) of one layer: "
              f"{glue:.3f} ms, x{cfg.n_layers} layers = "
              f"{glue * cfg.n_layers:.1f} ms of each full-depth model call")
    return rates


def quantize_operands(torch, gen, dev, shape, form, dtype):
    """x, scale, zero point for one quantize check: scales per ``form``
    (``"tensor"``, an axis, or ``"grouped"`` (E, 1, N)), half of them
    powers of two, so that the third of ``x`` put on half-code boundaries
    ``(k + 0.5) * s`` lies on them exactly in bfloat16 too; 3 % of ``x``
    far past the clip; zero points nonzero per channel."""
    if form == "tensor":
        sshape = ()
    elif form == "grouped":
        sshape = (shape[0], 1, shape[2])
    else:
        sshape = tuple(n if i == form else 1 for i, n in enumerate(shape))
    exp = torch.randint(5, 12, sshape, generator=gen, device=dev)
    s = torch.pow(2.0, -exp.float())
    odd = torch.rand(sshape, generator=gen, device=dev) < 0.5
    s = torch.where(odd, s * 1.37, s)
    z = (torch.zeros(sshape, device=dev) if form in ("tensor", "grouped")
         else torch.randint(-3, 4, sshape, generator=gen,
                            device=dev).float())
    x = torch.randn(shape, generator=gen, device=dev) * 60 * s
    half = (torch.randint(-128, 128, shape, generator=gen,
                          device=dev).float() + 0.5) * s
    pick = torch.rand(shape, generator=gen, device=dev)
    x = torch.where(pick < 0.33, half, x)
    x = torch.where(pick > 0.97, torch.sign(x) * 500 * s, x)
    return x.to(dtype), s, z


def quantize_plan_for(torch, x, s, z):
    """The plan kernel 2's wrapper makes for these operands."""
    from repro_torch.kernels import runtime
    from repro_torch.kernels.quantize.ops import VEC_BYTES, quantize_plan
    shape = tuple(x.shape)
    return quantize_plan(shape, x.stride(), s.expand(shape).stride(),
                         z.expand(shape).stride(), x.element_size(),
                         x.data_ptr() % VEC_BYTES,
                         runtime.launch_config(x)[0])


def perturb_rwkv(torch, params, gen) -> None:
    """Draws, in place, the rwkv leaves that the reference's init leaves at
    one value (``lora_B_*`` and ``bonus`` at 0, one decay, mixes at 0.5),
    so that the served model runs the LoRA token shift, the bonus term and
    a spread of decays (0.07 to 0.87)."""
    for blk in params["groups"].values():
        p = blk["rwkv"]
        for name, t in p.items():
            if name.startswith("lora_B"):
                t.normal_(0.0, 0.05, generator=gen)
            elif name == "bonus":
                t.normal_(0.0, 0.5, generator=gen)
            elif name == "decay_base":
                t.uniform_(-2.0, 1.0, generator=gen)
            elif name.startswith(("mu_", "cm_mu")):
                t.uniform_(0.0, 1.0, generator=gen)


def rwkv_phase(torch, np, dev, check, acu, ops, launches, account,
               fma_per_s) -> dict:
    """rwkv6-3b on the fused ACU: kernel 12 at the model's shapes, kernel 2
    at every weight shape of the three served models, then 32 requests
    through the wave and continuous engines, the card against the CPU on a
    two-layer cut, and a profile of one decode step. Returns tokens/s by
    engine."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core import (ApproxConfig, acu_operand, quantize,
                                  symmetric_qparams)
    from repro_torch.kernels.quantize.ref import quantize_ref
    from repro_torch.kernels.wkv.ops import wkv_work
    from repro_torch.kernels.wkv.ref import out_bound, wkv_ref
    from repro_torch.models import transformer as T
    from repro_torch.serve import engine as E

    cfg = get_config(RWKV_ARCH)
    d, f, h, hd = cfg.d_model, cfg.d_ff, cfg.rwkv_n_heads, cfg.rwkv_head_dim
    n_layers, b = cfg.n_layers, LM_SLOTS
    bf = torch.bfloat16
    acfg = ApproxConfig(acu=acu)
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    print(f"rwkv6-3b ({n_layers} layers, d {d}, {h} wkv heads x {hd}, d_ff "
          f"{f}, vocab {cfg.vocab_padded}, {cfg.dtype}), {MULT} fused ACU:")

    # -- kernel 12 at the decode and prefill shapes --------------------------
    print("  wkv against its plain version (S_T bitwise; out within "
          "hd*eps*sum_k |r_k a[k, v]|), w in (0.05, 0.95), s0 and u "
          "nonzero:")
    cases = [("decode", b, 1)] + [
        (f"continuous prefill {n}", 1, n) for n in (16, 32, 64, 128, 256)
    ] + [("wave prefill", b, LM_WAVE_PROMPT)]
    for label, nb, t in cases:
        r, k, v = (torch.randn((nb, t, h, hd), generator=gen, device=dev)
                   for _ in range(3))
        w = torch.rand((nb, t, h, hd), generator=gen, device=dev) * 0.9 \
            + 0.05
        u = torch.randn((h, hd), generator=gen, device=dev) * 0.5
        s0 = torch.randn((nb, h, hd, hd), generator=gen, device=dev)

        def fold(a):
            return a.transpose(1, 2).reshape(nb * h, t, hd)

        folded = [fold(a) for a in (r, k, v, w)] + [
            u, s0.reshape(nb * h, hd, hd)]
        kern = lambda: ops["wkv"](r, k, v, w, u, s0)
        plain = lambda: wkv_ref(*folded)
        (yk, sk), (yp, sp) = kern(), plain()
        diff = (fold(yk) - yp).abs()
        bound = out_bound(*folded)
        check(torch.equal(sk.reshape(nb * h, hd, hd), sp)
              and bool((diff <= bound).all())
              and bool(torch.isfinite(yk).all()),
              f"wkv {label} (B {nb}, T {t}): S_T bitwise equal to the plain "
              f"version, out within the bound (max |diff| "
              f"{float(diff.max()):.3e}, largest bound "
              f"{float(bound.max()):.3e})")
        ms = cuda_ms(torch, kern, 20 if t == 1 else 5)
        pms = cuda_ms(torch, plain, 1, warm=0)
        bytes_, flops = wkv_work(r, k, v, w, u, s0, None)
        bound_ms = max(bytes_ / HBM_BYTES_PER_S, flops / (2 * fma_per_s)) \
            * 1e3
        print(f"    {label:22s} {ms:.4f} ms (plain {pms:.2f}), bound "
              f"{bound_ms:.4f} ms ({bytes_ / 1e6:.1f} MB, "
              f"{flops / 1e6:.1f} M flops)", flush=True)
        if label == "decode":             # the JSON row: one decode step
            account("wkv", n_layers, ms, pms, None, bytes_, flops,
                    float(diff.max()), ops_per_s=2 * fma_per_s)
        del r, k, v, w, s0, folded, yk, yp, sk, sp, diff, bound

    # -- kernel 2 at every weight shape of the served models ---------------
    gcfg = get_config(MOE_ARCH)
    gd, ge, gf = gcfg.d_model, gcfg.n_experts, gcfg.d_ff
    gq, gkv = gcfg.n_heads * gcfg.head_dim, gcfg.n_kv_heads * gcfg.head_dim
    shapes = [  # (label, shape, form, calls per rwkv6-3b decode step)
        ("rwkv Wr/Wk/Wv/Wg/Wo/Wr_cm", (d, d), 1, 6 * n_layers),
        ("rwkv Wk_cm", (d, f), 1, n_layers),
        ("rwkv Wv_cm", (f, d), 1, n_layers),
        ("rwkv head", (d, cfg.vocab_padded), 1, 1),
        ("granite q/o", (gd, gq), 1, 0), ("granite k/v", (gd, gkv), 1, 0),
        ("granite head", (gd, gcfg.vocab_padded), 1, 0),
        ("granite gate/up", (ge, gd, gf), "grouped", 0),
        ("granite down", (ge, gf, gd), "grouped", 0),
        ("ResNet head", (64, 10), 1, 0),
        ("per tensor (wave activations)", (b * LM_WAVE_PROMPT, d), "tensor",
         0),
    ] + [(f"ResNet {name}", (cout, cin, k, k), 0, 0)
         for name, cin, _, cout, k, _, _, _ in CONVS]
    print("  quantize against its plain version, bitwise, float32 and "
          "bfloat16 (a third of the values on half-code boundaries, 3 % "
          "past the clip), on the path quantize_plan picks (strip, flat or "
          "strided; every weight on a vector path):")
    step_ms = step_bound = step_copy = 0.0
    for label, shape, form, per_step in shapes:
        same, paths = [], []
        for dtype in (torch.float32, bf):
            x, s, z = quantize_operands(torch, gen, dev, shape, form, dtype)
            path = quantize_plan_for(torch, x, s, z).path
            v0 = ops["quantize"].vector_launches
            qk, qp = ops["quantize"](x, s, z), quantize_ref(x, s, z)
            same.append(torch.equal(qk, qp) and int(qk.min()) == -128
                        and int(qk.max()) == 127
                        and ops["quantize"].vector_launches - v0
                        == int(path != "strided"))
            paths.append(path)
        check(all(same) and "strided" not in paths,
              f"quantize {label} {shape}, "
              f"{'per tensor' if form == 'tensor' else form}: bitwise equal "
              f"in float32 and bfloat16, both clip edges reached, path "
              f"{'/'.join(dict.fromkeys(paths))} (vector_launches as the "
              f"plan says)")
        if per_step:                      # the JSON row: one decode step
            kern = lambda: ops["quantize"](x, s, z)
            ms = cuda_ms(torch, kern, 10)
            step_ms += per_step * ms
            t0 = time.perf_counter()
            for _ in range(20):
                kern()
            host_ms = (time.perf_counter() - t0) / 20 * 1e3
            torch.cuda.synchronize()
            pms = cuda_ms(torch, lambda: quantize_ref(x, s, z), 2, warm=1)
            xf, sc = x.float(), s.reshape(-1)
            zi = torch.zeros(sc.shape, dtype=torch.int64, device=dev)
            lib = cuda_ms(torch, lambda: torch.quantize_per_channel(
                xf, sc, zi, 1, torch.qint8), 10)
            bytes_ = x.numel() * 6 + shape[1] * 8
            account("quantize", per_step, ms, pms, lib, bytes_, 0,
                    0.0 if all(same) else float("inf"))
            step_bound += per_step * bytes_ / HBM_BYTES_PER_S * 1e3
            # the card's own rate for these bytes: a PyTorch copy of the
            # bfloat16 bits into int32, 2 bytes read and 4 written each
            y32 = torch.empty(shape, dtype=torch.int32, device=dev)
            copy_ms = cuda_ms(torch, lambda: y32.copy_(x.view(torch.int16)),
                              10)
            step_copy += per_step * copy_ms
            del y32
            print(f"    {label:28s} {shape} bfloat16, {paths[-1]}: "
                  f"{ms:.4f} ms (plain {pms:.3f}, "
                  f"torch.quantize_per_channel f32 {lib:.4f}, not "
                  f"bit-identical; a copy of the same bytes "
                  f"{copy_ms:.4f}), bytes bound "
                  f"{bytes_ / HBM_BYTES_PER_S * 1e3:.4f} ms, x{per_step} "
                  f"per decode step; host dispatch {host_ms:.4f} ms per "
                  f"call", flush=True)
            del xf
        del x, s, z, qk, qp
    print(f"  quantize per rwkv6-3b decode step: {step_ms:.3f} ms (before "
          f"the redesign {K2_K11_BEFORE_MS['quantize']:.3f}), bytes bound "
          f"{step_bound:.3f} ms ({step_bound / step_ms:.3f} of it); a "
          f"PyTorch copy of the same bytes (bfloat16 bits into int32) "
          f"{step_copy:.3f} ms ({step_bound / step_copy:.3f} of the bound)")

    # a ragged per-tensor x that starts off a 16-byte boundary: the flat
    # path's head, whole vectors and tail; then a planted fault, the plan
    # with its last vector dropped on an output poisoned past the codes
    for dtype in (torch.float32, bf):
        base, s, z = quantize_operands(torch, gen, dev, (1_000_016,),
                                       "tensor", dtype)
        x = base[3:3 + 1_000_003]
        plan = quantize_plan_for(torch, x, s, z)
        qp = quantize_ref(x, s, z)
        v0 = ops["quantize"].vector_launches
        same = torch.equal(ops["quantize"](x, s, z), qp)
        check(same and plan.path == "flat" and plan.head > 0
              and plan.tail < x.numel()
              and ops["quantize"].vector_launches - v0 == 1,
              f"quantize ragged {x.numel()} elements 3 past a 16-byte "
              f"boundary, {str(dtype)[6:]}: flat path (head {plan.head}, "
              f"{plan.vectors} vectors, tail from {plan.tail}), bitwise "
              f"equal")
        poison = torch.full(x.shape, 1 << 20, dtype=torch.int32, device=dev)
        bad = ops["quantize"](x, s, z, plan=plan.drop_last_vector(),
                              out=poison)
        left = int((bad != qp).sum())
        check(left == plan.vec and not torch.equal(bad, qp),
              f"quantize planted fault, {str(dtype)[6:]}: the plan with its "
              f"last vector dropped leaves {left} codes poisoned and fails "
              f"the bitwise check")
        del base, x, qp, poison, bad

    # -- serve 32 requests through the wave and continuous engines --------
    t0 = time.perf_counter()
    params = T.init_params(0, cfg, device=dev)
    perturb_rwkv(torch, params, gen)
    torch.cuda.synchronize()
    print(f"  random weights from seed 0 (LoRA, bonus, decays and mixes "
          f"drawn) in {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    try:
        E.PagedContinuousServeEngine(params, cfg, slots=b,
                                     max_seq=LM_MAX_SEQ, block_size=LM_BLOCK,
                                     acfg=acfg, device=dev)
        refused = False
    except NotImplementedError:
        refused = True
    check(refused, "the paged engine refuses rwkv (no attention KV to "
                   "page), as the reference's cache does")
    prompts = lm_requests(np, cfg.vocab_size, RWKV_REQUESTS, MOE_SHARED)
    n_gemm = 8 * n_layers + 1
    per_call = {"fused_lut_dense": n_gemm, "quantize": n_gemm,
                "wkv": n_layers}
    engines = {
        "wave": E.ServeEngine(params, cfg, slots=b, max_seq=LM_MAX_SEQ,
                              acfg=acfg, device=dev),
        "continuous": E.ContinuousServeEngine(
            params, cfg, slots=b, max_seq=LM_MAX_SEQ, acfg=acfg,
            device=dev)}
    print(f"  serving {RWKV_REQUESTS} requests, {RWKV_NEW} new tokens each, "
          f"slots={b}:")
    rates = serve_lm(torch, check, E, engines, prompts, RWKV_NEW, cfg, ops,
                     launches, per_call, attention=False)
    del engines

    # -- the card against the CPU, two layers -------------------------------
    cut = dataclasses.replace(cfg, n_layers=RWKV_CPU_LAYERS)
    small = T.init_params(1, cut, device=dev)
    perturb_rwkv(torch, small, gen)
    short = prompts[3][:16]
    on_gpu = E.ContinuousServeEngine(small, cut, slots=1, max_seq=64,
                                     acfg=acfg, device=dev).run(
        [E.Request(prompt=short.copy(), max_new_tokens=4)])
    cpu_small = T.map_cache(lambda t: t.cpu(), small)
    t0 = time.perf_counter()
    on_cpu = E.ContinuousServeEngine(cpu_small, cut, slots=1, max_seq=64,
                                     acfg=acfg, device="cpu").run(
        [E.Request(prompt=short.copy(), max_new_tokens=4)])
    print(f"  full width cut to {RWKV_CPU_LAYERS} layers, one 16-token "
          f"request, 4 new tokens: card {list(on_gpu[0].out)}, CPU "
          f"{list(on_cpu[0].out)} ({time.perf_counter() - t0:.1f} s on the "
          f"CPU)")
    check(list(on_gpu[0].out) == list(on_cpu[0].out),
          f"rwkv6-3b cut to {RWKV_CPU_LAYERS} layers: the same tokens on the "
          f"card and the CPU")
    del small, cpu_small

    # -- profile one decode step; time one layer's weight quantization -----
    rng = np.random.default_rng(17)
    cache = T.init_cache(cfg, b, LM_MAX_SEQ, device=dev)
    for st in cache["groups"]["b0"]["rwkv"]:
        st.normal_(generator=gen)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (b, 1))).to(dev)
    blk = {n: t[0] for n, t in params["groups"]["b0"]["rwkv"].items()}

    def weight_codes():
        for n in ("Wr", "Wk", "Wv", "Wg", "Wo", "Wk_cm", "Wv_cm", "Wr_cm"):
            w = blk[n]
            qp = symmetric_qparams(torch.clamp_min(w.abs().amax(dim=0),
                                                   1e-9), 8, axis=1)
            acu_operand(quantize(w, qp), qp)

    with torch.inference_mode():
        step = lambda: T.apply_model(params, toks, cfg, acfg=acfg,
                                     cache=cache, cache_pos=LM_WAVE_PROMPT,
                                     decode=True)[0].argmax(-1).cpu()
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            step()
        wall = (time.perf_counter() - t0) / 3 * 1e3
        profile(torch, f"rwkv6-3b decode step, {b} rows", step, wall)
        glue = cuda_ms(torch, weight_codes, 5)
        print(f"  weight quantization (amax, scales, codes) of one layer's 8 "
              f"weights: {glue:.3f} ms, x{n_layers} layers = "
              f"{glue * n_layers:.1f} ms of each model call")
    return rates


# kernel 12's backward: held against wkv_bwd_ref at rwkv6-3b's heads for
# these T (B rows each), within WKV_BWD_TOL of each gradient's largest
# entry (the CUDA sums run in another order than the plain version's);
# then rwkv6-3b at full width cut to WKV_TRAIN_LAYERS layers, trained for
# WKV_TRAIN_STEPS AdamW steps at WKV_TRAIN_BATCH x WKV_TRAIN_SEQ tokens
WKV_BWD_CASES = ((2, 1), (2, 255), (2, 256), (1, 1024))
# an NVIDIA H100 80GB HBM3 at 700 W, before the redesign of kernel 12b
# and of kernel 12's sequence path: ms a layer at WKV_TRAIN_BATCH x
# WKV_TRAIN_SEQ (wkv_bwd from this script's run; the forward, with the
# chunk boundaries, from tools/wkv_probe.py)
WKV_BEFORE_MS = {"wkv_bwd": 3.262, "wkv": 0.3503}
WKV_BWD_TOL = 1e-4
# the reduced configs' rwkv_chunk, not a multiple of the sequence kernel's
# 16-step tile (its per-step boundary test), at both head dims: (hd, B, T)
WKV_SHORT_CHUNK = 8
WKV_SHORT_CASES = ((16, 2, 37), (64, 2, 37))
WKV_TRAIN_LAYERS, WKV_TRAIN_STEPS = 2, 3
WKV_TRAIN_BATCH, WKV_TRAIN_SEQ = 4, 512


def wkv_bwd_phase(torch, np, dev, check, acu, ops, launches, account,
                  fma_per_s) -> dict:
    """Kernel 12's backward (``csrc/wkv_bwd.cu``): held against
    ``wkv_bwd_ref`` on the same saved chunk boundaries at rwkv6-3b's 40
    heads of 64, its ``du`` the same bits in two runs, every state it
    restores bitwise the forward's, timed against its plain version and its
    bound (and the forward at 4 x 512 against its own); then rwkv6-3b at
    full width, cut to
    ``WKV_TRAIN_LAYERS`` layers, trained for ``WKV_TRAIN_STEPS`` AdamW steps
    through ``loss_fn`` on the fused ACU with the launch counters set to 0
    just before and read just after: every leaf's gradient finite and
    nonzero (``bonus``, ``lora_B_*`` and ``decay_base`` included). Returns
    the numbers for the summary."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core import ApproxConfig
    from repro_torch.data.pipeline import MarkovLM
    from repro_torch.kernels.wkv.ops import (CHUNK, _forward, wkv_bwd_work,
                                             wkv_work)
    from repro_torch.kernels.wkv.ref import out_bound, wkv_bwd_ref, wkv_ref
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamW
    from repro_torch.tree import leaves_with_names, unflatten

    t_phase = time.perf_counter()
    base = get_config(RWKV_ARCH)
    h, hd = base.rwkv_n_heads, base.rwkv_head_dim
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    out = {}
    print(f"kernel 12's backward (wkv_bwd) against wkv_bwd_ref, {h} heads x "
          f"{hd}, chunks of {CHUNK}, within {WKV_BWD_TOL} of each "
          f"gradient's largest entry:")

    def operands(b, t, hd=hd):
        r, k, v, g = (torch.randn((b, t, h, hd), generator=gen, device=dev)
                      for _ in range(4))
        w = torch.rand((b, t, h, hd), generator=gen, device=dev) * 0.9 + 0.05
        u = torch.randn((h, hd), generator=gen, device=dev) * 0.5
        s0 = torch.randn((b, h, hd, hd), generator=gen, device=dev)
        return r, k, v, w, u, s0, g

    def fold(a):
        return a.transpose(1, 2).reshape(-1, a.shape[1], a.shape[3])

    def rel_errs(got, want):
        return [float((a.double() - b_.double()).abs().max())
                / max(float(b_.abs().max()), 1e-30)
                for a, b_ in zip(got, want)]

    for hd_, b, t in WKV_SHORT_CASES:
        c = WKV_SHORT_CHUNK
        r, k, v, w, u, s0, g = operands(b, t, hd_)
        fo, fs, fb = _forward(r, k, v, w, u, s0, None, c)
        folded = [fold(a) for a in (r, k, v, w)] + [
            u, s0.reshape(b * h, hd_, hd_)]
        po, ps, pb = wkv_ref(*folded, chunk=c)
        fwd_ok = (torch.equal(fs.reshape(b * h, hd_, hd_), ps)
                  and torch.equal(fb, pb) and bool(
                      ((fold(fo) - po).abs() <= out_bound(*folded)).all()))
        got = ops["wkv_bwd"](r, k, v, w, u, fb, g, None, c)
        dr, dk, dv, dw, du, ds0 = wkv_bwd_ref(*folded[:5], fb, fold(g), None,
                                              c)
        unfold = lambda a: a.reshape(b, h, t, hd_).transpose(1, 2)  # noqa
        errs = rel_errs(got, (unfold(dr), unfold(dk), unfold(dv),
                              unfold(dw), du, ds0.reshape(b, h, hd_, hd_)))
        check(fwd_ok and max(errs) <= WKV_BWD_TOL,
              f"chunks of {c} (not a multiple of 16), hd {hd_} B {b} T {t}: "
              f"forward S_T and boundaries bitwise, out within out_bound; "
              f"wkv_bwd within {WKV_BWD_TOL} (worst {max(errs):.2e})")
        del r, k, v, w, u, s0, g, fo, fs, fb, folded, po, ps, pb, got

    for b, t in WKV_BWD_CASES + ((WKV_TRAIN_BATCH, WKV_TRAIN_SEQ),):
        r, k, v, w, u, s0, g = operands(b, t)
        _, _, bounds = _forward(r, k, v, w, u, s0, None, CHUNK)
        kern = lambda: ops["wkv_bwd"](r, k, v, w, u, bounds, g, None)
        got, again = kern(), kern()
        # every state the kernel restores, against the forward's own walk
        # (the plain update on the card, from s0)
        states = torch.empty((b * h, t, hd, hd), device=dev)
        ops["wkv_bwd"](r, k, v, w, u, bounds, g, None, states_out=states)
        walk, same = s0.reshape(b * h, hd, hd), True
        fk, fv, fw = (fold(a) for a in (k, v, w))
        for step in range(t):
            same &= torch.equal(states[:, step], walk)
            walk = fw[:, step, :, None] * walk + fk[:, step, :, None] \
                * fv[:, step, None, :]
        check(bool(same), f"wkv_bwd B {b} T {t}: every state the kernel "
                          f"restores bitwise the forward's")
        del states, walk, fk, fv, fw

        def plain():      # wkv_bwd_ref on the card, in the folded layout
            def unfold(a):
                return a.reshape(b, h, t, hd).transpose(1, 2)
            dr, dk, dv, dw, du, ds0 = wkv_bwd_ref(
                fold(r), fold(k), fold(v), fold(w), u, bounds, fold(g), None,
                CHUNK)
            return (unfold(dr), unfold(dk), unfold(dv), unfold(dw), du,
                    ds0.reshape(b, h, hd, hd))
        want = plain()
        pms = cuda_ms(torch, plain, 1, warm=0)
        errs = rel_errs(got, want)
        ok = all(e <= WKV_BWD_TOL for e in errs) and all(
            bool(torch.isfinite(a).all()) for a in got)
        check(ok and torch.equal(got[4], again[4]),
              f"wkv_bwd B {b} T {t}: dr dk dv dw du ds0 within "
              f"{WKV_BWD_TOL} of the plain version's largest entry (worst "
              f"{max(errs):.2e}), du the same bits in two runs")
        ms = cuda_ms(torch, kern, 3)
        bytes_, flops = wkv_bwd_work(r, k, v, w, u, bounds, g, None)
        bound_ms = max(bytes_ / HBM_BYTES_PER_S, flops / (2 * fma_per_s)) \
            * 1e3
        print(f"    B {b} T {t:4d}: {ms:.3f} ms (plain {pms:.1f} ms), "
              f"bound {bound_ms:.4f} ms "
              f"({bytes_ / 1e6:.1f} MB, {flops / 1e9:.2f} G FP32 FLOPs at "
              f"{2 * fma_per_s / 1e12:.1f} TFLOP/s)")
        if (b, t) == (WKV_TRAIN_BATCH, WKV_TRAIN_SEQ):
            # the JSON row: one training step's layers at this shape
            account("wkv_bwd", WKV_TRAIN_LAYERS, ms, pms, None, bytes_,
                    flops, max(float((a.double() - b_.double()).abs()
                                     .max()) for a, b_ in zip(got, want)),
                    ops_per_s=2 * fma_per_s)
            out["ms"], out["bound_ms"], out["plain_ms"] = ms, bound_ms, pms
            # the forward at the same shape, as training calls it (with
            # the chunk boundaries): its time against its bound
            fwd = lambda: _forward(r, k, v, w, u, s0, None, CHUNK)
            fo, fs, fb = fwd()
            folded = [fold(a) for a in (r, k, v, w)] + [
                u, s0.reshape(b * h, hd, hd)]
            po, ps, pb = wkv_ref(*folded, chunk=CHUNK)
            diff = (fold(fo) - po).abs()
            check(torch.equal(fs.reshape(b * h, hd, hd), ps)
                  and torch.equal(fb, pb) and torch.equal(fb, bounds)
                  and bool((diff <= out_bound(*folded)).all())
                  and bool(torch.isfinite(fo).all()),
                  f"forward wkv B {b} T {t}: S_T and the chunk boundaries "
                  f"bitwise the plain version's, out within out_bound (max "
                  f"|diff| {float(diff.max()):.2e})")
            del fo, fs, fb, folded, po, ps, pb, diff
            fms = cuda_ms(torch, fwd, 5)
            fbytes, fflops = wkv_work(r, k, v, w, u, s0, CHUNK)
            fbound = max(fbytes / HBM_BYTES_PER_S,
                         fflops / (2 * fma_per_s)) * 1e3
            print(f"    forward wkv B {b} T {t} (with the chunk "
                  f"boundaries): {fms:.4f} ms, bound {fbound:.4f} ms "
                  f"({fbytes / 1e6:.1f} MB, {fflops / 1e9:.2f} G FP32 "
                  f"FLOPs), {fbound / fms:.3f} of it")
            out["fwd_ms"], out["fwd_bound_ms"] = fms, fbound
        del r, k, v, w, u, s0, g, bounds, got, again, want
    torch.cuda.empty_cache()

    # -- rwkv6-3b, full width, cut in depth, trained -----------------------
    cfg = dataclasses.replace(base, n_layers=WKV_TRAIN_LAYERS)
    params = T.init_params(0, cfg, device=dev)
    perturb_rwkv(torch, params, gen)
    opt = AdamW(lr=1e-4)
    state = opt.init(params)
    acfg = ApproxConfig(acu=acu)
    lm = MarkovLM(vocab=cfg.vocab_size, seed=0)
    batches = lm.batches(WKV_TRAIN_BATCH, WKV_TRAIN_SEQ)
    named = leaves_with_names(params)
    print(f"  rwkv6-3b at full width cut to {WKV_TRAIN_LAYERS} of "
          f"{base.n_layers} layers ({cfg.dtype}, {MULT} fused ACU, exact "
          f"STE), {WKV_TRAIN_STEPS} AdamW steps at {WKV_TRAIN_BATCH} x "
          f"{WKV_TRAIN_SEQ} tokens:")
    for op in ops.values():
        op.launches = 0
    losses, step_ms, bad = [], [], []
    for step in range(WKV_TRAIN_STEPS):
        bt = next(batches)
        toks = torch.as_tensor(bt["tokens"], device=dev).long()
        labels = torch.as_tensor(bt["labels"], device=dev).long()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        live = [t.detach().requires_grad_(True) for _, t in named]
        ptree = unflatten(params, live)
        loss = T.loss_fn(ptree, toks, labels, cfg, acfg)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        for (name, _), gr in zip(named, grads):
            if gr is None or not bool(torch.isfinite(gr).all()) \
                    or not bool(gr.abs().max() > 0):
                bad.append(f"step {step} {name}")
        params, state = opt.update(unflatten(params, [
            torch.zeros_like(p) if gr is None else gr
            for p, gr in zip(live, grads)]), state, params)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss.detach()))
        named = leaves_with_names(params)
    counts = {k: op.launches for k, op in ops.items()}
    for k in ("wkv", "wkv_bwd"):
        launches[k] += counts[k]
    want_n = WKV_TRAIN_LAYERS * WKV_TRAIN_STEPS
    rwkv_names = [n for n, _ in named if "rwkv" in n]
    check(not bad and all(np.isfinite(losses)),
          f"every leaf's gradient finite and nonzero in every step "
          f"({len(named)} leaves, {len(rwkv_names)} of them rwkv leaves "
          f"with bonus, lora_B_* and decay_base); losses "
          + ", ".join(f"{x:.4f}" for x in losses)
          + (f"; bad: {bad[:6]}" if bad else ""))
    check(counts["wkv_bwd"] == want_n and counts["wkv"] == want_n,
          f"launches in the {WKV_TRAIN_STEPS} steps: wkv {counts['wkv']}, "
          f"wkv_bwd {counts['wkv_bwd']} (one each a layer a step: "
          f"{want_n})")
    print(f"  step times (ms): " + ", ".join(f"{x:.1f}" for x in step_ms)
          + f"; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB")
    out.update(losses=losses, step_ms=step_ms,
               seconds=time.perf_counter() - t_phase)
    del params, state, grads, live, ptree
    torch.cuda.empty_cache()
    return out


# the mesh phase: two ranks on the one card over gloo (NCCL refuses two
# ranks on one device), every wrap at a main-path shape bitwise against
# the one-rank call, SmolLM-135M data-parallel training (global batch
# MESH_DP_BATCH x TRAIN_LM_SEQ, MESH_DP_STEPS steps) against a one-process
# oracle and across a restart, and two engines under the mesh
MESH_RANKS = 2
MESH_DP_BATCH, MESH_DP_STEPS = 8, 3
MESH_LM_REQUESTS, MESH_LM_NEW = 8, 8
MESH_GRANITE_CAP = 16     # capacity rows per expert of the grouped GEMM


def mesh_rank_body(ckpt_root: str) -> dict:
    """One rank of ``mesh_phase``: every case run on the same global
    operands, twice: through the mesh (``use_mesh`` or ``mesh=``) and as
    the one-rank call, held bitwise. Returns, per case, whether the two
    agree and its seconds; the data-parallel run's numbers; the launch
    counts of kernel 10's ``emit_acc`` output and kernel 7's ``rmask``."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import (ApproxConfig, approx_dense, attn_plan,
                                  conv2d, make_acu, symmetric_qparams)
    from repro_torch.core.acu import AttnSpec
    from repro_torch.core.approx_ops import (approx_grouped_dense,
                                             approx_matmul)
    from repro_torch.data.pipeline import MarkovLM, shard_batch
    from repro_torch.kernels.fused_lut_conv.ops import fused_lut_conv_bwd_w
    from repro_torch.kernels.fused_lut_grouped.ops import fused_lut_grouped
    from repro_torch.launch.mesh import make_host_multi_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.vision import init_resnet, resnet_forward
    from repro_torch.optim.adamw import AdamW
    from repro_torch.optim.compression import compress, decompress
    from repro_torch.parallel.sharding import use_mesh
    from repro_torch.serve import engine as E
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import leaves, unflatten

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = make_host_multi_mesh((MESH_RANKS, 1))    # data 2: rows, batch
    cols = make_host_multi_mesh((1, MESH_RANKS))    # model 2: columns, K
    gen = torch.Generator(device=dev)
    gen.manual_seed(41)
    acu = make_acu(MULT, "lut", use_kernels=True, fused=True)
    biased = dataclasses.replace(make_acu("mul8s_exact", "lut",
                                          use_kernels=True, fused=True),
                                 lut=biased_lut(np).reshape(256, 256),
                                 _tables={})
    cfg_f = ApproxConfig(acu=acu)
    res: dict = {"cases": {}}

    def case(name, run, mesh, rules=None):
        """``run()`` as one rank, then under the mesh; bitwise."""
        torch.cuda.synchronize()
        local = run()
        t0 = time.perf_counter()
        c0 = (mesh.collective_s, mesh.collective_calls)
        with use_mesh(mesh, rules):
            out = run()
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(
            out if isinstance(out, (list, tuple)) else [out],
            local if isinstance(local, (list, tuple)) else [local]))
        res["cases"][name] = (same, time.perf_counter() - t0,
                              mesh.collective_s - c0[0],
                              mesh.collective_calls - c0[1])

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    # -- kernel 3 at SmolLM-135M's GEMMs, rows over data; K over model ----
    lm = get_config(LM_ARCH)
    dm, ff = lm.d_model, lm.d_ff
    kvd = lm.n_kv_heads * lm.head_dim
    M = MESH_DP_BATCH * TRAIN_LM_SEQ
    for kk, nn in ((dm, dm), (dm, kvd), (dm, ff), (ff, dm)):
        x, w = rnd(M, kk), rnd(kk, nn)
        case(f"kernel 3 dense {M}x{kk}x{nn}, rows over data",
             lambda: approx_dense(x, w, None, cfg_f), rows)
    x, w = rnd(M, dm - 1), rnd(dm - 1, dm)
    case(f"kernel 3 dense {M}x{dm - 1}x{dm}, K over model (pads 1), biased "
         f"table", lambda: approx_dense(x, w, None, ApproxConfig(acu=biased)),
         cols, {"acu_k": ("model",), "acu_cols": ()})

    # -- kernel 4: an approx_bwd step's dense gradients ---------------------
    x, w = rnd(M, dm), rnd(dm, ff)
    xqp = symmetric_qparams(torch.max(torch.abs(x)), 8)
    wqp = symmetric_qparams(torch.clamp_min(torch.abs(w).amax(0), 1e-9), 8,
                            axis=1)
    gscale = rnd(ff)
    cfg_b = ApproxConfig(acu=acu, approx_bwd=True)

    def k4():
        xs, ws = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        (approx_matmul(xs, ws, cfg_b, xqp, wqp) * gscale).sum().backward()
        return [xs.grad, ws.grad]
    case(f"kernel 4 approx_bwd gradients {M}x{dm}x{ff} (gx over the cols "
         f"axes, gw contracted over data)", k4, rows)

    # -- kernel 10 at granite-moe-3b-a800m's expert GEMMs, experts over model
    gr = get_config(MOE_ARCH)
    ne, gd, gf, cap = gr.n_experts, gr.d_model, gr.d_ff, MESH_GRANITE_CAP
    counts = torch.randint(0, cap + 1, (ne,), generator=gen,
                           device=dev).to(torch.int32)
    live = torch.arange(cap, device=dev)[None, :] < counts[:, None]
    xe = rnd(ne, cap, gd) * live[..., None]
    we = rnd(ne, gd, gf)

    def k10(acfg):
        return lambda: approx_grouped_dense(xe, we, acfg, counts)
    case(f"kernel 10 grouped ({ne} experts, {cap} rows, {gd} -> {gf}), "
         f"experts over model", k10(cfg_f), cols)
    n0 = fused_lut_grouped.launches
    case(f"kernel 10 grouped, K over model (emit_acc), biased table",
         k10(ApproxConfig(acu=biased)), cols,
         {"acu_grouped_k": ("model",), "acu_grouped_experts": ()})
    # the one-rank call launches once, the mesh call once a rank
    res["emit_acc_launches"] = fused_lut_grouped.launches - n0 - 1

    # -- kernels 8 and 9 at SmolLM's decode, batch rows over data -----------
    b, hq, hkv, d, sk = LM_SLOTS, lm.n_heads, lm.n_kv_heads, lm.head_dim, 512
    q, k, v = rnd(b, hq, 1, d), rnd(b, hkv, sk, d), rnd(b, hkv, sk, d)
    sc = [torch.abs(t).max() / 127.0 for t in (q, k, v)]
    lens = torch.randint(1, sk + 1, (b,), generator=gen, device=dev)
    info = torch.stack([lens - 1, torch.zeros_like(lens), lens], 1).to(
        torch.int32)
    spec = AttnSpec(hq=hq, hkv=hkv)
    case(f"kernel 8 decode (B {b}, {hq} heads over {hkv}, Sk {sk}), rows "
         f"over data", lambda: attn_plan(acu, spec)(q, k, v, *sc, info), rows)
    bk, n_log = LM_BLOCK, sk // LM_BLOCK
    n_phys = 1 + b * n_log
    kp, vp = rnd(hkv, n_phys, bk, d), rnd(hkv, n_phys, bk, d)
    pt = (1 + torch.randperm(b * n_log, generator=gen, device=dev)
          ).reshape(b, n_log).to(torch.int32)
    pspec = AttnSpec(hq=hq, hkv=hkv, bk=bk, kv_layout="paged")
    case(f"kernel 9 paged decode (B {b}, pool of {n_phys} blocks of {bk}), "
         f"rows over data",
         lambda: attn_plan(acu, pspec)(q, kp, vp, *sc, info, pt), rows)

    # -- kernels 5, 6, 7: ResNet-20's convs and the 224^2 tiled geometry -----
    for name, cin, hw, cout, kk, st, pad, _ in CONVS:
        xc, wc = rnd(BATCH, cin, hw, hw), rnd(cout, cin, kk, kk)
        case(f"kernel 5 conv ResNet-20 {name} (wave of {BATCH}), rows over "
             f"data", lambda: conv2d(xc, wc, None, stride=(st, st),
                                     padding=pad, cfg=cfg_f), rows)
    n7 = fused_lut_conv_bwd_w.rmask_launches
    for label, xs_, ws_ in (("ResNet-20 stage0", (BATCH, 16, 32, 32),
                             (16, 16, 3, 3)),
                            ("1x64x224x224 tiled", (1, 64, 224, 224),
                             (64, 64, 3, 3))):
        xc, wc = rnd(*xs_), rnd(*ws_)
        if xs_[0] == 1:
            case(f"kernel 6 conv {label}, two halo'd output-row bands over "
                 f"data", lambda: conv2d(xc, wc, None, cfg=cfg_f), rows)
        bx = (TRAIN_BATCH, *xs_[1:]) if xs_[0] > 1 else xs_
        xb, gb = rnd(*bx), None

        def k7():
            xs, ws = xb.clone().requires_grad_(True), \
                wc.clone().requires_grad_(True)
            y = conv2d(xs, ws, None, cfg=ApproxConfig(acu=acu,
                                                      approx_bwd=True))
            y.backward(torch.ones_like(y) * 1e-2 + y.detach() * 1e-3)
            return [xs.grad, ws.grad]
        case(f"kernel 7 + 4 approx_bwd conv gradients {label} "
             f"(batch {bx[0]}), rows over data", k7, rows)
    res["rmask_launches"] = fused_lut_conv_bwd_w.rmask_launches - n7
    torch.cuda.empty_cache()

    # -- SmolLM-135M data-parallel training, full width, depth and vocab ---
    cfg = lm
    p0 = T.init_params(0, cfg, device=dev)
    acfg = ApproxConfig(acu=acu)

    def loss_fn(p, bt):
        return T.loss_fn(p, bt["tokens"], bt["labels"], cfg, acfg)

    def data():
        return (shard_batch(bt, rows, device=dev) for bt in
                MarkovLM(vocab=cfg.vocab_size, seed=0).batches(
                    MESH_DP_BATCH, TRAIN_LM_SEQ))

    def fit(tag, n_steps):
        p = unflatten(p0, [t.clone() for t in leaves(p0)])
        opt = AdamW(lr=3e-4, weight_decay=0.01)
        tr = Trainer(loss_fn, opt, TrainerConfig(
            mesh=rows, ckpt_dir=os.path.join(ckpt_root, tag), ckpt_every=2,
            async_ckpt=False, log_every=1))
        c0 = rows.collective_s
        t0 = time.perf_counter()
        p, o = tr.fit(p, opt.init(p), data(), n_steps)
        torch.cuda.synchronize()
        return p, o, tr, time.perf_counter() - t0, rows.collective_s - c0

    pa, oa, tra, wall_a, coll_a = fit("full", MESH_DP_STEPS)
    res["dp_step_s"] = [h["dt"] for h in tra.history if "dt" in h]
    res["dp_losses"] = [h["loss"] for h in tra.history if "loss" in h]
    res["dp_wall_s"], res["dp_collective_s"] = wall_a, coll_a
    res["dp_params"] = sum(t.numel() for t in leaves(p0))
    fit("cut", MESH_DP_STEPS - 1)
    pc, oc, trc, _, _ = fit("cut", MESH_DP_STEPS)   # resumes at the cut
    res["dp_restart_equal"] = (
        all(torch.equal(a, b) for a, b in zip(leaves((pa, oa)),
                                              leaves((pc, oc))))
        and all(torch.equal(a, b) for a, b in zip(leaves(tra._ef_resid),
                                                  leaves(trc._ef_resid))))
    res["dp_resid_nonzero"] = any(bool(r.abs().max() > 0)
                                  for r in leaves(tra._ef_resid))
    if rows.rank == 0:
        # the one-process oracle: per-shard gradients, the shared amax,
        # the int32 sum x scale / W, the same AdamW
        p = unflatten(p0, [t.clone() for t in leaves(p0)])
        opt = AdamW(lr=3e-4, weight_decay=0.01)
        st = opt.init(p)
        resid = [[torch.zeros(t.shape, dtype=torch.float32, device=dev)
                  for t in leaves(p0)] for _ in range(MESH_RANKS)]
        n_w = torch.tensor(float(MESH_RANKS), device=dev)
        rows_per = MESH_DP_BATCH // MESH_RANKS
        for _, bt in zip(range(MESH_DP_STEPS), data()):
            per = []
            for i in range(MESH_RANKS):
                live = [t.detach().requires_grad_(True) for t in leaves(p)]
                shard = {kk: vv[i * rows_per:(i + 1) * rows_per]
                         for kk, vv in bt.items()}
                gs = torch.autograd.grad(loss_fn(unflatten(p, live), shard),
                                         live, allow_unused=True)
                per.append([torch.zeros_like(t) if gg is None else gg
                            for t, gg in zip(live, gs)])
            mean = []
            for li in range(len(per[0])):
                g_in = [per[i][li].to(torch.float32) + resid[i][li]
                        for i in range(MESH_RANKS)]
                amax = torch.max(torch.stack([g.abs().max() for g in g_in]))
                coded = [compress(g, amax) for g in g_in]
                for i in range(MESH_RANKS):
                    resid[i][li] = g_in[i] - decompress(*coded[i])
                q_sum = sum(c[0].to(torch.int32) for c in coded)
                mean.append(q_sum.to(torch.float32) * (coded[0][1] / n_w))
            p, st = opt.update(unflatten(p, mean), st, p)
        res["dp_oracle_equal"] = all(
            torch.equal(a, b) for a, b in zip(leaves((pa, oa)),
                                              leaves((p, st))))
        del p, st, per, resid, mean
    del pa, oa, pc, oc, tra, trc
    rows.barrier()
    torch.cuda.empty_cache()

    # -- engines under the mesh ------------------------------------------
    params = T.init_params(0, lm, device=dev)
    prompts = [np.random.default_rng(i).integers(
        1, lm.vocab_size, 24 + 8 * i).astype(np.int32)
        for i in range(MESH_LM_REQUESTS)]

    def serve(mesh):
        eng = E.ContinuousServeEngine(params, lm, slots=MESH_LM_REQUESTS,
                                      max_seq=256, acfg=acfg, device=dev,
                                      mesh=mesh)
        reqs = [E.Request(prompt=pr, max_new_tokens=MESH_LM_NEW)
                for pr in prompts]
        eng.run(reqs)
        return [r.out for r in reqs]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one = serve(None)
    t1 = time.perf_counter()
    c0 = cols.collective_s
    meshed = serve(cols)
    torch.cuda.synchronize()
    res["lm_tokens_equal"] = all(np.array_equal(a, b)
                                 for a, b in zip(one, meshed))
    res["lm_s"] = (t1 - t0, time.perf_counter() - t1,
                   cols.collective_s - c0)
    del params
    rp = init_resnet(0, device=dev)
    imgs = np.random.default_rng(3).normal(
        size=(BATCH, 3, 32, 32)).astype(np.float32)
    one = E.VisionServeEngine(rp, resnet_forward, slots=BATCH, acfg=cfg_f,
                              device=dev).run(imgs)
    t0 = time.perf_counter()
    meshed = E.VisionServeEngine(rp, resnet_forward, slots=BATCH, acfg=cfg_f,
                                 device=dev, mesh=rows).run(imgs)
    res["vision_equal"] = bool(np.array_equal(one, meshed))
    res["vision_s"] = time.perf_counter() - t0
    res["collective_s"] = rows.collective_s + cols.collective_s
    return res


def mesh_phase(torch, np, check) -> dict:
    """Two ranks on the one card (``launch/mesh.py: spawn_ranks``, gloo
    over the host): every ACU wrap at a main-path shape bitwise against
    the one-rank call, SmolLM-135M data-parallel training bitwise against
    a one-process oracle and across a restart with its EF residual, and
    the continuous LM engine and the vision engine under the mesh. The
    kernels were built before the ranks start; a rank that fails fails the
    phase."""
    import shutil
    import tempfile
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.configs import get_config
    from repro_torch.kernels import runtime
    from repro_torch.kernels.fused_lut_conv.ops import fused_lut_conv_bwd_w
    from repro_torch.kernels.fused_lut_conv.ref import (
        fused_lut_conv_bwd_w_ref)
    from repro_torch.kernels.fused_lut_grouped.ops import fused_lut_grouped
    from repro_torch.kernels.fused_lut_grouped.ref import (
        fused_lut_grouped_ref)
    t_phase = time.perf_counter()
    print(f"mesh phase: {MESH_RANKS} ranks on the one card over gloo (NCCL "
          f"refuses two ranks on one device), the global operands on every "
          f"rank; first what the wraps add to kernels 7 and 10, against the "
          f"plain versions on the card:")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(43)
    # on the biased table a masked row or a dead row would show
    lut = torch.from_numpy(biased_lut(np)).to(dev)
    lut16 = runtime.lut_to_int16(lut)
    x = torch.randn((TRAIN_BATCH, 16, 32, 32), generator=gen, device=dev)
    g = torch.randn((TRAIN_BATCH, 32, 32, 16), generator=gen, device=dev)
    rm = torch.ones((TRAIN_BATCH, 32), dtype=torch.int32, device=dev)
    rm[: TRAIN_BATCH // 2, 20:] = 0          # a dead band of output rows
    rm[-1] = 0                                # a padded image
    kw = dict(ksize=(3, 3), padding=((1, 1), (1, 1)))
    sx, sg = (torch.abs(t).max() / 127.0 for t in (x, g))
    got = fused_lut_conv_bwd_w(x, g, lut16, 128, sx, sg, rmask=rm, **kw)
    want = fused_lut_conv_bwd_w_ref(x, g, lut, 128, 256, sx, sg, rmask=rm,
                                    **kw)
    full = fused_lut_conv_bwd_w(x, g, lut16, 128, sx, sg, **kw)
    check(torch.equal(got, want) and not torch.equal(got, full),
          f"kernel 7 with rmask (a dead band, a padded image; batch "
          f"{TRAIN_BATCH} x 16 x 32 x 32, biased table) bitwise equal to its "
          f"plain version, and not to the unmasked sum")
    gr = get_config(MOE_ARCH)
    ne, cap = gr.n_experts, MESH_GRANITE_CAP
    xe = torch.randn((ne, cap, gr.d_model), generator=gen, device=dev)
    wq = torch.randint(-127, 128, (ne, gr.d_model, gr.d_ff), generator=gen,
                       device=dev, dtype=torch.int32)
    ws = torch.rand((ne, gr.d_ff), generator=gen, device=dev) * 1e-2
    counts = torch.randint(0, cap + 1, (ne,), generator=gen,
                           device=dev).to(torch.int32)
    xs = torch.abs(xe).max() / 127.0
    got = fused_lut_grouped(xe, wq, lut16, 128, xs, 0.0, ws, counts,
                            emit_acc=True)
    want = fused_lut_grouped_ref(xe, wq, lut, 128, 256, xs, 0.0, ws, counts,
                                 emit_acc=True)
    check(got.dtype == torch.int32 and torch.equal(got, want),
          f"kernel 10's emit_acc output ({ne} experts, {cap} rows, "
          f"{gr.d_model} -> {gr.d_ff}, biased table, dead rows) bitwise "
          f"equal to its plain version")
    del x, g, xe, wq, got, want, full
    root = tempfile.mkdtemp(prefix="mesh_ckpt_")
    print("  then each case under the mesh against the one-rank call, "
          "bitwise:")
    try:
        results = spawn_ranks(mesh_rank_body, MESH_RANKS, args=(root,),
                              backend="gloo", device="cuda:0", threads=4,
                              timeout=600)
    except RuntimeError as e:
        check(False, f"mesh phase: a rank failed: {str(e)[-3000:]}")
        return {"seconds": time.perf_counter() - t_phase}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    r0 = results[0]
    for name in r0["cases"]:
        sames = [r["cases"][name][0] for r in results]
        _, secs, coll_s, coll_n = r0["cases"][name]
        check(all(sames), f"{name}: bitwise equal to the one-rank call on "
                          f"every rank ({secs:.2f} s under the mesh, "
                          f"{coll_s:.2f} s of it in {coll_n} collectives)")
    check(r0["rmask_launches"] > 0 and all(
        r["emit_acc_launches"] > 0 for r in results),
        f"kernel 7 launched with rmask {r0['rmask_launches']}x and kernel "
        f"10's emit_acc output {r0['emit_acc_launches']}x by rank 0")
    check(r0["dp_oracle_equal"],
          f"SmolLM-135M data-parallel training (full width, depth and "
          f"vocabulary, {r0['dp_params'] / 1e6:.1f} M parameters; "
          f"{MESH_DP_STEPS} steps, global batch {MESH_DP_BATCH} x "
          f"{TRAIN_LM_SEQ}, "
          f"{MESH_DP_BATCH // MESH_RANKS} rows a rank, exact STE on the "
          f"fused ACU): parameters and AdamW state bitwise equal to the "
          f"one-process oracle")
    check(all(r["dp_restart_equal"] and r["dp_resid_nonzero"]
              for r in results),
          "a restart from the step-2 checkpoint (EF residual included, "
          "nonzero) ends bitwise equal to the run without it, on every rank")
    check(all(r["dp_losses"] == r0["dp_losses"] for r in results)
          and all(np.isfinite(r0["dp_losses"])),
          "the ranks report the same finite losses: " + ", ".join(
              f"{x:.4f}" for x in r0["dp_losses"]))
    check(all(r["lm_tokens_equal"] for r in results),
          f"SmolLM-135M continuous engine, {MESH_LM_REQUESTS} requests, "
          f"columns over model: tokens equal to the one-rank engine's "
          f"({r0['lm_s'][0]:.2f} s one rank, {r0['lm_s'][1]:.2f} s under "
          f"the mesh, {r0['lm_s'][2]:.2f} s of it in collectives)")
    check(all(r["vision_equal"] for r in results),
          f"ResNet-20 VisionServeEngine, one wave of {BATCH}, rows over "
          f"data: logits bitwise equal to the one-rank engine's "
          f"({r0['vision_s']:.2f} s under the mesh)")
    steps = r0["dp_step_s"]
    share = r0["dp_collective_s"] / r0["dp_wall_s"] if r0["dp_wall_s"] \
        else float("nan")
    print(f"  data-parallel step times (s, rank 0): "
          + ", ".join(f"{x:.3f}" for x in steps)
          + f"; {r0['dp_collective_s']:.2f} s of the run's "
          f"{r0['dp_wall_s']:.2f} s in collectives (share {share:.3f}; gloo "
          f"on one card goes through the host and says nothing of NVLink)")
    out = dict(step_s=steps, collective_share=share,
               rmask_launches=r0["rmask_launches"],
               emit_acc_launches=r0["emit_acc_launches"],
               seconds=time.perf_counter() - t_phase)
    return out


def count_launches(ops, fn):
    """``fn()``'s result and the launches it made, by kernel, with every
    counter set to 0 just before the call and read just after."""
    for op in ops.values():
        op.launches = 0
        if hasattr(op, "decode_launches"):
            op.decode_launches = 0
    out = fn()
    return out, {k: op.launches for k, op in ops.items()}


def whisper_phase(torch, np, dev, check, acu, ops, launches,
                  redesign: dict) -> dict:
    """whisper-small at full width and depth on the fused ACU: kernel 8's
    decode path at its self-attention, then the encoder over WHISPER_ROWS
    x 1500 stub frames and a greedy decode (a WHISPER_PROMPT-token prefill
    into the cache, then WHISPER_NEW steps), each call's launches checked
    against the code's (no kernel 8 for cross-attention); the per-step
    recomputation of the cross K and V timed; the card against the CPU on
    a 2 + 2-layer cut (float32 logits without the ACU at the full 1500
    frames, with planted CPU faults beyond the tolerance; greedy tokens on
    the fused ACU at 64 frames). Returns the phase's figures."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core import ApproxConfig
    from repro_torch.core.approx_ops import approx_dense
    from repro_torch.models import layers as L
    from repro_torch.models import whisper as W
    from repro_torch.models.transformer import _at, map_cache
    from repro_torch.tree import leaves

    cfg = get_config(WHISPER_ARCH)
    n_enc, n_dec, d = cfg.n_enc_layers, cfg.n_layers, cfg.d_model
    rows, t_enc = WHISPER_ROWS, cfg.enc_ctx
    acfg = ApproxConfig(acu=acu)
    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    print(f"whisper-small ({n_enc} + {n_dec} layers, d {d}, {cfg.n_heads} "
          f"heads over {cfg.n_kv_heads}, head_dim {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_padded}, {t_enc} frames, "
          f"{cfg.dtype}), {MULT} fused ACU:")
    t0 = time.perf_counter()
    params = W.init_params(0, cfg, device=dev)
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in leaves(params))
    print(f"  random weights from seed 0 in {time.perf_counter() - t0:.2f} s"
          f", {n_par / 1e6:.1f} M parameters, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")

    # -- kernel 8's decode path at whisper's self-attention ---------------
    redesign["kernel 8 " + cfg.name] = hold_decode_path(
        torch, np, dev, check, acu, ops, cfg, 20)

    # -- encode, prefill, greedy decode, launches per call ----------------
    frames = torch.randn((rows, t_enc, d), generator=gen,
                         device=dev).to(cfg.param_dtype)
    rng = np.random.default_rng(19)
    prompt = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (rows, WHISPER_PROMPT))).to(dev)
    max_seq = WHISPER_MAX_SEQ
    per_dec = {"fused_lut_dense": 10 * n_dec + 1, "quantize": 10 * n_dec + 1,
               "approx_flash_attention": n_dec}
    per_enc = {"fused_lut_dense": 6 * n_enc, "quantize": 6 * n_enc}
    with torch.inference_mode():
        W.encode(params, frames[:1, :256], cfg, acfg)      # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc, counts = count_launches(ops, lambda: W.encode(params, frames,
                                                           cfg, acfg))
        torch.cuda.synchronize()
        enc_ms = (time.perf_counter() - t0) * 1e3
        want = {k: per_enc.get(k, 0) for k in ops}
        check(counts == want and torch.isfinite(enc).all(),
              f"encode, {rows} x {t_enc} frames: {enc_ms:.1f} ms, launches "
              f"{ {k: v for k, v in counts.items() if v} } = {per_enc}, "
              f"finite")
        for k in ops:
            launches[k] += counts[k]
        cache = W.init_cache(cfg, rows, max_seq, device=dev)
        out, calls, dec_calls = [], 0, 0
        tally = {k: 0 for k in ops}
        decode_path = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (logits, _), c = count_launches(ops, lambda: W.decode(
            params, prompt, enc, cfg, acfg=acfg, cache=cache, cache_pos=0,
            last_only=True))
        cur = logits[:, -1].argmax(-1)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        calls += 1
        for k in ops:
            tally[k] += c[k]
        steps = []
        for t in range(WHISPER_NEW):
            out.append(cur.cpu().numpy())
            t1 = time.perf_counter()
            (logits, _), c = count_launches(ops, lambda: W.decode(
                params, cur[:, None], enc, cfg, acfg=acfg, cache=cache,
                cache_pos=WHISPER_PROMPT + t))
            cur = logits[:, -1].argmax(-1)
            decode_path += ops["approx_flash_attention"].decode_launches
            cur.cpu()
            steps.append((time.perf_counter() - t1) * 1e3)
            calls += 1
            dec_calls += 1
            for k in ops:
                tally[k] += c[k]
        wall = (time.perf_counter() - t0) * 1e3
    toks = np.stack(out, 1)
    want = {k: per_dec.get(k, 0) * calls for k in ops}
    check(tally == want,
          f"decode: launches {({k: v for k, v in tally.items() if v})} = "
          f"{per_dec} per call x {calls} calls (the prefill and "
          f"{dec_calls} steps): kernel 8 for the {n_dec} cached "
          f"self-attentions only, none for cross-attention")
    check(decode_path == n_dec * dec_calls,
          f"decode: {decode_path} of kernel 8's launches on its decode path "
          f"= {n_dec} per step x {dec_calls} steps")
    check(toks.shape == (rows, WHISPER_NEW) and bool(
        ((toks >= 0) & (toks < cfg.vocab_padded)).all()),
          f"greedy decode: {rows} x {WHISPER_NEW} tokens in the vocab")
    for k in ops:
        launches[k] += tally[k]
    step_ms = float(np.median(steps))
    rate = rows * WHISPER_NEW / (wall / 1e3)
    print(f"  encode {enc_ms:.1f} ms; prefill of {WHISPER_PROMPT} tokens "
          f"{prefill_ms:.1f} ms; decode {step_ms:.2f} ms per step (median "
          f"of {WHISPER_NEW}), {rate:.1f} tokens/s over the prefill and "
          f"{WHISPER_NEW} steps of {rows} rows ({wall:.0f} ms)")

    # -- the cross K/V recomputed on every decode call ---------------------
    def cross_kv():
        for li in range(n_dec):
            p = _at(params["dec"]["cross_attn"], li)
            approx_dense(enc, p["wk"], None, acfg)
            approx_dense(enc, p["wv"], None, acfg)

    with torch.inference_mode():
        cross_ms = cuda_ms(torch, cross_kv, 3)
        step = lambda: W.decode(params, cur[:, None], enc, cfg, acfg=acfg,
                                cache=cache, cache_pos=max_seq - 1
                                )[0].argmax(-1).cpu()
        _, _, prof_rows = profile(torch, f"whisper-small decode step, "
                                         f"{rows} rows", step, step_ms)
    print(f"  cross-attention K and V of {n_dec} layers ({2 * n_dec} GEMMs "
          f"of {rows * t_enc} x {d} x {d}), recomputed on every decode "
          f"call: {cross_ms:.2f} ms of the {step_ms:.2f} ms step")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  peak memory {peak:.2f} GiB")
    del params, enc, cache, frames
    torch.cuda.empty_cache()

    # -- the card against the CPU, 2 + 2 layers ----------------------------
    cut = dataclasses.replace(cfg, n_layers=WHISPER_CPU_LAYERS,
                              n_enc_layers=WHISPER_CPU_LAYERS,
                              dtype="float32")
    small = W.init_params(1, cut, device=dev)
    cpu_small = map_cache(lambda t: t.cpu(), small)
    fr = torch.randn((2, t_enc, d), generator=gen, device=dev)
    tk = torch.from_numpy(rng.integers(1, cfg.vocab_size, (2, 9))).to(dev)

    def run(p, f, t, device):
        """Encode, an 8-token prefill and one step (no ACU); the prefill's
        and the step's logits."""
        with torch.inference_mode():
            e = W.encode(p, f, cut)
            c = W.init_cache(cut, 2, 16, device=device)
            a, _ = W.decode(p, t[:, :8], e, cut, cache=c, cache_pos=0)
            b, _ = W.decode(p, t[:, 8:], e, cut, cache=c, cache_pos=8)
        return torch.cat([a, b], 1)

    on_gpu = run(small, fr, tk, dev).cpu()
    t0 = time.perf_counter()
    on_cpu = run(cpu_small, fr.cpu(), tk.cpu(), "cpu")
    cpu_s = time.perf_counter() - t0
    scale = float(on_cpu.abs().max())
    err = float((on_gpu - on_cpu).abs().max()) / scale
    check(err <= SCORE_CPU_TOL,
          f"whisper-small cut to {WHISPER_CPU_LAYERS} + "
          f"{WHISPER_CPU_LAYERS} layers, float32, no ACU, {t_enc} frames: "
          f"card logits within {err:.2e} of the CPU's (tolerance "
          f"{SCORE_CPU_TOL:.0e} of the largest |logit| {scale:.2f}; "
          f"{cpu_s:.1f} s on the CPU)")
    exact = L.gqa_attention

    def causal_cross(q, k, v, **kw):
        if q.shape[1] != k.shape[1]:
            kw["causal"] = True
        return exact(q, k, v, **kw)

    shifted = dict(cpu_small, dec_pos=torch.roll(cpu_small["dec_pos"], 1, 0))
    faults = {"learned positions shifted by one": (shifted, None),
              "cross-attention made causal": (cpu_small, causal_cross)}
    for label, (p, attn) in faults.items():
        if attn is not None:
            L.gqa_attention = attn
        try:
            bad = run(p, fr.cpu(), tk.cpu(), "cpu")
        finally:
            L.gqa_attention = exact
        ferr = float((on_gpu - bad).abs().max()) / scale
        check(ferr > SCORE_CPU_TOL,
              f"planted CPU fault ({label}): {ferr:.2e} from the card, "
              f"beyond the tolerance")
    del small, cpu_small

    cut64 = dataclasses.replace(cfg, n_layers=WHISPER_CPU_LAYERS,
                                n_enc_layers=WHISPER_CPU_LAYERS,
                                enc_ctx=WHISPER_CPU_CTX)
    small = W.init_params(2, cut64, device=dev)
    cpu_small = map_cache(lambda t: t.cpu(), small)
    fr = torch.randn((1, WHISPER_CPU_CTX, d), generator=gen,
                     device=dev).to(cut64.param_dtype)
    tk = torch.from_numpy(rng.integers(1, cfg.vocab_size, (1, 4))).to(dev)

    def greedy(p, f, t, device, n=4):
        with torch.inference_mode():
            e = W.encode(p, f, cut64, acfg)
            c = W.init_cache(cut64, 1, 16, device=device)
            lg, _ = W.decode(p, t, e, cut64, acfg=acfg, cache=c,
                             last_only=True)
            got = []
            for i in range(n):
                nxt = lg[:, -1].argmax(-1)
                got.append(int(nxt[0]))
                lg, _ = W.decode(p, nxt[:, None], e, cut64, acfg=acfg,
                                 cache=c, cache_pos=t.shape[1] + i)
        return got

    g_tok = greedy(small, fr, tk, dev)
    t0 = time.perf_counter()
    c_tok = greedy(cpu_small, fr.cpu(), tk.cpu(), "cpu")
    check(g_tok == c_tok,
          f"whisper-small cut to {WHISPER_CPU_LAYERS} + {WHISPER_CPU_LAYERS} "
          f"layers, {WHISPER_CPU_CTX} frames, bf16, fused ACU: greedy tokens "
          f"card {g_tok}, CPU {c_tok} ({time.perf_counter() - t0:.1f} s on "
          f"the CPU)")
    del small, cpu_small
    torch.cuda.empty_cache()
    return {"encode_ms": enc_ms, "step_ms": step_ms, "tokens_per_s": rate,
            "peak_gib": peak, "cross_kv_ms": cross_ms, "n_params": n_par}


def jamba_phase(torch, np, dev, check, acu, ops, launches,
                lookups_per_s, redesign: dict) -> dict:
    """jamba-v0.1-52b at full width, depth cut to one period of its pattern
    (JAMBA_LAYERS: 3 mamba, 4 mamba_moe, 1 attn), on the fused ACU: kernel
    2 bitwise at jamba's weight shapes (the expert stacks included); kernel
    10 at the decode and prefill expert shapes (plan printed; the expert
    codes bitwise; the output bitwise against its plain version on the
    first and last JAMBA_COLS columns, the plain version being too slow
    for all 14,336); kernels 2 and 3 at every dense GEMM shape at the
    decode and prefill rows (the model's codes bitwise, kernel 3's output
    on the same column slices); kernel 8's decode path at the attention
    layer (head dim 128); then JAMBA_REQUESTS
    requests through the wave and continuous engines with each call's
    launches checked; the tokens of the reduced config on the card against
    the CPU's; ms per decode step, the selective scan's share of a
    prefill's device time from profiles, the expert weight glue and peak
    memory. Returns the phase's figures."""
    import dataclasses
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core import (ApproxConfig, QParams, acu_operand,
                                  inline_symmetric_scale, quantize)
    from repro_torch.core.quantization import device_scalar
    from repro_torch.core import symmetric_qparams
    from repro_torch.kernels.fused_lut_dense.ref import fused_lut_dense_ref
    from repro_torch.kernels.fused_lut_grouped.ops import grouped_plan
    from repro_torch.kernels.fused_lut_grouped.ref import (
        fused_lut_grouped_ref, live_rows)
    from repro_torch.kernels.quantize.ref import quantize_ref
    from repro_torch.models import mamba as MB
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import silu
    from repro_torch.serve import engine as E

    full = get_config(JAMBA_ARCH)
    cfg = dataclasses.replace(full, n_layers=JAMBA_LAYERS)
    n_exp, k, d, f = cfg.n_experts, cfg.moe_top_k, cfg.d_model, cfg.d_ff
    bf = torch.bfloat16
    acfg = ApproxConfig(acu=acu)
    lut16, lut32 = acu.device_lut(dev), torch.from_numpy(
        acu.lut.reshape(-1)).to(dev)
    off, n_codes = acu.offset, acu.multiplier.n_codes
    zero = device_scalar(0.0, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    torch.cuda.empty_cache()
    kinds = {kd: cfg.pattern.count(kd) for kd in dict.fromkeys(cfg.pattern)}
    blk = {kd: f"b{cfg.pattern.index(kd)}" for kd in kinds}
    di, dtr = cfg.mamba_d_inner, cfg.mamba_dt_rank
    hq, hkv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    dense = [  # (label, (block kind, branch, leaf) or None for the head, K, N)
        ("in_proj", ("mamba", "mamba", "in_proj"), d, 2 * di),
        ("x_proj", ("mamba", "mamba", "x_proj"), di,
         dtr + 2 * cfg.mamba_d_state),
        ("dt_proj", ("mamba", "mamba", "dt_proj"), dtr, di),
        ("out_proj", ("mamba", "mamba", "out_proj"), di, d),
        ("q/o", ("attn", "attn", "wq"), d, hq),
        ("k/v", ("attn", "attn", "wk"), d, hkv),
        ("gate/up", ("mamba", "mlp", "w_gate"), d, f),
        ("down", ("mamba", "mlp", "w_down"), f, d),
        ("head", None, d, cfg.vocab_padded)]

    # -- kernel 2 at jamba's weight shapes, the expert stacks included -----
    print(f"  quantize against its plain version at jamba's weight shapes, "
          f"bitwise, float32 and bfloat16 (a third of the values on "
          f"half-code boundaries, 3 % past the clip):")
    for label, shape, form in (
            [(lb, (kk, nn), 1) for lb, _, kk, nn in dense]
            + [("expert gate/up", (n_exp, d, f), "grouped"),
               ("expert down", (n_exp, f, d), "grouped")]):
        same = []
        for dtype in (torch.float32, bf):
            x, s, z = quantize_operands(torch, gen, dev, shape, form, dtype)
            qk, qp = ops["quantize"](x, s, z), quantize_ref(x, s, z)
            same.append(torch.equal(qk, qp) and int(qk.min()) == -128
                        and int(qk.max()) == 127)
            del x, s, z, qk, qp
        check(all(same), f"quantize {label} {shape}, "
                         f"{'per channel' if form == 1 else form}: bitwise "
                         f"equal in float32 and bfloat16, both clip edges "
                         f"reached")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    print(f"jamba-v0.1-52b at full width, depth cut from {full.n_layers} to "
          f"{cfg.n_layers} layers (one period: {kinds}; d {d}, d_inner "
          f"{cfg.mamba_d_inner}, d_state {cfg.mamba_d_state}, dt_rank "
          f"{cfg.mamba_dt_rank}, {cfg.n_heads} heads over {cfg.n_kv_heads}, "
          f"head_dim {cfg.head_dim}, {n_exp} experts top-{k} of d_ff {f}, "
          f"vocab {cfg.vocab_padded}, {cfg.dtype}, {cfg.n_params() / 1e9:.2f}"
          f" B parameters; {full.n_params() / 1e9:.2f} B at full depth), "
          f"{MULT} fused ACU:")
    t0 = time.perf_counter()
    params = T.init_params(0, cfg, device=dev)
    torch.cuda.synchronize()
    print(f"  random weights from seed 0 in {time.perf_counter() - t0:.2f} s"
          f", {torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    moe_blk = next(f"b{i}" for i, kd in enumerate(cfg.pattern)
                   if kd == "mamba_moe")
    mlp0 = {n: t[0] for n, t in params["groups"][moe_blk]["mlp"].items()}

    def codes(w):
        ws = inline_symmetric_scale(
            torch.clamp_min(w.abs().amax(dim=1), 1e-9), 8)
        qp = QParams(scale=ws[:, None, :], zero_point=zero, bits=8)
        return acu_operand(quantize(w, qp), qp), ws

    def act_scale(x):
        return inline_symmetric_scale(torch.clamp_min(x.abs().amax(), 1e-6),
                                      8)

    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    times = {}

    def hold(label, x, wname, counts):
        """Kernel 10 at one shape: bitwise against its plain version on
        the first and last JAMBA_COLS output columns; timed against
        torch.bmm (f32) and its bound. The expert stack's codes (kernel
        2) are held against quantize's plain version first (zero point 0:
        the operand is the code)."""
        wq, ws = codes(mlp0[wname])
        same_codes = torch.equal(wq, quantize_ref(mlp0[wname],
                                                  ws[:, None, :], zero))
        G, C, K = x.shape
        N = wq.shape[2]
        c = torch.cat([torch.arange(JAMBA_COLS, device=dev),
                       torch.arange(N - JAMBA_COLS, N, device=dev)])
        xs = act_scale(x)
        kern = lambda: ops["fused_lut_grouped"](x, wq, lut16, off, xs, zero,
                                                ws, counts)
        yk = kern()
        wq_c, ws_c = wq[:, :, c].contiguous(), ws[:, c].contiguous()
        t0 = time.perf_counter()
        yp = fused_lut_grouped_ref(x, wq_c, lut32, off, n_codes, xs, zero,
                                   ws_c, counts)
        torch.cuda.synchronize()
        pms = (time.perf_counter() - t0) * 1e3
        dead = ~live_rows(counts, C)
        ok = (same_codes and torch.equal(yk[:, :, c], yp)
              and not bool(yk[dead].any()))
        nb = G // n_exp
        per_e = counts.reshape(nb, n_exp).sum(0)
        live, e_live = int(per_e.sum()), int((per_e > 0).sum())
        ms = cuda_ms(torch, kern, 10)
        xb = x.reshape(nb, n_exp, C, K).transpose(0, 1).reshape(
            n_exp, nb * C, K).float()
        wf = wq.float()
        lib = cuda_ms(torch, lambda: torch.bmm(xb, wf), 5)
        del xb, wf, wq_c
        bytes_ = (live * K * x.element_size() + e_live * K * N * 4
                  + n_exp * N * 4 + lut16.numel() * 2 + G * 4 + G * C * N * 4)
        lookups = live * K * N
        bound = max(bytes_ / HBM_BYTES_PER_S, lookups / lookups_per_s) * 1e3
        plan = grouped_plan(n_exp, nb, C, K, N, n_sm, n_codes, 2)
        check(ok, f"fused_lut_grouped {label} G={G} C={C} {K}->{N}: the "
                  f"expert codes and the output bitwise equal to the plain "
                  f"versions, the output on columns 0..{JAMBA_COLS - 1}"
                  f" and {N - JAMBA_COLS}..{N - 1} ({pms:.0f} ms), dead rows "
                  f"0; plan {plan.describe()}")
        print(f"    {ms:.4f} ms (torch.bmm f32 {lib:.4f}), bound {bound:.4f} "
              f"ms ({live} live rows, {lookups / 1e9:.3f} G lookups, "
              f"{bytes_ / 1e6:.1f} MB)", flush=True)
        times[label] = (ms, lib, bound, pms)
        return yk

    print(f"  fused_lut_grouped (kernel 10) at jamba's expert shapes, counts "
          f"from layer {moe_blk[1:]}'s routing of random hidden states:")
    for t, label in ((JAMBA_SLOTS, "decode"),
                     (JAMBA_SLOTS * JAMBA_PROMPT, "prefill")):
        geo = M.dispatch_geometry(cfg, t)
        x = torch.randn((t, d), generator=gen, device=dev).to(bf)
        _, _, top_e = M._route(x, mlp0["router"], k)
        xe, counts, _, _ = M.dispatch(x, top_e, geo)
        G, C = geo["n_blocks"] * n_exp, geo["capacity"]
        xg, cnt = xe.reshape(G, C, d), counts.reshape(G)
        gate = hold(f"{label} gate", xg, "w_gate", cnt)
        up = hold(f"{label} up", xg, "w_up", cnt)
        hold(f"{label} down", silu(gate.to(bf)) * up.to(bf), "w_down", cnt)
        del gate, up, xe, xg
    torch.cuda.empty_cache()
    redesign["kernel 10 jamba"] = times

    # -- kernels 2 and 3 at jamba's dense GEMM shapes -----------------------
    rows = (JAMBA_SLOTS, JAMBA_SLOTS * JAMBA_PROMPT)
    print(f"  quantize and fused_lut_dense at jamba's dense GEMM shapes, the "
          f"model's bfloat16 weights quantized as approx_dense does, M = "
          f"{' and '.join(map(str, rows))}: the codes bitwise, the output "
          f"bitwise on its first and last {JAMBA_COLS} columns:")
    for label, leaf, kk, nn in dense:
        w = (params["lm_head"] if leaf is None else
             params["groups"][blk[leaf[0]]][leaf[1]][leaf[2]][0])
        assert tuple(w.shape) == (kk, nn), (label, tuple(w.shape))
        wqp = symmetric_qparams(torch.clamp_min(w.abs().amax(dim=0), 1e-9),
                                8, axis=1)
        q = quantize(w, wqp)                                   # kernel 2
        same = [torch.equal(q, quantize_ref(
            w, wqp.scale.reshape(1, -1), wqp.zero_point.reshape(1, -1)))]
        wq = acu_operand(q, wqp)
        del q
        for m_rows in rows:
            x = torch.randn((m_rows, kk), generator=gen,
                            device=dev).to(bf)
            xqp = symmetric_qparams(torch.clamp_min(x.abs().amax(), 1e-6), 8)
            yk = ops["fused_lut_dense"](x, wq, lut16, off, xqp.scale,
                                        xqp.zero_point, wqp.scale)
            for cols in (slice(0, JAMBA_COLS), slice(nn - JAMBA_COLS, nn)):
                yp = fused_lut_dense_ref(x, wq[:, cols].contiguous(), lut32,
                                         off, n_codes, xqp.scale,
                                         xqp.zero_point, wqp.scale[cols])
                same.append(torch.equal(yk[:, cols], yp))
            del x, yk, yp
        check(all(same), f"{label}: quantize ({kk}, {nn}) codes and "
                         f"fused_lut_dense Mx{kk}x{nn}, M = "
                         f"{' and '.join(map(str, rows))}, bitwise equal to "
                         f"the plain versions")
        del w, wq
    torch.cuda.empty_cache()

    # -- kernel 8's decode path at jamba's attention (head dim 128) -------
    redesign["kernel 8 " + cfg.name] = hold_decode_path(
        torch, np, dev, check, acu, ops, cfg, 24)

    # -- serve through the wave and continuous engines ---------------------
    rng = np.random.default_rng(23)
    prompts = [rng.integers(1, cfg.vocab_size, JAMBA_PROMPT).astype(np.int32)
               for _ in range(JAMBA_REQUESTS)]
    n_kind = {kd: cfg.pattern.count(kd) * cfg.n_groups
              for kd in ("mamba", "mamba_moe", "attn")}
    n_dense = (4 * (n_kind["mamba"] + n_kind["mamba_moe"])
               + 3 * n_kind["mamba"] + 7 * n_kind["attn"] + 1)
    per_call = {"fused_lut_dense": n_dense,
                "fused_lut_grouped": 3 * n_kind["mamba_moe"],
                "quantize": n_dense + 3 * n_kind["mamba_moe"]}
    engines = {
        "wave": E.ServeEngine(params, cfg, slots=JAMBA_SLOTS,
                              max_seq=JAMBA_MAX_SEQ, acfg=acfg, device=dev),
        "continuous": E.ContinuousServeEngine(
            params, cfg, slots=JAMBA_SLOTS, max_seq=JAMBA_MAX_SEQ, acfg=acfg,
            device=dev)}
    print(f"  serving {JAMBA_REQUESTS} requests of {JAMBA_PROMPT} prompt "
          f"tokens, {JAMBA_NEW} new tokens each, slots={JAMBA_SLOTS}, "
          f"max_seq={JAMBA_MAX_SEQ}; per model call {per_call} + "
          f"{n_kind['attn']} approx_flash_attention:")
    rates = serve_lm(torch, check, E, engines, prompts, JAMBA_NEW, cfg, ops,
                     launches, per_call, attn_layers=n_kind["attn"])
    del engines
    try:
        E.PagedContinuousServeEngine(params, cfg, slots=JAMBA_SLOTS,
                                     max_seq=JAMBA_MAX_SEQ,
                                     block_size=LM_BLOCK, acfg=acfg,
                                     device=dev)
        refused = False
    except NotImplementedError:
        refused = True
    check(refused, "the paged engine refuses jamba's mamba layers, as the "
                   "reference's paged cache does")

    # -- decode step, prefill profile and the scan's share ----------------
    b = JAMBA_SLOTS
    ptoks = torch.from_numpy(np.stack(prompts)).to(dev)
    captured = []
    inner_scan = MB._ssm_scan

    def capture(dA, dBx, h0=None):
        captured.append((dA, dBx, h0))
        return inner_scan(dA, dBx, h0)

    def prefill():
        c = T.init_cache(cfg, b, JAMBA_MAX_SEQ, device=dev)
        return T.apply_model(params, ptoks, cfg, acfg=acfg, cache=c,
                             cache_pos=0, last_only=True)[0].argmax(-1).cpu()

    with torch.inference_mode():
        cache = T.init_cache(cfg, b, JAMBA_MAX_SEQ, device=dev)
        lg, _ = T.apply_model(params, ptoks, cfg, acfg=acfg, cache=cache,
                              cache_pos=0, last_only=True)
        cur = lg[:, -1].argmax(-1)[:, None]
        step = lambda: T.apply_model(params, cur, cfg, acfg=acfg,
                                     cache=cache, cache_pos=JAMBA_PROMPT,
                                     decode=True)[0].argmax(-1).cpu()
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            step()
        step_ms = (time.perf_counter() - t0) / 3 * 1e3
        profile(torch, f"jamba decode step, {b} rows", step, step_ms)
        prefill()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill()
        pre_ms = (time.perf_counter() - t0) * 1e3
        _, _, prows = profile(torch, f"jamba prefill, {b} x {JAMBA_PROMPT} "
                                     f"tokens", prefill, pre_ms)
        MB._ssm_scan = capture
        try:
            prefill()
        finally:
            MB._ssm_scan = inner_scan
        _, _, srows = profile(torch, f"the {len(captured)} selective scans "
                                     f"of that prefill",
                              lambda: [inner_scan(*a) for a in captured])
        busy = sum(r[1] for r in prows)
        scan = sum(r[1] for r in srows)
        share = scan / busy if busy else float("nan")
        check(len(captured) == n_kind["mamba"] + n_kind["mamba_moe"],
              f"selective scan: {scan:.3f} ms of the prefill's "
              f"{busy:.3f} ms device time ({share:.3f}), "
              f"{len(captured)} scans of {tuple(captured[0][0].shape)}")
        del captured
        mlp = params["groups"][moe_blk]["mlp"]
        glue = cuda_ms(torch, lambda: [codes(mlp[n][0]) for n in
                                       ("w_gate", "w_up", "w_down")], 3)
        n_moe = n_kind["mamba_moe"]
        print(f"  expert weight quantization (scales, codes) of one layer: "
              f"{glue:.3f} ms, x{n_moe} mamba_moe layers = {glue * n_moe:.1f}"
              f" ms of each model call ({step_ms:.1f} ms a decode step)")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  jamba decode step {step_ms:.1f} ms, prefill of {b} x "
          f"{JAMBA_PROMPT} {pre_ms:.1f} ms; tokens/s " + ", ".join(
              f"{kk} {v:.1f}" for kk, v in rates.items())
          + f"; peak memory {peak:.2f} GiB")
    del params, cache, mlp0, mlp
    torch.cuda.empty_cache()

    # -- the reduced config: the card against the CPU ----------------------
    red = reduced_config(JAMBA_ARCH)
    small = T.init_params(1, red, device=dev)
    cpu_small = T.map_cache(lambda t: t.cpu(), small)
    reqs = [prompts[i][:16 + 5 * i] % red.vocab_size for i in range(3)]
    for name in ("wave", "continuous"):
        cls = E.ServeEngine if name == "wave" else E.ContinuousServeEngine
        on = {}
        for where, p in (("card", small), ("CPU", cpu_small)):
            eng = cls(p, red, slots=2, max_seq=64, acfg=acfg,
                      device=dev if where == "card" else "cpu")
            on[where] = [[int(t) for t in r.out] for r in eng.run(
                [E.Request(prompt=q.copy(), max_new_tokens=6) for q in reqs])]
        check(on["card"] == on["CPU"],
              f"jamba reduced config ({red.n_layers} layers, d "
              f"{red.d_model}), {name} engine, 3 requests x 6 tokens: the "
              f"same tokens on the card and the CPU ({on['card'][0]} ...)")
    del small, cpu_small
    torch.cuda.empty_cache()
    return {"rates": rates, "step_ms": step_ms, "prefill_ms": pre_ms,
            "scan_share": share, "glue_ms": glue * n_kind["mamba_moe"],
            "peak_gib": peak, "k10": times}


def attn_pairs(sq: int, sk: int, window) -> int:
    """Visible (query, key) pairs of a causal call with queries aligned
    to key 0 and an optional window."""
    i = sum(min(q + 1, sk) for q in range(sq))
    if window is None:
        return i
    return i - sum(max(0, min(q + 1, sk) - window) for q in range(sq))


def score_phase(torch, np, dev, check, acu, ops, launches, account,
                fma_per_s, redesign) -> dict:
    """gemma2-27b through ``loss_fn``: kernel 11 against its plain version
    (and the chunked path, and SDPA's time) at the model's shapes, then one
    scored sequence at full width and depth on the fused ACU with exact
    launch counts, a profile of one forward, and the card against the CPU
    on a two-layer cut. Returns the scoring's numbers."""
    import dataclasses
    import gc

    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.core import (ApproxConfig, acu_operand, quantize,
                                  symmetric_qparams)
    from repro_torch.core.approx_ops import approx_dense
    from repro_torch.data.pipeline import MarkovLM
    from repro_torch.kernels.flash_attention.ops import flash_plan
    from repro_torch.kernels.flash_attention.ref import (
        FLASH_BK, flash_attention_ref, flash_tolerance)
    from repro_torch.kernels.fused_lut_dense.ref import fused_lut_dense_ref
    from repro_torch.kernels.quantize.ref import quantize_ref
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import gqa_attention

    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(SCORE_ARCH), attn_impl="flash")
    hq, hkv, d, w = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, \
        cfg.window_size
    cap = cfg.softcap_attn
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    print(f"gemma2-27b ({cfg.n_layers} layers, d {cfg.d_model}, {hq} heads "
          f"over {hkv} KV heads, head_dim {d}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_padded}, window {w}, softcaps {cap} / "
          f"{cfg.softcap_final}, bf16), attn_impl=flash, {MULT} fused ACU:")

    # -- kernel 11 against its plain version -------------------------------
    print("  flash_attention against its plain version on the card, every "
          "element within flash_tolerance (4 x (sqrt(n) + |q_row * scale| "
          "* max|k|) ulp of max|v| for n visible keys, + 1 ulp of the "
          "output), and planted faults of the plain version beyond it:")
    cases = [  # label, Hq, Hkv, D, Sq, Sk, window, softcap, dtype, q times,
        #        planted faults, calls per forward
        ("gemma2 local", hq, hkv, d, SCORE_TOKENS, SCORE_TOKENS, w, cap,
         torch.bfloat16, 1, ("window off by one", "softcap dropped"),
         cfg.n_groups),
        ("gemma2 global", hq, hkv, d, SCORE_TOKENS, SCORE_TOKENS, None, cap,
         torch.bfloat16, 1, ("first KV tile dropped",), cfg.n_groups),
        ("gemma2 local, q x10", hq, hkv, d, SCORE_TOKENS, SCORE_TOKENS, w,
         cap, torch.bfloat16, 10, ("softcap dropped",), 0),
        ("ragged local", hq, hkv, d, 4000, 4000, 1000, cap, torch.bfloat16,
         1, (), 0),
        ("Sq < Sk local", hq, hkv, d, 1000, SCORE_TOKENS, w, cap,
         torch.bfloat16, 1, (), 0),
        ("SmolLM-135M", 9, 3, 64, 600, 600, None, None, torch.float32, 1,
         (), 0),
    ]
    for (label, nq, nkv, hd, sq, sk, win, sc, dt, qmul, faults,
         per_fwd) in cases:
        q = (torch.randn((1, sq, nq, hd), generator=gen, device=dev)
             * qmul).to(dt)
        k, v = (torch.randn((1, sk, nkv, hd), generator=gen,
                            device=dev).to(dt) for _ in range(2))
        kw = dict(causal=True, window=win, softcap=sc)
        views = [t.transpose(1, 2) for t in (q, k, v)]   # (B, H, S, D)
        fold = [t.reshape(-1, t.shape[-2], hd) for t in views]
        kern = lambda: ops["flash_attention"](*views, **kw)
        plain = lambda: flash_attention_ref(*fold, rep=nq // nkv, **kw)
        yk, yp = kern(), plain()
        tol = flash_tolerance(*fold, yp, rep=nq // nkv, **kw)
        err = (yk.reshape(yp.shape).double() - yp.double()).abs()
        check(bool(torch.isfinite(yk).all()) and yk.dtype == dt
              and bool((err <= tol).all()),
              f"flash_attention {label} (Hq {nq}/Hkv {nkv}, D {hd}, Sq {sq},"
              f" Sk {sk}, window {win}, softcap {sc}, {str(dt)[6:]}): max "
              f"|diff| {float(err.max()):.3e}, largest |diff| / tolerance "
              f"{float((err / tol).max()):.3f}")
        for fault in faults:
            # what a kernel with this fault would give, and the rows it
            # moves: past the window, or past the first tile
            fkw, rows, frows = dict(kw), slice(0, sq), slice(0, sq)
            if fault == "window off by one":
                fkw["window"] = win - 1
                rows = frows = slice(win, sq)
            if fault == "softcap dropped":
                fkw["softcap"] = None
            bad_in = fold
            if fault == "first KV tile dropped":
                bad_in = [t[:, FLASH_BK:] for t in fold]
                rows, frows = slice(FLASH_BK, sq), slice(0, sq - FLASH_BK)
            bad = flash_attention_ref(*bad_in, rep=nq // nkv, **fkw)[:, frows]
            fe = (bad.double() - yp[:, rows].double()).abs() / tol[:, rows]
            check(bool((fe > 1).any()),
                  f"flash_attention {label}: the plain version with the "
                  f"{fault} lies beyond the tolerance (largest |diff| / "
                  f"tolerance {float(fe.max()):.1f}, "
                  f"{float((fe > 1).any(-1).double().mean()):.3f} of its "
                  f"rows beyond)")
            del bad, fe
        if per_fwd:
            # a planted fault of the kernel: the heaviest item's last KV
            # tile dropped from its plan
            plan = flash_plan(nq, sq, sk, nq // nkv, True, win, hd,
                              k.element_size())
            bad = ops["flash_attention"](*views, plan=plan.drop_last_tile(0),
                                         **kw)
            fe = (bad.reshape(yp.shape).double() - yp.double()).abs() / tol
            check(bool((fe > 1).any()),
                  f"flash_attention {label}: the plan with its heaviest "
                  f"item's last KV tile dropped lies beyond the tolerance "
                  f"(largest |diff| / tolerance {float(fe.max()):.1f}; plan: "
                  f"{len(plan.items)} items of {plan.heads} heads x "
                  f"{plan.bq} rows, {plan.warps} warps, {plan.smem} B of "
                  f"shared memory)")
            del bad, fe
            yc = gqa_attention(q, k, v, impl="chunked", **kw)
            ec = (yk.transpose(1, 2).double() - yc.double()).abs()
            ec = ec.transpose(1, 2).reshape(err.shape)
            check(bool((ec <= tol).all()),
                  f"flash_attention {label} against gqa_attention(impl="
                  f"\"chunked\") within the same tolerance (max |diff| "
                  f"{float(ec.max()):.3e}, largest |diff| / tolerance "
                  f"{float((ec / tol).max()):.3f})")
            del yc, ec
            mask = None
            if win is not None:
                i = torch.arange(sq, device=dev)[:, None]
                j = torch.arange(sk, device=dev)[None, :]
                mask = (j <= i) & (j > i - win)
            qd, kd, vd = (t.contiguous() for t in views)
            sdpa = lambda q_, k_, v_: F.scaled_dot_product_attention(
                q_, k_, v_, attn_mask=mask, is_causal=mask is None,
                enable_gqa=True)
            lib = cuda_ms(torch, lambda: sdpa(qd, kd, vd), 5)
            # the same attention on float32 operands (SDPA has no softcap),
            # the kernels line's yardstick, and the kernel PyTorch ran
            q32, k32, v32 = (t.float() for t in (qd, kd, vd))
            lib32 = cuda_ms(torch, lambda: sdpa(q32, k32, v32), 5)
            rows = profile(torch, f"SDPA float32 at {label}",
                           lambda: sdpa(q32, k32, v32), lead=2000)[2]
            backend = rows[0][0][:60] if rows else "not measured"
            ms = cuda_ms(torch, kern, 5)
            pms = cuda_ms(torch, plain, 1, warm=0)
            pairs = attn_pairs(sq, sk, win)
            flops = 4 * nq * hd * pairs
            bytes_ = (2 * sq * nq + 2 * sk * nkv) * hd * yk.element_size()
            bound = max(bytes_ / HBM_BYTES_PER_S, flops / TF32_FLOPS) * 1e3
            fp32 = flops / 2 / fma_per_s * 1e3
            # the split's own floor: 2 TF32 products at bfloat16 K and V,
            # 3 at float32
            passes = 2 if dt == torch.bfloat16 else 3
            split = passes * flops / TF32_FLOPS * 1e3
            before = K2_K11_BEFORE_MS["flash_attention"] / cfg.n_layers
            redesign[f"kernel 11 {label}"] = (ms, lib, lib32, backend,
                                              bound, fp32, split)
            account("flash_attention", per_fwd, ms, pms, lib32, bytes_,
                    flops, float(err.max()), ops_per_s=TF32_FLOPS)
            print(f"    {label}: {ms:.4f} ms (plain {pms:.2f}; "
                  f"scaled_dot_product_attention without softcap: "
                  f"{str(dt)[6:]} {lib:.4f}, float32 {lib32:.4f} on "
                  f"{backend}), bound {bound:.4f} ms (operations: "
                  f"{flops / 1e9:.1f} GFLOP at the TF32 rate; "
                  f"{bytes_ / 1e6:.1f} MB); {passes}xTF32 split bound "
                  f"{split:.4f} ms; at the FP32 CUDA-core rate "
                  f"{fp32:.4f} ms; x{per_fwd} per forward; before the "
                  f"redesign {before:.3f} ms a layer on average "
                  f"({K2_K11_BEFORE_MS['flash_attention']:.3f} per "
                  f"forward, PERF.md)", flush=True)
            del qd, kd, vd, q32, k32, v32, mask
        del q, k, v, views, fold, yk, yp, tol, err
    torch.cuda.empty_cache()

    # -- kernels 2 and 3 at the model's GEMM shapes -------------------------
    print(f"  quantize and fused_lut_dense at gemma2-27b's GEMM shapes, "
          f"M = {SCORE_TOKENS} rows: quantize bitwise in float32 and "
          f"bfloat16 per output channel (a third of the values on half-code "
          f"boundaries, 3 % past the clip); then a bfloat16 weight through "
          f"quantize and fused_lut_dense over every column, as loss_fn "
          f"runs them, bitwise on the plain versions (fused_lut_dense on "
          f"its first and last {SCORE_COLS} columns, whose plain gather "
          f"alone is affordable):")
    lut16 = acu.device_lut(dev)
    lut32 = torch.from_numpy(acu.lut.reshape(-1)).to(dev)
    off, n_codes = acu.offset, acu.multiplier.n_codes
    dm, qd, kvd = cfg.d_model, hq * d, hkv * d
    gemms = [("q", dm, qd), ("k/v", dm, kvd), ("o", qd, dm),
             ("gate/up", dm, cfg.d_ff), ("down", cfg.d_ff, dm),
             ("head", dm, cfg.vocab_padded)]
    for label, kk, nn in gemms:
        same = []
        for dtype in (torch.float32, torch.bfloat16):
            x, s, z = quantize_operands(torch, gen, dev, (kk, nn), 1, dtype)
            qk, qp = ops["quantize"](x, s, z), quantize_ref(x, s, z)
            same.append(torch.equal(qk, qp) and int(qk.min()) == -128
                        and int(qk.max()) == 127)
            del x, s, z, qk, qp
        check(all(same), f"quantize {label} ({kk}, {nn}), per channel: "
                         f"bitwise equal in float32 and bfloat16, both clip "
                         f"edges reached")
        w = (torch.randn((kk, nn), generator=gen, device=dev)
             * kk ** -0.5).to(torch.bfloat16)
        x = torch.randn((SCORE_TOKENS, kk), generator=gen,
                        device=dev).to(torch.bfloat16)
        # the qparams as approx_dense makes them
        xqp = symmetric_qparams(torch.clamp_min(x.abs().amax(), 1e-6), 8)
        wqp = symmetric_qparams(torch.clamp_min(w.abs().amax(dim=0), 1e-9),
                                8, axis=1)
        codes = quantize(w, wqp)                     # kernel 2
        same_codes = torch.equal(codes, quantize_ref(
            w, wqp.scale.reshape(1, -1), wqp.zero_point.reshape(1, -1)))
        wq = acu_operand(codes, wqp)
        del codes
        yk = ops["fused_lut_dense"](x, wq, lut16, off, xqp.scale,
                                    xqp.zero_point, wqp.scale)
        same = [same_codes]
        for cols in (slice(0, SCORE_COLS), slice(nn - SCORE_COLS, nn)):
            yp = fused_lut_dense_ref(x, wq[:, cols].contiguous(), lut32, off,
                                     n_codes, xqp.scale, xqp.zero_point,
                                     wqp.scale[cols])
            same.append(torch.equal(yk[:, cols], yp))
            del yp
        check(all(same), f"{label}: quantize ({kk}, {nn}) bfloat16 weight "
                         f"codes and fused_lut_dense {SCORE_TOKENS}x{kk}x{nn}"
                         f" bitwise equal to the plain versions")
        del w, x, wq, yk
        torch.cuda.empty_cache()

    # -- score one sequence at full width and depth ------------------------
    t0 = time.perf_counter()
    params = T.init_params(0, cfg, device=dev)
    torch.cuda.synchronize()
    print(f"  random weights from seed 0 in {time.perf_counter() - t0:.1f} s,"
          f" {torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card "
          f"({cfg.n_params() / 1e9:.2f} B parameters)")
    batch = next(MarkovLM(cfg.vocab_size, seed=0).batches(1, SCORE_TOKENS))
    toks, labels = (torch.from_numpy(batch[k]).long().to(dev)
                    for k in ("tokens", "labels"))
    acfg = ApproxConfig(acu=acu)
    n_gemm = 7 * cfg.n_layers + 1
    want = {k: 0 for k in ops}
    want.update(flash_attention=cfg.n_layers, fused_lut_dense=n_gemm,
                quantize=n_gemm)
    score = lambda: float(T.loss_fn(params, toks, labels, cfg, acfg=acfg))
    torch.cuda.reset_peak_memory_stats()
    for op in ops.values():
        op.launches = 0
    # one forward, profiled: its host-clock wall (ending in the loss's
    # device-to-host read) gives the scored tokens/s
    with torch.no_grad():
        loss, wall_ms, rows = profile(torch, "gemma2-27b loss_fn forward",
                                      score)
    dt = wall_ms / 1e3
    counts = {k: op.launches for k, op in ops.items()}
    for k in ops:
        launches[k] += counts[k]
    peak = torch.cuda.max_memory_allocated() / 2**30
    rate = SCORE_TOKENS / dt
    k3_ms = sum(ms for key, ms, _ in rows if "fused_lut_dense" in key)
    per_layer = (2 * dm * qd + 2 * dm * kvd + 3 * dm * cfg.d_ff)
    k3_lookups = SCORE_TOKENS * (cfg.n_layers * per_layer
                                 + dm * cfg.vocab_padded)
    print(f"  fused_lut_dense in the forward: {k3_ms / 1e3:.3f} s of device "
          f"time for {k3_lookups / 1e12:.2f} T lookups, "
          + (f"{k3_lookups / k3_ms / 1e9:.3f} T lookups/s" if k3_ms else
             "rate not measured (no device time traced)"), flush=True)
    print(f"  scored {SCORE_TOKENS} tokens of MarkovLM(vocab="
          f"{cfg.vocab_size}, seed=0) through loss_fn: loss {loss:.4f} "
          f"(ln vocab {np.log(cfg.vocab_size):.4f}), {dt:.1f} s, {rate:.1f} "
          f"scored tokens/s, peak memory {peak:.2f} GiB; launches {counts}",
          flush=True)
    check(np.isfinite(loss) and 0 < loss < 3 * np.log(cfg.vocab_size),
          f"gemma2-27b loss finite and positive ({loss:.4f})")
    check(counts == want, f"one loss_fn forward launches "
                          f"{ {k: v for k, v in want.items() if v} } "
                          f"(kernel 11 per layer, kernels 3 and 2 per GEMM: "
                          f"7 per layer + the head) and nothing else")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # -- the card against the CPU, two layers, float32 ---------------------
    cut = dataclasses.replace(cfg, n_layers=SCORE_CPU_LAYERS,
                              dtype="float32")
    small = T.init_params(1, cut, device=dev)
    for blk in small["groups"].values():     # scores where softcap 50 bites
        blk["attn"]["wq"].mul_(SCORE_CPU_QMUL)
    tk, lb = toks[:, :SCORE_CPU_TOKENS], labels[:, :SCORE_CPU_TOKENS]
    # what the LUT ACU would cost the CPU here: one q projection timed
    x = torch.randn((SCORE_CPU_TOKENS, cut.d_model))
    t0 = time.perf_counter()
    approx_dense(x, small["groups"]["b0"]["attn"]["wq"][0].cpu(), None, acfg)
    per_lookup = (time.perf_counter() - t0) / (x.numel() * hq * d)
    # every GEMM weight is one lookup per token (the embedding is none)
    lookups = SCORE_CPU_TOKENS * (cut.n_params()
                                  - cut.vocab_padded * cut.d_model)
    print(f"  card against CPU on {SCORE_CPU_LAYERS} layers (local + global) "
          f"at full width, {SCORE_CPU_TOKENS} tokens, float32, q projections "
          f"x{SCORE_CPU_QMUL:g} (attention scores of tens: the softcap "
          f"bites), no ACU (the LUT ACU's {lookups / 1e9:.1f} G lookups "
          f"would take ~{lookups * per_lookup:.0f} s on the CPU at the "
          f"measured {1e-9 / per_lookup:.2f} G lookups/s):")
    with torch.no_grad():
        n0 = ops["flash_attention"].launches
        lg_gpu = T.apply_model(small, tk, cut)[0].cpu()
        loss_gpu = float(T.loss_fn(small, tk, lb, cut))
        check(ops["flash_attention"].launches - n0 == 2 * cut.n_layers,
              "the card's two forwards ran kernel 11 in every layer")
        cpu_small = T.map_cache(lambda t: t.cpu(), small)
        del small
        t0 = time.perf_counter()
        lg_cpu = T.apply_model(cpu_small, tk.cpu(), cut)[0]
        loss_cpu = float(T.loss_fn(cpu_small, tk.cpu(), lb.cpu(), cut))
        cpu_s = time.perf_counter() - t0
        # planted faults on the CPU: what a wrong softcap or mask would read
        faults = {"attention softcap dropped": dict(softcap_attn=None),
                  f"window {SCORE_CPU_TOKENS // 2} on the local layer":
                  dict(window_size=SCORE_CPU_TOKENS // 2)}
        fault_lg = {name: T.apply_model(
            cpu_small, tk.cpu(), dataclasses.replace(cut, **kw))[0]
            for name, kw in faults.items()}
    scale = float(lg_cpu.abs().max())
    rel = float((lg_gpu - lg_cpu).abs().max()) / scale
    fault_rel = {name: float((f - lg_cpu).abs().max()) / scale
                 for name, f in fault_lg.items()}
    print(f"    logits max |diff| / max |logit| {rel:.3e} (max |logit| "
          f"{scale:.3f}); loss card {loss_gpu:.6f}, CPU {loss_cpu:.6f} "
          f"({cpu_s:.1f} s on the CPU); planted faults on the CPU read "
          + ", ".join(f"{k} {v:.3e}" for k, v in fault_rel.items()))
    check(rel <= SCORE_CPU_TOL
          and abs(loss_gpu - loss_cpu) <= 2 * rel * scale
          + 1e-6 * abs(loss_cpu),
          f"gemma2-27b cut to {SCORE_CPU_LAYERS} layers: logits within "
          f"{SCORE_CPU_TOL:.0e} of the largest, loss within twice the "
          f"largest logit difference, card against CPU")
    check(min(fault_rel.values()) > SCORE_CPU_TOL,
          f"every planted fault lies beyond {SCORE_CPU_TOL:.0e}")
    del cpu_small
    return {"loss": loss, "tokens_per_s": rate, "seconds": dt,
            "peak_gib": peak}


def conv_phase(torch, np, dev, check, acu, ops, launches, account,
               lookups_per_s, lut_bytes, n_sm, redesign: dict) -> dict:
    """ImageNet-scale convs: kernel 6 against its plain version and kernel
    5, bitwise, with its tiling, a planted fault (a tiling with one channel
    group dropped) and times beside kernel 5's in the same call at the
    VGG-16 and CNN-224 shapes (into ``redesign``), and its bank-conflict
    replay at c2; the CNN at width 64 and 224^2 served through
    ``VisionServeEngine`` with c2 on the banded route, exact launch counts
    and fused logits bitwise equal to the unfused ones; one ``approx_bwd``
    step banded against whole-image; a separable block and a grouped conv
    against the CPU. Returns the serve numbers."""
    import dataclasses
    import torch.nn.functional as F
    from repro_torch.core import (ApproxConfig, acu_operand, make_acu,
                                  quantize, separable_conv2d)
    from repro_torch.core.acu import ConvSpec, conv_plan, resolve_conv_padding
    from repro_torch.core.approx_ops import (_conv_qparams, _fused_conv,
                                             conv2d)
    from repro_torch.data.pipeline import image_task
    from repro_torch.kernels import runtime
    from repro_torch.kernels.fused_lut_conv.ops import (
        conv_out_size, fused_lut_conv, fused_lut_conv_tiled,
        pick_conv_kernel_tiling, pick_tiled_kernel_tiling)
    from repro_torch.kernels.fused_lut_conv.ref import (
        fused_lut_conv_ref, fused_lut_conv_tiled_ref)
    from repro_torch.models.vision import cnn_forward, init_cnn
    from repro_torch.serve.engine import VisionServeEngine

    t_phase = time.perf_counter()
    off, n_codes = acu.offset, acu.multiplier.n_codes
    gen = torch.Generator(device=dev)
    gen.manual_seed(18)
    v = np.arange(-128, 128, dtype=np.int32)
    tables = {"std": acu.lut, "biased": v[:, None] * v[None, :] + 7}
    luts = {k: (runtime.lut_to_int16(torch.from_numpy(t)).to(dev),
                torch.from_numpy(np.ascontiguousarray(t, np.int32))
                .reshape(-1).to(dev)) for k, t in tables.items()}
    cfg = ApproxConfig(acu=acu)

    def max_err(a, b):
        return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())

    print("ImageNet-scale convs: fused_lut_conv_tiled (kernel 6) against its "
          "plain version and fused_lut_conv (kernel 5), f32 and int32, "
          "bitwise:")
    for (label, xs_, ws_, s, d, bh, table, timed) in TILED_CASES:
        x = torch.relu(torch.randn(xs_, generator=gen, device=dev))
        w = torch.randn(ws_, generator=gen, device=dev)
        xqp, wqp = _conv_qparams(x, w, cfg, None, None)
        wq = acu_operand(quantize(w, wqp), wqp)
        st, dl = (s, s), (d, d)
        pad = resolve_conv_padding("SAME", xs_, ws_, st, dl)
        (n, c, hw, _), (cout, _, k, _) = xs_, ws_
        ho = conv_out_size(hw, k, s, d, pad[0])
        tiling = pick_tiled_kernel_tiling(c, ho, ho, cout, k, k, s, s, d, d,
                                          n_codes, bh=bh)
        l16, l32 = luts[table]
        args = (xqp.scale, xqp.zero_point, wqp.scale)
        geo = dict(stride=st, padding=pad, dilation=dl)
        k6 = lambda emit=False: fused_lut_conv_tiled(
            x, wq, l16, off, *args, bh=bh, emit_acc=emit, **geo)
        k5 = lambda emit=False: fused_lut_conv(x, wq, l16, off, *args,
                                               emit_acc=emit, **geo)
        plain = lambda emit=False: fused_lut_conv_tiled_ref(
            x, wq, l32, off, n_codes, *args, bh=tiling.bh, emit_acc=emit,
            **geo)
        y6, a6 = k6(), k6(True)
        yp, ap = plain(), plain(True)
        ok = (torch.equal(y6, yp) and torch.equal(a6, ap)
              and torch.equal(y6, k5()) and torch.equal(a6, k5(True)))
        err = max(max_err(y6, yp), max_err(a6, ap))
        items = n * tiling.tiles
        grid, per_sm = min(items, n_sm), SMEM_PER_SM // (tiling.smem_bytes
                                                          + 1024)
        check(ok, f"fused_lut_conv_tiled {label} {xs_} -> {cout}, stride "
                  f"{s}, dilation {d}, {table} table: equal to its plain "
                  f"version and to fused_lut_conv ({tiling.describe(ho)}; "
                  f"{items} tiles on a grid of {grid} persistent blocks, "
                  f"{per_sm} block(s) per SM by shared memory)")
        if table == "biased":   # planted fault: the last channel group,
            # which holds channels C - 1 and the pad, dropped from the sum
            bad = dataclasses.replace(tiling, c4=tiling.c4 - 4)
            caught = not torch.equal(fused_lut_conv_tiled(
                x, wq, l16, off, *args, emit_acc=True, tiling=bad, **geo), ap)
            check(caught, f"fused_lut_conv_tiled {label}, planted fault: a "
                          f"tiling with its last channel group dropped (c4 "
                          f"{bad.c4} of {tiling.c4}) differs from the plain "
                          f"version: caught")
        del yp, ap
        if not timed:
            account("fused_lut_conv_tiled", 0, 0.0, 0.0, 0.0, 0.0, 0.0, err)
            continue
        lookups = n * ho * ho * c * k * k * cout
        wf = wq.float()
        lib = cuda_ms(torch, lambda: F.conv2d(x, wf, stride=st,
                                              padding=(pad[0][0], pad[1][0]),
                                              dilation=dl), 10)
        ms6, ms5, ms6b = (cuda_ms(torch, fn, 10) for fn in (k6, k5, k6))
        ms6 = min(ms6, ms6b)
        redesign[f"kernel 6 {label}"] = (ms6, ms5)
        t5 = pick_conv_kernel_tiling(n, c, ho, ho, cout, k, k, s, s, d, d,
                                     n_codes, n_sm)
        msp = cuda_ms(torch, plain, 2, warm=1)
        nbytes = ((x.numel() + wq.numel() + n * ho * ho * cout) * 4
                  + lut_bytes + cout * 4 + 8)
        bound = max(nbytes / HBM_BYTES_PER_S, lookups / lookups_per_s) * 1e3
        # the kernels line: kernel 6's row is one CNN-224 wave (its c2)
        account("fused_lut_conv_tiled", int(label == "CNN-224 c2"), ms6,
                msp, lib, nbytes, lookups, err)
        print(f"  {label}: {lookups / 1e9:.2f} G lookups, bound {bound:.3f} "
              f"ms ({bound / ms6:.0%} of it); kernel 6 {ms6:.3f} ms "
              f"({lookups / ms6 / 1e9:.3f} T lookups/s), kernel 5 "
              f"{ms5:.3f} ms ({lookups / ms5 / 1e9:.3f} T lookups/s) in the "
              f"same call: kernel 5 / kernel 6 {ms5 / ms6:.2f}; plain "
              f"{msp:.1f} ms, F.conv2d f32 {lib:.3f} ms; tile {tiling.bh} "
              f"rows x {tiling.bw} columns, grid {grid} of {items} tiles; "
              f"kernel 5's tiling: {t5.describe(n)}", flush=True)
        if label == "CNN-224 c2":   # bank conflicts: real codes against
            # codes that put a warp's 32 gathers in 32 banks (lane l's
            # channel j reads code 2l + 64j: word l + 32j, bank l) on one
            # table row (every pixel 0.5)
            co = torch.arange(cout, device=dev)
            lane, j = co % tiling.bn // tiling.tn, co % tiling.tn
            free_w = (2 * lane + 64 * j - off).to(torch.int32)[
                :, None, None, None].expand(ws_).contiguous()
            free_x = torch.full(xs_, 0.5, device=dev)
            free = cuda_ms(torch, lambda: fused_lut_conv_tiled(
                free_x, free_w, l16, off, *args, **geo), 10)
            again = cuda_ms(torch, k6, 10)
            replay = min(ms6, again) / free
            redesign["kernel 6 conflicts"] = replay
            print(f"    bank conflicts at c2: {min(ms6, again):.3f} ms on "
                  f"real codes / {free:.3f} ms on conflict-free codes: "
                  f"x{replay:.2f}", flush=True)
            del free_w, free_x
        del wf
    torch.cuda.empty_cache()

    # -- kernel 5 at the CNN's c1 and c3, the convs it serves there ---------
    S, W, I = CNN_SLOTS, CNN_WIDTH, CNN_IMG
    print("fused_lut_conv (kernel 5) at CNN-224's c1 and c3 against its plain "
          "version, f32 and int32, bitwise; timed against F.conv2d (f32, "
          "TF32 off) and the gather bound:")
    for label, xs_, ws_ in (("c1", (S, 3, I, I), (W, 3, 3, 3)),
                            ("c3", (S, 2 * W, I // 4, I // 4),
                             (4 * W, 2 * W, 3, 3))):
        x = torch.relu(torch.randn(xs_, generator=gen, device=dev))
        w = torch.randn(ws_, generator=gen, device=dev)
        xqp, wqp = _conv_qparams(x, w, cfg, None, None)
        wq = acu_operand(quantize(w, wqp), wqp)
        pad = ((1, 1), (1, 1))
        (n, c, hw, _), cout = xs_, ws_[0]
        tiling = pick_conv_kernel_tiling(n, c, hw, hw, cout, 3, 3, 1, 1, 1,
                                         1, n_codes, n_sm)
        l16, l32 = luts["std"]
        args = (xqp.scale, xqp.zero_point, wqp.scale)
        k5 = lambda emit=False: fused_lut_conv(x, wq, l16, off, *args,
                                               padding=pad, emit_acc=emit)
        same = [torch.equal(k5(emit), fused_lut_conv_ref(
            x, wq, l32, off, n_codes, *args, padding=pad, emit_acc=emit))
            for emit in (False, True)]
        check(all(same), f"fused_lut_conv CNN-224 {label} {xs_} -> {cout}: "
                         f"f32 and int32 bitwise equal to the plain version "
                         f"({tiling.describe(n)})")
        wf = wq.float()
        lib = cuda_ms(torch, lambda: F.conv2d(x, wf, padding=1), 10)
        ms = cuda_ms(torch, k5, 10)
        lookups = n * hw * hw * c * 9 * cout
        nbytes = ((x.numel() + wq.numel() + n * hw * hw * cout) * 4
                  + lut_bytes + cout * 4 + 8)
        bound = max(nbytes / HBM_BYTES_PER_S, lookups / lookups_per_s) * 1e3
        redesign[f"kernel 5 CNN-224 {label}"] = (ms, lib, bound)
        print(f"  {label}: {lookups / 1e9:.2f} G lookups, kernel 5 {ms:.3f} "
              f"ms ({lookups / ms / 1e9:.3f} T lookups/s), bound "
              f"{bound:.3f} ms ({bound / ms:.0%} of it), F.conv2d f32 "
              f"{lib:.3f} ms",
              flush=True)
        del x, w, wq, wf
    torch.cuda.empty_cache()

    # -- the CNN at VGG-16's widths on 224^2 images --------------------------
    print(f"serving {CNN_IMAGES} images of image_task(n_classes="
          f"{CNN_CLASSES}, size={I}), CNN width {W} (c1 3->{W}, c2 "
          f"{W}->{2 * W}, c3 {2 * W}->{4 * W}, f1 {4 * W * (I // 8) ** 2}->"
          f"{8 * W}, f2 {8 * W}->{CNN_CLASSES}), {MULT}, slots={S}:")
    params = init_cnn(seed=0, n_classes=CNN_CLASSES, width=W, img=I,
                      device=dev)
    images = next(image_task(n_classes=CNN_CLASSES, size=I)(CNN_IMAGES))[
        "image"]
    eng = VisionServeEngine(params, cnn_forward, slots=S, acfg=cfg,
                            device=dev)
    routes = []
    for name, xs_, ws_ in (("c1", (S, 3, I, I), (W, 3, 3, 3)),
                           ("c2", (S, W, I // 2, I // 2), (2 * W, W, 3, 3)),
                           ("c3", (S, 2 * W, I // 4, I // 4),
                            (4 * W, 2 * W, 3, 3))):
        rep = eng.plan_report(xs_, ws_, cfg)
        routes.append(rep["route"])
        print(f"  {name} {xs_} -> {ws_[0]}: route {rep['route']}, "
              f"{rep['gemm']}, tiling {rep['tiling']}")
    check(routes == ["fused_conv", "tiled", "fused_conv"],
          "CNN-224 plan: c1 and c3 fused_conv, c2 tiled, as the reference "
          "routes them")
    eng.run(images[:S])                              # warm-up wave
    torch.cuda.synchronize()
    for op in ops.values():
        op.launches = 0
    t0 = time.perf_counter()
    logits = eng.run(images)
    dt = time.perf_counter() - t0
    counts = {k: op.launches for k, op in ops.items()}
    waves = CNN_IMAGES // S
    rate = CNN_IMAGES / dt
    print(f"  fused: {rate:.1f} images/s ({dt:.3f} s for {CNN_IMAGES}, "
          f"{dt / waves * 1e3:.1f} ms per wave), launches {counts}")
    check(counts == {k: CNN_WAVE_LAUNCHES.get(k, 0) * waves for k in ops},
          f"CNN-224 fused: launch counts are {waves} x {CNN_WAVE_LAUNCHES}")
    for k in ops:
        launches[k] += counts[k]
    check(logits.shape == (CNN_IMAGES, CNN_CLASSES)
          and bool(np.isfinite(logits).all()),
          f"CNN-224 logits finite, shape {logits.shape}")
    unfused = VisionServeEngine(
        params, cnn_forward, slots=S, device=dev,
        acfg=ApproxConfig(acu=make_acu(MULT, "lut", use_kernels=True)))
    for op in ops.values():
        op.launches = 0
    t0 = time.perf_counter()
    lu = unfused.run(images[:S])
    ms_u = (time.perf_counter() - t0) * 1e3
    counts = {k: op.launches for k, op in ops.items()}
    check(counts == {k: CNN_UNFUSED_LAUNCHES.get(k, 0) for k in ops}
          and np.array_equal(lu, logits[:S]),
          f"CNN-224 unfused (im2col + lut_matmul) wave: launch counts "
          f"{CNN_UNFUSED_LAUNCHES}, logits bitwise equal to the fused "
          f"wave's ({ms_u:.1f} ms, first wave, untimed warm-up)")
    for k in ops:
        launches[k] += counts[k]
    del unfused, lu
    profile(torch, "CNN-224 fused wave", lambda: eng.run(images[:S]),
            dt / waves * 1e3, lead=2000)
    del eng, params, images
    torch.cuda.empty_cache()

    # -- one approx_bwd step, banded against whole-image --------------------
    bshape, wshape = CONV_BWD
    x0 = torch.relu(torch.randn(bshape, generator=gen, device=dev))
    w0 = torch.randn(wshape, generator=gen, device=dev) * 0.1
    r = torch.randn(bshape, generator=gen, device=dev)
    bcfg = ApproxConfig(acu=acu, approx_bwd=True)
    spec = ConvSpec(bshape, wshape, padding=((1, 1), (1, 1)))
    # the whole-image plan only under a budget the reference's VMEM model
    # would allow: a 224^2 map is over its 12 MiB
    plans = {"tiled": conv_plan(acu, spec),
             "fused_conv": conv_plan(acu, spec, route="fused_conv",
                                     vmem_budget=1 << 40)}
    grads = {}
    for name, plan in plans.items():
        xg = x0.clone().requires_grad_(True)
        wg = w0.clone().requires_grad_(True)
        for op in ops.values():
            op.launches = 0
        t0 = time.perf_counter()
        if name == "tiled":          # conv2d's own route
            y = conv2d(xg, wg, cfg=bcfg)
        else:
            xqp, wqp = _conv_qparams(xg, wg, bcfg, None, None)
            y = _fused_conv(xg, wg, bcfg, plan, xqp, wqp)
        (y * r).sum().backward()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = {k: op.launches for k, op in ops.items()}
        fwd = "fused_lut_conv_tiled" if name == "tiled" else "fused_lut_conv"
        want = {fwd: 1, "quantize": 1, "fused_lut_conv_bwd_w": 1,
                "fused_lut_bwd": 1}
        check(plan.route == name and counts == {k: want.get(k, 0)
                                                for k in ops},
              f"approx_bwd step of conv2d {bshape} -> {wshape[0]} on the "
              f"{name} "
              f"route: launch counts {want} ({ms:.1f} ms)")
        for k in ops:
            launches[k] += counts[k]
        grads[name] = (xg.grad, wg.grad)
        del y
    check(all(torch.equal(a, b) for a, b in zip(grads["tiled"],
                                                grads["fused_conv"])),
          "approx_bwd gradients of x and w bitwise equal between the tiled "
          "and fused_conv routes")
    del grads, x0, r
    torch.cuda.empty_cache()

    # -- a separable block and a grouped conv, card against the CPU ---------
    blocks = [
        (f"separable {SEPARABLE[0]}: depthwise 3x3, then 1x1 -> "
         f"{SEPARABLE[2][0]}", SEPARABLE,
         lambda x, wd, wp, b: separable_conv2d(x, wd, wp, b, cfg=cfg),
         {"fused_lut_dense": 1, "fused_lut_conv": 1, "quantize": 2}),
        (f"groups=4 {GROUPED[0]} -> {GROUPED[1][0]}, 3x3", GROUPED,
         lambda x, w, b: conv2d(x, w, b, groups=4, cfg=cfg),
         {"fused_lut_dense": 4, "quantize": 4}),
    ]
    for label, shapes, fn, want in blocks:
        ts = [torch.randn(sh, generator=gen, device=dev) for sh in shapes]
        for op in ops.values():
            op.launches = 0
        with torch.inference_mode():
            y = fn(*ts)
            torch.cuda.synchronize()
            counts = {k: op.launches for k, op in ops.items()}
            y_cpu = fn(*[t.cpu() for t in ts])
        check(counts == {k: want.get(k, 0) for k in ops}
              and torch.equal(y.cpu(), y_cpu),
              f"{label}: launch counts {want}, output {tuple(y.shape)} "
              f"bitwise equal to the CPU's")
        for k in ops:
            launches[k] += counts[k]
    took = time.perf_counter() - t_phase
    print(f"ImageNet-scale conv phase: {took:.1f} s")
    return {"images_per_s": rate, "wave_ms": dt / waves * 1e3,
            "seconds": took}


def share_of(torch, diff, bound) -> float:
    """The largest ``diff / bound``, an element with both 0 counting 0."""
    return float(torch.where(diff == 0, 0.0, diff / bound).max())


def err_matmul_holds(torch, a, w, yk, yp, lut_int, acu):
    """Whether ``yk`` (kernel 13's output) holds against ``yp`` (its plain
    version): every element within the summation bound, finite, and
    ``round(y)`` equal to lut_matmul's integer wherever that bound is below
    0.5 and wherever the (tighter) LUT agreement bound is. Returns (ok,
    the numbers a report prints)."""
    from repro_torch.kernels.err_matmul.ref import (lut_agreement_bound,
                                                    summation_bound)
    f, g = acu.device_factors(a.device)
    off = acu.offset
    bound = summation_bound(a, w, f, g, off)
    diff = (yk.to(torch.float64) - yp.to(torch.float64)).abs()
    rounded = torch.round(yk).to(torch.int32)
    small = bound < 0.5
    near = lut_agreement_bound(yk, a, w, f, g, off,
                               acu.lowrank.max_abs_err) < 0.5
    ok = (bool((diff <= bound).all()) and bool(torch.isfinite(yk).all())
          and torch.equal(rounded[small], lut_int[small])
          and torch.equal(rounded[near], lut_int[near]))
    return ok, dict(max_diff=float(diff.max()), bound=float(bound.max()),
                    of_bound=share_of(torch, diff, bound),
                    small=float(small.double().mean()),
                    near=float(near.double().mean()),
                    same=float((rounded == lut_int).double().mean()))


def hold_err_matmul(torch, check, label, a, w, yk, yp, lut_int, acu):
    """Kernel 13 against its plain version (:func:`err_matmul_holds`),
    checked. Returns the largest difference."""
    ok, st = err_matmul_holds(torch, a, w, yk, yp, lut_int, acu)
    (m, k), n = a.shape, w.shape[1]
    check(ok, f"err_matmul {label} {m}x{k}x{n}: max |diff| "
              f"{st['max_diff']:.3e} within the summation bound (up to "
              f"{st['bound']:.3e}; at most {st['of_bound']:.2e} of it); "
              f"round(y) == lut_matmul where it is below 0.5 "
              f"({st['small']:.4f} of elements) and where the LUT agreement "
              f"bound is ({st['near']:.4f}); {st['same']:.6f} of all "
              f"elements round to lut_matmul")
    return st["max_diff"]


def ladder_phase(torch, np, dev, check, ops, launches, params, images):
    """Table 4's emulation-mode ladder on ResNet-20, one wave per row.
    Returns ms per wave by row."""
    import dataclasses
    from repro_torch.core import ApproxConfig, make_acu
    from repro_torch.models.vision import resnet_forward
    from repro_torch.serve.engine import VisionServeEngine

    lut = make_acu(MULT, "lut")
    cfgs = {
        "native": None,
        "baseline_lut": ApproxConfig(acu=dataclasses.replace(lut,
                                                             lut_chunk=0)),
        "adapt_lut_fused": ApproxConfig(acu=make_acu(
            MULT, "lut", use_kernels=True, fused=True)),
        "adapt_lut_unfused": ApproxConfig(acu=make_acu(MULT, "lut",
                                                       use_kernels=True)),
        "functional": ApproxConfig(acu=make_acu(MULT, "functional")),
        "lowrank_r8": ApproxConfig(acu=make_acu(MULT, "lowrank", rank=RANK,
                                                use_kernels=True)),
        "quant_only": ApproxConfig(acu=make_acu("mul8s_exact", "exact")),
    }
    wave = images[:BATCH]
    ms, logits, engines = {}, {}, {}
    print(f"Table 4 ladder: ResNet-20 (width 16, 3 blocks/stage), one wave "
          f"of {BATCH} images per row, {MULT}:")
    for name, acfg in cfgs.items():
        eng = engines[name] = VisionServeEngine(
            params, resnet_forward, slots=BATCH, acfg=acfg, device=dev)
        eng.run(wave)                                  # warm-up wave
        torch.cuda.synchronize()
        for op in ops.values():
            op.launches = 0
        t0 = time.perf_counter()
        logits[name] = eng.run(wave)                   # ends in a copy out
        ms[name] = (time.perf_counter() - t0) * 1e3
        counts = {k: op.launches for k, op in ops.items()}
        want = {k: LADDER_LAUNCHES.get(name, {}).get(k, 0) for k in ops}
        check(counts == want and logits[name].shape == (BATCH, 10)
              and bool(np.isfinite(logits[name]).all()),
              f"{name}: {ms[name]:.3f} ms per wave, finite logits, launch "
              f"counts {LADDER_LAUNCHES.get(name, 'none')}")
        for k in ops:
            launches[k] += counts[k]
    base = ms["baseline_lut"]
    print("  model,mode,ms_per_wave,speedup_vs_baseline_lut")
    for name in cfgs:
        print(f"  ResNet-20,{name},{ms[name]:.3f},{base / ms[name]:.2f}x")
    same = [np.array_equal(logits["baseline_lut"], logits[k])
            for k in ("adapt_lut_fused", "adapt_lut_unfused", "functional")]
    check(all(same), "baseline_lut, adapt_lut_fused, adapt_lut_unfused and "
                     "functional give the same logits bit for bit")
    lr, lu = logits["lowrank_r8"], logits["baseline_lut"]
    print(f"  lowrank_r8 vs the LUT rows: largest logit difference "
          f"{np.abs(lr - lu).max():.3e} of max |logit| {np.abs(lu).max():.3e},"
          f" argmax agrees on {(lr.argmax(-1) == lu.argmax(-1)).mean():.4f}")
    for name in ("functional", "lowrank_r8", "quant_only"):
        profile(torch, f"{name} wave", lambda: engines[name].run(wave),
                ms[name])

    small = images[:4]
    cpu_params = {k: v.cpu() for k, v in params.items()}
    for name in ("quant_only", "lowrank_r8"):
        on_gpu = VisionServeEngine(params, resnet_forward, slots=4,
                                   acfg=cfgs[name], device=dev).run(small)
        on_cpu = VisionServeEngine(cpu_params, resnet_forward, slots=4,
                                   acfg=cfgs[name], device="cpu").run(small)
        diff = float(np.abs(on_gpu - on_cpu).max())
        if name == "quant_only":
            check(np.array_equal(on_gpu, on_cpu),
                  "quant_only: a 4-image batch gives the CPU's logits bit "
                  "for bit")
        else:
            top = float(np.abs(on_cpu).max())
            check(diff <= LOWRANK_LOGIT_TOL * top,
                  f"lowrank_r8: a 4-image batch within "
                  f"{LOWRANK_LOGIT_TOL:.0e} of the largest |logit| of the "
                  f"CPU's (largest difference {diff:.3e} of {top:.3e}; "
                  f"{int((on_gpu != on_cpu).sum())} of {on_gpu.size} "
                  f"logits differ)")
    return ms


def table2_phase(torch, np, dev, check):
    """Table 2's accuracy arc, as ``benchmarks/table2_accuracy.py``
    defines it, on the card. Returns its CSV rows."""
    from repro_torch.core import ApproxConfig, make_acu
    from repro_torch.data.pipeline import blob_task, image_task, text_cls_task
    from repro_torch.models.rnn import init_lstm, lstm
    from repro_torch.models.vision import (cnn_forward, init_cnn, init_resnet,
                                           init_squeezenet, init_vae,
                                           resnet_forward, squeezenet_forward,
                                           vae_forward, vae_loss)
    from repro_torch.optim.adamw import SGD, AdamW
    from repro_torch.train.trainer import Trainer, TrainerConfig

    def approx(name):
        if name == "mul12s_2KM":
            return ApproxConfig(acu=make_acu("mul12s_2KM", "functional"),
                                a_bits=12, w_bits=12)
        mult = "mul8s_bam8" if name == "mul8s_hiMRE_bam8" else name
        return ApproxConfig(acu=make_acu(mult, "lut", use_kernels=True,
                                         fused=True))

    def quant(name):
        if name == "mul12s_2KM":
            return ApproxConfig(acu=make_acu("mul12s_exact", "exact"),
                                a_bits=12, w_bits=12)
        return ApproxConfig(acu=make_acu("mul8s_exact", "exact"))

    def xent(logits, labels):
        logz = torch.logsumexp(logits, -1)
        gold = torch.gather(logits, -1, labels[:, None])[:, 0]
        return (logz - gold).mean()

    def on_dev(v, long=False):
        t = torch.from_numpy(np.asarray(v)).to(dev)
        return t.long() if long else t

    fits = []

    def fit(loss_fn, params, opt, batches, steps, what):
        """``steps`` optimizer steps from a copy of ``params``."""
        trainer = Trainer(loss_fn, opt, TrainerConfig(log_every=1))
        p = {k: v.detach().clone() for k, v in params.items()}
        p, _ = trainer.fit(p, opt.init(p), batches, steps)
        losses = [h["loss"] for h in trainer.history if "loss" in h]
        fits.append(len(losses) == steps and bool(np.isfinite(losses).all()))
        if not fits[-1]:
            print(f"  {what}: a non-finite loss (last {losses[-1:]})")
        return p

    def arc(label, params, acc, retrain):
        fp32 = acc(params, None)
        rows = []
        for name in T2_ACUS:
            q, a = acc(params, quant(name)), acc(params, approx(name))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p2 = retrain(params, approx(name), f"{label} {name} retraining")
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            r = acc(p2, approx(name))
            rows.append(f"{label},{name},{fp32:.3f},{q:.3f},{a:.3f},{r:.3f},"
                        f"{dt:.1f}")
            print(f"  {rows[-1]}", flush=True)
        return rows

    def classification(label, fwd, init, task):
        def loss(acfg):
            return lambda p, b: xent(fwd(p, on_dev(b["image"]), acfg),
                                     on_dev(b["label"], long=True))

        def acc(p, acfg):
            ev, correct = task(64, seed=99), 0
            with torch.inference_mode():
                for _ in range(4):
                    b = next(ev)
                    pred = fwd(p, on_dev(b["image"]), acfg).argmax(-1)
                    correct += int((pred.cpu().numpy() == b["label"]).sum())
            return correct / (4 * 64)

        params = fit(loss(None), init(), AdamW(lr=3e-3, weight_decay=0.0),
                     task(64, seed=1), 200, f"{label} pre-training")
        return arc(label, params, acc, lambda p, acfg, what: fit(
            loss(acfg), p, SGD(lr=1e-3, momentum=0.9), task(64, seed=2), 60,
            what))

    task16 = image_task(n_classes=10, size=16)
    t16 = lambda b, seed=1: task16(b, noise=1.8, seed=seed)
    rows = ["model,acu,fp32,quant,approx,retrained,retrain_s"]
    print("Table 2 arc (" + rows[0] + "):")
    rows += classification(
        "CNN-vgg", cnn_forward,
        lambda: init_cnn(0, n_classes=10, width=8, in_ch=3, img=16,
                         device=dev), t16)
    rows += classification(
        "ResNet-mini", lambda p, x, a=None: resnet_forward(p, x, a,
                                                           n_blocks=3),
        lambda: init_resnet(0, n_classes=10, width=8, n_blocks=3,
                            device=dev), t16)
    rows += classification(
        "SqueezeNet-fire", squeezenet_forward,
        lambda: init_squeezenet(0, n_classes=10, width=8, device=dev), t16)

    # LSTM text classification
    text = text_cls_task(vocab=200, n_classes=2)
    gen = torch.Generator().manual_seed(0)
    emb = (torch.randn((200, 16), generator=gen) * 0.3).to(dev)
    p0 = init_lstm(0, 16, 32, device=dev)
    p0["head"] = (torch.randn((32, 2), generator=gen) * 0.2).to(dev)
    p0["head_b"] = torch.zeros(2, device=dev)

    def lstm_fwd(p, toks, acfg):
        return lstm(emb[toks], p, acfg) @ p["head"] + p["head_b"]

    def lstm_train(p, acfg, steps, lr, what):
        return fit(lambda q, b: xent(lstm_fwd(q, on_dev(b["tokens"], True),
                                              acfg),
                                     on_dev(b["label"], long=True)),
                   p, AdamW(lr=lr, weight_decay=0.0),
                   text(32, seq=24, seed=3), steps, what)

    def lstm_acc(p, acfg):
        ev, correct = text(64, seq=24, seed=99), 0
        with torch.inference_mode():
            for _ in range(3):
                b = next(ev)
                pred = lstm_fwd(p, on_dev(b["tokens"], True), acfg).argmax(-1)
                correct += int((pred.cpu().numpy() == b["label"]).sum())
        return correct / (3 * 64)

    p0 = lstm_train(p0, None, 100, 3e-3, "LSTM-textcls pre-training")
    rows += arc("LSTM-textcls", p0, lstm_acc,
                lambda p, acfg, what: lstm_train(p, acfg, 30, 3e-4, what))

    # VAE on blobs: reconstruction accuracy, 1 - mean binary error
    blobs = blob_task()

    def noise(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def vae_batches(seed):
        for i, b in enumerate(blobs(64, seed=seed)):
            yield {"image": b["image"], "step": i}

    def vae_train(p, acfg, steps, lr, what):
        return fit(lambda q, b: vae_loss(q, on_dev(b["image"]),
                                         noise(b["step"]), acfg),
                   p, AdamW(lr=lr, weight_decay=0.0), vae_batches(4), steps,
                   what)

    def vae_acc(p, acfg):
        x = on_dev(next(blobs(128, seed=99))["image"])
        with torch.inference_mode():
            recon, _, _ = vae_forward(p, x, noise(0), acfg)
        return float(1.0 - ((recon > 0.5).float() - x).abs().mean())

    pv = vae_train(init_vae(0, d_in=784, d_h=128, d_z=16, device=dev), None,
                   80, 1e-3, "VAE-blobs pre-training")
    rows += arc("VAE-blobs", pv, vae_acc,
                lambda p, acfg, what: vae_train(p, acfg, 20, 3e-4, what))
    check(all(fits), f"Table 2: every loss finite in all {len(fits)} "
                     f"pre-training and retraining runs")
    return rows


def lm_train_phase(torch, np, dev, check, acu, ops, launches, lookups_per_s,
                   lut_bytes, n_sm) -> dict:
    """SmolLM-135M trained through ``loss_fn`` at full width and depth
    (``launch/train.py``'s configuration): kernels 2 and 3 bitwise at every
    GEMM shape of a training step and kernel 4 at every dense gradient
    shape of an ``approx_bwd`` step, each timed; a step run twice from
    one state (gradients bitwise equal); an uninterrupted run with async
    checkpoints, the same run with failures planted between checkpoints
    and a fresh restart, bitwise equal with exactly the planted restores;
    a damped run whose ``accum`` grows, resumed mid-schedule bitwise;
    launch counts per step; steps/s and tokens/s in both regimes, a
    profile of one step, peak memory, checkpoint bytes and save and restore
    seconds; the card against the CPU on a two-layer cut. Returns the
    numbers for the summary."""
    import dataclasses
    import gc
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.core import (ApproxConfig, acu_operand,
                                  inline_symmetric_scale, quantize,
                                  symmetric_qparams)
    from repro_torch.data.pipeline import MarkovLM, Prefetcher
    from repro_torch.kernels.fused_lut_dense.ops import bwd_plan
    from repro_torch.kernels.fused_lut_dense.ref import (fused_lut_bwd_ref,
                                                         fused_lut_dense_ref)
    from repro_torch.kernels.quantize.ref import quantize_ref
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import SGD, AdamW, cosine_schedule
    from repro_torch.optim.damping import DampingConfig
    from repro_torch.train import checkpoint as ckpt_lib
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import leaves, leaves_with_names, tree_map

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    base = get_config(LM_ARCH)
    cfg = dataclasses.replace(base, vocab_size=min(base.vocab_size, 4096),
                              vocab_pad_mult=16)
    B, S = TRAIN_LM_BATCH, TRAIN_LM_SEQ
    M = B * S
    dm, ff, V = cfg.d_model, cfg.d_ff, cfg.vocab_padded
    qd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    L = cfg.n_layers
    gen = torch.Generator(device=dev)
    gen.manual_seed(31)
    lut16 = acu.device_lut(dev)
    lut32 = torch.from_numpy(acu.lut.reshape(-1)).to(dev)
    off, n_codes = acu.offset, acu.multiplier.n_codes
    print(f"training SmolLM-135M ({L} layers, d {dm}, {cfg.n_heads} heads "
          f"over {cfg.n_kv_heads}, d_ff {ff}, vocab cut to {cfg.vocab_size} "
          f"(padded {V}) as launch/train.py cuts it, bf16) through loss_fn, "
          f"{MULT} fused ACU, batch {B} x {S} tokens:")

    # -- kernels 2 and 3 at the forward's GEMM shapes ----------------------
    print(f"  quantize and fused_lut_dense at every GEMM shape of a training "
          f"step (M = {M}): a bfloat16 weight through quantize per output "
          f"channel (the head: the embedding's transposed view, as tied "
          f"embeddings run it) and fused_lut_dense on a bfloat16 "
          f"activation, bitwise on the plain versions; times per call:")
    per_layer = {"q": 1, "k/v": 2, "o": 1, "gate/up": 2, "down": 1}
    gemms = [("q", dm, qd), ("k/v", dm, kvd), ("o", qd, dm),
             ("gate/up", dm, ff), ("down", ff, dm), ("head", dm, V)]
    times = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, lib_ms=0.0)
             for k in ("quantize", "fused_lut_dense", "fused_lut_bwd")}

    def add(name, n, ms, pms, bound, lib):
        t = times[name]
        t["ms"] += n * ms
        t["plain_ms"] += n * pms
        t["bound_ms"] += n * bound
        t["lib_ms"] += n * lib

    for label, kk, nn in gemms:
        n = 1 if label == "head" else L * per_layer[label]
        if label == "head":
            w = (torch.randn((nn, kk), generator=gen, device=dev)
                 * kk ** -0.5).to(torch.bfloat16).t()
        else:
            w = (torch.randn((kk, nn), generator=gen, device=dev)
                 * kk ** -0.5).to(torch.bfloat16)
        x = torch.randn((M, kk), generator=gen, device=dev).to(torch.bfloat16)
        xqp = symmetric_qparams(torch.clamp_min(x.abs().amax(), 1e-6), 8)
        wqp = symmetric_qparams(torch.clamp_min(w.abs().amax(dim=0), 1e-9),
                                8, axis=1)
        sc, zp = wqp.scale.reshape(1, -1), wqp.zero_point.reshape(1, -1)
        codes = quantize(w, wqp)                     # kernel 2
        same_codes = torch.equal(codes, quantize_ref(w, sc, zp))
        wq = acu_operand(codes, wqp)
        args = (xqp.scale, xqp.zero_point, wqp.scale)
        dense_k = lambda: ops["fused_lut_dense"](x, wq, lut16, off, *args)
        dense_p = lambda: fused_lut_dense_ref(x, wq, lut32, off, n_codes,
                                              *args)
        yk, yp = dense_k(), dense_p()
        check(same_codes and torch.equal(yk, yp),
              f"{label}: quantize ({kk}, {nn}) bfloat16 weight codes"
              f"{' (a transposed view)' if label == 'head' else ''} and "
              f"fused_lut_dense {M}x{kk}x{nn} bitwise equal to the plain "
              f"versions")
        q_ms = cuda_ms(torch, lambda: quantize(w, wqp), 20)
        q_pms = cuda_ms(torch, lambda: quantize_ref(w, sc, zp), 2, warm=1)
        wf32, zi = w.float(), torch.zeros(nn, dtype=torch.int64, device=dev)
        q_lib = cuda_ms(torch, lambda: torch.quantize_per_channel(
            wf32, wqp.scale.reshape(-1), zi, 1, torch.qint8), 10)
        q_bound = (kk * nn * 6 + nn * 8) / HBM_BYTES_PER_S * 1e3
        add("quantize", n, q_ms, q_pms, q_bound, q_lib)
        d_ms = cuda_ms(torch, dense_k, 10)
        d_pms = cuda_ms(torch, dense_p, 2, warm=1)
        xf, wqf = x.float(), wq.float()
        d_lib = cuda_ms(torch, lambda: torch.matmul(xf, wqf), 10)
        d_bound = max(M * kk * nn / lookups_per_s,
                      (M * kk * 2 + kk * nn * 4 + lut_bytes + M * nn * 4)
                      / HBM_BYTES_PER_S) * 1e3
        add("fused_lut_dense", n, d_ms, d_pms, d_bound, d_lib)
        print(f"    {label:8s} x{n}: quantize {q_ms:.4f} ms (plain "
              f"{q_pms:.3f}, torch.quantize_per_channel f32 {q_lib:.4f}, "
              f"bytes bound {q_bound:.4f}); fused_lut_dense {d_ms:.4f} ms "
              f"(plain {d_pms:.2f}, torch.matmul f32 {d_lib:.4f}, lookup "
              f"bound {d_bound:.4f})", flush=True)
        del w, x, codes, wq, yk, yp, xf, wqf, wf32

    # -- kernel 4 at the dense gradient shapes of an approx_bwd step -------
    print(f"  fused_lut_bwd at every dense gradient shape of an approx_bwd "
          f"step, operands as the STE passes them (g, wf.T; xf.T, g; "
          f"per-tensor scales on the full tensors), float32 bitwise on the "
          f"plain version; times per call:")
    grads = [  # label, K_in, N_out, calls per step
        ("q/o", dm, qd, 2 * L), ("k/v", dm, kvd, 2 * L),
        ("gate/up", dm, ff, 2 * L), ("down", ff, dm, L), ("head", dm, V, 1)]
    for label, kin, nout, n in grads:
        g = torch.randn((M, nout), generator=gen, device=dev) * 1e-3
        wf = torch.randn((kin, nout), generator=gen, device=dev) * kin ** -0.5
        xf = torch.randn((M, kin), generator=gen, device=dev)
        sym = lambda t: inline_symmetric_scale(t.abs().amax(), 8)
        sg, sw, sx = sym(g), sym(wf), sym(xf)
        for which, a, b, sa, sb in (("gx", g, wf.t(), sg, sw),
                                    ("gw", xf.t(), g, sx, sg)):
            (mm, kk), nn = a.shape, b.shape[1]
            kern = lambda: ops["fused_lut_bwd"](a, b, lut16, off, sa, sb)
            plain = lambda: fused_lut_bwd_ref(a, b, lut32, off, n_codes, sa,
                                              sb)
            check(torch.equal(kern(), plain()),
                  f"fused_lut_bwd {label} {which} {mm}x{kk}x{nn}: float32 "
                  f"bitwise equal to the plain version; plan "
                  + bwd_plan(mm, kk, nn, n_sm, n_codes).describe())
            ms = cuda_ms(torch, kern, 10)
            pms = cuda_ms(torch, plain, 2, warm=1)
            ac, bc = a.contiguous(), b.contiguous()
            lib = cuda_ms(torch, lambda: torch.matmul(ac, bc), 10)
            bound = max(mm * kk * nn / lookups_per_s,
                        ((mm * kk + kk * nn + mm * nn) * 4 + lut_bytes)
                        / HBM_BYTES_PER_S) * 1e3
            add("fused_lut_bwd", n, ms, pms, bound, lib)
            print(f"    {label:8s} {which} x{n} {mm}x{kk}x{nn}: {ms:.4f} ms "
                  f"(plain {pms:.2f}, torch.matmul f32 {lib:.4f}, lookup "
                  f"bound {bound:.4f})", flush=True)
            del ac, bc
        del g, wf, xf
    torch.cuda.empty_cache()
    for name, t in times.items():
        print(f"  {name} per training step: {t['ms']:.3f} ms (plain "
              f"{t['plain_ms']:.1f}, library {t['lib_ms']:.3f}, bound "
              f"{t['bound_ms']:.3f})")

    # -- the model, its data, the two regimes -------------------------------
    p0 = T.init_params(0, cfg, device=dev)
    n_params = sum(t.numel() for t in leaves(p0))
    lm = MarkovLM(vocab=cfg.vocab_size, seed=0)
    regimes = {"exact": ApproxConfig(acu=acu),
               "approx_bwd": ApproxConfig(acu=acu, approx_bwd=True)}
    n_gemm = 7 * L + 1
    step_plan = {
        "exact": {"fused_lut_dense": n_gemm, "quantize": n_gemm},
        "approx_bwd": {"fused_lut_dense": n_gemm, "quantize": n_gemm,
                       "fused_lut_bwd": 2 * n_gemm}}
    opt = AdamW(lr=cosine_schedule(3e-4, 100, TRAIN_LM_STEPS),
                weight_decay=0.01)

    def loss_of(acfg):
        return lambda p, b: T.loss_fn(p, b["tokens"], b["labels"], cfg, acfg)

    def fresh():
        p = tree_map(torch.clone, p0)
        return p, opt.init(p)

    def data():
        return Prefetcher(lm.batches(B, S), depth=2, device=dev)

    def fit(regime, params, state, n_steps, fail_hook=None, step_hook=None,
            **kw):
        tr = Trainer(loss_of(regimes[regime]), opt,
                     TrainerConfig(log_every=1, **kw))
        it = data()
        try:
            params, state = tr.fit(params, state, it, n_steps,
                                   fail_hook=fail_hook, step_hook=step_hook)
        finally:
            it.close()
        return params, state, tr

    def reset():
        torch.cuda.synchronize()
        for op in ops.values():
            op.launches = 0

    def counted():
        torch.cuda.synchronize()
        counts = {k: op.launches for k, op in ops.items()}
        for k in ops:
            launches[k] += counts[k]
        return counts

    def restores(tr):
        return sum("restored" in h.get("event", "") for h in tr.history)

    def same_state(a, b):
        return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))

    print(f"  {n_params / 1e6:.2f} M parameters (bf16), AdamW("
          f"cosine_schedule(3e-4, 100, {TRAIN_LM_STEPS}), weight_decay=0.01)"
          f" as launch/train.py, data MarkovLM(vocab={cfg.vocab_size}, "
          f"seed=0) through a Prefetcher on the card")

    # -- one step, twice from one state: the step is deterministic ---------
    batch = next(lm.batches(B, S))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    for regime, acfg in regimes.items():
        tr = Trainer(loss_of(acfg), opt)
        p, _ = fresh()
        got = [tr._grads_and_stats(p, batch, 1)[:2] for _ in range(2)]
        names = [n for n, _ in leaves_with_names(got[0][1])]
        differ = [n for n, a, b in zip(names, leaves(got[0][1]),
                                       leaves(got[1][1]))
                  if not torch.equal(a, b)]
        check(not differ and torch.equal(got[0][0], got[1][0]),
              f"{regime}: one step's loss and all {len(names)} gradients "
              f"bitwise equal when run twice from one state"
              + (f" (differ: {', '.join(differ[:6])})" if differ else ""))
        del got, p
    gc.collect()
    torch.cuda.empty_cache()

    # -- warm-up, then the uninterrupted run with async checkpoints --------
    for regime in regimes:
        p, st = fresh()
        fit(regime, p, st, 1)
        del p, st
    # every save and restore the trainer makes, timed where it happens
    io = {"save": [], "restore": []}
    save0, restore0 = ckpt_lib.save, ckpt_lib.restore

    def timed(kind, fn):
        def wrapped(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            if kind == "restore":
                torch.cuda.synchronize()
            io[kind].append(time.perf_counter() - t0)
            return out
        return wrapped

    ckpt_lib.save = timed("save", save0)
    ckpt_lib.restore = timed("restore", restore0)
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    ck = dict(ckpt_every=TRAIN_LM_EVERY, keep=1)
    out = {}
    try:
        torch.cuda.reset_peak_memory_stats()
        p, st = fresh()
        reset()
        t0 = time.perf_counter()
        pa, sa, tra = fit("exact", p, st, TRAIN_LM_STEPS,
                          ckpt_dir=os.path.join(root, "a"), **ck)
        wall_a = time.perf_counter() - t0
        counts = counted()
        peak = torch.cuda.max_memory_allocated() / 2**30
        want = {k: TRAIN_LM_STEPS * step_plan["exact"].get(k, 0)
                for k in ops}
        losses = [h["loss"] for h in tra.history if "loss" in h]
        dts = sorted(h["dt"] for h in tra.history if "dt" in h)
        step_s = dts[len(dts) // 2]
        ckpt_dir_a = os.path.join(root, "a", f"step_{TRAIN_LM_STEPS:08d}")
        ckpt_bytes = sum(os.path.getsize(os.path.join(ckpt_dir_a, f))
                         for f in os.listdir(ckpt_dir_a))
        print(f"  uninterrupted: {TRAIN_LM_STEPS} steps, checkpoints every "
              f"{TRAIN_LM_EVERY} (async), {wall_a:.2f} s wall; losses "
              + " ".join(f"{v:.5f}" for v in losses)
              + f"; median step {step_s * 1e3:.1f} ms; launches "
              f"{ {k: v for k, v in counts.items() if v} }; peak memory "
              f"{peak:.2f} GiB", flush=True)
        check(len(losses) == TRAIN_LM_STEPS
              and bool(np.isfinite(losses).all())
              and restores(tra) == 0 and tra.consumed == TRAIN_LM_STEPS,
              f"uninterrupted run: {TRAIN_LM_STEPS} finite losses, "
              f"{tra.consumed} batches consumed, no restore")
        check(counts == want, f"exact regime: launch counts are "
                              f"{TRAIN_LM_STEPS} x {step_plan['exact']} "
                              f"(kernels 3 and 2 per GEMM: 7 per layer + "
                              f"the head)")

        # -- failures planted between checkpoints: batches replay ----------
        planted = []

        def fail_hook(step):
            if step == TRAIN_LM_FAIL_AT - 1 and len(planted) < 2:
                planted.append(step)
                raise RuntimeError("planted node failure")

        p, st = fresh()
        reset()
        pb, sb, trb = fit("exact", p, st, TRAIN_LM_STEPS, fail_hook,
                          ckpt_dir=os.path.join(root, "b"), **ck)
        counted()
        shutil.rmtree(os.path.join(root, "b"))
        events = [h["event"] for h in trb.history if "event" in h]
        print(f"  failures planted before step {TRAIN_LM_FAIL_AT} (twice): "
              f"history events {events}, consumed {trb.consumed}")
        check(len(planted) == 2 and restores(trb) == 2
              and len(events) == 2 and trb.consumed == tra.consumed
              and same_state((pa, sa), (pb, sb)),
              f"run with 2 planted failures: exactly 2 restores in history, "
              f"parameters, optimizer state and consumed ({trb.consumed}) "
              f"bitwise equal to the uninterrupted run's")
        del pb, sb

        # -- a fresh restart: a new Trainer and a fresh iterator -----------
        p, st = fresh()
        reset()
        fit("exact", p, st, TRAIN_LM_STEPS // 2,
            ckpt_dir=os.path.join(root, "c"), async_ckpt=False, **ck)
        del p, st
        p, st = fresh()
        pc, sc, trc = fit("exact", p, st, TRAIN_LM_STEPS,
                          ckpt_dir=os.path.join(root, "c"), **ck)
        counted()
        shutil.rmtree(os.path.join(root, "c"))
        check(restores(trc) == 0 and trc.consumed == tra.consumed
              and same_state((pa, sa), (pc, sc)),
              f"fresh restart (new Trainer and iterator from step "
              f"{TRAIN_LM_STEPS // 2}): parameters, optimizer state and "
              f"consumed bitwise equal to the uninterrupted run's")
        del pc, sc, pa, sa
        shutil.rmtree(os.path.join(root, "a"))

        # -- batch damping, resumed mid-schedule -------------------------
        dcfg = DampingConfig(**TRAIN_LM_DAMPING)
        p, st = fresh()
        reset()
        pd, sd, trd = fit("exact", p, st, TRAIN_LM_DAMPED_STEPS,
                          damping=dcfg)
        counted()
        accums = [h["accum"] for h in trd.history if "accum" in h]
        bn = [h["b_noise"] for h in trd.history if "b_noise" in h]
        dtext = ", ".join(f"{k}={v}" for k, v in TRAIN_LM_DAMPING.items())
        print(f"  damped (DampingConfig({dtext})): accum after each step "
              f"{accums}, b_noise " + " ".join(f"{v:.1f}" for v in bn)
              + f", consumed {trd.consumed}")
        check(accums == sorted(accums) and accums[-1] > 1
              and trd.consumed > TRAIN_LM_DAMPED_STEPS,
              f"damped run: accum grows ({accums}), {trd.consumed} batches "
              f"for {TRAIN_LM_DAMPED_STEPS} steps")
        planted.clear()
        p, st = fresh()
        reset()
        pe, se, tre = fit("exact", p, st, TRAIN_LM_DAMPED_STEPS, fail_hook,
                          ckpt_dir=os.path.join(root, "d"), damping=dcfg,
                          **ck)
        counted()
        shutil.rmtree(os.path.join(root, "d"))
        check(restores(tre) == 2 and tre.consumed == trd.consumed
              and tre.damp_state == trd.damp_state
              and same_state((pd, sd), (pe, se)),
              f"damped run with 2 planted failures after step "
              f"{TRAIN_LM_EVERY}'s checkpoint: schedule "
              f"{tre.damp_state.accum}, consumed {tre.consumed}, parameters "
              f"and optimizer state bitwise equal to the damped run's")
        del pd, sd, pe, se
    finally:
        ckpt_lib.save, ckpt_lib.restore = save0, restore0
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  checkpoints: {ckpt_bytes / 1e9:.3f} GB each "
          f"({n_params} bf16 parameters and two float32 moments); "
          f"{len(io['save'])} saves took "
          + ", ".join(f"{v:.2f}" for v in io["save"])
          + f" s (async ones off the step's path); {len(io['restore'])} "
          f"restores " + ", ".join(f"{v:.2f}" for v in io["restore"]) + " s")

    # -- throughput in both regimes, and a profile of one step -------------
    # the trainer reads each step's loss back (float(loss)), so a step has
    # ended on the card when step_hook runs; the window is the wall clock
    # from the end of the first step to the end of the last, batch draws
    # included
    rates = {}
    n_run = 1 + TRAIN_LM_WINDOW
    for regime in regimes:
        p, st = fresh()
        ends = []
        reset()
        p, st, tr = fit(regime, p, st, n_run,
                        step_hook=lambda *_: ends.append(time.perf_counter()))
        counts = counted()
        want = {k: n_run * step_plan[regime].get(k, 0) for k in ops}
        wall = ends[-1] - ends[0]
        step_s = wall / TRAIN_LM_WINDOW
        dts = sorted(h["dt"] for h in tr.history[1:])
        rates[regime] = (1 / step_s, M / step_s)
        check(counts == want and len(ends) == n_run,
              f"{regime}: launch counts are {n_run} x {step_plan[regime]}")
        it = data()
        trp = Trainer(loss_of(regimes[regime]), opt)
        _, wall_ms, rows = profile(
            torch, f"SmolLM-135M training step ({regime})",
            lambda: trp.fit(p, st, it, 1), step_s * 1e3)
        it.close()
        busy = sum(r[1] for r in rows)
        rates[regime] += (busy, 1 - busy / (step_s * 1e3) if rows else None)
        print(f"  {regime}: {rates[regime][0]:.3f} steps/s, "
              f"{rates[regime][1]:.0f} trained tokens/s ({TRAIN_LM_WINDOW} "
              f"steps in {wall:.3f} s wall after one to start; the steps' "
              f"own times min {dts[0] * 1e3:.1f}, median "
              f"{dts[len(dts) // 2] * 1e3:.1f}, max {dts[-1] * 1e3:.1f} ms)",
              flush=True)
        del p, st
    gc.collect()
    torch.cuda.empty_cache()

    # -- the card against the CPU on a two-layer cut -----------------------
    cut = dataclasses.replace(cfg, n_layers=TRAIN_LM_CPU_LAYERS,
                              dtype="float32")
    small = T.init_params(1, cut, device=dev)
    small_cpu = T.map_cache(lambda t: t.cpu(), small)
    res = {}
    for where, p, lr in (("cuda", small, TRAIN_LM_CPU_LR),
                         ("cpu", small_cpu, TRAIN_LM_CPU_LR),
                         ("cpu, lr x1.001 (planted)", small_cpu,
                          TRAIN_LM_CPU_LR * 1.001)):
        d = "cpu" if where.startswith("cpu") else dev
        q = tree_map(torch.clone, p)
        sgd = SGD(lr=lr, clip_norm=1.0)
        tr = Trainer(lambda pp, b: T.loss_fn(pp, b["tokens"], b["labels"],
                                             cut), sgd,
                     TrainerConfig(log_every=1))
        it = Prefetcher(lm.batches(TRAIN_LM_CPU_BATCH, TRAIN_LM_CPU_SEQ),
                        device=d)
        q, _ = tr.fit(q, sgd.init(q), it, TRAIN_LM_CPU_STEPS)
        it.close()
        res[where] = ([h["loss"] for h in tr.history],
                      [t.cpu() for t in leaves(q)])
    lc, pc = res["cpu"]
    eps = float(np.finfo(np.float32).eps)
    limits = [SCORE_CPU_TOL * float((a - b.cpu()).abs().max())
              + TRAIN_LM_CPU_STEPS * eps * a.abs()
              for a, b in zip(pc, leaves(small_cpu))]

    names = [n for n, _ in leaves_with_names(small_cpu)]

    def dist(run):
        """Largest loss difference (relative) and largest parameter
        difference over its limit (and its leaf), against the CPU's run."""
        l, ps = res[run]
        dl = max(abs(a - b) / abs(b) for a, b in zip(l, lc))
        dp, worst = max((float(((a - b).abs() / lim).max()), n)
                        for a, b, lim, n in zip(ps, pc, limits, names))
        return dl, dp, worst

    dl, dp, worst = dist("cuda")
    fl, fp, _ = dist("cpu, lr x1.001 (planted)")
    print(f"  card against CPU on {TRAIN_LM_CPU_LAYERS} layers, float32, no "
          f"ACU, {TRAIN_LM_CPU_STEPS} SGD steps (lr {TRAIN_LM_CPU_LR}, "
          f"clip 1.0) at batch {TRAIN_LM_CPU_BATCH} x {TRAIN_LM_CPU_SEQ}: "
          f"losses {' '.join(f'{v:.6f}' for v in res['cuda'][0])} (CPU "
          f"{' '.join(f'{v:.6f}' for v in lc)}); largest loss difference "
          f"{dl:.3e} relative; largest parameter difference {dp:.3f} of its "
          f"limit (in {worst}; {SCORE_CPU_TOL:.0e} of the leaf's largest "
          f"update + "
          f"{TRAIN_LM_CPU_STEPS} float32 roundings of the parameter); "
          f"planted lr x1.001 on the CPU reads {fl:.3e} / {fp:.3f}")
    check(dl <= SCORE_CPU_TOL and dp <= 1.0,
          f"two-layer cut: losses within {SCORE_CPU_TOL:.0e} and parameters "
          f"within their limits after {TRAIN_LM_CPU_STEPS} steps, card "
          f"against CPU")
    check(fp > 1.0, "the planted fault lies beyond the parameters' limits")
    del small, small_cpu, res, p0
    gc.collect()
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    print(f"LM training phase: {seconds:.1f} s")
    return {"rates": rates, "times": times, "peak_gib": peak,
            "ckpt_bytes": ckpt_bytes, "save_s": io["save"],
            "restore_s": io["restore"], "accums": accums,
            "seconds": seconds}


def roofline_cut(shape_name: str, acu_spec):
    """One roofline cell's batch cut, counted on ``meta`` with no device:
    the largest power-of-two batch (at most the shape's) whose counted step
    fits ROOFLINE_MEM and ROOFLINE_LB_S, or batch 1 when none does.
    Returns the batch, its ``CellCost`` and whether it fits.
    ``start_roofline_cuts`` runs it in a worker process. The counts grow with the batch, and b rows
    cost at most b times one row (the weights are shared), so the search
    climbs from the largest batch that bound admits."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import roofline as R
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.specs import build_step, make_acfg
    cfg, shape = get_config(ROOFLINE_ARCH), SHAPES[shape_name]
    acfg = make_acfg(acu_spec)

    def count(b):
        cost = R.count_step(build_step(cfg, dataclasses.replace(
            shape, global_batch=b), make_host_mesh(), acfg=acfg))
        return b, cost, (cost.peak_memory <= ROOFLINE_MEM
                         and cost.step_time <= ROOFLINE_LB_S)

    best = one = count(1)
    b = 1
    while 2 * b <= shape.global_batch and \
            2 * b * one[1].peak_memory <= ROOFLINE_MEM and \
            2 * b * one[1].step_time <= ROOFLINE_LB_S:
        b *= 2
    if b > 1:
        best = count(b)
    while best[2] and 2 * best[0] <= shape.global_batch:
        nxt = count(2 * best[0])
        if not nxt[2]:
            break
        best = nxt
    return best


def roofline_rates(torch, dev, R, card: str) -> tuple[float, float]:
    """The card's achieved bf16 ``torch.matmul`` rate (8192^3) and device
    copy bandwidth, printed beside the data-sheet constants; returns both
    (FLOP/s, B/s). Never used as a denominator."""
    n = 8192
    a = torch.randn((n, n), device=dev, dtype=torch.bfloat16)
    b = torch.randn((n, n), device=dev, dtype=torch.bfloat16)
    mm_rate = 2 * n ** 3 / (cuda_ms(torch, lambda: torch.matmul(a, b), 10)
                            / 1e3)
    src = torch.empty(2 ** 30, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    copy_rate = 2 * src.numel() / (cuda_ms(torch, lambda: dst.copy_(src), 10)
                                   / 1e3)
    del a, b, src, dst
    print(f"  roofline ({card}): achieved bf16 torch.matmul (8192^3) "
          f"{mm_rate / 1e12:.1f} TFLOP/s against the data sheet's "
          f"{R.PEAK_BF16 / 1e12:.0f}; device copy {copy_rate / 1e12:.3f} TB/s "
          f"(read + write) against HBM {R.HBM_BW / 1e12:.2f} TB/s; printed "
          f"only, the shares below use the data sheet's")
    return mm_rate, copy_rate


def roofline_cell(torch, dev, check, ops, launches, card, name, acu_spec,
                  cut, t_cell) -> tuple[str, dict]:
    """One cell of ``roofline_phase`` at its batch cut ``cut`` (from
    :func:`roofline_cut`): the step checked against the direct call, two
    warm-up steps, ROOFLINE_STEPS timed; returns its label and figures."""
    import statistics
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import roofline as R
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.specs import build_step, make_acfg, materialize
    from repro_torch.models import transformer as T

    bsz, cost, fits = cut
    cfg = get_config(ROOFLINE_ARCH)
    acfg = make_acfg(acu_spec)
    label = name + (f" --acu {acu_spec}" if acu_spec else "")
    shape = SHAPES[name]
    bundle = build_step(cfg, dataclasses.replace(shape, global_batch=bsz),
                        make_host_mesh(), acfg=acfg)
    sh = bundle.shape
    print(f"  {label}: global batch cut {shape.global_batch} -> "
          f"{sh.global_batch} at seq_len {sh.seq_len} (counted peak "
          f"{cost.peak_memory / 2**30:.2f} GiB, bound "
          f"{cost.step_time * 1e3:.2f} ms; limits "
          f"{ROOFLINE_MEM / 2**30:.0f} GiB, {ROOFLINE_LB_S * 1e3:.0f} "
          f"ms" + ("" if fits else ": batch 1 passes them, run all the "
                   "same") + f"; {time.perf_counter() - t_cell:.1f} s to "
          f"the count)")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    args = materialize(bundle, dev, seed=0)
    params = args[0]
    # the direct call, before the step writes anything in place
    with torch.no_grad():
        if sh.kind == "train":
            n_micro = bundle.fn.n_micro
            mb = sh.global_batch // n_micro
            nm = torch.tensor(float(n_micro), device=dev)
            want = torch.zeros((), dtype=torch.float32, device=dev)
            for j in range(n_micro):
                tk, lb = (t[j * mb:(j + 1) * mb] for t in args[2:4])
                li = T.loss_fn(params, tk, lb, cfg, acfg)
                want = li if n_micro == 1 else want + li / nm
        elif sh.kind == "prefill":
            cache = T.init_cache(cfg, sh.global_batch, sh.seq_len,
                                 device=dev)
            want = T.apply_model(params, args[2], cfg, acfg=acfg,
                                 cache=cache, cache_pos=0,
                                 last_only=True)[0][:, -1]
            del cache
    if sh.kind == "train":
        got = bundle.fn(*args)[2]
        what = "loss equal to loss_fn on its microbatches"
    elif sh.kind == "prefill":
        got = bundle.fn(*args)[0]
        what = "last logits equal to apply_model's"
    else:
        got = bundle.fn(*args)[0]
        with torch.no_grad():
            want = T.apply_model(params, args[2], cfg, acfg=acfg,
                                 cache=args[1], cache_pos=args[3],
                                 decode=True)[0][:, -1]
        what = "logits equal to apply_model's at the same position"
    check(torch.equal(got, want) and bool(torch.isfinite(got).all()),
          f"roofline {label}: the step's {what}, bitwise, finite")
    del got, want
    # two warm-up steps: the checked one, and one with the launch
    # counters read around it
    per_step = count_launches(ops, lambda: bundle.fn(*args))[1]
    if acfg is not None:
        for k in per_step:
            launches[k] += per_step[k]
        counted = {k: v["calls"] for k, v in cost.kernels.items()}
        ran = {k: v for k, v in per_step.items() if v}
        check(ran == counted and all(ran.get(k) for k in (
            "quantize", "fused_lut_dense", "approx_flash_attention")),
              f"roofline {label}: launches per step {ran} equal to the "
              f"count's calls {counted} (kernels 2, 3 and 8)")
    times = []
    for _ in range(ROOFLINE_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        bundle.fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    ms = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    mf = R.model_flops(cfg, sh, 1)
    share = cost.step_time / (ms / 1e3)
    floor_share = cost.step_time_min / (ms / 1e3)
    mfu = mf / (R.PEAK_BF16 * ms / 1e3)
    line = (f"  {label} ({card}; batch {sh.global_batch}"
            + (f", {bundle.fn.n_micro} microbatches" if sh.kind == "train"
               else "")
            + f"): median {ms:.2f} ms of {ROOFLINE_STEPS} steps ("
            + ", ".join(f"{t:.2f}" for t in times)
            + f"); counted t_compute {cost.t_compute * 1e3:.3f} ms, "
            f"t_memory {cost.t_memory * 1e3:.3f} ms -> {cost.bottleneck}, "
            f"step_time_lb {cost.step_time * 1e3:.3f} ms; flops "
            f"{cost.flops:.4g}, bytes {cost.bytes_accessed:.4g}, lookups "
            f"{cost.lookups:.4g}; model_flops {mf:.4g}; roofline_share "
            f"{share:.4f}, MFU {mfu:.5f}; algorithmic floor "
            f"step_time_min {cost.step_time_min * 1e3:.3f} ms (min_bytes "
            f"{cost.min_bytes:.4g}), floor share {floor_share:.4f}; peak "
            f"memory {peak:.2f} GiB (counted "
            f"{cost.peak_memory / 2**30:.2f})")
    if cost.lookups:
        t_look = cost.lookups / R.GATHER_RATE
        line += (f"; lookups alone {t_look * 1e3:.3f} ms, share "
                 f"{t_look / (ms / 1e3):.4f}")
    print(line + f"; cell {time.perf_counter() - t_cell:.1f} s", flush=True)
    for what, v in (("share", share), ("floor share", floor_share)):
        check(v <= ROOFLINE_SHARE_MAX,
              f"roofline {label}: {what} {v:.4f} <= {ROOFLINE_SHARE_MAX} "
              f"(a share past it means the count is wrong)")
    return label, dict(batch=sh.global_batch, ms=ms, share=share, mfu=mfu,
                       lb_ms=cost.step_time * 1e3,
                       floor_ms=cost.step_time_min * 1e3,
                       floor_share=floor_share, peak_gib=peak,
                       counted_peak_gib=cost.peak_memory / 2 ** 30,
                       bottleneck=cost.bottleneck)


def start_roofline_cuts():
    """Starts counting every roofline cell's batch cut (``roofline_cut``)
    in one worker process, on ``meta`` tensors on the CPU, so that the
    counts are done before ``roofline_phase`` needs them; returns the
    pool and the futures, in ROOFLINE_CELLS' order. The script starts it
    before the build, whose ``nvcc`` processes it shares the host with,
    and it ends before the host-timed phases; ``roofline_phase`` shuts
    the pool down."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor
    pool = ProcessPoolExecutor(1, mp_context=mp.get_context("spawn"))
    return pool, [pool.submit(roofline_cut, *c) for c in ROOFLINE_CELLS]


def roofline_phase(torch, np, dev, check, ops, launches, cuts) -> dict:
    """Whole steps against their counted roofline (item 14 of the module
    docstring), at the batch cuts ``cuts`` (``start_roofline_cuts``).
    Returns the phase's figures by cell."""
    from repro_torch.launch import roofline as R

    t_phase = time.perf_counter()
    pool, futures = cuts
    out = {}
    with pool:
        card = nvidia_smi("name,power.limit")
        mm_rate, copy_rate = roofline_rates(torch, dev, R, card)
        for (name, acu_spec), fut in zip(ROOFLINE_CELLS, futures):
            t_cell = time.perf_counter()
            label, figures = roofline_cell(torch, dev, check, ops, launches,
                                           card, name, acu_spec,
                                           fut.result(), t_cell)
            out[label] = figures
            torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    out["matmul_tflops"] = mm_rate / 1e12
    out["copy_tbps"] = copy_rate / 1e12
    print(f"roofline phase: {out['seconds']:.1f} s")
    return out


def main() -> int:
    # a run cut short (a time limit, a lost machine) shows how far it got
    sys.stdout.reconfigure(line_buffering=True)
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import numpy as np
        from repro_torch.core import (ApproxConfig, acu_operand,
                                      inline_symmetric_scale, make_acu,
                                      quantize, symmetric_qparams)
        from repro_torch.core.approx_ops import _conv_qparams, _im2col
        from repro_torch.core.acu import resolve_conv_padding
        from repro_torch.data.pipeline import image_task
        from repro_torch.kernels import runtime
        import torch.nn.functional as F
        from repro_torch.kernels.fused_lut_conv.ops import (
            conv_out_size, fused_lut_conv, fused_lut_conv_bwd_w,
            fused_lut_conv_tiled, pick_bwd_w_tiling, pick_conv_kernel_tiling)
        from repro_torch.kernels.fused_lut_conv.ref import (
            fused_lut_conv_bwd_w_ref, fused_lut_conv_ref)
        from repro_torch.kernels.fused_lut_dense.ops import (
            bwd_plan, fused_lut_bwd, fused_lut_dense)
        from repro_torch.kernels.fused_lut_dense.ref import (
            fused_lut_bwd_ref, fused_lut_dense_ref)
        from repro_torch.kernels.flash_attention.ops import (
            approx_flash_attention, approx_flash_attention_paged,
            flash_attention)
        from repro_torch.kernels.err_matmul.ops import err_matmul, err_tile
        from repro_torch.kernels.err_matmul.ref import (
            err_matmul_ref, err_matmul_tf32_ref, summation_bound)
        from repro_torch.kernels.fused_lut_grouped.ops import (
            fused_lut_grouped)
        from repro_torch.kernels.lut_matmul.ops import lut_matmul, lut_plan
        from repro_torch.kernels.lut_matmul.ref import lut_matmul_ref
        from repro_torch.kernels.quantize.ops import (
            quantize as quantize_kernel)
        from repro_torch.kernels.wkv.ops import wkv, wkv_bwd
        from repro_torch.models.vision import init_resnet, resnet_forward
        from repro_torch.optim.adamw import SGD
        from repro_torch.serve.engine import VisionServeEngine
        from repro_torch.train.trainer import Trainer, TrainerConfig
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

    # the roofline phase's batch cuts, counted on the CPU meanwhile
    roof_cuts = start_roofline_cuts()

    # -- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    logs = runtime.BUILDER.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({len(logs)} of {len(runtime.SIGNATURES)} libraries compiled)")
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

    fma_per_s = n_sm * FP32_LANES * clk_mhz * 1e6

    def account(name, count, ms, plain_ms, lib_ms, bytes_, ops, err,
                ops_per_s=None):
        """Adds ``count`` calls to ``name``'s row: ``ops`` table lookups
        (or, with ``ops_per_s``, operations at that rate) and ``bytes_``
        moved per call."""
        s = stats[name]
        t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
        t_ops = ops / (ops_per_s or lookups_per_s) * 1e3
        s["err"] = max(s["err"], err)
        s["ms"] += count * ms
        s["plain_ms"] += count * plain_ms
        s["lib_ms"] = None if lib_ms is None else s["lib_ms"] + count * lib_ms
        s["t_bytes"] += count * t_bytes
        s["t_ops"] += count * t_ops
        s["bound_ms"] += count * max(t_bytes, t_ops)

    def max_err(a, b):
        return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())

    # kernel 13: the LOWRANK GEMM at rank 8 on the same codes
    lr_acu = make_acu(MULT, "lowrank", rank=RANK, use_kernels=True)
    f13, g13 = lr_acu.device_factors(dev)
    table_bytes = 2 * f13.numel() * 4
    lowrank_stats = {"tf32_bound": 0.0}

    def lowrank_gemm(label, count, a, wmat, lut_int):
        """Holds err_matmul against its plain version at one GEMM shape
        and accounts its time; prints how far one plain TF32 pass (the
        3xTF32 split's lo terms dropped, emulated) lies from the summation
        bound, beside the kernel; at the stage 0 shape also a planted fault
        (one tile's exact term without its last k, which the hold must
        catch) and the bank-conflict replay. Returns the line to print."""
        (M, K), N = a.shape, wmat.shape[1]
        em_k = lambda: err_matmul(a, wmat, f13, g13, off)
        em_p = lambda: err_matmul_ref(a, wmat, f13, g13, off)
        yk, yp = em_k(), em_p()
        err = hold_err_matmul(torch, check, label, a, wmat, yk, yp, lut_int,
                              lr_acu)
        bound = summation_bound(a, wmat, f13, g13, off)
        y1 = err_matmul_tf32_ref(a, wmat, f13, g13, off, passes=1)
        tf32_of = share_of(torch, (y1.double() - yp.double()).abs(), bound)
        k_of = share_of(torch, (yk.double() - yp.double()).abs(), bound)
        lowrank_stats[label] = (k_of, tf32_of)
        del y1, bound
        if label == "stage0":
            bn, wm = err_tile(M, N, n_sm)
            bm = (4 if bn == 64 else 8) * wm
            bad = yk.clone()
            bad[:bm, :bn] -= (a[:bm, K - 1:].double()
                              * wmat[K - 1:, :bn].double()).float()
            caught, _ = err_matmul_holds(torch, a, wmat, bad, yp, lut_int,
                                         lr_acu)
            check(not caught, f"err_matmul {label}, planted fault: tile 0 "
                              f"({bm} x {bn}) with its exact term's last k "
                              f"left out fails the hold")
            zeros = (torch.zeros_like(a), torch.zeros_like(wmat))
            t = [cuda_ms(torch, lambda: err_matmul(aa, ww, f13, g13, off), 10)
                 for aa, ww in ((a, wmat), zeros, (a, wmat))]
            lowrank_stats["replay"] = min(t[0], t[2]) / t[1]
            print(f"  err_matmul {label} bank-conflict replay: real codes "
                  f"{t[0]:.4f} ms (again {t[2]:.4f}), code 0 everywhere "
                  f"{t[1]:.4f} ms: x{lowrank_stats['replay']:.2f}")
            del bad
        fa = torch.randn((M, K * RANK), generator=gen, device=dev)
        gw = torch.randn((K * RANK, N), generator=gen, device=dev)
        lib = cuda_ms(torch, lambda: torch.matmul(fa, gw), 10)
        del fa, gw
        ms = cuda_ms(torch, em_k, 10)
        pms = cuda_ms(torch, em_p, 2, warm=1)
        account("err_matmul", count, ms, pms, lib,
                (M * K + K * N) * 4 + table_bytes + M * N * 4,
                M * K * N * RANK, err, ops_per_s=fma_per_s)
        tf32_ms = 2 * M * K * N * RANK / TF32_FLOP_PER_S * 1e3
        lowrank_stats["tf32_bound"] += count * tf32_ms
        return (f"err_matmul {ms:.4f} ms (plain {pms:.3f}, torch.matmul "
                f"f32 at K*r {lib:.4f}, FMA bound "
                f"{M * K * N * RANK / fma_per_s * 1e3:.4f} ms, TF32 bound "
                f"{tf32_ms:.4f} ms, 3xTF32 {3 * tf32_ms:.4f}; of the "
                f"summation bound: kernel {k_of:.2e}, one plain TF32 pass "
                f"{tf32_of:.2e})")

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
        tiling = pick_conv_kernel_tiling(BATCH, cin, yk.shape[1],
                                         yk.shape[2], cout, k, k, stride,
                                         stride, 1, 1, n_codes, n_sm)
        print(f"  {name:16s} fused_lut_conv tiling: "
              f"{tiling.describe(BATCH)}; lut_matmul plan "
              f"{lut_plan(M, K, N, n_sm).summary()}")
        af, wf = a.float(), wmat.float()
        lib = cuda_ms(torch, lambda: torch.matmul(af, wf), 10)
        # kernel 5's yardstick: F.conv2d in f32 (TF32 off) on the same
        # image, padded beforehand (SAME at stride 2 pads one side)
        xpad = F.pad(x, (pad[1][0], pad[1][1], pad[0][0], pad[0][1]))
        wcf = wq.float()
        lib5 = cuda_ms(torch, lambda: F.conv2d(xpad, wcf, stride=st), 10)
        ms_c = cuda_ms(torch, conv_k, 10)
        ms_cp = cuda_ms(torch, conv_p, 2, warm=1)
        account("fused_lut_conv", count, ms_c, ms_cp, lib5,
                x.numel() * 4 + wq.numel() * 4 + lut_bytes + N * 12
                + M * N * 4, M * K * N, err)
        ms_m = cuda_ms(torch, lambda: lut_matmul(a, wmat, lut16, off), 10)
        ms_mp = cuda_ms(torch, lambda: lut_matmul_ref(a, wmat, lut32, off,
                                                      n_codes), 2, warm=1)
        account("lut_matmul", count, ms_m, ms_mp, lib,
                a.numel() * 4 + wmat.numel() * 4 + lut_bytes + M * N * 4,
                M * K * N, max_err(mk, mp))
        line13 = lowrank_gemm(name, count, a, wmat, mk)
        print(f"  {name:16s} x{count} GEMM {M}x{K}x{N}: conv {ms_c:.4f} ms "
              f"(plain {ms_cp:.3f}, F.conv2d f32 {lib5:.4f}), lut_matmul "
              f"{ms_m:.4f} ms (plain {ms_mp:.3f}), torch.matmul f32 "
              f"{lib:.4f} ms, "
              f"lookup bound {M * K * N / lookups_per_s * 1e3:.4f} ms; "
              f"{line13}", flush=True)
        del cols, a, mk, mp, xpad

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
    check(torch.equal(mk, mp), f"lut_matmul head: int32 bitwise equal to "
                               f"the plain version; plan "
                               f"{lut_plan(M, K, N, n_sm).summary()}")
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
    print(f"  head             x1 GEMM {M}x{K}x{N}: "
          + lowrank_gemm("head", 1, a, wq.contiguous(), mk), flush=True)

    # -- 3. backward kernels at the gradient shapes of one training step --
    tb = TRAIN_BATCH
    print(f"backward kernel checks at ResNet-20 training-step shapes "
          f"(batch {tb}):")

    def sym(t):
        return inline_symmetric_scale(t.abs().amax(), 8)

    for name, cin, hw, cout, k, stride, padding, count in CONVS:
        xf = torch.relu(torch.randn((tb, cin, hw, hw), generator=gen,
                                    device=dev))
        wf = torch.randn((cout, cin, k, k), generator=gen, device=dev) * 0.1
        st = (stride, stride)
        pad = resolve_conv_padding(padding, xf.shape, wf.shape, st, (1, 1))
        ho = conv_out_size(hw, k, stride, 1, pad[0])
        g = torch.randn((tb, ho, ho, cout), generator=gen, device=dev) * 1e-3
        sx, sg, sw = sym(xf), sym(g), sym(wf)
        geo = dict(ksize=(k, k), stride=st, padding=pad)
        bw_k = lambda: fused_lut_conv_bwd_w(xf, g, lut16, off, sx, sg, **geo)
        bw_p = lambda: fused_lut_conv_bwd_w_ref(xf, g, lut32, off, n_codes,
                                                sx, sg, **geo)
        ak, ap = bw_k(), bw_p()
        check(torch.equal(ak, ap),
              f"fused_lut_conv_bwd_w {name}: int32 bitwise equal to the "
              f"plain version {tuple(ak.shape)}; tiling "
              + pick_bwd_w_tiling(tb, cin, ho, ho, cout, k, k, stride,
                                  stride, 1, 1, n_codes,
                                  n_sm).describe(tb, n_sm))
        P, ckk = tb * ho * ho, cin * k * k
        g2 = g.reshape(P, cout)
        cols_f = torch.randn((ckk, P), generator=gen, device=dev)
        lib = cuda_ms(torch, lambda: torch.matmul(cols_f, g2), 10)
        ms_w = cuda_ms(torch, bw_k, 10)
        ms_wp = cuda_ms(torch, bw_p, 2, warm=1)
        account("fused_lut_conv_bwd_w", count, ms_w, ms_wp, lib,
                (xf.numel() + g.numel() + ckk * cout) * 4 + lut_bytes + 8,
                P * ckk * cout, max_err(ak, ap))
        # the unfused route's weight gradient: lut_matmul with K split
        qc = torch.randint(-128, 128, (ckk, P), generator=gen, device=dev,
                           dtype=torch.int32)
        qg = torch.randint(-128, 128, (P, cout), generator=gen, device=dev,
                           dtype=torch.int32)
        check(torch.equal(lut_matmul(qc, qg, lut16, off),
                          lut_matmul_ref(qc, qg, lut32, off, n_codes)),
              f"lut_matmul {name} gw {ckk}x{P}x{cout} (stream-K plan "
              f"{lut_plan(ckk, P, cout, n_sm).summary()}): int32 bitwise "
              f"equal to the plain version")
        ms_u = cuda_ms(torch, lambda: lut_matmul(qc, qg, lut16, off), 10)
        line = (f"  {name:16s} x{count} gw {ckk}x{P}x{cout}: bwd_w "
                f"{ms_w:.4f} ms (plain {ms_wp:.3f}), lut_matmul {ms_u:.4f} "
                f"ms, torch.matmul f32 {lib:.4f} ms, lookup bound "
                f"{P * ckk * cout / lookups_per_s * 1e3:.4f} ms")
        if name != "stem":      # the stem's input is the image: no gx
            wfmat = wf.reshape(cout, -1)
            gx_k = lambda emit=True: fused_lut_bwd(g2, wfmat, lut16, off,
                                                   sg, sw, emit_acc=emit)
            gx_p = lambda emit=True: fused_lut_bwd_ref(
                g2, wfmat, lut32, off, n_codes, sg, sw, emit_acc=emit)
            ck, cp = gx_k(), gx_p()
            check(torch.equal(ck, cp) and torch.equal(gx_k(False),
                                                      gx_p(False)),
                  f"fused_lut_bwd {name} gx: float32 and emit_acc bitwise "
                  f"equal to the plain version {tuple(ck.shape)}; plan "
                  + bwd_plan(P, cout, ckk, n_sm, n_codes).describe())
            lib = cuda_ms(torch, lambda: torch.matmul(g2, wfmat), 10)
            ms_x = cuda_ms(torch, gx_k, 10)
            ms_xp = cuda_ms(torch, gx_p, 2, warm=1)
            account("fused_lut_bwd", count, ms_x, ms_xp, lib,
                    (P * cout + cout * ckk + P * ckk) * 4 + lut_bytes + 8,
                    P * cout * ckk, max_err(ck, cp))
            line += (f"; gx {P}x{cout}x{ckk}: {ms_x:.4f} ms (plain "
                     f"{ms_xp:.3f}), torch.matmul f32 {lib:.4f} ms")
        print(line, flush=True)
        del cols_f, qc, qg

    xh = torch.relu(torch.randn((tb, 64), generator=gen, device=dev))
    wh = torch.randn((64, 10), generator=gen, device=dev) * 0.1
    gh = torch.randn((tb, 10), generator=gen, device=dev) * 1e-2
    for label, a, b in (("gx", gh, wh.t().contiguous()),
                        ("gw", xh.t().contiguous(), gh)):
        sa, sb = sym(a), sym(b)
        yk = fused_lut_bwd(a, b, lut16, off, sa, sb)
        yp = fused_lut_bwd_ref(a, b, lut32, off, n_codes, sa, sb)
        (M, K), N = a.shape, b.shape[1]
        ak = fused_lut_bwd(a, b, lut16, off, sa, sb, emit_acc=True)
        ap = fused_lut_bwd_ref(a, b, lut32, off, n_codes, sa, sb,
                               emit_acc=True)
        check(torch.equal(yk, yp) and torch.equal(ak, ap),
              f"fused_lut_bwd head {label} {M}x{K}x{N}: float32 and "
              f"emit_acc bitwise equal to the plain version; plan "
              + bwd_plan(M, K, N, n_sm, n_codes).describe())
        account("fused_lut_bwd", 1,
                cuda_ms(torch, lambda: fused_lut_bwd(a, b, lut16, off, sa,
                                                     sb), 20),
                cuda_ms(torch, lambda: fused_lut_bwd_ref(
                    a, b, lut32, off, n_codes, sa, sb), 5),
                cuda_ms(torch, lambda: torch.matmul(a, b), 20),
                (M * K + K * N + M * N) * 4 + lut_bytes + 8, M * K * N,
                max_err(yk, yp))

    # -- 4. serve ResNet-20 ------------------------------------------------
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
           "fused_lut_conv": fused_lut_conv, "fused_lut_bwd": fused_lut_bwd,
           "fused_lut_conv_bwd_w": fused_lut_conv_bwd_w,
           "approx_flash_attention": approx_flash_attention,
           "approx_flash_attention_paged": approx_flash_attention_paged,
           "err_matmul": err_matmul, "fused_lut_grouped": fused_lut_grouped,
           "quantize": quantize_kernel, "wkv": wkv, "wkv_bwd": wkv_bwd,
           "flash_attention": flash_attention,
           "fused_lut_conv_tiled": fused_lut_conv_tiled}
    path_kernels = {"fused": ("fused_lut_conv", "fused_lut_dense",
                              "quantize"),
                    "unfused": ("lut_matmul", "quantize")}
    launches = {k: 0 for k in KERNELS}
    logits, rates = {}, {}
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
            check(counts[k] > 0, f"{name} path launched {k} ({counts[k]}x)")
        for k in ops:
            launches[k] += counts[k]
    waves = N_IMAGES // BATCH
    n_convs = sum(c[-1] for c in CONVS)
    check(launches["fused_lut_conv"] == waves * n_convs
          and launches["fused_lut_dense"] == waves
          and launches["lut_matmul"] == waves * (n_convs + 1)
          and launches["fused_lut_bwd"] == launches["fused_lut_conv_bwd_w"]
          == 0 and launches["quantize"] == waves * 3 * (n_convs + 1),
          f"launch counts match the {n_convs} convs + 1 dense per wave "
          f"(quantize: every weight, and unfused every activation too)")
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
        profile(torch, f"{name} wave", lambda: eng.run(images[:BATCH]),
                1e3 * BATCH / rates[name])

    # -- 5. retrain ResNet-20 ----------------------------------------------
    print(f"training ResNet-20 (width 16, 3 blocks/stage), {MULT}, batch "
          f"{tb}, SGD(lr=1e-3, momentum=0.9), {TRAIN_STEPS} steps per "
          f"regime after one warm-up step:")

    def xent(logits, labels):
        logz = torch.logsumexp(logits, -1)
        gold = torch.gather(logits, -1, labels[:, None])[:, 0]
        return (logz - gold).mean()

    def batch_loss(p, batch, acfg, device):
        x = torch.from_numpy(batch["image"]).to(device)
        y = torch.from_numpy(batch["label"]).to(device).long()
        return xent(resnet_forward(p, x, acfg), y)

    regimes = {
        "exact": ApproxConfig(acu=acu),
        "approx_fused": ApproxConfig(acu=acu, approx_bwd=True),
        "approx_unfused": ApproxConfig(
            acu=make_acu(MULT, "lut", use_kernels=True), approx_bwd=True),
    }
    train = {}
    small = next(image_task(size=32)(4, seed=3))
    for regime, acfg in regimes.items():
        opt = SGD(lr=1e-3, momentum=0.9)
        p = {k: v.clone() for k, v in params.items()}
        state = opt.init(p)
        batches = image_task(size=32)(tb, seed=2)
        trainer = Trainer(lambda q, b, a=acfg: batch_loss(q, b, a, dev), opt,
                          TrainerConfig(log_every=1))
        p, state = trainer.fit(p, state, batches, 1)      # warm-up step
        trainer.history.clear()
        torch.cuda.synchronize()
        for op in ops.values():
            op.launches = 0
        t0 = time.perf_counter()
        p, state = trainer.fit(p, state, batches, TRAIN_STEPS)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = {k: op.launches for k, op in ops.items()}
        losses = [h["loss"] for h in trainer.history]
        train[regime] = (trainer, p, state, batches, TRAIN_STEPS / dt)
        print(f"  {regime}: {TRAIN_STEPS / dt:.3f} steps/s, "
              f"{TRAIN_STEPS * tb / dt:.1f} images/s; losses "
              + " ".join(f"{v:.5f}" for v in losses))
        print(f"    launches {counts}")
        check(len(losses) == TRAIN_STEPS
              and bool(np.isfinite(losses).all()),
              f"{regime}: {len(losses)} finite losses")
        want = {k: STEP_LAUNCHES[regime].get(k, 0) * TRAIN_STEPS
                for k in ops}
        check(counts == want, f"{regime}: launch counts are "
                              f"{TRAIN_STEPS} x {STEP_LAUNCHES[regime]}")
        for k in ops:
            launches[k] += counts[k]

        # one 4-image step on the card and on the CPU
        got = {}
        for where in ("cuda", "cpu"):
            q = {k: v.detach().to(where).clone().requires_grad_(True)
                 for k, v in params.items()}
            loss = batch_loss(q, small, acfg, torch.device(where))
            loss.backward()
            got[where] = (float(loss.detach()),
                          {k: v.grad.cpu() for k, v in q.items()})
        (lc, gc), (lh, gh_) = got["cuda"], got["cpu"]
        same = sum(torch.equal(gc[k], gh_[k]) for k in gc)
        worst = max(float((gc[k] - gh_[k]).abs().max()
                          / gh_[k].abs().max().clamp_min(1e-30)) for k in gc)
        print(f"    4-image step, card vs CPU: loss {lc!r} vs {lh!r}; "
              f"{same} of {len(gc)} gradients bitwise equal, largest "
              f"difference {worst:.3e} of the tensor's largest entry "
              f"(tolerance {GRAD_TOL[regime]:.0e})")
        check(abs(lc - lh) <= 1e-5 * abs(lh) and worst <= GRAD_TOL[regime],
              f"{regime}: 4-image loss and gradients agree between the card "
              f"and the CPU")

    for regime, (trainer, p, state, batches, rate) in train.items():
        profile(torch, f"{regime} training step",
                lambda: trainer.fit(p, state, batches, 1), 1e3 / rate)

    # -- 6. serve SmolLM-135M ----------------------------------------------
    redesign = {}
    lm_rates = lm_phase(torch, np, dev, check, acu, ops, launches, account,
                        lookups_per_s, lut_bytes, redesign)

    # -- 6b. kernel 3's redesign: plans, edge shapes, conflicts ------------
    dense_times = dense_phase(torch, np, dev, check, acu, ops,
                              lookups_per_s, lut_bytes, n_sm)

    # -- 6c. kernels 1 and 5 on the narrow-N core: conflicts, faults -------
    replay = narrow_phase(torch, np, dev, check, acu, n_sm)

    # -- 6d. kernels 4 and 7 redesigned: CONV_BWD, faults, conflicts -------
    bwd_times = bwd_phase(torch, np, dev, check, acu, n_sm, lookups_per_s,
                          lut_bytes)

    # -- 7. Table 4's emulation-mode ladder ---------------------------------
    ladder = ladder_phase(torch, np, dev, check, ops, launches, params,
                          images)

    # -- 8. Table 2's accuracy arc -------------------------------------------
    t0 = time.perf_counter()
    table2 = table2_phase(torch, np, dev, check)
    print(f"Table 2 arc: {time.perf_counter() - t0:.1f} s")

    # -- 9. serve granite-moe-3b-a800m -------------------------------------
    t0 = time.perf_counter()
    moe_rates = moe_phase(torch, np, dev, check, acu, ops, launches, account,
                          lookups_per_s, lut_bytes, redesign)
    print(f"MoE phase: {time.perf_counter() - t0:.1f} s")

    # -- 10. serve rwkv6-3b --------------------------------------------------
    t0 = time.perf_counter()
    rwkv_rates = rwkv_phase(torch, np, dev, check, acu, ops, launches,
                            account, fma_per_s)
    print(f"RWKV phase: {time.perf_counter() - t0:.1f} s")

    # -- 10a. kernel 12's backward; rwkv6-3b trained ----------------------
    wkv_train = wkv_bwd_phase(torch, np, dev, check, acu, ops, launches,
                              account, fma_per_s)
    print(f"kernel-12 backward phase: {wkv_train['seconds']:.1f} s")

    # -- 10b. whisper-small: encode, greedy decode ---------------------------
    t0 = time.perf_counter()
    whisper = whisper_phase(torch, np, dev, check, acu, ops, launches,
                            redesign)
    whisper["seconds"] = time.perf_counter() - t0
    print(f"whisper phase: {whisper['seconds']:.1f} s")

    # -- 10c. jamba-v0.1-52b, one period of its pattern --------------------
    t0 = time.perf_counter()
    jamba = jamba_phase(torch, np, dev, check, acu, ops, launches,
                        lookups_per_s, redesign)
    jamba["seconds"] = time.perf_counter() - t0
    print(f"jamba phase: {jamba['seconds']:.1f} s")

    # -- 11. score gemma2-27b through loss_fn --------------------------------
    t0 = time.perf_counter()
    scored = score_phase(torch, np, dev, check, acu, ops, launches, account,
                         fma_per_s, redesign)
    print(f"scoring phase: {time.perf_counter() - t0:.1f} s")

    # -- 12. ImageNet-scale convs: kernel 6 on the CNN at 224^2 ----------
    convs = conv_phase(torch, np, dev, check, acu, ops, launches, account,
                       lookups_per_s, lut_bytes, n_sm, redesign)

    # -- 13. train SmolLM-135M through loss_fn -------------------------------
    trained = lm_train_phase(torch, np, dev, check, acu, ops, launches,
                             lookups_per_s, lut_bytes, n_sm)

    # -- 14. whole steps against their roofline -----------------------------
    roof = roofline_phase(torch, np, dev, check, ops, launches, roof_cuts)

    # -- 14b. the mesh runtime: two ranks on the one card ------------------
    meshed = mesh_phase(torch, np, check)
    print(f"mesh phase: {meshed['seconds']:.1f} s")

    # -- 15. report --------------------------------------------------------
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
    print(f"ms summed over the calls of one serve wave of {BATCH} images "
          f"(forward kernels and err_matmul; fused_lut_dense adds one SmolLM "
          f"decode step's "
          f"211 GEMMs), one training step at batch {tb} (backward kernels), "
          f"one SmolLM decode step of {LM_SLOTS} rows (attention), one "
          f"granite-moe-3b-a800m decode step (fused_lut_grouped), one "
          f"rwkv6-3b decode step (quantize, wkv), one gemma2-27b forward "
          f"of {SCORE_TOKENS} tokens (flash_attention) or one CNN-224 wave "
          f"of {CNN_SLOTS} images (fused_lut_conv_tiled): "
          + ", ".join(f"{r['name']} {r['ms']:.3f} ms vs bound "
                      f"{r['bound_ms']:.3f}" for r in rows))
    print(f"SmolLM-135M ({LM_SERVE_LAYERS} of 30 layers) tokens/s: "
          + ", ".join(
        f"{k} {v:.1f}" for k, v in lm_rates.items()))
    print(f"granite-moe-3b-a800m ({MOE_SERVE_LAYERS} of 32 layers) "
          f"tokens/s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in moe_rates.items()))
    print("rwkv6-3b tokens/s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in rwkv_rates.items()))
    card = nvidia_smi("name,power.limit")
    print(f"whisper-small ({card}): encode {whisper['encode_ms']:.1f} ms "
          f"for {WHISPER_ROWS} x 1500 frames, {whisper['step_ms']:.2f} ms "
          f"per decode step of {WHISPER_ROWS} rows ({whisper['cross_kv_ms']:.2f}"
          f" ms of it the cross K/V recomputation), "
          f"{whisper['tokens_per_s']:.1f} tokens/s, peak memory "
          f"{whisper['peak_gib']:.2f} GiB; phase {whisper['seconds']:.1f} s")
    print(f"jamba-v0.1-52b cut to {JAMBA_LAYERS} layers ({card}): tokens/s "
          + ", ".join(f"{k} {v:.1f}" for k, v in jamba["rates"].items())
          + f"; {jamba['step_ms']:.1f} ms per decode step of {JAMBA_SLOTS} "
          f"rows ({jamba['glue_ms']:.1f} ms of it the expert weight glue), "
          f"prefill {jamba['prefill_ms']:.1f} ms, selective scan "
          f"{jamba['scan_share']:.3f} of the prefill's device time; peak "
          f"memory {jamba['peak_gib']:.2f} GiB; kernel 10 at jamba's shapes "
          f"(ms, torch.bmm f32, bound): " + ", ".join(
              f"{k} {v[0]:.4f}, {v[1]:.4f}, {v[2]:.4f}"
              for k, v in jamba["k10"].items())
          + f"; phase {jamba['seconds']:.1f} s")
    print(f"gemma2-27b scoring: {scored['tokens_per_s']:.1f} scored tokens/s "
          f"({SCORE_TOKENS} tokens in {scored['seconds']:.1f} s), loss "
          f"{scored['loss']:.4f}, peak memory {scored['peak_gib']:.2f} GiB")
    print(f"CNN-224 (width 64, 224^2, {CNN_CLASSES} classes): "
          f"{convs['images_per_s']:.1f} images/s, {convs['wave_ms']:.1f} ms "
          f"per wave of {CNN_SLOTS}; conv phase {convs['seconds']:.1f} s")
    print(f"images/s: fused {rates['fused']:.1f}, "
          f"unfused {rates['unfused']:.1f}; training steps/s: "
          + ", ".join(f"{k} {v[-1]:.3f}" for k, v in train.items()))
    print("Table 4 ladder, ms per wave of 256: " + ", ".join(
        f"{k} {v:.3f} ({ladder['baseline_lut'] / v:.2f}x)"
        for k, v in ladder.items()))
    print("fused_lut_dense (kernel 3) by regime: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in dense_times.items()
        if not k.startswith("conflicts")) + "; bank-conflict replay "
        "(real / conflict-free codes) " + ", ".join(
        f"M={k.split()[1]}: {v[0]:.2f} (kernel 4 {v[1]:.2f})"
        for k, v in dense_times.items() if k.startswith("conflicts")))
    print("kernels 1 and 5 on the narrow-N core, bank-conflict replay "
          "(real / conflict-free codes) at ResNet-20's widths: " + ", ".join(
              f"N={n}: kernel 5 {v[0]:.2f}, kernel 1 {v[1]:.2f}, kernel 4 "
              f"{v[2]:.2f}" for n, v in replay.items())
          + "; kernel 5 at CNN-224 " + ", ".join(
              f"{k.split()[-1]} {v[0]:.3f} ms (F.conv2d f32 {v[1]:.3f}, "
              f"bound {v[2]:.3f})" for k, v in redesign.items()
              if k.startswith("kernel 5 ")))
    print("kernels 4 and 7 on the narrow-N core, ms per training step "
          "(on the old core) vs lookup bound and torch.matmul f32: " + ", ".join(
              f"{k} {stats[k]['ms']:.3f} ({v:.3f}; x{stats[k]['ms'] / v:.2f}) "
              f"vs {stats[k]['bound_ms']:.3f} and {stats[k]['lib_ms']:.3f}"
              for k, v in BWD_OLD_CORE_MS.items())
          + "; at CONV_BWD (ms, bound, torch.matmul) " + ", ".join(
              f"{k.split()[1]} {v[0]:.3f}, {v[1]:.3f}, {v[2]:.3f}"
              for k, v in bwd_times.items() if k.endswith("CONV_BWD"))
          + "; bank-conflict replay (real / conflict-free codes) " + ", ".join(
              f"N={k.split()[1]}: kernel 4 {v[0]:.2f}, kernel 7 {v[1]:.2f}"
              for k, v in bwd_times.items() if k.startswith("conflicts")))
    k10, s10, s13 = (redesign["kernel 10"], stats["fused_lut_grouped"],
                     stats["err_matmul"])
    print(f"kernels 10 and 13 redesigned: fused_lut_grouped "
          f"{s10['ms']:.3f} ms per granite decode step (before "
          f"{K10_K13_BEFORE_MS['fused_lut_grouped']:.3f}) vs torch.bmm f32 "
          f"{s10['lib_ms']:.3f} and bound {s10['bound_ms']:.3f}; by call "
          f"(ms, torch.bmm, bound): " + ", ".join(
              f"{k} {v[0]:.4f}, {v[1]:.4f}, {v[2]:.4f}"
              for k, v in k10.items() if k != "replay")
          + f"; bank-conflict replay x{k10['replay']:.2f}. err_matmul "
          f"{s13['ms']:.3f} ms per ResNet-20 LOWRANK wave (before "
          f"{K10_K13_BEFORE_MS['err_matmul']:.3f}) vs torch.matmul f32 "
          f"{s13['lib_ms']:.3f}, FMA bound {s13['bound_ms']:.3f}, TF32 bound "
          f"{lowrank_stats['tf32_bound']:.3f} (3xTF32 "
          f"{3 * lowrank_stats['tf32_bound']:.3f}); largest share of the "
          f"summation bound, kernel / one plain TF32 pass: " + ", ".join(
              f"{k} {v[0]:.2e} / {v[1]:.2e}"
              for k, v in lowrank_stats.items()
              if k not in ("tf32_bound", "replay"))
          + f"; bank-conflict replay x{lowrank_stats['replay']:.2f}")
    s2, s11 = stats["quantize"], stats["flash_attention"]
    print(f"kernels 2 and 11 redesigned: quantize {s2['ms']:.3f} ms per "
          f"rwkv6-3b decode step (before "
          f"{K2_K11_BEFORE_MS['quantize']:.3f}) vs bytes bound "
          f"{s2['bound_ms']:.3f} ({s2['bound_ms'] / s2['ms']:.3f} of it); "
          f"flash_attention {s11['ms']:.3f} ms per gemma2-27b forward "
          f"(before {K2_K11_BEFORE_MS['flash_attention']:.3f}) vs TF32 "
          f"bound {s11['bound_ms']:.3f}; by layer (kernel / SDPA at the "
          f"model's dtype / SDPA float32 on its backend / TF32 bound / "
          f"split bound / FP32 bound, ms): "
          + ", ".join(f"{k[10:]} {v[0]:.3f} / {v[1]:.3f} / {v[2]:.3f} on "
                      f"{v[3]} / {v[4]:.3f} / {v[6]:.3f} / {v[5]:.3f}"
                      for k, v in redesign.items()
                      if k.startswith("kernel 11 ")))
    print("kernel 6 against kernel 5 in the same call: "
          + ", ".join(
              f"{k[9:]} kernel 6 {v[0]:.3f} ms, kernel 5 {v[1]:.3f} ms "
              f"(kernel 5 / kernel 6 {v[1] / v[0]:.2f})"
              for k, v in redesign.items() if k.startswith("kernel 6 ")
              and k != "kernel 6 conflicts")
          + f"; kernel 6 bank-conflict replay "
          f"x{redesign['kernel 6 conflicts']:.2f}; " + ", ".join(
              f"{k} decode path {v[0]:.4f} ms vs general {v[1]:.4f} ms "
              f"({v[1] / v[0]:.2f}x), SDPA {v[2]:.4f} ms, bound {v[3]:.4f} ms"
              for k, v in redesign.items() if k.startswith("kernel 8 ")))
    tr_rates, tr_times = trained["rates"], trained["times"]
    print(f"SmolLM-135M training (batch {TRAIN_LM_BATCH} x {TRAIN_LM_SEQ}, "
          f"{MULT} fused ACU; {nvidia_smi('name,power.limit')}): " + ", ".join(
              f"{k} {v[0]:.3f} steps/s, {v[1]:.0f} trained tokens/s, device "
              f"busy {v[2]:.1f} ms a step, idle share "
              + ("not measured" if v[3] is None else f"{v[3]:.3f}")
              for k, v in tr_rates.items())
          + f"; peak memory {trained['peak_gib']:.2f} GiB; checkpoint "
          f"{trained['ckpt_bytes'] / 1e9:.3f} GB, saves "
          + "/".join(f"{v:.2f}" for v in trained["save_s"]) + " s, restores "
          + "/".join(f"{v:.2f}" for v in trained["restore_s"])
          + f" s; damped accum {trained['accums']}; kernels per training "
          f"step (ms, plain, library, bound): " + ", ".join(
              f"{k} {v['ms']:.3f}, {v['plain_ms']:.1f}, {v['lib_ms']:.3f}, "
              f"{v['bound_ms']:.3f}" for k, v in tr_times.items())
          + f"; phase {trained['seconds']:.1f} s")
    print(f"roofline shares, {ROOFLINE_ARCH} ({card}): " + ", ".join(
        f"{k} batch {v['batch']} {v['ms']:.2f} ms vs bound {v['lb_ms']:.3f} "
        f"({v['bottleneck']}): share {v['share']:.4f}, MFU {v['mfu']:.5f}, "
        f"floor {v['floor_ms']:.3f} ms, floor share {v['floor_share']:.4f}"
        for k, v in roof.items() if isinstance(v, dict))
        + f"; achieved matmul {roof['matmul_tflops']:.1f} TFLOP/s, copy "
        f"{roof['copy_tbps']:.3f} TB/s; phase {roof['seconds']:.1f} s")
    print(f"kernel 12's backward ({card}): wkv_bwd {wkv_train['ms']:.3f} ms "
          f"a layer at {WKV_TRAIN_BATCH} x {WKV_TRAIN_SEQ} (plain "
          f"{wkv_train['plain_ms']:.1f} ms, bound "
          f"{wkv_train['bound_ms']:.4f} ms; before the redesign "
          f"{WKV_BEFORE_MS['wkv_bwd']:.3f}); forward wkv "
          f"{wkv_train['fwd_ms']:.4f} ms (bound "
          f"{wkv_train['fwd_bound_ms']:.4f}; before "
          f"{WKV_BEFORE_MS['wkv']:.4f}); rwkv6-3b cut to "
          f"{WKV_TRAIN_LAYERS} layers, {WKV_TRAIN_STEPS} AdamW steps: losses "
          + ", ".join(f"{x:.4f}" for x in wkv_train["losses"])
          + ", step ms " + ", ".join(f"{x:.1f}" for x in wkv_train["step_ms"])
          + f"; phase {wkv_train['seconds']:.1f} s")
    print(f"mesh runtime ({card}, {MESH_RANKS} ranks over gloo through the "
          f"host, which says nothing of NVLink): SmolLM-135M data-parallel "
          f"step s " + ", ".join(f"{x:.3f}" for x in meshed.get("step_s", []))
          + f", collective share {meshed.get('collective_share', float('nan')):.3f};"
          f" kernel 7 with rmask {meshed.get('rmask_launches', 0)}x, kernel "
          f"10 emit_acc {meshed.get('emit_acc_launches', 0)}x; phase "
          f"{meshed['seconds']:.1f} s")
    print("Table 2 arc:\n" + "\n".join(table2))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all, the "
          f"kernels' build included")
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

#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit (``nvcc``). It fails (non-zero exit, no result line) without a
card, outside a checkout, or when any phase fails. Phases, in order:

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``rectified_flow_vision_tpu_torch/ops/csrc``;
3. kernels: every kernel at every shape the flagship UNet's eval and train
   forwards give it (batch 256; shapes recorded from CPU forwards of the same
   model), the attention block at 1024 tokens (256, 32, 32, 256), the
   flash-attention forward at the DiT-S/2 latent shapes (batch 256 and 64,
   1024 tokens, 6 heads of 64) and at 16384 tokens, its backward at batch
   64, both at DiT-XL/2's widths (batch 64, 1024 tokens, 16 heads of 72)
   and at head widths 4, 12, 128, 136, 192, 256, 320, 384 and 512 (batch 64,
   1024 tokens, 6 heads; bf16 136-256 on the kernels' 192 and 256 instances,
   bf16 above 256 on the streamed kernels, fp32 up to 128 on the 3xTF32
   kernels, above 128 on the *_wide fp32 kernels; 512 in bf16 only), and at
   the shapes of the DiTs with 6
   heads of 192 and 3 heads of 384 of phase 11 (batch 2, 1024 tokens),
   the standalone dropout at three sizes, the DiT glue kernels
   (ln_modulate, bias_act with and without GELU, gated_residual) at 64 x
   1024 token rows of 384, 1152 and 1536 channels, FLUX's qk_norm_rope at
   its three streams at 1024 px (a double block's 256 text rows and 4096
   image rows into one 4352-row joint buffer, a single block's 4352 rows;
   24 heads of 128; against ``qk_norm_rope.joint_plain``, v bit for bit)
   the flash-attention forward at FLUX's joint (1, 4352, 24, 128), and
   gn_silu's streamed plan at the ConvVAE decode's slabs (``DECODE_GN``: the
   DiT serve cell's batch 64 at 64^2 x 256, 128^2 x 128, 256^2 x 64; FLUX's
   batch 1 at 128^2 x 256 up to 1024^2 x 64; the kernel's input cycled past
   the L2), in bf16 and fp32,
   against its plain PyTorch version on the same inputs within a stated
   tolerance, with the kernel's, the plain version's and one PyTorch library
   call's times, and the card's least time (bound: fp32 flash up to D = 128
   at the 3xTF32 rate, 495 / 3 TFLOP/s), with TFLOP/s where operations
   bound the kernel. The GroupNorm backward kernel at every
   GroupNorm site of the train step (with the dropout mask at the dropout
   sites), its library time that of ATen's chain (``F.group_norm`` +
   ``F.silu``, + ``F.dropout``) through autograd. The dropout kernels also:
   the mask equal to the plain version's bit for bit, the dropped fraction,
   same seed same output, other seed other mask. Then each flash kernel
   alone (forward; delta, dkv and dq of the backward) by the profiler's
   device time, with TFLOP/s and share of the bound, beside SDPA's forward
   and backward: bf16 at the DiT-S/2 and DiT-XL/2 shapes and at head widths
   256 and 320, fp32 at the DiT-S/2 and DiT-XL/2 shapes against both the
   3xTF32 and the CUDA-core bound. Then the fp32 kernels up to D = 128
   against float64 at (2, 1024, 4, D), D = 64, 72, 128, inputs N(0, 1) and
   N(0, 3^2): their max |error| in the output and in dq, dk, dv at most 4
   times the plain fp32 version's (TF32 off);
4. model: a full-width UNet forward in fp32 at batch 4, kernels on the card
   against the plain path on the CPU;
5. serve: ``SamplerService`` at full width, batch 256, steps (1, 2, 4), bf16,
   answering three requests; launch counts, same-seed determinism, img/s;
6. trace: one 4-step batch under ``torch.profiler``: device time by kernel
   group and the device's idle share;
7. gradient: full-width UNet, fp32, batch 4, dropout 0.1, fixed x0, t and
   seeds: the loss and every parameter's gradient on the card (kernels
   forward, ``gn_silu_backward`` backward) against the plain path on the CPU;
7a. winograd: the Winograd F(2x2, 3x3) conv (``ops/winograd.py``) that
   ``RFV_CONV_WINOGRAD`` selects, the variable set by the script only inside
   this phase and phase 15's ``tp2_winograd``: at every conv3x3 shape of the
   flagship forward (batch 256) fp32 against cuDNN's fp32 conv (TF32 off) and
   bf16 against the conv3x3 kernel's error (``WINOGRAD_*``), the ms a call of
   Winograd, the conv3x3 kernel and cuDNN (median of 10 CUDA-event
   readings each); the flagship forward at batch 256 in bf16 gate on and
   off (0 / 30 conv3x3 launches, 30 / 0 Winograd calls, the bf16 contract
   against the fp32 forward); one bf16 train step with dropout 0.1 gate on
   and off (launches, loss, the 30 conv sites' gradient norms); and
   ``SamplerService.throughput(4)`` (batch 256, bf16) off, on, on, off, with
   the card's name and power limit;
8. train: at full width, bf16 compute on fp32 masters: ``train_base_flow`` on
   a seeded 512-image corpus (batch 64, EMA 0.999, device-resident epochs),
   heun-teacher ``generate_reflow_pairs`` (pair batch 256),
   ``train_rectified_flow`` (teacher-init, u-shaped t, EMA),
   ``compute_straightness`` and 4-step samples from the student's EMA
   checkpoint; finite and falling losses, exact launch counts, and the same
   seeds giving the same loss trajectory twice;
9. train timing and trace: img/s of ``make_train_epoch`` at batch 256 in bf16,
   peak device memory, and one train step under ``torch.profiler``;
9a. resume: both trainers at full width (bf16, EMA, device-resident
   epochs, the state saved every epoch; ``RESUME``): two uninterrupted runs
   of ``train_base_flow`` on a seeded 1024-image corpus at batch 128, then
   one crashed after epoch 2's state is committed and resumed; the same
   for ``train_rectified_flow`` (teacher-init, u-shaped t) on 1024 heun
   pairs of the trained teacher; losses, weights and EMA of the resumed
   run held to twice the two runs' spread (+ a floor), both numbers
   printed; exact launch counts; then ``TrainStateManager`` and
   ``AsyncSaver`` writing while training goes on: the snapshot at the
   save, bit for bit;
9b. HTTP: ``serving_http.make_server`` around ``SamplerService`` (batch
   256, steps 1, 2, 4, bf16) on 127.0.0.1: 16 concurrent clients (n 1, 4,
   16, 64), each sending its next request as the last one returns, for
   windows of a few seconds (``HTTP``: three readings at 4 steps, three at
   1 step), npy and PNG; coalescing (fewer sampler calls than requests),
   shapes, range, a 400, /healthz, /metrics, exact launches; img/s (all
   images over all the time) and p50 / p99 latency of each reading and of
   all requests at a step count, the readings' spread, the share of the
   time the batcher spent in the sampler; then ``python -m
   rectified_flow_vision_tpu_torch.serving_http`` in a process of its own
   answering a request;
9c. metric networks: LPIPS and InceptionV3 (synthetic weights) at batch
   256 of 64x64 images with the process's TF32 switches on, against the
   CPU on 4 images (``METRIC_NETS``), ms per batch, and a control that
   must fail the same gate: the networks with their TF32 pin taken away;
   ``train_synthnet``'s 3 steps on the card from its default init against
   the CPU, the update held relative to its norm, and a control at half
   the lr that must fail that gate;
9d. profiling: an ``annotate`` span in a ``trace()`` of a served batch,
   ``device_memory_stats()`` nonzero, ``nan_check`` silent over a UNet
   sample and raising on a NaN made on the card;
10. dropout: ``ops.primitives.dropout`` on tensors on the card, forward and
    gradient (no model of either package calls the standalone kernel), and
    ``dropout_mask_apply`` on a cotangent (the backward kernel took its place
    in the train step);
11. DiT model and gradient: DiT-S/2 (hidden 384, depth 12, 6 heads, patch 2,
    64x64x4 latents, ``remat``) in fp32 at batch 4 with all-random parameters:
    the forward, the loss and every parameter's gradient on the card (flash
    kernels forward and backward) against the plain path on the CPU; then
    DiT-XL/2's widths (16 heads of 72) at depth 2, batch 2, the same in fp32
    and the forward in bf16; then DiT-XL/2's hidden size 1152 in 6 heads of
    192 (``DIT_WIDE``, depth 2, batch 2): bf16 forward, loss and every
    gradient on the card (the bf16 flash kernels above head width 128)
    against the bf16 plain path on the CPU, and the same in fp32 (the
    *_wide fp32 kernels), with exact launch counts; then the same for the
    hidden size 1152 in 3 heads of 384 (``DIT_WIDE_384``: the streamed bf16
    kernels, the *_wide fp32 kernels in two chunks);
12. latent serve: ``SamplerService`` with a ConvVAE (256x256x3, base 64,
    downsample 4; seeded weights for both), batch 256, steps (1, 2, 4), bf16
    flow and bf16 decode, three requests; exact launch counts (flash, the
    glue kernels, the decode's streamed GroupNorms and conv3x3 sites), outputs
    finite and in [-1, 1], same seed same images, pixel img/s, peak memory,
    and one 4-step batch under ``torch.profiler``;
13. latent train: a seeded 256-image 256x256 corpus; ``train_vae``; encode;
    ``train_base_flow(backbone="dit")`` at batch 64, lr 1e-4 with warm-up, EMA;
    heun pairs; ``train_rectified_flow`` (teacher-init, u-shaped t);
    straightness; ``LatentFlowPipeline.sample`` from the EMA checkpoint; exact
    launch counts; a second base run bit for bit; then DiT train img/s at
    batch 64, peak memory and a train-step trace, in bf16, then the same for
    DiT-S/2 with fp32 compute (seeded weights; the fp32 flash kernels, 24
    forward and 12 backward launches a step checked exactly; the device ms
    of each flash kernel in the trace).
14. CLI: the port's pipeline through ``main(argv)``, in-process, on
    ``configs/config.yaml`` saved by the port's ``Config.save`` under
    ``build/cli_smoke/`` with its widths and recipe (the flagship UNet,
    11,255,363 parameters; K = 2; 100 heun teacher steps; 8 step counts;
    throughput batch 256) and cut epochs, pairs, runs and quality samples
    (``CLI``): synthetic data, base training, Reflow, the benchmark. Each
    step's seconds, the launches of the five UNet kernels (each > 0), the
    models on the card, the checkpoints and finite losses, one
    ``benchmark_results.csv`` row per step count, the 9 rows of
    ``quality_results.csv`` with finite ``fid_deep`` and SSIM in [-1, 1], the
    report and its conclusions, and the benchmark's img/s at 1, 2 and 4 steps
    beside the serve phase's ``throughput(4)``.

15. parallel (``PARALLEL``): (a) a process group of one rank over NCCL in
    this process: explicit one-device meshes through ``make_train_step``
    (DP, FSDP2, FSDP2 x TP; flagship UNet, batch 64, fp32) and
    ``SamplerService(mesh=)`` (batch 256, 4 steps), each against no mesh on
    the card with its img/s beside the no-mesh img/s and exact launch
    counts; ``ring_attention_sharded`` on one rank against the flash kernel;
    a one-stage ``pipeline_apply`` of DiT-S/2 against its plain forward; the
    tensor-parallel forms of the attention-block kernel (a rank's heads, no
    residual) and of the dropout kernels (a rank's channel slice, its mask
    bits those of the whole activation) against their plain versions. (b)
    two gloo ranks spawned on the one card, holding CUDA tensors: DP, TP
    (dropout 0.1; also under ``RFV_CONV_WINOGRAD``, every conv site's slice
    on the Winograd conv) and FSDP train steps of the flagship UNet (fp32,
    batch 64 global), a sequence-parallel DiT-S/2 step and a two-stage pipeline step
    (depth 2), each against the single-rank result on the card within the
    CPU tests' tolerances, each rank held to its exact kernel launches. Any
    exception fails the phase. The ring and the pipeline run only where
    ``ppermute`` of CUDA tensors over gloo gives the right values; where
    gloo's TCP transport refuses them (``writev`` / ``readv`` of the device
    pointer: "Bad address", the rank aborted) they are logged as not run,
    with that error, after ``ppermute`` of CPU tensors gave the right values
    (NCCL refuses two ranks on one card; more than one card is unproven
    here).

16. FLUX (``FLUX``): FLUX.1 [schnell] at its published widths (hidden 3072,
    24 heads of 128, 256 text tokens of 4096, pooled 768, RoPE axes (16,
    56, 56)), 4 double + 8 single blocks, 1024 px (128x128x16 latents, 4352
    tokens), QK-RMSNorm scales 1 + 0.3 z: one fp32 forward on the card
    (kernels: fp32 qk_norm_rope, flash and glue) against the plain float32
    FLUX of ``tests/flux_reference.py`` on the card (TF32 off, the same
    parameter tensors), the bf16 forward against it too, and the reference
    with RoPE left out, which must fail the fp32 gate; then
    ``SamplerService`` (batch 1, 4 Euler steps, bf16, the ConvVAE decode to
    1024x1024x3) behind a ``Batcher`` answering three prompted requests
    (seeded N(0, 1) encoder outputs): images finite, in [-1, 1] and not
    constant, same seed and prompt the same image, the same noise with
    another prompt another image, exact launch counts (every qk_norm_rope,
    flash and glue launch of every forward), ms an image, peak memory and
    one image under ``torch.profiler``.

Every number is printed; the last two lines of standard output are the
``kernels`` JSON line and ``{"ok": true, "device": {...}}``. The profiler
traces are kept in ``build/*_trace.json`` (chrome trace format); checkpoints
of the train phases go to ``build/smoke_ckpt/``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parent
PACKAGE = ROOT / "rectified_flow_vision_tpu_torch"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # bf16 tensor cores; fp32 outside them
# fp32-accurate products on the tensor cores (3xTF32: three TF32 products at
# 495 TFLOP/s for each), the rate the fp32 flash kernels up to D = 128 run at
TF32X3_FLOPS = 495e12 / 3
BATCH = 256
SEED = 0

# (rtol, atol) per kernel and dtype, checked as |kernel - plain| <= atol + rtol * |plain|.
TOLERANCES = {
    # fp32: the same fp32 arithmetic, summed in another order (one-pass
    # shifted moments vs two-pass statistics; other GEMM orders; cuDNN may
    # pick a Winograd or FFT algorithm for the plain conv, which is still
    # fp32 with TF32 off but rounds differently).
    ("gn_silu", "float32"): (1e-4, 1e-4),
    ("gn_silu_streamed", "float32"): (1e-4, 1e-4),
    ("conv3x3", "float32"): (1e-3, 1e-3),
    ("attention_block", "float32"): (1e-3, 1e-3),
    # bf16: the kernels round once where the plain versions round two or
    # three times (gn then silu; conv then bias add); one bf16 ulp is 2^-7
    # relative at worst, 0.03 absolute on values in [4, 8).
    ("gn_silu", "bfloat16"): (2e-2, 3e-2),
    ("gn_silu_streamed", "bfloat16"): (2e-2, 3e-2),
    ("conv3x3", "bfloat16"): (2e-2, 3e-2),
    ("attention_block", "bfloat16"): (2e-2, 6e-2),
    # gn_silu_dropout: gn_silu's arithmetic times 1/keep on kept elements
    # (values up to 1.11x larger, hence the atol), zero elsewhere.
    ("gn_silu_dropout", "float32"): (1e-4, 1e-4),
    ("gn_silu_dropout", "bfloat16"): (2e-2, 3.5e-2),
    # gn_silu_backward: the plain version follows the kernel's fp32 formulas
    # from the same saved statistics and rounds dx once, as the kernel; sums
    # in another order (the parameter gradients over 256 images). Each
    # output (dx, dscale, dbias) is held to a share of its largest entry
    # (SCALED_ATOL).
    ("gn_silu_backward", "float32"): (0.0, 1e-4),
    ("gn_silu_backward", "bfloat16"): (0.0, 2e-2),
    # dropout_mask_apply: the same fp32 product and one rounding: exact.
    ("dropout_mask_apply", "float32"): (0.0, 0.0),
    ("dropout_mask_apply", "bfloat16"): (0.0, 0.0),
    ("dropout", "float32"): (0.0, 0.0),
    ("dropout", "bfloat16"): (0.0, 0.0),
    # flash attention, fp32: the same fp32 arithmetic with the softmax taken
    # tile by tile. bf16: the kernel rounds unnormalised probabilities and
    # divides by the fp32 sum at the end, the plain version rounds normalised
    # ones: a few bf16 ulps of outputs below 1 (one ulp is 0.004 in [0.5, 1)).
    ("flash_attention", "float32"): (1e-4, 1e-4),
    ("flash_attention", "bfloat16"): (2e-2, 2e-2),
    # backward: the plain version follows the kernels' formulas and rounds P
    # and dS to bf16 where they do; the atol is in units of the largest
    # gradient entry (SCALED_ATOL), since gradients have no natural scale.
    ("flash_attention_backward", "float32"): (1e-4, 1e-4),
    ("flash_attention_backward", "bfloat16"): (2e-2, 2e-2),
    # the DiT glue: the LayerNorm's fp32 sums in another order, within one
    # bf16 ulp (2^-7 of |x| covers it; 1e-6 next to zero, where the sums'
    # order sets the last bits) or 1e-5 in fp32; the dense epilogue and the
    # gated residual round where the eager composition does: bit-equal;
    # GELU's tanh and products contract differently: one bf16 ulp, 1e-6 fp32
    ("ln_modulate", "float32"): (1e-5, 1e-5),
    ("ln_modulate", "bfloat16"): (2.0 ** -7, 1e-6),
    ("bias_act", "float32"): (0.0, 0.0),
    ("bias_act", "bfloat16"): (0.0, 0.0),
    ("bias_act_gelu", "float32"): (1e-6, 1e-6),
    ("bias_act_gelu", "bfloat16"): (2.0 ** -7, 0.0),
    ("gated_residual", "float32"): (0.0, 0.0),
    ("gated_residual", "bfloat16"): (0.0, 0.0),
    # qk_norm_rope: the same fp32 arithmetic with the sum of squares in
    # another order and rsqrtf, then one rounding on both sides: q and k
    # within one bf16 rounding (or 2e-6 in fp32); v is copied (bit for bit,
    # checked apart)
    ("qk_norm_rope", "float32"): (2e-6, 2e-6),
    ("qk_norm_rope", "bfloat16"): (8e-3, 8e-3),
}
SCALED_ATOL = {"flash_attention_backward", "gn_silu_backward"}
# the GroupNorm forwards' second output, the saved fp32 (mean, 1/sigma),
# against gn_stats_plain: the same fp32 statistics summed in another order
SAVES_STATS = {"gn_silu", "gn_silu_streamed", "gn_silu_dropout"}
STATS_TOL = (1e-5, 1e-5)
DROP_RATE = 0.1  # the flagship config's dropout
DROP_FRACTION_TOL = 0.002  # of >= 16.7M elements: 27 standard deviations at least
# fp32 full-width forward, kernels on the card vs plain on the CPU: ~60
# layers of fp32 arithmetic summed in other orders.
MODEL_ATOL = 1e-3
# fp32 loss and gradients of the full-width UNet at batch 4, card vs CPU: a
# gradient may differ by GRAD_RTOL of its parameter's largest gradient entry
# (+ GRAD_ATOL), the loss by LOSS_ATOL. Reordered fp32 sums through ~60
# layers forward and backward; cuDNN picks its own backward algorithms.
GRAD_RTOL, GRAD_ATOL, LOSS_ATOL = 2e-3, 1e-6, 1e-4
# two runs of one training recipe on the card draw the same noise, times and
# masks; cuDNN's backward may sum in another order from run to run, and bf16
# steps carry that on, so epoch losses are held to this relative difference
TRAJECTORY_RTOL = 2e-2
# bf16 DiT forward, card vs CPU, both rounding to bf16 after every op but in
# other places (the flash kernel divides by the row sum at the end): a few
# bf16 ulps of the output's scale through two blocks
XL_BF16_RTOL = 5e-2
TRAIN_STEP_LAUNCHES = {"gn_silu": 15, "gn_silu_dropout": 14, "gn_silu_backward": 29,
                       "dropout_mask_apply": 0, "conv3x3": 30, "attention_block": 1}
EVAL_FORWARD_LAUNCHES = {"gn_silu": 29, "gn_silu_dropout": 0, "gn_silu_backward": 0,
                         "dropout_mask_apply": 0, "conv3x3": 30, "attention_block": 1}
TRAIN = dict(images=512, batch=64, base_epochs=4, reflow_epochs=3, lr=2e-4, ema=0.999,
             pairs=512, pair_batch=256, teacher_steps=8, straight_points=10, samples=64)

# The latent path: DiT-S/2 on 64x64x4 latents of 256x256x3 images
# (configs/config_dit256.yaml), full width and depth.
DIT = dict(image_size=64, in_channels=4, backbone="dit", dit_size="S", patch_size=2, remat=True)
DIT_DEPTH, DIT_TOKENS, DIT_HEADS, DIT_HEAD_DIM = 12, 1024, 6, 64
VAE = dict(image_size=256, in_channels=3, latent_channels=4, base_channels=64, downsample=4)
# cut against the config: corpus (256 for 500), VAE epochs (3 for 40), base
# epochs (8 for 400, warm-up 1 for 10), reflow epochs (4 for 50), pairs (256
# for 5000), teacher steps (4 for 100); widths, depth and the recipe are its own
LATENT = dict(images=256, vae_epochs=3, vae_batch=32, batch=64, base_epochs=8, warmup_epochs=1,
              reflow_epochs=4, lr=1e-4, ema=0.999, pairs=256, pair_batch=256, teacher_steps=4,
              straight_points=4, samples=16)
ATTN_1024 = (32, 32, 256)  # (H, W, C) of a 128x128 UNet's mid-block attention
FLASH_FWD_SHAPES = ((BATCH, DIT_TOKENS, DIT_HEADS, DIT_HEAD_DIM),
                    (LATENT["batch"], DIT_TOKENS, DIT_HEADS, DIT_HEAD_DIM),
                    (2, 16384, DIT_HEADS, DIT_HEAD_DIM))
FLASH_BWD_SHAPE = (LATENT["batch"], DIT_TOKENS, DIT_HEADS, DIT_HEAD_DIM)
# DiT-XL/2 (hidden 1152, 16 heads of 72) on the same latents: no path of
# this script runs it, the kernel phase holds it against the plain versions
FLASH_XL_SHAPE = (LATENT["batch"], DIT_TOKENS, 16, 72)
# head widths no config of the repo has, which the JAX _attention takes: 4
# and 12 zero-padded to 8 and 16; 128, the widest of the fp32 3xTF32
# kernels (bf16: the 128 instance); 136, 192 and 256 on the bf16 kernels'
# 192 and 256 instances; 320, 384 and 512 on the streamed bf16 kernels (512
# at its streamed dkv layout; bf16 only, FLASH_BF16_ONLY); every fp32 width
# above 128 on the *_wide fp32 kernels
FLASH_ODD_SHAPES = tuple((LATENT["batch"], DIT_TOKENS, DIT_HEADS, d)
                         for d in (4, 12, 128, 136, 192, 256, 320, 384, 512))
# the fp32 kernels up to D = 128 against float64 at (2, 1024, 4, D): their
# max |error| (output, dq, dk, dv) at most F64_GATE times the plain fp32
# version's (TF32 off), for inputs N(0, sigma^2) with each sigma here
F64_GATE_WIDTHS, F64_GATE_SIGMAS, F64_GATE = (64, 72, 128), (1.0, 3.0), 4.0
FLASH_BF16_ONLY = {FLASH_ODD_SHAPES[-1]}
# DiT-XL/2's hidden size 1152 in 6 heads of 192 (DiT(hidden_size=1152,
# num_heads=6), as the JAX constructor takes it), depth cut from 28 to 2:
# the model path of the bf16 flash kernels above head width 128, at batch 2
DIT_WIDE = dict(image_size=64, in_channels=4, backbone="dit", patch_size=2, hidden_size=1152,
                depth=2, num_heads=6, remat=True)
DIT_WIDE_SHAPE = (2, DIT_TOKENS, DIT_WIDE["num_heads"],
                  DIT_WIDE["hidden_size"] // DIT_WIDE["num_heads"])
# its flash calls in one bf16 forward, then loss and gradients: the forward,
# the loss's forward and remat's rerun of it; one backward a block
DIT_WIDE_FWD_CALLS, DIT_WIDE_BWD_CALLS = 3 * DIT_WIDE["depth"], DIT_WIDE["depth"]
# the same hidden size in 3 heads of 384: the model path of the streamed bf16
# kernels and of the *_wide fp32 kernels in two chunks, the same calls
DIT_WIDE_384 = {**DIT_WIDE, "num_heads": 3}
DIT_WIDE_384_SHAPE = (2, DIT_TOKENS, 3, DIT_WIDE["hidden_size"] // 3)
# bf16 loss and gradients, card vs CPU, both in bf16 but rounding at other
# places: the loss within this share of itself, each gradient within
# WIDE_BF16_GRAD_RTOL of its parameter's largest gradient entry (as the card
# tests' small bf16 DiTs)
WIDE_BF16_LOSS_RTOL, WIDE_BF16_GRAD_RTOL = 3e-2, 6e-2
DROPOUT_SHAPES = ((1024, 1024), (64, 1024, 384), (256, 64, 64, 64))
# the DiT glue kernels at the latent serve shape (a call's 64 rows of 1024
# tokens) and DiT-S/2's widths: hidden 384, qkv 1152, MLP 1536; the calls of
# one DiT-S/2 forward at each (kernel, C), 0 where it makes none
GLUE_ROWS, GLUE_WIDTHS = (LATENT["batch"], DIT_TOKENS), (384, 1152, 1536)
GLUE_CALLS = {("ln_modulate", 384): 2 * DIT_DEPTH + 1, ("bias_act", 1152): DIT_DEPTH,
              ("bias_act_gelu", 1536): DIT_DEPTH, ("gated_residual", 384): 2 * DIT_DEPTH}
# FLUX.1 [schnell] at its published widths and 1024 px, cut in depth to the
# benchmark's flux1-schnell-4d8s (4 double + 8 single blocks): 256 text and
# 4096 image tokens, 24 heads of 128; the ConvVAE decode to 1024x1024x3
FLUX = dict(backbone="flux", image_size=128, in_channels=16, patch_size=2, hidden_size=3072,
            num_heads=24, mlp_ratio=4.0, depth=4, depth_single_blocks=8, context_in_dim=4096,
            context_tokens=256, vec_in_dim=768, axes_dim=(16, 56, 56), theta=10000,
            qkv_bias=True)
FLUX_VAE = dict(image_size=1024, in_channels=3, latent_channels=16, base_channels=64,
                downsample=8)
# The ConvVAE decode's GroupNorm + SiLU slabs (H, W, C), every one past a
# cluster's shared memory (gn_silu's streamed plan), at the decode's batch:
# the DiT serve cell's 64 (rfbench's dit-s2-latent.serve.p12-s4) and FLUX's 1;
# each decode also runs its conv3x3 sites (DiT: 256 -> 128 at 128^2 and 128 ->
# 64 at 256^2; FLUX: 256 -> 128 at 256^2; wider images are outside the kernel)
DECODE_GN = {"dit": (64, ((64, 64, 256), (128, 128, 128), (256, 256, 64))),
             "flux": (1, ((128, 128, 256), (256, 256, 128), (512, 512, 64), (1024, 1024, 64)))}
DECODE_CONV3X3 = {"dit": 2, "flux": 1}
# inputs cycled through at least this many bytes when a streamed GroupNorm is
# timed, so that no launch finds its input in the 50 MB L2
L2_FLUSH_BYTES = 128 << 20
FLUX_TXT, FLUX_IMG = FLUX["context_tokens"], (FLUX["image_size"] // FLUX["patch_size"]) ** 2
FLUX_HEAD_DIM = FLUX["hidden_size"] // FLUX["num_heads"]
FLUX_FLASH_SHAPE = (1, FLUX_TXT + FLUX_IMG, FLUX["num_heads"], FLUX_HEAD_DIM)
# qk_norm_rope's streams at batch 1: (rows, first row in the joint buffer,
# launches in one forward): a double block's text and image, a single block's
FLUX_QKR_STREAMS = ((FLUX_TXT, 0, FLUX["depth"]), (FLUX_IMG, FLUX_TXT, FLUX["depth"]),
                    (FLUX_TXT + FLUX_IMG, 0, FLUX["depth_single_blocks"]))
# the fp32 forward on the card against the plain float32 FLUX on the card:
# within this share of the output's largest entry (fp32 sums in other orders
# through 12 blocks, flash in 3xTF32: 2.1e-6 on an H100; the reference with
# RoPE left out reads 6.8e-3 and must fail it); the bf16 forward within the
# rms share (8.3e-3 on an H100: one rounding a pass)
FLUX_F32_ATOL, FLUX_BF16_RMS = 1e-4, 5e-2
# The CLI phase: the port's main(argv) on configs/config.yaml with every width
# and recipe setting its own, every path under build/cli_smoke/, and these cuts
# of scale (config values in the comments). quality_samples stays at or above
# 480, the SynthNet feature width, so that fid_deep takes the d x d branch of
# fid_from_features that the config's 1000 take (below it, an n x n SVD).
CLI = dict(
    num_mock_images=256,    # 100: a larger corpus, so a batch-64 epoch has 4 steps
    base_epochs=4,          # 600
    reflow_epochs=2,        # 200 (K = 2 more rounds of reflow_epochs // 2 = 1 epoch)
    num_pairs=512,          # 20000
    num_runs=2,             # 5
    quality_samples=512,    # 1000
)
CLI_KERNELS = ("gn_silu", "conv3x3", "attention_block", "gn_silu_dropout", "gn_silu_backward")
# the CLI's quality gates: FID_BOOT bootstrap replicates a fid_deep
FID_BOOT = 16
# The resume phase: both trainers on the flagship UNet (bf16 on fp32 masters,
# EMA, device-resident epochs), a seeded corpus, 8 steps an epoch, the state
# saved every epoch; the reflow pairs from the trained teacher at 4 heun steps
RESUME = dict(images=1024, batch=128, epochs=3, lr=2e-4, ema=0.999, pairs=1024, pair_batch=256,
              teacher_steps=4)
# two uninterrupted runs give one sample of the card's run-to-run spread
# (cuDNN's backward sums in its own order); the resumed run's distance from
# the first is another sample of it: held to twice the measured spread, plus
# a floor for a card that repeats runs bit for bit (loss: relative; weights
# and EMA: largest |difference| of an entry)
RESUME_SPREAD_FACTOR, RESUME_FLOOR = 2.0, 1e-6
# The HTTP phase: concurrent clients with these request sizes (client i
# sends n = sizes[i % 4] again and again), readings of window_s seconds at
# each step count, the batcher's coalescing window
HTTP = dict(clients=16, sizes=(1, 4, 16, 64), steps=(4, 1), readings=3, window_s=2.5,
            max_wait_ms=5.0)
# The metric networks on the card against the CPU, both in exact fp32 with
# other summation orders (cuDNN may take Winograd or FFT convolutions): rtol,
# atol per entry, on the first cpu_slice images; train_synthnet on synth_n
# training images at batch synth_batch (3 steps), its update (weights minus
# init) on the card within synth_rtol of the CPU's, relative to its norm:
# 34x the 5.9e-4 measured on an H100, 1/26 of the 0.52 of a run at half the
# lr (a weight decay 100x too large moves the update by ~5e-4: not seen)
METRIC_NETS = dict(cpu_slice=4, rtol=1e-3, atol=1e-5, synth_n=24, synth_batch=8,
                   synth_rtol=0.02)

# The Winograd phase: the gate the user sets by name (as in the JAX package),
# set by the script only inside ``winograd_gate`` and restored after. Per
# conv shape: fp32 within WINOGRAD_F32_RTOL of the largest |y| of cuDNN's fp32
# conv with TF32 off (the transforms round at the outputs' scale); bf16 error
# against that fp32 truth at most WINOGRAD_BF16_FACTOR times the conv3x3
# kernel's (floor 1e-3: tests/test_winograd.py's contract). The flagship
# forward in bf16: the same contract against the fp32 forward. One bf16 train
# step (dropout 0.1): loss within WINOGRAD_LOSS_RTOL of the gate-off step's,
# each conv site's weight-gradient norm within WINOGRAD_GRAD_RTOL (bf16
# rounding at other points through ~60 layers forward and backward).
WINOGRAD_GATE = "RFV_CONV_WINOGRAD"
WINOGRAD_F32_RTOL, WINOGRAD_BF16_FACTOR, WINOGRAD_BF16_FLOOR = 1e-4, 4.0, 1e-3
WINOGRAD_LOSS_RTOL, WINOGRAD_GRAD_RTOL = 1e-2, 2e-2
WINOGRAD_READINGS = 10  # CUDA-event readings a time, their median kept


def all_counts(build, **counts):
    """Expected launch counts by kernel: ``counts``, and 0 for every other."""
    return {name: counts.get(name, 0) for name in build.LAUNCHES}


def gn_streamed(h: int, w: int, c: int, es: int, groups: int = 8) -> bool:
    """Whether gn_silu's forward takes the streamed plan at a slab (H, W, C)
    of ``es``-byte elements: the cluster plan needs 16-byte vectors within a
    group and an eighth of the slab in one block's shared memory
    (``csrc/gn_silu.cuh`` ``plan``)."""
    vec = 16 // es
    while (c // groups) % vec:
        vec //= 2
    return vec * es != 16 or -(-h * w // 8) * c * es > 232448 - 8192


# gn_silu sites of an fp32 flagship UNet forward on the streamed plan: its
# (64, 64, 192) slab, 3 MB in fp32 (checked against the forward's shapes in
# main); in bf16 every flagship slab takes the cluster plan
UNET_F32_STREAMED = 1


def fp32_unet(counts: dict, forwards: int = 1) -> dict:
    """``counts`` (EVAL_FORWARD_LAUNCHES or TRAIN_STEP_LAUNCHES) for an fp32
    flagship UNet: UNET_F32_STREAMED of its gn_silu calls a forward count as
    gn_silu_streamed."""
    n = UNET_F32_STREAMED * forwards
    return dict(counts, gn_silu=counts["gn_silu"] - n, gn_silu_streamed=n)


def vae_counts(decodes: int, which: str, **more) -> dict:
    """The ConvVAE's launches in ``decodes`` decodes of the ``which`` path
    (DECODE_GN, DECODE_CONV3X3), added to ``more``."""
    out = dict(more)
    out["gn_silu_streamed"] = out.get("gn_silu_streamed", 0) + decodes * len(DECODE_GN[which][1])
    out["conv3x3"] = out.get("conv3x3", 0) + decodes * DECODE_CONV3X3[which]
    return out


def dit_glue(blocks: int, heads: int) -> dict:
    """The DiT glue kernels' launches for ``blocks`` DiT block forwards and
    ``heads`` head forwards, under autograd or not (a block: two LayerNorms,
    two epilogues, two gated residuals; the head: its LayerNorm; the
    backward launches none)."""
    return dict(ln_modulate=2 * blocks + heads, bias_act=2 * blocks, gated_residual=2 * blocks)


def nonzero(counts):
    """The kernels that were launched, for a log line."""
    return {name: n for name, n in counts.items() if n}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if res.returncode != 0:
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = 10) -> float:
    """Mean device time of ``fn()`` over ``reps`` launches (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def record_main_path_shapes(torch, UNet, fused_mod, train=False):
    """Shapes each kernel gets in one flagship forward (eval, or train with
    dropout), with multiplicity, from a batch-1 CPU forward through the plain
    versions."""
    calls = {"gn_silu": Counter(), "conv3x3": Counter(), "attention_block": Counter(),
             "gn_silu_dropout": Counter()}
    G, C, A, D = fused_mod.G, fused_mod.C, fused_mod.A, fused_mod.D

    def spy(name, fn, key):
        def inner(*args, **kw):
            calls[name][key(*args)] += 1
            return fn(*args, **kw)
        return inner

    net = UNet()
    x = torch.zeros((1, 64, 64, 3))
    t = torch.zeros((1,))
    with mock.patch.object(G, "gn_silu_plain", spy(
            "gn_silu", G.gn_silu_plain, lambda x, *a: tuple(x.shape[1:]))), \
         mock.patch.object(C, "conv3x3_plain", spy(
             "conv3x3", C.conv3x3_plain, lambda x, w, b: tuple(x.shape[1:]) + (w.shape[0],))), \
         mock.patch.object(A, "attention_block_plain", spy(
             "attention_block", A.attention_block_plain, lambda x, *a: tuple(x.shape[1:]))), \
         mock.patch.object(D, "gn_silu_dropout_plain", spy(
             "gn_silu_dropout", D.gn_silu_dropout_plain, lambda x, *a: tuple(x.shape[1:]))):
        with torch.no_grad():
            if train:
                net(x, t, train=True, masters=True,
                    seeds=torch.zeros(net.num_dropout_seeds, dtype=torch.int32))
            else:
                net(x, t)
    # gn_silu_dropout_plain is gn_silu_plain plus the mask: take its inner call out
    calls["gn_silu"] -= calls["gn_silu_dropout"]
    return calls


def kernel_cases(torch, shape_calls, train_calls):
    """(name, shape, count, make_inputs(dtype) -> (kernel, plain, library), bytes_fn, flops).
    ``shape_calls`` are the eval forward's shapes, ``train_calls`` the train
    forward's: gn_silu_dropout at its sites (and dropout_mask_apply, which
    the train step no longer runs, at the same), gn_silu_backward at every
    GroupNorm site of the step."""
    import torch.nn.functional as F

    from rectified_flow_vision_tpu_torch.ops import attention as A
    from rectified_flow_vision_tpu_torch.ops import conv3x3 as C
    from rectified_flow_vision_tpu_torch.ops import gn_silu as G
    from rectified_flow_vision_tpu_torch.ops import gn_silu_dropout as D

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, dtype=torch.float32, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale + shift).to(dtype)

    def uniform(*shape, bound, dtype):
        u = torch.rand(shape, generator=gen, device=dev)
        return ((u * 2 - 1) * bound).to(dtype)

    cases = []
    for (h, w, c), n in sorted(shape_calls["gn_silu"].items()):
        def make(dt, h=h, w=w, c=c):
            x = randn(BATCH, h, w, c, dtype=dt, scale=2.0, shift=0.3)
            s = randn(c, scale=0.2, shift=1.0)
            b = randn(c, scale=0.2)
            sl, bl = s.to(dt), b.to(dt)
            return (
                lambda: G.gn_silu_cuda(x, s, b),
                lambda: (G.gn_silu_plain(x, s, b), G.gn_stats_plain(x)),
                lambda: F.silu(F.group_norm(x.permute(0, 3, 1, 2), 8, sl, bl)),
            )
        elems = BATCH * h * w * c
        cases.append(("gn_silu", (BATCH, h, w, c), n, make,
                      lambda es, e=elems, c=c: 2 * e * es + 2 * c * 4, 10 * elems))
    # the streamed plan at the ConvVAE decode's slabs: the kernel's input
    # cycled past the L2 between timed launches; the eager composition's
    # arithmetic is the plain version's (gn_silu_plain)
    from rectified_flow_vision_tpu_torch.ops import build

    for which, (batch, slabs) in DECODE_GN.items():
        for h, w, c in slabs:
            def make(dt, h=h, w=w, c=c, batch=batch):
                xs = [randn(batch, h, w, c, dtype=dt, scale=2.0, shift=0.3)]
                nbytes = xs[0].numel() * xs[0].element_size()
                while len(xs) * nbytes < L2_FLUSH_BYTES:
                    xs.append(xs[0].roll(len(xs), dims=1))
                s = randn(c, scale=0.2, shift=1.0)
                b = randn(c, scale=0.2)
                sl, bl = s.to(dt), b.to(dt)
                turn = [0]

                def kernel():
                    before = build.LAUNCHES["gn_silu_streamed"]
                    out = G.gn_silu_cuda(xs[turn[0] % len(xs)], s, b)
                    turn[0] += 1
                    if build.LAUNCHES["gn_silu_streamed"] != before + 1:
                        fail(f"gn_silu at {(batch, h, w, c)} {dt} did not take the streamed plan")
                    return out
                x = xs[0]
                return (
                    kernel,
                    lambda: (G.gn_silu_plain(x, s, b), G.gn_stats_plain(x)),
                    lambda: F.silu(F.group_norm(x.permute(0, 3, 1, 2), 8, sl, bl)),
                )
            elems = batch * h * w * c
            calls = 1 if which == "dit" else 0  # a DiT serve decode's
            cases.append(("gn_silu_streamed", (batch, h, w, c), calls, make,
                          lambda es, e=elems, c=c, n=batch: 2 * e * es + 2 * c * 4 + 8 * 8 * n,
                          10 * elems))
    seed = torch.tensor([SEED + 17], dtype=torch.int32, device=dev)
    drop_calls = train_calls["gn_silu_dropout"]
    for (h, w, c), n in sorted(drop_calls.items()):
        def make(dt, h=h, w=w, c=c):
            x = randn(BATCH, h, w, c, dtype=dt, scale=2.0, shift=0.3)
            s = randn(c, scale=0.2, shift=1.0)
            b = randn(c, scale=0.2)
            sl, bl = s.to(dt), b.to(dt)
            return (
                lambda seed=seed: D.gn_silu_dropout_cuda(x, s, b, seed, DROP_RATE),
                lambda: (D.gn_silu_dropout_plain(x, s, b, seed, DROP_RATE), G.gn_stats_plain(x)),
                lambda: F.dropout(F.silu(F.group_norm(x.permute(0, 3, 1, 2), 8, sl, bl)),
                                  DROP_RATE, training=True),
            )
        elems = BATCH * h * w * c
        cases.append(("gn_silu_dropout", (BATCH, h, w, c), n, make,
                      lambda es, e=elems, c=c: 2 * e * es + 2 * c * 4 + 4, 30 * elems))

        def make(dt, h=h, w=w, c=c):
            g = randn(BATCH, h, w, c, dtype=dt)
            return (
                lambda seed=seed: D.dropout_mask_apply_cuda(g, seed, DROP_RATE),
                lambda: D.dropout_mask_apply_plain(g, seed, DROP_RATE),
                lambda: F.dropout(g, DROP_RATE, training=True),
            )
        cases.append(("dropout_mask_apply", (BATCH, h, w, c), n, make,
                      lambda es, e=elems: 2 * e * es + 4, 20 * elems))
    # the backward kernel at the step's gn_silu sites, then with the mask at
    # its gn_silu_dropout sites
    bwd_sites = [(hwc, n, False) for hwc, n in sorted(train_calls["gn_silu"].items())]
    bwd_sites += [(hwc, n, True) for hwc, n in sorted(drop_calls.items())]
    for (h, w, c), n, drop in bwd_sites:
        def make(dt, h=h, w=w, c=c, drop=drop):
            x = randn(BATCH, h, w, c, dtype=dt, scale=2.0, shift=0.3)
            s = randn(c, scale=0.2, shift=1.0)
            b = randn(c, scale=0.2)
            # a cotangent that follows the output, so that the group means
            # of dz * scale and dz * scale * xhat in dx are of dx's order
            g = (G.gn_silu_plain(x, s, b).float() + randn(BATCH, h, w, c)).to(dt)
            _, stats = G.gn_silu_cuda(x, s, b)
            plain_stats = G.gn_stats_plain(x)
            leaves = [t.detach().clone().to(dt).requires_grad_()
                      for t in (x.permute(0, 3, 1, 2), s, b)]
            lib_out = F.silu(F.group_norm(leaves[0], 8, leaves[1], leaves[2]))
            if drop:
                lib_out = F.dropout(lib_out, DROP_RATE, training=True)
                kernel = lambda seed=seed: D.gn_silu_dropout_backward_cuda(  # noqa: E731
                    x, g, s, b, stats, seed, DROP_RATE)
                plain = lambda: D.gn_silu_dropout_backward_plain(  # noqa: E731
                    x, g, s, b, plain_stats, seed, DROP_RATE)
            else:
                kernel = lambda: G.gn_silu_backward_cuda(x, g, s, b, stats)  # noqa: E731
                plain = lambda: G.gn_silu_backward_plain(x, g, s, b, plain_stats)  # noqa: E731
            g_cl = g.permute(0, 3, 1, 2)
            return (kernel, plain,
                    lambda: torch.autograd.grad(lib_out, leaves, g_cl, retain_graph=True))
        elems = BATCH * h * w * c
        cases.append(("gn_silu_backward", (BATCH, h, w, c), n, make,
                      lambda es, e=elems, c=c: 3 * e * es + 16 * c + 8 * 8 * BATCH, 40 * elems))
    for (h, w, cin, cout), n in sorted(shape_calls["conv3x3"].items()):
        def make(dt, h=h, w=w, cin=cin, cout=cout):
            x = randn(BATCH, h, w, cin, dtype=dt)
            wt = uniform(cout, 3, 3, cin, bound=1 / math.sqrt(9 * cin), dtype=dt)
            b = uniform(cout, bound=1 / math.sqrt(9 * cin), dtype=torch.float32)
            x_cl, w_cl, bl = x.permute(0, 3, 1, 2), wt.permute(0, 3, 1, 2), b.to(dt)
            return (
                lambda: C.conv3x3_cuda(x, wt, b),
                lambda: C.conv3x3_plain(x, wt, b),
                lambda: F.conv2d(x_cl, w_cl, bl, padding=1),
            )
        m = BATCH * h * w
        cases.append(("conv3x3", (BATCH, h, w, cin, cout), n, make,
                      lambda es, m=m, cin=cin, cout=cout:
                      (m * cin + m * cout + 9 * cin * cout) * es + cout * 4,
                      2 * m * 9 * cin * cout))
    # the flagship's 16x16 mid block, and a 128x128 UNet's 32x32 one (1024
    # tokens; no path of this script runs it: 0 calls)
    attn_shapes = sorted(shape_calls["attention_block"].items()) + [(ATTN_1024, 0)]
    for (h, w, c), n in attn_shapes:
        def make(dt, h=h, w=w, c=c):
            x = randn(BATCH, h, w, c, dtype=dt)
            bound = 1 / math.sqrt(c)
            ns, nb = randn(c, scale=0.2, shift=1.0), randn(c, scale=0.2)
            wq, bq = uniform(3 * c, c, bound=bound, dtype=dt), uniform(3 * c, bound=bound, dtype=torch.float32)
            wp, bp = uniform(c, c, bound=bound, dtype=dt), uniform(c, bound=bound, dtype=torch.float32)
            args = (x, ns, nb, wq, bq, wp, bp)
            heads, nt = 4, h * w

            def library():
                xn = F.group_norm(x.permute(0, 3, 1, 2), 8, ns.to(dt), nb.to(dt))
                qkv = F.linear(xn.permute(0, 2, 3, 1).reshape(BATCH, nt, c), wq, bq.to(dt))
                q, k, v = (u.reshape(BATCH, nt, heads, c // heads).transpose(1, 2)
                           for u in qkv.split(c, dim=-1))
                o = F.scaled_dot_product_attention(q, k, v)
                o = F.linear(o.transpose(1, 2).reshape(BATCH, nt, c), wp, bp.to(dt))
                return x + o.reshape(BATCH, h, w, c)

            return (
                lambda: A.attention_block_cuda(*args),
                lambda: A.attention_block_plain(*args),
                library,
            )
        nt = h * w
        flops = BATCH * (2 * nt * c * 3 * c + 4 * nt * nt * c + 2 * nt * c * c)
        cases.append(("attention_block", (BATCH, h, w, c), n, make,
                      lambda es, c=c, nt=nt: (2 * BATCH * nt * c + 4 * c * c) * es + 6 * c * 4,
                      flops))
    return (cases + flash_cases(torch, randn) + dropout_cases(torch, randn, seed)
            + glue_cases(torch, randn) + qk_norm_rope_cases(torch, randn))


def flash_fwd_cost(shape):
    """(bytes at 2 bytes an element, flops) of one forward call: q, k, v read
    and o written once, the fp32 lse written; 4 B H T^2 D flops."""
    b, t, h, d = shape
    return 4 * b * t * h * d * 2 + 4 * b * h * t, 4 * b * h * t * t * d


def flash_bwd_cost(shape):
    """(bytes, flops) of one backward call: q, k, v, o, d_out read and dq, dk,
    dv written once, lse read; five products of 2 B H T^2 D flops each."""
    b, t, h, d = shape
    return 8 * b * t * h * d * 2 + 4 * b * h * t, 10 * b * h * t * t * d


def flash_cases(torch, randn):
    """Flash attention forward at the DiT-S/2 latent shapes (12 calls per DiT
    forward at batch 256; 24 per ``remat`` train step at batch 64), at 16384
    tokens, at DiT-XL/2's widths, at the odd head widths and at the shapes of
    the DiTs with 6 heads of 192 and 3 heads of 384 (6 calls in each run)
    and at FLUX's joint attention (12 calls a forward of 4 + 8 blocks),
    and its backward at batch 64 (12 calls per train step), at the same
    widths and at those DiTs' shapes (2 calls each). q, k, v are the three views of
    one [B, T, 3, H, D] tensor, as DiT hands them over. Bound: forward
    4 B H T^2 D flops, backward 2.5 times that; every input read once, every
    output written once."""
    import torch.nn.functional as F

    from rectified_flow_vision_tpu_torch.ops import flash_attention as FA

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)).transpose(1, 2)

    fwd_calls = {FLASH_FWD_SHAPES[0]: DIT_DEPTH, FLASH_FWD_SHAPES[1]: 2 * DIT_DEPTH,
                 DIT_WIDE_SHAPE: DIT_WIDE_FWD_CALLS, DIT_WIDE_384_SHAPE: DIT_WIDE_FWD_CALLS,
                 FLUX_FLASH_SHAPE: FLUX["depth"] + FLUX["depth_single_blocks"]}
    cases = []
    for shape in (FLASH_FWD_SHAPES + (FLASH_XL_SHAPE,) + FLASH_ODD_SHAPES
                  + (DIT_WIDE_SHAPE, DIT_WIDE_384_SHAPE, FLUX_FLASH_SHAPE)):
        b, t, h, d = shape

        def make(dt, shape=shape):
            b, t, h, d = shape
            q, k, v = randn(b, t, 3, h, d, dtype=dt).unbind(2)
            return (
                lambda: FA.flash_attention_cuda(q, k, v)[0],
                lambda: FA.flash_attention_plain(q, k, v),
                lambda: sdpa(q, k, v),
            )
        elems = b * t * h * d
        cases.append(("flash_attention", shape, fwd_calls.get(shape, 0), make,
                      lambda es, e=elems, r=b * h * t: 4 * e * es + 4 * r,
                      flash_fwd_cost(shape)[1]))

    for shape, calls in ((FLASH_BWD_SHAPE, DIT_DEPTH), (FLASH_XL_SHAPE, 0),
                         *((odd, 0) for odd in FLASH_ODD_SHAPES),
                         (DIT_WIDE_SHAPE, DIT_WIDE_BWD_CALLS),
                         (DIT_WIDE_384_SHAPE, DIT_WIDE_BWD_CALLS)):
        def make(dt, shape=shape):
            b, t, h, d = shape
            q, k, v = randn(b, t, 3, h, d, dtype=dt).unbind(2)
            g = randn(b, t, h, d, dtype=dt)
            out, lse = FA.flash_attention_cuda(q, k, v)
            leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
            lib_out = sdpa(*leaves)
            return (
                lambda: FA.flash_attention_backward_cuda(q, k, v, out, lse, g),
                lambda: FA.flash_attention_backward_plain(q, k, v, out, lse, g),
                lambda: torch.autograd.grad(lib_out, leaves, g, retain_graph=True),
            )
        b, t, h, d = shape
        elems = b * t * h * d
        cases.append(("flash_attention_backward", shape, calls, make,
                      lambda es, e=elems, r=b * h * t: 8 * e * es + 4 * r,
                      flash_bwd_cost(shape)[1]))
    return cases


FLASH_KERNELS = (("flash_fwd", "forward"), ("flash_delta", "delta"), ("flash_dkv", "dkv"),
                 ("flash_dq", "dq"))


def flash_breakdown(torch) -> None:
    """Each flash kernel alone: device ms per call by kernel (forward;
    delta, dkv and dq of the backward) from the profiler over 10 calls each,
    with TFLOP/s (of the products each kernel runs, at the true head width)
    and the share of the bound, beside SDPA's forward and backward timed with
    CUDA events in the same run. bf16 at the DiT-S/2 shapes (forward at batch
    256, backward at batch 64), at DiT-XL/2's widths and at head widths 256
    (the kernels above 128) and 320 (the streamed kernels, which compute S
    and dP twice there); fp32 (the 3xTF32 kernels) at DiT-S/2's and
    DiT-XL/2's widths at batch 64, against two bounds: 3xTF32 on the tensor
    cores (the route the kernels take) and the fp32 CUDA cores. The split
    backward recomputes S and dP in dq (seven products where the bound counts
    five), so it can reach at most 5/7 of its bound."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from rectified_flow_vision_tpu_torch.ops import flash_attention as FA

    reps = 10
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    wide = [s for s in FLASH_ODD_SHAPES if s[3] in (FA.HEAD_DIM_WIDE, 320)]
    cases = [(s, "bfloat16") for s in (FLASH_FWD_SHAPES[0], FLASH_BWD_SHAPE, FLASH_XL_SHAPE, *wide)]
    cases += [(FLASH_BWD_SHAPE, "float32"), (FLASH_XL_SHAPE, "float32")]
    for shape, dname in cases:
        b, t, h, d = shape
        dt = getattr(torch, dname)
        q, k, v = (torch.randn((b, t, 3, h, d), generator=gen, device="cuda")
                   .to(dt).unbind(2))
        g = torch.randn((b, t, h, d), generator=gen, device="cuda").to(dt)
        out, lse = FA.flash_attention_cuda(q, k, v)

        def run():
            for _ in range(reps):
                FA.flash_attention_cuda(q, k, v)
                FA.flash_attention_backward_cuda(q, k, v, out, lse, g)

        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        path = ROOT / "build" / "flash_breakdown_trace.json"
        path.parent.mkdir(exist_ok=True)
        prof.export_chrome_trace(str(path))
        ms = Counter()
        for e in json.loads(path.read_text())["traceEvents"]:
            if e.get("cat") == "kernel" and "dur" in e:
                for key, label in FLASH_KERNELS:
                    if key in e["name"]:
                        ms[label] += e["dur"] / 1e3 / reps
                        break
        if set(ms) != {label for _, label in FLASH_KERNELS}:
            fail(f"flash breakdown {shape} {dname}: the trace holds {dict(ms)}")

        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        tq, tk, tv = (x.transpose(1, 2) for x in leaves)
        sdpa_f = time_ms(torch, lambda: F.scaled_dot_product_attention(tq, tk, tv))
        lib_out = F.scaled_dot_product_attention(tq, tk, tv).transpose(1, 2)
        sdpa_b = time_ms(torch, lambda: torch.autograd.grad(lib_out, leaves, g, retain_graph=True))
        del leaves, tq, tk, tv, lib_out

        es = 2 if dt == torch.bfloat16 else 4
        # bound name -> rate of the products; the bytes at this dtype's width
        rates = ({"bound": PEAK_FLOPS["bfloat16"]} if dt == torch.bfloat16 else
                 {"3xTF32 bound": TF32X3_FLOPS, "CUDA-core bound": PEAK_FLOPS["float32"]})
        elems, rows = b * t * h * d, b * h * t
        fwd_cost = (4 * elems * es + 4 * rows, flash_fwd_cost(shape)[1])
        bwd_cost = (8 * elems * es + 4 * rows, flash_bwd_cost(shape)[1])

        def shares(cost, kernel_ms):  # "0.xxx of its <bound> y.yyyy" for each bound
            nbytes, flops = cost
            out = []
            for name, rate in rates.items():
                bound = max(nbytes / HBM_BYTES_PER_S, flops / rate) * 1e3
                out.append(f"{bound / kernel_ms:.3f} of its {name} {bound:.4f}")
            return ", ".join(out)

        prod = 2 * b * h * t * t * d  # flops of one T x T x D product
        delta_bytes = 2 * elems * es + 4 * rows
        bwd = ms["delta"] + ms["dkv"] + ms["dq"]
        log(f"flash kernels {shape} {'bf16' if es == 2 else 'fp32'}, ms per call (profiler): "
            f"forward {ms['forward']:.4f} ({2 * prod / ms['forward'] / 1e9:.1f} TFLOP/s, "
            f"{shares(fwd_cost, ms['forward'])}) vs SDPA {sdpa_f:.4f} "
            f"({2 * prod / sdpa_f / 1e9:.1f} TFLOP/s, {shares(fwd_cost, sdpa_f)}); backward "
            f"{bwd:.4f} = delta {ms['delta']:.4f} ({delta_bytes / ms['delta'] / 1e6:.1f} GB/s) + "
            f"dkv {ms['dkv']:.4f} ({4 * prod / ms['dkv'] / 1e9:.1f} TFLOP/s) + dq {ms['dq']:.4f} "
            f"({3 * prod / ms['dq'] / 1e9:.1f} TFLOP/s), {shares(bwd_cost, bwd)} (at most 5/7 "
            f"for the split design) vs SDPA {sdpa_b:.4f} ({5 * prod / sdpa_b / 1e9:.1f} TFLOP/s, "
            f"{shares(bwd_cost, sdpa_b)})")
        del q, k, v, g, out, lse
        torch.cuda.empty_cache()


def flash_f64_gate(torch) -> None:
    """What exact fp32 stood for, held for the fp32 flash kernels up to D =
    128 (3xTF32 on the tensor cores): at (2, 1024, 4, D) for each of
    F64_GATE_WIDTHS and inputs N(0, sigma^2) for each of F64_GATE_SIGMAS, the
    kernels' and the plain fp32 version's (TF32 off, as main sets it) max
    |error| against a float64 computation, for the output and each of dq, dk
    and dv; the kernels' at most F64_GATE times the plain version's."""
    from rectified_flow_vision_tpu_torch.ops import flash_attention as FA

    if torch.backends.cuda.matmul.allow_tf32:
        fail("the float64 gate needs the plain version in full fp32 (allow_tf32 off)")
    notes = []
    for d in F64_GATE_WIDTHS:
        for sigma in F64_GATE_SIGMAS:
            gen = torch.Generator(device="cuda").manual_seed(SEED + 40 + d)
            q, k, v = (torch.randn((2, DIT_TOKENS, 3, 4, d), generator=gen, device="cuda")
                       * sigma).unbind(2)
            g = torch.randn((2, DIT_TOKENS, 4, d), generator=gen, device="cuda")
            leaves = [x.double().transpose(1, 2).requires_grad_() for x in (q, k, v)]
            ref_out = torch.softmax(leaves[0] @ leaves[1].transpose(-1, -2) / math.sqrt(d),
                                    dim=-1) @ leaves[2]
            ref_grads = torch.autograd.grad(ref_out, leaves, g.double().transpose(1, 2))
            ref = [x.transpose(1, 2) for x in (ref_out.detach(), *ref_grads)]
            out, lse = FA.flash_attention_cuda(q, k, v)
            kernel = (out, *FA.flash_attention_backward_cuda(q, k, v, out, lse, g))
            p_out = FA.flash_attention_plain(q, k, v)
            plain = (p_out, *FA.flash_attention_backward_plain(
                q, k, v, p_out, FA.flash_attention_lse_plain(q, k), g))
            errs = []
            for name, a, p, r in zip(("out", "dq", "dk", "dv"), kernel, plain, ref):
                err_k = float((a.double() - r).abs().max())
                err_p = float((p.double() - r).abs().max())
                errs.append(f"{name} {err_k:.3e} / {err_p:.3e} ({err_k / err_p:.2f}x)")
                if not err_k <= F64_GATE * err_p:
                    fail(f"fp32 flash D {d} N(0, {sigma}^2): {name} error against float64 "
                         f"{err_k:.3e}, more than {F64_GATE} x the plain fp32 version's "
                         f"{err_p:.3e}")
            notes.append(f"D {d} sigma {sigma}: " + ", ".join(errs))
            del q, k, v, g, leaves, ref_out, ref_grads, ref, out, lse, kernel, p_out, plain
    log(f"flash fp32 (3xTF32) vs float64 at (2, {DIT_TOKENS}, 4, D), max |error| kernel / plain "
        f"fp32 (gate: kernel <= {F64_GATE} x plain): " + "; ".join(notes))


def dropout_cases(torch, randn, seed):
    import torch.nn.functional as F

    from rectified_flow_vision_tpu_torch.ops import dropout as DR

    cases = []
    for shape in DROPOUT_SHAPES:
        def make(dt, shape=shape):
            x = randn(*shape, dtype=dt)
            return (
                lambda seed=seed: DR.dropout_cuda(x, seed, DROP_RATE),
                lambda: DR.dropout_plain(x, seed, DROP_RATE),
                lambda: F.dropout(x, DROP_RATE, training=True),
            )
        elems = math.prod(shape)
        cases.append(("dropout", shape, 1, make, lambda es, e=elems: 2 * e * es + 4, 20 * elems))
    return cases


def glue_cases(torch, randn):
    """The DiT glue kernels at GLUE_ROWS x GLUE_WIDTHS against their plain
    versions (the eager composition) on the same inputs; shift, scale and
    gate are strided views of one [B, 6C] projection, as ``DiTBlock`` reads
    them. ln_modulate's shift and scale are zero there, so that the
    comparison holds the LayerNorm itself to one bf16 ulp (the modulation's
    bit-equality is a card test's). Library: one PyTorch call of the same
    bytes (``F.layer_norm``, an add, ``F.gelu``, ``torch.addcmul``)."""
    import torch.nn.functional as F

    from rectified_flow_vision_tpu_torch.ops import dit_glue as DG

    cases = []
    b, t = GLUE_ROWS
    for c in GLUE_WIDTHS:
        def make(dt, c=c, kind=None):
            x = randn(b, t, c, dtype=dt, scale=1.7, shift=0.4)
            y = randn(b, t, c, dtype=dt, scale=2.0)
            mod = randn(b, 6 * c, dtype=dt, scale=0.6)
            bias = randn(c, dtype=dt).float()
            zero = torch.zeros_like(mod).chunk(6, dim=-1)
            gate, bl = mod.chunk(6, dim=-1)[2], bias.to(dt)
            if kind == "ln_modulate":
                return (lambda: DG.ln_modulate_cuda(x, zero[0], zero[1]),
                        lambda: DG.ln_modulate_plain(x, zero[0], zero[1]),
                        lambda: F.layer_norm(x, (c,), eps=DG.LN_EPS))
            if kind == "gated_residual":
                return (lambda: DG.gated_residual_cuda(x, y, bias, gate),
                        lambda: DG.gated_residual_plain(x, y, bias, gate),
                        lambda: torch.addcmul(x, gate[:, None, :], y))
            act = "gelu_tanh" if kind == "bias_act_gelu" else None
            return (lambda: DG.bias_act_cuda(y, bias, act),
                    lambda: DG.bias_act_plain(y, bias, act),
                    (lambda: F.gelu(y, approximate="tanh")) if act else (lambda: y + bl))
        elems = b * t * c
        for kind, nbytes, flops in (
                ("ln_modulate", lambda es, e=elems, c=c: 2 * e * es + 2 * b * c * es, 8 * elems),
                ("bias_act", lambda es, e=elems, c=c: 2 * e * es + 4 * c, elems),
                ("bias_act_gelu", lambda es, e=elems, c=c: 2 * e * es + 4 * c, 10 * elems),
                ("gated_residual", lambda es, e=elems, c=c: 3 * e * es + b * c * es + 4 * c,
                 3 * elems)):
            cases.append((kind, (b, t, c), GLUE_CALLS.get((kind, c), 0),
                          lambda dt, make=make, kind=kind: make(dt, kind=kind), nbytes, flops))
    return cases


def qk_norm_rope_cases(torch, randn):
    """FLUX's qk_norm_rope at its three streams (FLUX_QKR_STREAMS), each
    launch writing its rows of one joint [1, 4352, 3, 24, 128] buffer, the
    QK-norm scales 1 + 0.3 z and the tables of the 1024 px positions, against
    ``joint_plain`` on the same stream and the tables from its first row.
    Bound by bytes: qkv read and q, k, v written once, the fp32 cos and sin
    rows of its tokens and the two scales read. Library: ``F.rms_norm`` of q
    and k (two thirds of the bytes, no rotation)."""
    import torch.nn.functional as F

    from rectified_flow_vision_tpu_torch.models import flux as TFX
    from rectified_flow_vision_tpu_torch.ops import qk_norm_rope as QR

    heads, d = FLUX["num_heads"], FLUX_HEAD_DIM
    c, total = heads * d, FLUX_TXT + FLUX_IMG
    grid = FLUX["image_size"] // FLUX["patch_size"]
    cos, sin = TFX.rope_tables(TFX.positions(FLUX_TXT, grid, grid, "cuda"), FLUX["axes_dim"],
                               FLUX["theta"])
    cases = []
    for rows, off, calls in FLUX_QKR_STREAMS:
        def make(dt, rows=rows, off=off):
            qkv = randn(1, rows, 3 * c, dtype=dt)
            qs, ks = randn(d, scale=0.3, shift=1.0), randn(d, scale=0.3, shift=1.0)
            out = torch.empty((1, total, 3, heads, d), device="cuda", dtype=dt)
            qk = qkv.view(1, rows, 3, heads, d)[:, :, :2]

            def kernel():
                QR.qk_norm_rope_cuda(qkv, qs, ks, cos, sin, out, off)
                return out[:, off:off + rows]
            return (kernel,
                    lambda: QR.joint_plain([(qkv, qs, ks)], cos[off:], sin[off:], heads),
                    lambda: F.rms_norm(qk, (d,), eps=QR.EPS))
        cases.append(("qk_norm_rope", (1, rows, heads, d), calls, make,
                      lambda es, t=rows: 6 * t * c * es + 4 * (t * d + 2 * d), 16 * rows * c))
    return cases


def as_tuple(out):
    """A kernel's outputs as a tuple (a GroupNorm forward gives two, a
    backward three)."""
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def dropout_checks(torch, name, dname, shape, kernel, got, want) -> str:
    """What only the dropout kernels promise: the plain version's mask bit
    for bit, the dropped fraction, same seed same output, other seed other
    mask. ``got`` / ``want`` are the kernel's and the plain version's outputs."""
    from rectified_flow_vision_tpu_torch.ops import gn_silu_dropout as D

    dev = got.device
    seed = torch.tensor([SEED + 17], dtype=torch.int32, device=dev)
    keep = D.keep_mask(shape, seed, DROP_RATE, dev)
    # a kept element is zero only where the value itself is zero
    wrong = int(((got != 0) != keep)[want != 0].sum()) + int((got[~keep] != 0).sum())
    if wrong:
        fail(f"{name} {dname} {shape}: {wrong} elements off the plain version's mask")
    dropped = 1.0 - float(keep.float().mean())
    if abs(dropped - DROP_RATE) > DROP_FRACTION_TOL:
        fail(f"{name} {dname} {shape}: dropped fraction {dropped:.5f}, rate {DROP_RATE}")
    if not torch.equal(as_tuple(kernel())[0].float(), got):
        fail(f"{name} {dname} {shape}: same seed, other output")
    other = as_tuple(kernel(seed=seed + 1))[0].float()
    if torch.equal(other != 0, got != 0):
        fail(f"{name} {dname} {shape}: another seed gave the same mask")
    return f"mask = plain's, dropped {dropped:.5f}"


def peak_rate(torch, name: str, dname: str, shape) -> float:
    """The card's rate for a kernel's products: bf16 and the fp32 SIMT
    kernels at their type's peak; the fp32 flash kernels up to D = 128 do
    their fp32-accurate products as three TF32 products each (TF32X3_FLOPS)."""
    if (name.startswith("flash") and dname == "float32"
            and kernel_route(torch, dname, shape[3]) == "f32"):
        return TF32X3_FLOPS
    return PEAK_FLOPS[dname]


def kernel_phase(torch, shape_calls, train_calls):
    rows = []
    for name, shape, count, make, bytes_fn, flops in kernel_cases(torch, shape_calls, train_calls):
        for dname, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            if dt == torch.float32 and shape in FLASH_BF16_ONLY:
                continue
            kernel, plain, library = make(dt)
            gots = [t.float() for t in as_tuple(kernel())]
            wants = [t.float() for t in as_tuple(plain())]
            torch.cuda.synchronize()
            for got, want in zip(gots, wants):
                if tuple(got.shape) != tuple(want.shape) or not torch.isfinite(got).all():
                    fail(f"{name} {dname} {shape}: bad shape or non-finite output")
            note = ""
            if name in ("gn_silu_dropout", "dropout_mask_apply", "dropout"):
                note = " | " + dropout_checks(torch, name, dname, shape, kernel, gots[0], wants[0])
            if name == "qk_norm_rope":  # v is copied
                if not torch.equal(gots[0][:, :, 2], wants[0][:, :, 2]):
                    fail(f"qk_norm_rope {dname} {shape}: v is not the plain version's bit for bit")
                note = " | v bit for bit"

            rtol, atol = TOLERANCES[(name, dname)]
            ok, max_abs, max_rel = True, 0.0, 0.0
            for i, (got, want) in enumerate(zip(gots, wants)):  # each against its own scale
                err = (got - want).abs()
                scale = float(want.abs().max())
                rt, at = STATS_TOL if i == 1 and name in SAVES_STATS else (rtol, atol)
                tol = at * max(scale, 1.0) if name in SCALED_ATOL else at
                ok = ok and bool((err <= tol + rt * want.abs()).all())
                max_abs = max(max_abs, float(err.max()))
                max_rel = max(max_rel, float(err.max()) / max(scale, 1e-30))
                del err
            del gots, wants
            k_ms = time_ms(torch, kernel)
            p_ms = time_ms(torch, plain)
            l_ms = time_ms(torch, library)
            es = 2 if dt == torch.bfloat16 else 4
            t_bytes = bytes_fn(es) / HBM_BYTES_PER_S * 1e3
            t_ops = flops / peak_rate(torch, name, dname, shape) * 1e3
            row = dict(
                name=name, dtype=dname, shape=list(shape), calls=count,
                max_abs_err=max_abs, max_rel_err=max_rel, rtol=rtol, atol=atol, ok=ok,
                ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
            )
            rows.append(row)
            rate = ""
            if row["bound_by"] == "operations" or name == "conv3x3":
                rate = (f" | {flops / k_ms / 1e9:.1f} TFLOP/s kernel, "
                        f"{flops / l_ms / 1e9:.1f} library")
            log(f"kernel {name:18s} {dname:8s} {str(tuple(shape)):24s} x{count:<2d} "
                f"max_abs {max_abs:.3e} max_rel {max_rel:.3e} (rtol {rtol}, atol {atol}) "
                f"{'ok' if ok else 'MISMATCH'} | kernel {k_ms:.4f} ms plain {p_ms:.4f} ms "
                f"library {l_ms:.4f} ms bound {row['bound_ms']:.4f} ms ({row['bound_by']})"
                + rate + note)
            del kernel, plain, library
        torch.cuda.empty_cache()
    bad = [r for r in rows if not r["ok"]]
    if bad:
        fail(f"{len(bad)} kernel case(s) outside tolerance: "
             + ", ".join(f"{r['name']} {r['dtype']} {tuple(r['shape'])}" for r in bad))
    return rows


def model_phase(torch, UNet):
    from rectified_flow_vision_tpu_torch.ops import build

    cpu = UNet()
    cpu.reset_parameters(torch.Generator().manual_seed(SEED))
    gpu = UNet()
    gpu.load_state_dict(cpu.state_dict())
    gpu.to("cuda")
    g = torch.Generator().manual_seed(SEED + 1)
    x = torch.randn((4, 64, 64, 3), generator=g)
    t = torch.rand((4,), generator=g)
    build.reset_launches()
    with torch.no_grad():
        want = cpu(x, t)
        got = gpu(x.cuda(), t.cuda()).cpu()
    if dict(build.LAUNCHES) != all_counts(build, **fp32_unet(EVAL_FORWARD_LAUNCHES)):
        fail(f"model forward launches {dict(build.LAUNCHES)}, expected "
             f"{fp32_unet(EVAL_FORWARD_LAUNCHES)}")
    if tuple(got.shape) != (4, 64, 64, 3) or not torch.isfinite(got).all():
        fail("model forward: bad shape or non-finite output")
    err = float((got - want).abs().max())
    log(f"model fp32 forward (4, 64, 64, 3): kernels on the card vs plain on the CPU "
        f"max_abs {err:.3e} (atol {MODEL_ATOL}) max|v| {float(want.abs().max()):.3f}")
    if not err <= MODEL_ATOL:
        fail(f"model forward differs from the plain path by {err:.3e}")


def serve_phase(torch, build):
    from rectified_flow_vision_tpu_torch.models import BaseFlowModel
    from rectified_flow_vision_tpu_torch.serving import SamplerService

    model = BaseFlowModel(image_size=64, seed=SEED, sample_dtype="bfloat16", device="cuda")
    if model.num_parameters() != 11_255_363:
        fail(f"flagship has {model.num_parameters()} parameters")

    # the main path: counts from 0, service start-up (warmup) and three requests
    build.reset_launches()
    t0 = time.perf_counter()
    svc = SamplerService(model, step_counts=(1, 2, 4), batch_size=BATCH, method="euler",
                         seed=SEED)
    warm_s = time.perf_counter() - t0
    outs = {}
    lat = {}
    for n, steps in ((16, 1), (256, 2), (300, 4)):
        t0 = time.perf_counter()
        outs[(n, steps)] = svc.generate(n, num_steps=steps)
        lat[f"{n}x{steps}"] = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    forwards = (1 + 2 + 4) + 1 * 1 + 1 * 2 + 2 * 4  # warmup + requests (300 -> 2 batches)
    expect = all_counts(build, **{k: v * forwards for k, v in EVAL_FORWARD_LAUNCHES.items()})
    log(f"serve: warmup {warm_s:.2f} s, requests {lat}, launches {nonzero(launches)}")
    if launches != expect:
        fail(f"main-path launches {launches}, expected {expect}")

    for (n, steps), imgs in outs.items():
        if imgs.shape != (n, 3, 64, 64):
            fail(f"generate({n}, {steps}) returned shape {imgs.shape}")
        if not np.isfinite(imgs).all() or imgs.min() < -1.0 or imgs.max() > 1.0:
            fail(f"generate({n}, {steps}): non-finite or outside [-1, 1]")

    build.reset_launches()
    svc.generate(BATCH, num_steps=4)
    one_batch = dict(build.LAUNCHES)
    if one_batch != all_counts(build, **{k: 4 * v for k, v in EVAL_FORWARD_LAUNCHES.items()}):
        fail(f"one 4-step batch launched {one_batch}, expected 4 forwards")
    log(f"serve: one 4-step batch of {BATCH} launched {nonzero(one_batch)}")

    again = SamplerService(model, step_counts=(1,), batch_size=BATCH, seed=SEED, warmup=False)
    same = again.generate(16, num_steps=1)
    if not np.array_equal(same, outs[(16, 1)]):
        fail("same seed gave different images")
    img_s = svc.throughput(4)
    log(f"serve: same seed gives the same images; throughput(4) {img_s:.2f} img/s "
        f"(batch {BATCH}, bf16)")
    return launches, svc, img_s


KERNEL_GROUPS = (
    # substring of the device kernel's name -> group; first match wins
    ("flash_fwd", "flash_attention forward"),
    ("flash_dkv", "flash_attention backward (dkv)"),
    ("flash_dq", "flash_attention backward (dq)"),
    ("flash_delta", "flash_attention backward (delta)"),
    ("conv3x3", "conv3x3"),
    ("gn_silu_dropout_fwd", "gn_silu_dropout"),
    ("gn_silu_bwd", "gn_silu_backward"),
    ("dropout_kernel", "dropout"),
    ("dropout_mask_apply", "dropout_mask_apply"),
    ("gn_silu_fwd", "gn_silu"),
    ("gn_norm", "attention_block"),
    ("attn_", "attention_block"),
    ("qk_norm_rope", "qk_norm_rope"),
    ("ln_modulate", "ln_modulate"),
    ("bias_act", "bias_act"),
    ("gated_residual", "gated_residual"),
    ("adam", "optimizer"),
    ("multi_tensor", "optimizer"),
    ("cudnn", "cuDNN / cuBLAS (plain convs, backward)"),
    ("nvjet", "cuDNN / cuBLAS (plain convs, backward)"),
    ("cublas", "cuDNN / cuBLAS (plain convs, backward)"),
    ("cutlass", "cuDNN / cuBLAS (plain convs, backward)"),
    ("xmma", "cuDNN / cuBLAS (plain convs, backward)"),
    ("gemm", "cuDNN / cuBLAS (plain convs, backward)"),
    ("wgrad", "cuDNN / cuBLAS (plain convs, backward)"),
    ("dgrad", "cuDNN / cuBLAS (plain convs, backward)"),
    ("convolve", "cuDNN / cuBLAS (plain convs, backward)"),
)


def kernel_group(name: str) -> str:
    for key, group in KERNEL_GROUPS:
        if key in name:
            return group
    return "other"


def profile_device(torch, fn, trace_name: str, what: str) -> None:
    """Run ``fn`` once under torch.profiler: device time by kernel group, and
    the device's idle share of the host's wall time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    path = ROOT / "build" / trace_name
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "kernel" and "dur" in e]
    if not events:
        fail("the profiler trace holds no device kernels")
    groups: Counter = Counter()
    names: Counter = Counter()
    for e in events:
        groups[kernel_group(e["name"])] += e["dur"] / 1e3
        if kernel_group(e["name"]) == "other":
            names[e["name"][:80]] += e["dur"] / 1e3
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    busy, end = 0.0, -math.inf
    for a, b in spans:  # union of kernel intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    busy_ms = busy / 1e3
    log(f"trace: {what}: wall {wall_ms:.2f} ms, device busy "
        f"{busy_ms:.2f} ms (idle share {1.0 - busy_ms / wall_ms:.3f}), {len(events)} kernels, "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in groups.most_common()))
    log("trace: largest other kernels: "
        + "; ".join(f"{k} {v:.2f} ms" for k, v in names.most_common(8)))


def trace_phase(torch, svc) -> None:
    sampler = svc._samplers[4]
    noise = svc._noise()
    profile_device(torch, lambda: sampler(noise), "serve_trace.json",
                   f"one 4-step batch of {BATCH}")


def worst_gradient(torch, cpu, gpu, what: str, rtol=GRAD_RTOL, atol=GRAD_ATOL):
    """(ratio, parameter name) of the card gradient farthest from the CPU's,
    as a share of its tolerance: rtol x the parameter's largest CPU gradient
    entry + atol. Fails on a missing or non-finite gradient."""
    worst, worst_name = 0.0, ""
    for (name, pc), pg in zip(cpu.named_parameters(), gpu.parameters()):
        if pg.grad is None or not torch.isfinite(pg.grad).all():
            fail(f"{what}gradient of {name} is missing or non-finite")
        err = float((pg.grad.cpu() - pc.grad).abs().max())
        ratio = err / (rtol * float(pc.grad.abs().max()) + atol)
        if ratio > worst:
            worst, worst_name = ratio, name
    return worst, worst_name


def gradient_phase(torch, build) -> None:
    """Loss and every parameter's gradient of the full-width UNet in fp32:
    kernels forward and the gn_silu_backward kernel on the card, against the
    plain path on the CPU, on the same x1, x0, t and dropout seeds."""
    from rectified_flow_vision_tpu_torch.models import BaseFlowModel

    cpu = BaseFlowModel(image_size=64, seed=SEED, dropout=DROP_RATE, device="cpu")
    gpu = BaseFlowModel(image_size=64, seed=SEED, dropout=DROP_RATE, device="cuda")
    g = torch.Generator().manual_seed(SEED + 2)
    x1 = torch.tanh(torch.randn((4, 64, 64, 3), generator=g))
    x0 = torch.randn((4, 64, 64, 3), generator=g)
    t = torch.rand((4,), generator=g)
    seeds = torch.randint(2**31 - 1, (cpu.velocity_net.num_dropout_seeds,), generator=g,
                          dtype=torch.int32)
    want = cpu.loss_fn(x1, x0=x0, t=t, seeds=seeds)
    want.backward()
    build.reset_launches()
    got = gpu.loss_fn(x1.cuda(), x0=x0.cuda(), t=t.cuda(), seeds=seeds.cuda())
    got.backward()
    torch.cuda.synchronize()
    if dict(build.LAUNCHES) != all_counts(build, **fp32_unet(TRAIN_STEP_LAUNCHES)):
        fail(f"loss + backward launched {dict(build.LAUNCHES)}, expected "
             f"{fp32_unet(TRAIN_STEP_LAUNCHES)}")
    loss_err = abs(float(got.detach()) - float(want.detach()))
    worst, worst_name = worst_gradient(torch, cpu, gpu, "")
    log(f"gradient fp32 batch 4, dropout {DROP_RATE}: loss {float(got.detach()):.6f} (CPU plain "
        f"{float(want.detach()):.6f}, |diff| {loss_err:.2e}, atol {LOSS_ATOL}); worst gradient "
        f"{worst_name} at {worst:.3f} of its tolerance ({GRAD_RTOL} x max|g| + {GRAD_ATOL})")
    if loss_err > LOSS_ATOL or worst > 1.0:
        fail("loss or gradients on the card differ from the CPU plain path")


@contextlib.contextmanager
def winograd_gate(on: bool = True):
    """``RFV_CONV_WINOGRAD`` set (or unset) inside, the previous value back on
    exit."""
    old = os.environ.get(WINOGRAD_GATE)
    if on:
        os.environ[WINOGRAD_GATE] = "1"
    else:
        os.environ.pop(WINOGRAD_GATE, None)
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(WINOGRAD_GATE, None)
        else:
            os.environ[WINOGRAD_GATE] = old


def median_ms(torch, fn, readings: int = WINOGRAD_READINGS) -> float:
    """Median of ``readings`` CUDA-event timings of one ``fn()`` each."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(readings):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def conv_sites(model) -> dict:
    """The 30 weights of the flagship's conv2d_fused sites: conv1 and conv2
    of each res-block, and the upsample convs."""
    sites = {n: p for n, p in model.named_parameters()
             if re.search(r"\.conv[12]\.weight$|upsamples\.\d+\.1\.weight$", n)}
    if len(sites) != EVAL_FORWARD_LAUNCHES["conv3x3"]:
        fail(f"winograd: found {len(sites)} conv sites, not {EVAL_FORWARD_LAUNCHES['conv3x3']}")
    return sites


def winograd_phase(torch, build, shape_calls) -> None:
    """The Winograd conv of ``ops/winograd.py`` behind ``RFV_CONV_WINOGRAD``:
    (a) at every conv3x3 shape of the flagship forward, batch 256, against
    cuDNN's fp32 conv (fp32) and the conv3x3 kernel's bf16 error (bf16), with
    the ms a call of Winograd, the conv3x3 kernel and cuDNN (``conv3x3_plain``);
    (b) the flagship forward at batch 256 in bf16 gate on and off (launches,
    Winograd calls, outputs), one bf16 train step with dropout 0.1 on and
    off, and ``SamplerService.throughput(4)`` on and off, in turns."""
    from rectified_flow_vision_tpu_torch.models import BaseFlowModel
    from rectified_flow_vision_tpu_torch.models.unet import UNet
    from rectified_flow_vision_tpu_torch.ops import conv3x3 as C
    from rectified_flow_vision_tpu_torch.ops import primitives as P
    from rectified_flow_vision_tpu_torch.ops import winograd as W
    from rectified_flow_vision_tpu_torch.serving import SamplerService

    log(f"winograd: card {card_line()}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    bf16 = torch.bfloat16
    per_forward = {"bf16": np.zeros(3), "fp32": np.zeros(3)}
    for (h, w, cin, cout), n in sorted(shape_calls["conv3x3"].items()):
        x = torch.randn((BATCH, h, w, cin), generator=gen, device="cuda")
        bound = 1 / math.sqrt(9 * cin)
        wt = (torch.rand((cout, 3, 3, cin), generator=gen, device="cuda") * 2 - 1) * bound
        b = (torch.rand((cout,), generator=gen, device="cuda") * 2 - 1) * bound
        with P.exact_fp32():
            truth = C.conv3x3_plain(x, wt, b)
            scale = float(truth.abs().max())
            err32 = float((W.winograd_conv3x3(x, wt, b) - truth).abs().max())
            xb, wb = x.to(bf16), wt.to(bf16)
            err_w = float((W.winograd_conv3x3(xb, wb, b).float() - truth).abs().max())
            err_k = float((C.conv3x3_cuda(xb, wb, b).float() - truth).abs().max())
            ms = {dname: [median_ms(torch, lambda f=f, a=a: f(*a)) for f in
                          (W.winograd_conv3x3, C.conv3x3_cuda, C.conv3x3_plain)]
                  for dname, a in (("bf16", (xb, wb, b)), ("fp32", (x, wt, b)))}
        for dname, v in ms.items():
            per_forward[dname] += n * np.array(v)
        log(f"winograd: ({BATCH}, {h}, {w}, {cin}) -> {cout}, {n} site(s) a forward: fp32 max_abs "
            f"{err32:.3e} ({err32 / scale:.2e} of max|y| {scale:.3f}, limit {WINOGRAD_F32_RTOL}); "
            f"bf16 max_abs {err_w:.3e} vs the conv3x3 kernel's {err_k:.3e} (limit "
            f"{WINOGRAD_BF16_FACTOR}x); ms a call (median of {WINOGRAD_READINGS}) Winograd / "
            f"conv3x3 / cuDNN: bf16 " + " / ".join(f"{v:.4f}" for v in ms["bf16"]) + ", fp32 "
            + " / ".join(f"{v:.4f}" for v in ms["fp32"]))
        if not (err32 <= WINOGRAD_F32_RTOL * scale
                and err_w <= WINOGRAD_BF16_FACTOR * max(err_k, WINOGRAD_BF16_FLOOR)):
            fail(f"winograd: the conv at ({h}, {w}, {cin}) -> {cout} is outside its tolerance")
        del x, wt, xb, wb, truth
    log("winograd: ms a flagship forward (the shapes' ms times their sites, 30 convs) Winograd / "
        "conv3x3 / cuDNN: " + ", ".join(f"{d} " + " / ".join(f"{v:.3f}" for v in t)
                                       for d, t in per_forward.items()))
    torch.cuda.empty_cache()

    # (b) the flagship forward at batch 256: gate off, gate on, fp32 truth
    net = UNet()
    net.reset_parameters(torch.Generator().manual_seed(SEED))
    net.to("cuda")
    g = torch.Generator(device="cuda").manual_seed(SEED + 31)
    x = torch.randn((BATCH, 64, 64, 3), generator=g, device="cuda")
    t = torch.rand((BATCH,), generator=g, device="cuda")
    outs, counts = {}, {}
    with torch.no_grad():
        for on in (False, True):
            with winograd_gate(on):
                build.reset_launches()
                W.reset_calls()
                outs[on] = net(x, t, dtype=bf16).float()
                torch.cuda.synchronize()
                counts[on] = (dict(build.LAUNCHES), W.CALLS["winograd"])
        with P.exact_fp32():
            truth = net(x, t)
    sites = EVAL_FORWARD_LAUNCHES["conv3x3"]
    if counts[False] != (all_counts(build, **EVAL_FORWARD_LAUNCHES), 0):
        fail(f"winograd: the gate-off forward launched {counts[False]}")
    if counts[True] != (all_counts(build, **dict(EVAL_FORWARD_LAUNCHES, conv3x3=0)), sites):
        fail(f"winograd: the gate-on forward launched {counts[True]}, not 0 conv3x3 and "
             f"{sites} Winograd calls")
    err_on = float((outs[True] - truth).abs().max())
    err_off = float((outs[False] - truth).abs().max())
    log(f"winograd: flagship forward, batch {BATCH}, bf16: gate on {counts[True][1]} Winograd "
        f"calls, conv3x3 launches {counts[True][0]['conv3x3']} (gate off "
        f"{counts[False][0]['conv3x3']}, {counts[False][1]} Winograd calls); max |error| against "
        f"the fp32 forward {err_on:.4e} gate on, {err_off:.4e} gate off (limit "
        f"{WINOGRAD_BF16_FACTOR}x), max|y| {float(truth.abs().max()):.3f}")
    if not (torch.isfinite(outs[True]).all() and err_on <= WINOGRAD_BF16_FACTOR * max(
            err_off, WINOGRAD_BF16_FLOOR)):
        fail("winograd: the gate-on flagship forward is outside the bf16 contract")
    del net, outs, truth, x, t
    torch.cuda.empty_cache()

    # one bf16 train step (loss and gradients, dropout 0.1), gate off and on
    model = BaseFlowModel(image_size=64, seed=SEED, dropout=DROP_RATE, compute_dtype="bfloat16",
                          device="cuda")
    sites_w = conv_sites(model)
    g = torch.Generator(device="cuda").manual_seed(SEED + 32)
    x1 = torch.tanh(torch.randn((BATCH, 64, 64, 3), generator=g, device="cuda"))
    x0 = torch.randn((BATCH, 64, 64, 3), generator=g, device="cuda")
    t = torch.rand((BATCH,), generator=g, device="cuda")
    seeds = torch.randint(2**31 - 1, (model.velocity_net.num_dropout_seeds,), generator=g,
                          device="cuda", dtype=torch.int32)
    steps = {}
    for on in (False, True):
        with winograd_gate(on):
            model.zero_grad(set_to_none=True)
            build.reset_launches()
            W.reset_calls()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss = model.loss_fn(x1, x0=x0, t=t, seeds=seeds)
            loss.backward()
            torch.cuda.synchronize()
            steps[on] = dict(loss=float(loss.detach()), s=time.perf_counter() - t0,
                             launches=dict(build.LAUNCHES), calls=W.CALLS["winograd"],
                             peak=torch.cuda.max_memory_allocated() / 2**30,
                             norms={k: float(p.grad.norm()) for k, p in sites_w.items()})
    if steps[True]["launches"] != all_counts(build, **dict(TRAIN_STEP_LAUNCHES, conv3x3=0)) or (
            steps[True]["calls"] != sites):
        fail(f"winograd: the gate-on train step launched {steps[True]['launches']}, "
             f"{steps[True]['calls']} Winograd calls")
    if steps[False]["launches"] != all_counts(build, **TRAIN_STEP_LAUNCHES):
        fail(f"winograd: the gate-off train step launched {steps[False]['launches']}")
    rel = {k: abs(steps[True]["norms"][k] - v) / v for k, v in steps[False]["norms"].items()}
    worst = max(rel, key=rel.get)
    loss_rel = abs(steps[True]["loss"] - steps[False]["loss"]) / abs(steps[False]["loss"])
    log(f"winograd: bf16 train step, batch {BATCH}, dropout {DROP_RATE}: loss gate on "
        f"{steps[True]['loss']!r} vs off {steps[False]['loss']!r} (rel {loss_rel:.2e}, limit "
        f"{WINOGRAD_LOSS_RTOL}); conv sites' gradient norms: worst {worst} rel {rel[worst]:.2e} "
        f"(limit {WINOGRAD_GRAD_RTOL}); host s (first call, not a timing) on "
        f"{steps[True]['s']:.3f} / off {steps[False]['s']:.3f}; peak GiB on "
        f"{steps[True]['peak']:.2f} / off {steps[False]['peak']:.2f}")
    if not (math.isfinite(steps[True]["loss"]) and loss_rel <= WINOGRAD_LOSS_RTOL
            and rel[worst] <= WINOGRAD_GRAD_RTOL):
        fail("winograd: the gate-on train step disagrees with the gate-off step")
    del model, x1, x0, t, sites_w
    torch.cuda.empty_cache()

    # throughput(4) at batch 256, bf16, in turns: off, on, on, off
    svc = SamplerService(BaseFlowModel(image_size=64, seed=SEED, sample_dtype="bfloat16",
                                       device="cuda"),
                         step_counts=(4,), batch_size=BATCH, seed=SEED, warmup=False)
    rates = {False: [], True: []}
    for on in (False, True, True, False):
        with winograd_gate(on):
            rates[on].append(svc.throughput(4))
    log(f"winograd: SamplerService.throughput(4), batch {BATCH}, bf16, in turns off / on / on / "
        f"off: gate on {[round(v, 2) for v in rates[True]]} img/s (median "
        f"{float(np.median(rates[True])):.2f}), off {[round(v, 2) for v in rates[False]]} "
        f"(median {float(np.median(rates[False])):.2f}); card {card_line()}")
    del svc
    torch.cuda.empty_cache()


def make_corpus(n: int) -> np.ndarray:
    """A seeded corpus of 64x64 images in [-1, 1]: smooth blobs (an 8x8 normal
    field, upsampled) plus fine noise."""
    r = np.random.default_rng(SEED)
    coarse = np.kron(r.standard_normal((n, 8, 8, 3)), np.ones((1, 8, 8, 1)))
    fine = 0.1 * r.standard_normal((n, 64, 64, 3))
    return np.tanh(coarse + fine).astype(np.float32)


def train_phase(torch, build):
    """The training and Reflow path at full width, through the entry points a
    user calls. Returns its launch counts."""
    from rectified_flow_vision_tpu_torch import (
        ArrayDataset, BaseFlowModel, RectifiedFlowModel, SamplerService,
        generate_reflow_pairs, train_base_flow, train_rectified_flow,
    )

    cfg = TRAIN
    data = ArrayDataset(make_corpus(cfg["images"]))
    ckpt_dir = ROOT / "build" / "smoke_ckpt"
    steps_per_epoch = cfg["images"] // cfg["batch"]

    def base_run(save_path):
        model = BaseFlowModel(image_size=64, seed=SEED, compute_dtype="bfloat16",
                              sample_dtype="bfloat16", device="cuda")
        losses = train_base_flow(
            model, data, epochs=cfg["base_epochs"], lr=cfg["lr"], batch_size=cfg["batch"],
            save_path=save_path, save_every=cfg["base_epochs"], seed=SEED, progress=False,
            ema_decay=cfg["ema"],
        )
        return model, losses

    def check_losses(what, losses, below):
        if not np.isfinite(losses).all():
            fail(f"{what}: non-finite loss in {losses}")
        if not losses[-1] < below:
            fail(f"{what}: the last epoch's loss is not below {below}: {losses}")

    # the main path: counts from 0
    build.reset_launches()
    t0 = time.perf_counter()
    base, base_losses = base_run(str(ckpt_dir / "base_flow"))
    base_s = time.perf_counter() - t0
    check_losses("train_base_flow", base_losses, below=base_losses[0])

    t0 = time.perf_counter()
    x0, x1 = generate_reflow_pairs(
        base, cfg["pairs"], batch_size=cfg["pair_batch"], num_steps=cfg["teacher_steps"],
        seed=SEED, data_format="NHWC", method="heun",
    )
    pairs_s = time.perf_counter() - t0
    if x0.shape != (cfg["pairs"], 64, 64, 3) or x1.shape != x0.shape:
        fail(f"generate_reflow_pairs returned {x0.shape}, {x1.shape}")
    if not (np.isfinite(x0).all() and np.isfinite(x1).all()):
        fail("generate_reflow_pairs: non-finite pairs")

    student = RectifiedFlowModel.from_base_model(base, copy_weights=True, seed=SEED + 1000)
    student.reflow_iteration = 1
    t0 = time.perf_counter()
    reflow_losses = train_rectified_flow(
        student, x0, x1, epochs=cfg["reflow_epochs"], batch_size=cfg["batch"], lr=cfg["lr"],
        save_path=str(ckpt_dir / "reflow_k1"), save_every=cfg["reflow_epochs"], seed=SEED,
        data_format="NHWC", progress=False, ema_decay=cfg["ema"], time_sampling="u_shaped",
    )
    reflow_s = time.perf_counter() - t0
    # the student starts at the teacher's weights, where the loss on the
    # teacher's own couplings is already small, and AdamW's first steps at the
    # full lr may raise it: held below the base flow's last loss (the pairs
    # are a deterministic target, the base loss has the noise's variance)
    check_losses("train_rectified_flow", reflow_losses, below=base_losses[-1])

    straight = student.compute_straightness(
        x0[:cfg["samples"]], x1[:cfg["samples"]], cfg["straight_points"], data_format="NHWC")
    if not (np.isfinite(straight) and straight >= 0.0):
        fail(f"compute_straightness returned {straight}")

    ema_model = BaseFlowModel.from_checkpoint(str(ckpt_dir / "reflow_k1_ema_final.npz"),
                                              device="cuda")
    if not (isinstance(ema_model, RectifiedFlowModel) and ema_model.reflow_iteration == 1):
        fail("the student's EMA checkpoint did not come back as a RectifiedFlowModel")
    svc = SamplerService(ema_model, step_counts=(4,), batch_size=cfg["samples"], seed=SEED,
                         warmup=False)
    imgs = svc.generate(cfg["samples"], num_steps=4)
    launches = dict(build.LAUNCHES)
    if imgs.shape != (cfg["samples"], 3, 64, 64) or not np.isfinite(imgs).all():
        fail(f"samples from the student's EMA: shape {imgs.shape} or non-finite")
    if imgs.min() < -1.0 or imgs.max() > 1.0:
        fail("samples from the student's EMA leave [-1, 1]")

    train_steps = (cfg["base_epochs"] + cfg["reflow_epochs"]) * steps_per_epoch
    forwards = (-(-cfg["pairs"] // cfg["pair_batch"]) * cfg["teacher_steps"] * 2  # heun
                + cfg["straight_points"] + 4)
    expect = all_counts(build, **{
        k: train_steps * TRAIN_STEP_LAUNCHES[k] + forwards * EVAL_FORWARD_LAUNCHES[k]
        for k in TRAIN_STEP_LAUNCHES})
    log(f"train: base {cfg['base_epochs']} epochs x {steps_per_epoch} steps of {cfg['batch']} in "
        f"{base_s:.1f} s, losses {[round(v, 4) for v in base_losses]}")
    log(f"train: {cfg['pairs']} heun pairs at {cfg['teacher_steps']} teacher steps (the config "
        f"has 100), pair batch {cfg['pair_batch']}, in {pairs_s:.1f} s")
    log(f"train: reflow {cfg['reflow_epochs']} epochs (teacher-init, u_shaped, EMA {cfg['ema']}) "
        f"in {reflow_s:.1f} s, losses {[round(v, 5) for v in reflow_losses]}; straightness "
        f"{straight:.5f}; {cfg['samples']} 4-step samples from the EMA in "
        f"[{imgs.min():.3f}, {imgs.max():.3f}]")
    log(f"train: launches {nonzero(launches)}")
    if launches != expect:
        fail(f"train-path launches {launches}, expected {expect} "
             f"({train_steps} train steps, {forwards} eval forwards)")

    # same seeds, same trajectory: noise, times, permutations and masks repeat
    _, again = base_run(None)
    rel = max(abs(a - b) / abs(a) for a, b in zip(base_losses, again))
    log(f"train: a second run from the same seeds: largest relative difference of an epoch "
        f"loss {rel:.2e} (rtol {TRAJECTORY_RTOL}); first epoch {base_losses[0]!r} vs {again[0]!r}")
    if rel > TRAJECTORY_RTOL:
        fail(f"same seeds gave another loss trajectory: {base_losses} vs {again}")
    return launches, base, data


def train_timing_phase(torch, build, model, data) -> None:
    """img/s of device-resident training at batch 256 in bf16, peak memory,
    the launches of one step, and one step under the profiler."""
    from rectified_flow_vision_tpu_torch.models.base_flow import (
        init_ema, make_optimizer, make_train_epoch)

    steps = 6
    opt = make_optimizer(model, TRAIN["lr"], 1000, steps)
    ema = init_ema(model)
    epoch = make_train_epoch(model, opt, coupled=False, ema=ema, ema_decay=TRAIN["ema"])
    corpus = torch.as_tensor(data.images, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    r = np.random.default_rng(SEED)

    def perm(n):
        return torch.as_tensor(r.integers(0, len(data), (n, BATCH)), device="cuda")

    build.reset_launches()
    epoch(corpus, perm(1), gen)
    torch.cuda.synchronize()
    if dict(build.LAUNCHES) != all_counts(build, **TRAIN_STEP_LAUNCHES):
        fail(f"one train step launched {dict(build.LAUNCHES)}, expected {TRAIN_STEP_LAUNCHES}")
    torch.cuda.reset_peak_memory_stats()
    rates = []
    for _ in range(4):
        p = perm(steps)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = epoch(corpus, p, gen)
        torch.cuda.synchronize()
        rates.append(BATCH * steps / (time.perf_counter() - t0))
        if not torch.isfinite(losses).all():
            fail("train timing: non-finite loss")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"train timing: make_train_epoch, batch {BATCH}, bf16 compute, fp32 masters, EMA, "
        f"64x64, {steps} steps per reading: img/s {[round(v, 2) for v in rates]} "
        f"(median {float(np.median(rates)):.2f}); peak device memory {peak:.2f} GiB; "
        f"launches per step {TRAIN_STEP_LAUNCHES}")
    one = perm(1)
    profile_device(torch, lambda: epoch(corpus, one, gen), "train_trace.json",
                   f"one train step of {BATCH}")


def dropout_phase(torch, build):
    """The standalone dropout through the function a user calls,
    ``ops.primitives.dropout``, forward and gradient, on tensors on the card.
    No model of either package calls it (the UNet's dropout is fused into
    ``gn_silu_dropout``, DiT has none), so this direct run is its path.
    The same for ``dropout_mask_apply`` (gn_silu_dropout's mask on a
    cotangent), which the train step no longer runs: the backward kernel
    applies the mask itself. Returns their launch counts."""
    from rectified_flow_vision_tpu_torch.ops import dropout as DR
    from rectified_flow_vision_tpu_torch.ops import gn_silu_dropout as D
    from rectified_flow_vision_tpu_torch.ops import primitives as P

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    build.reset_launches()
    for shape in DROPOUT_SHAPES:
        x = torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16).requires_grad_()
        g = torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)
        seed = torch.randint(2**31 - 1, (1,), generator=gen, dtype=torch.int32, device="cuda")
        out = P.dropout(x, DROP_RATE, seed, train=True)
        (grad,) = torch.autograd.grad(out, x, g)
        if not torch.equal(grad, DR.dropout_plain(g, seed, DROP_RATE)):
            fail(f"dropout {shape}: the gradient is not the mask applied to the cotangent")
        if P.dropout(x, DROP_RATE, seed, train=False) is not x:
            fail("dropout in eval mode is not the identity")
        if not torch.equal(D.dropout_mask_apply_cuda(g, seed, DROP_RATE),
                           D.dropout_mask_apply_plain(g, seed, DROP_RATE)):
            fail(f"dropout_mask_apply {shape}: not the plain version's result")
    launches = dict(build.LAUNCHES)
    expect = all_counts(build, dropout=2 * len(DROPOUT_SHAPES),
                        dropout_mask_apply=len(DROPOUT_SHAPES))
    log(f"dropout: P.dropout forward and gradient, dropout_mask_apply at {DROPOUT_SHAPES}: "
        f"launches {nonzero(launches)}")
    if launches != expect:
        fail(f"dropout launches {launches}, expected {expect}")
    return launches


def randomize_zero_leaves(torch, model, seed: int) -> None:
    """adaLN-Zero starts every gate, the head and every bias at zero, which
    makes a fresh DiT the zero function: fill the all-zero parameters with
    N(0, 0.02) from a seed, so that every block reaches the output."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            if not bool(p.any()):
                p.copy_((torch.randn(p.shape, generator=g) * 0.02).to(p.device))


def dit_model_phase(torch, build) -> None:
    """DiT-S/2 at full width and depth in fp32, batch 4, all parameters
    random: the forward, the loss and every parameter's gradient on the card
    (flash kernels forward and backward, ``remat``) against the CPU plain path."""
    from rectified_flow_vision_tpu_torch.models import BaseFlowModel

    cpu = BaseFlowModel(seed=SEED, device="cpu", **DIT)
    randomize_zero_leaves(torch, cpu, SEED + 4)
    gpu = BaseFlowModel(seed=SEED, device="cuda", **DIT)
    gpu.load_state_dict(cpu.state_dict())
    if cpu.num_parameters() != 32_867_728:
        fail(f"DiT-S/2 has {cpu.num_parameters()} parameters")
    g = torch.Generator().manual_seed(SEED + 5)
    x1 = torch.tanh(torch.randn((4, 64, 64, 4), generator=g))
    x0 = torch.randn((4, 64, 64, 4), generator=g)
    t = torch.rand((4,), generator=g)

    build.reset_launches()
    with torch.no_grad():
        want = cpu.velocity_net(x0, t)
        got = gpu.velocity_net(x0.cuda(), t.cuda()).cpu()
    expect = all_counts(build, flash_attention=DIT_DEPTH, **dit_glue(DIT_DEPTH, 1))
    if dict(build.LAUNCHES) != expect:
        fail(f"DiT forward launches {dict(build.LAUNCHES)}, expected {expect}")
    if tuple(got.shape) != (4, 64, 64, 4) or not torch.isfinite(got).all():
        fail("DiT forward: bad shape or non-finite output")
    err = float((got - want).abs().max())
    log(f"DiT-S/2 fp32 forward (4, 64, 64, 4), all parameters random: kernels on the card vs "
        f"plain on the CPU max_abs {err:.3e} (atol {MODEL_ATOL}) max|v| "
        f"{float(want.abs().max()):.3f}")
    if not err <= MODEL_ATOL or float(want.abs().max()) < 0.05:
        fail(f"DiT forward differs from the plain path by {err:.3e} (or is degenerate)")

    ref = cpu.loss_fn(x1, x0=x0, t=t)
    ref.backward()
    build.reset_launches()
    loss = gpu.loss_fn(x1.cuda(), x0=x0.cuda(), t=t.cuda())
    loss.backward()
    torch.cuda.synchronize()
    expect = all_counts(build, flash_attention=2 * DIT_DEPTH, flash_attention_backward=DIT_DEPTH,
                        **dit_glue(2 * DIT_DEPTH, 1))
    if dict(build.LAUNCHES) != expect:
        fail(f"DiT loss + backward launched {dict(build.LAUNCHES)}, expected {expect}")
    loss_err = abs(float(loss.detach()) - float(ref.detach()))
    worst, worst_name = worst_gradient(torch, cpu, gpu, "DiT ")
    log(f"DiT-S/2 gradient fp32 batch 4, remat: loss {float(loss.detach()):.6f} (CPU plain "
        f"{float(ref.detach()):.6f}, |diff| {loss_err:.2e}, atol {LOSS_ATOL}); worst gradient "
        f"{worst_name} at {worst:.3f} of its tolerance ({GRAD_RTOL} x max|g| + {GRAD_ATOL})")
    if loss_err > LOSS_ATOL or worst > 1.0:
        fail("DiT loss or gradients on the card differ from the CPU plain path")


def dit_xl_phase(torch, build) -> None:
    """DiT-XL/2's widths (hidden 1152, 16 heads of 72, patch 2) on 64x64x4
    latents (1024 tokens), depth cut from 28 to 2, batch 2, all parameters
    random: the fp32 forward, loss and every gradient on the card (flash
    kernels at head width 72, ``remat``) against the CPU plain path, as for
    DiT-S/2; the bf16 forward against the CPU's bf16 plain path."""
    from rectified_flow_vision_tpu_torch.models import BaseFlowModel

    depth = 2
    cfg = dict(image_size=64, in_channels=4, backbone="dit", patch_size=2, hidden_size=1152,
               depth=depth, num_heads=16, remat=True)
    cpu = BaseFlowModel(seed=SEED, device="cpu", **cfg)
    randomize_zero_leaves(torch, cpu, SEED + 9)
    gpu = BaseFlowModel(seed=SEED, device="cuda", **cfg)
    gpu.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(SEED + 10)
    x1 = torch.tanh(torch.randn((2, 64, 64, 4), generator=g))
    x0 = torch.randn((2, 64, 64, 4), generator=g)
    t = torch.rand((2,), generator=g)

    errs = {}
    for dname, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        build.reset_launches()
        with torch.no_grad():
            want = cpu.velocity_net(x0, t, dtype=dt).float()
            got = gpu.velocity_net(x0.cuda(), t.cuda(), dtype=dt).float().cpu()
        if dict(build.LAUNCHES) != all_counts(build, flash_attention=depth,
                                              **dit_glue(depth, 1)):
            fail(f"DiT-XL widths {dname} forward launched {dict(build.LAUNCHES)}")
        if not torch.isfinite(got).all():
            fail(f"DiT-XL widths {dname} forward: non-finite output")
        scale = float(want.abs().max())
        errs[dname] = float((got - want).abs().max())
        tol = MODEL_ATOL if dt == torch.float32 else XL_BF16_RTOL * scale
        if not errs[dname] <= tol or scale < 0.05:
            fail(f"DiT-XL widths {dname} forward differs from the plain path by {errs[dname]:.3e} "
                 f"(tolerance {tol:.3e}, max|v| {scale:.3f})")

    ref = cpu.loss_fn(x1, x0=x0, t=t)
    ref.backward()
    build.reset_launches()
    loss = gpu.loss_fn(x1.cuda(), x0=x0.cuda(), t=t.cuda())
    loss.backward()
    torch.cuda.synchronize()
    expect = all_counts(build, flash_attention=2 * depth, flash_attention_backward=depth,
                        **dit_glue(2 * depth, 1))
    if dict(build.LAUNCHES) != expect:
        fail(f"DiT-XL widths loss + backward launched {dict(build.LAUNCHES)}, expected {expect}")
    loss_err = abs(float(loss.detach()) - float(ref.detach()))
    worst, worst_name = worst_gradient(torch, cpu, gpu, "DiT-XL widths ")
    log(f"DiT-XL/2 widths (hidden 1152, 16 heads of 72), depth {depth}, batch 2, all parameters "
        f"random: forward vs the CPU plain path max_abs fp32 {errs['float32']:.3e} (atol "
        f"{MODEL_ATOL}), bf16 {errs['bfloat16']:.3e} (rtol {XL_BF16_RTOL} of max|v|); fp32 loss "
        f"{float(loss.detach()):.6f} (|diff| {loss_err:.2e}, atol {LOSS_ATOL}); worst gradient "
        f"{worst_name} at {worst:.3f} of its tolerance ({GRAD_RTOL} x max|g| + {GRAD_ATOL})")
    if loss_err > LOSS_ATOL or worst > 1.0:
        fail("DiT-XL widths loss or gradients on the card differ from the CPU plain path")


def dit_wide_phase(torch, build, cfg, shape, routes):
    """A head width above 128 on a model path (``cfg``: hidden 1152 in 6
    heads of 192, or in 3 heads of 384; depth 2) at batch 2 on 64x64x4
    latents (1024 tokens), all parameters random: the bf16 forward, loss and
    every gradient on the card (``remat``) against the same bf16 plain path
    on the CPU, then the fp32 ones against the CPU. ``routes`` names the
    kernels entries each dtype's flash calls take (bf16: the 192 / 256
    instances, or the streamed kernels; fp32: the *_wide fp32 kernels);
    returns the launches of both runs under those names."""
    from rectified_flow_vision_tpu_torch.models import BaseFlowModel

    depth, (bsz, _, heads, hd) = cfg["depth"], shape
    what = f"DiT {heads} heads of {hd}"
    for dname, (route, _) in routes.items():
        if kernel_route(torch, dname, hd) != route:
            fail(f"{what} {dname} does not take the {route} kernels")
    g = torch.Generator().manual_seed(SEED + 18)
    x1 = torch.tanh(torch.randn((bsz, 64, 64, 4), generator=g))
    x0 = torch.randn((bsz, 64, 64, 4), generator=g)
    t = torch.rand((bsz,), generator=g)
    launches, notes = {}, []
    for dname in ("bfloat16", "float32"):
        cpu = BaseFlowModel(seed=SEED, device="cpu", compute_dtype=dname, **cfg)
        randomize_zero_leaves(torch, cpu, SEED + 19)
        gpu = BaseFlowModel(seed=SEED, device="cuda", compute_dtype=dname, **cfg)
        gpu.load_state_dict(cpu.state_dict())
        dt = getattr(torch, dname)
        build.reset_launches()
        with torch.no_grad():
            want = cpu.velocity_net(x0, t, dtype=dt).float()
            got = gpu.velocity_net(x0.cuda(), t.cuda(), dtype=dt).float().cpu()
        loss = gpu.loss_fn(x1.cuda(), x0=x0.cuda(), t=t.cuda())
        loss.backward()
        torch.cuda.synchronize()
        counts = dict(build.LAUNCHES)
        expect = all_counts(build, flash_attention=DIT_WIDE_FWD_CALLS,
                            flash_attention_backward=DIT_WIDE_BWD_CALLS,
                            **dit_glue(DIT_WIDE_FWD_CALLS, 2))
        if counts != expect:
            fail(f"{what} {dname} forward, loss and backward launched {counts}, "
                 f"expected {expect}")
        fwd_name, bwd_name = routes[dname][1]
        launches[fwd_name] = counts["flash_attention"]
        launches[bwd_name] = counts["flash_attention_backward"]
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        tol = MODEL_ATOL if dname == "float32" else XL_BF16_RTOL * scale
        if not torch.isfinite(got).all() or not err <= tol or scale < 0.05:
            fail(f"{what} {dname} forward differs from the CPU plain path by {err:.3e} "
                 f"(tolerance {tol:.3e}, max|v| {scale:.3f})")
        ref = cpu.loss_fn(x1, x0=x0, t=t)
        ref.backward()
        loss_err = abs(float(loss.detach()) - float(ref.detach()))
        if dname == "float32":
            loss_tol, rtol, atol = LOSS_ATOL, GRAD_RTOL, GRAD_ATOL
        else:
            loss_tol = WIDE_BF16_LOSS_RTOL * abs(float(ref.detach()))
            rtol, atol = WIDE_BF16_GRAD_RTOL, 0.0
        worst, worst_name = worst_gradient(torch, cpu, gpu, f"{what} {dname} ", rtol, atol)
        notes.append(f"{dname}: forward max_abs {err:.3e} (tolerance {tol:.3e}), loss "
                     f"{float(loss.detach()):.6f} (CPU {float(ref.detach()):.6f}, tolerance "
                     f"{loss_tol:.2e}), worst gradient {worst_name} at {worst:.3f} of its "
                     f"tolerance ({rtol} x max|g| + {atol})")
        if loss_err > loss_tol or worst > 1.0:
            fail(f"{what} {dname} loss or gradients differ from the CPU plain path: "
                 + notes[-1])
        del cpu, gpu, loss, ref
    log(f"DiT hidden 1152, {heads} heads of {hd}, depth {depth}, batch {bsz}, all parameters "
        "random, kernels on the card vs the plain path on the CPU; " + "; ".join(notes)
        + f"; launches {launches}")
    return launches


def kernel_route(torch, dname: str, d: int) -> str:
    """Which flash kernels a head width takes in ``dname``: bf16 "narrow" (up
    to 128), "wide" (the 192 / 256 instances), "streamed" (above 256); fp32
    "f32" (up to 128) or "f32_wide"."""
    from rectified_flow_vision_tpu_torch.ops import flash_attention as FA

    w = FA.kernel_head_dim(d, getattr(torch, dname))
    if dname == "float32":
        return "f32" if w <= FA.HEAD_DIM_MAX_F32 else "f32_wide"
    return "narrow" if w <= 128 else "wide" if w <= FA.HEAD_DIM_WIDE else "streamed"


def latent_serve_phase(torch, build):
    """Latent serving at full width: a DiT-S/2 flow on 64x64x4 latents and a
    ConvVAE decode to 256x256x3, batch 256, bf16 flow and bf16 decode."""
    from rectified_flow_vision_tpu_torch.models import BaseFlowModel, ConvVAE
    from rectified_flow_vision_tpu_torch.serving import SamplerService

    model = BaseFlowModel(seed=SEED, sample_dtype="bfloat16", device="cuda", **DIT)
    randomize_zero_leaves(torch, model, SEED + 6)
    vae = ConvVAE(seed=SEED, device="cuda", **VAE)
    torch.cuda.reset_peak_memory_stats()

    build.reset_launches()
    t0 = time.perf_counter()
    svc = SamplerService(model, step_counts=(1, 2, 4), batch_size=BATCH, method="euler",
                         seed=SEED, vae=vae)
    warm_s = time.perf_counter() - t0
    outs, lat = {}, {}
    for n, steps in ((16, 1), (256, 2), (300, 4)):
        t0 = time.perf_counter()
        outs[(n, steps)] = svc.generate(n, num_steps=steps)
        lat[f"{n}x{steps}"] = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    forwards = (1 + 2 + 4) + 1 * 1 + 1 * 2 + 2 * 4  # warmup + requests (300 -> 2 batches)
    decodes = 3 + 1 + 1 + 2  # one a sampler call
    expect = all_counts(build, **vae_counts(
        decodes, "dit", flash_attention=DIT_DEPTH * forwards,
        **dit_glue(DIT_DEPTH * forwards, forwards)))
    log(f"latent serve: warmup {warm_s:.2f} s, requests {lat}, launches {nonzero(launches)}")
    if launches != expect:
        fail(f"latent serve launches {launches}, expected {expect}")
    for (n, steps), imgs in outs.items():
        if imgs.shape != (n, 3, 256, 256):
            fail(f"latent generate({n}, {steps}) returned shape {imgs.shape}")
        if not np.isfinite(imgs).all() or imgs.min() < -1.0 or imgs.max() > 1.0:
            fail(f"latent generate({n}, {steps}): non-finite or outside [-1, 1]")
        if float(imgs.std()) < 1e-3:
            fail(f"latent generate({n}, {steps}): constant images")

    again = SamplerService(model, step_counts=(1,), batch_size=BATCH, seed=SEED, vae=vae,
                           warmup=False)
    if not np.array_equal(again.generate(16, num_steps=1), outs[(16, 1)]):
        fail("latent serve: same seed gave different images")
    img_s = svc.throughput(4)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"latent serve: same seed gives the same images; throughput(4) {img_s:.2f} img/s of "
        f"256x256 pixels (batch {BATCH}, bf16 flow, bf16 decode); peak device memory "
        f"{peak:.2f} GiB")
    sampler, noise = svc._samplers[4], svc._noise()
    profile_device(torch, lambda: svc._run(sampler, noise), "latent_serve_trace.json",
                   f"one 4-step latent batch of {BATCH} with its decode")
    return launches


def flux_counts(build, forwards: int) -> dict:
    """Every kernel's launches in ``forwards`` FLUX forwards (FLUX's depths):
    a double block: two qk_norm_rope streams, one flash, per stream two
    LayerNorms, two epilogues (qkv, GELU MLP) and two gated residuals; a
    single block: one stream, one flash, one LayerNorm, two epilogues, one
    gated residual; around them the image and text embeddings' epilogues,
    and the final LayerNorm and head epilogue."""
    d, s = FLUX["depth"], FLUX["depth_single_blocks"]
    return all_counts(build, qk_norm_rope=(2 * d + s) * forwards,
                      flash_attention=(d + s) * forwards, ln_modulate=(4 * d + s + 1) * forwards,
                      bias_act=(4 * d + 2 * s + 3) * forwards,
                      gated_residual=(4 * d + s) * forwards)


def flux_phase(torch, build):
    """FLUX.1 [schnell] at its published widths (FLUX), 1024 px: the model
    on the card against the plain float32 FLUX on the card, then served
    with prompts through ``SamplerService`` and ``Batcher``."""
    import functools

    from rectified_flow_vision_tpu_torch.models import BaseFlowModel, ConvVAE, LatentFlowPipeline
    from rectified_flow_vision_tpu_torch.models import flux as TFX
    from rectified_flow_vision_tpu_torch.serving import SamplerService
    from rectified_flow_vision_tpu_torch.serving_http import Batcher

    sys.path.insert(0, str(ROOT / "tests"))
    import flux_reference as R

    torch.cuda.reset_peak_memory_stats()
    model = BaseFlowModel(seed=SEED, sample_dtype="bfloat16", device="cuda", **FLUX)
    g = torch.Generator(device="cuda").manual_seed(SEED + 19)
    with torch.no_grad():
        for name, prm in model.velocity_net.named_parameters():
            if name.endswith("norm.scale"):  # 1 everywhere would hide the scales
                prm.copy_(1 + 0.3 * torch.randn(prm.shape, generator=g, device="cuda"))
    n_params = sum(prm.numel() for prm in model.velocity_net.parameters())

    def prompt(k):  # one prompt's encoder outputs on the host, seeded
        gen = torch.Generator().manual_seed(SEED + 100 + k)
        return {"txt": torch.randn((FLUX_TXT, FLUX["context_in_dim"]), generator=gen),
                "vec": torch.randn((FLUX["vec_in_dim"],), generator=gen)}

    # the forward against the plain float32 FLUX, sharing the parameter tensors
    with torch.device("meta"):
        ref = R.Flux(in_channels=FLUX["in_channels"] * FLUX["patch_size"] ** 2,
                     vec_in_dim=FLUX["vec_in_dim"], context_in_dim=FLUX["context_in_dim"],
                     hidden_size=FLUX["hidden_size"], mlp_ratio=FLUX["mlp_ratio"],
                     num_heads=FLUX["num_heads"], depth=FLUX["depth"],
                     depth_single_blocks=FLUX["depth_single_blocks"], axes_dim=FLUX["axes_dim"],
                     theta=FLUX["theta"], qkv_bias=FLUX["qkv_bias"])
    ref.load_state_dict(model.velocity_net.state_dict(), strict=True, assign=True)
    x = torch.randn((1, FLUX["image_size"], FLUX["image_size"], FLUX["in_channels"]),
                    generator=g, device="cuda")
    t = torch.tensor([0.3], device="cuda")
    cond = {k: c[None].cuda() for k, c in prompt(0).items()}
    with torch.no_grad(), torch.device("cuda"):
        img, img_ids = R.pack(x)
        txt_ids = torch.zeros((1, FLUX_TXT, 3))
        want = R.unpack(ref.velocity(img, img_ids, cond["txt"], txt_ids, t, cond["vec"]), x.shape)
        bare = R.unpack(ref.velocity(img, img_ids, cond["txt"], txt_ids, t, cond["vec"],
                                     rope=False), x.shape)
    del ref
    build.reset_launches()
    with torch.no_grad():
        got32 = model.velocity_net(x, t, dtype=torch.float32, cond=cond).float()
        got16 = model.velocity_net(x, t, dtype=torch.bfloat16, cond=cond).float()
    launches = dict(build.LAUNCHES)
    if launches != flux_counts(build, 2):
        fail(f"FLUX forwards: launches {nonzero(launches)}, expected "
             f"{nonzero(flux_counts(build, 2))}")
    scale = float(want.abs().max())
    err32 = float((got32 - want).abs().max()) / scale
    rms16 = float((got16 - want).norm() / want.norm())
    err_bare = float((bare - want).abs().max()) / scale
    log(f"FLUX forward ({n_params:,} parameters, {FLUX_TXT} + {FLUX_IMG} tokens, batch 1) "
        f"against the plain float32 FLUX on the card: fp32 max |error| {err32:.3e} of the "
        f"largest entry {scale:.4f} (gate {FLUX_F32_ATOL}), bf16 rms {rms16:.3e} (gate "
        f"{FLUX_BF16_RMS}); the reference without RoPE {err_bare:.3e} (must fail the fp32 gate)")
    if not err32 <= FLUX_F32_ATOL:
        fail(f"FLUX fp32 forward {err32:.3e} of the output's scale from the plain reference")
    if not rms16 <= FLUX_BF16_RMS:
        fail(f"FLUX bf16 forward rms {rms16:.3e} from the plain reference")
    if not err_bare > FLUX_F32_ATOL:
        fail(f"FLUX: the reference without RoPE is within the gate ({err_bare:.3e})")
    del want, bare, got32, got16
    torch.cuda.empty_cache()

    # served: a 4-step bf16 sampler and the ConvVAE decode, batch 1, prompts
    vae = ConvVAE(seed=SEED, device="cuda", **FLUX_VAE)
    build.reset_launches()
    t0 = time.perf_counter()
    svc = SamplerService(model, step_counts=(4,), batch_size=1, seed=SEED, vae=vae)
    warm_s = time.perf_counter() - t0
    batcher = Batcher(svc, max_wait_ms=5.0)
    prompts = [prompt(k) for k in range(3)]
    try:
        served = [batcher.submit(1, 4, cond=pr) for pr in prompts]
    finally:
        batcher.shutdown()
    noise = torch.randn((1, FLUX["image_size"], FLUX["image_size"], FLUX["in_channels"]),
                        generator=torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    rows = [{k: c[None].cuda() for k, c in pr.items()} for pr in prompts[:2]]
    pipe = LatentFlowPipeline(model, vae)
    first = pipe.sample(noise=noise, num_steps=4, cond=rows[0],
                        data_format="NHWC").permute(0, 3, 1, 2).cpu().numpy()
    other = pipe.sample(noise=noise, num_steps=4, cond=rows[1],
                        data_format="NHWC").permute(0, 3, 1, 2).cpu().numpy()
    launches = dict(build.LAUNCHES)
    forwards = 4 + 3 * 4 + 2 * 4  # warm-up, three requests, two pipeline samples
    expect = dict(flux_counts(build, forwards), **vae_counts(forwards // 4, "flux"))
    if launches != expect:
        fail(f"FLUX serve launches {nonzero(launches)}, expected {nonzero(expect)}")
    for k, im in enumerate(served):
        if im.shape != (1, 3, FLUX_VAE["image_size"], FLUX_VAE["image_size"]):
            fail(f"FLUX request {k}: shape {im.shape}")
        if not np.isfinite(im).all() or im.min() < -1.0 or im.max() > 1.0:
            fail(f"FLUX request {k}: non-finite or outside [-1, 1]")
        if float(im.std()) < 1e-3:
            fail(f"FLUX request {k}: a constant image")
    if not np.array_equal(first, served[0]):
        fail("FLUX: LatentFlowPipeline.sample from the service's first noise and prompt gave "
             f"another image (max |diff| {float(np.abs(first - served[0]).max()):.3e})")
    moved = float(np.abs(other - first).mean())
    if not moved > 1e-3:
        fail(f"FLUX: the same noise with another prompt gave the same image ({moved:.3e})")
    ms = []
    for k in range(5):
        t0 = time.perf_counter()
        svc.generate(1, 4, cond={k2: c[None] for k2, c in prompts[k % 3].items()})
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    stats = dict(svc.stats)
    log(f"FLUX serve: warm-up {warm_s:.2f} s; three prompted requests through the batcher; "
        f"the pipeline from the same noise and prompt gives the served image bit for bit, "
        f"another prompt moves it by {moved:.4f} (mean |diff|); launches {nonzero(launches)}; "
        f"ms an image (4 steps + decode, batch 1, host clock) {[round(m, 2) for m in ms]}; "
        f"cond_rows {stats['cond_rows']}, cond_sum_s {stats['cond_sum_s']:.4f}; "
        f"peak device memory {peak:.2f} GiB")
    sampler = functools.partial(svc._samplers[4], cond=rows[0])
    profile_device(torch, lambda: svc._run(sampler, noise), "flux_serve_trace.json",
                   "one 4-step 1024 px FLUX image (4 + 8 blocks) with its decode")
    del svc, pipe, model, vae
    torch.cuda.empty_cache()
    return launches


def make_corpus_256(n: int) -> np.ndarray:
    """A seeded corpus of 256x256 images in [-1, 1]: smooth blobs (a 16x16
    normal field, upsampled) plus fine noise."""
    r = np.random.default_rng(SEED + 7)
    coarse = np.kron(r.standard_normal((n, 16, 16, 3)).astype(np.float32),
                     np.ones((1, 16, 16, 1), np.float32))
    fine = 0.1 * r.standard_normal((n, 256, 256, 3), dtype=np.float32)
    return np.tanh(coarse + fine)


def latent_train_phase(torch, build):
    """The latent training path at full width, through the entry points a
    user calls: train_vae, encode, train_base_flow(dit), pairs, reflow,
    straightness, pipeline samples. Returns (launches, base model, latents)."""
    from rectified_flow_vision_tpu_torch import (
        ArrayDataset, BaseFlowModel, ConvVAE, LatentFlowPipeline, RectifiedFlowModel,
        generate_reflow_pairs, train_base_flow, train_rectified_flow, train_vae,
    )
    from rectified_flow_vision_tpu_torch.models.autoencoder import vae_loss

    cfg = LATENT
    images = make_corpus_256(cfg["images"])
    ckpt_dir = ROOT / "build" / "smoke_ckpt"
    steps_per_epoch = cfg["images"] // cfg["batch"]

    build.reset_launches()  # the main path: counts from 0
    vae = ConvVAE(seed=SEED, device="cuda", **VAE)
    probe = torch.as_tensor(images[: cfg["vae_batch"]], device="cuda")
    with torch.no_grad():
        mse0 = float(vae_loss(vae, probe, 1e-4, torch.Generator(device="cuda").manual_seed(SEED))[1])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, mse = train_vae(vae, images, epochs=cfg["vae_epochs"], batch_size=cfg["vae_batch"],
                       seed=SEED, progress=False)
    vae_s = time.perf_counter() - t0
    vae_peak = torch.cuda.max_memory_allocated() / 2**30
    if not (np.isfinite(mse) and mse < mse0):
        fail(f"train_vae: reconstruction MSE {mse0} -> {mse} did not fall")
    vae.save(str(ckpt_dir / "vae.npz"))
    vae = ConvVAE.load(str(ckpt_dir / "vae.npz"), device="cuda")
    with torch.no_grad():
        latents = np.concatenate([
            vae.encode(torch.as_tensor(images[i : i + cfg["vae_batch"]], device="cuda"))
            .cpu().numpy() for i in range(0, cfg["images"], cfg["vae_batch"])])
    if latents.shape != (cfg["images"], 64, 64, 4) or not np.isfinite(latents).all():
        fail(f"encoded corpus: shape {latents.shape} or non-finite")
    log(f"latent train: train_vae {cfg['vae_epochs']} epochs of {cfg['images'] // cfg['vae_batch']}"
        f" x {cfg['vae_batch']} at 256x256 in {vae_s:.1f} s, recon MSE {mse0:.5f} -> {mse:.5f}, "
        f"scaling factor {vae.scaling_factor:.4f}, latent std {latents.std():.4f}, peak device "
        f"memory {vae_peak:.2f} GiB")
    data = ArrayDataset(latents)

    def base_run(save_path):
        model = BaseFlowModel(seed=SEED, compute_dtype="bfloat16", sample_dtype="bfloat16",
                              device="cuda", **DIT)
        losses = train_base_flow(
            model, data, epochs=cfg["base_epochs"], lr=cfg["lr"], batch_size=cfg["batch"],
            save_path=save_path, save_every=cfg["base_epochs"], seed=SEED, progress=False,
            ema_decay=cfg["ema"], warmup_epochs=cfg["warmup_epochs"],
        )
        return model, losses

    t0 = time.perf_counter()
    base, base_losses = base_run(str(ckpt_dir / "dit_base"))
    base_s = time.perf_counter() - t0
    if not np.isfinite(base_losses).all() or not base_losses[-1] < base_losses[0]:
        fail(f"train_base_flow(dit): losses not finite and falling: {base_losses}")

    t0 = time.perf_counter()
    x0, x1 = generate_reflow_pairs(
        base, cfg["pairs"], batch_size=cfg["pair_batch"], num_steps=cfg["teacher_steps"],
        seed=SEED, data_format="NHWC", method="heun",
    )
    pairs_s = time.perf_counter() - t0
    if x0.shape != (cfg["pairs"], 64, 64, 4) or x1.shape != x0.shape:
        fail(f"generate_reflow_pairs(dit) returned {x0.shape}, {x1.shape}")
    if not (np.isfinite(x0).all() and np.isfinite(x1).all()):
        fail("generate_reflow_pairs(dit): non-finite pairs")

    student = RectifiedFlowModel.from_base_model(base, copy_weights=True, seed=SEED + 1000)
    student.reflow_iteration = 1
    t0 = time.perf_counter()
    reflow_losses = train_rectified_flow(
        student, x0, x1, epochs=cfg["reflow_epochs"], batch_size=cfg["batch"], lr=cfg["lr"],
        save_path=str(ckpt_dir / "dit_reflow_k1"), save_every=cfg["reflow_epochs"], seed=SEED,
        data_format="NHWC", progress=False, ema_decay=cfg["ema"], time_sampling="u_shaped",
    )
    reflow_s = time.perf_counter() - t0
    # as for the UNet: the student starts at the teacher, so its loss on the
    # teacher's own couplings is held below the base flow's last loss
    if not np.isfinite(reflow_losses).all() or not reflow_losses[-1] < base_losses[-1]:
        fail(f"train_rectified_flow(dit): losses {reflow_losses} vs base {base_losses[-1]}")

    straight = student.compute_straightness(
        x0[: cfg["samples"]], x1[: cfg["samples"]], cfg["straight_points"], data_format="NHWC")
    if not (np.isfinite(straight) and straight >= 0.0):
        fail(f"compute_straightness(dit) returned {straight}")

    ema_model = BaseFlowModel.from_checkpoint(str(ckpt_dir / "dit_reflow_k1_ema_final.npz"),
                                              device="cuda")
    if not (isinstance(ema_model, RectifiedFlowModel) and ema_model.backbone == "dit"
            and ema_model.velocity_net.cfg.remat and ema_model.reflow_iteration == 1):
        fail("the DiT student's EMA checkpoint did not come back as it was saved")
    imgs = LatentFlowPipeline(ema_model, vae).sample(
        num_steps=4, batch_size=cfg["samples"],
        generator=torch.Generator(device="cuda").manual_seed(SEED)).cpu().numpy()
    launches = dict(build.LAUNCHES)
    if imgs.shape != (cfg["samples"], 3, 256, 256) or not np.isfinite(imgs).all():
        fail(f"pipeline samples: shape {imgs.shape} or non-finite")
    if imgs.min() < -1.0 or imgs.max() > 1.0:
        fail("pipeline samples leave [-1, 1]")

    train_steps = (cfg["base_epochs"] + cfg["reflow_epochs"]) * steps_per_epoch
    forwards = (-(-cfg["pairs"] // cfg["pair_batch"]) * cfg["teacher_steps"] * 2  # heun
                + cfg["straight_points"] + 4)
    # the ConvVAE: every GroupNorm on the streamed plan (fp32 256x256 images
    # in training and encoding, the bf16 decode of the samples), its decode's
    # two conv3x3 sites; the probe's and each train step's encode and decode,
    # the backward's six GroupNorms a step; the calibration's and the
    # corpus's encodes (three GroupNorms a batch); the samples' decode
    vae_steps = cfg["vae_epochs"] * (cfg["images"] // cfg["vae_batch"])
    encodes = 2 * -(-min(cfg["images"], 256) // cfg["vae_batch"])
    vae_fwd = 1 + vae_steps  # encode + decode
    expect = all_counts(
        build, flash_attention=DIT_DEPTH * (2 * train_steps + forwards),
        flash_attention_backward=DIT_DEPTH * train_steps,
        gn_silu_streamed=6 * vae_fwd + 3 * encodes + 3, gn_silu_backward=6 * vae_steps,
        conv3x3=2 * vae_fwd + 2,
        **dit_glue(DIT_DEPTH * (2 * train_steps + forwards), train_steps + forwards))
    log(f"latent train: DiT-S/2 base {cfg['base_epochs']} epochs x {steps_per_epoch} steps of "
        f"{cfg['batch']} (lr {cfg['lr']}, warm-up {cfg['warmup_epochs']} epoch, EMA {cfg['ema']}, "
        f"remat) in {base_s:.1f} s, losses {[round(v, 4) for v in base_losses]}")
    log(f"latent train: {cfg['pairs']} heun pairs at {cfg['teacher_steps']} teacher steps (the "
        f"config has 100), pair batch {cfg['pair_batch']}, in {pairs_s:.1f} s; reflow "
        f"{cfg['reflow_epochs']} epochs (teacher-init, u_shaped) in {reflow_s:.1f} s, losses "
        f"{[round(v, 5) for v in reflow_losses]}; straightness {straight:.5f}; "
        f"{cfg['samples']} 4-step 256x256 samples from the EMA in [{imgs.min():.3f}, "
        f"{imgs.max():.3f}]")
    log(f"latent train: launches {nonzero(launches)}")
    if launches != expect:
        fail(f"latent train launches {launches}, expected {expect} "
             f"({train_steps} train steps, {forwards} eval forwards)")

    # the flash backward uses no atomics: the same seeds give the same bits
    _, again = base_run(None)
    log(f"latent train: a second base run from the same seeds: losses "
        f"{'equal bit for bit' if again == base_losses else 'DIFFER'}; first epoch "
        f"{base_losses[0]!r} vs {again[0]!r}")
    if again != base_losses:
        fail(f"same seeds gave another DiT loss trajectory: {base_losses} vs {again}")
    return launches, base, data


def dit_train_timing_phase(torch, build, model, data, dname="bfloat16"):
    """img/s of device-resident DiT-S/2 training at batch 64 in ``dname``
    (the model's compute dtype) with remat and EMA, peak memory, the launches
    of one step (returned), and one step under the profiler."""
    from rectified_flow_vision_tpu_torch.models.base_flow import (
        init_ema, make_optimizer, make_train_epoch)

    steps, batch = 6, LATENT["batch"]
    opt = make_optimizer(model, LATENT["lr"], 1000, steps)
    ema = init_ema(model)
    epoch = make_train_epoch(model, opt, coupled=False, ema=ema, ema_decay=LATENT["ema"])
    corpus = torch.as_tensor(data.images, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    r = np.random.default_rng(SEED)

    def perm(n):
        return torch.as_tensor(r.integers(0, len(data), (n, batch)), device="cuda")

    build.reset_launches()
    epoch(corpus, perm(1), gen)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    per_step = all_counts(build, flash_attention=2 * DIT_DEPTH,
                          flash_attention_backward=DIT_DEPTH, **dit_glue(2 * DIT_DEPTH, 1))
    if launches != per_step:
        fail(f"one {dname} DiT train step launched {launches}, expected {per_step}")
    torch.cuda.reset_peak_memory_stats()
    rates = []
    for _ in range(4):
        p = perm(steps)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = epoch(corpus, p, gen)
        torch.cuda.synchronize()
        rates.append(batch * steps / (time.perf_counter() - t0))
        if not torch.isfinite(losses).all():
            fail(f"{dname} DiT train timing: non-finite loss")
    peak = torch.cuda.max_memory_allocated() / 2**30
    what = "bf16 compute, fp32 masters" if dname == "bfloat16" else "fp32 compute"
    log(f"DiT train timing: make_train_epoch, DiT-S/2, batch {batch}, {what}, EMA, remat, "
        f"64x64x4 latents, {steps} steps per reading: img/s {[round(v, 2) for v in rates]} "
        f"(median {float(np.median(rates)):.2f}); peak device memory {peak:.2f} GiB; flash "
        f"launches per step: {launches['flash_attention']} forward, "
        f"{launches['flash_attention_backward']} backward")
    one = perm(1)
    profile_device(torch, lambda: epoch(corpus, one, gen),
                   f"dit_train_{'bf16' if dname == 'bfloat16' else 'fp32'}_trace.json",
                   f"one {dname} DiT-S/2 train step of {batch}")
    return launches


def _read_csv(path: Path):
    import csv

    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def cli_phase(torch, build, serve_img_s: float):
    """The port's CLI, ``main(argv)``, in-process so that the launch counters
    can be read, on a copy of ``configs/config.yaml`` cut as ``CLI`` says.
    Returns its launch counts."""
    import shutil

    from rectified_flow_vision_tpu_torch import config as config_lib
    from rectified_flow_vision_tpu_torch.experiments import benchmark as bench_mod
    from rectified_flow_vision_tpu_torch.experiments import train_base as base_mod
    from rectified_flow_vision_tpu_torch.experiments import train_rectified as rect_mod
    from rectified_flow_vision_tpu_torch.main import main as cli_main
    from rectified_flow_vision_tpu_torch.utils import download_data as data_mod

    out = ROOT / "build" / "cli_smoke"
    shutil.rmtree(out, ignore_errors=True)
    cfg = config_lib.load_config(ROOT / "configs" / "config.yaml")
    cfg.data.num_mock_images = CLI["num_mock_images"]
    cfg.data.data_dir = str(out / "data")
    cfg.training_base.epochs = CLI["base_epochs"]
    cfg.training_rectified.epochs = CLI["reflow_epochs"]
    cfg.training_rectified.num_pairs = CLI["num_pairs"]
    cfg.benchmark.num_runs = CLI["num_runs"]
    cfg.benchmark.quality_samples = CLI["quality_samples"]
    cfg.paths.checkpoints = str(out / "checkpoints")
    cfg.paths.results = str(out / "results")
    cfg.paths.figures = str(out / "results" / "figures")
    cfg_path = out / "config.yaml"
    cfg.save(cfg_path)
    if config_lib.load_config(cfg_path) != cfg:
        fail("the saved CLI config does not read back to itself")

    # each step's seconds, and the device of every model the steps train or
    # benchmark, read by wrapping the functions main() calls
    seconds, devices = {}, set()

    def timed(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t0
            return result
        return run

    def on_device(fn):
        def run(model, *args, **kwargs):
            devices.update(p.device.type for p in getattr(model, "flow", model).parameters())
            return fn(model, *args, **kwargs)
        return run

    patches = [
        mock.patch.object(data_mod, "download_data",
                          timed("1 data", data_mod.download_data)),
        mock.patch.object(base_mod, "main", timed("2 train_base", base_mod.main)),
        mock.patch.object(rect_mod, "main", timed("3 train_rectified", rect_mod.main)),
        mock.patch.object(bench_mod, "main", timed("4 benchmark", bench_mod.main)),
        mock.patch.object(base_mod, "train_base_flow", on_device(base_mod.train_base_flow)),
        mock.patch.object(rect_mod, "train_rectified_flow",
                          on_device(rect_mod.train_rectified_flow)),
        mock.patch.object(bench_mod, "benchmark_throughput",
                          on_device(bench_mod.benchmark_throughput)),
        # the held-out references go under build/cli_smoke/data/eval_64
        mock.patch.object(config_lib, "repo_root", lambda: out),
    ]
    for p in patches:
        p.start()
    build.reset_launches()  # the main path: counts from 0
    try:
        t0 = time.perf_counter()
        cli_main(["--offline", "--config", str(cfg_path)])
        total_s = time.perf_counter() - t0
    finally:
        launches = dict(build.LAUNCHES)
        for p in reversed(patches):
            p.stop()

    log(f"cli: main(['--offline', '--config', '{cfg_path.relative_to(ROOT)}']) in "
        f"{total_s:.1f} s; steps (s): " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    log(f"cli: launches {nonzero(launches)}; models on {sorted(devices)}")
    if sorted(seconds) != ["1 data", "2 train_base", "3 train_rectified", "4 benchmark"]:
        fail(f"the CLI ran the steps {sorted(seconds)}")
    missing = [k for k in CLI_KERNELS if launches[k] <= 0]
    if missing:
        fail(f"the CLI never launched {missing}")
    if devices != {"cuda"}:
        fail(f"the CLI's models were on {devices}")

    ck, res = out / "checkpoints", out / "results"
    for name in ("base_flow_final", "base_flow_ema_final", "rectified_flow_k1_final",
                 "rectified_flow_k1_ema_final", "reflow_k1_final", "reflow_k1_ema_final",
                 "reflow_k2_final", "reflow_k2_ema_final"):
        if not (ck / f"{name}.npz").is_file():
            fail(f"the CLI wrote no {name}.npz")
    base_losses = np.load(ck / "base_flow_losses.npy")
    rect_losses = np.load(ck / "rectified_flow_k1_losses.npy")
    if not (np.isfinite(base_losses).all() and np.isfinite(rect_losses).all()):
        fail(f"non-finite losses: base {base_losses}, reflow {rect_losses}")
    if not base_losses[-1] < base_losses[0]:
        fail(f"the base loss did not fall: {base_losses}")
    log(f"cli: base losses {[round(float(v), 4) for v in base_losses]}, reflow k1 losses "
        f"{[round(float(v), 5) for v in rect_losses]}")

    speed = _read_csv(res / "benchmark_results.csv")
    steps = [int(r["num_steps"]) for r in speed]
    if steps != list(cfg.benchmark.steps_to_test):
        fail(f"benchmark_results.csv has the step counts {steps}")
    times = [float(r[k]) for r in speed for k in ("base_time_ms", "rect_time_ms",
                                                  "base_dispatch_bound_ms_b4",
                                                  "rect_dispatch_bound_ms_b4")]
    if not all(math.isfinite(t) and t > 0 for t in times):
        fail("benchmark_results.csv holds a time that is not positive")
    quality = _read_csv(res / "quality_results.csv")
    rows = [(int(r["num_steps"]), r["model"]) for r in quality]
    want = [(s, m) for s in (1, 2, 4, 8) for m in ("base", "rectified")] + [(100, "base")]
    if rows != want:
        fail(f"quality_results.csv has the rows {rows}")
    for r in quality:
        fid, ssim = float(r["fid_deep"] or "nan"), float(r["ssim_mean"] or "nan")
        if not (math.isfinite(fid) and -1.0 <= ssim <= 1.0):
            fail(f"quality row {r['num_steps']} {r['model']}: fid_deep {fid}, ssim {ssim}")
    report_path = res / "benchmark_report.txt"
    report = report_path.read_text() if report_path.is_file() else ""
    if "MEASURED QUALITY CONCLUSIONS" not in report:
        fail("benchmark_report.txt or its conclusions were not written")
    by_steps = {int(r["num_steps"]): r for r in speed}
    log("cli: benchmark throughput (chained, batch "
        f"{cfg.benchmark.throughput_batch}, {cfg.model.sample_dtype}) img/s: " + ", ".join(
            f"{s} steps base {float(by_steps[s]['base_img_per_sec']):.2f} rect "
            f"{float(by_steps[s]['rect_img_per_sec']):.2f}" for s in (1, 2, 4))
        + f"; the serve phase's throughput(4) {serve_img_s:.2f}")
    log("cli: benchmark latency (batch 4, the reference's sweep) ms/img: " + ", ".join(
        f"{s} steps base {float(by_steps[s]['base_dispatch_bound_ms_b4']):.3f} rect "
        f"{float(by_steps[s]['rect_dispatch_bound_ms_b4']):.3f}" for s in (1, 4, 100)))
    # where a batch-4 sample's time goes: the trained base model, one 4-step
    # sample of the latency sweep's shape, under the profiler
    from rectified_flow_vision_tpu_torch.models import BaseFlowModel

    model = BaseFlowModel.from_checkpoint(str(ck / "base_flow_ema_final.npz"), device="cuda")
    noise = torch.randn((4, 64, 64, 3), generator=torch.Generator(device="cuda").manual_seed(SEED),
                        device="cuda")
    profile_device(torch, lambda: model.sample(noise=noise, num_steps=4, data_format="NHWC"),
                   "cli_latency_trace.json", "one 4-step sample of batch 4 (the latency sweep's)")
    log("cli: quality " + "; ".join(
        f"{r['model']}@{r['num_steps']} fid_deep {float(r['fid_deep']):.2f} "
        f"ssim {float(r['ssim_mean']):.4f}" for r in quality))
    conclusions = report.split("MEASURED QUALITY CONCLUSIONS", 1)[1].strip().splitlines()[1:]
    log("cli: conclusions: " + " | ".join(conclusions))
    cli_quality_gates(torch, cfg, ck, out, bench_mod, config_lib)
    return launches


def _gram_fid(f1: np.ndarray, f2: np.ndarray) -> float:
    """The Frechet distance by the Gram identity: tr sqrt(S1 S2) is the
    nuclear norm of A B^T / sqrt(c1 c2), an n x n SVD."""
    a, b = f1 - f1.mean(0), f2 - f2.mean(0)
    c1, c2 = len(f1) - 1, len(f2) - 1
    diff = f1.mean(0) - f2.mean(0)
    tr_sqrt = np.linalg.svd(a @ b.T, compute_uv=False).sum() / math.sqrt(c1 * c2)
    return float(diff @ diff + (a * a).sum() / c1 + (b * b).sum() / c2 - 2.0 * tr_sqrt)


def cli_quality_gates(torch, cfg, ck: Path, out: Path, bench_mod, config_lib) -> None:
    """What the CLI's quality rows cannot show at this cut. Its 64 base steps
    leave the EMA weights (decay 0.999) about 94% the initial ones, and the
    benchmark loads those (``prefer_ema``), so every row is that of a
    near-random model. Here:

    * the models that the benchmark loads sample bit for bit what
      ``from_checkpoint`` of the EMA files it names samples, and the raw and
      EMA files differ (a mis-wired load fails);
    * the sampler's Euler steps equal a plain loop over the model's velocity
      field (a broken sampler fails);
    * fid_deep of the benchmark's references against the raw (not EMA) base
      model at 1 and 100 steps and the EMA one at 100, with bootstrap CIs:
      each by fid_from_features' d x d branch (the config's), held against
      the Gram identity; the raw model's two step counts differ beyond their
      CIs (a velocity field that learned nothing gives the same images at
      every step count), and its 100-step CI lies below the EMA model's.
    """
    from rectified_flow_vision_tpu_torch.data import eval_reference_images
    from rectified_flow_vision_tpu_torch.models import BaseFlowModel, RectifiedFlowModel
    from rectified_flow_vision_tpu_torch.utils.metrics import MetricsCalculator

    dev = torch.device("cuda")
    size = cfg.data.image_size
    noise = bench_mod._noise((8, size, size, 3), SEED, dev)
    loaded = {}
    for cls, name in ((BaseFlowModel, "base_flow"), (RectifiedFlowModel, "rectified_flow_k1")):
        model = bench_mod._load_model(cls, cfg, ck / f"{name}_final.npz", name, dev)
        direct = cls.from_checkpoint(str(ck / f"{name}_ema_final.npz"), device="cuda")
        raw = cls.from_checkpoint(str(ck / f"{name}_final.npz"), device="cuda")
        got, want, other = (m.sample(noise=noise, num_steps=4, data_format="NHWC",
                                     dtype=cfg.model.sample_dtype) for m in (model, direct, raw))
        if type(model) is not cls or not torch.equal(got, want):
            fail(f"the benchmark's {name} model is not {name}_ema_final.npz")
        if torch.equal(got, other):
            fail(f"{name}_ema_final.npz samples what {name}_final.npz samples")
        loaded[name] = (model, raw)
    ema, raw = loaded["base_flow"]

    # Euler's steps as a plain loop over the fp32 velocity field
    steps = 8
    x = noise.clone()
    for i in range(steps):
        t = torch.full((x.shape[0],), np.float32(i) * np.float32(1.0 / steps), device=dev)
        x = x + raw(x, t, data_format="NHWC").float() * float(np.float32(1.0 / steps))
    got = raw.sample(noise=noise, num_steps=steps, data_format="NHWC", dtype="float32")
    err = (got - x).abs().max().item()
    log(f"cli gates: the sampler's {steps} Euler steps against a plain loop: max |err| {err:.3g}")
    if not err <= 1e-5:
        fail(f"the sampler disagrees with the plain Euler loop by {err}")

    n = cfg.benchmark.quality_samples
    with mock.patch.object(config_lib, "repo_root", lambda: out):
        refs = eval_reference_images(size, n)
    ref_nchw = np.transpose(refs, (0, 3, 1, 2))
    calc = MetricsCalculator(dev)
    features = calc.lpips_model.fid_features
    f_ref = calc._features(ref_nchw, features)
    if f_ref.shape != (n, 480):
        fail(f"SynthNet features of shape {f_ref.shape}: not the d x d branch")

    def samples(model, num_steps):  # benchmark_quality's noise and blocks
        return np.concatenate([
            model.sample(noise=bench_mod._noise((min(256, n - i), size, size, 3),
                                                7 * 1000003 + i, dev),
                         num_steps=num_steps, data_format="NHWC").float().cpu().numpy()
            for i in range(0, n, 256)])

    fids = {}
    for name, model, num_steps in (("raw@1", raw, 1), ("raw@100", raw, 100),
                                   ("ema@100", ema, 100)):
        gen = np.transpose(samples(model, num_steps), (0, 3, 1, 2))
        t0 = time.perf_counter()
        ci = calc.compute_fid_deep_ci(ref_nchw, gen, n_boot=FID_BOOT)
        sec = time.perf_counter() - t0
        gram = _gram_fid(f_ref, calc._features(gen, features))
        rel = abs(ci["fid"] - gram) / abs(gram)
        log(f"cli gates: fid_deep {name} (n {n}) {ci['fid']:.4f} [{ci['lo']:.4f}, "
            f"{ci['hi']:.4f}], Gram identity {gram:.4f} (rel diff {rel:.3g}); "
            f"{1 + FID_BOOT} Frechet distances (d x d) in {sec:.2f} s")
        if not (all(math.isfinite(ci[k]) for k in ("fid", "lo", "hi")) and rel <= 1e-6):
            fail(f"fid_deep {name} {ci} against the Gram identity {gram}")
        fids[name] = ci
    one, many, ema_many = fids["raw@1"], fids["raw@100"], fids["ema@100"]
    if not (one["lo"] > many["hi"] or one["hi"] < many["lo"]):
        fail(f"the raw base model's fid_deep at 1 and 100 steps overlap: {one} {many}")
    if not many["hi"] < ema_many["lo"]:
        fail(f"the raw base model's fid_deep at 100 steps is not below the EMA one's: "
             f"{many} {ema_many}")


def _state_diff(a, b):
    """Largest |difference| of any entry between two {name: tensor} dicts."""
    if a.keys() != b.keys():
        fail(f"state dicts differ in their names: {sorted(a.keys() ^ b.keys())[:5]}")
    return max(float((a[k].cpu().double() - b[k].cpu().double()).abs().max()) for k in a)


def _rel_loss_diff(a, b):
    return max(abs(x - y) / abs(x) for x, y in zip(a, b))


def resume_phase(torch, build):
    """Resume of both trainers at full width on the card, through the entry
    points a user calls: ``train_base_flow`` (EMA, device-resident epochs)
    and then ``train_rectified_flow`` (teacher-init, u-shaped t, EMA) on heun
    pairs from the trained teacher, each run uninterrupted twice (their
    difference is the card's own spread: cuDNN's backward may sum in another
    order from run to run) and once crashed after epoch 2's state is
    committed, then resumed. The resumed run's losses, weights and EMA are
    held to RESUME_SPREAD_FACTOR x that spread + RESUME_FLOOR. Then a state
    written by ``TrainStateManager`` and a checkpoint written by
    ``AsyncSaver`` while training goes on equal snapshots taken at the save.
    Returns the phase's launch counts."""
    from rectified_flow_vision_tpu_torch import (
        ArrayDataset, BaseFlowModel, RectifiedFlowModel, generate_reflow_pairs,
        train_base_flow, train_rectified_flow,
    )
    from rectified_flow_vision_tpu_torch.utils import train_state as ts

    import shutil

    cfg = RESUME
    root = ROOT / "build" / "resume_smoke"
    shutil.rmtree(root, ignore_errors=True)
    data = ArrayDataset(make_corpus(cfg["images"]))
    common = dict(epochs=cfg["epochs"], lr=cfg["lr"], save_every=1, seed=SEED, progress=False,
                  ema_decay=cfg["ema"], device_epoch=True)
    pairs = {}

    def base(tag):
        model = BaseFlowModel(image_size=64, seed=SEED, compute_dtype="bfloat16",
                              sample_dtype="bfloat16", device="cuda")
        return model, train_base_flow(model, data, batch_size=cfg["batch"],
                                      resume_dir=str(root / tag), **common)

    def reflow(tag):
        student = RectifiedFlowModel.from_base_model(pairs["teacher"], copy_weights=True,
                                                     seed=SEED + 1000)
        losses = train_rectified_flow(
            student, pairs["x0"], pairs["x1"], batch_size=cfg["batch"], data_format="NHWC",
            time_sampling="u_shaped", resume_dir=str(root / tag), **common)
        return student, losses

    orig_save = ts.TrainStateManager.save

    def crashing_save(self, epoch, *args, **kwargs):
        orig_save(self, epoch, *args, **kwargs)
        if epoch == 1:  # epoch 2's state is committed, then the run dies
            self.wait()
            raise KeyboardInterrupt("simulated crash")

    def final_state(tag):
        params, _, losses, next_epoch, ema = ts.TrainStateManager(root / tag).restore()
        if next_epoch != cfg["epochs"] or ema is None:
            fail(f"{tag}: the final state is epoch {next_epoch - 1}, EMA {ema is not None}")
        return params, ema, losses

    build.reset_launches()
    t0 = time.perf_counter()
    for what, run in (("train_base_flow", base), ("train_rectified_flow", reflow)):
        prefix = what.split("_")[1]
        model_a, losses_a = run(f"{prefix}_a")
        _, losses_b = run(f"{prefix}_b")
        with mock.patch.object(ts.TrainStateManager, "save", crashing_save):
            try:
                run(f"{prefix}_c")
                fail(f"{what}: the simulated crash did not happen")
            except KeyboardInterrupt:
                pass
        if ts.TrainStateManager(root / f"{prefix}_c").epochs() != [0, 1]:
            fail(f"{what}: the crashed run did not leave epochs 1 and 2 committed")
        _, losses_c = run(f"{prefix}_c")
        (pa, ea, la), (pb, eb, lb), (pc, ec, lc) = (final_state(f"{prefix}_{x}") for x in "abc")
        if not (la == losses_a and lb == losses_b and lc == losses_c):
            fail(f"{what}: the saved losses are not the returned ones")
        if not np.isfinite(losses_a + losses_b + losses_c).all() or len(losses_c) != 3:
            fail(f"{what}: losses {losses_a} {losses_b} {losses_c}")
        spread = {"loss": _rel_loss_diff(losses_a, losses_b), "params": _state_diff(pa, pb),
                  "ema": _state_diff(ea, eb)}
        resumed = {"loss": _rel_loss_diff(losses_a, losses_c), "params": _state_diff(pa, pc),
                   "ema": _state_diff(ea, ec)}
        log(f"resume: {what}, {cfg['epochs']} epochs x {cfg['images'] // cfg['batch']} steps of "
            f"{cfg['batch']} (bf16, EMA {cfg['ema']}, device epochs), crashed after epoch 2: "
            f"losses {[round(v, 5) for v in losses_a]}; two uninterrupted runs differ by "
            + ", ".join(f"{k} {v:.3e}" for k, v in spread.items())
            + "; the resumed run from the first by "
            + ", ".join(f"{k} {v:.3e}" for k, v in resumed.items())
            + f" (bound {RESUME_SPREAD_FACTOR} x spread + {RESUME_FLOOR}; loss relative, weights "
            "and EMA largest |difference|)")
        for k, v in resumed.items():
            if v > RESUME_SPREAD_FACTOR * spread[k] + RESUME_FLOOR:
                fail(f"{what}: the resumed run's {k} differs by {v:.3e}, beyond "
                     f"{RESUME_SPREAD_FACTOR} x the spread {spread[k]:.3e} + {RESUME_FLOOR}")
        if what == "train_base_flow":
            x0, x1 = generate_reflow_pairs(
                model_a, cfg["pairs"], batch_size=cfg["pair_batch"],
                num_steps=cfg["teacher_steps"], seed=SEED, data_format="NHWC", method="heun")
            pairs.update(teacher=model_a, x0=x0, x1=x1)
    launches = dict(build.LAUNCHES)
    log(f"resume: both trainers in {time.perf_counter() - t0:.1f} s, launches {nonzero(launches)}")
    steps_per_epoch = cfg["images"] // cfg["batch"]
    # each trainer: runs a and b, the crashed run's 2 epochs and the resumed one's 1
    train_steps = 2 * 3 * cfg["epochs"] * steps_per_epoch
    forwards = -(-cfg["pairs"] // cfg["pair_batch"]) * cfg["teacher_steps"] * 2  # heun
    expect = all_counts(build, **{
        k: train_steps * TRAIN_STEP_LAUNCHES[k] + forwards * EVAL_FORWARD_LAUNCHES[k]
        for k in TRAIN_STEP_LAUNCHES})
    if launches != expect:
        fail(f"resume launches {launches}, expected {expect}")
    saver_phase(torch, pairs["teacher"], data)
    shutil.rmtree(root)  # 3 GB of train states
    return launches


def saver_phase(torch, model, data) -> None:
    """``TrainStateManager.save`` and ``AsyncSaver.save`` snapshot on the
    caller's thread: training goes on in place while their threads write, and
    what they wrote equals a copy taken at the save, bit for bit."""
    from rectified_flow_vision_tpu_torch.models.base_flow import (
        init_ema, make_optimizer, make_train_epoch)
    from rectified_flow_vision_tpu_torch.utils import checkpoint as ckpt_io
    from rectified_flow_vision_tpu_torch.utils import train_state as ts

    opt = make_optimizer(model, RESUME["lr"], 10, 4)
    ema = init_ema(model)
    epoch = make_train_epoch(model, opt, coupled=False, ema=ema, ema_decay=RESUME["ema"])
    corpus = torch.as_tensor(data.images, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    perm = torch.arange(4 * RESUME["batch"], device="cuda").reshape(4, -1) % len(data)
    epoch(corpus, perm[:1], gen)
    snap = {k: v.detach().clone() for k, v in model.state_dict().items()}
    snap_ema = {k: v.clone() for k, v in ema.items()}
    snap_moments = {k: v.clone() for k, v in opt.adamw.state[opt.params[0]].items()}
    mgr = ts.TrainStateManager(ROOT / "build" / "resume_smoke" / "saver")
    saver = ckpt_io.AsyncSaver()
    path = ROOT / "build" / "resume_smoke" / "saver.npz"
    mgr.save(0, model.state_dict(), opt.state_dict(), [0.0], ema=ema)
    saver.save(path, model.state_dict())
    epoch(corpus, perm, gen)  # in place, while the two threads write
    torch.cuda.synchronize()
    mgr.close()
    saver.wait()
    params, opt_state, _, _, ema_r = ts.TrainStateManager(mgr.directory).restore()
    moved = _state_diff(snap, model.state_dict())
    saved = ckpt_io.load_params(path)[0]
    exact = (all(torch.equal(params[k], v.cpu()) for k, v in snap.items())
             and all(torch.equal(ema_r[k], v.cpu()) for k, v in snap_ema.items())
             and all(torch.equal(opt_state["adamw"]["state"][0][k], v.cpu())
                     for k, v in snap_moments.items())
             and opt_state["step_count"] == 1
             and all(np.array_equal(saved[k], v.cpu().numpy()) for k, v in snap.items()))
    log(f"resume: TrainStateManager and AsyncSaver wrote the state at save while 4 more steps "
        f"moved the weights by up to {moved:.3e}: {'bit for bit' if exact else 'DIFFERENT'}")
    if not exact or moved == 0.0:
        fail("a state written while training went on is not the snapshot taken at the save")


def _get(url: str, timeout: float = 60.0):
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read()


def _post(url: str, payload: dict, timeout: float = 120.0):
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def http_phase(torch, build):
    """The HTTP front end at full width: ``SamplerService`` (batch 256, steps
    1, 2, 4, bf16) behind ``make_server`` on 127.0.0.1, an ephemeral port.
    HTTP["clients"] concurrent clients, client i asking for n =
    HTTP["sizes"][i % 4] images (PNG for every fourth, else npy) and sending
    its next request as soon as the last one returns, for HTTP["window_s"]
    seconds: HTTP["readings"] such readings at each of HTTP["steps"]. npy
    and PNG responses checked, requests coalesced into fewer sampler calls,
    a 400 for an unconfigured step count, /healthz and /metrics. img/s of a
    reading is all its images over the time from its start to its last
    answer; p50 / p99 over its requests, and over all requests at a step
    count, with the readings' spread and the share of the time the batcher
    spent in the sampler. Then ``python -m
    rectified_flow_vision_tpu_torch.serving_http`` in its own process
    answers a request. Returns the in-process launch counts."""
    import base64
    import io
    import threading

    from PIL import Image

    from rectified_flow_vision_tpu_torch.models import BaseFlowModel
    from rectified_flow_vision_tpu_torch.serving import SamplerService
    from rectified_flow_vision_tpu_torch.serving_http import make_server

    model = BaseFlowModel(image_size=64, seed=SEED, sample_dtype="bfloat16", device="cuda")
    build.reset_launches()
    svc = SamplerService(model, step_counts=(1, 2, 4), batch_size=BATCH, seed=SEED)
    calls, generate = [], svc.generate

    def recording(n, num_steps=None, **kw):  # the batcher's sampler calls
        calls.append((n, num_steps))
        return generate(n, num_steps=num_steps, **kw)

    def check(n, fmt, code, body, what):
        if code != 200:
            fail(f"HTTP: {what} returned {code}: {body[:200]!r}")
        if fmt == "npy":
            arr = np.load(io.BytesIO(body))
            if arr.shape != (n, 3, 64, 64) or not np.isfinite(arr).all():
                fail(f"HTTP: npy response of shape {arr.shape} for n={n}, or non-finite")
            if arr.min() < -1.0 or arr.max() > 1.0:
                fail("HTTP: npy response outside [-1, 1]")
        else:
            pngs = json.loads(body)["images_png_b64"]
            imgs = [Image.open(io.BytesIO(base64.b64decode(p))) for p in pngs]
            if len(imgs) != n or any(im.size != (64, 64) or im.mode != "RGB" for im in imgs):
                fail(f"HTTP: PNG response of {len(imgs)} images, not {n} RGB 64x64")

    svc.generate = recording
    httpd, batcher = make_server(svc, "127.0.0.1", 0, max_wait_ms=HTTP["max_wait_ms"])
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    readings, n_requests, n_images = [], 0, 0
    try:
        for steps in HTTP["steps"]:
            for r in range(HTTP["readings"]):
                answers = [[] for _ in range(HTTP["clients"])]
                sampler_s, first_call = batcher.stats["latency_sum_s"], len(calls)
                t0 = time.perf_counter()

                def client(i):
                    n = HTTP["sizes"][i % len(HTTP["sizes"])]
                    fmt = "png" if i % 4 == 0 else "npy"
                    while (sent := time.perf_counter()) - t0 < HTTP["window_s"]:
                        code, _, body = _post(url + "/generate", {"n": n, "num_steps": steps,
                                                                   "format": fmt})
                        answers[i].append((n, fmt, code, body, sent, time.perf_counter()))

                threads = [threading.Thread(target=client, args=(i,))
                           for i in range(HTTP["clients"])]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=300)
                wall = max(a[5] for ans in answers for a in ans) - t0
                lat = [(a[5] - a[4]) * 1e3 for ans in answers for a in ans]
                images = sum(a[0] for ans in answers for a in ans)
                readings.append(dict(steps=steps, wall=wall, images=images, lat=lat,
                                     sizes=[a[0] for ans in answers for a in ans],
                                     calls=calls[first_call:],
                                     sampler=batcher.stats["latency_sum_s"] - sampler_s))
                for i, ans in enumerate(answers):
                    if not ans:
                        fail(f"HTTP: client {i} got no answer in {HTTP['window_s']} s")
                    for j, (n, fmt, code, body, _, _) in enumerate(ans):
                        check(n, fmt, code, body, f"request {j} of client {i}")
                n_requests += len(lat)
                n_images += images
        bad_code, _, _ = _post(url + "/generate", {"n": 1, "num_steps": 3})
        health_code, health = _get(url + "/healthz")
        metrics_code, metrics = _get(url + "/metrics")
    finally:
        httpd.shutdown()
        batcher.shutdown()
        httpd.server_close()
    launches = dict(build.LAUNCHES)

    counters = dict(line.split() for line in metrics.decode().splitlines())
    requests, batches = int(counters["rfv_requests_total"]), int(counters["rfv_batches_total"])
    health = json.loads(health)
    if bad_code != 400 or health_code != 200 or metrics_code != 200:
        fail(f"HTTP: unconfigured steps gave {bad_code}, /healthz {health_code}, "
             f"/metrics {metrics_code}")
    if health["step_counts"] != [1, 2, 4] or health["batch_size"] != BATCH:
        fail(f"HTTP: /healthz says {health}")
    if not (requests == n_requests and batches < requests):
        fail(f"HTTP: {requests} requests (clients counted {n_requests}) in {batches} "
             "sampler calls: no coalescing")
    images = int(counters["rfv_images_total"])
    log(f"HTTP: {HTTP['clients']} concurrent clients, n in {HTTP['sizes']}, readings of "
        f"{HTTP['window_s']} s: {requests} requests, {images} images in {batches} sampler calls "
        f"(batch {BATCH}, bf16); a 400 for 3 steps; launches {nonzero(launches)}")
    for steps in HTTP["steps"]:
        mine = [r for r in readings if r["steps"] == steps]
        rates = [r["images"] / r["wall"] for r in mine]
        for r, rate in zip(mine, rates):
            log(f"HTTP: {steps} steps, a reading: {rate:.2f} img/s ({r['images']} images, "
                f"{len(r['lat'])} requests in {r['wall']:.3f} s), p50 "
                f"{np.percentile(r['lat'], 50):.2f} ms, p99 {np.percentile(r['lat'], 99):.2f} ms; "
                f"the batcher in the sampler {r['sampler'] / r['wall']:.3f} of the time")
        lat = np.array([x for r in mine for x in r["lat"]])
        sizes = np.array([x for r in mine for x in r["sizes"]])
        mine_calls = [c for r in mine for c in r["calls"]]
        fill = sum(n for n, _ in mine_calls) / (BATCH * sum(-(-n // BATCH) for n, _ in mine_calls))
        log(f"HTTP: {steps} steps, all {len(mine)} readings: "
            f"{sum(r['images'] for r in mine) / sum(r['wall'] for r in mine):.2f} img/s, "
            f"readings {min(rates):.2f}-{max(rates):.2f} (spread "
            f"{(max(rates) - min(rates)) / np.median(rates):.3f} of the median); {len(lat)} "
            f"requests p50 {np.percentile(lat, 50):.2f} ms, p99 {np.percentile(lat, 99):.2f} ms; "
            f"p50 / p99 by n: " + ", ".join(
                f"{n} {np.percentile(lat[sizes == n], 50):.0f} / "
                f"{np.percentile(lat[sizes == n], 99):.0f}" for n in HTTP["sizes"])
            + f" ms; the batcher in the sampler "
            f"{sum(r['sampler'] for r in mine) / sum(r['wall'] for r in mine):.3f} of the time, "
            f"{len(mine_calls)} sampler calls filled {fill:.3f} of their batches of {BATCH}")
    if len(calls) != batches or images != n_images:
        fail(f"HTTP: {len(calls)} sampler calls for {batches} batches, {images} images "
             f"(clients received {n_images})")
    # warm-up (1 + 2 + 4 forwards), then each sampler call's batches of 256
    forwards = (1 + 2 + 4) + sum(steps * -(-n // BATCH) for n, steps in calls)
    expect = all_counts(build, **{k: v * forwards for k, v in EVAL_FORWARD_LAUNCHES.items()})
    if launches != expect:
        fail(f"HTTP launches {launches}, expected {expect} ({forwards} forwards)")
    http_module_phase(torch, model)
    return launches


def http_module_phase(torch, model) -> None:
    """``python -m rectified_flow_vision_tpu_torch.serving_http`` on a saved
    checkpoint, in its own process on the card: it answers /healthz and one
    request, then stops at SIGINT."""
    import signal

    ckpt = ROOT / "build" / "http_smoke" / "flow.npz"
    model.save(str(ckpt))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "rectified_flow_vision_tpu_torch.serving_http", "--checkpoint",
         str(ckpt), "--port", "0", "--steps", "2", "--batch-size", "16", "--device", "cuda"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        lines = []
        port = None
        while port is None:
            line = proc.stdout.readline()
            if not line:
                fail("serving_http exited before serving: " + "".join(lines[-20:]))
            lines.append(line)
            m = re.search(r"serving on http://127\.0\.0\.1:(\d+)", line)
            if m:
                port = int(m.group(1))
            if time.perf_counter() - t0 > 120:
                fail("serving_http did not start within 120 s")
        url = f"http://127.0.0.1:{port}"
        _, health = _get(url + "/healthz")
        code, _, body = _post(url + "/generate", {"n": 5, "num_steps": 2})
        arr = np.load(__import__("io").BytesIO(body)) if code == 200 else None
        if arr is None or arr.shape != (5, 3, 64, 64) or not np.isfinite(arr).all():
            fail(f"serving_http answered {code} with {None if arr is None else arr.shape}")
        log(f"HTTP: python -m rectified_flow_vision_tpu_torch.serving_http served 5 images at "
            f"2 steps, {json.loads(health)['step_counts']}, "
            f"{time.perf_counter() - t0:.1f} s from start to answer")
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def lpips_weights(seed: int = 0) -> dict:
    """Seeded synthetic AlexNet-LPIPS weights (the JAX package's tests draw
    these: normal convs, small biases, uniform lin heads)."""
    from rectified_flow_vision_tpu_torch.utils.lpips import _ALEX_LAYERS

    rng = np.random.default_rng(seed)
    w, cin = {}, 3
    for i, (k, _, _, cout, _) in enumerate(_ALEX_LAYERS):
        w[f"conv{i}_w"] = rng.normal(0, 0.1, (k, k, cin, cout)).astype(np.float32)
        w[f"conv{i}_b"] = rng.normal(0, 0.01, (cout,)).astype(np.float32)
        w[f"lin{i}_w"] = rng.uniform(0, 1, (cout,)).astype(np.float32)
        cin = cout
    return w


def _close(got, want, rtol, atol):
    """Largest |got - want| as a share of atol + rtol |want| (<= 1 passes)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / (atol + rtol * np.abs(want))).max())


def metric_nets_phase(torch) -> None:
    """LPIPS and InceptionV3 with seeded synthetic weights at batch 256 of
    64x64 images on the card, with the process's TF32 switches ON (the
    networks pin exact fp32 themselves), against the port's own CPU result
    on a slice of the batch (METRIC_NETS tolerances); ms per batch. The
    control: the same networks with ``exact_fp32`` replaced by a null
    context, so that cuDNN runs them in TF32; each network must fail the
    gate there, or the gate could not see a lost pin. Then
    ``train_synthnet``'s steps on the card from its default init (drawn
    from the seed) against the CPU from the same tree: the update (weights
    minus init) within METRIC_NETS["synth_rtol"] of the CPU's, relative to
    its norm; the control, the CPU at half the lr, must fail that gate."""
    import contextlib
    from unittest import mock

    from rectified_flow_vision_tpu_torch.utils import inception as I
    from rectified_flow_vision_tpu_torch.utils import lpips as L
    from rectified_flow_vision_tpu_torch.utils import synthnet as S

    r = np.random.default_rng(SEED + 5)
    a = np.tanh(r.standard_normal((BATCH, 3, 64, 64))).astype(np.float32)
    b = np.tanh(r.standard_normal((BATCH, 3, 64, 64))).astype(np.float32)
    k = METRIC_NETS["cpu_slice"]
    lp_gpu, lp_cpu = L.LPIPS(lpips_weights(), "cuda"), L.LPIPS(lpips_weights(), "cpu")
    inc_gpu = I.InceptionV3Features(I.synthetic_weights(0), "cuda")
    inc_cpu = I.InceptionV3Features(I.synthetic_weights(0), "cpu")
    rtol, atol = METRIC_NETS["rtol"], METRIC_NETS["atol"]
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = cudnn.allow_tf32, matmul.allow_tf32

    def outputs():
        return {"lpips": lp_gpu(a, b), "lpips fid_features": lp_gpu.fid_features(a),
                "lpips pairwise": lp_gpu.pairwise_distance(a[:k], b[:k]),
                "inception": inc_gpu(a)}

    cudnn.allow_tf32 = matmul.allow_tf32 = True
    try:
        got = outputs()
        a_dev, b_dev = torch.as_tensor(a, device="cuda"), torch.as_tensor(b, device="cuda")
        ms = {"lpips": time_ms(torch, lambda: lp_gpu.distance(a_dev, b_dev), reps=3),
              "inception": time_ms(torch, lambda: inc_gpu.forward(a_dev), reps=3)}
        if (cudnn.allow_tf32, matmul.allow_tf32) != (True, True):
            fail("a metric network did not restore the process's TF32 switches")
        with mock.patch.object(L, "exact_fp32", contextlib.nullcontext), \
                mock.patch.object(I, "exact_fp32", contextlib.nullcontext):
            control = outputs()
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = prev
    want = {"lpips": lp_cpu(a[:k], b[:k]), "lpips fid_features": lp_cpu.fid_features(a[:k]),
            "lpips pairwise": lp_cpu.pairwise_distance(a[:k], b[:k]), "inception": inc_cpu(a[:k])}
    shapes = {"lpips": (BATCH,), "lpips fid_features": (BATCH, 256), "lpips pairwise": (k, k),
              "inception": (BATCH, 2048)}

    def share(out, name):
        return _close(out[name][:k] if name != "lpips pairwise" else out[name], want[name],
                      rtol, atol)

    worst, tf32 = {}, {}
    for name, g in got.items():
        if g.shape != shapes[name] or not np.isfinite(g).all():
            fail(f"{name} on the card: shape {g.shape} or non-finite")
        worst[name], tf32[name] = share(got, name), share(control, name)
    log(f"metric networks: batch {BATCH} of 64x64, synthetic weights, TF32 switched on around "
        f"them: LPIPS {ms['lpips']:.3f} ms a batch (two images a pair), InceptionV3 "
        f"(resize to 299) {ms['inception']:.3f} ms a batch; card vs CPU on {k} images, worst "
        "share of tolerance (rtol " + f"{rtol}, atol {atol}): "
        + ", ".join(f"{n} {v:.3f}" for n, v in worst.items())
        + "; the control without the TF32 pin: "
        + ", ".join(f"{n} {v:.3f}" for n, v in tf32.items()))
    if max(worst.values()) > 1.0:
        fail("a metric network on the card differs from the CPU")
    for net in ("lpips", "inception"):
        if max(v for n, v in tf32.items() if n.startswith(net)) <= 1.0:
            fail(f"the {net} gate passes the network run in TF32: it cannot see a lost pin")

    kw = dict(n_train=METRIC_NETS["synth_n"], n_val=8, size=64, batch=METRIC_NETS["synth_batch"],
              epochs=1, seed=SEED, progress=False)
    lr = 3e-4
    init = S.init_params(torch.Generator().manual_seed(SEED), device="cpu")
    t0 = time.perf_counter()
    p_gpu, m_gpu = S.train_synthnet(**kw, lr=lr, device="cuda")  # the default init of SEED
    gpu_s = time.perf_counter() - t0
    p_cpu, m_cpu = S.train_synthnet(**kw, lr=lr, params=init, device="cpu")
    p_half, _ = S.train_synthnet(**kw, lr=lr / 2, params=init, device="cpu")
    steps = (kw["n_train"] * 2 // 3 // kw["batch"]) + (kw["n_train"] // 3 // kw["batch"])

    def update(p):
        return torch.cat([(p[l][n].cpu() - init[l][n]).reshape(-1) for l in init for n in init[l]])

    step_cpu = update(p_cpu)
    rel = float((update(p_gpu) - step_cpu).norm() / step_cpu.norm())
    rel_half = float((update(p_half) - step_cpu).norm() / step_cpu.norm())
    diff = max(float((p_gpu[l][n].cpu() - p_cpu[l][n]).abs().max()) for l in init for n in init[l])
    log(f"metric networks: train_synthnet {steps} steps (batch {kw['batch']}, 64 and 32 px) on "
        f"the card from its default init in {gpu_s:.2f} s: the update within {rel:.3e} of the "
        f"CPU's, relative to its norm {float(step_cpu.norm()):.3e} (limit "
        f"{METRIC_NETS['synth_rtol']}; the control at half the lr {rel_half:.3e}); largest entry "
        f"difference {diff:.3e}; validation accuracies card {m_gpu} CPU {m_cpu}")
    if not rel <= METRIC_NETS["synth_rtol"]:
        fail("train_synthnet on the card differs from the CPU")
    if rel_half <= METRIC_NETS["synth_rtol"]:
        fail("the train_synthnet gate passes a run at half the lr")


def profiling_phase(torch, build):
    """``annotate`` spans in a ``trace()`` of one served batch (with its
    device kernels), ``device_memory_stats()`` nonzero, and ``nan_check``:
    no false alarm over a UNet sample on the card, a raise on a NaN produced
    there. Returns the phase's launch counts."""
    from rectified_flow_vision_tpu_torch.models import BaseFlowModel
    from rectified_flow_vision_tpu_torch.serving import SamplerService
    from rectified_flow_vision_tpu_torch.utils import profiling as prof

    model = BaseFlowModel(image_size=64, seed=SEED, sample_dtype="bfloat16", device="cuda")
    build.reset_launches()
    svc = SamplerService(model, step_counts=(4,), batch_size=BATCH, seed=SEED, warmup=False)
    logdir = ROOT / "build" / "annotate_trace"
    with prof.trace(str(logdir)):
        with prof.annotate("rfv_served_batch"):
            imgs = svc.generate(BATCH, num_steps=4)
    events = json.loads((logdir / "trace.json").read_text())["traceEvents"]
    spans = [e for e in events if e.get("name") == "rfv_served_batch"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not spans or not kernels or imgs.shape != (BATCH, 3, 64, 64):
        fail(f"trace: {len(spans)} annotate spans, {len(kernels)} device kernels")
    stats = prof.device_memory_stats()
    dev = stats.get("cuda:0", {})
    if not (dev.get("bytes_in_use", 0) > 0 and dev.get("peak_bytes_in_use", 0) > 0):
        fail(f"device_memory_stats() read {stats}")
    t0 = time.perf_counter()
    with prof.nan_check():
        clean = model.sample(batch_size=4, num_steps=1)
    check_s = time.perf_counter() - t0
    if not torch.isfinite(clean).all():
        fail("the sample under nan_check is not finite")
    try:
        with prof.nan_check():
            torch.log(-torch.ones(4, device="cuda"))
        fail("nan_check did not raise on a NaN produced on the card")
    except FloatingPointError as e:
        raised = str(e)
    launches = dict(build.LAUNCHES)
    log(f"profiling: the annotate span 'rfv_served_batch' in trace.json with {len(kernels)} "
        f"device kernels ({len(spans)} span); device_memory_stats {stats}; nan_check: a 1-step "
        f"sample of 4 under it in {check_s:.2f} s, no alarm; a NaN on the card raised "
        f"FloatingPointError ({raised}); launches {nonzero(launches)}")
    expect = all_counts(build, **{k: v * 5 for k, v in EVAL_FORWARD_LAUNCHES.items()})
    if launches != expect:
        fail(f"profiling launches {launches}, expected {expect} (5 forwards)")
    return launches


# ---------------------------------------------------------------------------
# 15. parallel
# ---------------------------------------------------------------------------

# Phase 15: the parallel paths. (a) in this process, a process group of one
# rank over NCCL: explicit one-device meshes through make_train_step (DP,
# FSDP2, FSDP2 x TP) at the flagship's width, batch 64, fp32 compute (in
# bf16 an FSDP2 step's gradients differ from no mesh's by bf16 roundings,
# found on the CPU, and AdamW's first step turns such a difference on an
# entry near zero into 2 lr), SamplerService(mesh=) at batch 256 in bf16,
# ring attention
# and a one-stage pipeline of DiT-S/2, each against the no-mesh path on the
# card, with img/s beside the no-mesh img/s; the tensor-parallel forms of the
# attention-block and dropout kernels against their plain versions. (b) two
# gloo ranks spawned on the one card, holding CUDA tensors: DP, TP (dropout
# 0.1: the ranks' channel-keyed masks) and FSDP train steps of the flagship
# UNet (fp32, batch 64 global), a sequence-parallel DiT-S/2 step and a
# two-stage pipeline step (depth 2), each against the single-rank result on
# the card within the CPU tests' tolerances. NCCL refuses two ranks on one
# card, so (b) runs over gloo, the train steps in one pair of processes and
# ppermute, the ring and the pipeline in another (gloo's refusal of send /
# recv of CUDA tensors aborts a rank).
PARALLEL = dict(batch=64, timing_steps=4, serve_batch=256, dit_batch=2, dit_depth=2,
                pipe_batch=4, microbatches=2, spawn_timeout=420)
# the CPU tests' tolerances (tests/test_torch_parallel_*.py): train step
# loss rel 1e-5, weights rtol 5e-3 / atol 1e-4; sequence-parallel DiT
# forward 1e-4, loss and gradients 1e-5; pipeline 2e-4
PAR_LOSS_RTOL, PAR_W_RTOL, PAR_W_ATOL = 1e-5, 5e-3, 1e-4
PAR_SEQ_FWD, PAR_SEQ_GRAD, PAR_PIPE = 1e-4, 1e-5, 2e-4
# gloo's TCP transport given a CUDA tensor's pointer (EFAULT)
GLOO_CUDA_P2P = r"gloo/transport/tcp/pair\.cc:\d+\] (?:writev|readv|read|write) \S+: Bad address"
PAR_UNET_CASES = {"dp2": dict(dp=2, tp=1, fsdp=False, dropout=0.0),
                  "tp2": dict(dp=1, tp=2, fsdp=False, dropout=0.1),
                  "fsdp2": dict(dp=2, tp=1, fsdp=True, dropout=0.0),
                  # the winograd phase's tensor-parallel step: each rank's
                  # slices of the 30 conv sites on the Winograd conv
                  "tp2_winograd": dict(dp=1, tp=2, fsdp=False, dropout=0.1, winograd=True)}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _unet_inputs():
    r = np.random.default_rng(SEED + 15)
    b = PARALLEL["batch"]
    x0 = r.standard_normal((b, 64, 64, 3)).astype(np.float32)
    return x0, make_corpus(b), r.random(b).astype(np.float32)


def _dit_cfg():
    return dict(DIT, depth=PARALLEL["dit_depth"], dit_size=None, hidden_size=384, num_heads=6,
                remat=False, sample_dtype="float32")


def _dit_inputs(b):
    r = np.random.default_rng(SEED + 16)
    return tuple(r.standard_normal((b, 64, 64, 4)).astype(np.float32) for _ in range(2)) + (
        r.random(b).astype(np.float32),)


def _unet_step(torch, case, mesh, x0, x1, t):
    """One coupled fp32 train step of the flagship UNet (seeded weights) on
    this rank's rows; the global loss and the whole weights as numpy."""
    from rectified_flow_vision_tpu_torch.models import BaseFlowModel
    from rectified_flow_vision_tpu_torch.models import base_flow as BF
    from rectified_flow_vision_tpu_torch.parallel import mesh as M

    model = BaseFlowModel(image_size=64, seed=SEED, dropout=case["dropout"], device="cuda")
    if mesh is not None:
        M.place_params(mesh, model, fsdp=case["fsdp"])
    opt = BF.make_optimizer(model, TRAIN["lr"], 1, 1, mesh=mesh)
    step = BF.make_train_step(model, opt, coupled=True, mesh=mesh)
    rows = [M.shard_batch(mesh, torch.as_tensor(a, device="cuda")) for a in (x0, x1)]
    with mock.patch.object(BF, "sample_times", lambda *a, **k: torch.as_tensor(t, device="cuda")), \
            winograd_gate(case.get("winograd", False)):
        loss = float(step(tuple(rows), torch.Generator(device="cuda").manual_seed(SEED)))
    return loss, {k: v.detach().cpu().numpy() for k, v in
                  (M.full_state_dict(model) if mesh is not None else model.state_dict()).items()}


def _dit_model(torch):
    """DiT-S/2 at phase 15's depth, seeded weights, all moved off adaLN-Zero's
    zeros, fp32."""
    from rectified_flow_vision_tpu_torch.models import BaseFlowModel

    model = BaseFlowModel(seed=SEED, device="cuda", **_dit_cfg())
    randomize_zero_leaves(torch, model, SEED + 17)
    return model


def _dit_seq(torch, mesh, x1, x0, t, model=None):
    """The DiT's (``_dit_model``) velocity, flow loss and every gradient,
    with the tokens split over ``mesh``'s seq dim when given."""
    model = model or _dit_model(torch)
    net = model.velocity_net
    x1, x0, t = (torch.as_tensor(a, device="cuda") for a in (x1, x0, t))
    x_t, target = model.get_interpolation(x0, x1, t)
    kw = dict(mesh=mesh, seq_axis="seq") if mesh is not None else {}
    pred = net(x_t, t, masters=True, **kw)
    loss = torch.mean(torch.square(pred - target))
    named = dict(net.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    return (pred.detach().cpu().numpy(), float(loss.detach()),
            {k: g.cpu().numpy() for k, g in zip(named, grads)})


def _dit_pipe(torch, mesh, x, tx, x1, x0, t):
    """DiT-S/2 (depth 2) through ``pipeline_apply`` on ``mesh``'s stage dim:
    the forward, then the pipeline loss's gradients (this stage's blocks, as
    block-index names, and the rest)."""
    from rectified_flow_vision_tpu_torch.parallel import pipeline as PP

    net = _dit_model(torch).velocity_net
    x, tx, x1, x0, t = (torch.as_tensor(a, device="cuda") for a in (x, tx, x1, x0, t))
    with torch.no_grad():
        fwd = net.pipeline_apply(x, tx, mesh, num_microbatches=PARALLEL["microbatches"])
    _, loss_fn = PP.make_pipeline_train_step(net, lambda ps: torch.optim.SGD(ps, lr=0.0), mesh,
                                             num_microbatches=PARALLEL["microbatches"])
    rest, blocks = PP.split_pipeline_params(net, mesh)
    loss = loss_fn(rest, blocks, x1, x0, t)
    leaves = {**rest, **{f"stage.{k}": v for k, v in blocks.items()}}
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    stage = mesh.get_local_rank("stage")
    out = {k: g.cpu().numpy() for k, g in grads.items() if not k.startswith("stage.")}
    for k, g in grads.items():
        if k.startswith("stage."):
            per = g.shape[1]
            for j in range(per):
                out[f"blocks.{stage * per + j}.{k[6:]}"] = g[0, j].cpu().numpy()
    return fwd.cpu().numpy(), float(loss.detach()), out


def _parallel_rank(part, rank, world, store, out_dir, inputs):
    """One of phase 15's two gloo ranks on the card, for ``part``: "steps"
    (the UNet's DP, TP and FSDP train steps) or "p2p" (``ppermute`` of CPU,
    then of CUDA tensors; ring attention and the pipeline where both ranks
    got the right values). Each check's result or exception, and its kernel
    launches, go to ``{part}_rank{R}.pkl`` as each check ends, and the
    rank's standard error to ``{part}_rank{R}.err`` (an error in gloo's
    transport thread aborts the process); the parent judges them."""
    import faulthandler
    import os
    import pickle
    import traceback

    err = open(Path(out_dir) / f"{part}_rank{rank}.err", "w")
    os.dup2(err.fileno(), 2)  # native aborts too
    faulthandler.enable()  # a crash in native code prints where it was
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    sys.path.insert(0, str(ROOT))
    from rectified_flow_vision_tpu_torch.ops import build
    from rectified_flow_vision_tpu_torch.ops import winograd
    from rectified_flow_vision_tpu_torch.parallel import collectives
    from rectified_flow_vision_tpu_torch.parallel import mesh as M

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    build.library()  # the parent built it: loaded, not rebuilt
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    results = {}

    def run(fn):
        try:
            return dict(ok=True, value=fn())
        except Exception as exc:
            return dict(ok=False, reason=f"{type(exc).__name__}: {exc}".splitlines()[0],
                        trace=traceback.format_exc())

    def save():
        with open(Path(out_dir) / f"{part}_rank{rank}.pkl", "wb") as f:
            pickle.dump(results, f)

    def attempt(name, fn):
        print(f"parallel (b): rank {rank}: {name}", flush=True)
        build.reset_launches()
        winograd.reset_calls()
        results[name] = run(lambda: (fn(), torch.cuda.synchronize())[0])
        results[name]["launches"] = dict(build.LAUNCHES)
        results[name]["winograd"] = winograd.CALLS["winograd"]
        save()
        dist.barrier()

    if part == "steps":
        x0, x1, t = inputs["unet"]
        for name, case in PAR_UNET_CASES.items():
            attempt(name, lambda case=case: _unet_step(
                torch, case, M.create_mesh(case["dp"], case["tp"], device="cuda"), x0, x1, t))
    else:
        right = [float((rank - 1) % world)] * 4
        for dev in ("cpu", "cuda"):
            results[f"ppermute_{dev}"] = run(lambda: collectives.ppermute(
                torch.full((4,), float(rank), device=dev), dist.group.WORLD).cpu().tolist())
            save()
        ok = torch.tensor([int(all(results[f"ppermute_{d}"].get("value") == right
                                   for d in ("cpu", "cuda")))])
        dist.all_reduce(ok, op=dist.ReduceOp.MIN)
        if int(ok):
            seq = DeviceMesh("cuda", torch.arange(world).reshape(1, world),
                             mesh_dim_names=("data", "seq"))
            attempt("dit_seq", lambda: _dit_seq(torch, seq, *inputs["dit_seq"]))
            stage = DeviceMesh("cuda", torch.arange(world), mesh_dim_names=("stage",))
            attempt("dit_pipe", lambda: _dit_pipe(torch, stage, *inputs["dit_pipe"]))
    dist.destroy_process_group()


def _spawn_pair(part, out, inputs, timeout):
    """Run ``_parallel_rank(part, ...)`` in two spawned processes: their exit
    codes, results and standard errors."""
    import multiprocessing as mp
    import pickle

    ctx = mp.get_context("spawn")
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_parallel_rank,
                         args=(part, r, 2, str(out / f"{part}_store"), str(out), inputs))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(max(1.0, timeout - (time.perf_counter() - t0)))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    results, errs = [], []
    for r in range(2):
        f = out / f"{part}_rank{r}.pkl"
        results.append(pickle.loads(f.read_bytes()) if f.exists() else {})
        e = out / f"{part}_rank{r}.err"
        errs.append(e.read_text(errors="replace") if e.exists() else "")
    log(f"parallel (b): two gloo ranks on the card ({part}) ran in "
        f"{time.perf_counter() - t0:.1f} s (process start and kernel load included)")
    return [p.exitcode for p in procs], results, errs


def _max_diff(got: dict, want: dict) -> float:
    if set(got) != set(want):
        fail(f"parallel: parameter names differ: {sorted(set(got) ^ set(want))[:4]}")
    return max(float(np.abs(got[k] - want[k]).max()) for k in want)


def _within(got: dict, want: dict, rtol: float, atol: float) -> bool:
    return all(np.all(np.abs(got[k] - want[k]) <= atol + rtol * np.abs(want[k])) for k in want)


def parallel_tp_kernels(torch) -> None:
    """The tensor-parallel forms of two kernels against their plain versions:
    the attention block on one of two ranks' heads without the residual
    (the flagship mid block, batch 256), and the dropout kernels on one of two
    ranks' channels of the level-2 norm2 (mask bits of its place in the whole
    activation: the zeros exactly the plain version's)."""
    from rectified_flow_vision_tpu_torch.ops import attention as A
    from rectified_flow_vision_tpu_torch.ops import gn_silu as G
    from rectified_flow_vision_tpu_torch.ops import gn_silu_dropout as D

    g = torch.Generator(device="cuda").manual_seed(SEED + 18)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale

    c, ci = 256, 128
    for dname, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        x = randn(BATCH, 16, 16, c).to(dt)
        args = (1 + 0.1 * randn(c), 0.1 * randn(c), (0.05 * randn(3 * ci, c)).to(dt),
                0.1 * randn(3 * ci), (0.05 * randn(c, ci)).to(dt), torch.zeros(c, device="cuda"))
        got = A.attention_block_cuda(x, *args, num_heads=2, residual=False)
        want = A.attention_block_plain(x, *args, num_heads=2, residual=False)
        rtol, atol = TOLERANCES[("attention_block", dname)]
        err = float((got.float() - want.float()).abs().max())
        log(f"parallel: attention_block, 2 heads of 64 (one of 2 ranks), no residual, {dname}: "
            f"max |kernel - plain| {err:.3e}")
        if not torch.all((got.float() - want.float()).abs() <= atol + rtol * want.float().abs()):
            fail(f"parallel: tensor-parallel attention_block {dname} disagrees ({err:.3e})")
        xs = randn(BATCH, 16, 16, ci, scale=2.0).to(dt)
        s, b = 1 + 0.1 * randn(ci), 0.1 * randn(ci)
        for r in range(2):
            chans = (r * ci, 2 * ci)
            out, stats = D.gn_silu_dropout_cuda(xs, s, b, 1234, DROP_RATE, num_groups=4,
                                                channels=chans)
            plain = D.gn_silu_dropout_plain(xs, s, b, 1234, DROP_RATE, num_groups=4,
                                            channels=chans)
            keep = D.keep_mask(xs.shape, 1234, DROP_RATE, xs.device, chans)
            whole = D.keep_mask((BATCH, 16, 16, 2 * ci), 1234, DROP_RATE, xs.device)
            if not torch.equal(keep, whole[..., r * ci:(r + 1) * ci]):
                fail("parallel: a channel slice's mask is not the whole activation's")
            if not torch.equal(out == 0, ~keep | (plain == 0)):
                fail(f"parallel: gn_silu_dropout rank {r} {dname}: the kernel's zeros are not "
                     "the mask's")
            rtol, atol = TOLERANCES[("gn_silu_dropout", dname)]
            if not torch.all((out.float() - plain.float()).abs()
                             <= atol + rtol * plain.float().abs()):
                fail(f"parallel: gn_silu_dropout rank {r} {dname} disagrees with plain")
            cot = (out + randn(*out.shape, scale=0.1)).to(dt)
            got_b = D.gn_silu_dropout_backward_cuda(xs, cot, s, b, stats, 1234, DROP_RATE,
                                                    num_groups=4, channels=chans)
            want_b = D.gn_silu_dropout_backward_plain(xs, cot, s, b, G.gn_stats_plain(
                xs, num_groups=4), 1234, DROP_RATE, num_groups=4, channels=chans)
            tol = TOLERANCES[("gn_silu_backward", dname)][1]
            for a, w in zip(got_b, want_b):
                if float((a.float() - w.float()).abs().max()) > tol * float(w.float().abs().max()):
                    fail(f"parallel: gn_silu_backward with a channel slice, rank {r} {dname}")
        log(f"parallel: gn_silu_dropout / gn_silu_backward on both ranks' channel slices "
            f"(128 of 256), {dname}: masks bit for bit the whole activation's, values within "
            "the kernel-phase tolerances")


def parallel_one_rank(torch, build) -> Counter:
    """(a): a process group of one rank over NCCL, explicit one-device
    meshes, against no mesh on the card. Returns the mesh paths' launches
    (each path's counted from 0)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from rectified_flow_vision_tpu_torch.models import BaseFlowModel
    from rectified_flow_vision_tpu_torch.models import base_flow as BF
    from rectified_flow_vision_tpu_torch.ops import fused
    from rectified_flow_vision_tpu_torch.parallel import mesh as M
    from rectified_flow_vision_tpu_torch.parallel.ring_attention import ring_attention_sharded
    from rectified_flow_vision_tpu_torch.serving import SamplerService

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                            world_size=1)
    total = Counter()
    try:
        mesh = M.create_mesh(device="cuda")
        if dist.get_backend() != "nccl":
            fail("parallel: the one-rank group is not NCCL")
        data = torch.as_tensor(make_corpus(PARALLEL["batch"]), device="cuda")
        runs = {}
        for kind in ("none", "dp", "fsdp", "fsdp_tp"):
            model = BaseFlowModel(image_size=64, seed=SEED, device="cuda")
            m = None if kind == "none" else mesh
            if m is not None:
                M.place_params(m, model, fsdp=kind != "dp")
            opt = BF.make_optimizer(model, TRAIN["lr"], 1000, 1, mesh=m)
            step = BF.make_train_step(model, opt, coupled=False, mesh=m)
            gen = torch.Generator(device="cuda").manual_seed(SEED)
            build.reset_launches()  # this path's launches: one step
            loss = float(step(data, gen))
            launches = dict(build.LAUNCHES)
            if launches != all_counts(build, **fp32_unet(TRAIN_STEP_LAUNCHES)):
                fail(f"parallel: one {kind} step launched {launches}")
            if m is not None:
                total.update(launches)
            weights = {k: v.detach().float().cpu().numpy() for k, v in (
                M.full_state_dict(model) if m is not None else model.state_dict()).items()}
            rates = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(PARALLEL["timing_steps"]):
                    step(data, gen)
                torch.cuda.synchronize()
                rates.append(PARALLEL["batch"] * PARALLEL["timing_steps"]
                             / (time.perf_counter() - t0))
            runs[kind] = (loss, weights, float(np.median(rates)))
            del model, opt, step
            torch.cuda.empty_cache()
        loss0, w0, r0 = runs["none"]
        for kind in ("dp", "fsdp", "fsdp_tp"):
            loss, w, r = runs[kind]
            diff = _max_diff(w, w0)
            log(f"parallel (a): make_train_step with a one-rank {kind} mesh (NCCL), batch "
                f"{PARALLEL['batch']}, fp32: loss {loss!r} vs no mesh {loss0!r}; weights after "
                f"one step max |diff| {diff:.3e}; img/s {r:.2f} vs no mesh {r0:.2f} "
                f"(overhead {100 * (r0 / r - 1):.1f}%)")
            if abs(loss - loss0) > PAR_LOSS_RTOL * abs(loss0) or not _within(
                    w, w0, PAR_W_RTOL, PAR_W_ATOL):
                fail(f"parallel: the one-rank {kind} step disagrees with no mesh")

        imgs, rates = {}, {}
        for kind in ("none", "mesh"):
            model = BaseFlowModel(image_size=64, seed=SEED, device="cuda")
            svc = SamplerService(model, step_counts=(4,), batch_size=PARALLEL["serve_batch"],
                                 seed=SEED, mesh=None if kind == "none" else mesh)
            build.reset_launches()
            imgs[kind] = svc.generate(PARALLEL["serve_batch"], num_steps=4)
            launches = dict(build.LAUNCHES)
            if launches != all_counts(build, **{k: 4 * v for k, v in
                                                EVAL_FORWARD_LAUNCHES.items()}):
                fail(f"parallel: the {kind} service's batch launched {launches}")
            if kind == "mesh":
                total.update(launches)
            rates[kind] = float(np.median([svc.throughput(4) for _ in range(3)]))
            del svc, model
        if not np.array_equal(imgs["mesh"], imgs["none"]):
            fail("parallel: SamplerService(mesh=) on one rank differs from no mesh")
        log(f"parallel (a): SamplerService(mesh=) one rank, batch {PARALLEL['serve_batch']}, 4 "
            f"steps: images equal to no mesh's; throughput(4) {rates['mesh']:.2f} vs no mesh "
            f"{rates['none']:.2f} img/s (overhead {100 * (rates['none'] / rates['mesh'] - 1):.1f}%)")

        seq = DeviceMesh("cuda", torch.arange(1), mesh_dim_names=("seq",))
        g = torch.Generator(device="cuda").manual_seed(SEED + 19)
        q, k, v = (torch.randn(FLASH_BWD_SHAPE, generator=g, device="cuda") for _ in range(3))
        ring = ring_attention_sharded(q, k, v, seq)
        flash = fused.flash_attention(q, k, v)
        err = float((ring - flash).abs().max())
        ring_ms = time_ms(torch, lambda: ring_attention_sharded(q, k, v, seq), reps=3)
        flash_ms = time_ms(torch, lambda: fused.flash_attention(q, k, v), reps=3)
        log(f"parallel (a): ring_attention_sharded on one rank at {FLASH_BWD_SHAPE} fp32 against "
            f"the flash kernel: max |diff| {err:.3e}; {ring_ms:.2f} ms vs flash {flash_ms:.2f} ms "
            "(the ring's block product is a plain matmul, as in the JAX package)")
        if err > 1e-4:
            fail(f"parallel: one-rank ring attention disagrees with flash ({err:.3e})")

        stage = DeviceMesh("cuda", torch.arange(1), mesh_dim_names=("stage",))
        dit = BaseFlowModel(seed=SEED, device="cuda", **{**DIT, "remat": False,
                                                         "sample_dtype": "float32"})
        randomize_zero_leaves(torch, dit, SEED + 17)
        x = torch.randn((PARALLEL["pipe_batch"], 64, 64, 4), generator=g, device="cuda")
        tt = torch.linspace(0.1, 0.9, PARALLEL["pipe_batch"], device="cuda")
        with torch.no_grad():
            want = dit.velocity_net(x, tt)
            build.reset_launches()
            got = dit.velocity_net.pipeline_apply(x, tt, stage,
                                                  num_microbatches=PARALLEL["microbatches"])
        launches = dict(build.LAUNCHES)
        total.update(launches)
        err = float((got - want).abs().max())
        with torch.no_grad():
            pipe_ms = time_ms(torch, lambda: dit.velocity_net.pipeline_apply(
                x, tt, stage, num_microbatches=PARALLEL["microbatches"]), reps=3)
            plain_ms = time_ms(torch, lambda: dit.velocity_net(x, tt), reps=3)
        b = PARALLEL["pipe_batch"]
        log(f"parallel (a): one-stage pipeline_apply of DiT-S/2 (depth {DIT_DEPTH}, batch {b}, "
            f"{PARALLEL['microbatches']} microbatches, fp32) against the plain forward: max "
            f"|diff| {err:.3e}; img/s {1e3 * b / pipe_ms:.2f} vs plain {1e3 * b / plain_ms:.2f}; "
            f"launches {nonzero(launches)}")
        if err > PAR_PIPE or launches.get("flash_attention", 0) != (
                DIT_DEPTH * PARALLEL["microbatches"]):
            fail(f"parallel: one-stage pipeline ({err:.3e}, launches {launches})")
        del dit
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return total


def parallel_two_ranks(torch, build) -> Counter:
    """(b): two gloo ranks spawned on the one card, against the single-rank
    result on the card. Returns rank 0's launches in the checks that ran."""
    import shutil

    x0, x1, t = _unet_inputs()
    dit_seq = _dit_inputs(PARALLEL["dit_batch"])
    r = np.random.default_rng(SEED + 20)
    x = r.standard_normal((PARALLEL["pipe_batch"], 64, 64, 4)).astype(np.float32)
    tx = np.linspace(0.1, 0.9, PARALLEL["pipe_batch"]).astype(np.float32)
    dit_pipe = (x, tx, *_dit_inputs(PARALLEL["pipe_batch"]))
    inputs = dict(unet=(x0, x1, t), dit_seq=dit_seq, dit_pipe=dit_pipe)
    out = ROOT / "build" / "parallel_smoke"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)

    codes, ranks, errs = _spawn_pair("steps", out, inputs, PARALLEL["spawn_timeout"])
    if codes != [0, 0]:
        for e in errs:
            print(e[-3000:], file=sys.stderr)
        fail(f"parallel (b): the two ranks of the train steps exited with {codes}")
    results = ranks[0]

    def check_ran(name):  # any exception on either rank fails the phase
        for r_, res in enumerate(ranks):
            if not res[name]["ok"]:
                print(res[name]["trace"], file=sys.stderr)
                fail(f"parallel (b): {name} raised on rank {r_}: {res[name]['reason']}")

    def check_launches(name, **expected):
        want = all_counts(build, **expected)
        for r_, res in enumerate(ranks):
            if res[name]["launches"] != want:
                fail(f"parallel (b): {name} on rank {r_} launched {res[name]['launches']}, "
                     f"not {nonzero(want)}")

    ran, total = [], Counter()

    def passed(name):
        ran.append(name)
        total.update(results[name]["launches"])

    for name, case in PAR_UNET_CASES.items():
        check_ran(name)
        loss, weights = results[name]["value"]
        loss1, w1 = _unet_step(torch, case, None, x0, x1, t)
        diff = _max_diff(weights, w1)
        log(f"parallel (b): {name} train step (flagship UNet, fp32, batch "
            f"{PARALLEL['batch']} global, dropout {case['dropout']}): loss {loss!r} vs one rank "
            f"{loss1!r}; weights max |diff| {diff:.3e}; launches on each rank "
            f"{nonzero(results[name]['launches'])}, Winograd calls {results[name]['winograd']}")
        if abs(loss - loss1) > PAR_LOSS_RTOL * abs(loss1) or not _within(
                weights, w1, PAR_W_RTOL, PAR_W_ATOL):
            fail(f"parallel (b): {name} disagrees with one rank")
        # every site on its kernel, the tensor-parallel ranks' channel slices
        # too; under the Winograd gate every conv site on the Winograd conv
        launches = fp32_unet(TRAIN_STEP_LAUNCHES if case["dropout"] else
                             dict(EVAL_FORWARD_LAUNCHES, gn_silu_backward=29))
        sites = EVAL_FORWARD_LAUNCHES["conv3x3"] if case.get("winograd") else 0
        check_launches(name, **(dict(launches, conv3x3=0) if sites else launches))
        wcalls = [res[name]["winograd"] for res in ranks]
        if wcalls != [sites, sites]:
            fail(f"parallel (b): {name}: Winograd calls on the ranks {wcalls}, not {sites}")
        passed(name)

    # ppermute: right on CPU tensors on both ranks, and on CUDA tensors right
    # or refused by gloo's TCP transport, which hands the tensor's device
    # pointer to writev / readv (EFAULT, the rank aborted); anything else fails
    codes, ranks, errs = _spawn_pair("p2p", out, inputs, PARALLEL["spawn_timeout"])
    results = ranks[0]
    outcome = []
    for r_, res in enumerate(ranks):
        want = [float((r_ - 1) % 2)] * 4
        cpu, cuda = res.get("ppermute_cpu"), res.get("ppermute_cuda")
        if cpu is None or not cpu["ok"] or cpu["value"] != want:
            print(errs[r_][-3000:], file=sys.stderr)
            fail(f"parallel (b): ppermute of CPU tensors on rank {r_}: {cpu}")
        if cuda is not None and cuda["ok"] and cuda["value"] != want:
            fail(f"parallel (b): ppermute of CUDA tensors on rank {r_} gave {cuda['value']}")
        found = re.search(GLOO_CUDA_P2P, errs[r_] + (cuda or {}).get("reason", ""))
        outcome.append("right" if cuda is not None and cuda["ok"] else
                       found.group(0) if found else (cuda or {}).get("reason", "no result"))
        log(f"parallel (b): ppermute of a CUDA tensor over gloo, rank {r_} (exit {codes[r_]}): "
            f"{outcome[-1]}")
    not_run = []
    if outcome != ["right", "right"]:
        if not any(re.search(GLOO_CUDA_P2P, o) for o in outcome):
            for e in errs:
                print(e[-3000:], file=sys.stderr)
            fail(f"parallel (b): ppermute of CUDA tensors failed, and not by gloo's refusal: "
                 f"{outcome}")
        not_run = [f"{name} (gloo's send / recv of CUDA tensors: {outcome})"
                   for name in ("dit_seq", "dit_pipe")]
    else:
        if codes != [0, 0]:
            fail(f"parallel (b): the two ranks of ring attention and the pipeline exited with "
                 f"{codes}")
        check_ran("dit_seq")
        pred, loss, grads = results["dit_seq"]["value"]
        pred1, loss1, grads1 = _dit_seq(torch, None, *dit_seq)
        fwd, gdiff = float(np.abs(pred - pred1).max()), _max_diff(grads, grads1)
        log(f"parallel (b): sequence-parallel DiT-S/2 (depth {PARALLEL['dit_depth']}, batch "
            f"{PARALLEL['dit_batch']}, 1024 tokens, 512 a rank, fp32) against one rank (flash): "
            f"forward max |diff| {fwd:.3e}, loss {loss!r} vs {loss1!r}, gradients max |diff| "
            f"{gdiff:.3e}")
        if fwd > PAR_SEQ_FWD or abs(loss - loss1) > PAR_SEQ_GRAD or gdiff > PAR_SEQ_GRAD:
            fail("parallel (b): the sequence-parallel DiT disagrees with one rank")
        # the ring's block product is plain, as in JAX; the glue kernels on
        # each rank's 512 tokens, once in its one forward (no remat)
        check_launches("dit_seq", **dit_glue(PARALLEL["dit_depth"], 1))
        passed("dit_seq")
        check_ran("dit_pipe")
        fwd, loss, grads = results["dit_pipe"]["value"]
        one = _dit_pipe_reference(torch, *dit_pipe)
        fdiff = float(np.abs(fwd - one[0]).max())
        mine = {k: v for k, v in one[2].items() if k in grads}
        gdiff = _max_diff(grads, mine)
        log(f"parallel (b): two-stage pipeline of DiT-S/2 (depth {PARALLEL['dit_depth']}, batch "
            f"{PARALLEL['pipe_batch']}, {PARALLEL['microbatches']} microbatches, fp32) against "
            f"one rank: forward max |diff| {fdiff:.3e}, loss {loss!r} vs {one[1]!r}, rank 0's "
            f"gradients max |diff| {gdiff:.3e}; launches on rank 0 "
            f"{nonzero(results['dit_pipe']['launches'])}")
        if fdiff > PAR_PIPE or abs(loss - one[1]) > PAR_PIPE or gdiff > PAR_PIPE:
            fail("parallel (b): the pipeline disagrees with one rank")
        # each stage's blocks at every one of the M + S - 1 ticks: the
        # forward, then the loss's forward and backward; the head on every
        # stage, once in each
        calls = PARALLEL["dit_depth"] // 2 * (PARALLEL["microbatches"] + 1)
        check_launches("dit_pipe", flash_attention=2 * calls, flash_attention_backward=calls,
                       **dit_glue(2 * calls, 2))
        passed("dit_pipe")
    log(f"parallel (b): ran at two ranks on the card: {ran}; not run at two ranks on the card "
        f"(their multi-rank arithmetic rests on the CPU tests): {not_run or 'none'}")
    return total


def _dit_pipe_reference(torch, x, tx, x1, x0, t):
    """The pipeline's forward and loss gradients without stages: the plain
    DiT on the card."""
    model = _dit_model(torch)
    with torch.no_grad():
        fwd = model.velocity_net(*(torch.as_tensor(a, device="cuda") for a in (x, tx)))
    return (fwd.cpu().numpy(), *_dit_seq(torch, None, x1, x0, t, model=model)[1:])


def parallel_phase(torch, build) -> dict:
    """Phase 15: (a) one rank over NCCL, (b) two gloo ranks on the card.
    Returns the launches of the mesh paths (a) and of rank 0 in (b)."""
    parallel_tp_kernels(torch)
    total = parallel_one_rank(torch, build)
    total.update(parallel_two_ranks(torch, build))
    log(f"parallel: launches of the mesh paths {nonzero(total)}")
    return dict(total)


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script runs on a CUDA card")
    if not (PACKAGE / "ops" / "csrc").is_dir():
        fail(f"{PACKAGE} not found: run chip_smoke.py from the root of a checkout")
    sys.path.insert(0, str(ROOT))
    from rectified_flow_vision_tpu_torch.models import BaseFlowModel
    from rectified_flow_vision_tpu_torch.models.unet import UNet
    from rectified_flow_vision_tpu_torch.ops import build
    from rectified_flow_vision_tpu_torch.ops import fused as fused_mod

    log(f"card: {card_line()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s")

    def phase(name):  # seconds since the build began, at the start of each phase
        log(f"[{time.perf_counter() - t0:.0f} s] {name}")

    shape_calls = record_main_path_shapes(torch, UNet, fused_mod)
    per_forward = {k: sum(v.values()) for k, v in shape_calls.items()}
    train_calls = record_main_path_shapes(torch, UNet, fused_mod, train=True)
    per_train = {k: sum(v.values()) for k, v in train_calls.items()}
    # one backward kernel per GroupNorm site; the mask is applied inside it
    per_train["gn_silu_backward"] = per_train["gn_silu"] + per_train["gn_silu_dropout"]
    per_train["dropout_mask_apply"] = 0
    if {**per_forward, "gn_silu_backward": 0, "dropout_mask_apply": 0} != EVAL_FORWARD_LAUNCHES:
        fail(f"flagship eval forward calls {per_forward}, expected {EVAL_FORWARD_LAUNCHES}")
    if per_train != TRAIN_STEP_LAUNCHES:
        fail(f"flagship train step calls {per_train}, expected {TRAIN_STEP_LAUNCHES}")
    for calls in (shape_calls, train_calls):
        streamed = {hwc: n for hwc, n in calls["gn_silu"].items() if gn_streamed(*hwc, es=4)}
        if sum(streamed.values()) != UNET_F32_STREAMED or any(
                gn_streamed(*hwc, es=2) for hwc in calls["gn_silu"]):
            fail(f"flagship gn_silu slabs on the streamed plan: fp32 {streamed}, expected "
                 f"{UNET_F32_STREAMED} call and none in bf16")
    phase("kernels")
    rows = kernel_phase(torch, shape_calls, train_calls)
    phase("flash breakdown, float64 gate")
    flash_breakdown(torch)
    flash_f64_gate(torch)
    phase("UNet model, serve, trace, gradient")
    model_phase(torch, UNet)
    serve_launches, svc, serve_img_s = serve_phase(torch, build)
    trace_phase(torch, svc)
    del svc
    torch.cuda.empty_cache()
    gradient_phase(torch, build)
    phase("winograd")
    winograd_phase(torch, build, shape_calls)
    phase("UNet train")
    train_launches, trained, data = train_phase(torch, build)
    train_timing_phase(torch, build, trained, data)
    del trained, data
    torch.cuda.empty_cache()
    phase("UNet resume, HTTP, metric networks, profiling")
    resume_launches = resume_phase(torch, build)
    torch.cuda.empty_cache()
    http_launches = http_phase(torch, build)
    metric_nets_phase(torch)
    profiling_launches = profiling_phase(torch, build)
    torch.cuda.empty_cache()
    phase("dropout, DiT models")
    dropout_launches = dropout_phase(torch, build)
    dit_model_phase(torch, build)
    dit_xl_phase(torch, build)
    f32_wide = ("f32_wide", ("flash_attention_f32_wide", "flash_attention_f32_wide_backward"))
    dit_wide_launches = dit_wide_phase(torch, build, DIT_WIDE, DIT_WIDE_SHAPE, {
        "bfloat16": ("wide", ("flash_attention_wide", "flash_attention_wide_backward")),
        "float32": f32_wide})
    dit_384_launches = dit_wide_phase(torch, build, DIT_WIDE_384, DIT_WIDE_384_SHAPE, {
        "bfloat16": ("streamed", ("flash_attention_streamed", "flash_attention_streamed_backward")),
        "float32": f32_wide})
    phase("latent serve")
    latent_serve_launches = latent_serve_phase(torch, build)
    torch.cuda.empty_cache()
    phase("latent train")
    latent_train_launches, dit_trained, latents = latent_train_phase(torch, build)
    dit_train_timing_phase(torch, build, dit_trained, latents)
    del dit_trained
    torch.cuda.empty_cache()
    phase("fp32 DiT train timing")
    dit_f32 = BaseFlowModel(seed=SEED, compute_dtype="float32", device="cuda", **DIT)
    if kernel_route(torch, "float32", DIT_HEAD_DIM) != "f32":
        fail("fp32 DiT-S/2 does not take the fp32 flash kernels up to 128")
    step_f32 = dit_train_timing_phase(torch, build, dit_f32, latents, "float32")
    dit_f32_launches = {"flash_attention_f32": step_f32["flash_attention"],
                        "flash_attention_f32_backward": step_f32["flash_attention_backward"]}
    del dit_f32, latents
    torch.cuda.empty_cache()
    phase("FLUX")
    flux_launches = flux_phase(torch, build)
    phase("CLI")
    cli_launches = cli_phase(torch, build, serve_img_s)
    phase("parallel")
    parallel_launches = parallel_phase(torch, build)
    torch.cuda.empty_cache()

    phase("done")
    csrc = "rectified_flow_vision_tpu_torch/ops/csrc/"
    pallas = "rectified_flow_vision_tpu/ops/pallas_kernels.py"
    unet_forward = "one UNet eval forward at batch 256: sum over its calls"
    unet_step = "one UNet train step at batch 256: sum over its calls"
    dit_attention = "rectified_flow_vision_tpu/models/dit.py:127"
    # no TPU kernel: XLA fuses the JAX block's glue into the ops around it
    glue_replaces = "none (XLA fusion); rectified_flow_vision_tpu/models/dit.py"
    dit_serve = f"one DiT-S/2 forward at batch {GLUE_ROWS[0]}, {DIT_TOKENS} tokens"
    flux_forward = (f"one FLUX.1 [schnell] forward at 1024 px, batch 1 ({FLUX['depth']} double "
                    f"+ {FLUX['depth_single_blocks']} single blocks, {FLUX_TXT} + {FLUX_IMG} "
                    "tokens, 24 heads of 128)")

    def on_dit_path(r):  # the kernel phase's glue rows at DiT-S/2's sites
        return r["calls"] > 0
    def model_run(dname, heads, hd):
        return (f"one {dname} forward, then loss and gradients, of the DiT with {heads} heads of "
                f"{hd} (depth {DIT_WIDE['depth']}, batch {DIT_WIDE_SHAPE[0]}, {DIT_TOKENS} tokens)")

    def route_is(*routes):  # the kernel phase's rows on these flash routes
        return lambda r: kernel_route(torch, r["dtype"], r["shape"][3]) in routes

    # name -> (source, TPU kernel it replaces, what `ms` sums, calls in that unit,
    #          filter on the kernel phase's rows[, dtype]); ms and bounds sum
    #          the kept rows of that dtype (bf16 unless named), each times its
    #          calls on the main path
    sources = {
        "gn_silu": (csrc + "gn_silu.cu", pallas + ":100", unet_forward, per_forward["gn_silu"],
                    None),
        "gn_silu_streamed": (
            csrc + "gn_silu.cu", pallas + ":100",
            f"one ConvVAE decode at batch {DECODE_GN['dit'][0]} (the DiT serve cell's): its "
            f"{len(DECODE_GN['dit'][1])} calls", len(DECODE_GN["dit"][1]),
            lambda r: r["shape"][0] == DECODE_GN["dit"][0]),
        "conv3x3": (csrc + "conv3x3.cu", "rectified_flow_vision_tpu/ops/conv_pallas.py:378",
                    unet_forward, per_forward["conv3x3"], None),
        "attention_block": (csrc + "attention.cu", pallas + ":191", unet_forward,
                            per_forward["attention_block"], None),
        "gn_silu_dropout": (csrc + "gn_silu_dropout.cu", pallas + ":358", unet_step,
                            per_train["gn_silu_dropout"], None),
        "gn_silu_backward": (csrc + "gn_silu.cu",
                             "rectified_flow_vision_tpu/ops/fused.py:84 (_gn_silu_bwd; "
                             ":267 _gsd_bwd), the VJP of " + pallas + ":100 and :358",
                             unet_step, per_train["gn_silu_backward"], None),
        "dropout_mask_apply": (
            csrc + "gn_silu_dropout.cu", pallas + ":387",
            "one call at each of a UNet train step's 14 dropout sites at batch 256 (no longer on "
            "the step: gn_silu_backward applies the mask); its launches are those of "
            "dropout_mask_apply driven directly", sum(train_calls["gn_silu_dropout"].values()),
            None),
        "flash_attention": (
            csrc + "flash_attention.cu", dit_attention,
            "one DiT-S/2 forward at batch 256, 1024 tokens: its 12 calls", DIT_DEPTH,
            lambda r: r["shape"][0] == BATCH),
        "flash_attention_backward": (
            csrc + "flash_attention.cu", dit_attention,
            "one DiT-S/2 train step at batch 64, 1024 tokens: its 12 backward calls "
            "(delta, dkv and dq kernels)", DIT_DEPTH, route_is("narrow", "f32")),
        "flash_attention_f32": (
            csrc + "flash_attention_f32.cu", dit_attention + " (fp32 head widths up to 128)",
            "one fp32 DiT-S/2 train step at batch 64, 1024 tokens: its 24 forward calls (remat)",
            2 * DIT_DEPTH, lambda r: tuple(r["shape"]) == FLASH_BWD_SHAPE, "float32"),
        "flash_attention_f32_backward": (
            csrc + "flash_attention_f32.cu", dit_attention + " (fp32 head widths up to 128)",
            "one fp32 DiT-S/2 train step at batch 64, 1024 tokens: its 12 backward calls (delta, "
            "then flash_dkv_tf32_kernel and flash_dq_tf32_kernel)", DIT_DEPTH,
            lambda r: tuple(r["shape"]) == FLASH_BWD_SHAPE, "float32"),
        "flash_attention_wide": (
            csrc + "flash_attention.cu", dit_attention + " (head widths 129-256)",
            f"{model_run('bf16', 6, 192)}: its {DIT_WIDE_FWD_CALLS} forward calls (the 192 "
            "instance)", DIT_WIDE_FWD_CALLS, route_is("wide")),
        "flash_attention_wide_backward": (
            csrc + "flash_attention.cu", dit_attention + " (head widths 129-256)",
            f"{model_run('bf16', 6, 192)}: its {DIT_WIDE_BWD_CALLS} backward calls (delta, "
            "flash_dkv_wide and flash_dq_wide kernels at 192)", DIT_WIDE_BWD_CALLS,
            route_is("wide")),
        "flash_attention_streamed": (
            csrc + "flash_attention_streamed.cu", dit_attention + " (bf16 head widths above 256)",
            f"{model_run('bf16', 3, 384)}: its {DIT_WIDE_FWD_CALLS} forward calls",
            DIT_WIDE_FWD_CALLS, route_is("streamed")),
        "flash_attention_streamed_backward": (
            csrc + "flash_attention_streamed.cu", dit_attention + " (bf16 head widths above 256)",
            f"{model_run('bf16', 3, 384)}: its {DIT_WIDE_BWD_CALLS} backward calls (delta, "
            "flash_dkv_streamed and flash_dq_streamed kernels)", DIT_WIDE_BWD_CALLS,
            route_is("streamed")),
        "flash_attention_f32_wide": (
            csrc + "flash_attention_f32.cu", dit_attention + " (fp32 head widths above 128)",
            f"{model_run('fp32', 6, 192)} and of the DiT with 3 heads of 384: their "
            f"{DIT_WIDE_FWD_CALLS} forward calls each (one chunk at 192, two at 384)",
            2 * DIT_WIDE_FWD_CALLS, route_is("f32_wide"), "float32"),
        "flash_attention_f32_wide_backward": (
            csrc + "flash_attention_f32.cu", dit_attention + " (fp32 head widths above 128)",
            f"{model_run('fp32', 6, 192)} and of the DiT with 3 heads of 384: their "
            f"{DIT_WIDE_BWD_CALLS} backward calls each (delta, then the dkv and dq launches of "
            "flash_bwd_f32_wide_kernel)", 2 * DIT_WIDE_BWD_CALLS, route_is("f32_wide"), "float32"),
        "dropout": (
            csrc + "dropout.cu", pallas + ":264",
            "one call at each of the three sizes; no model of either package calls it: its "
            "launches are those of ops.primitives.dropout driven directly",
            len(DROPOUT_SHAPES), None),
        "ln_modulate": (
            csrc + "dit_glue.cu", glue_replaces + ":183 (_modulate(_layer_norm(...)))",
            f"{dit_serve}: its {2 * DIT_DEPTH + 1} calls (two a block, the head's)",
            2 * DIT_DEPTH + 1, on_dit_path),
        "bias_act": (
            csrc + "dit_glue.cu", glue_replaces + ":184, :198-199 (dense bias, GELU)",
            f"{dit_serve}: its {DIT_DEPTH} qkv epilogues (C 1152) and {DIT_DEPTH} mlp1 "
            "epilogues with GELU (C 1536)", 2 * DIT_DEPTH, on_dit_path),
        "gated_residual": (
            csrc + "dit_glue.cu", glue_replaces + ":194-195, :200-201 (bias, gate, residual)",
            f"{dit_serve}: its {2 * DIT_DEPTH} calls (proj and mlp2, C 384)", 2 * DIT_DEPTH,
            on_dit_path),
        "qk_norm_rope": (
            csrc + "qk_norm_rope.cu", "none (no text-conditioned model in the JAX package)",
            f"{flux_forward}: its {sum(n for _, _, n in FLUX_QKR_STREAMS)} calls (a double "
            "block's text and image streams, a single block's joint one)",
            sum(n for _, _, n in FLUX_QKR_STREAMS), None),
        "flash_attention_joint": (
            csrc + "flash_attention.cu", dit_attention + " (FLUX's joint text-image attention)",
            f"{flux_forward}: its {FLUX['depth'] + FLUX['depth_single_blocks']} calls",
            FLUX["depth"] + FLUX["depth_single_blocks"],
            lambda r: tuple(r["shape"]) == FLUX_FLASH_SHAPE),
    }
    by_path = {"unet_serve": serve_launches, "unet_train": train_launches,
               "dropout_direct": dropout_launches, "latent_serve": latent_serve_launches,
               "latent_train": latent_train_launches, "cli": cli_launches,
               "dit_head_192": dit_wide_launches, "dit_head_384": dit_384_launches,
               "dit_train_f32": dit_f32_launches, "unet_resume": resume_launches,
               "http": http_launches, "profiling": profiling_launches,
               "parallel": parallel_launches,
               # the joint attention's launches, under their entry's name too
               "flux": {**flux_launches, "flash_attention_joint": flux_launches["flash_attention"]}}
    # the wrapper whose kernel-phase rows an entry reads, where it is not the entry's own name
    row_names = {f"flash_attention_{route}{part}": (f"flash_attention{part}",)
                 for route in ("wide", "streamed", "f32", "f32_wide")
                 for part in ("", "_backward")}
    row_names["bias_act"] = ("bias_act", "bias_act_gelu")
    row_names["flash_attention_joint"] = ("flash_attention",)
    kernels = []
    for name, (src, replaces, per, calls, keep, *dtype) in sources.items():
        dtype = dtype[0] if dtype else "bfloat16"
        mine = [r for r in rows
                if r["name"] in row_names.get(name, (name,)) and (keep is None or keep(r))]
        bf = [r for r in mine if r["dtype"] == dtype]

        def total(key):  # sum over the calls at their shapes
            return sum(r[key] * r["calls"] for r in bf)

        by_bytes = sum(r["bound_ms"] * r["calls"] for r in bf if r["bound_by"] == "bytes")
        paths = {path: counts.get(name, 0) for path, counts in by_path.items()}
        launches = sum(paths.values())
        if launches <= 0:
            fail(f"the main paths never launched {name}")
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches, launches_by_path=paths,
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=total("ms"), plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
            bound_by="bytes" if 2 * by_bytes >= total("bound_ms") else "operations",
            library_ms=total("library_ms"), status="ok", dtype=dtype, per=per, calls=calls,
        ))

    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

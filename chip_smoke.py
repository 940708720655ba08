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
   and at head widths 4, 12, 136 and 256 (batch 64, 1024 tokens, 6 heads),
   and the standalone dropout at three sizes, in bf16 and fp32,
   against its plain PyTorch version on the same inputs within a stated
   tolerance, with the kernel's, the plain version's and one PyTorch library
   call's times, and the card's least time (bound), with TFLOP/s where
   operations bound the kernel. The GroupNorm backward kernel at every
   GroupNorm site of the train step (with the dropout mask at the dropout
   sites), its library time that of ATen's chain (``F.group_norm`` +
   ``F.silu``, + ``F.dropout``) through autograd. The dropout kernels also:
   the mask equal to the plain version's bit for bit, the dropped fraction,
   same seed same output, other seed other mask. Then each bf16 flash
   kernel alone (forward; delta, dkv and dq of the backward) by the
   profiler's device time, with TFLOP/s and share of the bound, beside
   SDPA's forward and backward;
4. model: a full-width UNet forward in fp32 at batch 4, kernels on the card
   against the plain path on the CPU;
5. serve: ``SamplerService`` at full width, batch 256, steps (1, 2, 4), bf16,
   answering three requests; launch counts, same-seed determinism, img/s;
6. trace: one 4-step batch under ``torch.profiler``: device time by kernel
   group and the device's idle share;
7. gradient: full-width UNet, fp32, batch 4, dropout 0.1, fixed x0, t and
   seeds: the loss and every parameter's gradient on the card (kernels
   forward, ``gn_silu_backward`` backward) against the plain path on the CPU;
8. train: at full width, bf16 compute on fp32 masters: ``train_base_flow`` on
   a seeded 512-image corpus (batch 64, EMA 0.999, device-resident epochs),
   heun-teacher ``generate_reflow_pairs`` (pair batch 256),
   ``train_rectified_flow`` (teacher-init, u-shaped t, EMA),
   ``compute_straightness`` and 4-step samples from the student's EMA
   checkpoint; finite and falling losses, exact launch counts, and the same
   seeds giving the same loss trajectory twice;
9. train timing and trace: img/s of ``make_train_epoch`` at batch 256 in bf16,
   peak device memory, and one train step under ``torch.profiler``;
10. dropout: ``ops.primitives.dropout`` on tensors on the card, forward and
    gradient (no model of either package calls the standalone kernel), and
    ``dropout_mask_apply`` on a cotangent (the backward kernel took its place
    in the train step);
11. DiT model and gradient: DiT-S/2 (hidden 384, depth 12, 6 heads, patch 2,
    64x64x4 latents, ``remat``) in fp32 at batch 4 with all-random parameters:
    the forward, the loss and every parameter's gradient on the card (flash
    kernels forward and backward) against the plain path on the CPU; then
    DiT-XL/2's widths (16 heads of 72) at depth 2, batch 2, the same in fp32
    and the forward in bf16;
12. latent serve: ``SamplerService`` with a ConvVAE (256x256x3, base 64,
    downsample 4; seeded weights for both), batch 256, steps (1, 2, 4), bf16
    flow and bf16 decode, three requests; exact flash launch counts, outputs
    finite and in [-1, 1], same seed same images, pixel img/s, peak memory,
    and one 4-step batch under ``torch.profiler``;
13. latent train: a seeded 256-image 256x256 corpus; ``train_vae``; encode;
    ``train_base_flow(backbone="dit")`` at batch 64, lr 1e-4 with warm-up, EMA;
    heun pairs; ``train_rectified_flow`` (teacher-init, u-shaped t);
    straightness; ``LatentFlowPipeline.sample`` from the EMA checkpoint; exact
    launch counts; a second base run bit for bit; then DiT train img/s at
    batch 64, peak memory and a train-step trace.
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

Every number is printed; the last two lines of standard output are the
``kernels`` JSON line and ``{"ok": true, "device": {...}}``. The profiler
traces are kept in ``build/*_trace.json`` (chrome trace format); checkpoints
of the train phases go to ``build/smoke_ckpt/``.
"""

from __future__ import annotations

import json
import math
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
BATCH = 256
SEED = 0

# (rtol, atol) per kernel and dtype, checked as |kernel - plain| <= atol + rtol * |plain|.
TOLERANCES = {
    # fp32: the same fp32 arithmetic, summed in another order (one-pass
    # shifted moments vs two-pass statistics; other GEMM orders; cuDNN may
    # pick a Winograd or FFT algorithm for the plain conv, which is still
    # fp32 with TF32 off but rounds differently).
    ("gn_silu", "float32"): (1e-4, 1e-4),
    ("conv3x3", "float32"): (1e-3, 1e-3),
    ("attention_block", "float32"): (1e-3, 1e-3),
    # bf16: the kernels round once where the plain versions round two or
    # three times (gn then silu; conv then bias add); one bf16 ulp is 2^-7
    # relative at worst, 0.03 absolute on values in [4, 8).
    ("gn_silu", "bfloat16"): (2e-2, 3e-2),
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
}
SCALED_ATOL = {"flash_attention_backward", "gn_silu_backward"}
# the GroupNorm forwards' second output, the saved fp32 (mean, 1/sigma),
# against gn_stats_plain: the same fp32 statistics summed in another order
SAVES_STATS = {"gn_silu", "gn_silu_dropout"}
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
# and 12 zero-padded to 8 and 16, 136 and 256 on the chunked fp32 kernels
FLASH_ODD_SHAPES = tuple((LATENT["batch"], DIT_TOKENS, DIT_HEADS, d) for d in (4, 12, 136, 256))
DROPOUT_SHAPES = ((1024, 1024), (64, 1024, 384), (256, 64, 64, 64))
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


def all_counts(build, **counts):
    """Expected launch counts by kernel: ``counts``, and 0 for every other."""
    return {name: counts.get(name, 0) for name in build.LAUNCHES}


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
    return cases + flash_cases(torch, randn) + dropout_cases(torch, randn, seed)


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
    tokens and at DiT-XL/2's widths, and its backward at batch 64 (12 calls
    per train step) and at DiT-XL/2's widths. q, k, v are the three views of
    one [B, T, 3, H, D] tensor, as DiT hands them over. Bound: forward
    4 B H T^2 D flops, backward 2.5 times that; every input read once, every
    output written once."""
    import torch.nn.functional as F

    from rectified_flow_vision_tpu_torch.ops import flash_attention as FA

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)).transpose(1, 2)

    cases = []
    for shape in FLASH_FWD_SHAPES + (FLASH_XL_SHAPE,) + FLASH_ODD_SHAPES:
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
        calls = 0 if d != DIT_HEAD_DIM else {BATCH: DIT_DEPTH,
                                             LATENT["batch"]: 2 * DIT_DEPTH}.get(b, 0)
        cases.append(("flash_attention", shape, calls, make,
                      lambda es, e=elems, r=b * h * t: 4 * e * es + 4 * r,
                      flash_fwd_cost(shape)[1]))

    for shape, calls in ((FLASH_BWD_SHAPE, DIT_DEPTH), (FLASH_XL_SHAPE, 0),
                         *((odd, 0) for odd in FLASH_ODD_SHAPES)):
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
    """Each bf16 flash kernel alone: device ms per call by kernel (forward;
    delta, dkv and dq of the backward) from the profiler over 10 calls each,
    at the DiT-S/2 shapes (forward at batch 256, backward at batch 64) and at
    DiT-XL/2's widths, with TFLOP/s (of the products each kernel runs, at the
    true head width) and the share of the bound, beside SDPA's forward and
    backward timed with CUDA events in the same run. The split backward
    recomputes S and dP in dq (seven products where the bound counts five),
    so it can reach at most 5/7 of its bound."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from rectified_flow_vision_tpu_torch.ops import flash_attention as FA

    reps = 10
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    for shape in (FLASH_FWD_SHAPES[0], FLASH_BWD_SHAPE, FLASH_XL_SHAPE):
        b, t, h, d = shape
        q, k, v = (torch.randn((b, t, 3, h, d), generator=gen, device="cuda")
                   .to(torch.bfloat16).unbind(2))
        g = torch.randn((b, t, h, d), generator=gen, device="cuda").to(torch.bfloat16)
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
            fail(f"flash breakdown {shape}: the trace holds {dict(ms)}")

        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        tq, tk, tv = (x.transpose(1, 2) for x in leaves)
        sdpa_f = time_ms(torch, lambda: F.scaled_dot_product_attention(tq, tk, tv))
        lib_out = F.scaled_dot_product_attention(tq, tk, tv).transpose(1, 2)
        sdpa_b = time_ms(torch, lambda: torch.autograd.grad(lib_out, leaves, g, retain_graph=True))
        del leaves, tq, tk, tv, lib_out

        def bound(cost):
            nbytes, flops = cost
            return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["bfloat16"]) * 1e3

        fb, bb = bound(flash_fwd_cost(shape)), bound(flash_bwd_cost(shape))
        prod = 2 * b * h * t * t * d  # flops of one T x T x D product
        delta_bytes = 2 * b * t * h * d * 2 + 4 * b * h * t
        bwd = ms["delta"] + ms["dkv"] + ms["dq"]
        log(f"flash kernels {shape} bf16, ms per call (profiler): forward {ms['forward']:.4f} "
            f"({2 * prod / ms['forward'] / 1e9:.1f} TFLOP/s, {fb / ms['forward']:.3f} of its "
            f"bound {fb:.4f}) vs SDPA {sdpa_f:.4f} ({2 * prod / sdpa_f / 1e9:.1f} TFLOP/s, "
            f"{fb / sdpa_f:.3f}); backward {bwd:.4f} = delta {ms['delta']:.4f} "
            f"({delta_bytes / ms['delta'] / 1e6:.1f} GB/s) + dkv {ms['dkv']:.4f} "
            f"({4 * prod / ms['dkv'] / 1e9:.1f} TFLOP/s) + dq {ms['dq']:.4f} "
            f"({3 * prod / ms['dq'] / 1e9:.1f} TFLOP/s), {bb / bwd:.3f} of its bound {bb:.4f} "
            f"(at most 5/7 for the split design) vs SDPA {sdpa_b:.4f} "
            f"({5 * prod / sdpa_b / 1e9:.1f} TFLOP/s, {bb / sdpa_b:.3f})")
        del q, k, v, g, out, lse
        torch.cuda.empty_cache()


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


def kernel_phase(torch, shape_calls, train_calls):
    rows = []
    for name, shape, count, make, bytes_fn, flops in kernel_cases(torch, shape_calls, train_calls):
        for dname, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
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
            t_ops = flops / PEAK_FLOPS[dname] * 1e3
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
    if dict(build.LAUNCHES) != all_counts(build, **EVAL_FORWARD_LAUNCHES):
        fail(f"model forward launches {dict(build.LAUNCHES)}, expected {EVAL_FORWARD_LAUNCHES}")
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
    if dict(build.LAUNCHES) != all_counts(build, **TRAIN_STEP_LAUNCHES):
        fail(f"loss + backward launched {dict(build.LAUNCHES)}, expected {TRAIN_STEP_LAUNCHES}")
    loss_err = abs(float(got.detach()) - float(want.detach()))
    worst, worst_name = 0.0, ""
    for (name, pc), pg in zip(cpu.named_parameters(), gpu.parameters()):
        if pg.grad is None or not torch.isfinite(pg.grad).all():
            fail(f"gradient of {name} is missing or non-finite")
        ref = pc.grad
        err = float((pg.grad.cpu() - ref).abs().max())
        ratio = err / (GRAD_RTOL * float(ref.abs().max()) + GRAD_ATOL)
        if ratio > worst:
            worst, worst_name = ratio, name
    log(f"gradient fp32 batch 4, dropout {DROP_RATE}: loss {float(got.detach()):.6f} (CPU plain "
        f"{float(want.detach()):.6f}, |diff| {loss_err:.2e}, atol {LOSS_ATOL}); worst gradient "
        f"{worst_name} at {worst:.3f} of its tolerance ({GRAD_RTOL} x max|g| + {GRAD_ATOL})")
    if loss_err > LOSS_ATOL or worst > 1.0:
        fail("loss or gradients on the card differ from the CPU plain path")


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
    expect = all_counts(build, flash_attention=DIT_DEPTH)
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
    expect = all_counts(build, flash_attention=2 * DIT_DEPTH, flash_attention_backward=DIT_DEPTH)
    if dict(build.LAUNCHES) != expect:
        fail(f"DiT loss + backward launched {dict(build.LAUNCHES)}, expected {expect}")
    loss_err = abs(float(loss.detach()) - float(ref.detach()))
    worst, worst_name = 0.0, ""
    for (name, pc), pg in zip(cpu.named_parameters(), gpu.parameters()):
        if pg.grad is None or not torch.isfinite(pg.grad).all():
            fail(f"DiT gradient of {name} is missing or non-finite")
        err = float((pg.grad.cpu() - pc.grad).abs().max())
        ratio = err / (GRAD_RTOL * float(pc.grad.abs().max()) + GRAD_ATOL)
        if ratio > worst:
            worst, worst_name = ratio, name
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
        if dict(build.LAUNCHES) != all_counts(build, flash_attention=depth):
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
    expect = all_counts(build, flash_attention=2 * depth, flash_attention_backward=depth)
    if dict(build.LAUNCHES) != expect:
        fail(f"DiT-XL widths loss + backward launched {dict(build.LAUNCHES)}, expected {expect}")
    loss_err = abs(float(loss.detach()) - float(ref.detach()))
    worst, worst_name = 0.0, ""
    for (name, pc), pg in zip(cpu.named_parameters(), gpu.parameters()):
        if pg.grad is None or not torch.isfinite(pg.grad).all():
            fail(f"DiT-XL widths gradient of {name} is missing or non-finite")
        err = float((pg.grad.cpu() - pc.grad).abs().max())
        ratio = err / (GRAD_RTOL * float(pc.grad.abs().max()) + GRAD_ATOL)
        if ratio > worst:
            worst, worst_name = ratio, name
    log(f"DiT-XL/2 widths (hidden 1152, 16 heads of 72), depth {depth}, batch 2, all parameters "
        f"random: forward vs the CPU plain path max_abs fp32 {errs['float32']:.3e} (atol "
        f"{MODEL_ATOL}), bf16 {errs['bfloat16']:.3e} (rtol {XL_BF16_RTOL} of max|v|); fp32 loss "
        f"{float(loss.detach()):.6f} (|diff| {loss_err:.2e}, atol {LOSS_ATOL}); worst gradient "
        f"{worst_name} at {worst:.3f} of its tolerance ({GRAD_RTOL} x max|g| + {GRAD_ATOL})")
    if loss_err > LOSS_ATOL or worst > 1.0:
        fail("DiT-XL widths loss or gradients on the card differ from the CPU plain path")


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
    expect = all_counts(build, flash_attention=DIT_DEPTH * forwards)
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
    expect = all_counts(
        build, flash_attention=DIT_DEPTH * (2 * train_steps + forwards),
        flash_attention_backward=DIT_DEPTH * train_steps)
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


def dit_train_timing_phase(torch, build, model, data) -> None:
    """img/s of device-resident DiT training at batch 64 in bf16 with remat,
    peak memory, the launches of one step, and one step under the profiler."""
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
    per_step = all_counts(build, flash_attention=2 * DIT_DEPTH,
                          flash_attention_backward=DIT_DEPTH)
    if dict(build.LAUNCHES) != per_step:
        fail(f"one DiT train step launched {dict(build.LAUNCHES)}, expected {per_step}")
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
            fail("DiT train timing: non-finite loss")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"DiT train timing: make_train_epoch, DiT-S/2, batch {batch}, bf16 compute, fp32 "
        f"masters, EMA, remat, 64x64x4 latents, {steps} steps per reading: img/s "
        f"{[round(v, 2) for v in rates]} (median {float(np.median(rates)):.2f}); peak device "
        f"memory {peak:.2f} GiB; flash launches per step: 24 forward, 12 backward")
    one = perm(1)
    profile_device(torch, lambda: epoch(corpus, one, gen), "dit_train_trace.json",
                   f"one DiT-S/2 train step of {batch}")


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
    from rectified_flow_vision_tpu_torch.models.unet import UNet
    from rectified_flow_vision_tpu_torch.ops import build
    from rectified_flow_vision_tpu_torch.ops import fused as fused_mod

    log(f"card: {card_line()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s")

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
    rows = kernel_phase(torch, shape_calls, train_calls)
    flash_breakdown(torch)
    model_phase(torch, UNet)
    serve_launches, svc, serve_img_s = serve_phase(torch, build)
    trace_phase(torch, svc)
    del svc
    torch.cuda.empty_cache()
    gradient_phase(torch, build)
    train_launches, trained, data = train_phase(torch, build)
    train_timing_phase(torch, build, trained, data)
    del trained, data
    torch.cuda.empty_cache()
    dropout_launches = dropout_phase(torch, build)
    dit_model_phase(torch, build)
    dit_xl_phase(torch, build)
    latent_serve_launches = latent_serve_phase(torch, build)
    torch.cuda.empty_cache()
    latent_train_launches, dit_trained, latents = latent_train_phase(torch, build)
    dit_train_timing_phase(torch, build, dit_trained, latents)
    del dit_trained, latents
    torch.cuda.empty_cache()
    cli_launches = cli_phase(torch, build, serve_img_s)

    csrc = "rectified_flow_vision_tpu_torch/ops/csrc/"
    pallas = "rectified_flow_vision_tpu/ops/pallas_kernels.py"
    unet_forward = "one UNet eval forward at batch 256: sum over its calls"
    unet_step = "one UNet train step at batch 256: sum over its calls"
    # name -> (source, TPU kernel it replaces, what `ms` sums, calls in that unit,
    #          filter on the kernel phase's rows)
    sources = {
        "gn_silu": (csrc + "gn_silu.cu", pallas + ":100", unet_forward, per_forward["gn_silu"],
                    None),
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
            csrc + "flash_attention.cu", "rectified_flow_vision_tpu/models/dit.py:127",
            "one DiT-S/2 forward at batch 256, 1024 tokens: its 12 calls", DIT_DEPTH,
            lambda r: r["shape"][0] == BATCH),
        "flash_attention_backward": (
            csrc + "flash_attention.cu", "rectified_flow_vision_tpu/models/dit.py:127",
            "one DiT-S/2 train step at batch 64, 1024 tokens: its 12 backward calls "
            "(delta, dkv and dq kernels)", DIT_DEPTH, None),
        "dropout": (
            csrc + "dropout.cu", pallas + ":264",
            "one call at each of the three sizes; no model of either package calls it: its "
            "launches are those of ops.primitives.dropout driven directly",
            len(DROPOUT_SHAPES), None),
    }
    by_path = {"unet_serve": serve_launches, "unet_train": train_launches,
               "dropout_direct": dropout_launches, "latent_serve": latent_serve_launches,
               "latent_train": latent_train_launches, "cli": cli_launches}
    kernels = []
    for name, (src, replaces, per, calls, keep) in sources.items():
        mine = [r for r in rows if r["name"] == name]
        bf = [r for r in mine if r["dtype"] == "bfloat16" and (keep is None or keep(r))]

        def total(key):  # bf16: sum over the calls at their shapes
            return sum(r[key] * r["calls"] for r in bf)

        by_bytes = sum(r["bound_ms"] * r["calls"] for r in bf if r["bound_by"] == "bytes")
        paths = {path: counts[name] for path, counts in by_path.items()}
        launches = sum(paths.values())
        if launches <= 0:
            fail(f"the main paths never launched {name}")
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches, launches_by_path=paths,
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=total("ms"), plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
            bound_by="bytes" if 2 * by_bytes >= total("bound_ms") else "operations",
            library_ms=total("library_ms"), status="ok", dtype="bfloat16", per=per, calls=calls,
        ))

    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Throughput of two checkouts of the PyTorch port on one card, in turns.

    python3 tools/torch_serve_ab.py PARENT_ROOT [CHANGE_ROOT]

Each root is a checkout that holds ``rectified_flow_vision_tpu_torch/``
(``CHANGE_ROOT`` defaults to this file's checkout). The order is parent,
change, change, parent, each in a process of its own that builds that
checkout's kernels and reads, from random weights (seed 0), in bf16:

- ``unet_serve``: ``SamplerService.throughput(4)`` of the flagship UNet
  (64x64) at batch 256, three readings;
- ``unet_train``: img/s of ``make_train_epoch`` at batch 256 (6 steps a
  reading, four readings);
- ``latent_serve``: ``throughput(4)`` of DiT-S/2 on 64x64x4 latents with the
  ConvVAE decode to 256x256x3, batch 256, three readings;
- ``dit_train``: img/s of ``make_train_epoch`` for DiT-S/2 with ``remat`` at
  batch 64 (6 steps a reading, four readings); ``dit_train_f32`` the same
  with fp32 compute (the fp32 flash kernels up to D = 128);
- ``flash_fwd_ms`` / ``flash_bwd_ms``: the flash kernels' device time (CUDA
  events, at least 10 calls and 20 ms of them after a warm-up) summed over
  the 12 calls of one DiT-S/2
  forward at batch 256 and of one train step's backward at batch 64;
- ``flash_d{D}_fwd_ms`` / ``flash_d{D}_bwd_ms``: one forward and one
  backward call at (64, 1024, H, D) in bf16: DiT-XL/2's 16 heads of 72, and
  6 heads of 4, 12, 136, 192, 256, 320, 384 and 512 (the zero-padded
  widths, the widths above 128 and above 256); ``flash_f32_d{D}_*`` the
  same in fp32 at 6 heads of 64, 4, 12, 192, 256 and 384 and at DiT-XL/2's
  16 heads of 72; ``flash_b2_d192_*`` the
  6 forward and 2 backward calls at (2, 1024, 6, 192) of the DiT with heads
  of 192;
- ``gn_fwd_ms`` / ``gn_drop_fwd_ms``: the same for ``gn_silu_cuda`` over the
  29 GroupNorm calls of one flagship UNet forward at batch 256, and for
  ``gn_silu_dropout_cuda`` over the 14 dropout sites of a train step;
- ``unet_train_split``: one UNet train step at batch 256 under
  ``torch.profiler``, its device time by the autograd node that launched
  each kernel (the outermost ``evaluate_function: <node>`` around the launch
  on the host),
  "forward / optimizer" outside any node; printed, not compared.

Two versions are only comparable within one run on one card, so the card's
name and power limit are printed first. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import json, sys, time
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
from rectified_flow_vision_tpu_torch.models import BaseFlowModel, ConvVAE
from rectified_flow_vision_tpu_torch.models.base_flow import init_ema, make_optimizer, make_train_epoch
from rectified_flow_vision_tpu_torch.ops import flash_attention as FA
from rectified_flow_vision_tpu_torch.serving import SamplerService
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
DIT = dict(image_size=64, in_channels=4, backbone="dit", dit_size="S", patch_size=2, remat=True)
# the rows whose kernels a change may leave alone first, then the wide ones,
# whose chunked versions hold the card for seconds a reading
FLASH_CASES = (("flash_d72", "bfloat16", 64, 16, 72, 1, 1), ("flash_d4", "bfloat16", 64, 6, 4, 1, 1),
               ("flash_d12", "bfloat16", 64, 6, 12, 1, 1),
               *((f"flash_d{d}", "bfloat16", 64, 6, d, 1, 1) for d in (136, 192, 256)),
               ("flash_b2_d192", "bfloat16", 2, 6, 192, 6, 2),
               ("flash_f32_d64", "float32", 64, 6, 64, 1, 1),
               ("flash_f32_d72", "float32", 64, 16, 72, 1, 1),
               *((f"flash_f32_d{d}", "float32", 64, 6, d, 1, 1) for d in (4, 12)),
               *((f"flash_d{d}", "bfloat16", 64, 6, d, 1, 1) for d in (320, 384, 512)),
               *((f"flash_f32_d{d}", "float32", 64, 6, d, 1, 1) for d in (192, 256, 384)))
out = {}

def randomize_zero_leaves(model, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            if not bool(p.any()):
                p.copy_((torch.randn(p.shape, generator=g) * 0.02).to(p.device))

def train_rates(model, corpus, batch, lr):
    steps = 6
    opt = make_optimizer(model, lr, 1000, steps)
    epoch = make_train_epoch(model, opt, coupled=False, ema=init_ema(model), ema_decay=0.999)
    gen = torch.Generator(device="cuda").manual_seed(0)
    r = np.random.default_rng(0)
    perm = lambda n: torch.as_tensor(r.integers(0, len(corpus), (n, batch)), device="cuda")
    epoch(corpus, perm(1), gen)
    rates = []
    for _ in range(4):
        p = perm(steps)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        epoch(corpus, p, gen)
        torch.cuda.synchronize()
        rates.append(batch * steps / (time.perf_counter() - t0))
    return rates

def kernel_ms(fn):
    # at least 10 calls and 20 ms of them, so that a call of a few
    # microseconds is not read off one launch's jitter
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    reps = min(1000, max(10, int(20.0 / max(a.elapsed_time(b), 1e-3))))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps

def by_autograd_node(trace):
    # device ms by the autograd node whose evaluate_function event holds the
    # host-side launch of each kernel (the outermost on that thread: a node
    # whose backward runs autograd itself holds its inner nodes)
    events = trace["traceEvents"]
    nodes = {}
    for e in events:
        if e.get("cat") == "cpu_op" and e["name"].startswith("autograd::engine::evaluate_function: "):
            nodes.setdefault(e["tid"], []).append((e["ts"], e["ts"] + e["dur"], e["name"].split(": ", 1)[1]))
    launch = {}
    for e in events:
        if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = (e["tid"], e["ts"])
    ms = {}
    for e in events:
        if e.get("cat") != "kernel" or "dur" not in e:
            continue
        tid, ts = launch.get(e["args"].get("correlation"), (None, None))
        label, width = "forward / optimizer", -1.0
        for a, b, name in nodes.get(tid, ()):
            if a <= ts <= b and b - a > width:
                label, width = name, b - a
        ms[label] = ms.get(label, 0.0) + e["dur"] / 1e3
    return dict(sorted(ms.items(), key=lambda kv: -kv[1]))

def unet_train_split(model, corpus):
    import os, tempfile
    from torch.profiler import ProfilerActivity, profile
    opt = make_optimizer(model, 2e-4, 1000, 1)
    epoch = make_train_epoch(model, opt, coupled=False, ema=init_ema(model), ema_decay=0.999)
    gen = torch.Generator(device="cuda").manual_seed(0)
    perm = torch.as_tensor(np.random.default_rng(0).integers(0, len(corpus), (1, 256)), device="cuda")
    epoch(corpus, perm, gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        epoch(corpus, perm, gen)
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    os.remove(path)
    return {k: round(v, 3) for k, v in by_autograd_node(trace).items()}

model = BaseFlowModel(image_size=64, seed=0, sample_dtype="bfloat16", device="cuda")
svc = SamplerService(model, step_counts=(4,), batch_size=256, seed=0)
out["unet_serve"] = [svc.throughput(4) for _ in range(3)]
del svc, model
model = BaseFlowModel(image_size=64, seed=0, compute_dtype="bfloat16", sample_dtype="bfloat16",
                      device="cuda")
images = torch.tanh(torch.randn((512, 64, 64, 3), generator=torch.Generator(device="cuda").manual_seed(1),
                                device="cuda"))
out["unet_train"] = train_rates(model, images, 256, 2e-4)
out["unet_train_split"] = unet_train_split(model, images)
del model, images
torch.cuda.empty_cache()

model = BaseFlowModel(seed=0, sample_dtype="bfloat16", device="cuda", **DIT)
randomize_zero_leaves(model, 6)
vae = ConvVAE(seed=0, device="cuda", image_size=256, in_channels=3, latent_channels=4,
              base_channels=64, downsample=4)
svc = SamplerService(model, step_counts=(4,), batch_size=256, seed=0, vae=vae)
out["latent_serve"] = [svc.throughput(4) for _ in range(3)]
del svc, model, vae
torch.cuda.empty_cache()
model = BaseFlowModel(seed=0, compute_dtype="bfloat16", sample_dtype="bfloat16", device="cuda", **DIT)
latents = torch.randn((256, 64, 64, 4), generator=torch.Generator(device="cuda").manual_seed(2),
                      device="cuda")
out["dit_train"] = train_rates(model, latents, 64, 1e-4)
del model
torch.cuda.empty_cache()
model = BaseFlowModel(seed=0, compute_dtype="float32", device="cuda", **DIT)
out["dit_train_f32"] = train_rates(model, latents, 64, 1e-4)
del model, latents
torch.cuda.empty_cache()

g = torch.Generator(device="cuda").manual_seed(3)
q, k, v = torch.randn((256, 1024, 3, 6, 64), generator=g, device="cuda").bfloat16().unbind(2)
out["flash_fwd_ms"] = [12 * kernel_ms(lambda: FA.flash_attention_cuda(q, k, v))]
q, k, v = torch.randn((64, 1024, 3, 6, 64), generator=g, device="cuda").bfloat16().unbind(2)
d_out = torch.randn((64, 1024, 6, 64), generator=g, device="cuda").bfloat16()
o, lse = FA.flash_attention_cuda(q, k, v)
out["flash_bwd_ms"] = [12 * kernel_ms(lambda: FA.flash_attention_backward_cuda(q, k, v, o, lse, d_out))]
del q, k, v, d_out, o, lse
for key, dname, b, h, d, nf, nb in FLASH_CASES:
    dt = getattr(torch, dname)
    q, k, v = torch.randn((b, 1024, 3, h, d), generator=g, device="cuda").to(dt).unbind(2)
    d_out = torch.randn((b, 1024, h, d), generator=g, device="cuda").to(dt)
    o, lse = FA.flash_attention_cuda(q, k, v)
    out[f"{key}_fwd_ms"] = [nf * kernel_ms(lambda: FA.flash_attention_cuda(q, k, v))]
    out[f"{key}_bwd_ms"] = [nb * kernel_ms(lambda: FA.flash_attention_backward_cuda(q, k, v, o, lse, d_out))]
    del q, k, v, d_out, o, lse
    torch.cuda.empty_cache()
from rectified_flow_vision_tpu_torch.ops import gn_silu as G, gn_silu_dropout as D
GN_FWD = {(16, 16, 128): 1, (16, 16, 256): 10, (16, 16, 512): 1, (32, 32, 64): 1, (32, 32, 128): 6,
          (32, 32, 384): 1, (64, 64, 64): 8, (64, 64, 192): 1}
GN_DROP = {(16, 16, 256): 5, (32, 32, 128): 4, (64, 64, 64): 5}
for key, calls, fn in (("gn_fwd_ms", GN_FWD, lambda x, s, b: G.gn_silu_cuda(x, s, b)),
                       ("gn_drop_fwd_ms", GN_DROP, lambda x, s, b: D.gn_silu_dropout_cuda(x, s, b, 7, 0.1))):
    total = 0.0
    for (h, w, c), n in calls.items():
        x = torch.randn((256, h, w, c), generator=g, device="cuda").bfloat16()
        s, b = torch.ones(c, device="cuda"), torch.zeros(c, device="cuda")
        total += n * kernel_ms(lambda: fn(x, s, b))
    out[key] = [total]
print(json.dumps(out))
"""

FLASH_KEYS = ("flash_d72", "flash_d4", "flash_d12", "flash_d136", "flash_d192", "flash_d256",
              "flash_b2_d192", "flash_f32_d64", "flash_f32_d72", "flash_f32_d4", "flash_f32_d12",
              "flash_d320", "flash_d384", "flash_d512", "flash_f32_d192", "flash_f32_d256",
              "flash_f32_d384")
METRICS = ("unet_serve", "unet_train", "latent_serve", "dit_train", "dit_train_f32",
           "flash_fwd_ms", "flash_bwd_ms",
           *(f"{key}_{p}_ms" for key in FLASH_KEYS for p in ("fwd", "bwd")),
           "gn_fwd_ms", "gn_drop_fwd_ms")


def main() -> None:
    if len(sys.argv) not in (2, 3):
        sys.exit(__doc__)
    parent = Path(sys.argv[1]).resolve()
    change = Path(sys.argv[2]).resolve() if len(sys.argv) == 3 else Path(__file__).resolve().parents[1]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"card: {card}", flush=True)
    readings = {side: {m: [] for m in METRICS} for side in ("parent", "change")}
    for side in ("parent", "change", "change", "parent"):
        root = parent if side == "parent" else change
        res = subprocess.run(
            [sys.executable, "-c", CHILD, str(root)], cwd=root, capture_output=True, text=True,
            timeout=900,
        )
        if res.returncode != 0:
            sys.exit(f"{side} ({root}) failed:\n{res.stdout}\n{res.stderr}")
        got = json.loads(res.stdout.strip().splitlines()[-1])
        for m in METRICS:
            readings[side][m] += got[m]
        print(f"{side:6s} {root}: " + ", ".join(f"{m} {[round(x, 3) for x in got[m]]}"
                                                for m in METRICS), flush=True)
        print(f"{side:6s} unet_train_split (device ms by autograd node): "
              f"{json.dumps(got['unet_train_split'])}", flush=True)
    summary = {"card": card}
    for m in METRICS:
        med = {side: statistics.median(readings[side][m]) for side in readings}
        summary[m] = {"parent": readings["parent"][m], "change": readings["change"][m],
                      "parent_median": med["parent"], "change_median": med["change"],
                      "change_over_parent": med["change"] / med["parent"]}
    print(json.dumps(summary))


if __name__ == "__main__":
    main()

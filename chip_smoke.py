#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit (``nvcc``). It fails (non-zero exit, no result line) without a
card, outside a checkout, or when any phase fails. Phases, in order:

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``rectified_flow_vision_tpu_torch/ops/csrc``;
3. kernels: every kernel at every shape the flagship UNet's forward gives it
   (batch 256; shapes recorded from a CPU forward of the same model), in
   bf16 and fp32, against its plain PyTorch version on the same inputs
   within a stated tolerance, with the kernel's, the plain version's and one
   PyTorch library call's times, and the card's least time (bound);
4. model: a full-width UNet forward in fp32 at batch 4, kernels on the card
   against the plain path on the CPU;
5. serve: ``SamplerService`` at full width, batch 256, steps (1, 2, 4), bf16,
   answering three requests; launch counts, same-seed determinism, img/s;
6. trace: one 4-step batch under ``torch.profiler``: device time by kernel
   group and the device's idle share.

Every number is printed; the last two lines of standard output are the
``kernels`` JSON line and ``{"ok": true, "device": {...}}``. The profiler
trace is kept in ``build/serve_trace.json`` (chrome trace format).
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
}
# fp32 full-width forward, kernels on the card vs plain on the CPU: ~60
# layers of fp32 arithmetic summed in other orders.
MODEL_ATOL = 1e-3


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


def record_main_path_shapes(torch, UNet, fused_mod):
    """Shapes each kernel gets in one flagship forward, with multiplicity,
    from a batch-1 CPU forward through the plain versions."""
    calls = {"gn_silu": Counter(), "conv3x3": Counter(), "attention_block": Counter()}
    G, C, A = fused_mod.G, fused_mod.C, fused_mod.A

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
             "attention_block", A.attention_block_plain, lambda x, *a: tuple(x.shape[1:]))):
        with torch.no_grad():
            net(x, t)
    return calls


def kernel_cases(torch, shape_calls):
    """(name, shape, count, make_inputs(dtype) -> (kernel, plain, library), bytes_fn, flops)."""
    import torch.nn.functional as F

    from rectified_flow_vision_tpu_torch.ops import attention as A
    from rectified_flow_vision_tpu_torch.ops import conv3x3 as C
    from rectified_flow_vision_tpu_torch.ops import gn_silu as G

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
                lambda: G.gn_silu_plain(x, s, b),
                lambda: F.silu(F.group_norm(x.permute(0, 3, 1, 2), 8, sl, bl)),
            )
        elems = BATCH * h * w * c
        cases.append(("gn_silu", (BATCH, h, w, c), n, make,
                      lambda es, e=elems, c=c: 2 * e * es + 2 * c * 4, 10 * elems))
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
    for (h, w, c), n in sorted(shape_calls["attention_block"].items()):
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
    return cases


def kernel_phase(torch, shape_calls):
    rows = []
    for name, shape, count, make, bytes_fn, flops in kernel_cases(torch, shape_calls):
        for dname, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            kernel, plain, library = make(dt)
            got, want = kernel().float(), plain().float()
            torch.cuda.synchronize()
            if tuple(got.shape) != tuple(want.shape) or not torch.isfinite(got).all():
                fail(f"{name} {dname} {shape}: bad shape or non-finite output")
            err = (got - want).abs()
            rtol, atol = TOLERANCES[(name, dname)]
            ok = bool((err <= atol + rtol * want.abs()).all())
            max_abs = float(err.max())
            max_rel = max_abs / max(float(want.abs().max()), 1e-30)
            k_ms = time_ms(torch, kernel)
            p_ms = time_ms(torch, plain)
            l_ms = time_ms(torch, library)
            es = 2 if dt == torch.bfloat16 else 4
            t_bytes = bytes_fn(es) / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS[dname] * 1e3
            row = dict(
                name=name, dtype=dname, shape=list(shape), calls_per_forward=count,
                max_abs_err=max_abs, max_rel_err=max_rel, rtol=rtol, atol=atol, ok=ok,
                ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
            )
            rows.append(row)
            log(f"kernel {name:16s} {dname:8s} {str(tuple(shape)):24s} x{count:<2d} "
                f"max_abs {max_abs:.3e} max_rel {max_rel:.3e} (rtol {rtol}, atol {atol}) "
                f"{'ok' if ok else 'MISMATCH'} | kernel {k_ms:.4f} ms plain {p_ms:.4f} ms "
                f"library {l_ms:.4f} ms bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
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
    if dict(build.LAUNCHES) != {"gn_silu": 29, "conv3x3": 30, "attention_block": 1}:
        fail(f"model forward launches {dict(build.LAUNCHES)}, expected 29 / 30 / 1")
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
    expect = {"gn_silu": 29 * forwards, "conv3x3": 30 * forwards, "attention_block": forwards}
    log(f"serve: warmup {warm_s:.2f} s, requests {lat}, launches {launches}")
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
    if one_batch != {"gn_silu": 4 * 29, "conv3x3": 4 * 30, "attention_block": 4}:
        fail(f"one 4-step batch launched {one_batch}, expected 116 / 120 / 4")
    log(f"serve: one 4-step batch of {BATCH} launched {one_batch}")

    again = SamplerService(model, step_counts=(1,), batch_size=BATCH, seed=SEED, warmup=False)
    same = again.generate(16, num_steps=1)
    if not np.array_equal(same, outs[(16, 1)]):
        fail("same seed gave different images")
    img_s = svc.throughput(4)
    log(f"serve: same seed gives the same images; throughput(4) {img_s:.2f} img/s "
        f"(batch {BATCH}, bf16)")
    return launches, svc


def kernel_group(name: str) -> str:
    for key, group in (("conv3x3", "conv3x3"), ("gn_", "gn_silu"), ("attn_", "attention_block")):
        if key in name:
            return group
    return "other"


def trace_phase(torch, svc) -> None:
    """Device time of one 4-step batch by kernel group, and the device's idle
    share of the host's wall time, from a torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    sampler = svc._samplers[4]
    noise = svc._noise()
    sampler(noise)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sampler(noise)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    path = ROOT / "build" / "serve_trace.json"
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
    log(f"trace: one 4-step batch of {BATCH}: wall {wall_ms:.2f} ms, device busy "
        f"{busy_ms:.2f} ms (idle share {1.0 - busy_ms / wall_ms:.3f}), {len(events)} kernels, "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in groups.most_common()))
    log("trace: largest other kernels: "
        + "; ".join(f"{k} {v:.2f} ms" for k, v in names.most_common(8)))


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
    if per_forward != {"gn_silu": 29, "conv3x3": 30, "attention_block": 1}:
        fail(f"flagship forward calls {per_forward}, expected 29 / 30 / 1")
    rows = kernel_phase(torch, shape_calls)
    model_phase(torch, UNet)
    launches, svc = serve_phase(torch, build)
    trace_phase(torch, svc)

    sources = {
        "gn_silu": ("rectified_flow_vision_tpu_torch/ops/csrc/gn_silu.cu",
                    "rectified_flow_vision_tpu/ops/pallas_kernels.py:100"),
        "conv3x3": ("rectified_flow_vision_tpu_torch/ops/csrc/conv3x3.cu",
                    "rectified_flow_vision_tpu/ops/conv_pallas.py:378"),
        "attention_block": ("rectified_flow_vision_tpu_torch/ops/csrc/attention.cu",
                            "rectified_flow_vision_tpu/ops/pallas_kernels.py:191"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        mine = [r for r in rows if r["name"] == name]
        bf = [r for r in mine if r["dtype"] == "bfloat16"]

        def per_fwd(key):  # one bf16 forward at batch 256: sum over its calls
            return sum(r[key] * r["calls_per_forward"] for r in bf)

        by_bytes = sum(r["bound_ms"] * r["calls_per_forward"]
                       for r in bf if r["bound_by"] == "bytes")
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name], max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=per_fwd("ms"), plain_ms=per_fwd("plain_ms"), bound_ms=per_fwd("bound_ms"),
            bound_by="bytes" if 2 * by_bytes >= per_fwd("bound_ms") else "operations",
            library_ms=per_fwd("library_ms"), status="ok", dtype="bfloat16",
            per="one UNet forward at batch 256: sum over its calls",
            calls_per_forward=per_forward[name],
        ))

    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

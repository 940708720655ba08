"""Benchmark: base vs rectified model, speed and quality, with the report.

Counterpart of the JAX package's ``experiments/benchmark.py``:

* ``benchmark_speed``: the reference's latency sweep (batch 4, warm-up
  outside the timed runs);
* ``benchmark_throughput``: the dependency-chained sweep at a saturating
  batch (each timed run is ``chain`` sampler calls, each fed the previous
  output; latent models decode every output);
* ``benchmark_quality``: SSIM, LPIPS (row-paired, and the nearest-neighbour
  precision / recall with CIs), raw-pixel FID and deep FID with its CI
  against held-out references;
* the sample grids, ``benchmark_results.csv``, ``quality_results.csv``, the
  figures, ``benchmark_report.txt`` and the measured conclusions, judged by
  ``judge_quality_claim`` (copied from the JAX package with the other pure
  helpers below).

Every host clock ends in ``torch.cuda.synchronize()`` on the card. Noise is
drawn from seeded ``torch.Generator``s on the models' device, so the port's
images are not the JAX package's. ``main`` returns the speed rows as a list
of dicts and writes the CSVs with the ``csv`` module, with the columns, in
the order, of the JAX package's data frames. The environment variables are
the JAX package's: ``RFV_RESULTS_DIR`` redirects the artifacts,
``RFV_ALLOW_UNTRAINED`` lets untrained models overwrite existing ones, and
``RFV_PROFILE=<dir>`` records a ``torch.profiler`` trace of the run.
"""

from __future__ import annotations

import csv
import os
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from rectified_flow_vision_tpu_torch import config as config_lib
from rectified_flow_vision_tpu_torch.config import Config, load_config
from rectified_flow_vision_tpu_torch.models import BaseFlowModel, RectifiedFlowModel
from rectified_flow_vision_tpu_torch.models.base_flow import resolve_device
from rectified_flow_vision_tpu_torch.serving import _sync
from rectified_flow_vision_tpu_torch.utils.logging_config import get_logger
from rectified_flow_vision_tpu_torch.utils.metrics import MetricsCalculator
from rectified_flow_vision_tpu_torch.utils.visualization import (
    create_summary_report,
    plot_generated_samples,
    plot_quality_vs_speed,
    plot_speed_comparison,
    plot_trajectory_comparison,
)

log = get_logger("flow_vision.benchmark")

# the data frames' columns, in the JAX package's order
SPEED_COLUMNS = ["num_steps", "base_time_ms", "rect_time_ms", "base_img_per_sec",
                 "rect_img_per_sec", "speedup"]
LATENCY_COLUMNS = ["base_dispatch_bound_ms_b4", "rect_dispatch_bound_ms_b4"]
QUALITY_COLUMNS = [
    "num_steps", "model", "ssim_mean", "ssim_std", "ssim_n", "lpips",
    "lpips_to_ref", "lpips_to_ref_lo", "lpips_to_ref_hi",
    "lpips_recall", "lpips_recall_lo", "lpips_recall_hi",
    "fid_simple", "fid_simple_n", "fid_deep", "fid_deep_lo", "fid_deep_hi", "n_eval",
]


def _device(model) -> torch.device:
    return getattr(model, "flow", model).device


def _noise(shape, seed: int, device: torch.device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float32, device=device)


def benchmark_speed(
    model,
    num_samples: int,
    steps_list: list,
    image_size: int,
    num_runs: int = 3,
    batch_size: int = 4,
):
    """Latency sweep over step counts (reference: benchmark.py:32-83).

    Per step count: one warm-up sample at every batch shape of the sweep,
    then ``num_runs`` timed loops over ``num_samples`` images in batches of
    ``batch_size``, each ended by a synchronise.
    """
    device = _device(model)
    shape = (image_size, image_size, model.in_channels)
    warmup_batches = {batch_size}
    if num_samples % batch_size:
        warmup_batches.add(num_samples % batch_size)

    results = []
    for num_steps in steps_list:
        for wb in sorted(warmup_batches):  # outside the timed runs
            model.sample(noise=_noise((wb,) + shape, 0, device), num_steps=num_steps,
                         data_format="NHWC")
        _sync(device)
        times = []
        for run in range(num_runs):
            start = time.perf_counter()
            for i in range(0, num_samples, batch_size):
                cur = min(batch_size, num_samples - i)  # exactly num_samples
                noise = _noise((cur,) + shape, run * 131071 + i, device)
                model.sample(noise=noise, num_steps=num_steps, data_format="NHWC")
            _sync(device)
            times.append(time.perf_counter() - start)

        avg_time, std_time = float(np.mean(times)), float(np.std(times))
        results.append(
            {
                "num_steps": num_steps,
                "total_time": avg_time,
                "time_per_image": avg_time / num_samples,
                "images_per_second": num_samples / avg_time,
                "time_std": std_time,
                "num_samples": num_samples,
            }
        )
    return results


def benchmark_throughput(
    model,
    steps_list: list,
    image_size: int,
    batch_size: int = 256,
    num_runs: int = 3,
    chain: int = 4,
):
    """Dependency-chained throughput sweep: each timed run is ``chain``
    sampler calls at ``batch_size``, each fed the previous call's output,
    ended by a synchronise; the best run counts. A latent pipeline's decode
    of every chained output is timed too, so its img/s are pixels."""
    flow = getattr(model, "flow", model)
    decode = getattr(model, "decode", None) if model is not flow else None
    device = flow.device
    noise = _noise((batch_size, image_size, image_size, model.in_channels), 0, device)
    results = []
    for num_steps in steps_list:
        sampler = flow._get_sampler(num_steps, False, flow.sample_dtype)
        x = sampler(noise)  # warm-up
        if decode is not None:
            decode(x)
        _sync(device)

        times = []
        for _ in range(num_runs):
            t0 = time.perf_counter()
            x = noise
            for _ in range(chain):
                x = sampler(x)
                if decode is not None:
                    decode(x)
            _sync(device)
            times.append((time.perf_counter() - t0) / chain)
        best = min(times)
        results.append(
            {
                "num_steps": num_steps,
                "time_per_image": best / batch_size,
                "images_per_second": batch_size / best,
                "batch_size": batch_size,
            }
        )
    return results


def benchmark_quality(
    model,
    reference_images,
    num_steps: int,
    noise_shape=None,
    calc: Optional[MetricsCalculator] = None,
    ssim_cap: int = 0,
    n_boot: int = 64,
):
    """Quality against NHWC reference images in [-1, 1]: SSIM, LPIPS,
    raw-pixel FID and deep FID with its 95% bootstrap CI.

    ``noise_shape`` overrides the sampling noise's shape (latent pipelines
    draw latent-shaped noise and emit pixel images). ``lpips`` is the
    reference's row-paired statistic; ``lpips_to_ref`` / ``lpips_recall``
    the nearest-neighbour perceptual precision and recall. ``ssim_cap`` > 0
    limits the pairs that the host-side SSIM loop scores (``ssim_n``); the
    raw-pixel FID is capped at 512 images above 50k pixels a sample
    (``fid_simple_n``); FID and the set statistics use the full set.
    """
    device = _device(model)
    calc = calc if calc is not None else MetricsCalculator(device)
    n = reference_images.shape[0]
    shape = noise_shape or reference_images.shape
    # chunked sampling keeps device memory bounded at 256 px
    block = 256 if reference_images.shape[1] <= 64 else 64
    chunks = []
    for i in range(0, n, block):
        cur = min(block, n - i)
        noise = _noise((cur,) + tuple(shape[1:]), 7 * 1000003 + i, device)
        out = model.sample(noise=noise, num_steps=num_steps, data_format="NHWC")
        chunks.append(out.float().cpu().numpy())
    generated = np.concatenate(chunks)

    n_ssim = min(n, ssim_cap) if ssim_cap else n
    ref_np = ((reference_images[:n_ssim] + 1) / 2 * 255).astype(np.uint8)
    gen_np = ((np.clip(generated[:n_ssim], -1, 1) + 1) / 2 * 255).astype(np.uint8)
    ssim_scores = [calc.compute_ssim(ref_np[i], gen_np[i]) for i in range(n_ssim)]

    ref_nchw = np.transpose(np.asarray(reference_images), (0, 3, 1, 2))
    gen_nchw = np.transpose(generated, (0, 3, 1, 2))
    lpips_score = calc.compute_lpips(ref_nchw, gen_nchw)
    set_stats = calc.compute_lpips_set_stats(gen_nchw, ref_nchw)
    n_simple = min(n, 512) if ref_nchw[0].size > 50_000 else n
    fid = calc.compute_fid(ref_nchw[:n_simple], gen_nchw[:n_simple])
    deep = calc.compute_fid_deep_ci(ref_nchw, gen_nchw, n_boot=n_boot)

    return {
        "ssim_mean": float(np.mean(ssim_scores)),
        "ssim_std": float(np.std(ssim_scores)),
        "ssim_n": n_ssim,
        "lpips": lpips_score,
        "lpips_to_ref": set_stats["precision"],
        "lpips_to_ref_lo": set_stats["precision_lo"],
        "lpips_to_ref_hi": set_stats["precision_hi"],
        "lpips_recall": set_stats["recall"],
        "lpips_recall_lo": set_stats["recall_lo"],
        "lpips_recall_hi": set_stats["recall_hi"],
        "fid_simple": fid,
        "fid_simple_n": n_simple,
        "fid_deep": deep["fid"],
        "fid_deep_lo": deep["lo"],
        "fid_deep_hi": deep["hi"],
        "n_eval": n,
        "num_steps": num_steps,
    }


def _csv_value(v) -> str:
    """A cell as pandas' ``to_csv`` writes it: NaN and None empty, floats in
    repr form."""
    if v is None:
        return ""
    if isinstance(v, (float, np.floating)):
        return "" if np.isnan(v) else repr(float(v))
    if isinstance(v, np.integer):
        return str(int(v))
    return str(v)


def write_csv(path: Path, rows: List[Dict], columns: List[str]) -> None:
    """``rows`` as a CSV with a header of ``columns`` (what
    ``pd.DataFrame(rows)[columns].to_csv(path, index=False)`` writes)."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(columns)
        for row in rows:
            w.writerow([_csv_value(row.get(c)) for c in columns])


def _ci_bounds(row, col):
    """(lo, hi) bootstrap interval for ``col`` in a quality row, or None
    when the row predates the CI columns / the backbone was unavailable."""
    lo = row.get(f"{col}_lo", float("nan"))
    hi = row.get(f"{col}_hi", float("nan"))
    try:
        lo, hi = float(lo), float(hi)
    except (TypeError, ValueError):
        return None
    if np.isfinite(lo) and np.isfinite(hi):
        return lo, hi
    return None


def _beats_beyond_noise(a, b, col, rel_eps: float = 0.02) -> bool:
    """True when row ``a``'s (lower-is-better) ``col`` beats row ``b``'s
    beyond noise: disjoint bootstrap CIs when both rows carry them,
    otherwise a >``rel_eps`` relative margin (the tie tolerance for rows
    committed before the CI columns existed)."""
    ci_a, ci_b = _ci_bounds(a, col), _ci_bounds(b, col)
    if ci_a is not None and ci_b is not None:
        return ci_a[1] < ci_b[0]
    return a[col] < (1.0 - rel_eps) * b[col]


def judge_quality_claim(quality_rows):
    """Judge the reference's central claim on measured quality rows.

    The reference prints its quality-match claim unconditionally
    (reference: benchmark.py:287-306); here it must be SUPPORTED by the
    measured rows: best few-step (<=4) rectified FID within 10% (or SSIM
    within 0.02) of the many-step (>=64) base anchor. Judged on
    learned-feature ``fid_deep`` when the backbone is available (the
    production metric the reference's own comment points at, ref
    utils/metrics.py:84-88), raw-pixel ``fid_simple`` otherwise.

    Returns ``(claim_supported, fid_col, best_rect_row, anchor_row)``;
    ``claim_supported`` is None when there is no quality data to judge
    with (missing anchor or no few-step rectified rows).

    Anchor health (VERDICT r4 ask #3): a model whose many-step ODE solution
    is WORSE than its few-step output is degenerate in steps — "rect@4
    beats base@64" demonstrates nothing if base@64 is the base model's
    worst output. When another base row beats the many-step anchor beyond
    noise (CI-separated when CIs are present, else >2% relative), the
    claim is judged against base's BEST measured row instead, and the
    returned anchor carries ``degraded_from_steps``/``degraded_from_fid``
    so reports disclose the substitution.
    """
    anchor = next(
        (
            r for r in quality_rows
            if r["model"] == "base" and r["num_steps"] >= 64
        ),
        None,
    )
    rect_few = [
        r for r in quality_rows
        if r["model"] == "rectified" and r["num_steps"] <= 4
    ]
    if not (anchor and rect_few):
        return None, None, None, anchor
    fid_col = (
        "fid_deep"
        if np.isfinite(anchor.get("fid_deep", float("nan")))
        else "fid_simple"
    )
    base_rows = [
        r for r in quality_rows
        if r["model"] == "base"
        and np.isfinite(r.get(fid_col, float("nan")))
    ]
    best_base = min(base_rows, key=lambda r: r[fid_col], default=anchor)
    if best_base is not anchor and _beats_beyond_noise(
        best_base, anchor, fid_col
    ):
        anchor = dict(
            best_base,
            degraded_from_steps=anchor["num_steps"],
            degraded_from_fid=anchor[fid_col],
        )
    best_rect = min(rect_few, key=lambda r: r[fid_col])
    fid_ok = bool(best_rect[fid_col] <= 1.10 * anchor[fid_col])
    ssim_ok = bool(best_rect["ssim_mean"] >= anchor["ssim_mean"] - 0.02)
    claim_supported = fid_ok or ssim_ok
    # .basis records WHICH clause carried the verdict so reports can say
    # "matches (within the SSIM margin; an FID gap remains)" instead of an
    # unqualified claim when only the structural-similarity clause held
    best_rect = dict(best_rect, basis="fid" if fid_ok else "ssim")
    return claim_supported, fid_col, best_rect, anchor


def _load_model(cls, cfg: Config, path: Path, name: str, device):
    from rectified_flow_vision_tpu_torch.experiments.train_base import build_model

    model = build_model(cfg, cls, device=device)
    if cfg.benchmark.prefer_ema:
        ema_path = path.with_name(path.name.replace("_final", "_ema_final"))
        if ema_path.exists():
            model.load(str(ema_path))
            log.info("%s model loaded from EMA checkpoint %s", name, ema_path.name)
            return model
    if path.exists():
        model.load(str(path))
        model.untrained = False
        log.info("%s model loaded from checkpoint", name)
    else:
        model.untrained = True
        log.warning("WARNING: Using untrained %s model", name)
    return model


def guard_untrained_overwrite(untrained, results_dir, *, allow: bool):
    """Refuse to clobber existing benchmark artifacts with untrained models.

    Model checkpoints (.npz) are NOT tracked run evidence (too large; see
    .gitignore), so after a fresh checkout the trained weights behind the
    committed artifacts are gone. Without this guard a benchmark rerun on
    such a tree silently regenerates every artifact from random weights —
    base == rectified, noise-level metrics — and a careless commit
    destroys good evidence. The reference warns and continues
    (benchmark.py:52-60), which is safe only because its pipeline always
    trains immediately before benchmarking.
    """
    if not untrained or allow:
        return
    existing = [
        p.name
        for p in (
            results_dir / "quality_results.csv",
            results_dir / "benchmark_results.csv",
        )
        if p.exists()
    ]
    if existing:
        raise SystemExit(
            f"Refusing to overwrite existing artifacts ({', '.join(existing)} "
            f"in {results_dir}) with UNTRAINED model(s): "
            f"{', '.join(untrained)}. Train first (experiments.train_base / "
            "train_rectified) or set RFV_ALLOW_UNTRAINED=1 to proceed."
        )


def main(config: Optional[Config] = None, *, device: str | torch.device = "cuda") -> List[Dict]:
    """Benchmark entry point; returns the rows of ``benchmark_results.csv``.
    ``RFV_PROFILE=<dir>`` records a ``torch.profiler`` trace of the run."""
    profile_dir = os.environ.get("RFV_PROFILE")
    if profile_dir:
        from rectified_flow_vision_tpu_torch.utils.profiling import trace

        with trace(profile_dir):
            return _main_impl(config, device)
    return _main_impl(config, device)


def _main_impl(config: Optional[Config], device) -> List[Dict]:
    cfg = config if config is not None else load_config()
    device = resolve_device(device)
    root = config_lib.repo_root()

    checkpoint_dir = root / cfg.paths.checkpoints
    # RFV_RESULTS_DIR redirects every artifact of this run (a staging dir)
    results_dir = Path(os.environ.get("RFV_RESULTS_DIR") or (root / cfg.paths.results))
    results_dir.mkdir(parents=True, exist_ok=True)

    image_size = cfg.data.image_size
    num_samples = cfg.benchmark.num_samples
    steps_to_test = cfg.benchmark.steps_to_test
    num_runs = cfg.benchmark.num_runs

    log.info("Loading models...")
    base_model = _load_model(
        BaseFlowModel, cfg, checkpoint_dir / "base_flow_final.npz", "Base", device
    )
    rect_model = _load_model(
        RectifiedFlowModel, cfg, checkpoint_dir / "rectified_flow_k1_final.npz", "Rectified",
        device,
    )
    # guard the config's own results dir (not the staging override)
    guard_untrained_overwrite(
        [
            name
            for name, m in (("base", base_model), ("rectified", rect_model))
            if getattr(m, "untrained", False)
        ],
        root / cfg.paths.results,
        allow=bool(os.environ.get("RFV_ALLOW_UNTRAINED")),
    )

    # latent pipeline: the flow models run at latent resolution; grids and
    # quality go through the VAE decoder (pixel outputs)
    base_out, rect_out = base_model, rect_model
    latent = cfg.model.latent
    if latent:
        from rectified_flow_vision_tpu_torch.models import ConvVAE, LatentFlowPipeline

        vae_path = checkpoint_dir / "vae.npz"
        if vae_path.exists():
            vae = ConvVAE.load(str(vae_path), device=device)
        else:
            log.warning(
                "VAE checkpoint not found at %s — using an UNTRAINED "
                "decoder (results will be meaningless)", vae_path,
            )
            vae = ConvVAE(
                image_size=cfg.data.image_size,
                latent_channels=cfg.model.latent_channels,
                downsample=cfg.model.latent_downsample,
                device=device,
            )
        base_out = LatentFlowPipeline(base_model, vae)
        rect_out = LatentFlowPipeline(rect_model, vae)
        image_size = base_model.image_size  # sweep at latent resolution

    # ---- speed ------------------------------------------------------------
    log.info("=" * 60)
    log.info("SPEED BENCHMARK")
    log.info("=" * 60)
    log.info("Samples: %d, Steps: %s, Runs: %d", num_samples, steps_to_test, num_runs)

    log.info("Benchmarking BASE model (latency, batch 4)...")
    base_latency = benchmark_speed(base_out, num_samples, steps_to_test, image_size, num_runs)
    log.info("Benchmarking RECTIFIED model (latency, batch 4)...")
    rect_latency = benchmark_speed(rect_out, num_samples, steps_to_test, image_size, num_runs)

    tput_batch = cfg.benchmark.throughput_batch
    if tput_batch:
        log.info("Benchmarking throughput (chained, batch %d)...", tput_batch)
        base_results = benchmark_throughput(
            base_out, steps_to_test, image_size, tput_batch, num_runs=num_runs
        )
        rect_results = benchmark_throughput(
            rect_out, steps_to_test, image_size, tput_batch, num_runs=num_runs
        )
    else:
        base_results, rect_results = base_latency, rect_latency

    log.info("-" * 60)
    log.info("%-10s %-18s %-18s %-10s", "Steps", "Base (ms/img)", "Rect (ms/img)", "Speedup")
    log.info("-" * 60)
    for base_r, rect_r in zip(base_results, rect_results):
        base_time = base_r["time_per_image"] * 1000
        rect_time = rect_r["time_per_image"] * 1000
        speedup = base_time / rect_time if rect_time > 0 else 0
        log.info("%-10d %-18.2f %-18.2f %-10.2fx", base_r["num_steps"], base_time, rect_time,
                 speedup)

    # ---- few-step sample grids ---------------------------------------------
    log.info("=" * 60)
    log.info("KEY COMPARISON: GENERATION WITH FEW STEPS")
    log.info("=" * 60)

    few_steps = [1, 2, 4, 8]
    noise_test = _noise((8, image_size, image_size, base_model.in_channels), 3, device)
    for steps in few_steps:
        log.info("Generating with %d step(s)...", steps)
        base_samples = base_out.sample(noise=noise_test, num_steps=steps, data_format="NHWC")
        rect_samples = rect_out.sample(noise=noise_test, num_steps=steps, data_format="NHWC")
        plot_generated_samples(
            base_samples[:4].cpu().numpy(),
            title=f"Base Model - {steps} steps",
            save_path=str(results_dir / f"base_samples_{steps}steps.png"),
            data_format="NHWC",
        )
        plot_generated_samples(
            rect_samples[:4].cpu().numpy(),
            title=f"Rectified Model - {steps} steps",
            save_path=str(results_dir / f"rect_samples_{steps}steps.png"),
            data_format="NHWC",
        )

    # ---- quality -------------------------------------------------------------
    quality_rows: List[Dict] = []
    if cfg.metrics.compute_ssim or cfg.metrics.compute_lpips or cfg.metrics.compute_fid:
        from rectified_flow_vision_tpu_torch.data import ImageDataset, eval_reference_images

        data_dir = root / cfg.data.data_dir
        # references at pixel resolution: in the latent pipeline `image_size`
        # is the latent sweep's, but quality compares decoded pixels
        n_q = cfg.benchmark.quality_samples
        if cfg.benchmark.heldout_reference:
            ref_imgs = eval_reference_images(cfg.data.image_size, n_q)
            log.info("Quality references: %d held-out eval images (data/eval_%d)",
                     len(ref_imgs), cfg.data.image_size)
        else:
            ds = ImageDataset(str(data_dir), cfg.data.image_size) if data_dir.exists() else None
            ref_imgs = ds.images[: min(len(ds), n_q)] if ds is not None and len(ds) >= 8 else None
        if ref_imgs is not None and len(ref_imgs) >= 8:
            calc = MetricsCalculator(device)
            ssim_cap = cfg.benchmark.ssim_samples
            if ssim_cap and ssim_cap < len(ref_imgs):
                log.info(
                    "SSIM capped at %d of %d pairs (ssim_samples); FID and "
                    "set statistics use the full set", ssim_cap, len(ref_imgs),
                )
            q_noise_shape = (
                (ref_imgs.shape[0], image_size, image_size, base_model.in_channels)
                if latent
                else None
            )
            for steps in few_steps:
                q_base = benchmark_quality(base_out, ref_imgs, steps, noise_shape=q_noise_shape,
                                           calc=calc, ssim_cap=ssim_cap)
                q_rect = benchmark_quality(rect_out, ref_imgs, steps, noise_shape=q_noise_shape,
                                           calc=calc, ssim_cap=ssim_cap)
                quality_rows.append({"num_steps": steps, "model": "base", **q_base})
                quality_rows.append({"num_steps": steps, "model": "rectified", **q_rect})
            # the many-step base anchor the conclusions judge against
            many = max((s for s in steps_to_test if s >= 64), default=64)
            quality_rows.append(
                {
                    "num_steps": many,
                    "model": "base",
                    **benchmark_quality(base_out, ref_imgs, many, noise_shape=q_noise_shape,
                                        calc=calc, ssim_cap=ssim_cap),
                }
            )
            log.info("Quality metrics computed for steps %s + base@%d", few_steps, many)

    # ---- persist ------------------------------------------------------------
    log.info("=" * 60)
    log.info("SAVING RESULTS")
    log.info("=" * 60)

    rows = []
    for i, (base_r, rect_r) in enumerate(zip(base_results, rect_results)):
        row = {
            "num_steps": base_r["num_steps"],
            "base_time_ms": base_r["time_per_image"] * 1000,
            "rect_time_ms": rect_r["time_per_image"] * 1000,
            "base_img_per_sec": base_r["images_per_second"],
            "rect_img_per_sec": rect_r["images_per_second"],
        }
        row["speedup"] = row["base_time_ms"] / row["rect_time_ms"]
        if tput_batch:
            # the reference methodology's batch-4 latency, kept beside the
            # chained sweep's primary columns: it measures per-call dispatch
            row["base_dispatch_bound_ms_b4"] = base_latency[i]["time_per_image"] * 1000
            row["rect_dispatch_bound_ms_b4"] = rect_latency[i]["time_per_image"] * 1000
        rows.append(row)

    csv_path = results_dir / "benchmark_results.csv"
    write_csv(csv_path, rows, SPEED_COLUMNS + (LATENCY_COLUMNS if tput_batch else []))
    log.info("Results saved to: %s", csv_path)

    if quality_rows:
        write_csv(results_dir / "quality_results.csv", quality_rows, QUALITY_COLUMNS)

    all_results = {"base_model": base_results, "rectified_model": rect_results}
    plot_speed_comparison(all_results, save_path=str(results_dir / "speed_comparison.png"))
    create_summary_report(all_results, str(results_dir))

    if quality_rows:
        speed_by_steps = {r["num_steps"]: r["images_per_second"] for r in rect_results}
        rect_q_steps = {r["num_steps"] for r in quality_rows if r["model"] == "rectified"}
        # only steps quality-measured for both models
        q_steps = [
            r["num_steps"] for r in quality_rows
            if r["model"] == "base"
            and r["num_steps"] in speed_by_steps
            and r["num_steps"] in rect_q_steps
        ]
        quality_payload = {
            "base_model": [
                {"num_steps": s, "images_per_second": next(
                    br["images_per_second"] for br in base_results if br["num_steps"] == s)}
                for s in q_steps
            ],
            "rectified_model": [
                {"num_steps": s, "images_per_second": speed_by_steps[s]} for s in q_steps
            ],
            "quality": {
                "base_model": [
                    r["fid_simple"] for r in quality_rows
                    if r["model"] == "base" and r["num_steps"] in q_steps
                ],
                "rectified_model": [
                    r["fid_simple"] for r in quality_rows
                    if r["model"] == "rectified" and r["num_steps"] in q_steps
                ],
            },
        }
        plot_quality_vs_speed(quality_payload, quality_metric="fid",
                              save_path=str(results_dir / "quality_vs_speed.png"))

    traj_noise = _noise((1, image_size, image_size, base_model.in_channels), 11, device)
    base_traj = base_model.sample_with_trajectory(traj_noise, num_steps=20, save_every=5,
                                                  data_format="NHWC")
    rect_traj = rect_model.sample_with_trajectory(traj_noise, num_steps=20, save_every=5,
                                                  data_format="NHWC")
    if latent:  # decode each latent frame for the pixel strips
        base_traj = [base_out.decode(s) for s in base_traj]
        rect_traj = [rect_out.decode(s) for s in rect_traj]
    plot_trajectory_comparison(
        [s.cpu().numpy() for s in base_traj],
        [s.cpu().numpy() for s in rect_traj],
        save_path=str(results_dir / "trajectory_comparison.png"),
        data_format="NHWC",
    )

    log.info("=" * 60)
    log.info("CONCLUSIONS")
    log.info("=" * 60)

    write_conclusions(quality_rows, base_results, rect_results, results_dir)

    log.info("All results in: %s", results_dir)
    return rows


def conclusion_lines_for(quality_rows, base_results, rect_results):
    """The measured-conclusions text for a run's (quality, timing) rows.

    Pure: rows are plain dicts (num_steps / time_per_image /
    images_per_second for timing; the quality CSV columns for quality), so
    the same verdict can be re-derived offline from committed CSVs
    (tools/append_conclusions.py)."""

    def timing_at(rows, steps):
        return next((r for r in rows if r["num_steps"] == steps), None)

    lines = []

    def conclude(msg, *fmt_args):
        lines.append(msg % fmt_args if fmt_args else msg)

    claim_supported, fid_col, best_rect, anchor = judge_quality_claim(
        quality_rows
    )
    # the headline speedup is computed from the SAME rows that carry the
    # quality verdict (ADVICE r4: a rect@1-vs-base@64 figure under a
    # rect@4-vs-base@100 quality claim overstates the quality-matched
    # speedup ~2x); without a verdict, fall back to the step-count framing
    # with the pairing spelled out. The timing sweep may also stop short
    # of the anchor step count (dit256 times 1-32 but anchors quality at
    # base@64) — then the claim is still judged, only the figure omitted.
    if best_rect and anchor:
        rect_t = timing_at(rect_results, best_rect["num_steps"])
        base_t = timing_at(base_results, anchor["num_steps"])
        speedup_pair = (best_rect["num_steps"], anchor["num_steps"])
    else:
        rect_t = next((r for r in rect_results if r["num_steps"] <= 4), None)
        base_t = next((r for r in base_results if r["num_steps"] >= 64), None)
        speedup_pair = (
            (rect_t["num_steps"], base_t["num_steps"])
            if rect_t and base_t
            else None
        )
    total_speedup = (
        base_t["time_per_image"] / rect_t["time_per_image"]
        if rect_t and base_t
        else None
    )
    if anchor and best_rect:
        def _ci(row):
            lo, hi = row.get("fid_deep_lo"), row.get("fid_deep_hi")
            if (
                fid_col == "fid_deep"
                and lo is not None
                and np.isfinite(lo)
                and np.isfinite(hi)
            ):
                return f" [{lo:.1f}, {hi:.1f}]"
            return ""

        n_eval = best_rect.get("n_eval")
        n_part = (
            f", n={int(n_eval)}"
            if n_eval is not None and np.isfinite(float(n_eval)) and n_eval
            else ""
        )
        conclude(
            "Measured quality (%s%s): rect@%d FID %.1f%s / SSIM %.3f vs "
            "base@%d FID %.1f%s / SSIM %.3f",
            fid_col, n_part,
            best_rect["num_steps"], best_rect[fid_col], _ci(best_rect),
            best_rect["ssim_mean"], anchor["num_steps"],
            anchor[fid_col], _ci(anchor), anchor["ssim_mean"],
        )
        if anchor.get("degraded_from_steps") is not None:
            # VERDICT r4 ask #3: never judge against a degenerate
            # many-step anchor silently — disclose the substitution
            conclude(
                "Anchor note: base quality DEGRADES with steps on this run "
                "(base@%d %s %.1f is worse than base@%d %.1f), so the claim "
                "is judged against base's best measured step count instead "
                "of the degenerate many-step anchor.",
                anchor["degraded_from_steps"], fid_col,
                anchor["degraded_from_fid"],
                anchor["num_steps"], anchor[fid_col],
            )
        # metric-disagreement disclosure (the two perceptual statistics
        # measure different failure modes: fid_deep is distributional,
        # lpips_to_ref is precision-only and blind to mode collapse) —
        # reports must say when they rank the winner differently. Fires
        # only when BOTH metrics support a direction beyond noise
        # (CI-separated when the run carries CI columns, else a >2%
        # relative margin): a 1e-5 precision delta is a tie, not a
        # disagreement (VERDICT r4 ask #6 / ADVICE r4).
        def _direction(col):
            if _beats_beyond_noise(best_rect, anchor, col):
                return "rectified"
            if _beats_beyond_noise(anchor, best_rect, col):
                return "base"
            return None

        prec_r = best_rect.get("lpips_to_ref", float("nan"))
        prec_a = anchor.get("lpips_to_ref", float("nan"))
        if np.isfinite(prec_r) and np.isfinite(prec_a):
            fid_dir = _direction(fid_col)
            prec_dir = _direction("lpips_to_ref")
            if fid_dir and prec_dir and fid_dir != prec_dir:
                conclude(
                    "Metric disagreement (both beyond noise): %s favors %s "
                    "while perceptual precision (lpips_to_ref %.4f vs %.4f) "
                    "favors %s — precision is blind to coverage; see the "
                    "lpips_recall column for the coverage direction.",
                    fid_col, fid_dir, prec_r, prec_a, prec_dir,
                )
    if claim_supported:
        qualifier = (
            " (measured above)."
            if best_rect.get("basis") == "fid"
            else " within the measured SSIM margin (an FID gap remains, "
            "see quality_results.csv)."
        )
        conclude(
            "The RECTIFIED model with %d steps matches the quality of "
            "the BASE model with %d+ steps%s",
            best_rect["num_steps"], anchor["num_steps"], qualifier,
        )
        if total_speedup is not None:
            conclude(
                "Measured quality-matched speedup: %.1fx faster "
                "(rect@%d vs base@%d, the rows that carried the claim)",
                total_speedup, *speedup_pair,
            )
    elif claim_supported is None:
        if total_speedup is not None:
            conclude(
                "Step-count speedup rect@%d vs base@%d is %.1fx; no "
                "quality rows were computed, so no quality-match claim "
                "is made.",
                speedup_pair[0], speedup_pair[1], total_speedup,
            )
    else:
        conclude(
            "Few-step rectified quality does NOT yet match the "
            "many-step base on this run (see quality_results.csv)%s",
            f"; the {total_speedup:.1f}x step-count speedup "
            f"(rect@{speedup_pair[0]} vs base@{speedup_pair[1]}) is "
            "reported without a quality-parity claim."
            if total_speedup is not None
            else ".",
        )

    best = max(
        (r["images_per_second"] for r in rect_results if r["num_steps"] <= 4),
        default=None,
    )
    if best is not None:
        conclude("Peak few-step throughput: %.1f images/sec/chip", best)
    return lines


def write_conclusions(quality_rows, base_results, rect_results, results_dir):
    """Log the measured conclusions and mirror them into the committed
    report artifact so the quality-claim verdict travels with the run,
    not just the log (the reference's report carries only the per-step
    speedup table, visualization.py:210-258). Idempotent: an existing
    section is replaced, not duplicated."""
    lines = conclusion_lines_for(quality_rows, base_results, rect_results)
    for line in lines:
        log.info("%s", line)
    report_path = results_dir / "benchmark_report.txt"
    if not (report_path.exists() and lines):
        return
    header = "MEASURED QUALITY CONCLUSIONS"
    text = report_path.read_text()
    if header in text:
        text = text[: text.index("\n" + header)].rstrip("\n") + "\n"
    with open(report_path, "w") as f:
        f.write(text)
        f.write("\n" + header + "\n")
        f.write("-" * 40 + "\n")
        for line in lines:
            f.write(line + "\n")


def _cli() -> None:
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--config", default=None, metavar="YAML",
        help="config file (default: configs/config.yaml)",
    )
    args = parser.parse_args()
    main(load_config(args.config) if args.config else None)


if __name__ == "__main__":
    _cli()

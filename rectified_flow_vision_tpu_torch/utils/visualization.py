"""Result figures and the text report of the benchmark.

Counterpart of the JAX package's ``utils/visualization.py``: the 2-panel
speed figure (ms/img over log2 steps and per-step speedup bars), sample
grids from [-1, 1] images, the quality-vs-speed scatter, trajectory strips,
and ``benchmark_report.txt`` with the per-step table and the average,
largest and smallest speedup.

This is host-side output, not a device path. matplotlib is imported where a
figure is drawn, on the headless Agg backend; where it is not installed each
figure logs one warning naming the file it did not write, and the run goes
on: the CSVs and ``benchmark_report.txt`` carry every number.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from rectified_flow_vision_tpu_torch.utils.logging_config import get_logger

log = get_logger("flow_vision.visualization")


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _pyplot(save_path: Optional[str]):
    """matplotlib's pyplot on the headless Agg backend with the reference's
    style (reference: visualization.py:14-20), or None, after one warning
    naming the figure that is not written, where matplotlib is absent."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        log.warning(
            "matplotlib is not installed: %s not written (the CSVs and "
            "benchmark_report.txt carry every number)", save_path,
        )
        return None
    try:
        plt.style.use("seaborn-v0_8-whitegrid")
    except OSError:
        pass
    plt.rcParams["figure.figsize"] = (10, 6)
    plt.rcParams["font.size"] = 12
    plt.rcParams["axes.labelsize"] = 14
    plt.rcParams["axes.titlesize"] = 16
    return plt


def _save(plt, fig, save_path: Optional[str]) -> None:
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
        print(f"Figure saved to: {save_path}")
    plt.close(fig)


def plot_speed_comparison(results: Dict, save_path: Optional[str] = None) -> None:
    """Two panels: ms/img vs steps (log2 x) and per-step speedup bars."""
    plt = _pyplot(save_path)
    if plt is None:
        return
    fig, axes = plt.subplots(1, 2, figsize=(14, 5))

    base_steps = [r["num_steps"] for r in results["base_model"]]
    base_times = [r["time_per_image"] * 1000 for r in results["base_model"]]
    rect_times = [r["time_per_image"] * 1000 for r in results["rectified_model"]]

    ax1 = axes[0]
    ax1.plot(base_steps, base_times, "o-", label="Base Model", linewidth=2, markersize=8)
    ax1.plot(base_steps, rect_times, "s-", label="Rectified Model", linewidth=2, markersize=8)
    ax1.set_xlabel("Number of Integration Steps")
    ax1.set_ylabel("Time per Image (ms)")
    ax1.set_title("Generation Speed")
    ax1.legend()
    ax1.set_xscale("log", base=2)
    ax1.grid(True, alpha=0.3)

    ax2 = axes[1]
    speedup = [b / r for b, r in zip(base_times, rect_times)]
    colors = ["green" if s > 1 else "red" for s in speedup]
    ax2.bar(range(len(base_steps)), speedup, color=colors, alpha=0.7)
    ax2.axhline(y=1, color="black", linestyle="--", linewidth=1)
    ax2.set_xticks(range(len(base_steps)))
    ax2.set_xticklabels(base_steps)
    ax2.set_xlabel("Number of Steps")
    ax2.set_ylabel("Speedup (Base / Rectified)")
    ax2.set_title("Rectified Model Speedup")
    ax2.grid(True, alpha=0.3, axis="y")

    fig.tight_layout()
    _save(plt, fig, save_path)


def plot_quality_vs_speed(
    results: Dict, quality_metric: str = "fid", save_path: Optional[str] = None
) -> None:
    """Quality/speed trade-off scatter (reference: visualization.py:74-110)."""
    plt = _pyplot(save_path)
    if plt is None:
        return
    fig, ax = plt.subplots(figsize=(10, 6))

    if "quality" in results:
        base_quality = results["quality"]["base_model"]
        rect_quality = results["quality"]["rectified_model"]
        base_speed = [r["images_per_second"] for r in results["base_model"]]
        rect_speed = [r["images_per_second"] for r in results["rectified_model"]]

        ax.scatter(base_speed, base_quality, s=100, label="Base Model", alpha=0.7)
        ax.scatter(rect_speed, rect_quality, s=100, label="Rectified Model", alpha=0.7)
        ax.set_xlabel("Images per Second")
        ax.set_ylabel(f"{quality_metric.upper()} Score")
        ax.set_title("Trade-off: Quality vs Speed")
        ax.legend()
    else:
        ax.text(
            0.5, 0.5, "No quality data available",
            ha="center", va="center", transform=ax.transAxes,
        )

    _save(plt, fig, save_path)


def plot_generated_samples(
    samples,
    title: str = "Generated Samples",
    nrow: int = 4,
    save_path: Optional[str] = None,
    data_format: str = "NCHW",
) -> None:
    """Grid of generated images; input in [-1, 1]."""
    plt = _pyplot(save_path)
    if plt is None:
        return
    samples = _to_numpy(samples)
    if data_format.upper() == "NCHW":
        samples = np.transpose(samples, (0, 2, 3, 1))

    samples = np.clip((samples + 1.0) / 2.0, 0.0, 1.0)

    n_samples = min(samples.shape[0], nrow * nrow)
    ncol = nrow
    nrow_actual = -(-n_samples // ncol)

    fig, axes = plt.subplots(nrow_actual, ncol, figsize=(ncol * 2, nrow_actual * 2))
    axes = np.atleast_2d(axes)
    for i in range(nrow_actual * ncol):
        ax = axes[i // ncol, i % ncol]
        if i < n_samples:
            ax.imshow(samples[i])
        ax.axis("off")

    fig.suptitle(title, fontsize=16)
    fig.tight_layout()
    _save(plt, fig, save_path)


def plot_trajectory_comparison(
    base_trajectories: List,
    rect_trajectories: List,
    save_path: Optional[str] = None,
    data_format: str = "NCHW",
) -> None:
    """Side-by-side trajectory strips (reference: visualization.py:161-207)."""
    plt = _pyplot(save_path)
    if plt is None:
        return
    fig, axes = plt.subplots(2, len(base_trajectories), figsize=(15, 6))

    def prep(img):
        img = _to_numpy(img)[0]
        if data_format.upper() == "NCHW":
            img = np.transpose(img, (1, 2, 0))
        return np.clip((img + 1.0) / 2.0, 0.0, 1.0)

    for i, (base_img, rect_img) in enumerate(zip(base_trajectories, rect_trajectories)):
        axes[0, i].imshow(prep(base_img))
        axes[0, i].axis("off")
        axes[1, i].imshow(prep(rect_img))
        axes[1, i].axis("off")
        t = i / max(len(base_trajectories) - 1, 1)
        axes[0, i].set_title(f"t={t:.2f}")

    fig.suptitle("Trajectory Comparison", fontsize=16)
    fig.tight_layout()
    _save(plt, fig, save_path)


def create_summary_report(results: Dict, save_dir: str) -> None:
    """Text report + speed figure (reference: visualization.py:210-258)."""
    os.makedirs(save_dir, exist_ok=True)

    report_path = os.path.join(save_dir, "benchmark_report.txt")
    with open(report_path, "w") as f:
        f.write("=" * 60 + "\n")
        f.write("BENCHMARK REPORT: FLOW DISTILLATION\n")
        f.write("=" * 60 + "\n\n")

        f.write("SPEED COMPARISON\n")
        f.write("-" * 40 + "\n")
        f.write(
            f"{'Steps':<10} {'Base (ms/img)':<15} {'Rect (ms/img)':<15} {'Speedup':<10}\n"
        )
        f.write("-" * 40 + "\n")

        speedups = []
        for base_r, rect_r in zip(results["base_model"], results["rectified_model"]):
            steps = base_r["num_steps"]
            base_time = base_r["time_per_image"] * 1000
            rect_time = rect_r["time_per_image"] * 1000
            speedup = base_time / rect_time if rect_time > 0 else 0
            if rect_r["time_per_image"] > 0:
                speedups.append(base_r["time_per_image"] / rect_r["time_per_image"])
            f.write(f"{steps:<10} {base_time:<15.2f} {rect_time:<15.2f} {speedup:<10.2f}x\n")

        f.write("\n" + "=" * 60 + "\n")
        f.write("CONCLUSIONS\n")
        f.write("-" * 40 + "\n")
        if speedups:
            f.write(f"Average speedup: {np.mean(speedups):.2f}x\n")
            f.write(f"Maximum speedup: {max(speedups):.2f}x\n")
            f.write(f"Minimum speedup: {min(speedups):.2f}x\n")

    print(f"Report saved to: {report_path}")
    plot_speed_comparison(results, os.path.join(save_dir, "speed_comparison.png"))

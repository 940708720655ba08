"""The complete Flow Distillation pipeline on the PyTorch / CUDA port.

    python -m rectified_flow_vision_tpu_torch                    # full pipeline
    python -m rectified_flow_vision_tpu_torch --skip-training    # benchmark only
    python -m rectified_flow_vision_tpu_torch --skip-download    # keep existing data
    python -m rectified_flow_vision_tpu_torch --quick            # reduced demo config
    python -m rectified_flow_vision_tpu_torch --offline          # synthetic data
    python -m rectified_flow_vision_tpu_torch --config configs/config_dit256.yaml

Counterpart of the repo's root ``main.py``, with the same flags and steps:
1) download or generate the data, 2) train the base flow model, 3) train the
rectified model (Reflow), 4) the comparative benchmark and its report. With
``--quick`` the overlay config is written to ``configs/config_quick.yaml``
and used. The pipeline runs on the card; ``main(argv, device="cpu")`` runs
the plain PyTorch path on the CPU, for tests.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from rectified_flow_vision_tpu_torch import config as config_lib
from rectified_flow_vision_tpu_torch.config import QUICK_CONFIG_PATH, load_config, quick_overlay
from rectified_flow_vision_tpu_torch.models.base_flow import resolve_device
from rectified_flow_vision_tpu_torch.utils.logging_config import get_logger

log = get_logger("flow_vision.main")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Flow Distillation - Complete Pipeline (PyTorch / CUDA)"
    )
    parser.add_argument(
        "--skip-training", action="store_true", help="Skip training and only run benchmark"
    )
    parser.add_argument("--skip-download", action="store_true", help="Skip data download")
    parser.add_argument(
        "--quick", action="store_true", help="Quick mode with fewer epochs for demo"
    )
    parser.add_argument(
        "--offline", action="store_true", help="Use synthetic data without internet connection"
    )
    parser.add_argument(
        "--config", default=None, metavar="YAML",
        help="Config file (default: configs/config.yaml); e.g. "
        "configs/config_cifar32.yaml or configs/config_dit256.yaml",
    )
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None, *, device: str | torch.device = "cuda") -> None:
    args = parse_args(argv)
    device = resolve_device(device)

    log.info("=" * 60)
    log.info("   FLOW DISTILLATION - Rectified Flow Testing (PyTorch / CUDA)")
    log.info("=" * 60)
    if device.type == "cuda":
        log.info("Device: %s (%d visible)", torch.cuda.get_device_name(device),
                 torch.cuda.device_count())
    else:
        log.info("Device: %s (the plain PyTorch path)", device)

    config = load_config(args.config)
    if args.quick:
        log.info("QUICK MODE activated - Reduced configuration for demo")
        config = quick_overlay(config)
        config.save(QUICK_CONFIG_PATH)  # written and used

    # STEP 1: data
    if not args.skip_download:
        log.info("=" * 60)
        log.info("STEP 1: Preparing test data")
        log.info("=" * 60)
        from rectified_flow_vision_tpu_torch.utils.download_data import download_data

        download_data(use_online=not args.offline, config_path=args.config)

    # STEP 2 + 3: training
    if not args.skip_training:
        log.info("=" * 60)
        log.info("STEP 2: Training base Flow model")
        log.info("=" * 60)
        from rectified_flow_vision_tpu_torch.experiments.train_base import main as train_base

        train_base(config, device=device)

        log.info("=" * 60)
        log.info("STEP 3: Training rectified Flow model (Reflow)")
        log.info("=" * 60)
        from rectified_flow_vision_tpu_torch.experiments.train_rectified import (
            main as train_rectified,
        )

        train_rectified(config, device=device)

    # STEP 4: benchmark
    log.info("=" * 60)
    log.info("STEP 4: Running comparative benchmark")
    log.info("=" * 60)
    from rectified_flow_vision_tpu_torch.experiments.benchmark import main as benchmark

    benchmark(config, device=device)

    log.info("=" * 60)
    log.info("   PIPELINE COMPLETED")
    log.info("=" * 60)
    root = config_lib.repo_root()
    log.info(
        "\nGenerated files:\n\n"
        "Checkpoints:\n"
        "   %s/\n"
        "   |- base_flow_final.npz          (Base model)\n"
        "   |- rectified_flow_k1_final.npz  (Rectified model)\n\n"
        "Results:\n"
        "   %s/\n"
        "   |- benchmark_results.csv        (Numerical data)\n"
        "   |- quality_results.csv          (SSIM/LPIPS/FID per step count)\n"
        "   |- speed_comparison.png         (Speed comparison plot)\n"
        "   |- benchmark_report.txt         (Text report)\n"
        "   |- *_samples_*.png              (Generated samples)\n",
        root / config.paths.checkpoints,
        root / config.paths.results,
    )
    log.info("Experiment completed successfully!")

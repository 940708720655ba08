"""Train the rectified (Reflow) model: the second training stage.

Counterpart of the JAX package's ``experiments/train_rectified.py``: load the
trained base checkpoint (its EMA when ``teacher_use_ema`` and it exists; a
fresh model with a warning when there is none) -> one Reflow round (teacher
pair synthesis, student training, ``rectified_flow_k1_*``) -> with
``num_reflow_iterations`` K > 1, K more rounds of ``iterative_reflow``
(``reflow_k{k}_*``) -> the straightness of base and student. Latent configs
build data-side pairs from the corpus encoded through the trained ConvVAE.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from rectified_flow_vision_tpu_torch import config as config_lib
from rectified_flow_vision_tpu_torch.config import Config, load_config
from rectified_flow_vision_tpu_torch.experiments.train_base import (
    build_model,
    default_mesh,
    encode_dataset,
    ensure_vae,
)
from rectified_flow_vision_tpu_torch.models import (
    RectifiedFlowModel,
    generate_reflow_pairs,
    iterative_reflow,
    train_rectified_flow,
)
from rectified_flow_vision_tpu_torch.models.base_flow import resolve_device
from rectified_flow_vision_tpu_torch.parallel import mesh as mesh_lib
from rectified_flow_vision_tpu_torch.utils import checkpoint as ckpt_io
from rectified_flow_vision_tpu_torch.utils.logging_config import get_logger

log = get_logger("flow_vision.train_rectified")


def _resolve_teacher_path(cfg: Config, checkpoint_dir: Path) -> Path:
    """``base_flow_ema_final.npz`` when it exists and ``teacher_use_ema`` is
    set (the benchmark's base@100 anchor evaluates the EMA weights under
    ``benchmark.prefer_ema``), else ``base_flow_final.npz``."""
    ema_path = checkpoint_dir / "base_flow_ema_final.npz"
    if cfg.training_rectified.teacher_use_ema and ema_path.exists():
        return ema_path
    return checkpoint_dir / "base_flow_final.npz"


def _flow_space_corpus(cfg: Config, checkpoint_dir: Path, device) -> np.ndarray:
    """The training corpus in the flow model's space (NHWC numpy): the
    images, or for latent configs their encoding through the trained VAE."""
    from rectified_flow_vision_tpu_torch.data import ImageDataset

    data_dir = config_lib.repo_root() / cfg.data.data_dir
    dataset = ImageDataset(str(data_dir), cfg.data.image_size)
    if cfg.model.latent:
        vae = ensure_vae(cfg, dataset, checkpoint_dir, device=device)
        return encode_dataset(vae, dataset.images).images
    return dataset.images


def main(
    config: Optional[Config] = None, *, mesh=None, device: str | torch.device = "cuda"
) -> RectifiedFlowModel:
    cfg = config if config is not None else load_config()
    device = resolve_device(device)
    if mesh is None:
        mesh = default_mesh(cfg, device)

    checkpoint_dir = config_lib.repo_root() / cfg.paths.checkpoints
    checkpoint_dir.mkdir(parents=True, exist_ok=True)

    base_path = _resolve_teacher_path(cfg, checkpoint_dir)
    base_model = build_model(cfg, device=device)
    if base_path.exists():
        log.info("Loading base model from: %s", base_path)
        base_model.load(str(base_path))
    else:
        log.warning(
            "Trained base model not found (%s). Run train_base first. "
            "Using an untrained base model for demo...",
            base_path,
        )

    log.info("=" * 60)
    log.info("TRAINING RECTIFIED MODEL (Single Reflow)")
    log.info("=" * 60)

    tr = cfg.training_rectified
    rect_model = RectifiedFlowModel.from_base_model(base_model, copy_weights=tr.init_from_teacher)

    # the 0-defaults reproduce the reference's formulas
    num_pairs = tr.num_pairs or min(1000, cfg.data.num_mock_images * 10)
    teacher_steps = tr.teacher_steps or cfg.training_base.num_timesteps // 10
    data_frac = tr.data_pair_fraction
    real_data = _flow_space_corpus(cfg, checkpoint_dir, device) if data_frac > 0 else None
    x0_data, x1_data = generate_reflow_pairs(
        base_model,
        num_pairs=num_pairs,
        num_steps=teacher_steps,
        data_format="NHWC",
        batch_size=tr.pair_batch_size,
        method=tr.teacher_method,
        real_data=real_data,
        data_pair_fraction=data_frac,
        mesh=mesh,
    )

    losses = train_rectified_flow(
        model=rect_model,
        x0_data=x0_data,
        x1_data=x1_data,
        epochs=tr.epochs,
        batch_size=tr.batch_size,
        lr=tr.learning_rate,
        save_path=str(checkpoint_dir / "rectified_flow_k1"),
        save_every=tr.save_every,
        data_format="NHWC",
        mesh=mesh,
        resume_dir=str(checkpoint_dir / "state_rectified_k1") if tr.resume else None,
        fsdp=cfg.parallel.fsdp,
        ema_decay=tr.ema_decay or None,
        time_sampling=tr.time_sampling,
    )

    if mesh_lib.writes_files():
        np.save(str(checkpoint_dir / "rectified_flow_k1_losses.npy"), losses)

    if tr.ema_decay:
        # the production sampling weights: the benchmark evaluates the
        # *_ema_final checkpoint under benchmark.prefer_ema, and the
        # straightness report below reads the same
        rect_model.params = ckpt_io.load_params(
            str(checkpoint_dir / "rectified_flow_k1_ema_final.npz")
        )[0]

    if tr.num_reflow_iterations > 1:
        log.info("=" * 60)
        log.info("TRAINING ITERATIVE REFLOW (K=%d)", tr.num_reflow_iterations)
        log.info("=" * 60)
        models = iterative_reflow(
            initial_model=base_model,
            num_iterations=tr.num_reflow_iterations,
            epochs_per_iter=tr.epochs // tr.num_reflow_iterations,
            num_pairs=num_pairs,
            teacher_steps=teacher_steps,
            lr=tr.learning_rate,
            save_dir=str(checkpoint_dir),
            mesh=mesh,
            fsdp=cfg.parallel.fsdp,
            pair_batch_size=tr.pair_batch_size,
            init_from_teacher=tr.init_from_teacher,
            teacher_method=tr.teacher_method,
            time_sampling=tr.time_sampling,
            ema_decay=tr.ema_decay or None,
            real_data=real_data,
            data_pair_fraction=data_frac,
        )
        log.info("Created %d iteratively rectified models", len(models))

    log.info("Reflow training completed!")
    log.info("Model saved to: %s", checkpoint_dir / "rectified_flow_k1_final.npz")

    log.info("Comparing trajectory straightness...")
    gen = torch.Generator(device=device).manual_seed(42)
    x0_test = torch.randn(
        (4, base_model.image_size, base_model.image_size, base_model.in_channels),
        generator=gen, device=device,
    )
    x1_test = base_model.sample(noise=x0_test, num_steps=100, data_format="NHWC")
    base_straightness = RectifiedFlowModel.compute_straightness(
        base_model, x0_test, x1_test, data_format="NHWC"
    )
    rect_straightness = rect_model.compute_straightness(x0_test, x1_test, data_format="NHWC")
    log.info("Base model straightness:      %.4f", base_straightness)
    log.info("Rectified model straightness: %.4f", rect_straightness)
    log.info("(Lower value = straighter trajectories)")
    return rect_model


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

"""Train the base flow model: the first training stage of the pipeline.

Counterpart of the JAX package's ``experiments/train_base.py``: config ->
data (synthesized when the data directory is empty) -> dataset (encoded to
ConvVAE latents for latent configs, training the VAE first when its
checkpoint is absent) -> model -> ``train_base_flow`` -> the loss curve as
``base_flow_losses.npy`` -> a smoke sample. Paths are relative to the repo
root unless absolute. Runnable as
``python -m rectified_flow_vision_tpu_torch.experiments.train_base``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from rectified_flow_vision_tpu_torch import config as config_lib
from rectified_flow_vision_tpu_torch.config import Config, load_config
from rectified_flow_vision_tpu_torch.data import ArrayDataset, ImageDataset
from rectified_flow_vision_tpu_torch.models import BaseFlowModel, ConvVAE, train_base_flow
from rectified_flow_vision_tpu_torch.models.base_flow import resolve_device
from rectified_flow_vision_tpu_torch.utils.logging_config import get_logger

log = get_logger("flow_vision.train_base")


def build_model(cfg: Config, cls=BaseFlowModel, *, device: str | torch.device = "cuda"):
    """Construct the configured model (unet or dit backbone) on ``device``.

    With ``model.latent`` the flow model lives in the ConvVAE's latent
    space: image_size and channels are the latent dimensions. The config's
    ``model.use_pallas`` switches the JAX package's Pallas kernels; the port
    has no such switch (a CUDA tensor always takes the hand-written kernels,
    a CPU tensor their plain versions), so it is read here and not passed on.
    """
    image_size, in_channels = cfg.data.image_size, 3
    if cfg.model.latent:
        image_size = cfg.data.image_size // cfg.model.latent_downsample
        in_channels = cfg.model.latent_channels
    kwargs = dict(
        image_size=image_size,
        in_channels=in_channels,
        compute_dtype=cfg.model.compute_dtype,
        sample_dtype=cfg.model.sample_dtype,
        backbone=cfg.model.backbone,
        device=device,
    )
    if cfg.model.backbone == "dit":
        kwargs.update(remat=cfg.model.remat)
    else:
        kwargs.update(
            model_channels=cfg.model.channels,
            channel_mult=cfg.model.channel_mult,
            num_res_blocks=cfg.model.num_res_blocks,
            attention_resolutions=cfg.model.attention_resolutions,
            dropout=cfg.model.dropout,
        )
    return cls(**kwargs)


def ensure_vae(cfg: Config, dataset, checkpoint_dir: Path, *, device="cuda") -> ConvVAE:
    """The config's ConvVAE from ``vae.npz``, trained and saved first if absent."""
    from rectified_flow_vision_tpu_torch.models import train_vae

    vae_path = checkpoint_dir / "vae.npz"
    if vae_path.exists():
        return ConvVAE.load(str(vae_path), device=device)
    log.info(
        "Training the ConvVAE (%dx -> %dx%d latents, %d epochs)...",
        cfg.model.latent_downsample,
        cfg.data.image_size // cfg.model.latent_downsample,
        cfg.model.latent_channels,
        cfg.model.vae_epochs,
    )
    vae = ConvVAE(
        image_size=cfg.data.image_size,
        latent_channels=cfg.model.latent_channels,
        downsample=cfg.model.latent_downsample,
        device=device,
    )
    _, mse = train_vae(vae, dataset.images, epochs=cfg.model.vae_epochs)
    vae.save(str(vae_path))
    log.info("VAE trained: recon MSE %.5f -> %s", mse, vae_path)
    return vae


@torch.no_grad()
def encode_dataset(vae: ConvVAE, images: np.ndarray, batch: int = 64) -> ArrayDataset:
    """Encode an NHWC pixel corpus into an ArrayDataset of (mu) latents."""
    lat = [
        vae.encode(torch.as_tensor(images[i : i + batch], dtype=torch.float32,
                                   device=vae.device)).cpu().numpy()
        for i in range(0, images.shape[0], batch)
    ]
    return ArrayDataset(np.concatenate(lat))


def default_mesh(cfg: Config, device: str | torch.device = "cuda"):
    """None on one device, as the JAX trainers take a one-device mesh for no
    mesh. More cards, or tensor parallelism, need the mesh of ROADMAP A9."""
    device = torch.device(device)
    cards = torch.cuda.device_count() if device.type == "cuda" else 1
    if cards <= 1 and cfg.parallel.model_axis == 1:
        return None
    raise NotImplementedError(
        f"{cards} visible cards with parallel.model_axis={cfg.parallel.model_axis}: "
        "meshes are not ported to PyTorch yet: ROADMAP.md item A9 (parallelism); "
        "set CUDA_VISIBLE_DEVICES to one card"
    )


def main(
    config: Optional[Config] = None, *, mesh=None, device: str | torch.device = "cuda"
) -> BaseFlowModel:
    cfg = config if config is not None else load_config()
    device = resolve_device(device)
    if mesh is None:
        mesh = default_mesh(cfg, device)
    root = config_lib.repo_root()

    checkpoint_dir = root / cfg.paths.checkpoints
    checkpoint_dir.mkdir(parents=True, exist_ok=True)

    data_dir = root / cfg.data.data_dir
    if not data_dir.exists() or not any(data_dir.iterdir()):
        log.info("No data found; generating synthetic data for demo...")
        from rectified_flow_vision_tpu_torch.utils.download_data import generate_synthetic_images

        generate_synthetic_images(str(data_dir), cfg.data.num_mock_images, cfg.data.image_size)

    dataset = ImageDataset(str(data_dir), cfg.data.image_size)

    vae = None
    if cfg.model.latent:
        vae = ensure_vae(cfg, dataset, checkpoint_dir, device=device)
        log.info(
            "Latent pipeline: %dx%dx%d -> %dx%dx%d (scaling %.3f)",
            cfg.data.image_size, cfg.data.image_size, 3,
            vae.latent_size, vae.latent_size, vae.latent_channels,
            vae.scaling_factor,
        )
        dataset = encode_dataset(vae, dataset.images)

    model = build_model(cfg, device=device)
    log.info("Model created with %s parameters", f"{model.num_parameters():,}")

    log.info("=" * 60)
    log.info("TRAINING BASE MODEL")
    log.info("=" * 60)

    losses = train_base_flow(
        model=model,
        dataloader=dataset,
        epochs=cfg.training_base.epochs,
        lr=cfg.training_base.learning_rate,
        save_path=str(checkpoint_dir / "base_flow"),
        save_every=cfg.training_base.save_every,
        batch_size=cfg.training_base.batch_size,
        mesh=mesh,
        resume_dir=(
            str(checkpoint_dir / "state_base") if cfg.training_base.resume else None
        ),
        use_native_loader=cfg.training_base.use_native_loader,
        ema_decay=cfg.training_base.ema_decay or None,
        fsdp=cfg.parallel.fsdp,
        warmup_epochs=cfg.training_base.warmup_epochs,
    )

    np.save(str(checkpoint_dir / "base_flow_losses.npy"), losses)

    log.info("Training completed!")
    log.info("Model saved to: %s", checkpoint_dir / "base_flow_final.npz")

    log.info("Generating test samples...")
    if vae is not None:
        from rectified_flow_vision_tpu_torch.models import LatentFlowPipeline

        samples = LatentFlowPipeline(model, vae).sample(batch_size=4, num_steps=50)
    else:
        samples = model.sample(batch_size=4, num_steps=50)
    log.info("Generated samples: %s", tuple(samples.shape))
    return model


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

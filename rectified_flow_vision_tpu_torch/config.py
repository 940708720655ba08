"""Typed configuration: dataclasses <-> YAML, one loader, the --quick overlay.

Counterpart of the JAX package's ``config.py``: the same dataclasses, key
names, defaults, ``load_config``, ``quick_overlay``, ``QUICK_CONFIG_PATH`` and
``repo_root``, on PyYAML (``yaml.safe_load`` to read, ``yaml.dump`` to write).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

import yaml

# Repo root = directory containing configs/ and this package.
_REPO_ROOT = Path(__file__).resolve().parent.parent
DEFAULT_CONFIG_PATH = _REPO_ROOT / "configs" / "config.yaml"
QUICK_CONFIG_PATH = _REPO_ROOT / "configs" / "config_quick.yaml"
WEIGHTS_DIR = _REPO_ROOT / "weights"  # committed metric backbones


@dataclass
class DataConfig:
    image_size: int = 64
    num_mock_images: int = 100
    data_dir: str = "data/mock_images"


@dataclass
class ModelConfig:
    channels: int = 64
    channel_mult: List[int] = field(default_factory=lambda: [1, 2, 4])
    num_res_blocks: int = 2
    attention_resolutions: List[int] = field(default_factory=lambda: [16, 8])
    dropout: float = 0.1
    backbone: str = "unet"  # "unet" | "dit"
    param_dtype: str = "float32"
    compute_dtype: str = "float32"  # training compute dtype
    sample_dtype: str = "bfloat16"  # inference/sampling compute dtype
    # the JAX package's switch for its Pallas kernels; the port has no such
    # switch (a CUDA tensor always takes the kernels), so it reads the key
    # and ignores it
    use_pallas: Optional[bool] = None
    remat: bool = False  # rematerialize transformer blocks (long sequences)
    # latent-diffusion pipeline: train/sample the flow in a ConvVAE's latent
    # space instead of pixels
    latent: bool = False
    latent_channels: int = 4
    latent_downsample: int = 4  # spatial factor; latent size = image_size / this
    vae_epochs: int = 40  # auto-training epochs when the VAE ckpt is absent


@dataclass
class TrainingBaseConfig:
    epochs: int = 50
    batch_size: int = 16
    learning_rate: float = 1e-4
    num_timesteps: int = 1000
    save_every: int = 10
    resume: bool = False          # restart from the latest train state
    ema_decay: float = 0.0        # >0 enables EMA params
    use_native_loader: bool = False
    # linear LR warmup over this many epochs before the cosine schedule
    warmup_epochs: float = 0.0


@dataclass
class TrainingRectifiedConfig:
    epochs: int = 30
    batch_size: int = 16
    learning_rate: float = 1e-4
    num_reflow_iterations: int = 2
    save_every: int = 10
    resume: bool = False
    # 0 => the reference's formula min(1000, num_mock_images * 10)
    num_pairs: int = 0
    # 0 => the reference's num_timesteps // 10 teacher steps
    teacher_steps: int = 0
    # ODE integrator for teacher pair synthesis: euler | midpoint | heun
    teacher_method: str = "euler"
    # initialise the student from the teacher's weights
    init_from_teacher: bool = False
    # t distribution for the coupled loss: uniform | logit_normal | u_shaped
    time_sampling: str = "uniform"
    # >0 trains an EMA of the student (saved as *_ema_* checkpoints)
    ema_decay: float = 0.0
    pair_batch_size: int = 64
    # distil from base_flow_ema_final when it exists
    teacher_use_ema: bool = True
    # fraction of Reflow pairs built data-side (real images inverted through
    # the teacher ODE)
    data_pair_fraction: float = 0.0


@dataclass
class BenchmarkConfig:
    num_samples: int = 50
    steps_to_test: List[int] = field(
        default_factory=lambda: [1, 2, 4, 8, 16, 32, 64, 100]
    )
    num_runs: int = 5
    # batch of the dependency-chained throughput sweep; 0 keeps the
    # latency-only columns
    throughput_batch: int = 256
    # reference/generated images of the quality benchmark
    quality_samples: int = 32
    # quality references from the held-out synthetic eval set
    # (data/eval_<size>/) instead of the training images
    heldout_reference: bool = True
    # cap on the image pairs the host-side SSIM loop scores (0 = all)
    ssim_samples: int = 0
    # evaluate *_ema_final checkpoints when present
    prefer_ema: bool = False


@dataclass
class MetricsConfig:
    compute_fid: bool = True
    compute_lpips: bool = True
    compute_ssim: bool = True


@dataclass
class PathsConfig:
    checkpoints: str = "checkpoints"
    results: str = "results"
    figures: str = "results/figures"


@dataclass
class ParallelConfig:
    """Mesh layout (the JAX package's extension; one card in this port)."""

    data_axis: int = -1  # -1 => all remaining devices
    model_axis: int = 1  # tensor-parallel degree
    fsdp: bool = False


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    training_base: TrainingBaseConfig = field(default_factory=TrainingBaseConfig)
    training_rectified: TrainingRectifiedConfig = field(
        default_factory=TrainingRectifiedConfig
    )
    benchmark: BenchmarkConfig = field(default_factory=BenchmarkConfig)
    metrics: MetricsConfig = field(default_factory=MetricsConfig)
    paths: PathsConfig = field(default_factory=PathsConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "Config":
        cfg = cls()
        for section_name, section_value in (d or {}).items():
            if not hasattr(cfg, section_name):
                continue  # tolerate unknown sections (forward compat)
            section = getattr(cfg, section_name)
            if not dataclasses.is_dataclass(section) or not isinstance(section_value, dict):
                continue
            known = {f.name for f in dataclasses.fields(section)}
            for k, v in section_value.items():
                if k in known:
                    setattr(section, k, v)
        return cfg

    def save(self, path: os.PathLike | str) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            yaml.dump(self.to_dict(), f, default_flow_style=False)


def load_config(path: Optional[os.PathLike | str] = None) -> Config:
    """Load the project config; the built-in defaults when the file does
    not exist."""
    path = Path(path) if path is not None else DEFAULT_CONFIG_PATH
    if not path.exists():
        return Config()
    with open(path) as f:
        return Config.from_dict(yaml.safe_load(f) or {})


def quick_overlay(cfg: Config) -> Config:
    """Apply the --quick demo overlay; checkpoints and results go under
    ``*/quick`` so a demo never overwrites a trained flagship."""
    cfg.data.num_mock_images = 50
    cfg.training_base.epochs = 5
    cfg.training_base.batch_size = 8
    cfg.training_rectified.epochs = 3
    cfg.training_rectified.num_reflow_iterations = 1
    cfg.training_rectified.num_pairs = 500
    cfg.benchmark.num_samples = 10
    cfg.benchmark.steps_to_test = [1, 4, 16, 64]
    cfg.benchmark.num_runs = 2
    cfg.paths.checkpoints = str(Path(cfg.paths.checkpoints) / "quick")
    cfg.paths.results = str(Path(cfg.paths.results) / "quick")
    cfg.paths.figures = str(Path(cfg.paths.figures) / "quick")
    return cfg


def repo_root() -> Path:
    return _REPO_ROOT


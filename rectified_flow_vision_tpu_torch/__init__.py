"""rectified_flow_vision_tpu_torch: the PyTorch / CUDA (H100) port.

The JAX package ``rectified_flow_vision_tpu`` is the reference; this
package computes the same functions with PyTorch, and each Pallas TPU
kernel on its path becomes a CUDA kernel written for Hopper
(``ops/csrc``, built with ``nvcc`` at first use). It imports neither JAX
nor the JAX package.

Ported so far: the few-step serving path of the UNet flow model
(``UNet`` -> ``BaseFlowModel`` samplers -> ``SamplerService``) with ``.npz``
/ reference ``.pt`` weight loading, and the training and Reflow path
(``train_base_flow`` -> ``generate_reflow_pairs`` -> ``train_rectified_flow``
/ ``iterative_reflow``, ``compute_straightness``) on in-memory, packed or
natively loaded corpora, and the DiT latent path (``ConvVAE`` /
``train_vae``, ``BaseFlowModel(backbone="dit")`` with hand-written flash
attention, ``LatentFlowPipeline``, latent serving through
``SamplerService(vae=...)``), and the ``main.py`` pipeline: ``config``
(``load_config``, ``quick_overlay``), synthetic data, the two training
experiments, the benchmark with its metrics (``MetricsCalculator``) and
report, and the CLI (``python -m rectified_flow_vision_tpu_torch``, or
``rectified_flow_vision_tpu_torch.main.main(argv)``), and the rest of the
public API: resume of both trainers (``resume_dir``,
``utils.train_state.TrainStateManager``), ``utils.checkpoint.AsyncSaver``,
the HTTP front end (``serving_http``), the LPIPS and InceptionV3 networks,
SynthNet training, the generation-speed helpers, ``.pt`` export and the
profiling hooks, and parallelism (``parallel``: data, tensor and fully
sharded parallel training, mesh serving, ring attention, the GPipe
pipeline), and the Winograd F(2x2, 3x3) conv (``ops.winograd``), which the
UNet's 3x3 conv sites take when ``RFV_CONV_WINOGRAD`` is set, as in the JAX
package: with it the port does everything the JAX package does.
Entry points run on ``device="cuda"`` unless the caller asks for the CPU.
"""

__version__ = "0.1.0"

from rectified_flow_vision_tpu_torch.config import Config, load_config, quick_overlay  # noqa: F401
from rectified_flow_vision_tpu_torch.data import (  # noqa: F401
    ArrayDataset,
    ImageDataset,
    PackedCorpus,
    as_nchw,
    as_nhwc,
)
from rectified_flow_vision_tpu_torch.models import (  # noqa: F401
    BaseFlowModel,
    ConvVAE,
    DiT,
    LatentFlowPipeline,
    RectifiedFlowModel,
    UNet,
    count_parameters,
    generate_reflow_pairs,
    iterative_reflow,
    make_epoch_cosine_schedule,
    make_optimizer,
    make_train_epoch,
    make_train_step,
    train_base_flow,
    train_rectified_flow,
    train_vae,
)
from rectified_flow_vision_tpu_torch.serving import SamplerService  # noqa: F401
from rectified_flow_vision_tpu_torch.utils.metrics import MetricsCalculator  # noqa: F401

__all__ = [
    "Config",
    "load_config",
    "quick_overlay",
    "MetricsCalculator",
    "PackedCorpus",
    "UNet",
    "DiT",
    "ConvVAE",
    "train_vae",
    "LatentFlowPipeline",
    "count_parameters",
    "BaseFlowModel",
    "RectifiedFlowModel",
    "SamplerService",
    "ImageDataset",
    "ArrayDataset",
    "as_nchw",
    "as_nhwc",
    "train_base_flow",
    "generate_reflow_pairs",
    "train_rectified_flow",
    "iterative_reflow",
    "make_train_step",
    "make_train_epoch",
    "make_optimizer",
    "make_epoch_cosine_schedule",
]

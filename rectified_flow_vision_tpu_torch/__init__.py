"""rectified_flow_vision_tpu_torch: the PyTorch / CUDA (H100) port.

The JAX package ``rectified_flow_vision_tpu`` is the reference; this
package computes the same functions with PyTorch, and each Pallas TPU
kernel on its path becomes a CUDA kernel written for Hopper
(``ops/csrc``, built with ``nvcc`` at first use). It imports neither JAX
nor the JAX package.

Ported so far: the few-step serving path of the UNet flow model
(``UNet`` -> ``BaseFlowModel`` samplers -> ``SamplerService``), with
``.npz`` / reference ``.pt`` weight loading. Entry points run on
``device="cuda"`` unless the caller asks for the CPU.
"""

__version__ = "0.1.0"

from rectified_flow_vision_tpu_torch.models import (  # noqa: F401
    BaseFlowModel,
    RectifiedFlowModel,
    UNet,
    count_parameters,
)
from rectified_flow_vision_tpu_torch.serving import SamplerService  # noqa: F401

__all__ = [
    "UNet",
    "count_parameters",
    "BaseFlowModel",
    "RectifiedFlowModel",
    "SamplerService",
]

"""UNet velocity field and the flow models around it."""

from rectified_flow_vision_tpu_torch.models.base_flow import BaseFlowModel  # noqa: F401
from rectified_flow_vision_tpu_torch.models.rectified_flow import (  # noqa: F401
    RectifiedFlowModel,
)
from rectified_flow_vision_tpu_torch.models.unet import UNet, count_parameters  # noqa: F401

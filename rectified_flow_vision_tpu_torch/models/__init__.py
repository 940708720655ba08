"""UNet and DiT velocity fields, the flow models around them, the ConvVAE of
the latent path and their trainers."""

from rectified_flow_vision_tpu_torch.models.autoencoder import (  # noqa: F401
    ConvVAE,
    LatentFlowPipeline,
    train_vae,
)
from rectified_flow_vision_tpu_torch.models.base_flow import (  # noqa: F401
    BaseFlowModel,
    make_epoch_cosine_schedule,
    make_optimizer,
    make_train_epoch,
    make_train_step,
    train_base_flow,
)
from rectified_flow_vision_tpu_torch.models.dit import DIT_SIZES, DiT, DiTConfig  # noqa: F401
from rectified_flow_vision_tpu_torch.models.rectified_flow import (  # noqa: F401
    RectifiedFlowModel,
    generate_reflow_pairs,
    iterative_reflow,
    train_rectified_flow,
)
from rectified_flow_vision_tpu_torch.models.unet import UNet, count_parameters  # noqa: F401

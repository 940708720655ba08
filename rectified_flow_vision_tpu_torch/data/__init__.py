"""Image corpora and host-side batching."""

from rectified_flow_vision_tpu_torch.data.dataset import (  # noqa: F401
    ArrayDataset,
    ImageDataset,
    as_nchw,
    as_nhwc,
    list_image_paths,
    load_image,
)

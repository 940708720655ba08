"""Image corpora, host-side batching, packed corpora and the native loader."""

from rectified_flow_vision_tpu_torch.data.dataset import (  # noqa: F401
    ArrayDataset,
    ImageDataset,
    as_nchw,
    as_nhwc,
    eval_reference_images,
    list_image_paths,
    load_image,
)
from rectified_flow_vision_tpu_torch.data.packed import (  # noqa: F401
    PackedCorpus,
    pack_corpus,
)

"""Parallelism: process groups, the device mesh, parameter placement, ring
attention and the GPipe pipeline (the JAX package's ``parallel``)."""

from rectified_flow_vision_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    create_mesh,
    fsdp_spec,
    maybe_init_distributed,
    place_params,
    replicated,
    shard_batch,
    shard_params,
    shard_params_fsdp,
    unet_param_spec,
)

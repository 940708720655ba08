"""Dispatch between the port's CUDA kernels and their plain versions.

Counterpart of the JAX package's ``ops/fused.py``. The only switch is the
tensor's device: a CPU tensor takes the plain PyTorch version, a CUDA tensor
takes the kernel, and any other device raises. There is no size cap (the
JAX side's VMEM slab cap is a TPU limit) and no fallback when a build or a
launch fails. The one exception is the conv's contract: a conv outside
``conv3x3.supports`` (not 3x3/stride 1, or channels not multiples of 64)
is the plain conv on every device, as in the JAX package.
"""

from __future__ import annotations

import torch

from rectified_flow_vision_tpu_torch.ops import attention as A
from rectified_flow_vision_tpu_torch.ops import conv3x3 as C
from rectified_flow_vision_tpu_torch.ops import gn_silu as G
from rectified_flow_vision_tpu_torch.ops import primitives as P

Tensor = torch.Tensor


def _on_cpu(x: Tensor) -> bool:
    return x.device.type == "cpu"


def gn_silu(x: Tensor, scale: Tensor, bias: Tensor, *, num_groups: int = 8) -> Tensor:
    """Fused GroupNorm(num_groups) + SiLU over an NHWC tensor."""
    fn = G.gn_silu_plain if _on_cpu(x) else G.gn_silu_cuda
    return fn(x, scale, bias, num_groups=num_groups)


def conv2d_fused(x: Tensor, w_ohwi: Tensor, b: Tensor, *, stride: int = 1) -> Tensor:
    """NHWC conv with an OHWI weight: the conv3x3 kernel inside its contract,
    the plain conv outside it."""
    if C.supports(x.shape, w_ohwi.shape, stride):
        fn = C.conv3x3_plain if _on_cpu(x) else C.conv3x3_cuda
        return fn(x, w_ohwi, b)
    return P.conv2d(x, w_ohwi.permute(0, 3, 1, 2), b, stride=stride)


def attention(
    x: Tensor,
    norm_scale: Tensor,
    norm_bias: Tensor,
    w_qkv: Tensor,
    b_qkv: Tensor,
    w_proj: Tensor,
    b_proj: Tensor,
    *,
    num_heads: int = 4,
    num_groups: int = 8,
) -> Tensor:
    """Spatial self-attention block (norm -> qkv -> attn -> proj -> +x)."""
    fn = A.attention_block_plain if _on_cpu(x) else A.attention_block_cuda
    return fn(
        x, norm_scale, norm_bias, w_qkv, b_qkv, w_proj, b_proj,
        num_heads=num_heads, num_groups=num_groups,
    )

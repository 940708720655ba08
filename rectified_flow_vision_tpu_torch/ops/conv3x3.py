"""3x3 / stride-1 / pad-1 NHWC convolution: CUDA kernel and its plain version.

Replaces the Pallas TPU kernel ``rectified_flow_vision_tpu/ops/conv_pallas.py``
``conv3x3`` (five TPU tilings of one op: ``_conv3x3_taps``,
``_conv3x3_padded``, ``_conv3x3_packed``, ``_conv3x3_image``); one Hopper
kernel (``csrc/conv3x3.cu``) honours the same contract. It is an implicit
GEMM (M = N*H*W, N = Cout, K = 9*Cin) bound by operations on the H100: the
bf16 path runs on the tensor cores through WMMA, the fp32 path on fp32 FMAs.

The weight is ``(Cout, 3, 3, Cin)`` (OHWI): the K axis is ordered
(dy, dx, ci), which is a torch OIHW weight ``permute(0, 2, 3, 1)``. The
UNet packs it once per weight version and dtype, not per call
(``models/unet.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from rectified_flow_vision_tpu_torch.ops import build

Tensor = torch.Tensor


def supports(x_shape, w_shape, stride: int) -> bool:
    """The kernel's contract (as the JAX ``conv_pallas.supports``): 3x3,
    stride 1, Cin and Cout multiples of 64, H >= 8 and 8 <= W <= 256.
    ``w_shape`` is OHWI."""
    if stride != 1 or len(w_shape) != 4 or tuple(w_shape[1:3]) != (3, 3):
        return False
    _, h, wdt, cin = x_shape
    cout = w_shape[0]
    if w_shape[3] != cin or cin % 64 or cout % 64:
        return False
    return h >= 8 and 8 <= wdt <= 256


def conv3x3_plain(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Plain PyTorch 3x3/pad-1 conv; conv in x's dtype, fp32 bias, then x's dtype
    (as ``P.conv2d``)."""
    out = F.conv2d(x.permute(0, 3, 1, 2), w.permute(0, 3, 1, 2).to(x.dtype), None, padding=1)
    return (out.permute(0, 2, 3, 1).float() + b.float()).to(x.dtype)


def conv3x3_cuda(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Launch the CUDA kernel. x: (N, H, W, Cin); w: (Cout, 3, 3, Cin) in x's
    dtype; b: (Cout,) fp32."""
    build.require_cuda(x, "conv3x3")
    if not supports(x.shape, w.shape, 1):
        raise ValueError(f"conv3x3: shapes x {tuple(x.shape)}, w {tuple(w.shape)} not supported")
    n, h, wdt, cin = x.shape
    cout = w.shape[0]
    if n * h * wdt >= 2**31:
        raise ValueError(f"conv3x3: x {tuple(x.shape)} too large for 32-bit row indices")
    build.require(x, "x", device=x.device, dtype=x.dtype, shape=x.shape)
    build.require(w, "w", device=x.device, dtype=x.dtype, shape=(cout, 3, 3, cin))
    build.require(b, "b", device=x.device, dtype=torch.float32, shape=(cout,))
    lib = build.library()
    out = torch.empty((n, h, wdt, cout), device=x.device, dtype=x.dtype)
    rc = lib.rfv_conv3x3(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
        n, h, wdt, cin, cout, build.DTYPE_CODES[x.dtype], build.stream_ptr(x),
    )
    build.check(rc, "conv3x3")
    build.LAUNCHES["conv3x3"] += 1
    return out


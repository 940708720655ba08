"""3x3 / stride-1 / pad-1 NHWC convolution: CUDA kernel and its plain version.

Replaces the Pallas TPU kernel ``rectified_flow_vision_tpu/ops/conv_pallas.py``
``conv3x3`` (five TPU tilings of one op: ``_conv3x3_taps``,
``_conv3x3_padded``, ``_conv3x3_packed``, ``_conv3x3_image``); one Hopper
kernel (``csrc/conv3x3.cu``) honours the same contract. It is an implicit
GEMM (M = N*H*W, N = Cout, K = 9*Cin) bound by operations on the H100 (the
flagship forward's 30 calls: 3.09 TFLOP, 3.1 ms at 989 TFLOP/s). The bf16
path is warp-specialised and persistent: a block tile of 128 or 256 pixels
takes every output channel (up to 256) so each tap's input tile is fetched
once; TMA brings the tap's pixels as a box of image rows over x viewed as a
4D tensor, its zero fill standing in for the halo, and the weights as a
[Cout, 9*Cin] box, into a ring of 128-byte-swizzled stages that two
warpgroups consume with ``wgmma``. ``tile_config`` picks the tile, the ring's
depth and the box. The fp32 path runs on fp32 FMAs (no TF32).

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


def supports(x_shape, w_shape, stride: int, *, multiple: int = 64) -> bool:
    """Whether a conv is the kernel's site (as the JAX ``conv_pallas.supports``):
    3x3, stride 1, Cin and Cout multiples of 64, H >= 8 and 8 <= W <= 256.
    ``w_shape`` is OHWI. The kernel itself takes channels that are multiples
    of ``KERNEL_MULTIPLE`` (``multiple=``), so that a tensor-parallel rank's
    slice of a site's channels runs on it too."""
    if stride != 1 or len(w_shape) != 4 or tuple(w_shape[1:3]) != (3, 3):
        return False
    _, h, wdt, cin = x_shape
    cout = w_shape[0]
    if w_shape[3] != cin or cin % multiple or cout % multiple:
        return False
    return h >= 8 and 8 <= wdt <= 256


KERNEL_MULTIPLE = 16  # the fp32 kernel's k-chunk lies in one tap


SMEM_LIMIT = 232448  # bytes of shared memory a block may use on the H100
MAX_STAGES = 8


def tile_config(h: int, w: int, cin: int, cout: int) -> dict:
    """The bf16 wgmma kernel's tiling for one shape (the convs, and the
    attention block's projections as one-tap convs): ``bn`` output channels
    per tile (the smallest of 64, 128, 192, 256 that holds Cout, else the
    largest that divides it, else 256; columns past Cout are not stored),
    ``bm`` pixels per tile (256 where bn <= 128, so that each k-step's weights
    serve twice the rows, else 128), the A box of ``hb`` image rows x ``wb``
    columns (``wb`` the power of two >= W, at most 128; ``hb * wb`` = bm),
    the ring's ``stages`` (as many bm x 128 + bn x 128-byte stages as fit,
    at most 8), the block's dynamic shared memory and the number of tiles
    per image."""
    tiles = (64, 128, 192, 256)
    if cout <= 256:
        bn = next(b for b in tiles if b >= cout)
    else:
        bn = next((b for b in reversed(tiles) if cout % b == 0), 256)
    bm = 256 if bn <= 128 else 128
    wb = min(128, 1 << max(0, (w - 1).bit_length()))
    hb = bm // wb
    stage = bm * 64 * 2 + bn * 64 * 2
    reserve = 1024 + 2 * MAX_STAGES * 8  # 1024-byte alignment of the ring, mbarriers
    stages = min(MAX_STAGES, (SMEM_LIMIT - reserve) // stage)
    smem = stages * stage + 1024 + 2 * stages * 8
    n_tiles = -(-h // hb) * -(-w // wb) * -(-cout // bn)
    return dict(bn=bn, bm=bm, wb=wb, hb=hb, stages=stages, smem=smem, tiles_per_image=n_tiles)


def conv3x3_plain(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Plain PyTorch 3x3/pad-1 conv; conv in x's dtype, fp32 bias, then x's dtype
    (as ``P.conv2d``)."""
    out = F.conv2d(x.permute(0, 3, 1, 2), w.permute(0, 3, 1, 2).to(x.dtype), None, padding=1)
    return (out.permute(0, 2, 3, 1).float() + b.float()).to(x.dtype)


def conv3x3_cuda(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Launch the CUDA kernel. x: (N, H, W, Cin); w: (Cout, 3, 3, Cin) in x's
    dtype; b: (Cout,) fp32."""
    if not supports(x.shape, w.shape, 1, multiple=KERNEL_MULTIPLE):
        raise ValueError(f"conv3x3: shapes x {tuple(x.shape)}, w {tuple(w.shape)} not supported")
    build.require_cuda(x, "conv3x3")
    n, h, wdt, cin = x.shape
    cout = w.shape[0]
    if n * h * wdt >= 2**31:
        raise ValueError(f"conv3x3: x {tuple(x.shape)} too large for 32-bit row indices")
    build.require(x, "x", device=x.device, dtype=x.dtype, shape=x.shape)
    build.require(w, "w", device=x.device, dtype=x.dtype, shape=(cout, 3, 3, cin))
    build.require(b, "b", device=x.device, dtype=torch.float32, shape=(cout,))
    lib = build.library()
    cfg = tile_config(h, wdt, cin, cout)
    out = torch.empty((n, h, wdt, cout), device=x.device, dtype=x.dtype)
    rc = lib.rfv_conv3x3(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
        n, h, wdt, cin, cout, cfg["bn"], cfg["stages"], cfg["wb"], cfg["hb"],
        build.DTYPE_CODES[x.dtype], build.stream_ptr(x),
    )
    build.check(rc, "conv3x3")
    build.LAUNCHES["conv3x3"] += 1
    return out


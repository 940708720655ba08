"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test skips without a CUDA device (decided in the
fixture, not at import). On a machine with a card and nvcc:

    python -m pytest tests/test_torch_kernels_cuda.py -q

Shapes are small but cover ragged tiles (M not a multiple of the conv's
128-row tile, 35 tokens in attention, C not a multiple of 32) and group
widths that take gn_silu's narrower vectors (2 and 3 channels a group). Tolerances as in chip_smoke.py:
fp32 1e-4 (gn_silu) / 1e-3 (conv3x3, attention; reordered sums, cuDNN's
algorithm choice), bf16 one rounding against two or three (2e-2 rtol, 3e-2
atol, 6e-2 for attention).
"""

import pytest
import torch

from rectified_flow_vision_tpu_torch.ops import attention as A
from rectified_flow_vision_tpu_torch.ops import build
from rectified_flow_vision_tpu_torch.ops import conv3x3 as C
from rectified_flow_vision_tpu_torch.ops import fused
from rectified_flow_vision_tpu_torch.ops import gn_silu as G

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype, fp32=1e-3, bf16_atol=3e-2):
    return dict(rtol=fp32, atol=fp32) if dtype == torch.float32 else dict(rtol=2e-2, atol=bf16_atol)


def _gen(dev, seed=0):
    return torch.Generator(device=dev).manual_seed(seed)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "shape", [(3, 8, 8, 64), (2, 16, 16, 192), (1, 9, 7, 512), (2, 8, 8, 16), (1, 4, 4, 24)]
)
def test_gn_silu(dev, dtype, shape):
    g = _gen(dev)
    x = (torch.randn(shape, generator=g, device=dev) * 2 + 0.3).to(dtype)
    c = shape[-1]
    s = torch.randn(c, generator=g, device=dev) * 0.2 + 1
    b = torch.randn(c, generator=g, device=dev) * 0.2
    before = build.LAUNCHES["gn_silu"]
    out = fused.gn_silu(x, s, b)
    assert build.LAUNCHES["gn_silu"] == before + 1
    torch.testing.assert_close(out.float(), G.gn_silu_plain(x, s, b).float(),
                               **_tol(dtype, fp32=1e-4))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,cout", [((3, 8, 8, 64), 64), ((1, 12, 10, 128), 192),
                                        ((2, 16, 16, 192), 64)])
def test_conv3x3(dev, dtype, shape, cout):
    g = _gen(dev, 1)
    cin = shape[-1]
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    w = ((torch.rand((cout, 3, 3, cin), generator=g, device=dev) * 2 - 1) / (9 * cin) ** 0.5).to(dtype)
    b = torch.randn(cout, generator=g, device=dev) * 0.1
    before = build.LAUNCHES["conv3x3"]
    out = fused.conv2d_fused(x, w, b)
    assert build.LAUNCHES["conv3x3"] == before + 1
    torch.testing.assert_close(out.float(), C.conv3x3_plain(x, w, b).float(), **_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 16, 16, 256), (3, 8, 8, 128), (2, 8, 8, 16),
                                   (1, 5, 7, 64)])
def test_attention_block(dev, dtype, shape):
    g = _gen(dev, 2)
    c = shape[-1]
    x = torch.randn(shape, generator=g, device=dev).to(dtype)

    def u(*s):
        return (torch.rand(s, generator=g, device=dev) * 2 - 1) / c ** 0.5

    args = (x, torch.randn(c, generator=g, device=dev) * 0.2 + 1,
            torch.randn(c, generator=g, device=dev) * 0.2,
            u(3 * c, c).to(dtype), u(3 * c), u(c, c).to(dtype), u(c))
    before = build.LAUNCHES["attention_block"]
    out = fused.attention(*args)
    assert build.LAUNCHES["attention_block"] == before + 1
    torch.testing.assert_close(out.float(), A.attention_block_plain(*args).float(),
                               **_tol(dtype, bf16_atol=6e-2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_small_unet_on_the_card_matches_the_cpu(dev, dtype):
    """A UNet far from the flagship (16 channels, an 8x8 mid attention):
    every kernel site runs on the card and agrees with the plain path on the
    CPU (fp32 1e-3; bf16 3% of the output scale)."""
    from rectified_flow_vision_tpu_torch.models.unet import UNet

    cpu = UNet(model_channels=16, channel_mult=(1,), num_res_blocks=1)
    cpu.reset_parameters(torch.Generator().manual_seed(0))
    gpu = UNet(model_channels=16, channel_mult=(1,), num_res_blocks=1)
    gpu.load_state_dict(cpu.state_dict())
    gpu.to(dev)
    g = torch.Generator().manual_seed(1)
    x, t = torch.randn((2, 8, 8, 3), generator=g), torch.rand((2,), generator=g)
    dt = getattr(torch, dtype)
    build.reset_launches()
    with torch.no_grad():
        want = cpu(x, t, dtype=dt).float()
        got = gpu(x.to(dev), t.to(dev), dtype=dt).float().cpu()
    # 4 residual blocks x 2 + the head; 16 channels are outside conv3x3's contract
    assert build.LAUNCHES == {"gn_silu": 9, "conv3x3": 0, "attention_block": 1}
    tol = 1e-3 if dtype == "float32" else 0.03 * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = torch.randn((1, 8, 8, 64), device=dev)
    s = torch.ones(64, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        G.gn_silu_cuda(x.transpose(1, 2), s, s)
    with pytest.raises(ValueError, match="dtype"):
        G.gn_silu_cuda(x.half(), s, s)
    with pytest.raises(ValueError, match="scale"):
        G.gn_silu_cuda(x, s.double(), s)
    with pytest.raises(ValueError, match="not supported"):
        C.conv3x3_cuda(x, torch.randn((64, 3, 3, 32), device=dev), s)
    with pytest.raises(ValueError, match="w has dtype"):
        C.conv3x3_cuda(x, torch.randn((64, 3, 3, 64), device=dev).bfloat16(), s)

"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test skips without a CUDA device (decided in the
fixture, not at import). On a machine with a card and nvcc:

    python -m pytest tests/test_torch_kernels_cuda.py -q

Shapes are small but cover ragged tiles (M not a multiple of the conv's
128-row tile, boxes wider or taller than the image, 35 tokens in attention,
C not a multiple of 32), every conv shape of the flagship forward and of
its tensor-parallel slices, the
attention block at 1024 and 4096 tokens, head widths 4 to 64 (attention
block) and 4 to 640 (flash attention, DiT-XL's 72 among them; 4, 12 and 20
zero-padded; 136, 192, 200 and 256 on the bf16 kernels' 192 / 256 instances;
264, 320, 384, 512 and 640 on the streamed bf16 kernels, 512 and 640 with
their streamed layouts; every fp32 width above 128 on the *_wide fp32
kernels; the fp32 3xTF32 kernels at 8 to 128 against the plain versions and
against float64, where their error is held to 4 times the plain fp32
version's), every
GroupNorm slab of the flagship, group widths that take gn_silu's
narrower vectors (2 and 3 channels a group), and the DiT glue kernels at
DiT-S/2's and DiT-XL/2's widths (8 to 4608 channels, 111 rows, the adaLN
rows as strided views), bit-equal to the eager composition but for the
LayerNorm's sums and GELU's tanh (one bf16 ulp). Tolerances as in
chip_smoke.py: fp32 1e-4 (gn_silu) / 1e-3 (conv3x3,
attention; reordered sums, cuDNN's algorithm choice), bf16 one rounding
against two or three (2e-2 rtol, 3e-2 atol, 6e-2 for attention); the
backward kernels against their plain versions' formulas at fp32 1e-4 and
bf16 2e-2 of each gradient's largest entry.
"""

import pytest
import torch

from rectified_flow_vision_tpu_torch.ops import attention as A
from rectified_flow_vision_tpu_torch.ops import build
from rectified_flow_vision_tpu_torch.ops import conv3x3 as C
from rectified_flow_vision_tpu_torch.ops import dropout as DR
from rectified_flow_vision_tpu_torch.ops import flash_attention as FA
from rectified_flow_vision_tpu_torch.ops import fused
from rectified_flow_vision_tpu_torch.ops import gn_silu as G
from rectified_flow_vision_tpu_torch.ops import gn_silu_dropout as D

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


# the flagship's eight GroupNorm slabs (H, W, C) at batch 2 (the fp32 (64, 64,
# 192) slab, 3 MB, is past a cluster's shared memory: the route that reads x
# from device memory on every pass), then ragged ones: odd pixel counts that
# split unevenly over a cluster, 2 and 3 channels a group (narrow vectors)
GN_SHAPES = [
    (2, 16, 16, 128), (2, 16, 16, 256), (2, 16, 16, 512), (2, 32, 32, 64), (2, 32, 32, 128),
    (2, 32, 32, 384), (2, 64, 64, 64), (2, 64, 64, 192),
    (3, 8, 8, 64), (2, 16, 16, 192), (1, 9, 7, 512), (2, 8, 8, 16), (1, 4, 4, 24),
    (3, 33, 31, 64), (1, 1, 3, 256),
]


def _gn_route(x, groups=8):
    """The launch counter of gn_silu's plan for x: the cluster plan takes
    16-byte vectors within a group and an eighth of a slab in one block's
    shared memory, the streamed plan the rest."""
    h, w, c = x.shape[1:]
    es = x.element_size()
    vec = 16 // es
    while (c // groups) % vec:
        vec //= 2
    fits = vec * es == 16 and -(-h * w // 8) * c * es <= 232448 - 8192
    return "gn_silu" if fits else "gn_silu_streamed"


def _gn_args(dev, shape, seed):
    g = _gen(dev, seed)
    x = (torch.randn(shape, generator=g, device=dev) * 2 + 0.3)
    c = shape[-1]
    s = torch.randn(c, generator=g, device=dev) * 0.2 + 1
    b = torch.randn(c, generator=g, device=dev) * 0.2
    cot = torch.randn(shape, generator=g, device=dev)
    return x, s, b, cot


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", GN_SHAPES)
def test_gn_silu(dev, dtype, shape):
    """The one-pass forward against the plain version; its saved statistics
    against the plain two-pass ones."""
    x, s, b, _ = _gn_args(dev, shape, 0)
    x = x.to(dtype)
    route = _gn_route(x)
    before = build.LAUNCHES[route]
    out = fused.gn_silu(x, s, b)
    assert build.LAUNCHES[route] == before + 1
    torch.testing.assert_close(out.float(), G.gn_silu_plain(x, s, b).float(),
                               **_tol(dtype, fp32=1e-4))
    again, stats = G.gn_silu_cuda(x, s, b)
    assert torch.equal(again, out)
    torch.testing.assert_close(stats, G.gn_stats_plain(x), rtol=1e-5, atol=1e-5)


# slabs past one cluster, on gn_silu's streamed plan: the ConvVAE decode's at
# the DiT serve batch (64), FLUX's decode at batch 1 (1024^2 and 512^2 x 64:
# runs read from device memory; 256^2 x 128: resident runs), pixel counts
# that do not divide evenly among the blocks, 3 channels a group (runs read
# from device memory, scalar vectors)
GN_STREAMED_SHAPES = [
    (64, 64, 64, 256), (64, 128, 128, 128), (64, 256, 256, 64),
    (1, 1024, 1024, 64), (1, 512, 512, 64), (1, 256, 256, 128),
    (3, 97, 101, 128), (2, 333, 71, 64), (1, 200, 190, 24),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", GN_STREAMED_SHAPES)
def test_gn_silu_streamed(dev, dtype, shape):
    """The streamed plan against the plain version, its saved statistics
    against the plain two-pass ones, and the same bits on a second call."""
    x, s, b = _gn_args(dev, shape, 1)[:3]
    x = x.to(dtype)
    assert _gn_route(x) == "gn_silu_streamed"
    before = dict(build.LAUNCHES)
    out, stats = G.gn_silu_cuda(x, s, b)
    assert build.LAUNCHES["gn_silu_streamed"] == before["gn_silu_streamed"] + 1
    assert build.LAUNCHES["gn_silu"] == before["gn_silu"]
    torch.testing.assert_close(out.float(), G.gn_silu_plain(x, s, b).float(),
                               **_tol(dtype, fp32=1e-4))
    torch.testing.assert_close(stats, G.gn_stats_plain(x), rtol=1e-5, atol=1e-5)
    again, stats2 = G.gn_silu_cuda(x, s, b)
    assert torch.equal(again, out) and torch.equal(stats2, stats)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gn_silu_streamed_backward(dev, dtype):
    """fused.gn_silu at a slab on the streamed plan under autograd: the
    backward kernel from the streamed plan's saved statistics against
    ordinary autograd of the plain version."""
    x, s, b, cot = _gn_args(dev, (2, 128, 128, 128), 2)
    x = x.to(dtype)
    cot = (G.gn_silu_plain(x, s, b).float() + cot).to(dtype)
    assert _gn_route(x) == "gn_silu_streamed"
    before = dict(build.LAUNCHES)
    out_k, grads_k = _grads(fused.gn_silu, (x, s, b), cot)
    out_p, grads_p = _grads(G.gn_silu_plain, (x, s, b), cot)
    assert build.LAUNCHES["gn_silu_streamed"] == before["gn_silu_streamed"] + 1
    assert build.LAUNCHES["gn_silu_backward"] == before["gn_silu_backward"] + 1
    for got, want in zip(grads_k, grads_p):
        scale = float(want.float().abs().max())
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        assert float((got.float() - want.float()).abs().max()) <= tol * max(scale, 1.0)


def _assert_scaled(got, want, tol):
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and a.shape == w.shape
        assert float((a.float() - w.float()).abs().max()) <= tol * float(w.float().abs().max())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", GN_SHAPES)
def test_gn_silu_backward_kernel(dev, dtype, shape):
    """dx, dscale, dbias of the backward kernel (with and without the dropout
    mask) against ``gn_silu_backward_plain`` from the plain statistics, the
    same formulas: fp32 1e-4, bf16 2e-2 of each gradient's largest entry; a
    second run gives the same bits (no atomics). The cotangent follows the
    output, so that dx's group-mean terms are of dx's order."""
    x, s, b, noise = _gn_args(dev, shape, 16)
    x = x.to(dtype)
    cot = (G.gn_silu_plain(x, s, b).float() + noise).to(dtype)
    _, stats = G.gn_silu_cuda(x, s, b)
    plain_stats = G.gn_stats_plain(x)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    before = build.LAUNCHES["gn_silu_backward"]
    got = G.gn_silu_backward_cuda(x, cot, s, b, stats)
    assert build.LAUNCHES["gn_silu_backward"] == before + 1
    _assert_scaled(got, G.gn_silu_backward_plain(x, cot, s, b, plain_stats), tol)
    assert all(torch.equal(u, w) for u, w in zip(got, G.gn_silu_backward_cuda(x, cot, s, b, stats)))
    got = D.gn_silu_dropout_backward_cuda(x, cot, s, b, stats, 31, 0.2)
    _assert_scaled(got, D.gn_silu_dropout_backward_plain(x, cot, s, b, plain_stats, 31, 0.2), tol)


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


# (N, H, W, Cin, Cout): the flagship forward's ten shapes at batch 2, then a
# tile M that is no multiple of 128 and H below the box (9 x 8), W at both
# ends of the contract (8, 256, and 10: a box wider than the image), Cout
# 192 and 512 (two output-channel tiles), Cin 576 (81 k-steps); then the
# tensor-parallel slices of the flagship's 64-channel level (32 at
# model_axis 2, 16 at 4, as conv1's output and conv2's input), and channels
# that are multiples of 16 only (Cin 48 and 96: a k-step past a tap's
# channels; Cout 80: a column tile past Cout)
CONV_SHAPES = [
    (2, 64, 64, 64, 64), (2, 64, 64, 192, 64), (2, 64, 64, 128, 128),
    (2, 32, 32, 64, 128), (2, 32, 32, 128, 128), (2, 32, 32, 384, 128), (2, 32, 32, 256, 256),
    (2, 16, 16, 128, 256), (2, 16, 16, 256, 256), (2, 16, 16, 512, 256),
    (1, 9, 8, 64, 64), (2, 12, 8, 64, 128), (1, 8, 256, 64, 64), (1, 11, 10, 128, 192),
    (1, 8, 8, 576, 512), (3, 16, 16, 64, 192),
    (2, 64, 64, 64, 32), (2, 64, 64, 32, 64), (2, 64, 64, 192, 16), (2, 64, 64, 16, 64),
    (1, 11, 10, 48, 80), (1, 9, 8, 96, 32),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_conv3x3_main_path_and_edges(dev, dtype, shape):
    n, h, w, cin, cout = shape
    g = _gen(dev, 15)
    x = torch.randn((n, h, w, cin), generator=g, device=dev).to(dtype)
    wt = ((torch.rand((cout, 3, 3, cin), generator=g, device=dev) * 2 - 1)
          / (9 * cin) ** 0.5).to(dtype)
    b = torch.randn(cout, generator=g, device=dev) * 0.1
    before = build.LAUNCHES["conv3x3"]
    out = C.conv3x3_cuda(x, wt, b)
    assert build.LAUNCHES["conv3x3"] == before + 1
    torch.testing.assert_close(out.float(), C.conv3x3_plain(x, wt, b).float(), **_tol(dtype))
    # a batch slice that does not start at the storage's first element
    big = torch.randn((n + 1, h, w, cin), generator=g, device=dev).to(dtype)
    torch.testing.assert_close(C.conv3x3_cuda(big[1:], wt, b).float(),
                               C.conv3x3_plain(big[1:], wt, b).float(), **_tol(dtype))


def test_conv3x3_tile_config_matches_the_library(dev):
    """The wrapper's shared-memory figure is the one the kernel launches with."""
    lib = build.library()
    for h, w, cin, cout in [(s[1], s[2], s[3], s[4]) for s in CONV_SHAPES]:
        cfg = C.tile_config(h, w, cin, cout)
        assert lib.rfv_conv3x3_smem(cfg["bn"], cfg["stages"]) == cfg["smem"] <= C.SMEM_LIMIT


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 16, 16, 256), (3, 8, 8, 128), (2, 8, 8, 16),
                                   (1, 5, 7, 64), (2, 32, 32, 256), (1, 64, 64, 128),
                                   (1, 5, 7, 16)])
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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "shape", [(3, 8, 8, 64), (2, 16, 16, 192), (1, 9, 7, 512), (2, 8, 8, 16), (1, 4, 4, 24),
              (2, 64, 64, 64), (2, 64, 64, 192)]
)
def test_gn_silu_dropout(dev, dtype, shape):
    """The kernel's mask is the plain version's bit for bit (also with the
    2- and 3-channel groups that take narrow vectors); kept values within the
    gn_silu tolerances; the seed may be an int or an int32 tensor on the card."""
    g = _gen(dev, 3)
    x = (torch.randn(shape, generator=g, device=dev) * 2 + 0.3).to(dtype)
    c = shape[-1]
    s = torch.randn(c, generator=g, device=dev) * 0.2 + 1
    b = torch.randn(c, generator=g, device=dev) * 0.2
    seed, rate = 123456789, 0.3
    before = build.LAUNCHES["gn_silu_dropout"]
    out = fused.gn_silu_dropout(x, s, b, rate, seed, train=True)
    assert build.LAUNCHES["gn_silu_dropout"] == before + 1
    keep = D.keep_mask(shape, seed, rate, dev)
    act = G.gn_silu_plain(x, s, b)
    assert torch.equal((out != 0) | (act == 0), keep | (act == 0))
    assert torch.equal(out[~keep], torch.zeros_like(out[~keep]))
    want = D.gn_silu_dropout_plain(x, s, b, seed, rate)
    torch.testing.assert_close(out.float(), want.float(), **_tol(dtype, fp32=1e-4))
    seed_t = torch.tensor([seed], dtype=torch.int32, device=dev)
    again, stats = D.gn_silu_dropout_cuda(x, s, b, seed_t, rate)
    assert torch.equal(again, out)
    torch.testing.assert_close(stats, G.gn_stats_plain(x), rtol=1e-5, atol=1e-5)
    assert not torch.equal(D.gn_silu_dropout_cuda(x, s, b, seed + 1, rate)[0], out)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,ranks", [((3, 8, 8, 64), 2), ((2, 5, 7, 32), 4),
                                         ((2, 16, 16, 256), 2)])
def test_gn_silu_dropout_channel_slices(dev, dtype, shape, ranks):
    """Tensor parallelism: each rank's channel slice drops what the whole
    activation drops there, in the forward and the backward kernel."""
    g = _gen(dev, 5)
    x = (torch.randn(shape, generator=g, device=dev) * 2 + 0.3).to(dtype)
    c = shape[-1]
    cs = c // ranks
    s = torch.randn(c, generator=g, device=dev) * 0.2 + 1
    b = torch.randn(c, generator=g, device=dev) * 0.2
    seed, rate = 98765, 0.2
    whole = D.keep_mask(shape, seed, rate, dev)
    for r in range(ranks):
        sl = slice(r * cs, (r + 1) * cs)
        xs, ss, bs = x[..., sl].contiguous(), s[sl].contiguous(), b[sl].contiguous()
        chans = (r * cs, c)
        groups = 8 // ranks
        out, stats = D.gn_silu_dropout_cuda(xs, ss, bs, seed, rate, num_groups=groups,
                                            channels=chans)
        act = G.gn_silu_plain(xs, ss, bs, num_groups=groups)
        keep = whole[..., sl]
        assert torch.equal((out != 0) | (act == 0), keep | (act == 0))
        want = D.gn_silu_dropout_plain(xs, ss, bs, seed, rate, num_groups=groups, channels=chans)
        torch.testing.assert_close(out.float(), want.float(), **_tol(dtype, fp32=1e-4))
        cot = (out.float() + 0.1 * torch.randn(out.shape, generator=g, device=dev)).to(dtype)
        got = D.gn_silu_dropout_backward_cuda(xs, cot, ss, bs, stats, seed, rate,
                                              num_groups=groups, channels=chans)
        ref = D.gn_silu_dropout_backward_plain(xs, cot, ss, bs, stats, seed, rate,
                                               num_groups=groups, channels=chans)
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        for a, w in zip(got, ref):
            assert float((a.float() - w.float()).abs().max()) <= tol * float(w.float().abs().max())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,heads,ranks", [((2, 16, 16, 256), 4, 2), ((3, 8, 8, 128), 4, 4)])
def test_attention_block_head_slices(dev, dtype, shape, heads, ranks):
    """Tensor parallelism: a rank's heads (width Ci = C / ranks) without the
    residual; the ranks' sums plus the bias and x are the whole block."""
    g = _gen(dev, 6)
    c = shape[-1]
    ci = c // ranks
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    ns = 1 + 0.1 * torch.randn(c, generator=g, device=dev)
    nb = 0.1 * torch.randn(c, generator=g, device=dev)
    wq = (0.05 * torch.randn(3 * c, c, generator=g, device=dev)).to(dtype)
    bq = 0.1 * torch.randn(3 * c, generator=g, device=dev)
    wp = (0.05 * torch.randn(c, c, generator=g, device=dev)).to(dtype)
    bp = 0.1 * torch.randn(c, generator=g, device=dev)
    zero = torch.zeros(c, device=dev)
    total = torch.zeros(shape, device=dev)
    for r in range(ranks):
        rows = torch.cat([torch.arange(r * ci, (r + 1) * ci) + k * c for k in range(3)])
        args = (ns, nb, wq[rows].contiguous(), bq[rows].contiguous(),
                wp[:, r * ci:(r + 1) * ci].contiguous(), zero)
        got = A.attention_block_cuda(x, *args, num_heads=heads // ranks, residual=False)
        want = A.attention_block_plain(x, *args, num_heads=heads // ranks, residual=False)
        torch.testing.assert_close(got.float(), want.float(), **_tol(dtype, bf16_atol=6e-2))
        total += got.float()
    whole = A.attention_block_plain(x, ns, nb, wq, bq, wp, bp, num_heads=heads)
    tol = _tol(dtype, bf16_atol=1.5e-1)
    torch.testing.assert_close((total + bp + x.float()).to(dtype).float(), whole.float(), **tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(3, 8, 8, 64), (2, 5, 7, 3), (4, 16, 16, 24), (2, 1023)])
def test_dropout_mask_apply(dev, dtype, shape):
    """Exact: the same bits, g * inv_keep in fp32, one rounding. Image sizes
    that are no multiple of the vector width take the narrower vectors."""
    g = torch.randn(shape, generator=_gen(dev, 4), device=dev).to(dtype)
    before = build.LAUNCHES["dropout_mask_apply"]
    out = D.dropout_mask_apply_cuda(g, -7, 0.1)
    assert build.LAUNCHES["dropout_mask_apply"] == before + 1
    assert torch.equal(out, D.dropout_mask_apply_plain(g, -7, 0.1))
    assert torch.equal(D.dropout_mask_apply_plain(g.cpu(), -7, 0.1), out.cpu())


def _grads(fn, args, cot):
    leaves = [a.detach().clone().requires_grad_(a.is_floating_point()) for a in args]
    out = fn(*leaves)
    wanted = [a for a in leaves if a.requires_grad]
    return out, torch.autograd.grad(out, wanted, cot)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", ["gn_silu", "gn_silu_dropout", "conv3x3", "attention_block"])
def test_function_backward_matches_plain_autograd(dev, dtype, op):
    """Each autograd Function (kernel forward; the GroupNorm ones with the
    gn_silu_backward kernel, which applies the dropout mask itself, the conv
    and attention block with their plain version's backward) against
    ordinary autograd of the plain version on the same inputs and cotangent."""
    g = _gen(dev, 5)
    c = 64
    x = torch.randn((2, 8, 8, c), generator=g, device=dev).to(dtype)
    cot = torch.randn((2, 8, 8, c), generator=g, device=dev).to(dtype)
    s = torch.randn(c, generator=g, device=dev) * 0.2 + 1
    b = torch.randn(c, generator=g, device=dev) * 0.2

    def u(*shape):
        return (torch.rand(shape, generator=g, device=dev) * 2 - 1) / c ** 0.5

    if op == "gn_silu":
        args = (x, s, b)
        kernel, plain = fused.gn_silu, G.gn_silu_plain
    elif op == "gn_silu_dropout":
        args = (x, s, b)

        def kernel(x_, s_, b_):
            return fused.gn_silu_dropout(x_, s_, b_, 0.25, 77, train=True)

        def plain(x_, s_, b_):
            return D.gn_silu_dropout_plain(x_, s_, b_, 77, 0.25)
    elif op == "conv3x3":
        args = (x, u(c, 3, 3, c).to(dtype), u(c))
        kernel, plain = fused.conv2d_fused, C.conv3x3_plain
    else:
        args = (x, s, b, u(3 * c, c).to(dtype), u(3 * c), u(c, c).to(dtype), u(c))
        kernel, plain = fused.attention, A.attention_block_plain
    before = dict(build.LAUNCHES)
    out_k, grads_k = _grads(kernel, args, cot)
    out_p, grads_p = _grads(plain, args, cot)
    if op.startswith("gn_silu"):
        assert build.LAUNCHES["gn_silu_backward"] == before["gn_silu_backward"] + 1
        assert build.LAUNCHES["dropout_mask_apply"] == before["dropout_mask_apply"]
    assert out_k.dtype == dtype and len(grads_k) == len(args)
    for got, want, arg in zip(grads_k, grads_p, args):
        assert got.dtype == arg.dtype and got.shape == arg.shape
        # what differs: the GroupNorm backward kernel works in fp32 from x
        # where autograd rounds each bf16 op, and sums in another order
        scale = float(want.float().abs().max())
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        assert float((got.float() - want.float()).abs().max()) <= tol * max(scale, 1.0)


def test_train_forward_and_backward_launch_counts(dev):
    """One loss and backward of a 64-channel UNet on the card: every kernel
    site launches once forward, and each GroupNorm site once backward (the
    dropout mask applied inside that kernel)."""
    from rectified_flow_vision_tpu_torch.models import BaseFlowModel

    model = BaseFlowModel(image_size=16, model_channels=64, channel_mult=[1, 2],
                          num_res_blocks=1, dropout=0.1, device=dev)
    x1 = torch.randn((2, 16, 16, 3), generator=_gen(dev, 6), device=dev)
    build.reset_launches()
    loss = model.loss_fn(x1, torch.Generator(device=dev).manual_seed(0))
    loss.backward()
    # 6 residual blocks: norm1 (+ the head) gn_silu, norm2 gn_silu_dropout;
    # conv1, conv2 and one upsample conv; one mid attention
    assert build.LAUNCHES == {"gn_silu": 7, "gn_silu_streamed": 0, "gn_silu_dropout": 6,
                              "gn_silu_backward": 13,
                              "dropout_mask_apply": 0, "conv3x3": 13, "attention_block": 1,
                              "flash_attention": 0, "flash_attention_backward": 0, "dropout": 0,
                              "ln_modulate": 0, "bias_act": 0, "gated_residual": 0,
                              "qk_norm_rope": 0}
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in model.parameters())
    cpu = BaseFlowModel(image_size=16, model_channels=64, channel_mult=[1, 2],
                        num_res_blocks=1, dropout=0.1, device="cpu", params=model.params)
    gen = torch.Generator(device=dev).manual_seed(0)
    x0 = torch.randn(x1.shape, generator=gen, device=dev)
    t = torch.rand((2,), generator=gen, device=dev)
    seeds = torch.randint(2**31 - 1, (6,), generator=gen, dtype=torch.int32, device=dev)
    ref = cpu.loss_fn(x1.cpu(), x0=x0.cpu(), t=t.cpu(), seeds=seeds.cpu())
    assert abs(float(ref.detach()) - float(loss.detach())) <= 1e-4


def test_remat_on_the_card_gives_the_same_gradients(dev):
    """Residual blocks recomputed in the backward relaunch their kernels with
    the saved seeds: the same loss and gradients, more launches."""
    from rectified_flow_vision_tpu_torch.models import BaseFlowModel

    cfg = dict(image_size=16, model_channels=64, channel_mult=[1, 2], num_res_blocks=1,
               dropout=0.1, device=dev, seed=3)
    x1 = torch.randn((2, 16, 16, 3), generator=_gen(dev, 7), device=dev)
    out = []
    for remat in (False, True):
        model = BaseFlowModel(remat=remat, **cfg)
        build.reset_launches()
        loss = model.loss_fn(x1, torch.Generator(device=dev).manual_seed(1))
        loss.backward()
        out.append((loss.detach(), [p.grad for p in model.parameters()], dict(build.LAUNCHES)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-6)
    assert out[1][2]["gn_silu_dropout"] == 2 * out[0][2]["gn_silu_dropout"] == 12
    assert out[1][2]["gn_silu_backward"] == out[0][2]["gn_silu_backward"] == 13
    assert out[1][2]["dropout_mask_apply"] == out[0][2]["dropout_mask_apply"] == 0


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
    # 4 residual blocks x 2 + the head, on the streamed plan where a group's
    # channels hold no 16-byte vector (2 channels; the up block's 32-channel
    # input, 4 a group, holds one in fp32); 16 channels are outside conv3x3's
    # contract
    streamed = 8 if dtype == "float32" else 9
    assert build.LAUNCHES == {"gn_silu": 9 - streamed, "gn_silu_streamed": streamed,
                              "conv3x3": 0, "attention_block": 1,
                              "gn_silu_dropout": 0, "gn_silu_backward": 0, "dropout_mask_apply": 0,
                              "flash_attention": 0, "flash_attention_backward": 0, "dropout": 0,
                              "ln_modulate": 0, "bias_act": 0, "gated_residual": 0,
                              "qk_norm_rope": 0}
    tol = 1e-3 if dtype == "float32" else 0.03 * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol


def _vae_pair(dev, seed, **cfg):
    """A ConvVAE on the CPU and a copy on the card, its GroupNorm parameters
    moved off ones and zeros."""
    from rectified_flow_vision_tpu_torch.models import ConvVAE

    cpu = ConvVAE(seed=seed, device="cpu", **cfg)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in cpu.modules():
            if isinstance(m, torch.nn.GroupNorm):
                m.weight.copy_(1 + 0.2 * torch.randn(m.weight.shape, generator=g))
                m.bias.copy_(0.2 * torch.randn(m.bias.shape, generator=g))
    gpu = ConvVAE(seed=seed, device=dev, **cfg)
    gpu.load_state_dict(cpu.state_dict())
    return cpu, gpu


def test_dit_decode_on_the_card_matches_the_cpu(dev):
    """The DiT serve cell's ConvVAE decode (base 64, 64x64x4 latents to
    256x256x3) in bf16: three GroupNorm + SiLU slabs on the streamed plan and
    two convs on conv3x3, against the CPU's bf16 decode (each rounds to bf16
    at other points: within 2% rms of the image, 0.1 at any pixel)."""
    cpu, gpu = _vae_pair(dev, 4, image_size=256, base_channels=64)
    z = torch.randn((3, 64, 64, 4), generator=torch.Generator().manual_seed(5))
    build.reset_launches()
    with torch.no_grad():
        want = cpu.decode(z, dtype=torch.bfloat16).float()
        got = gpu.decode(z.to(dev), dtype=torch.bfloat16).float().cpu()
    assert build.LAUNCHES["gn_silu_streamed"] == 3 and build.LAUNCHES["gn_silu"] == 0
    assert build.LAUNCHES["conv3x3"] == 2
    assert got.shape == want.shape == (3, 256, 256, 3)
    assert float((got - want).norm() / want.norm()) <= 2e-2
    assert float((got - want).abs().max()) <= 0.1


def test_vae_train_step_gradients_on_the_card_match_the_cpu(dev):
    """One fp32 loss and backward of a ConvVAE at 128x128 (base 64): its
    GroupNorms forward on both plans (128^2 x 64 and 64^2 x 128 streamed,
    32^2 x 256 on one cluster) with the backward kernel, the decoder's two
    conv3x3 sites, against the CPU from the same noise: the loss within
    1e-4, every gradient within 2e-3 of its parameter's largest entry."""
    from rectified_flow_vision_tpu_torch.models.autoencoder import vae_loss

    cpu, gpu = _vae_pair(dev, 6, image_size=128, base_channels=64)
    g = torch.Generator().manual_seed(7)
    x = torch.tanh(torch.randn((2, 128, 128, 3), generator=g))
    eps = torch.randn((2, 32, 32, 4), generator=g)
    want, _ = vae_loss(cpu, x, 1e-4, eps=eps)
    want.backward()
    build.reset_launches()
    got, _ = vae_loss(gpu, x.to(dev), 1e-4, eps=eps.to(dev))
    got.backward()
    torch.cuda.synchronize()
    assert {k: build.LAUNCHES[k] for k in ("gn_silu", "gn_silu_streamed", "gn_silu_backward",
                                           "conv3x3")} == {"gn_silu": 2, "gn_silu_streamed": 4,
                                                           "gn_silu_backward": 6, "conv3x3": 2}
    assert abs(float(got) - float(want)) <= 1e-4
    for (name, p), q in zip(cpu.named_parameters(), gpu.parameters()):
        scale = float(p.grad.abs().max())
        assert float((q.grad.cpu() - p.grad).abs().max()) <= 2e-3 * scale + 1e-6, name


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
    with pytest.raises(ValueError, match="rate"):
        D.gn_silu_dropout_cuda(x, s, s, 3, 1.0)
    with pytest.raises(ValueError, match="seed"):
        D.gn_silu_dropout_cuda(x, s, s, torch.tensor([3], device=dev), 0.1)  # int64
    with pytest.raises(ValueError, match="contiguous"):
        D.dropout_mask_apply_cuda(x.transpose(1, 2), 3, 0.1)
    # attention_block: any number of tokens (1024 here, no longer rejected);
    # channels that the heads or groups do not divide, or heads wider than
    # 128, are outside the contract
    c = 64
    args = (torch.ones(c, device=dev), torch.zeros(c, device=dev),
            torch.randn((3 * c, c), device=dev) * 0.1, torch.zeros(3 * c, device=dev),
            torch.randn((c, c), device=dev) * 0.1, torch.zeros(c, device=dev))
    big = torch.randn((1, 32, 32, c), device=dev)
    assert A.attention_block_cuda(big, *args).shape == big.shape
    with pytest.raises(ValueError, match="not supported"):
        A.attention_block_cuda(big, *args, num_heads=3)
    with pytest.raises(ValueError, match="not supported"):
        A.attention_block_cuda(big, *args, num_groups=6)
    wide = torch.randn((1, 4, 4, 256), device=dev)
    c = 256
    with pytest.raises(ValueError, match="not supported"):
        A.attention_block_cuda(wide, torch.ones(c, device=dev), torch.zeros(c, device=dev),
                               torch.zeros((3 * c, c), device=dev), torch.zeros(3 * c, device=dev),
                               torch.zeros((c, c), device=dev), torch.zeros(c, device=dev),
                               num_heads=1)


# ---- flash attention and the standalone dropout ---------------------------------


def _qkv(dev, dtype, b, t, h, d, seed=8, packed=True):
    """q, k, v as DiT hands them over: views of one [B, T, 3, H, D] projection
    (or three separate tensors), scaled so that the softmax is far from flat."""
    g = _gen(dev, seed)
    qkv = (torch.randn((b, t, 3, h, d), generator=g, device=dev) * 1.5).to(dtype)
    if packed:
        return qkv.unbind(2)
    return tuple(x.contiguous() for x in qkv.unbind(2))


# bf16: the kernel rounds unnormalised probabilities and divides at the end,
# the plain version rounds normalised ones: a few ulps of outputs of size ~1
FLASH_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4), torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


# head widths 8 to 128 (DiT-S/B/L 64, XL 72; the bf16 kernels pad to 64 or
# 128, the fp32 ones run at D), T a multiple of 128, the
# 16384-token shape, widths the wrapper zero-pads (4, 12, 20), widths above
# 128 (136, 192, 200, 256: bf16 on the 192 / 256 kernels, packed and
# contiguous; fp32 on the *_wide kernels, one chunk) and above 256 (264, 320,
# 384, 512, 640: bf16 on the streamed kernels, ragged widths as views of one
# projection; fp32 in two or three chunks)
FLASH_FWD_CASES = [((2, 1024, 6, 64), True), ((1, 1152, 3, 64), False), ((2, 1024, 4, 32), True),
                   ((2, 1024, 4, 72), True), ((1, 1152, 2, 72), False), ((1, 1024, 2, 128), True),
                   ((1, 1152, 2, 128), False), ((1, 1024, 3, 8), True), ((1, 1024, 2, 96), False),
                   ((2, 16384, 6, 64), True), ((1, 1024, 3, 4), True), ((2, 1024, 2, 12), False),
                   ((1, 1024, 2, 20), True), ((1, 1024, 2, 136), True), ((1, 1152, 2, 256), False),
                   ((1, 1024, 2, 136), False), ((2, 1024, 3, 192), True), ((1, 1152, 2, 192), False),
                   ((1, 1024, 2, 200), True), ((1, 1152, 2, 200), False), ((2, 1024, 3, 256), True),
                   ((1, 1024, 2, 320), True), ((1, 1152, 2, 264), True), ((1, 1024, 2, 264), False),
                   ((1, 1152, 2, 320), False), ((2, 1024, 3, 384), True), ((1, 1024, 2, 512), True),
                   ((1, 1152, 1, 512), False), ((1, 1024, 1, 640), True)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,packed", FLASH_FWD_CASES)
def test_flash_attention_forward(dev, dtype, shape, packed):
    q, k, v = _qkv(dev, dtype, *shape, packed=packed)
    before = build.LAUNCHES["flash_attention"]
    out = fused.flash_attention(q, k, v)
    assert build.LAUNCHES["flash_attention"] == before + 1
    assert out.shape == q.shape and out.dtype == dtype and out.is_contiguous()
    torch.testing.assert_close(out.float(), FA.flash_attention_plain(q, k, v).float(),
                               **FLASH_TOL[dtype])
    _, lse = FA.flash_attention_cuda(q, k, v)
    torch.testing.assert_close(lse, FA.flash_attention_lse_plain(q, k), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,packed", [((2, 1024, 6, 64), True), ((1, 1152, 2, 32), False),
                                          ((2, 1024, 4, 72), True), ((1, 1152, 2, 72), False),
                                          ((1, 1024, 2, 128), True), ((1, 1024, 3, 8), False),
                                          ((1, 1024, 3, 4), True), ((1, 1024, 2, 12), False),
                                          ((1, 1024, 2, 136), True), ((1, 1024, 2, 256), False),
                                          ((1, 1024, 2, 136), False), ((2, 1024, 3, 192), True),
                                          ((1, 1152, 2, 192), False), ((1, 1024, 2, 200), True),
                                          ((1, 1152, 2, 200), False), ((2, 1024, 3, 256), True),
                                          ((1, 1024, 2, 320), True), ((1, 1152, 2, 264), True),
                                          ((1, 1024, 2, 264), False), ((2, 1024, 3, 384), True),
                                          ((1, 1152, 2, 384), False), ((1, 1024, 2, 512), True),
                                          ((1, 1024, 1, 640), True)])
def test_flash_attention_backward(dev, dtype, shape, packed):
    """dq, dk, dv of the kernels against the plain backward (the same
    formulas) and against autograd of the plain forward; two runs give the
    same bits."""
    q, k, v = _qkv(dev, dtype, *shape, seed=9, packed=packed)
    g = torch.randn(shape, generator=_gen(dev, 10), device=dev).to(dtype)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    before = dict(build.LAUNCHES)
    out = fused.flash_attention(*leaves)
    got = torch.autograd.grad(out, leaves, g)
    assert build.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert build.LAUNCHES["flash_attention_backward"] == before["flash_attention_backward"] + 1
    o, lse = FA.flash_attention_cuda(q, k, v)
    want = FA.flash_attention_backward_plain(q, k, v, o, lse, g)
    ref = torch.autograd.grad(FA.flash_attention_plain(*leaves), leaves, g)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for a, b, c in zip(got, want, ref):
        assert a.dtype == dtype and a.shape == tuple(shape)
        scale = max(float(b.float().abs().max()), 1.0)
        assert float((a.float() - b.float()).abs().max()) <= tol * scale
        assert float((a.float() - c.float()).abs().max()) <= 2 * tol * scale
    again = torch.autograd.grad(fused.flash_attention(*leaves), leaves, g)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# the fp32 kernels up to D = 128 (3xTF32 on the tensor cores, compiled at every
# multiple of 8): widths from one n-tile to sixteen, DiT-S/B/L's 64 and XL's
# 72, T from one 128-row block to eight, packed and contiguous q, k, v
F32_TC_CASES = [(d, t, packed) for d in (8, 16, 24, 64, 72, 80, 128) for t in (128, 1024)
                for packed in (True, False)]


@pytest.mark.parametrize("d,t,packed", F32_TC_CASES)
def test_flash_attention_f32_tensor_core_kernels(dev, d, t, packed):
    """The fp32 kernels against the plain versions at FLASH_TOL: output and
    log-sum-exp, then dq, dk, dv against the plain backward's formulas (each
    within 1e-4 of its largest entry); two backward runs give the same
    bits."""
    q, k, v = _qkv(dev, torch.float32, 2, t, 3, d, seed=20 + d, packed=packed)
    g = torch.randn(q.shape, generator=_gen(dev, 21), device=dev)
    out, lse = FA.flash_attention_cuda(q, k, v)
    torch.testing.assert_close(out, FA.flash_attention_plain(q, k, v), **FLASH_TOL[torch.float32])
    torch.testing.assert_close(lse, FA.flash_attention_lse_plain(q, k), rtol=1e-4, atol=1e-3)
    got = FA.flash_attention_backward_cuda(q, k, v, out, lse, g)
    want = FA.flash_attention_backward_plain(q, k, v, out, lse, g)
    for a, b in zip(got, want):
        scale = max(float(b.abs().max()), 1.0)
        assert float((a - b).abs().max()) <= 1e-4 * scale
    again = FA.flash_attention_backward_cuda(q, k, v, out, lse, g)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _attention_f64(q, k, v, g):
    """Forward and (dq, dk, dv) in float64 by autograd, [B, T, H, D]."""
    leaves = [x.double().transpose(1, 2).requires_grad_() for x in (q, k, v)]
    s = leaves[0] @ leaves[1].transpose(-1, -2) / q.shape[-1] ** 0.5
    out = torch.softmax(s, dim=-1) @ leaves[2]
    grads = torch.autograd.grad(out, leaves, g.double().transpose(1, 2))
    return [x.transpose(1, 2) for x in (out.detach(), *grads)]


@pytest.mark.parametrize("d", [64, 72, 128])
@pytest.mark.parametrize("sigma", [1.0, 3.0], ids=["n01", "n03"])
def test_flash_attention_f32_error_against_float64(dev, d, sigma):
    """What exact fp32 stood for: against a float64 computation, the 3xTF32
    kernels' max |error| in the output and in each of dq, dk, dv is at most 4
    times the plain fp32 version's (TF32 off, set by the fixture). N(0, 1)
    inputs, and N(0, 3^2) for peaked rows."""
    gen = _gen(dev, 40 + d)
    q, k, v = (torch.randn((2, 1024, 3, 4, d), generator=gen, device=dev) * sigma).unbind(2)
    g = torch.randn((2, 1024, 4, d), generator=gen, device=dev)
    ref = _attention_f64(q, k, v, g)
    out, lse = FA.flash_attention_cuda(q, k, v)
    kernel = (out, *FA.flash_attention_backward_cuda(q, k, v, out, lse, g))
    p_out = FA.flash_attention_plain(q, k, v)
    p_lse = FA.flash_attention_lse_plain(q, k)
    plain = (p_out, *FA.flash_attention_backward_plain(q, k, v, p_out, p_lse, g))
    for name, a, p, r in zip(("out", "dq", "dk", "dv"), kernel, plain, ref):
        err_k = float((a.double() - r).abs().max())
        err_p = float((p.double() - r).abs().max())
        assert err_k <= 4 * err_p, (name, err_k, err_p)


class _LibrarySpy:
    """The kernel library with every C entry point's arguments recorded."""

    def __init__(self, lib, fail=False):
        self.lib, self.fail, self.calls = lib, fail, []

    def __getattr__(self, name):
        fn = getattr(self.lib, name)

        def call(*args):
            self.calls.append((name, args))
            return 1 if self.fail and name.startswith("rfv_flash") else fn(*args)
        return call


@pytest.mark.parametrize("d", [136, 192, 200, 256, 264, 320, 384, 512])
def test_flash_attention_bf16_routes_by_head_width(dev, monkeypatch, d):
    """bf16 above 128 reaches the C entry points in bf16 at every width (no
    fp32 copy): q, k, v read in place, at the 192 / 256 kernels' width up to
    256 and at D rounded up to 64 above it (the streamed kernels), never the
    plain version. A failed launch raises: no fallback to another kernel or
    the plain version."""
    q, k, v = _qkv(dev, torch.bfloat16, 1, 1024, 2, d)
    g = torch.randn(q.shape, generator=_gen(dev, 15), device=dev).to(torch.bfloat16)

    def plain(*args, **kwargs):
        raise AssertionError("a CUDA tensor took the plain version")
    monkeypatch.setattr(FA, "flash_attention_plain", plain)
    monkeypatch.setattr(FA, "flash_attention_backward_plain", plain)
    spy = _LibrarySpy(build.library())
    monkeypatch.setattr(build, "library", lambda: spy)
    out, lse = FA.flash_attention_cuda(q, k, v)
    FA.flash_attention_backward_cuda(q, k, v, out, lse, g)
    code = build.DTYPE_CODES[torch.bfloat16]
    (fwd, fa), (bwd, ba) = spy.calls
    assert (fwd, fa[9], fa[14]) == ("rfv_flash_attention_fwd", -(-d // 64) * 64, code)
    assert (bwd, ba[14], ba[22]) == ("rfv_flash_attention_bwd", fa[9], code)
    assert fa[:3] == tuple(x.data_ptr() for x in (q, k, v))  # q, k, v read in place
    assert ba[:3] == fa[:3]
    failing = _LibrarySpy(spy.lib, fail=True)
    monkeypatch.setattr(build, "library", lambda: failing)
    before = dict(build.LAUNCHES)
    with pytest.raises(RuntimeError, match="launch failed"):
        FA.flash_attention_cuda(q, k, v)
    with pytest.raises(RuntimeError, match="launch failed"):
        FA.flash_attention_backward_cuda(q, k, v, out, lse, g)
    assert build.LAUNCHES == before


def test_flash_attention_dispatch_and_rejections(dev):
    """Below 1024 tokens, or off a multiple of 128, the plain attention runs
    on the card too (the JAX package's rule); every head width runs a kernel
    (20 zero-padded, 136 on the fp32 *_wide kernels); bf16 reaches the
    kernels with no fp32 copy at every width; what the kernel does not take
    raises."""
    q, k, v = _qkv(dev, torch.float32, 2, 256, 2, 64)
    before = build.LAUNCHES["flash_attention"]
    out = fused.flash_attention(q, k, v)
    assert build.LAUNCHES["flash_attention"] == before
    torch.testing.assert_close(out, FA.flash_attention_plain(q, k, v))
    for d in (136, 20):
        q, k, v = _qkv(dev, torch.float32, 1, 1024, 2, d)
        before = build.LAUNCHES["flash_attention"]
        out = fused.flash_attention(q, k, v)
        assert build.LAUNCHES["flash_attention"] == before + 1 and out.shape == q.shape
        torch.testing.assert_close(out, FA.flash_attention_plain(q, k, v), **FLASH_TOL[q.dtype])
    for d in (72, 136, 200, 256, 264, 320, 512):
        q, k, v = _qkv(dev, torch.bfloat16, 1, 1024, 2, d)
        assert all(x.dtype == torch.bfloat16 for x in FA._kernel_inputs(q, k, v, d))
    with pytest.raises(ValueError, match="head dimension"):
        FA.flash_attention_cuda(*_qkv(dev, torch.float32, 1, 1024, 2, 0))
    with pytest.raises(ValueError, match="tile"):
        FA.flash_attention_cuda(*_qkv(dev, torch.float32, 1, 1000, 2, 64))
    with pytest.raises(ValueError, match="dtype"):
        FA.flash_attention_cuda(*(x.half() for x in _qkv(dev, torch.float32, 1, 1024, 2, 64)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1024, 1024), (3, 8, 8, 64), (2, 5, 7, 3), (70000, 6), (1023,)])
def test_dropout(dev, dtype, shape):
    """The standalone dropout: the plain version's result bit for bit (the
    mask and the values), through ``P.dropout`` too; its gradient is the same
    mask on the cotangent."""
    from rectified_flow_vision_tpu_torch.ops import primitives as P

    x = torch.randn(shape, generator=_gen(dev, 11), device=dev).to(dtype)
    before = build.LAUNCHES["dropout"]
    out = DR.dropout_cuda(x, 41, 0.25)
    assert build.LAUNCHES["dropout"] == before + 1
    assert torch.equal(out, DR.dropout_plain(x, 41, 0.25))
    assert torch.equal(DR.dropout_plain(x.cpu(), 41, 0.25), out.cpu())
    assert torch.equal(P.dropout(x, 0.25, 41, train=True), out)
    assert not torch.equal(DR.dropout_cuda(x, 42, 0.25) != 0, out != 0)
    leaf = x.detach().clone().requires_grad_()
    g = torch.randn(shape, generator=_gen(dev, 12), device=dev).to(dtype)
    (grad,) = torch.autograd.grad(P.dropout(leaf, 0.25, 41, train=True), leaf, g)
    assert torch.equal(grad, DR.dropout_plain(g, 41, 0.25))
    assert build.LAUNCHES["dropout"] == before + 5  # three forwards above, then forward + backward


def test_dropout_contract_at_2_to_20(dev):
    """The contract of the TPU kernel's own test: same seed same mask, another
    seed another mask, kept fraction within 1% of keep, kept values x / keep."""
    x = torch.ones((1024, 1024), device=dev)
    seed = torch.tensor([7], dtype=torch.int32, device=dev)
    a, b = DR.dropout_cuda(x, seed, 0.3), DR.dropout_cuda(x, seed, 0.3)
    c = DR.dropout_cuda(x, seed + 1, 0.3)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert abs(float((a != 0).float().mean()) - 0.7) < 0.01
    torch.testing.assert_close(a[a != 0], torch.full_like(a[a != 0], 1 / 0.7))


@pytest.mark.parametrize("hidden", [128, 144], ids=["head_64", "head_72"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_small_dit_on_the_card_matches_the_cpu(dev, dtype, hidden):
    """A narrow DiT whose 64x64 input gives 1024 tokens: the flash kernels on
    the card against the plain path on the CPU, forward and every gradient,
    with all parameters random (a fresh DiT is the zero function); two heads
    of 64, and of 72 (DiT-XL's head width)."""
    from rectified_flow_vision_tpu_torch.models import BaseFlowModel

    cfg = dict(image_size=64, in_channels=4, backbone="dit", hidden_size=hidden, depth=2,
               num_heads=2, compute_dtype=dtype, seed=0)
    cpu = BaseFlowModel(device="cpu", **cfg)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in cpu.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    gpu = BaseFlowModel(device=dev, **cfg)
    gpu.load_state_dict(cpu.state_dict())
    x1, x0 = torch.randn((2, 2, 64, 64, 4), generator=g).unbind(0)
    t = torch.rand((2,), generator=g)
    want = cpu.loss_fn(x1, x0=x0, t=t)
    want.backward()
    build.reset_launches()
    got = gpu.loss_fn(x1.to(dev), x0=x0.to(dev), t=t.to(dev))
    got.backward()
    assert build.LAUNCHES["flash_attention"] == 2 and build.LAUNCHES["flash_attention_backward"] == 2
    rel = 1e-4 if dtype == "float32" else 3e-2
    assert abs(float(got) - float(want)) <= rel * abs(float(want))
    for (name, pc), pg in zip(cpu.named_parameters(), gpu.parameters()):
        scale = max(float(pc.grad.abs().max()), 1e-6)
        tol = 2e-3 if dtype == "float32" else 6e-2
        assert float((pg.grad.cpu() - pc.grad).abs().max()) <= tol * scale, name


def test_dit_remat_on_the_card_reruns_the_forward_kernel(dev):
    from rectified_flow_vision_tpu_torch.models import BaseFlowModel

    cfg = dict(image_size=64, in_channels=4, backbone="dit", hidden_size=128, depth=2,
               num_heads=2, seed=1, device=dev)
    x1 = torch.randn((2, 64, 64, 4), generator=_gen(dev, 13), device=dev)
    out = []
    for remat in (False, True):
        model = BaseFlowModel(remat=remat, **cfg)
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(torch.randn(p.shape, generator=_gen(dev, 14), device=dev) * 0.05)
        build.reset_launches()
        loss = model.loss_fn(x1, torch.Generator(device=dev).manual_seed(1))
        loss.backward()
        out.append((loss.detach(), [p.grad for p in model.parameters()], dict(build.LAUNCHES)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)
    assert out[0][2]["flash_attention"] == 2 and out[1][2]["flash_attention"] == 4
    assert out[0][2]["flash_attention_backward"] == out[1][2]["flash_attention_backward"] == 2


# ---- the DiT block's glue: ln_modulate, bias_act, gated_residual ----------------

# DiT-S/2 and DiT-XL/2's widths (hidden 384 / 1152, qkv 1152 / 3456, MLP 1536 /
# 4608) and the narrowest the kernels take; 3 x 37 = 111 rows, ragged against
# every row group
GLUE_WIDTHS = [8, 384, 1152, 1536, 3456, 4608]


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each |x| (8 significant bits), the least normal's below it."""
    e = torch.floor(torch.log2(x.float().abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def _glue_args(dev, dtype, c, b=3, t=37, seed=21):
    """Tokens [B, T, C] and the six [B, C] rows as strided views of one [B, 6C]
    projection (row stride 6C), as ``DiTBlock`` chunks its adaLN output."""
    g = _gen(dev, seed)
    x = (torch.randn((b, t, c), generator=g, device=dev) * 1.7 + 0.4).to(dtype)
    mod = (torch.randn((b, 6 * c), generator=g, device=dev) * 0.6).to(dtype)
    y = (torch.randn((b, t, c), generator=g, device=dev) * 2.0).to(dtype)
    bias = torch.randn(c, generator=g, device=dev).to(dtype).float()
    return x, mod.chunk(6, dim=-1), y, bias


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", GLUE_WIDTHS)
def test_ln_modulate(dev, dtype, c):
    """The LayerNorm within one bf16 ulp (fp32: 1e-5) of the plain version's,
    or 1e-6 where it is that close to zero: the fp32 sums' order differs, and
    near zero (x within ~1e-6 sigma of the mean) that order, not the bf16
    rounding, sets the last bits (DiT-S/2's serve shape differs in 81 of 25M
    values, one beyond an ulp, by 3e-9). The modulation on the kernel's own
    LayerNorm bit-equal to the eager composition, with shift and scale read in
    place as strided views. A row wider than four warps hold in registers
    (fp32 above 4096 channels) is refused."""
    from rectified_flow_vision_tpu_torch.ops import dit_glue as DG
    from rectified_flow_vision_tpu_torch.ops import primitives as P

    x, (shift, scale, *_), _, _ = _glue_args(dev, dtype, c)
    assert shift.stride() == (6 * c, 1)
    if c * x.element_size() > 16 * DG.LN_MAX_VECTORS:
        with pytest.raises(ValueError, match="registers"):
            DG.ln_modulate_cuda(x, shift, scale)
        assert dtype == torch.float32 and c == 4608
        return
    zero = torch.zeros_like(shift)
    ln = DG.ln_modulate_cuda(x, zero, zero)
    want = P.layer_norm(x)
    if dtype == torch.float32:
        torch.testing.assert_close(ln, want, rtol=1e-5, atol=1e-5)
    else:
        assert bool(((ln.float() - want.float()).abs() <= _bf16_ulp(want).clamp_min(1e-6)).all())
    before = build.LAUNCHES["ln_modulate"]
    out = DG.ln_modulate_cuda(x, shift, scale)
    assert build.LAUNCHES["ln_modulate"] == before + 1
    assert torch.equal(out, P.modulate(ln, shift, scale))


@pytest.mark.parametrize("act", [None, "gelu_tanh"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", GLUE_WIDTHS)
def test_bias_act(dev, dtype, c, act):
    """The dense epilogue bit-equal to the eager ``(float(y) + b).to(dtype)``;
    with GELU within one bf16 ulp (fp32: 1e-6), the tanh and the products
    contracting differently from PyTorch's kernel."""
    from rectified_flow_vision_tpu_torch.ops import dit_glue as DG

    _, _, y, bias = _glue_args(dev, dtype, c)
    before = build.LAUNCHES["bias_act"]
    out = DG.bias_act_cuda(y, bias, act)
    assert build.LAUNCHES["bias_act"] == before + 1
    want = DG.bias_act_plain(y, bias, act)
    assert out.dtype == want.dtype and out.shape == want.shape
    if act is None:
        assert torch.equal(out, want)
    elif dtype == torch.float32:
        torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)
    else:
        assert bool(((out.float() - want.float()).abs() <= _bf16_ulp(want)).all())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", GLUE_WIDTHS)
def test_gated_residual(dev, dtype, c):
    """tokens + gate * (y + b) bit-equal to the eager composition, the gate a
    strided view of the adaLN projection."""
    from rectified_flow_vision_tpu_torch.ops import dit_glue as DG

    x, (*_, gate), y, bias = _glue_args(dev, dtype, c)
    before = build.LAUNCHES["gated_residual"]
    out = DG.gated_residual_cuda(x, y, bias, gate)
    assert build.LAUNCHES["gated_residual"] == before + 1
    assert torch.equal(out, DG.gated_residual_plain(x, y, bias, gate))


def test_glue_kernels_refuse_what_they_do_not_take(dev):
    from rectified_flow_vision_tpu_torch.ops import dit_glue as DG

    x, (shift, scale, *_), y, bias = _glue_args(dev, torch.bfloat16, 12)
    with pytest.raises(ValueError, match="multiple of 8"):
        DG.ln_modulate_cuda(x, shift, scale)
    with pytest.raises(ValueError, match="multiple of 8"):
        DG.bias_act_cuda(y, bias)
    with pytest.raises(ValueError, match="multiple of 8"):  # the dispatch has no plain route
        fused.gated_residual(x, y, bias, shift)
    x, (shift, scale, *_), y, bias = _glue_args(dev, torch.bfloat16, 64)
    with pytest.raises(ValueError, match="activation"):
        DG.bias_act_cuda(y, bias, "relu")
    with pytest.raises(ValueError, match="float32"):
        DG.bias_act_cuda(y, bias.to(torch.bfloat16))
    with pytest.raises(ValueError, match="shift"):
        DG.ln_modulate_cuda(x, shift.float(), scale)
    for dtype, c in ((torch.bfloat16, 8192), (torch.float32, 4096)):  # the widest rows
        for width in (c, c + 8):
            wide = torch.ones((1, 2, width), device=dev, dtype=dtype)
            row = torch.zeros((1, width), device=dev, dtype=dtype)
            if width == c:
                assert not bool(DG.ln_modulate_cuda(wide, row, row).any())
                continue
            with pytest.raises(ValueError, match="registers"):
                DG.ln_modulate_cuda(wide, row, row)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dit_s2_forward_takes_the_glue_kernels_once_a_site(dev, monkeypatch, dtype):
    """A whole DiT-S/2 forward without grad at batch 4 (1024 tokens), all
    parameters random: the glue kernels against the eager composition on the
    card, at the file's tolerance for a whole model's forward (fp32 1e-3, bf16
    3% of the output's largest entry), and in bf16 no further from the eager
    fp32 forward than the eager bf16 one (root mean square, within 10%); one
    launch a site (two LayerNorms, two epilogues and two gated residuals a
    block, the head's LayerNorm). Under autograd the same launches, and
    every gradient within the file's whole-model tolerance of the eager
    composition's (fp32 2e-3, bf16 6e-2 of its largest entry)."""
    from rectified_flow_vision_tpu_torch.models import dit as TDIT
    from rectified_flow_vision_tpu_torch.ops import dit_glue as DG

    net = TDIT.DiT(input_size=64, size="S").to(dev)
    g = _gen(dev, 31)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=g, device=dev) * 0.05)
    x = torch.randn((4, 64, 64, 4), generator=g, device=dev)
    t = torch.rand((4,), generator=g, device=dev)
    depth = net.cfg.depth
    sites = (2 * depth + 1, 2 * depth, 2 * depth)

    def launches():
        return tuple(build.LAUNCHES[k] for k in ("ln_modulate", "bias_act", "gated_residual"))

    def grads():
        net.zero_grad()
        net(x, t, dtype=dtype, masters=True).float().square().mean().backward()
        return [p.grad.clone() for p in net.parameters()]

    build.reset_launches()
    with torch.no_grad():
        got = net(x, t, dtype=dtype)
    assert launches() == sites
    build.reset_launches()
    got_grads = grads()
    assert launches() == sites and build.LAUNCHES["flash_attention"] == depth
    for name in ("ln_modulate", "bias_act", "gated_residual"):  # the eager composition
        monkeypatch.setattr(fused, name, getattr(DG, f"{name}_plain"))
    build.reset_launches()
    with torch.no_grad():
        want = net(x, t, dtype=dtype)
    want_grads = grads()
    assert launches() == (0, 0, 0)
    got, want = got.float(), want.float()
    tol = 1e-3 if dtype == torch.float32 else 0.03 * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol
    if dtype == torch.bfloat16:
        with torch.no_grad():
            ref = net(x, t, dtype=torch.float32)
        rms = [float((a - ref).square().mean().sqrt()) for a in (got, want)]
        assert rms[0] <= 1.1 * rms[1], rms
    rel = 2e-3 if dtype == torch.float32 else 6e-2
    for (name, _), a, b in zip(net.named_parameters(), got_grads, want_grads):
        assert float((a - b).abs().max()) <= rel * max(float(b.abs().max()), 1e-6), name


# ---- FLUX's QK-RMSNorm + RoPE: qk_norm_rope --------------------------------------


def _qkr_streams(dev, dtype, heads, d, lengths=(37, 111), b=2, seed=41):
    """Text and image streams of random qkv and QK-norm scales, and the
    tables of their positions: text at 0, the image a 3-row grid."""
    from rectified_flow_vision_tpu_torch.models import flux as TFX

    g = _gen(dev, seed)
    c = heads * d
    streams = [(torch.randn((b, n, 3 * c), generator=g, device=dev).to(dtype),
                1 + 0.3 * torch.randn((d,), generator=g, device=dev),
                1 + 0.3 * torch.randn((d,), generator=g, device=dev)) for n in lengths]
    axes = (d // 4, 3 * d // 8, 3 * d // 8) if d >= 16 else (d // 2, d // 4, d // 4)
    ids = TFX.positions(lengths[0], 3, lengths[1] // 3, dev)
    return streams, TFX.rope_tables(ids, axes, 10000)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("heads,d", [(24, 128), (6, 64), (4, 16), (3, 8)])
def test_qk_norm_rope(dev, dtype, heads, d):
    """The kernel against its plain version on the card, two streams into one
    joint buffer: v copied bit for bit; q and k within one rounding of the
    output dtype (bf16: both sides round once from fp32 values that differ
    by the sum's order and rsqrtf) and fp32 within 2e-6; one launch a
    stream."""
    from rectified_flow_vision_tpu_torch.ops import qk_norm_rope as QR

    if not QR.supports(heads * d, d, dtype):
        pytest.skip(f"{heads} x {d} {dtype} is outside the kernel")
    streams, (cos, sin) = _qkr_streams(dev, dtype, heads, d)
    build.reset_launches()
    got = fused.qk_norm_rope(streams, cos, sin, heads)
    assert build.LAUNCHES["qk_norm_rope"] == 2
    want = QR.joint_plain(streams, cos, sin, heads)
    assert got.shape == want.shape == (2, 148, 3, heads, d) and got.is_contiguous()
    assert torch.equal(got[:, :, 2], want[:, :, 2])
    tol = dict(rtol=2e-6, atol=2e-6) if dtype == torch.float32 else dict(rtol=8e-3, atol=8e-3)
    torch.testing.assert_close(got[:, :, :2].float(), want[:, :, :2].float(), **tol)
    q, k, _ = got.float().unbind(2)  # flash reads the slices in place
    assert q.stride() == k.stride() and q.stride(1) == 3 * heads * d


def test_qk_norm_rope_at_flux_shapes_and_its_backward(dev):
    """FLUX.1's joint sequence at 1024 px (256 text + 4096 image tokens, 24
    heads of 128, bf16): within one bf16 rounding of the plain version; the
    backward differentiates the plain version, so its gradients are the
    plain version's own."""
    from rectified_flow_vision_tpu_torch.models import flux as TFX
    from rectified_flow_vision_tpu_torch.ops import qk_norm_rope as QR

    g = _gen(dev, 43)
    streams = [(torch.randn((1, n, 3 * 3072), generator=g, device=dev).bfloat16(),
                1 + 0.3 * torch.randn((128,), generator=g, device=dev),
                1 + 0.3 * torch.randn((128,), generator=g, device=dev)) for n in (256, 4096)]
    cos, sin = TFX.rope_tables(TFX.positions(256, 64, 64, dev), (16, 56, 56), 10000)
    got = fused.qk_norm_rope(streams, cos, sin, 24)
    want = QR.joint_plain(streams, cos, sin, 24)
    torch.testing.assert_close(got.float(), want.float(), rtol=8e-3, atol=8e-3)
    ulp = (got.float() - want.float()).abs() > 0
    assert float(ulp.float().mean()) < 0.01  # a value in a hundred or fewer differ at all
    leaves = [tuple(x.detach().float().requires_grad_(True) for x in s) for s in streams[:1]]
    g = torch.randn((1, 256, 3, 24, 128), device=dev, generator=_gen(dev, 5))
    text = cos[:256], sin[:256]
    got_grads = torch.autograd.grad(fused.qk_norm_rope(leaves, *text, 24), leaves[0], g)
    want_grads = torch.autograd.grad(QR.joint_plain(leaves, *text, 24), leaves[0], g)
    for a, b in zip(got_grads, want_grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_qk_norm_rope_refuses_what_it_does_not_take(dev):
    from rectified_flow_vision_tpu_torch.ops import qk_norm_rope as QR

    streams, (cos, sin) = _qkr_streams(dev, torch.bfloat16, 4, 16)
    out = torch.empty((2, 148, 3, 4, 16), device=dev, dtype=torch.bfloat16)
    qkv, qs, ks = streams[0]
    with pytest.raises(ValueError, match="rows"):
        QR.qk_norm_rope_cuda(qkv, qs, ks, cos, sin, out, 120)
    with pytest.raises(ValueError, match="float32"):
        QR.qk_norm_rope_cuda(qkv, qs.double(), ks, cos, sin, out, 0)
    wide = torch.zeros((1, 4, 3 * 96), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="power of two"):
        QR.qk_norm_rope_cuda(wide, torch.ones(96, device=dev), torch.ones(96, device=dev),
                             torch.zeros(4, 48, device=dev), torch.zeros(4, 48, device=dev),
                             torch.empty((1, 4, 3, 1, 96), device=dev, dtype=torch.bfloat16), 0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_flux_forward_takes_its_kernels_on_the_card(dev, dtype):
    """A small FLUX (hidden 64, 4 heads of 16, 1 double + 2 single blocks,
    8 text tokens, 16 x 16 x 4 latents) on the card against the same network
    on the CPU: fp32 within 1e-3 of the output's largest entry (reordered
    sums, TF32 off), bf16 within 4% (one rounding a pass on the card); one
    qk_norm_rope launch a stream of a block, the glue kernels at every site."""
    from rectified_flow_vision_tpu_torch.models import flux as TFX

    cfg = dict(input_size=16, in_channels=4, hidden_size=64, num_heads=4, depth=1,
               depth_single_blocks=2, context_in_dim=32, context_tokens=8, vec_in_dim=24,
               axes_dim=(4, 6, 6))
    cpu = TFX.Flux(**cfg)
    g = torch.Generator().manual_seed(9)
    with torch.no_grad():
        for name, p in cpu.named_parameters():
            z = torch.randn(p.shape, generator=g)
            p.copy_(1 + 0.3 * z if name.endswith("norm.scale") else
                    (0.1 * z if p.ndim == 1 else z / p.shape[1] ** 0.5))
    card = TFX.Flux(**cfg).to(dev)
    card.load_state_dict(cpu.state_dict())
    x = torch.randn((2, 16, 16, 4), generator=g)
    t = torch.tensor([0.2, 0.7])
    cond = {"txt": torch.randn((2, 8, 32), generator=g), "vec": torch.randn((2, 24), generator=g)}
    build.reset_launches()
    with torch.no_grad():
        got = card(x.to(dev), t.to(dev), dtype=dtype,
                   cond={k: c.to(dev) for k, c in cond.items()}).float().cpu()
        want = cpu(x, t, dtype=torch.float32, cond=cond)
    assert build.LAUNCHES["qk_norm_rope"] == 2 * 1 + 2
    assert build.LAUNCHES["ln_modulate"] == 4 * 1 + 2 + 1
    assert build.LAUNCHES["gated_residual"] == 4 * 1 + 2
    tol = (1e-3 if dtype == torch.float32 else 0.04) * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol

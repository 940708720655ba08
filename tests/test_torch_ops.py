"""The port's primitives and the plain versions of its kernels, held against
the JAX package on the CPU.

Inputs come from a numpy seed and go through both packages. The Pallas
kernels run in interpret mode (``K.set_interpret(True)``), as the JAX
package's own tests run them on the CPU. Tolerances:

* fp32: rtol/atol 1e-5. Both sides compute the same fp32 arithmetic; only
  the order of the sums differs (XLA's vs ATen's reductions and GEMMs).
* fp32 attention: 1e-4. Two chained GEMMs and a softmax over 256 keys
  accumulate more reordering error than one reduction.
* bf16: 2e-2. One bf16 ulp is 2^-8 relative (0.4%); the two sides round
  intermediates at the same points but accumulate in different orders, so a
  few ulps of disagreement on O(1) values is expected.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectified_flow_vision_tpu.ops import conv_pallas as JC
from rectified_flow_vision_tpu.ops import pallas_kernels as K
from rectified_flow_vision_tpu.ops import primitives as JP
from rectified_flow_vision_tpu_torch.ops import attention as TA
from rectified_flow_vision_tpu_torch.ops import conv3x3 as TC
from rectified_flow_vision_tpu_torch.ops import fused as TF
from rectified_flow_vision_tpu_torch.ops import gn_silu as TG
from rectified_flow_vision_tpu_torch.ops import primitives as TP

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture(autouse=True)
def interpret_mode():
    K.set_interpret(True)
    yield
    K.set_interpret(False)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32)).astype(dtype)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _gn_inputs(shape, seed=0):
    r = _rng(seed)
    c = shape[-1]
    x = r.standard_normal(shape).astype(np.float32) * 2 + 0.3
    scale = r.standard_normal(c).astype(np.float32) * 0.2 + 1.0
    bias = r.standard_normal(c).astype(np.float32) * 0.2
    return x, scale, bias


def _attn_params(c, seed=1):
    r = _rng(seed)
    bound = 1.0 / np.sqrt(c)
    u = lambda *s: r.uniform(-bound, bound, s).astype(np.float32)  # noqa: E731
    return {
        "norm": {
            "scale": (r.standard_normal(c) * 0.2 + 1.0).astype(np.float32),
            "bias": (r.standard_normal(c) * 0.2).astype(np.float32),
        },
        "qkv": {"w": u(c, 3 * c), "b": u(3 * c)},  # JAX (in, out)
        "proj": {"w": u(c, c), "b": u(c)},
    }


def _attn_torch_args(p, dtype):
    """JAX (in, out) dense weights -> torch Linear (out, in) in ``dtype``;
    norm parameters and biases fp32 (rounded through ``dtype`` first, as the
    port's UNet hands them to the kernel)."""
    f = lambda a: _t(a, dtype).float()  # noqa: E731
    return (
        f(p["norm"]["scale"]), f(p["norm"]["bias"]),
        _t(p["qkv"]["w"].T, dtype), f(p["qkv"]["b"]),
        _t(p["proj"]["w"].T, dtype), f(p["proj"]["b"]),
    )


def _jax_tree(p, dtype):
    return jax.tree_util.tree_map(lambda a: _j(a, dtype), p)


class TestGnSilu:
    @pytest.mark.parametrize("shape", [(2, 16, 16, 256), (1, 8, 8, 64), (3, 4, 4, 32)])
    def test_plain_matches_pallas_and_xla_fp32(self, shape):
        """fp32: the same per-group fp32 statistics on both sides (1e-5)."""
        x, s, b = _gn_inputs(shape)
        out = TG.gn_silu_plain(_t(x), _t(s), _t(b), num_groups=8)
        pallas = K.gn_silu(_j(x), _j(s), _j(b), num_groups=8)
        xla = JP.silu(JP.group_norm(_j(x), {"scale": _j(s), "bias": _j(b)}, num_groups=8))
        np.testing.assert_allclose(_np(out), _np(pallas), **F32)
        np.testing.assert_allclose(_np(out), _np(xla), **F32)

    def test_plain_matches_pallas_and_xla_bf16(self):
        """bf16 in/out, fp32 statistics: a few bf16 ulps apart (2e-2)."""
        x, s, b = _gn_inputs((2, 8, 8, 64), seed=3)
        out = TG.gn_silu_plain(_t(x, torch.bfloat16), _t(s), _t(b), num_groups=8)
        assert out.dtype == torch.bfloat16
        xb = _j(x, jnp.bfloat16)
        pallas = K.gn_silu(xb, _j(s), _j(b), num_groups=8)
        xla = JP.silu(JP.group_norm(xb, {"scale": _j(s), "bias": _j(b)}, num_groups=8))
        np.testing.assert_allclose(_np(out), _np(pallas), **BF16)
        np.testing.assert_allclose(_np(out), _np(xla), **BF16)


# (shape, dtype): 2 and 4 channels a group, and 3 (C = 24: gn_silu's narrower vectors)
GN_BWD_CASES = [(s, d) for s in [(2, 8, 8, 16), (1, 16, 16, 32), (2, 4, 4, 24)]
                for d in ("float32", "bfloat16")]


def _gn_bwd_inputs(shape, dtype, seed):
    x, s, b = _gn_inputs(shape, seed=seed)
    g = _rng(seed + 100).standard_normal(shape).astype(np.float32)
    return x, s, b, g, getattr(torch, dtype), getattr(jnp, dtype)


def _assert_grads(got, want, dtype):
    """fp32: 1e-5 of each gradient's largest entry; bf16: 2e-2 of it."""
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for name, a, w in zip(("dx", "dscale", "dbias"), got, want):
        a, w = _np(a), _np(w)
        assert a.shape == w.shape, name
        assert np.abs(a - w).max() <= tol * np.abs(w).max(), name


class TestGnSiluBackward:
    """``gn_silu_backward_plain`` (the backward kernel's formulas, from the
    saved statistics) against ``jax.vjp`` of the JAX package's ``_gn_silu_xla``,
    the VJP its ``custom_vjp`` takes."""

    @pytest.mark.parametrize("shape,dtype", GN_BWD_CASES)
    def test_plain_backward_matches_jax_vjp(self, shape, dtype):
        from rectified_flow_vision_tpu.ops import fused as JF

        x, s, b, g, tdt, jdt = _gn_bwd_inputs(shape, dtype, seed=20)
        _, vjp = jax.vjp(lambda x_, s_, b_: JF._gn_silu_xla(x_, s_, b_, 8),
                         _j(x, jdt), _j(s), _j(b))
        want = vjp(_j(g, jdt))
        tx = _t(x, tdt)
        got = TG.gn_silu_backward_plain(tx, _t(g, tdt), _t(s), _t(b), TG.gn_stats_plain(tx))
        assert got[0].dtype == tdt and got[1].dtype == torch.float32
        _assert_grads(got, want, tdt)

    @pytest.mark.parametrize("shape,dtype", GN_BWD_CASES)
    def test_dropout_backward_matches_jax_vjp_of_the_masked_cotangent(self, shape, dtype):
        """The dropout variant: ``jax.vjp`` applied to g * mask / keep, with
        the port's Philox mask (the contract)."""
        from rectified_flow_vision_tpu.ops import fused as JF
        from rectified_flow_vision_tpu_torch.ops import gn_silu_dropout as TD

        x, s, b, g, tdt, jdt = _gn_bwd_inputs(shape, dtype, seed=21)
        seed, rate = 99, 0.3
        keep = TD.keep_mask(shape, seed, rate, torch.device("cpu")).numpy()
        gm = np.where(keep, g / (1.0 - rate), 0.0).astype(np.float32)
        _, vjp = jax.vjp(lambda x_, s_, b_: JF._gn_silu_xla(x_, s_, b_, 8),
                         _j(x, jdt), _j(s), _j(b))
        want = vjp(_j(gm, jdt))
        tx = _t(x, tdt)
        got = TD.gn_silu_dropout_backward_plain(tx, _t(g, tdt), _t(s), _t(b),
                                                TG.gn_stats_plain(tx), seed, rate)
        _assert_grads(got, want, tdt)

    @pytest.mark.parametrize("shape", [(2, 8, 8, 16), (1, 16, 16, 32), (2, 4, 4, 24)])
    def test_saved_statistics_match_jax_group_stats(self, shape):
        """The forward's saved mean and 1/sigma against the Pallas kernel's
        ``_group_stats``, image by image (per channel there, per group here)."""
        x, _, _ = _gn_inputs(shape, seed=22)
        stats = TG.gn_stats_plain(_t(x)).numpy()
        cg = shape[-1] // 8
        for i in range(shape[0]):
            mean_c, inv_c = K._group_stats(_j(x[i].reshape(-1, shape[-1])), 8, 1e-5)
            np.testing.assert_allclose(np.repeat(stats[i, :, 0], cg), _np(mean_c)[0], **F32)
            np.testing.assert_allclose(np.repeat(stats[i, :, 1], cg), _np(inv_c)[0], rtol=1e-4)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_plain_backward_matches_autograd_of_the_plain_forward(self, dtype):
        """The CPU path's ordinary autograd of ``gn_silu_plain`` and the
        hand-written formulas agree (bf16: the autograd chain rounds between
        ops, the formulas once)."""
        x, s, b, g, tdt, _ = _gn_bwd_inputs((2, 8, 8, 64), dtype, seed=23)
        leaves = [_t(x, tdt).requires_grad_(), _t(s).requires_grad_(), _t(b).requires_grad_()]
        want = torch.autograd.grad(TF.gn_silu(*leaves), leaves, _t(g, tdt))
        tx = leaves[0].detach()
        got = TG.gn_silu_backward_plain(tx, _t(g, tdt), _t(s), _t(b), TG.gn_stats_plain(tx))
        tol = 1e-5 if tdt == torch.float32 else 2e-2
        for a, w in zip(got, want):
            assert float((a.float() - w.float()).abs().max()) <= tol * float(w.float().abs().max())


class TestConv3x3:
    def test_plain_matches_pallas_fp32(self):
        """fp32 at (1, 8, 8, 64 -> 64): same products, other summation order (1e-5)."""
        r = _rng(4)
        x = r.standard_normal((1, 8, 8, 64)).astype(np.float32)
        w = (r.standard_normal((3, 3, 64, 64)) * 0.1).astype(np.float32)  # HWIO
        b = r.standard_normal(64).astype(np.float32)
        out = TC.conv3x3_plain(_t(x), _t(w.transpose(3, 0, 1, 2)), _t(b))
        ref = JC.conv3x3(_j(x), _j(w), _j(b))
        np.testing.assert_allclose(_np(out), _np(ref), **F32)

    @pytest.mark.parametrize(
        "shape,cout", [((2, 16, 8, 64), 64), ((1, 8, 8, 64), 128), ((1, 8, 16, 192), 128)]
    )
    def test_plain_matches_xla_conv_fp32(self, shape, cout):
        """fp32 against ``P.conv2d`` with symmetric pad 1 (1e-5, relative to
        outputs of O(1))."""
        r = _rng(5)
        x = r.standard_normal(shape).astype(np.float32)
        w = (r.standard_normal((3, 3, shape[-1], cout)) * 0.05).astype(np.float32)
        b = r.standard_normal(cout).astype(np.float32)
        out = TC.conv3x3_plain(_t(x), _t(w.transpose(3, 0, 1, 2)), _t(b))
        ref = JP.conv2d(_j(x), {"w": _j(w), "b": _j(b)})
        np.testing.assert_allclose(_np(out), _np(ref), **F32)

    def test_plain_matches_xla_conv_bf16(self):
        """bf16 conv, fp32 bias, one rounding to bf16 on each side (2e-2)."""
        r = _rng(6)
        x = r.standard_normal((1, 8, 8, 64)).astype(np.float32)
        w = (r.standard_normal((3, 3, 64, 64)) * 0.05).astype(np.float32)
        b = r.standard_normal(64).astype(np.float32)
        out = TC.conv3x3_plain(
            _t(x, torch.bfloat16), _t(w.transpose(3, 0, 1, 2), torch.bfloat16), _t(b)
        )
        assert out.dtype == torch.bfloat16
        ref = JP.conv2d(_j(x, jnp.bfloat16), {"w": _j(w, jnp.bfloat16), "b": _j(b)})
        np.testing.assert_allclose(_np(out), _np(ref), **BF16)

    @pytest.mark.parametrize(
        "x_shape,w_shape,stride,ok",
        [
            ((1, 16, 16, 64), (64, 3, 3, 64), 1, True),
            ((1, 8, 256, 128), (192, 3, 3, 128), 1, True),
            ((1, 16, 16, 64), (64, 3, 3, 64), 2, False),
            ((1, 16, 16, 3), (64, 3, 3, 3), 1, False),
            ((1, 16, 16, 64), (3, 3, 3, 64), 1, False),
            ((1, 16, 16, 64), (64, 1, 1, 64), 1, False),
            ((1, 16, 4, 64), (64, 3, 3, 64), 1, False),
            ((1, 16, 512, 64), (64, 3, 3, 64), 1, False),
        ],
    )
    def test_supports_matches_jax_contract(self, x_shape, w_shape, stride, ok):
        """The contract is the JAX ``conv_pallas.supports`` one (w OHWI here,
        HWIO there)."""
        o, kh, kw, i = w_shape
        assert TC.supports(x_shape, w_shape, stride) is ok
        assert JC.supports(x_shape, (kh, kw, i, o), stride) is ok

    @pytest.mark.parametrize(
        "x_shape,w_shape,ok",
        [
            ((1, 16, 16, 32), (64, 3, 3, 32), True),
            ((1, 16, 16, 64), (32, 3, 3, 64), True),
            ((1, 16, 16, 16), (48, 3, 3, 16), True),
            ((1, 16, 16, 8), (64, 3, 3, 8), False),
            ((1, 16, 16, 64), (24, 3, 3, 64), False),
            ((1, 16, 16, 32), (64, 1, 1, 32), False),
        ],
    )
    def test_kernel_takes_tensor_parallel_slices(self, x_shape, w_shape, ok):
        """The kernel takes channels in multiples of 16 (a rank's slice of a
        site's 64 at model_axis 4); which convs are its sites stays the JAX
        contract."""
        assert TC.supports(x_shape, w_shape, 1, multiple=TC.KERNEL_MULTIPLE) is ok
        assert TC.supports(x_shape, w_shape, 1) is False


    @pytest.mark.parametrize("h,w,cin,cout", [
        (64, 64, 64, 64), (64, 64, 192, 64), (64, 64, 128, 128), (32, 32, 64, 128),
        (32, 32, 128, 128), (32, 32, 384, 128), (32, 32, 256, 256), (16, 16, 128, 256),
        (16, 16, 256, 256), (16, 16, 512, 256), (9, 8, 64, 64), (8, 256, 64, 64),
        (11, 10, 128, 192), (8, 8, 576, 512), (8, 200, 64, 320),
        # the attention block's projections (C -> 3C, C -> C) as one-tap convs
        (16, 16, 256, 768), (32, 32, 128, 384), (8, 8, 16, 48), (5, 7, 64, 192),
    ])
    def test_tile_config(self, h, w, cin, cout):
        """The bf16 wgmma kernel's tiling: every output channel in one tile up
        to 256 (else a divisor of Cout), a box of whole image rows (Wb a power
        of two covering W up to 128) of 256 pixels where the channel tile is
        narrow, a ring of at least four stages that fits the H100's 232,448
        bytes of shared memory a block."""
        cfg = TC.tile_config(h, w, cin, cout)
        bn = cfg["bn"]
        assert bn in (64, 128, 192, 256)
        if cout <= 256:
            assert bn >= cout and (bn == 64 or bn - 64 < cout)
        else:
            assert cout % bn == 0 or (bn == 256 and cout % 64)
        assert cfg["bm"] == (256 if bn <= 128 else 128)
        assert cfg["wb"] * cfg["hb"] == cfg["bm"] and cfg["wb"] & (cfg["wb"] - 1) == 0
        assert cfg["wb"] >= min(w, 128) and (cfg["wb"] < 2 * w or cfg["wb"] == 8)
        stage = cfg["bm"] * 64 * 2 + bn * 64 * 2
        assert 4 <= cfg["stages"] <= TC.MAX_STAGES
        assert cfg["smem"] == cfg["stages"] * stage + 1024 + 16 * cfg["stages"]
        assert cfg["smem"] <= TC.SMEM_LIMIT == 232448
        assert cfg["smem"] + stage > TC.SMEM_LIMIT or cfg["stages"] == TC.MAX_STAGES
        rows, cols = -(-h // cfg["hb"]), -(-w // cfg["wb"])
        assert cfg["tiles_per_image"] == rows * cols * -(-cout // bn)


class TestAttentionBlock:
    @pytest.mark.parametrize("shape", [(2, 16, 16, 256), (1, 8, 8, 64), (1, 32, 32, 256)])
    def test_plain_matches_pallas_and_xla_fp32(self, shape):
        """fp32: GEMMs + fp32 softmax, reordered sums (1e-4). (1, 32, 32, 256)
        is a 128x128 UNet's mid block: 1024 tokens, which the CUDA kernels
        take too."""
        c = shape[-1]
        x = _rng(7).standard_normal(shape).astype(np.float32)
        p = _attn_params(c)
        out = TA.attention_block_plain(_t(x), *_attn_torch_args(p, torch.float32))
        pallas = K.attention_block(_j(x), _jax_tree(p, jnp.float32), num_heads=4, num_groups=8)
        xla = JP.spatial_attention(_j(x), _jax_tree(p, jnp.float32), num_heads=4, num_groups=8)
        np.testing.assert_allclose(_np(out), _np(pallas), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(_np(out), _np(xla), rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("c,heads,groups,dtype,ok", [
        (256, 4, 8, torch.bfloat16, True), (256, 4, 8, torch.float32, True),
        (16, 4, 8, torch.bfloat16, True), (512, 4, 8, torch.float32, True),
        (512, 2, 8, torch.float32, False),  # heads of 256
        (64, 3, 8, torch.bfloat16, False), (64, 4, 6, torch.bfloat16, False),
        (12, 4, 4, torch.bfloat16, False), (12, 4, 4, torch.float32, True),  # TMA: C % 8
        (2048, 16, 32, torch.bfloat16, True), (4096, 32, 32, torch.bfloat16, False),
        (64, 4, 64, torch.float32, False),  # more than 32 groups
    ])
    def test_kernel_contract(self, c, heads, groups, dtype, ok):
        """What the CUDA kernels take: any number of tokens; C divided by the
        heads (at most 128 wide) and by at most 32 groups; C / V <= 256 for
        the GroupNorm statistics pass."""
        assert TA.supports(c, heads, groups, dtype) is ok

    def test_plain_matches_xla_bf16(self):
        """bf16: the plain version rounds where ``P.spatial_attention`` does
        (2e-2)."""
        x = _rng(8).standard_normal((2, 8, 8, 128)).astype(np.float32)
        p = _attn_params(128)
        out = TA.attention_block_plain(
            _t(x, torch.bfloat16), *_attn_torch_args(p, torch.bfloat16)
        )
        assert out.dtype == torch.bfloat16
        xla = JP.spatial_attention(
            _j(x, jnp.bfloat16), _jax_tree(p, jnp.bfloat16), num_heads=4, num_groups=8
        )
        np.testing.assert_allclose(_np(out), _np(xla), **BF16)


class TestPrimitives:
    @pytest.mark.parametrize(
        "shape,k,stride", [((2, 8, 8, 16), 3, 2), ((1, 7, 7, 8), 3, 2), ((1, 8, 8, 16), 1, 1),
                           ((1, 6, 6, 3), 3, 1)]
    )
    def test_conv2d_symmetric_padding(self, shape, k, stride):
        """Symmetric k//2 padding (not "SAME"): on even sizes at stride 2
        "SAME" would pad (0, 1) and shift every output (1e-5)."""
        r = _rng(9)
        cout = 12
        x = r.standard_normal(shape).astype(np.float32)
        w = (r.standard_normal((k, k, shape[-1], cout)) * 0.2).astype(np.float32)
        b = r.standard_normal(cout).astype(np.float32)
        out = TP.conv2d(_t(x), _t(w.transpose(3, 2, 0, 1)), _t(b), stride=stride)
        ref = JP.conv2d(_j(x), {"w": _j(w), "b": _j(b)}, stride=stride)
        assert tuple(out.shape) == tuple(ref.shape)
        np.testing.assert_allclose(_np(out), _np(ref), **F32)

    def test_dense(self):
        """fp32 GEMM + fp32 bias (1e-5)."""
        r = _rng(10)
        x = r.standard_normal((4, 5, 32)).astype(np.float32)
        w = r.standard_normal((32, 48)).astype(np.float32) * 0.1
        b = r.standard_normal(48).astype(np.float32)
        out = TP.dense(_t(x), _t(w.T), _t(b))
        ref = JP.dense(_j(x), {"w": _j(w), "b": _j(b)})
        np.testing.assert_allclose(_np(out), _np(ref), **F32)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_group_norm(self, dtype):
        """fp32 statistics either way; bf16 output rounded once (tolerance per dtype)."""
        x, s, b = _gn_inputs((2, 4, 4, 32), seed=11)
        tdt, jdt = (torch.float32, jnp.float32) if dtype == "float32" else (
            torch.bfloat16, jnp.bfloat16)
        out = TP.group_norm(_t(x, tdt), _t(s), _t(b), num_groups=8)
        ref = JP.group_norm(_j(x, jdt), {"scale": _j(s), "bias": _j(b)}, num_groups=8)
        np.testing.assert_allclose(_np(out), _np(ref), **(F32 if dtype == "float32" else BF16))

    def test_silu(self):
        x = np.linspace(-8, 8, 101).astype(np.float32)
        np.testing.assert_allclose(_np(TP.silu(_t(x))), _np(JP.silu(_j(x))), **F32)

    def test_upsample_nearest_2x(self):
        """Pure data movement: exact."""
        x = _rng(12).standard_normal((2, 3, 5, 4)).astype(np.float32)
        out = TP.upsample_nearest_2x(_t(x))
        np.testing.assert_array_equal(_np(out), _np(JP.upsample_nearest_2x(_j(x))))

    @pytest.mark.parametrize("dim", [32, 64])
    def test_sinusoidal_time_embedding(self, dim):
        """The (half - 1) frequency denominator; fp32 sin/cos of args up to
        1 (1e-5)."""
        t = np.array([0.0, 0.25, 0.5, 0.999, 1.0], np.float32)
        out = TP.sinusoidal_time_embedding(_t(t), dim)
        ref = JP.sinusoidal_time_embedding(_j(t), dim)
        np.testing.assert_allclose(_np(out), _np(ref), **F32)

    def test_dropout_eval_is_identity(self):
        x = _t(_rng(13).standard_normal((2, 3)))
        assert TP.dropout(x, 0.1, train=False) is x
        assert TP.dropout(x, 0.0, 5, train=True) is x
        assert TP.dropout(x, 0.1, None, train=True) is x  # no seed: as a JAX rng of None
        out = TP.dropout(_t(np.ones((4, 64), np.float32)), 0.25, 5, train=True)
        assert set(np.unique(_np(out))) == {0.0, np.float32(1.0) / np.float32(0.75)}


class TestDispatch:
    def test_cpu_tensors_take_the_plain_versions(self):
        """``ops.fused`` on CPU tensors equals each kernel's plain version,
        and launches nothing."""
        from rectified_flow_vision_tpu_torch.ops import build

        build.reset_launches()
        x, s, b = _gn_inputs((1, 8, 8, 64), seed=14)
        np.testing.assert_array_equal(
            _np(TF.gn_silu(_t(x), _t(s), _t(b))), _np(TG.gn_silu_plain(_t(x), _t(s), _t(b)))
        )
        w = _t(_rng(15).standard_normal((64, 3, 3, 64)) * 0.05)
        np.testing.assert_array_equal(
            _np(TF.conv2d_fused(_t(x), w, _t(b))), _np(TC.conv3x3_plain(_t(x), w, _t(b)))
        )
        args = _attn_torch_args(_attn_params(64), torch.float32)
        np.testing.assert_array_equal(
            _np(TF.attention(_t(x), *args)), _np(TA.attention_block_plain(_t(x), *args))
        )
        assert set(build.LAUNCHES) >= {"gn_silu", "conv3x3", "attention_block"}
        assert sum(build.LAUNCHES.values()) == 0

    def test_conv_outside_contract_is_the_plain_conv(self):
        """A 3x3 conv with Cin = 3 is outside the contract: plain conv on
        every device, equal to ``P.conv2d``."""
        r = _rng(16)
        x = _t(r.standard_normal((1, 8, 8, 3)))
        w_ohwi = _t(r.standard_normal((64, 3, 3, 3)) * 0.1)
        b = _t(r.standard_normal(64))
        out = TF.conv2d_fused(x, w_ohwi, b)
        ref = TP.conv2d(x, w_ohwi.permute(0, 3, 1, 2), b)
        np.testing.assert_array_equal(_np(out), _np(ref))

    @pytest.mark.parametrize("op", ["gn_silu", "conv3x3", "attention_block"])
    def test_non_cpu_tensor_takes_the_kernel_or_raises(self, op):
        """A tensor off the CPU never takes the plain version: on a device
        without the kernel (``meta``) the wrapper raises."""
        x = torch.empty((1, 8, 8, 64), device="meta")
        s = torch.empty(64, device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            if op == "gn_silu":
                TF.gn_silu(x, s, s)
            elif op == "conv3x3":
                TF.conv2d_fused(x, torch.empty((64, 3, 3, 64), device="meta"), s)
            else:
                w3 = torch.empty((192, 64), device="meta")
                w1 = torch.empty((64, 64), device="meta")
                TF.attention(x, s, s, w3, torch.empty(192, device="meta"), w1, s)

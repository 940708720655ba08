"""The port's flash attention and standalone dropout (plain versions) on the CPU.

Inputs come from a numpy seed and go through the JAX function and its
counterpart. On the CPU the JAX ``_attention`` takes its XLA branch (the
backend is not a TPU), which is the library kernel's plain reference; the port
takes ``flash_attention_plain``. Head widths 64 (DiT-S/B/L) and 72 (DiT-XL),
widths the kernels take only zero-padded (4, 12), widths above 128 (136, 192,
200, 256: the bf16 kernels' 192 and 256 instances, in fp32 the *_wide
kernels), widths above 256 (264, 320, 384, 512: the streamed bf16 kernels,
the fp32 *_wide kernels in two chunks), the padding identity, and the
kernels' head-width rule, which needs no card, and the fp32 kernels' 3xTF32
split arithmetic, emulated in numpy. Tolerances: fp32 atol 1e-5
forward (the same fp32 arithmetic, summed in another order), 1e-4 for dq,
dk, dv; bf16 rtol 2e-2 (probabilities and outputs are rounded to bf16 on
both sides, at the same points), and above 128 in bf16 2e-2 of each
output's largest entry for the forward and the gradients against
``jax.vjp`` (which rounds at other points). The
hand-written backward is also held against torch autograd of the plain
forward. The dropout is held to the contract of
``tests/test_pallas.py::TestDropoutKernels::test_dropout_kernel_mask_stats_and_determinism``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectified_flow_vision_tpu.models import dit as JD
from rectified_flow_vision_tpu_torch.ops import build
from rectified_flow_vision_tpu_torch.ops import dropout as TDR
from rectified_flow_vision_tpu_torch.ops import flash_attention as TFA
from rectified_flow_vision_tpu_torch.ops import fused as TF
from rectified_flow_vision_tpu_torch.ops import gn_silu_dropout as TD
from rectified_flow_vision_tpu_torch.ops import primitives as TP

FLASH = (2, 1024, 2, 64)  # the dispatch rule's flash route
XL = (1, 1024, 2, 72)  # DiT-XL's head width on the flash route
SHORT = (2, 192, 3, 32)  # below the threshold: plain on every device


def _qkv(shape, seed=0, scale=1.5):
    r = np.random.default_rng(seed)
    return tuple((r.standard_normal(shape) * scale).astype(np.float32) for _ in range(3))


def _jax_attention(q, k, v, dtype=jnp.float32):
    return JD._attention(*(jnp.asarray(a, dtype) for a in (q, k, v)), use_flash=True)


class TestForward:
    @pytest.mark.parametrize("shape", [FLASH, XL, SHORT], ids=["flash_shape", "head_72", "short"])
    def test_plain_matches_jax_fp32(self, shape):
        q, k, v = _qkv(shape)
        want = np.asarray(_jax_attention(q, k, v))
        got = TF.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
        assert got.shape == shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)

    @pytest.mark.parametrize("shape", [FLASH, XL, SHORT], ids=["flash_shape", "head_72", "short"])
    def test_plain_matches_jax_bf16(self, shape):
        q, k, v = _qkv(shape, seed=1)
        want = np.asarray(_jax_attention(q, k, v, jnp.bfloat16).astype(jnp.float32))
        got = TF.flash_attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)))
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2, atol=2e-2)

    def test_dispatch_follows_the_jax_rule(self):
        assert TFA.FLASH_MIN_SEQ == JD._FLASH_MIN_SEQ
        for t in (64, 1000, 1024, 1088, 1152, 16384):
            want = t >= JD._FLASH_MIN_SEQ and JD._flash_block_sizes(t) is not None
            assert TFA.use_flash(t) == want, t

    @pytest.mark.parametrize("d", range(8, 129, 8))
    def test_every_head_width_from_8_to_128_has_a_kernel(self, d):
        """bf16 pads D to one or two 64-column TMA boxes; fp32 runs at D
        itself (the 3xTF32 kernels are compiled at every multiple of 8);
        DiT-S/B/L (64) and XL (72) are among them."""
        bf16 = TFA.kernel_head_dim(d, torch.bfloat16)
        fp32 = TFA.kernel_head_dim(d, torch.float32)
        assert bf16 == (64 if d <= 64 else 128) and d <= bf16
        assert fp32 == d

    @pytest.mark.parametrize("d", range(1, 129))
    def test_every_head_width_from_1_to_128_runs_at_its_padded_width(self, d):
        """Every D from 1 to 128 reaches the fp32 kernels at the next
        multiple of 8 (D itself where it is one), never wider: no zero
        column beyond the padding that a 16-byte row needs."""
        want = -(-d // 8) * 8
        assert TFA.padded_head_dim(d) == want
        assert TFA.kernel_head_dim(d, torch.float32) == want
        assert TFA.kernel_head_dim(d, torch.bfloat16) == (64 if d <= 64 else 128)

    @pytest.mark.parametrize("d", [0, 4, 12, 20, 100, 127, 130, 136, 192, 200, 256, 260, 320,
                                   264, 384, 512, 520, 1000])
    def test_other_head_widths_are_padded_to_a_kernel_width(self, d):
        """Every D >= 1 reaches a kernel: zero-padded to the next multiple of
        8 (and 8 at least), then a kernel's width: bf16 the next multiple of
        64 at every width (no ceiling), fp32 that multiple of 8 itself up to
        128 and the next multiple of 64 above it. Only D = 0 raises."""
        limits = {torch.bfloat16: 0, torch.float32: TFA.HEAD_DIM_MAX_F32}
        for dtype, limit in limits.items():
            if d == 0:
                with pytest.raises(ValueError, match="D >= 1"):
                    TFA.kernel_head_dim(d, dtype)
                continue
            padded, width = TFA.padded_head_dim(d), TFA.kernel_head_dim(d, dtype)
            assert padded % 8 == 0 and d <= padded < d + 8 and padded >= 8
            assert padded <= width
            if padded > limit:
                assert width % TFA.HEAD_DIM_BOX == 0 and width < padded + TFA.HEAD_DIM_BOX
            else:
                assert width == TFA.kernel_head_dim(padded, dtype)

    @pytest.mark.parametrize("d,bf16,fp32", [(136, 192, 192), (192, 192, 192), (200, 256, 256),
                                             (256, 256, 256), (320, 320, 320), (264, 320, 320),
                                             (384, 384, 384), (512, 512, 512), (520, 576, 576)])
    def test_head_widths_above_128_route_by_dtype(self, d, bf16, fp32):
        """Above 128, bf16 takes the wgmma kernels' 192 and 256 instances up
        to D = 256 and the streamed bf16 kernels above it, fp32 the *_wide
        fp32 kernels: a multiple of 64 either way, with no ceiling."""
        assert TFA.kernel_head_dim(d, torch.bfloat16) == bf16
        assert TFA.kernel_head_dim(d, torch.float32) == fp32
        assert TFA.HEAD_DIM_WIDE == 256 and TFA.HEAD_DIM_MAX_F32 == 128

    @pytest.mark.parametrize("d", [64, 136, 200, 256, 264, 320, 512])
    def test_bf16_reaches_the_kernels_without_an_fp32_copy_up_to_256(self, d):
        """The views of one [B, T, 3, H, D] projection reach the kernels in
        place, in their own dtype, at every width: bf16 up to D = 256 and
        above it (the streamed kernels, a multiple of 64 with no fp32 copy),
        fp32 above 128."""
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = torch.zeros((1, 128, 3, 2, d), dtype=dtype).unbind(2)
            got = TFA._kernel_inputs(q, k, v, d)
            assert all(x.dtype == dtype and x.shape == q.shape for x in got)
            assert all(a is b for a, b in zip(got, (q, k, v)))
            assert TFA.kernel_head_dim(d, dtype) % (64 if d > 128 else 16) == 0

    def test_views_of_one_projection_need_no_copy(self):
        """q, k, v as DiT hands them over share their strides, so the kernel
        wrapper reads them in place; unrelated layouts are copied once."""
        qkv = torch.zeros((2, 128, 3, 2, 64))
        q, k, v = qkv.unbind(2)
        same = TFA._shared_strides(q, k, v)
        assert all(a is b for a, b in zip(same, (q, k, v)))
        odd = TFA._shared_strides(q, k.transpose(1, 2).contiguous().transpose(1, 2), v)
        assert all(a.is_contiguous() for a in odd)

    def test_lse_is_the_log_sum_exp_of_the_scaled_logits(self):
        q, k, _ = _qkv(SHORT, seed=2)
        lse = TFA.flash_attention_lse_plain(torch.from_numpy(q), torch.from_numpy(k))
        logits = np.einsum("bthd,bshd->bhts", q, k) / np.sqrt(q.shape[-1])
        want = np.log(np.exp(logits - logits.max(-1, keepdims=True)).sum(-1)) + logits.max(-1)
        np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)


# head widths the kernels take only zero-padded (4, 12), above 128 (136,
# 192, 200, 256: bf16 on the 192 / 256 kernels, fp32 on the *_wide kernels)
# and above 256 (264, 320, 384, 512: the streamed bf16 kernels; fp32 in two
# chunks)
ODD_WIDTHS = [4, 12, 136, 192, 200, 256]
WIDER = [264, 320, 384, 512]


class TestHeadWidths:
    """Every head width the JAX ``_attention`` takes: the plain forward and
    backward against it at D = 4, 12, 136, 192, 200, 256, 264, 320, 384 and
    512 (and in bf16 at 136, 256, 264, 320, 384 and 512), and the padding
    identity the kernel wrappers rely on."""

    @pytest.mark.parametrize("d", ODD_WIDTHS + WIDER)
    def test_plain_matches_jax_forward_and_vjp(self, d):
        """fp32 forward within 1e-5 (of the output's largest entry above 256,
        where the logits' sums over D reach 1e-5 of outputs of size 3) and
        gradients within 1e-4 of ``jax.vjp``."""
        shape = (1, 1024, 2, d)
        q, k, v = _qkv(shape, seed=11)
        g = np.random.default_rng(12).standard_normal(shape).astype(np.float32)
        out, vjp = jax.vjp(lambda *a: JD._attention(*a, use_flash=True),
                           *(jnp.asarray(a) for a in (q, k, v)))
        want = vjp(jnp.asarray(g))
        tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
        got_out = TF.flash_attention(tq, tk, tv)
        scale = max(1.0, float(np.abs(out).max())) if d in WIDER else 1.0
        np.testing.assert_allclose(got_out.numpy(), np.asarray(out), rtol=0, atol=1e-5 * scale)
        lse = TFA.flash_attention_lse_plain(tq, tk)
        got = TFA.flash_attention_backward_plain(tq, tk, tv, got_out, lse, tg)
        for name, a, b in zip("qkv", got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-4,
                                       err_msg=f"d{name}")

    @pytest.mark.parametrize("d", [136, 256] + WIDER)
    def test_plain_matches_jax_forward_and_vjp_bf16(self, d):
        """bf16 above 128, the route of the bf16 192 / 256 kernels and of the
        streamed kernels above 256: the plain
        forward and the hand-written backward (P and dS rounded to bf16, as
        the kernels do) against the JAX XLA branch in bf16 and its
        ``jax.vjp``, each output within 2e-2 of its largest entry."""
        shape = (1, 1024, 2, d)
        q, k, v = _qkv(shape, seed=15)
        g = np.random.default_rng(16).standard_normal(shape).astype(np.float32)
        out, vjp = jax.vjp(lambda *a: JD._attention(*a, use_flash=True),
                           *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
        want = vjp(jnp.asarray(g, jnp.bfloat16))
        tq, tk, tv, tg = (torch.from_numpy(a).bfloat16() for a in (q, k, v, g))
        got_out = TF.flash_attention(tq, tk, tv)
        lse = TFA.flash_attention_lse_plain(tq, tk)
        got = TFA.flash_attention_backward_plain(tq, tk, tv, got_out, lse, tg)
        for name, a, b in zip(("out", "dq", "dk", "dv"), (got_out, *got), (out, *want)):
            assert a.dtype == torch.bfloat16 and a.shape == shape
            b = np.asarray(b.astype(jnp.float32))
            err = float(np.abs(a.float().numpy() - b).max())
            assert err <= 2e-2 * float(np.abs(b).max()), name

    @pytest.mark.parametrize("d", ODD_WIDTHS)
    def test_zero_padding_at_the_true_scale_is_exact(self, d):
        """q, k, v zero-padded in the head axis to the kernels' width, at
        scale 1/sqrt(D) of the true D: the same output, log-sum-exp and
        gradients in the first D columns, zeros past them."""
        shape = (1, 256, 2, d)
        q, k, v = (torch.from_numpy(a) for a in _qkv(shape, seed=13))
        g = torch.from_numpy(np.random.default_rng(14).standard_normal(shape).astype(np.float32))
        dk = TFA.padded_head_dim(d) if d % 8 else d + 8  # 136 ..: pad a block of 8 anyway
        pad = lambda x: torch.nn.functional.pad(x, (0, dk - d))  # noqa: E731
        scale = 1.0 / np.sqrt(d)
        out = TFA.flash_attention_plain(q, k, v)
        out_p = TFA.flash_attention_plain(pad(q), pad(k), pad(v), scale=scale)
        lse = TFA.flash_attention_lse_plain(q, k)
        lse_p = TFA.flash_attention_lse_plain(pad(q), pad(k), scale=scale)
        np.testing.assert_allclose(out_p[..., :d].numpy(), out.numpy(), rtol=0, atol=1e-6)
        assert not out_p[..., d:].any()
        np.testing.assert_allclose(lse_p.numpy(), lse.numpy(), rtol=0, atol=1e-5)
        grads = TFA.flash_attention_backward_plain(q, k, v, out, lse, g)
        grads_p = TFA.flash_attention_backward_plain(pad(q), pad(k), pad(v), out_p, lse_p,
                                                     pad(g), scale=scale)
        for a, b in zip(grads_p, grads):
            np.testing.assert_allclose(a[..., :d].numpy(), b.numpy(), rtol=0, atol=1e-5)
            assert not a[..., d:].any()


def _tf32(x):
    """``cvt.rna.tf32.f32`` on the fp32 bit pattern: 0x1000 added to the
    magnitude bits and the low 13 cleared (round to nearest, ties away from
    zero), the sign kept."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    mag = ((bits & np.uint32(0x7FFFFFFF)) + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    return (mag | (bits & np.uint32(0x80000000))).view(np.float32)


def _mm3(a, b):
    """a @ b as the kernels' 3xTF32 products: hi = tf32(x), lo = tf32(x -
    hi); lo b_hi + hi b_lo + hi b_hi in fp32, lo lo dropped."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


class TestSplitArithmetic:
    """The fp32 kernels up to D = 128 compute every product in 3xTF32 on the
    tensor cores. Their arithmetic, emulated here in numpy (fp32 sums), against
    the JAX ``_attention`` and its ``jax.vjp`` at the plain versions'
    tolerances: 1e-5 forward and log-sum-exp, 1e-4 for dq, dk, dv."""

    def test_tf32_rounds_to_nearest_with_ties_away_from_zero(self):
        ulp = 2.0 ** -10  # tf32's spacing in [1, 2)
        x = np.array([1 + ulp / 2, 1 + ulp / 4, 1 + 3 * ulp / 4, 1.5 + ulp / 2, 3.0,
                      2.0 ** -126, 1 + ulp / 2 - 2.0 ** -23], np.float32)
        want = np.array([1 + ulp, 1, 1 + ulp, 1.5 + ulp, 3.0, 2.0 ** -126, 1], np.float32)
        np.testing.assert_array_equal(_tf32(x), want)
        np.testing.assert_array_equal(_tf32(-x), -want)
        r = np.random.default_rng(21).standard_normal(4096).astype(np.float32) * 100
        hi = _tf32(r)
        assert not (hi.view(np.uint32) & np.uint32(0x1FFF)).any()
        lo = _tf32(r - hi)
        # hi + lo keeps 22 significant bits: within 2^-22 of |x|
        assert (np.abs(hi.astype(np.float64) + lo - r) <= 2.0 ** -22 * np.abs(r)).all()

    @pytest.mark.parametrize("d", [64, 72])
    def test_3xtf32_forward_and_gradients_match_jax(self, d):
        shape = (1, 1024, 2, d)
        q, k, v = _qkv(shape, seed=31)
        g = np.random.default_rng(32).standard_normal(shape).astype(np.float32)
        out, vjp = jax.vjp(lambda *a: JD._attention(*a, use_flash=True),
                           *(jnp.asarray(a) for a in (q, k, v)))
        want = vjp(jnp.asarray(g))
        scale = np.float32(1.0 / np.sqrt(d))
        want_lse = np.asarray(jax.nn.logsumexp(
            jnp.einsum("bthd,bshd->bhts", q, k) * scale, axis=-1))
        qh, kh, vh, gh = (np.ascontiguousarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v, g))
        s = _mm3(qh, kh.transpose(0, 1, 3, 2)) * scale  # [B, H, T, T]
        m = s.max(-1, keepdims=True)
        p = np.exp(s - m)
        l_sum = p.sum(-1, keepdims=True)
        o = _mm3(p, vh) / l_sum
        lse = (m + np.log(l_sum))[..., 0]
        np.testing.assert_allclose(o.transpose(0, 2, 1, 3), np.asarray(out), rtol=0, atol=1e-5)
        np.testing.assert_allclose(lse, want_lse, rtol=0, atol=1e-5)
        # the backward kernels' formulas: P from the saved lse, delta = rowsum(dO O)
        p = np.exp(_mm3(qh, kh.transpose(0, 1, 3, 2)) * scale - lse[..., None])
        dp = _mm3(gh, vh.transpose(0, 1, 3, 2))
        ds = p * (dp - (gh * o).sum(-1, keepdims=True))
        dq = _mm3(ds, kh) * scale
        dk = _mm3(ds.transpose(0, 1, 3, 2), qh) * scale
        dv = _mm3(p.transpose(0, 1, 3, 2), gh)
        for name, a, b in zip("qkv", (dq, dk, dv), want):
            np.testing.assert_allclose(a.transpose(0, 2, 1, 3), np.asarray(b), rtol=0, atol=1e-4,
                                       err_msg=f"d{name}")


class TestBackward:
    @pytest.mark.parametrize("shape", [FLASH, XL, SHORT], ids=["flash_shape", "head_72", "short"])
    def test_plain_backward_matches_jax_grad(self, shape):
        q, k, v = _qkv(shape, seed=3)
        g = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
        _, vjp = jax.vjp(lambda *a: JD._attention(*a, use_flash=True),
                         *(jnp.asarray(a) for a in (q, k, v)))
        want = vjp(jnp.asarray(g))
        tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
        out = TFA.flash_attention_plain(tq, tk, tv)
        lse = TFA.flash_attention_lse_plain(tq, tk)
        got = TFA.flash_attention_backward_plain(tq, tk, tv, out, lse, tg)
        for name, a, b in zip("qkv", got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-4,
                                       err_msg=f"d{name}")

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
    def test_plain_backward_matches_autograd_of_the_plain_forward(self, dtype):
        q, k, v = (torch.from_numpy(a).to(dtype).requires_grad_() for a in _qkv(SHORT, seed=5))
        g = torch.from_numpy(np.random.default_rng(6).standard_normal(SHORT)
                             .astype(np.float32)).to(dtype)
        out = TFA.flash_attention_plain(q, k, v)
        want = torch.autograd.grad(out, (q, k, v), g)
        lse = TFA.flash_attention_lse_plain(q, k)
        got = TFA.flash_attention_backward_plain(
            q.detach(), k.detach(), v.detach(), out.detach(), lse.detach(), g)
        tol = 1e-5 if dtype == torch.float32 else 3e-2
        for a, b in zip(got, want):
            assert a.dtype == dtype
            scale = max(float(b.float().abs().max()), 1.0)
            assert float((a.float() - b.float()).abs().max()) <= tol * scale

    def test_cpu_tensors_launch_no_kernel_and_others_raise(self):
        build.reset_launches()
        q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv((1, 1024, 1, 32), seed=7))
        TF.flash_attention(q, k, v).sum().backward()
        assert q.grad is not None and sum(build.LAUNCHES.values()) == 0
        meta = torch.empty((1, 1024, 1, 64), device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            TFA.flash_attention_cuda(meta, meta, meta)
        with pytest.raises(ValueError, match="CUDA"):
            TFA.flash_attention_backward_cuda(meta, meta, meta, meta, meta, meta)


class TestDropout:
    def test_contract_of_the_tpu_kernel(self):
        """Same seed same mask, another seed another mask, kept fraction within
        1% of keep at 2^20 elements, kept values x / keep."""
        x = torch.ones((1024, 1024))
        a, b = TDR.dropout_plain(x, 7, 0.3), TDR.dropout_plain(x, 7, 0.3)
        c = TDR.dropout_plain(x, 8, 0.3)
        assert torch.equal(a, b) and not torch.equal(a, c)
        assert abs(float((a != 0).float().mean()) - 0.7) < 0.01
        np.testing.assert_allclose(a[a != 0].numpy(), 1.0 / 0.7, rtol=1e-5)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
    def test_primitive_dropout_is_the_plain_version(self, dtype):
        x = torch.from_numpy(np.random.default_rng(8).standard_normal((3, 8, 8, 16))
                             .astype(np.float32)).to(dtype)
        out = TP.dropout(x, 0.4, 21, train=True)
        assert out.dtype == dtype
        assert torch.equal(out, TDR.dropout_plain(x, 21, 0.4))
        assert torch.equal(out != 0, TD.keep_mask(x.shape, 21, 0.4, x.device) & (x != 0))
        assert TP.dropout(x, 0.4, 21, train=False) is x
        assert TP.dropout(x, 0.0, 21, train=True) is x
        assert TP.dropout(x, 0.4, None, train=True) is x

    def test_gradient_is_the_same_mask_on_the_cotangent(self):
        x = torch.from_numpy(np.random.default_rng(9).standard_normal((2, 64))
                             .astype(np.float32)).requires_grad_()
        g = torch.from_numpy(np.random.default_rng(10).standard_normal((2, 64)).astype(np.float32))
        (grad,) = torch.autograd.grad(TP.dropout(x, 0.25, 5, train=True), x, g)
        assert torch.equal(grad, TDR.dropout_plain(g, 5, 0.25))

    def test_non_cpu_tensor_takes_the_kernel_or_raises(self):
        with pytest.raises(ValueError, match="CUDA"):
            TDR.dropout_cuda(torch.empty((4, 4), device="meta"), 3, 0.1)

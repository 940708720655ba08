"""The port's counter-based dropout (plain versions) on the CPU.

The TPU kernels' bits cannot be replayed, so the port is held to the contract
of ``tests/test_pallas.py::TestDropoutKernels`` instead: same seed same mask,
keep fraction 1 - rate, kept values = JAX ``gn_silu`` / keep (2e-5: the same
fp32 arithmetic, summed in another order), ``dropout_mask_apply``
regenerates the mask, gradients equal JAX's gradients of the masked XLA
chain given the port's mask (2e-4, as the JAX test), and eval mode or rate 0
is ``gn_silu``. The Philox4x32-10 written in PyTorch integer ops is checked
against the published known-answer vectors (Random123 ``kat_vectors``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectified_flow_vision_tpu.ops import primitives as JP
from rectified_flow_vision_tpu_torch.models import BaseFlowModel
from rectified_flow_vision_tpu_torch.models.base_flow import make_optimizer
from rectified_flow_vision_tpu_torch.models.unet import UNet
from rectified_flow_vision_tpu_torch.ops import build
from rectified_flow_vision_tpu_torch.ops import fused as TF
from rectified_flow_vision_tpu_torch.ops import gn_silu as TG
from rectified_flow_vision_tpu_torch.ops import gn_silu_dropout as TD
from rectified_flow_vision_tpu_torch.ops import primitives as TP

CPU = torch.device("cpu")

KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    (
        (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
        (0xA4093822, 0x299F31D0),
        (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1),
    ),
]


def _philox_uint64(counter, key):
    """Philox4x32-10 on numpy uint64 scalars: an independent reference."""
    c = [np.uint64(v) for v in counter]
    k = [np.uint64(v) for v in key]
    m32, s32 = np.uint64(0xFFFFFFFF), np.uint64(32)
    for _ in range(10):
        p0, p1 = np.uint64(0xD2511F53) * c[0], np.uint64(0xCD9E8D57) * c[2]
        c = [(p1 >> s32) ^ c[1] ^ k[0], p1 & m32, (p0 >> s32) ^ c[3] ^ k[1], p0 & m32]
        k = [(k[0] + np.uint64(0x9E3779B9)) & m32, (k[1] + np.uint64(0xBB67AE85)) & m32]
    return tuple(int(v) for v in c)


def _gn_inputs(shape, seed):
    r = np.random.default_rng(seed)
    c = shape[-1]
    x = (r.standard_normal(shape) * 2 + 0.3).astype(np.float32)
    s = (r.standard_normal(c) * 0.2 + 1.0).astype(np.float32)
    b = (r.standard_normal(c) * 0.2).astype(np.float32)
    return x, s, b


def _jax_gn_silu(x, s, b):
    return JP.silu(JP.group_norm(x, {"scale": s, "bias": b}, num_groups=8))


class TestPhilox:
    @pytest.mark.parametrize("counter,key,want", KAT, ids=["zeros", "ones", "pi"])
    def test_known_answer_vectors(self, counter, key, want):
        got = TD.philox4x32_10(
            [torch.tensor(v, dtype=torch.int64) for v in counter],
            [torch.tensor(v, dtype=torch.int64) for v in key],
        )
        assert tuple(int(g) for g in got) == want
        assert _philox_uint64(counter, key) == want

    def test_bits_follow_the_counter_contract(self):
        """key = (seed, DROPOUT_KEY1), counter = (image, element // 4, 0, 0),
        lane = element % 4, also where an image's size is no multiple of 4."""
        shape, seed = (3, 5, 7, 3), 1234567
        bits = TD.dropout_bits(shape, seed, CPU).reshape(3, -1).numpy()
        for image, elem in [(0, 0), (0, 3), (1, 4), (2, 104), (2, 103), (1, 57)]:
            words = _philox_uint64((image, elem // 4, 0, 0), (seed, TD.DROPOUT_KEY1))
            assert int(bits[image, elem]) == words[elem % 4]

    @pytest.mark.parametrize("off,width,total", [(0, 8, 16), (8, 8, 16), (4, 4, 12),
                                                 (32, 32, 128), (0, 12, 12)])
    def test_channel_slice_bits_are_the_whole_tensors(self, off, width, total):
        """A tensor-parallel rank's channels [off, off + width) of an
        activation of ``total`` channels draw the bits of their place in the
        whole activation (pixel * total + off + channel); (0, C) is the whole
        tensor."""
        whole = TD.dropout_bits((2, 3, 5, total), 77, CPU)
        got = TD.dropout_bits((2, 3, 5, width), 77, CPU, channels=(off, total))
        assert torch.equal(got, whole[..., off:off + width])

    @pytest.mark.parametrize("channels", [(2, 16), (0, 18), (12, 16)])
    def test_channel_slices_off_the_quads_are_refused(self, channels):
        with pytest.raises(ValueError, match="multiples of 4"):
            TD.dropout_bits((1, 2, 2, 8), 1, CPU, channels=channels)

    def test_seed_forms_agree_and_wrap_to_32_bits(self):
        shape = (2, 4, 4, 8)
        ref = TD.dropout_bits(shape, -5, CPU)
        as_tensor = TD.dropout_bits(shape, torch.tensor([-5], dtype=torch.int32), CPU)
        wrapped = TD.dropout_bits(shape, 2**32 - 5, CPU)
        assert torch.equal(ref, as_tensor) and torch.equal(ref, wrapped)
        assert int(ref.min()) >= 0 and int(ref.max()) < 2**32

    def test_rate_consts_match_the_jax_kernel(self):
        from rectified_flow_vision_tpu.ops import pallas_kernels as K

        for rate in (0.1, 0.25, 0.5, 1e-12):
            thresh, inv_keep = K._rate_consts(rate)
            assert TD.rate_consts(rate) == (thresh, float(np.float32(inv_keep)))


class TestDropoutContract:
    def test_mask_stats_and_determinism(self):
        x = torch.ones((8, 16, 16, 32))
        y1 = TD.dropout_mask_apply_plain(x, 42, 0.25)
        y2 = TD.dropout_mask_apply_plain(x, 42, 0.25)
        assert torch.equal(y1, y2)
        assert abs(float((y1 == 0).float().mean()) - 0.25) < 0.02
        kept = y1[y1 != 0].numpy()
        np.testing.assert_allclose(kept, 1.0 / 0.75, rtol=1e-6)
        y3 = TD.dropout_mask_apply_plain(x, 43, 0.25)
        assert not torch.equal(y1, y3)
        # images of one batch do not share a mask
        assert not torch.equal(y1[0], y1[1])

    def test_gn_silu_dropout_matches_masked_jax_gn_silu(self):
        x, s, b = _gn_inputs((3, 8, 8, 64), seed=0)
        rate, seed = 0.2, 7
        out = TD.gn_silu_dropout_plain(
            torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(b), seed, rate
        ).numpy()
        ref = np.asarray(_jax_gn_silu(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b)))
        mask = out != 0
        np.testing.assert_allclose(out[mask], ref[mask] / (1 - rate), rtol=2e-5, atol=2e-5)
        assert abs((~mask).mean() - rate) < 0.03
        gm = TD.dropout_mask_apply_plain(torch.ones(x.shape), seed, rate).numpy()
        np.testing.assert_array_equal(gm != 0, mask)
        np.testing.assert_array_equal(TD.keep_mask(x.shape, seed, rate, CPU).numpy(), mask)

    def test_gn_silu_dropout_grads_match_jax_masked_chain(self):
        x, _, _ = _gn_inputs((2, 8, 8, 32), seed=3)
        s = np.full(32, 1.1, np.float32)
        b = np.full(32, 0.05, np.float32)
        rate, seed = 0.3, 11
        tx, ts, tb = (torch.from_numpy(a).requires_grad_() for a in (x, s, b))
        out = TF.gn_silu_dropout(tx, ts, tb, rate, seed, train=True)
        (out * out).sum().backward()
        mask = jnp.asarray(TD.keep_mask(x.shape, seed, rate, CPU).numpy(), jnp.float32)

        def ref_loss(x_, s_, b_):
            masked = _jax_gn_silu(x_, s_, b_) * mask / (1 - rate)
            return jnp.sum(masked * masked)

        g_ref = jax.grad(ref_loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (x, s, b)))
        for got, want in zip((tx.grad, ts.grad, tb.grad), g_ref):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)

    @pytest.mark.parametrize("kw", [dict(train=False, rate=0.5, seed=3),
                                    dict(train=True, rate=0.0, seed=3),
                                    dict(train=True, rate=0.5, seed=None)],
                             ids=["eval", "rate0", "no_seed"])
    def test_eval_rate0_or_no_seed_is_gn_silu(self, kw):
        x, s, b = (torch.from_numpy(a) for a in _gn_inputs((2, 8, 8, 32), seed=4))
        out = TF.gn_silu_dropout(x, s, b, kw["rate"], kw["seed"], train=kw["train"])
        assert torch.equal(out, TG.gn_silu_plain(x, s, b))
        ref = _jax_gn_silu(*(jnp.asarray(a.numpy()) for a in (x, s, b)))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)

    def test_bits_do_not_depend_on_dtype(self):
        """bf16 and fp32 tensors of one shape drop the same elements, and the
        bf16 result is the fp32 result rounded once."""
        g = torch.from_numpy(_gn_inputs((2, 8, 8, 16), seed=5)[0])
        f32 = TD.dropout_mask_apply_plain(g, 9, 0.1)
        b16 = TD.dropout_mask_apply_plain(g.bfloat16(), 9, 0.1)
        assert torch.equal(f32 != 0, b16 != 0)
        want = (g.bfloat16().float() * TD.rate_consts(0.1)[1]).bfloat16()
        assert torch.equal(b16[b16 != 0], want[b16 != 0])

    def test_primitive_dropout_uses_the_same_mask(self):
        x = torch.from_numpy(_gn_inputs((2, 4, 4, 8), seed=6)[0])
        out = TP.dropout(x, 0.4, 21, train=True)
        mask = TD.keep_mask(x.shape, 21, 0.4, CPU)
        assert torch.equal(out != 0, mask)
        np.testing.assert_allclose(out[mask].numpy(), (x[mask] / 0.6).numpy(), rtol=1e-6)

    def test_cpu_path_launches_no_kernel(self):
        build.reset_launches()
        x, s, b = (torch.from_numpy(a) for a in _gn_inputs((1, 8, 8, 64), seed=7))
        TF.gn_silu_dropout(x, s, b, 0.1, 3, train=True)
        assert sum(build.LAUNCHES.values()) == 0

    @pytest.mark.parametrize("op", ["gn_silu_dropout", "dropout_mask_apply"])
    def test_non_cpu_tensor_takes_the_kernel_or_raises(self, op):
        x = torch.empty((1, 8, 8, 64), device="meta")
        s = torch.empty(64, device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            if op == "gn_silu_dropout":
                TD.gn_silu_dropout_cuda(x, s, s, 3, 0.1)
            else:
                TD.dropout_mask_apply_cuda(x, 3, 0.1)


SMALL = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1, dropout=0.2)


def _net_inputs(seed=0):
    r = np.random.default_rng(seed)
    x = torch.from_numpy(r.standard_normal((2, 16, 16, 3)).astype(np.float32))
    t = torch.from_numpy(r.random(2).astype(np.float32))
    return x, t


class TestTrainingUNet:
    def _net(self):
        net = UNet(**SMALL)
        net.reset_parameters(torch.Generator().manual_seed(0))
        return net

    def test_seeds_drive_dropout_per_block(self):
        net = self._net()
        x, t = _net_inputs()
        n = net.num_dropout_seeds
        assert n == 6  # 2 encoder + 2 middle + 2 decoder blocks
        seeds = torch.arange(n, dtype=torch.int32) + 100
        a = net(x, t, train=True, seeds=seeds, masters=True)
        b = net(x, t, train=True, seeds=seeds, masters=True)
        c = net(x, t, train=True, seeds=seeds + 1, masters=True)
        ev = net(x, t, train=False, seeds=seeds, masters=True)
        assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, ev)
        assert torch.allclose(ev, net(x, t), atol=1e-6)
        with pytest.raises(ValueError, match="seeds"):
            net(x, t, train=True, seeds=seeds[:3], masters=True)

    def test_remat_grads_equal_plain_grads(self):
        """Each block recomputed in the backward regenerates the same mask."""
        x, t = _net_inputs(1)
        seeds = torch.arange(6, dtype=torch.int32) * 7 + 1
        grads = []
        for remat in (False, True):
            net = self._net()
            out = net(x, t, train=True, seeds=seeds, masters=True, remat=remat)
            out.square().mean().backward()
            grads.append({k: p.grad.clone() for k, p in net.named_parameters()})
        assert set(grads[0]) == set(grads[1])
        for k in grads[0]:
            torch.testing.assert_close(grads[1][k], grads[0][k], rtol=1e-6, atol=1e-7, msg=k)

    def test_masters_view_reaches_every_parameter(self):
        net = self._net()
        x, t = _net_inputs(2)
        net(x, t, dtype=torch.bfloat16, masters=True).float().square().mean().backward()
        missing = [k for k, p in net.named_parameters() if p.grad is None]
        assert not missing
        # the sampling view stays detached
        assert not net(x, t).requires_grad

    def test_bf16_masters_keep_biases_unrounded(self):
        """Training hands biases and norm parameters to the ops in fp32 as
        they are; the sampling view rounds them through bf16 first."""
        net = self._net()
        x, t = _net_inputs(3)
        with torch.no_grad():
            for p in net.parameters():
                p.copy_(p.bfloat16().float())
            # on bf16-valued parameters the two views agree
            assert torch.equal(net(x, t, dtype=torch.bfloat16),
                               net(x, t, dtype=torch.bfloat16, masters=True))
            net.output_conv[2].bias.fill_(1.001)  # not a bf16 value
        sample = net(x, t, dtype=torch.bfloat16).float()
        with torch.no_grad():
            master = net(x, t, dtype=torch.bfloat16, masters=True).float()
            net.output_conv[2].bias.fill_(float(torch.tensor(1.001).bfloat16()))
            rounded = net(x, t, dtype=torch.bfloat16, masters=True).float()
        assert torch.equal(sample, rounded)
        assert not torch.equal(sample, master)

    def test_sampler_sees_weights_after_an_optimizer_step(self):
        model = BaseFlowModel(
            image_size=16, device="cpu", sample_dtype="bfloat16", **{**SMALL, "dropout": 0.1}
        )
        noise = np.random.default_rng(4).standard_normal((2, 3, 16, 16)).astype(np.float32)
        before = model.sample(noise=noise, num_steps=1)
        opt = make_optimizer(model, 1e-2, 1, 1)
        x1 = torch.from_numpy(np.tanh(noise.transpose(0, 2, 3, 1)))
        model.loss_fn(x1, torch.Generator().manual_seed(0)).backward()
        opt.step()
        after = model.sample(noise=noise, num_steps=1)
        assert not torch.allclose(after, before, atol=1e-3)
        fresh = BaseFlowModel(
            image_size=16, device="cpu", sample_dtype="bfloat16", params=model.params,
            **{**SMALL, "dropout": 0.1},
        )
        assert torch.equal(fresh.sample(noise=noise, num_steps=1), after)

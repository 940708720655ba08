"""The port's UNet held against the JAX ``UNet.apply`` on the CPU.

Weights are made once by the JAX ``init`` from a seed and carried over
through ``params_to_state_dict``; x and t come from a numpy seed.
Tolerances: fp32 atol 1e-4 (the same fp32 arithmetic through ~60 layers,
summed in another order); bf16 3% of the output's largest magnitude (every
layer rounds to bf16 on both sides, at the same points, and 1 ulp is 0.4%).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectified_flow_vision_tpu.models.unet import UNet as JUNet
from rectified_flow_vision_tpu.models.unet import count_parameters as j_count
from rectified_flow_vision_tpu.utils import pt_import as JPT
from rectified_flow_vision_tpu_torch.models.unet import UNet, count_parameters
from rectified_flow_vision_tpu_torch.ops import build
from rectified_flow_vision_tpu_torch.utils import pt_import as TPT

SMALL = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1)
PREFIX = "velocity_net."


def _jax_params(cfg, seed=0):
    net = JUNet(**cfg)
    params = net.init(jax.random.key(seed))
    return net, params, jax.tree_util.tree_map(np.asarray, params)


def _port(cfg, params_np):
    sd = TPT.params_to_state_dict(
        params_np, list(cfg.get("channel_mult", (1, 2, 4))), cfg.get("num_res_blocks", 2)
    )
    net = UNet(**cfg)
    net.load_state_dict(
        {k[len(PREFIX):]: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True
    )
    return net


def _inputs(b, size, seed=1):
    r = np.random.default_rng(seed)
    x = r.standard_normal((b, size, size, 3)).astype(np.float32)
    t = r.random(b).astype(np.float32)
    return x, t


@pytest.fixture(scope="module")
def flagship():
    return _jax_params({})


class TestWeightCarryOver:
    def test_params_to_state_dict_matches_jax(self, flagship):
        """The port's copy gives the JAX package's state dict, key by key and
        value by value."""
        _, _, params_np = flagship
        ours = TPT.params_to_state_dict(params_np, [1, 2, 4], 2)
        ref = JPT.params_to_state_dict(params_np, [1, 2, 4], 2)
        assert list(ours) == list(ref)
        for k in ref:
            np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)

    def test_state_dict_to_params_round_trip(self, flagship):
        _, _, params_np = flagship
        sd = TPT.params_to_state_dict(params_np, [1, 2, 4], 2)
        back, arch = TPT.state_dict_to_params(sd)
        ref_back, ref_arch = JPT.state_dict_to_params(sd)
        assert arch == ref_arch == {"model_channels": 64, "channel_mult": [1, 2, 4],
                                    "num_res_blocks": 2}
        flat = jax.tree_util.tree_leaves_with_path(back)
        ref_flat = dict(jax.tree_util.tree_leaves_with_path(ref_back))
        assert len(flat) == len(ref_flat)
        for path, leaf in flat:
            np.testing.assert_array_equal(leaf, ref_flat[path])

    def test_strict_load_and_golden_count(self, flagship):
        """The reference module names: the JAX tree loads with strict=True,
        and the flagship keeps 11,255,363 parameters."""
        _, params, params_np = flagship
        net = _port({}, params_np)  # load_state_dict(strict=True) inside
        assert count_parameters(net) == j_count(params) == 11_255_363
        own = set(net.state_dict())
        ref = {k[len(PREFIX):] for k in JPT.params_to_state_dict(params_np, [1, 2, 4], 2)}
        assert own == ref

    def test_reference_pt_file_loads(self, tmp_path, flagship):
        """A reference-format ``.pt`` checkpoint loads through ``load_params``."""
        from rectified_flow_vision_tpu_torch.utils import checkpoint as ckpt

        _, _, params_np = flagship
        sd = JPT.params_to_state_dict(params_np, [1, 2, 4], 2)
        path = tmp_path / "ref.pt"
        torch.save(
            {"state_dict": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
             "config": {"image_size": 64, "in_channels": 3}},
            path,
        )
        params, config = ckpt.load_params(path)
        assert config["model_channels"] == 64 and config["channel_mult"] == [1, 2, 4]
        back = TPT.params_to_state_dict(params, [1, 2, 4], 2)
        for k in sd:
            np.testing.assert_array_equal(back[k], sd[k])


class TestForwardParity:
    def test_small_unet_fp32(self):
        """Image 16, 32 channels, mult (1, 2), 1 res-block: fp32 atol 1e-4."""
        jnet, params, params_np = _jax_params(SMALL)
        net = _port(SMALL, params_np)
        x, t = _inputs(2, 16)
        ref = np.asarray(jnet.apply(params, jnp.asarray(x), jnp.asarray(t)))
        out = net(torch.from_numpy(x), torch.from_numpy(t)).detach().numpy()
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)

    def test_small_unet_bf16(self):
        """bf16 compute with params rounded to bf16, as the JAX sampler
        does: within 3% of the largest output magnitude."""
        jnet, params, params_np = _jax_params(SMALL, seed=2)
        net = _port(SMALL, params_np)
        x, t = _inputs(2, 16, seed=3)
        bparams = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), params)
        ref = jnet.apply(bparams, jnp.asarray(x), jnp.asarray(t), compute_dtype=jnp.bfloat16)
        ref = np.asarray(ref.astype(jnp.float32))
        out = net(torch.from_numpy(x), torch.from_numpy(t), dtype=torch.bfloat16)
        assert out.dtype == torch.bfloat16
        err = np.abs(out.float().detach().numpy() - ref).max()
        assert err <= 0.03 * np.abs(ref).max(), err

    def test_full_width_batch1_fp32(self, flagship):
        """The flagship (64x64, 64 channels, mult (1, 2, 4), 2 res-blocks,
        mid attention at 16x16), batch 1: fp32 atol 1e-4."""
        jnet, params, params_np = flagship
        net = _port({}, params_np)
        x, t = _inputs(1, 64, seed=4)
        ref = np.asarray(jnet.apply(params, jnp.asarray(x), jnp.asarray(t)))
        out = net(torch.from_numpy(x), torch.from_numpy(t)).detach().numpy()
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)

    def test_param_cache_follows_weight_updates(self):
        """The per-dtype parameter copies are rebuilt after a weight changes."""
        net = UNet(**SMALL)
        net.reset_parameters(torch.Generator().manual_seed(0))
        x, t = (torch.from_numpy(a) for a in _inputs(1, 16, seed=5))
        before = net(x, t, dtype=torch.bfloat16)
        with torch.no_grad():
            net.output_conv[2].bias.add_(1.0)
        after = net(x, t, dtype=torch.bfloat16)
        assert torch.allclose(after.float(), before.float() + 1.0, atol=2e-2)

    def test_seeded_init_is_deterministic_and_torch_default(self):
        a, b = UNet(**SMALL), UNet(**SMALL)
        a.reset_parameters(torch.Generator().manual_seed(7))
        b.reset_parameters(torch.Generator().manual_seed(7))
        for (k, p), q in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(p, q), k
        w = a.input_conv.weight
        assert w.abs().max() <= 1.0 / np.sqrt(3 * 9)
        assert torch.equal(a.mid_attn.norm.weight, torch.ones(64))

    def test_cpu_forward_launches_no_kernel(self):
        build.reset_launches()
        net = UNet(**SMALL)
        x, t = (torch.from_numpy(a) for a in _inputs(1, 16, seed=6))
        net(x, t)
        assert sum(build.LAUNCHES.values()) == 0

"""The port's ConvVAE, its trainer and the latent pipeline, against the JAX package on the CPU.

32x32 images, base 16 channels, downsample 4 (8x8x4 latents); weights from the
JAX ``init`` with the GroupNorm parameters perturbed, carried across through
``ConvVAE.params``. The two packages draw different noise from one seed, so
the port is handed the noise the JAX key gives. Tolerances: fp32 atol 1e-4 on
every forward and on the decoded samples (the same fp32 arithmetic in another
summation order, through up to 8 convs and a 2-step DiT); the bf16 decode atol
5e-2 on [-1, 1] pixels (each layer rounds to bf16 on both sides, at other
points inside the convs); parameters after two AdamW steps atol 1e-5, with the
exception worded at ``_compare_params``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectified_flow_vision_tpu.models import BaseFlowModel as JBase
from rectified_flow_vision_tpu.models import autoencoder as JAE
from rectified_flow_vision_tpu_torch.models import BaseFlowModel
from rectified_flow_vision_tpu_torch.models import autoencoder as TAE
from rectified_flow_vision_tpu_torch.ops import build
from rectified_flow_vision_tpu_torch.ops import conv3x3 as C
from rectified_flow_vision_tpu_torch.ops import fused
from rectified_flow_vision_tpu_torch.ops import primitives as P
from rectified_flow_vision_tpu_torch.serving import SamplerService
from rectified_flow_vision_tpu_torch.utils import pt_import as TPT

VAE = dict(image_size=32, base_channels=16)
DIT = dict(image_size=8, in_channels=4, backbone="dit", patch_size=2, hidden_size=32,
           depth=2, num_heads=4, sample_dtype="float32")
ATOL = 1e-4


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _images(n, seed=0):
    r = np.random.default_rng(seed)
    return np.tanh(r.standard_normal((n, 32, 32, 3))).astype(np.float32)


def _vaes(seed=0, scaling_factor=1.0):
    """A JAX VAE with its params and the port's on the same weights."""
    jvae = JAE.ConvVAE(scaling_factor=scaling_factor, **VAE)
    params = jax.tree_util.tree_map(np.array, jvae.init(jax.random.key(seed)))
    r = np.random.default_rng(seed + 50)
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        if "norm" in jax.tree_util.keystr(path):
            leaf += (0.2 * r.standard_normal(leaf.shape)).astype(np.float32)
    tvae = TAE.ConvVAE(scaling_factor=scaling_factor, params=params, device="cpu", **VAE)
    return jvae, jax.tree_util.tree_map(jnp.asarray, params), tvae


def _flows(seed=0):
    jm = JBase(seed=seed, **DIT)
    r = np.random.default_rng(seed + 100)
    jm.params = jax.tree_util.tree_map(
        lambda a: jnp.asarray((r.standard_normal(a.shape) * 0.1).astype(np.float32)), jm.params)
    tm = BaseFlowModel(device="cpu", params=jax.tree_util.tree_map(np.asarray, jm.params), **DIT)
    return jm, tm


class TestForward:
    def test_encode_raw_encode_decode_apply_match_jax(self):
        jvae, jparams, tvae = _vaes(scaling_factor=1.7)
        x = _images(3, seed=1)
        tx = torch.from_numpy(x)
        key = jax.random.key(5)
        eps = np.asarray(jax.random.normal(key, (3, 8, 8, 4), jnp.float32)).copy()

        jmu, jlogvar = jvae._encode_raw(jparams, jnp.asarray(x))
        with torch.no_grad():
            mu, logvar = tvae._encode_raw(tx)
            assert mu.shape == logvar.shape == (3, 8, 8, 4)
            np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=0, atol=ATOL)
            np.testing.assert_allclose(logvar.numpy(), np.asarray(jlogvar), rtol=0, atol=ATOL)
            np.testing.assert_allclose(
                tvae.encode(tx).numpy(), np.asarray(jvae.encode(jparams, jnp.asarray(x))),
                rtol=0, atol=ATOL)
            np.testing.assert_allclose(
                tvae.encode(tx, eps=eps).numpy(),
                np.asarray(jvae.encode(jparams, jnp.asarray(x), key)), rtol=0, atol=ATOL)
            z = np.random.default_rng(2).standard_normal((3, 8, 8, 4)).astype(np.float32)
            np.testing.assert_allclose(
                tvae.decode(torch.from_numpy(z)).numpy(),
                np.asarray(jvae.decode(jparams, jnp.asarray(z))), rtol=0, atol=ATOL)
            recon, mu2, logvar2 = tvae.apply(tx, eps=eps)
        jrecon, _, _ = jvae.apply(jparams, jnp.asarray(x), key)
        assert recon.shape == (3, 32, 32, 3)
        np.testing.assert_allclose(recon.numpy(), np.asarray(jrecon), rtol=0, atol=ATOL)
        assert torch.equal(mu2, mu) and torch.equal(logvar2, logvar)

    def test_logvar_is_clipped_and_sampling_takes_a_generator(self):
        _, _, tvae = _vaes(seed=1)
        with torch.no_grad():
            tvae.enc["out"].bias[4:] = 100.0
            tvae.enc["out"].bias[:4] = 0.0
            x = torch.from_numpy(_images(2, seed=3))
            _, logvar = tvae._encode_raw(x)
            assert float(logvar.max()) == 20.0
            tvae.enc["out"].bias[4:] = -3.0
            a = tvae.encode(x, torch.Generator().manual_seed(1))
            b = tvae.encode(x, torch.Generator().manual_seed(1))
            c = tvae.encode(x, torch.Generator().manual_seed(2))
        assert torch.equal(a, b) and not torch.equal(a, c)
        assert not torch.equal(a, tvae.encode(x))

    def test_config_and_shape_rules(self):
        jvae, _, tvae = _vaes()
        assert tvae.config == jvae.config and tvae.latent_size == jvae.latent_size == 8
        with pytest.raises(ValueError, match="power of 2"):
            TAE.ConvVAE(downsample=3, device="cpu")


def _decode_primitives(vae, z, dtype=None):
    """The decode as plain primitives (``P.silu(P.group_norm(...))`` and
    ``P.conv2d`` on the torch-layout weights), rounded through ``dtype`` as
    the serving decode rounds its parameters: the composition the port's
    decode replaced with the fused entry points."""
    dt = dtype or z.dtype
    d = vae.dec

    def conv(h, m):
        return P.conv2d(h, m.weight.to(dt), m.bias.to(dt).float(), stride=m.stride[0])

    def gn_silu(h, m):
        return P.silu(P.group_norm(h, m.weight.to(dt).float(), m.bias.to(dt).float(),
                                   num_groups=m.num_groups))

    h = conv(z.to(dt) / vae.scaling_factor, d["in"])
    for lv in range(vae.num_levels):
        h = P.upsample_nearest_2x(gn_silu(h, d[f"up{lv}"].norm))
        h = conv(h, d[f"up{lv}"].conv)
    return conv(gn_silu(h, d["out_norm"]), d["out"])


class TestKernelSites:
    """Every GroupNorm + SiLU of the ConvVAE goes through ``fused.gn_silu``
    and every conv through ``fused.conv2d_fused`` (so that a CUDA tensor
    takes the port's kernels), and on the CPU those are the old plain
    composition bit for bit."""

    @pytest.mark.parametrize("downsample", [4, 8])
    @pytest.mark.parametrize("part", ["decode", "encode"])
    def test_each_site_reaches_the_fused_entry_points(self, monkeypatch, part, downsample):
        calls = {"gn_silu": [], "conv2d_fused": []}

        def spy(name):
            real = getattr(fused, name)

            def inner(x, *args, **kw):
                calls[name].append((tuple(x.shape), kw.get("stride", 1)))
                return real(x, *args, **kw)
            return inner

        for name in calls:
            monkeypatch.setattr(fused, name, spy(name))
        vae = TAE.ConvVAE(image_size=32, base_channels=16, downsample=downsample, device="cpu")
        levels = vae.num_levels
        with torch.no_grad():
            if part == "decode":
                side = 32 // downsample
                vae.decode(torch.randn((2, side, side, 4)), dtype=torch.bfloat16)
            else:
                vae._encode_raw(torch.from_numpy(_images(2)))
        assert len(calls["gn_silu"]) == levels + 1
        assert len(calls["conv2d_fused"]) == levels + 2
        strides = [s for _, s in calls["conv2d_fused"]]
        assert strides == ([1] * (levels + 2) if part == "decode" else [1] + [2] * levels + [1])

    def test_the_dit_decode_widths_take_the_conv3x3_sites(self, monkeypatch):
        """At base 64 (the DiT cell's widths) the decode's two stride-1 convs
        256 -> 128 and 128 -> 64 are conv3x3 sites; the input conv (4
        channels in), the output conv (3 out) and the encoder's stride-2
        convs stay plain."""
        sites = []
        real = C.conv3x3_plain
        monkeypatch.setattr(C, "conv3x3_plain", lambda x, w, b: sites.append(
            (tuple(x.shape[1:]), w.shape[0])) or real(x, w, b))
        vae = TAE.ConvVAE(image_size=32, base_channels=64, device="cpu")
        with torch.no_grad():
            vae.decode(torch.randn((1, 8, 8, 4)), dtype=torch.bfloat16)
            assert sites == [((16, 16, 256), 128), ((32, 32, 128), 64)]
            vae._encode_raw(torch.from_numpy(_images(1)))
        assert len(sites) == 2

    @pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["float32", "bfloat16"])
    @pytest.mark.parametrize("base", [16, 64])
    def test_cpu_decode_is_the_plain_composition_bit_for_bit(self, dtype, base):
        vae = TAE.ConvVAE(image_size=32, base_channels=base, scaling_factor=1.7, device="cpu",
                          seed=3)
        with torch.no_grad():
            for m in vae.modules():  # GroupNorm parameters away from ones and zeros
                if isinstance(m, torch.nn.GroupNorm):
                    m.weight.normal_(1.0, 0.2, generator=torch.Generator().manual_seed(5))
                    m.bias.normal_(0.0, 0.2, generator=torch.Generator().manual_seed(6))
            z = torch.randn((2, 8, 8, 4), generator=torch.Generator().manual_seed(7))
            got = vae.decode(z, dtype=dtype)
            want = _decode_primitives(vae, z, dtype)
        assert got.dtype == want.dtype == (dtype or torch.float32)
        assert torch.equal(got, want)


def _compare_params(got_tree, want_tree, atol, lr, steps):
    """Parameters after ``steps`` AdamW steps: every element within
    steps * lr, and all of each leaf within ``atol`` but one element in 10,000
    (two in a small leaf). Adam divides a gradient by its own magnitude, so
    where a gradient is fp32 rounding noise two correct implementations may
    move an element apart by up to lr per step."""
    got, want = _leaves(got_tree), _leaves(want_tree)
    assert set(got) == set(want)
    for k in want:
        diff = np.abs(got[k] - want[k])
        assert diff.max() <= steps * lr * 1.001, k
        assert np.sum(diff > atol) <= max(2, diff.size // 10000), (k, diff.max())


class TestTraining:
    def test_two_train_vae_steps_and_the_calibration_match_jax(self, monkeypatch):
        """``train_vae`` for one epoch of two steps on 8 images, from the JAX
        initialisation and with the noise of the JAX step keys: the same MSE,
        parameters and scaling factor."""
        images = _images(8, seed=4)
        seed, lr = 3, 2e-4
        jvae = JAE.ConvVAE(**VAE)
        jparams, jmse = JAE.train_vae(jvae, images, epochs=1, batch_size=4, lr=lr, seed=seed,
                                      progress=False)

        tvae = TAE.ConvVAE(device="cpu", **VAE)
        init = jax.tree_util.tree_map(np.asarray, jvae.init(jax.random.key(seed)))
        noises = iter([np.asarray(jax.random.normal(
            jax.random.key(seed * 7919 + i), (4, 8, 8, 4), jnp.float32)).copy() for i in range(2)])
        monkeypatch.setattr(tvae, "reset_parameters", lambda gen: setattr(tvae, "params", init))
        monkeypatch.setattr(
            tvae, "_noise", lambda like, gen, eps: torch.from_numpy(next(noises)))
        tparams, tmse = TAE.train_vae(tvae, images, epochs=1, batch_size=4, lr=lr, seed=seed,
                                      progress=False)
        assert abs(tmse - jmse) <= 1e-5
        _compare_params(tparams, jparams, 1e-5, lr, 2)
        moved = np.abs(_leaves(tparams)["['dec']['out']['w']"]
                       - _leaves(init)["['dec']['out']['w']"]).max()
        assert moved > 1e-4
        assert tvae.scaling_factor == pytest.approx(jvae.scaling_factor, rel=1e-4)
        assert tvae.scaling_factor != 1.0

    def test_calibration_on_a_fixed_corpus(self):
        """1 / std of the encoder's mean over whole batches of the first
        min(n, 256) images: the ragged last batch is left out."""
        jvae, jparams, tvae = _vaes(seed=2)
        images = _images(10, seed=5)
        mu = np.asarray(jvae._encode_raw(jparams, jnp.asarray(images[:8]))[0])
        want = 1.0 / (mu.std() + 1e-8)
        got = TAE.calibrate_scaling_factor(tvae, images, batch_size=4)
        assert got == tvae.scaling_factor == pytest.approx(want, rel=1e-4)

    def test_train_vae_lowers_the_reconstruction_error(self):
        tvae = TAE.ConvVAE(device="cpu", **VAE)
        images = _images(8, seed=6)
        _, first = TAE.train_vae(tvae, images, epochs=1, batch_size=4, lr=2e-3, progress=False)
        params, last = TAE.train_vae(tvae, images, epochs=6, batch_size=4, lr=2e-3,
                                     progress=False)
        assert np.isfinite(last) and last < first
        assert set(params) == {"enc", "dec"} and tvae.scaling_factor > 0

    def test_optimizer_is_optax_adamw_with_a_per_step_cosine(self):
        import optax

        tvae = TAE.ConvVAE(device="cpu", **VAE)
        opt, set_lr = TAE.make_vae_optimizer(tvae, 2e-4, 10)
        group = opt.param_groups[0]
        assert (group["weight_decay"], group["eps"], group["betas"]) == (1e-4, 1e-8, (0.9, 0.999))
        sched = optax.cosine_decay_schedule(2e-4, 10)
        for step in (0, 1, 5, 10, 12):
            set_lr(step)
            assert group["lr"] == pytest.approx(float(sched(step)), rel=1e-5, abs=1e-12)


class TestCheckpoints:
    def test_jax_npz_loads_in_the_port_and_back(self, tmp_path):
        jvae, jparams, tvae = _vaes(seed=3, scaling_factor=2.5)
        jvae.save(str(tmp_path / "jax_vae.npz"), jparams)
        loaded = TAE.ConvVAE.load(str(tmp_path / "jax_vae.npz"), device="cpu")
        assert loaded.config == jvae.config and loaded.scaling_factor == 2.5
        for k, v in _leaves(jparams).items():
            np.testing.assert_array_equal(_leaves(loaded.params)[k], v, err_msg=k)

        tvae.save(str(tmp_path / "torch_vae.npz"))
        jback, jback_params = JAE.ConvVAE.load(str(tmp_path / "torch_vae.npz"))
        assert jback.config == tvae.config
        for k, v in _leaves(jparams).items():
            np.testing.assert_array_equal(_leaves(jback_params)[k], v, err_msg=k)

    def test_state_dict_names_follow_the_tree(self):
        _, jparams, tvae = _vaes(seed=4)
        sd = TPT.tree_to_state_dict(jax.tree_util.tree_map(np.asarray, jparams))
        assert set(sd) == set(tvae.state_dict())
        assert sd["enc.in.weight"].shape == (16, 3, 3, 3)  # OIHW
        assert sd["dec.up0.norm.weight"].shape == (64,)
        assert sd["enc.down1.conv.weight"].shape == (64, 32, 3, 3)


class TestLatentPipeline:
    @pytest.mark.parametrize("decode_dtype,atol", [("float32", ATOL), ("bfloat16", 5e-2)])
    def test_sample_matches_jax_from_the_same_latent_noise(self, decode_dtype, atol):
        jvae, jparams, tvae = _vaes(seed=5, scaling_factor=1.3)
        jm, tm = _flows(seed=6)
        noise = np.random.default_rng(7).standard_normal((2, 4, 8, 8)).astype(np.float32)
        jpipe = JAE.LatentFlowPipeline(jm, jvae, jparams, decode_dtype=jnp.dtype(decode_dtype))
        tpipe = TAE.LatentFlowPipeline(tm, tvae, decode_dtype=decode_dtype)
        want = np.asarray(jpipe.sample(noise, num_steps=2))
        got = tpipe.sample(noise, num_steps=2)
        assert got.shape == (2, 3, 32, 32) and got.dtype == torch.float32
        assert float(got.min()) >= -1.0 and float(got.max()) <= 1.0
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
        nhwc = tpipe.sample(noise.transpose(0, 2, 3, 1), num_steps=2, data_format="NHWC")
        np.testing.assert_allclose(nhwc.permute(0, 3, 1, 2).numpy(), got.numpy(), rtol=0, atol=1e-6)
        assert (tpipe.image_size, tpipe.in_channels) == (jpipe.image_size, jpipe.in_channels)
        assert tpipe.sample(num_steps=1, batch_size=3).shape == (3, 3, 32, 32)

    def test_vae_params_are_loaded_into_the_vae(self):
        _, jparams, tvae = _vaes(seed=8)
        _, tm = _flows(seed=9)
        fresh = TAE.ConvVAE(device="cpu", seed=11, **VAE)
        TAE.LatentFlowPipeline(tm, fresh, jax.tree_util.tree_map(np.asarray, jparams))
        for a, b in zip(fresh.parameters(), tvae.parameters()):
            assert torch.equal(a, b)


class TestLatentServing:
    def test_sampler_service_with_a_vae_on_the_cpu(self, tmp_path):
        _, _, tvae = _vaes(seed=10, scaling_factor=1.1)
        _, tm = _flows(seed=11)
        build.reset_launches()
        svc = SamplerService(tm, step_counts=(1, 2), batch_size=2, seed=4, vae=tvae)
        imgs = svc.generate(3, num_steps=2)
        assert imgs.shape == (3, 3, 32, 32) and np.isfinite(imgs).all()
        assert imgs.min() >= -1.0 and imgs.max() <= 1.0
        again = SamplerService(tm, step_counts=(2,), batch_size=2, seed=4, vae=tvae, warmup=False)
        np.testing.assert_array_equal(again.generate(3, num_steps=2), imgs)
        assert svc.generate(2, num_steps=1, data_format="NHWC").shape == (2, 32, 32, 3)
        assert svc.throughput(1, iters=1) > 0 and sum(build.LAUNCHES.values()) == 0
        # the same pixels as the pipeline gives from the service's first noise
        noise = torch.randn((2, 8, 8, 4), generator=torch.Generator().manual_seed(4))
        want = TAE.LatentFlowPipeline(tm, tvae).sample(noise, num_steps=2, data_format="NHWC")
        np.testing.assert_allclose(imgs[:2], want.permute(0, 3, 1, 2).numpy(), rtol=0, atol=1e-6)

        tm.save(str(tmp_path / "flow.npz"))
        tvae.save(str(tmp_path / "vae.npz"))
        loaded = SamplerService.from_checkpoint(
            str(tmp_path / "flow.npz"), vae_path=str(tmp_path / "vae.npz"), device="cpu",
            step_counts=(2,), batch_size=2, seed=4, warmup=False)
        # from_checkpoint builds the model with the default bf16 sampling dtype
        assert loaded.generate(3, num_steps=2).shape == (3, 3, 32, 32)

"""The port's flow model, checkpoints and sampling service, held against the
JAX ``BaseFlowModel`` on the CPU.

Both models share the weights the JAX ``init`` made and the same numpy
noise, and sample in fp32. Tolerance: atol 1e-4 on the final state; the
same fp32 arithmetic in another summation order, carried through at most 4
network evaluations per sample.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectified_flow_vision_tpu.models import BaseFlowModel as JBase
from rectified_flow_vision_tpu.models import RectifiedFlowModel as JRect
from rectified_flow_vision_tpu_torch.models import BaseFlowModel, RectifiedFlowModel
from rectified_flow_vision_tpu_torch.serving import SamplerService

TINY = dict(image_size=8, model_channels=16, channel_mult=[1], num_res_blocks=1,
            sample_dtype="float32")
ATOL = 1e-4


def _pair(seed=0):
    jm = JBase(seed=seed, **TINY)
    tm = BaseFlowModel(device="cpu", params=jm.params, **TINY)
    return jm, tm


def _noise(b=2, seed=0):
    return np.random.default_rng(seed).standard_normal((b, 3, 8, 8)).astype(np.float32)


class TestSamplers:
    @pytest.mark.parametrize("method", ["euler", "midpoint", "heun"])
    def test_sample_matches_jax(self, method):
        jm, tm = _pair()
        noise = _noise()
        ref = np.asarray(jm.sample(noise=noise, num_steps=2, method=method))
        out = tm.sample(noise=noise, num_steps=2, method=method)
        assert tuple(out.shape) == (2, 3, 8, 8)
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)

    @pytest.mark.parametrize("method", ["euler", "heun"])
    def test_invert_matches_jax(self, method):
        jm, tm = _pair(seed=1)
        images = np.tanh(_noise(seed=1))
        ref = np.asarray(jm.invert(images, num_steps=3, method=method))
        out = tm.invert(images, num_steps=3, method=method)
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)

    def test_trajectory_matches_jax(self):
        jm, tm = _pair(seed=2)
        noise = _noise(seed=2)
        ref = jm.sample_with_trajectory(noise, num_steps=4, save_every=2)
        out = tm.sample_with_trajectory(noise, num_steps=4, save_every=2)
        assert len(out) == len(ref) == 3
        for o, r in zip(out, ref):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=ATOL)

    def test_forward_and_nhwc_layout(self):
        jm, tm = _pair(seed=3)
        x = _noise(seed=3)
        t = np.array([0.1, 0.9], np.float32)
        ref = np.asarray(jm.forward(x, t))
        np.testing.assert_allclose(tm(x, t).numpy(), ref, rtol=0, atol=ATOL)
        nhwc = tm(x.transpose(0, 2, 3, 1), t, data_format="NHWC").numpy()
        np.testing.assert_allclose(nhwc, ref.transpose(0, 2, 3, 1), rtol=0, atol=ATOL)

    def test_fresh_noise_from_seeded_generator(self):
        _, tm = _pair()
        a = tm.sample(num_steps=1, batch_size=2, generator=torch.Generator().manual_seed(5))
        b = tm.sample(num_steps=1, batch_size=2, generator=torch.Generator().manual_seed(5))
        assert tuple(a.shape) == (2, 3, 8, 8)
        assert torch.equal(a, b)

    def test_interpolation(self):
        x0, x1 = torch.zeros(2, 3, 4, 4), torch.ones(2, 3, 4, 4)
        xt, v = BaseFlowModel.get_interpolation(x0, x1, torch.tensor([0.25, 1.0]))
        assert torch.allclose(xt[0], torch.full((3, 4, 4), 0.25))
        assert torch.allclose(xt[1], x1[1]) and torch.equal(v, x1 - x0)

    def test_unknown_method_raises(self):
        _, tm = _pair()
        with pytest.raises(ValueError):
            tm.sample(num_steps=2, batch_size=1, method="rk7")


class TestCheckpoints:
    def test_jax_npz_loads_via_from_checkpoint(self, tmp_path):
        """A checkpoint saved by the JAX ``save`` gives the same velocity."""
        jm = JBase(seed=4, **TINY)
        path = str(tmp_path / "base.npz")
        jm.save(path)
        tm = BaseFlowModel.from_checkpoint(path, device="cpu")
        assert type(tm) is BaseFlowModel and tm.config == jm.config
        x, t = _noise(seed=4), np.array([0.3, 0.7], np.float32)
        np.testing.assert_allclose(
            tm(x, t).numpy(), np.asarray(jm.forward(x, t)), rtol=0, atol=ATOL
        )

    def test_port_npz_loads_in_jax(self, tmp_path):
        tm = BaseFlowModel(device="cpu", seed=5, **TINY)
        path = str(tmp_path / "port.npz")
        tm.save(path)
        jm = JBase.from_checkpoint(path)
        x, t = _noise(seed=5), np.array([0.2, 0.4], np.float32)
        np.testing.assert_allclose(
            tm(x, t).numpy(), np.asarray(jm.forward(x, t)), rtol=0, atol=ATOL
        )

    def test_rectified_checkpoint_restores_class(self, tmp_path):
        jr = JRect(seed=6, **TINY)
        jr.reflow_iteration = 2
        path = str(tmp_path / "rect.npz")
        jr.save(path)
        tm = BaseFlowModel.from_checkpoint(path, device="cpu")
        assert isinstance(tm, RectifiedFlowModel) and tm.reflow_iteration == 2
        assert tm.config == jr.config

    def test_load_rejects_other_architecture(self, tmp_path):
        path = str(tmp_path / "wide.npz")
        BaseFlowModel(device="cpu", **dict(TINY, model_channels=32)).save(path)
        tm = BaseFlowModel(device="cpu", **TINY)
        with pytest.raises(ValueError, match="mismatch"):
            tm.load(path)

    def test_from_base_model(self):
        base = BaseFlowModel(device="cpu", seed=7, **TINY)
        fresh = RectifiedFlowModel.from_base_model(base)
        copied = RectifiedFlowModel.from_base_model(base, copy_weights=True)
        x, t = _noise(seed=7), np.array([0.5, 0.5], np.float32)
        assert torch.equal(copied(x, t), base(x, t))
        assert not torch.equal(fresh(x, t), base(x, t))
        assert copied.sample_dtype == base.sample_dtype and copied.device == base.device


class TestSamplerService:
    def _svc(self, seed=0, **kw):
        tm = BaseFlowModel(device="cpu", seed=8, **TINY)
        kw.setdefault("step_counts", (1, 2))
        kw.setdefault("batch_size", 4)
        return SamplerService(tm, seed=seed, warmup=False, **kw)

    def test_tiling_truncation_and_clip(self):
        svc = self._svc()
        imgs = svc.generate(6, num_steps=2)  # two batches of 4, truncated
        assert imgs.shape == (6, 3, 8, 8) and isinstance(imgs, np.ndarray)
        assert np.isfinite(imgs).all()
        assert imgs.min() >= -1.0 and imgs.max() <= 1.0
        nhwc = self._svc().generate(6, num_steps=2, data_format="NHWC")
        np.testing.assert_array_equal(nhwc, imgs.transpose(0, 2, 3, 1))

    def test_clip_matches_unclipped_sampler(self):
        """generate() is the sampler's output on the service's noise stream,
        clipped to [-1, 1]."""
        svc = self._svc(seed=3)
        gen = torch.Generator().manual_seed(3)
        noise = torch.randn(svc._noise_shape, generator=gen)
        raw = svc.model._get_sampler(1, False, svc.model.sample_dtype, "euler")(noise)
        assert raw.abs().max() > 1.0  # random weights overshoot: the clip is exercised
        got = svc.generate(4, num_steps=1, data_format="NHWC")
        np.testing.assert_array_equal(got, raw.clamp(-1.0, 1.0).numpy())

    def test_unconfigured_steps_raise(self):
        with pytest.raises(ValueError, match="not precompiled"):
            self._svc(step_counts=(2,)).generate(2, num_steps=4)

    def test_same_seed_same_images(self):
        a = self._svc(seed=1).generate(5, num_steps=1)
        b = self._svc(seed=1).generate(5, num_steps=1)
        c = self._svc(seed=2).generate(5, num_steps=1)
        np.testing.assert_array_equal(a, b)
        assert not np.allclose(a, c)

    def test_distinct_batches_and_throughput(self):
        svc = self._svc()
        assert not np.allclose(svc.generate(2, num_steps=1), svc.generate(2, num_steps=1))
        stats = svc.warmup()
        assert set(stats) == {1, 2}
        assert svc.throughput(1, iters=2) > 0

    def test_matches_jax_sampler_on_same_noise(self):
        """The service's sampler is the model's: bf16 compute, fp32 state.
        Held against the JAX sampler in bf16, within 3% of the output scale
        (bf16 rounding at every layer, as in the UNet test)."""
        jm = JBase(seed=9, **dict(TINY, sample_dtype="bfloat16"))
        tm = BaseFlowModel(device="cpu", params=jm.params, **dict(TINY, sample_dtype="bfloat16"))
        svc = SamplerService(tm, step_counts=(2,), batch_size=2, warmup=False)
        noise = np.random.default_rng(9).standard_normal((2, 8, 8, 3)).astype(np.float32)
        out = svc._samplers[2](torch.from_numpy(noise)).numpy()
        ref = np.asarray(jm._get_sampler(2, False, jnp.bfloat16)(jm.params, jnp.asarray(noise)))
        assert np.abs(out - ref).max() <= 0.03 * np.abs(ref).max()

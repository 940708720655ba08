"""The port's training and Reflow path, held against the JAX package on the CPU.

Small model (32x32, 32 channels, mult (1, 2), 1 res-block), inputs from a
numpy seed, weights made by the JAX ``init`` and carried over through
``params_to_state_dict``. The two packages draw different random numbers from
one seed, so every comparison hands both the same ``x0`` and ``t``: the test
re-derives ``t`` from the JAX key as ``loss_fn`` does and gives it to the
port. Dropout is off wherever JAX is the reference (the masks cannot agree;
``tests/test_torch_dropout.py`` holds the port's dropout to its contract).

Tolerances: fp32 atol 1e-5 on the loss, on gradients, and on parameters and
EMA after three AdamW steps (the same fp32 arithmetic in another summation
order; what Adam does to a gradient at the level of rounding noise is stated
at ``_compare_params``). bf16 compute: rtol 2e-2 on the loss; each gradient
leaf within 2.5e-2 of its norm of JAX's fp32 gradient and within 4e-2 of JAX's
bf16 gradient, which itself lies 2.5-3% from the fp32 one (every layer rounds
to bf16 on both sides, forward and backward, and the two backward passes
round at other points). The schedule 1e-7; pairs and straightness atol 1e-4
(up to 4 network evaluations per sample).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectified_flow_vision_tpu.models import BaseFlowModel as JBase
from rectified_flow_vision_tpu.models import RectifiedFlowModel as JRect
from rectified_flow_vision_tpu.models import base_flow as JBF
from rectified_flow_vision_tpu.models import rectified_flow as JRF
from rectified_flow_vision_tpu_torch import data as TD
from rectified_flow_vision_tpu_torch.models import BaseFlowModel, RectifiedFlowModel
from rectified_flow_vision_tpu_torch.models import base_flow as TBF
from rectified_flow_vision_tpu_torch.models import rectified_flow as TRF
from rectified_flow_vision_tpu_torch.utils import checkpoint as ckpt
from rectified_flow_vision_tpu_torch.utils import pt_import as TPT

SMALL = dict(image_size=32, model_channels=32, channel_mult=[1, 2], num_res_blocks=1,
             dropout=0.0, sample_dtype="float32")
TINY = dict(image_size=8, model_channels=16, channel_mult=[1], num_res_blocks=1,
            sample_dtype="float32")
ATOL = 1e-5


def _pair(cfg=SMALL, seed=0, cls=(JBase, BaseFlowModel), **kw):
    jm = cls[0](seed=seed, **{**cfg, **kw})
    tm = cls[1](device="cpu", params=jax.tree_util.tree_map(np.asarray, jm.params),
                **{**cfg, **kw})
    return jm, tm


def _images(n, size=32, seed=0):
    r = np.random.default_rng(seed)
    return np.tanh(r.standard_normal((n, size, size, 3))).astype(np.float32)


def _jax_times(rng, batch, time_sampling):
    """``t`` as ``loss_fn`` draws it from ``rng`` (and the noise it would draw)."""
    k_noise, k_t, _ = jax.random.split(rng, 3)
    if time_sampling == "uniform":
        t = jax.random.uniform(k_t, (batch,), jnp.float32)
    elif time_sampling == "logit_normal":
        t = jax.nn.sigmoid(jax.random.normal(k_t, (batch,), jnp.float32))
    else:
        t = 0.5 - 0.5 * jnp.cos(jnp.pi * jax.random.uniform(k_t, (batch,), jnp.float32))
    return np.asarray(t), k_noise


def _grad_tree(model):
    sd = {k: p.grad.numpy() for k, p in model.named_parameters()}
    return TPT.state_dict_to_params(sd)[0]


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


class TestLoss:
    @pytest.mark.parametrize("coupled", [False, True], ids=["fresh_noise", "coupled"])
    @pytest.mark.parametrize("time_sampling", ["uniform", "logit_normal", "u_shaped"])
    def test_loss_and_grads_match_jax_fp32(self, time_sampling, coupled):
        jm, tm = _pair()
        x1 = _images(4, seed=1)
        rng = jax.random.key(7)
        t, k_noise = _jax_times(rng, 4, time_sampling)
        if coupled:
            x0 = np.random.default_rng(2).standard_normal(x1.shape).astype(np.float32)
        else:
            x0 = np.asarray(jax.random.normal(k_noise, x1.shape, jnp.float32))

        def jloss(p):
            return jm.loss_fn(p, jnp.asarray(x1), rng, x0=jnp.asarray(x0) if coupled else None,
                              time_sampling=time_sampling)

        ref, gref = jax.value_and_grad(jloss)(jm.params)
        loss = tm.loss_fn(torch.from_numpy(x1), x0=torch.from_numpy(x0),
                          t=torch.from_numpy(t), time_sampling=time_sampling)
        loss.backward()
        assert abs(float(loss.detach()) - float(ref)) <= ATOL
        got, want = _leaves(_grad_tree(tm)), _leaves(gref)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATOL, err_msg=k)

    @pytest.mark.parametrize("coupled", [False, True], ids=["fresh_noise", "coupled"])
    def test_loss_and_grads_match_jax_bf16(self, coupled):
        """bf16 compute on fp32 masters: weights cast per op, biases and norm
        parameters unrounded, on both sides."""
        jm, tm = _pair(compute_dtype="bfloat16", seed=1)
        x1 = _images(4, seed=3)
        rng = jax.random.key(8)
        t, k_noise = _jax_times(rng, 4, "uniform")
        if coupled:
            x0 = np.random.default_rng(4).standard_normal(x1.shape).astype(np.float32)
        else:
            x0 = np.asarray(jax.random.normal(k_noise, x1.shape, jnp.float32))

        def jloss(p):
            return jm.loss_fn(p, jnp.asarray(x1), rng, x0=jnp.asarray(x0) if coupled else None)

        ref, gref = jax.value_and_grad(jloss)(jm.params)
        jm.compute_dtype = jnp.float32
        gref32 = jax.grad(jloss)(jm.params)
        loss = tm.loss_fn(torch.from_numpy(x1), x0=torch.from_numpy(x0), t=torch.from_numpy(t))
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=2e-2)
        got, want, want32 = _leaves(_grad_tree(tm)), _leaves(gref), _leaves(gref32)
        for k in want:
            assert got[k].dtype == np.float32
            norm = np.linalg.norm(want32[k])
            assert np.linalg.norm(got[k] - want32[k]) <= 2.5e-2 * norm + 1e-6, k
            assert np.linalg.norm(got[k] - want[k]) <= 4e-2 * norm + 1e-6, k

    def test_fresh_draws_come_from_the_generator(self):
        _, tm = _pair(TINY, dropout=0.1)
        x1 = torch.from_numpy(_images(2, size=8))
        a = tm.loss_fn(x1, torch.Generator().manual_seed(3))
        b = tm.loss_fn(x1, torch.Generator().manual_seed(3))
        c = tm.loss_fn(x1, torch.Generator().manual_seed(4))
        assert float(a) == float(b) != float(c)
        ev = tm.compute_loss(x1, torch.Generator().manual_seed(3), data_format="NHWC")
        assert not ev.requires_grad and float(ev) != float(a)  # eval: no dropout
        with pytest.raises(ValueError, match="time_sampling"):
            tm.loss_fn(x1, time_sampling="beta")

    @pytest.mark.parametrize("time_sampling", ["uniform", "logit_normal", "u_shaped"])
    def test_time_distributions(self, time_sampling):
        t = TBF.sample_times(time_sampling, 20000, torch.Generator().manual_seed(0),
                             torch.device("cpu")).numpy()
        assert t.dtype == np.float32 and t.min() >= 0.0 and t.max() <= 1.0
        ends = np.mean((t < 0.1) | (t > 0.9))
        # uniform 0.2; arcsine law 2/pi * asin(sqrt(0.1)) * 2 = 0.41; logit-normal 0.028
        want = {"uniform": 0.2, "u_shaped": 0.4097, "logit_normal": 0.028}[time_sampling]
        assert abs(ends - want) < 0.015


class TestGroupNormBackward:
    """What the card's GroupNorm backward kernel computes is what training on
    the CPU differentiates: autograd of the plain ``gn_silu_dropout`` (the
    UNet's dropout sites) against ``gn_silu_dropout_backward_plain``, the
    kernel's formulas from the saved statistics; fp32 1e-5, bf16 2e-2 of
    each gradient's largest entry."""

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
    def test_dropout_site_gradients_match_the_kernel_formulas(self, dtype):
        from rectified_flow_vision_tpu_torch.ops import fused
        from rectified_flow_vision_tpu_torch.ops import gn_silu as G
        from rectified_flow_vision_tpu_torch.ops import gn_silu_dropout as D

        r = np.random.default_rng(30)
        x = torch.from_numpy(r.standard_normal((2, 8, 8, 32)).astype(np.float32) * 2 + 0.3)
        s = torch.from_numpy(r.standard_normal(32).astype(np.float32) * 0.2 + 1)
        b = torch.from_numpy(r.standard_normal(32).astype(np.float32) * 0.2)
        g = torch.from_numpy(r.standard_normal((2, 8, 8, 32)).astype(np.float32)).to(dtype)
        leaves = [x.to(dtype).requires_grad_(), s.clone().requires_grad_(),
                  b.clone().requires_grad_()]
        out = fused.gn_silu_dropout(*leaves, 0.1, 1234, train=True)
        want = torch.autograd.grad(out, leaves, g)
        xd = leaves[0].detach()
        got = D.gn_silu_dropout_backward_plain(xd, g, s, b, G.gn_stats_plain(xd), 1234, 0.1)
        tol = 1e-5 if dtype == torch.float32 else 2e-2
        for a, w in zip(got, want):
            assert a.dtype == w.dtype
            assert float((a.float() - w.float()).abs().max()) <= tol * float(w.float().abs().max())


class TestSchedule:
    @pytest.mark.parametrize("warmup", [0.0, 1.5], ids=["no_warmup", "warmup"])
    def test_schedule_matches_jax(self, warmup):
        lr, epochs, spe = 2e-4, 7, 5
        ref = JBF.make_epoch_cosine_schedule(lr, epochs, spe, warmup)
        ours = TBF.make_epoch_cosine_schedule(lr, epochs, spe, warmup)
        steps = list(range(0, 12)) + [17, 20, 34, 35, 36, 50]
        got = np.array([ours(s) for s in steps])
        want = np.array([float(ref(jnp.asarray(s))) for s in steps])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7 * lr)
        assert got[-1] == 0.0 or warmup  # past the last epoch the cosine is at 0
        assert all(isinstance(ours(s), float) for s in steps[:2])


# The key bias of the attention block has a gradient that is zero in exact
# arithmetic (softmax is invariant to a shift of the logits along the keys),
# so what each package computes for it is rounding noise.
ATTN_KEY_BIAS = ("['mid_attn']['qkv']['b']", slice(64, 128))


def _compare_params(got_tree, want_tree, atol, lr, steps):
    """Parameters after ``steps`` AdamW steps. Adam's update is
    lr * m / (sqrt(v) + eps): a gradient at the level of fp32 rounding noise
    is divided by its own magnitude, so two correct implementations can move
    such an element apart by up to lr per step. Held: every element within
    steps * lr, and all of each leaf within ``atol`` but one element in 10,000
    (two in a small leaf); the attention key bias, all noise, only to the
    first."""
    got, want = _leaves(got_tree), _leaves(want_tree)
    assert set(got) == set(want)
    for k in want:
        diff = np.abs(got[k] - want[k])
        assert diff.max() <= steps * lr * 1.001, k
        if k == ATTN_KEY_BIAS[0]:
            diff = np.delete(diff, np.r_[ATTN_KEY_BIAS[1]])
        assert np.sum(diff > atol) <= max(2, diff.size // 10000), (k, diff.max())


class TestTrainStep:
    def test_three_steps_with_ema_match_jax(self, monkeypatch):
        jm, tm = _pair(seed=2)
        lr, decay = 1e-4, 0.9
        batches = [(np.random.default_rng(10 + i).standard_normal((4, 32, 32, 3))
                    .astype(np.float32), _images(4, seed=20 + i)) for i in range(3)]
        keys = [jax.random.key(30 + i) for i in range(3)]
        times = iter([torch.from_numpy(_jax_times(k, 4, "uniform")[0]) for k in keys])
        monkeypatch.setattr(TBF, "sample_times", lambda *a: next(times))

        tx = JBF.make_optimizer(lr, 2, 2)  # the lr changes after two steps
        jstep = JBF.make_train_step(jm, tx, coupled=True, ema_decay=decay)
        params = jax.tree_util.tree_map(jnp.array, jm.params)
        ema = jax.tree_util.tree_map(jnp.array, params)
        opt_state = tx.init(params)
        jlosses = []
        for (x0, x1), key in zip(batches, keys):
            params, ema, opt_state, loss = jstep(
                params, ema, opt_state, (jnp.asarray(x0), jnp.asarray(x1)), key)
            jlosses.append(float(loss))

        opt = TBF.make_optimizer(tm, lr, 2, 2)
        tema = TBF.init_ema(tm)
        tstep = TBF.make_train_step(tm, opt, coupled=True, ema=tema, ema_decay=decay)
        gen = torch.Generator().manual_seed(0)
        tlosses = [float(tstep((torch.from_numpy(x0), torch.from_numpy(x1)), gen))
                   for x0, x1 in batches]

        np.testing.assert_allclose(tlosses, jlosses, rtol=0, atol=ATOL)
        assert opt.step_count == 3
        _compare_params(tm.params, params, ATOL, lr, 3)
        _compare_params(TBF.ema_params(tema), ema, ATOL, lr, 3)
        # the weights moved, and the EMA lags them
        moved = np.abs(_leaves(tm.params)["['input_conv']['w']"]
                       - _leaves(jm.params)["['input_conv']['w']"]).max()
        assert moved > 1e-4

    def test_clip_scales_only_above_norm_one(self):
        """optax.clip_by_global_norm(1.0): g / norm where norm >= 1, else g."""
        for scale, clipped in ((0.01, False), (100.0, True)):
            p = torch.nn.Parameter(torch.zeros(4))
            q = torch.nn.Parameter(torch.zeros(3))
            opt = TBF.FlowOptimizer([p, q], lambda step: 0.0)
            p.grad = torch.tensor([3.0, 0.0, 0.0, 0.0]) * scale
            q.grad = torch.tensor([0.0, 4.0, 0.0]) * scale
            opt.step()
            norm = 5.0 * scale
            want = 3.0 * scale / norm if clipped else 3.0 * scale
            assert float(p.grad[0]) == pytest.approx(want, rel=1e-6)

    def test_ema_arguments_go_together(self):
        _, tm = _pair(TINY)
        opt = TBF.make_optimizer(tm, 1e-4, 1, 1)
        with pytest.raises(ValueError, match="together"):
            TBF.make_train_step(tm, opt, coupled=False, ema_decay=0.9)


class TestTrainers:
    def test_reflow_epoch_matches_jax(self, monkeypatch):
        """One ``train_rectified_flow`` epoch, dropout 0: both packages take
        the permutation ``default_rng(seed * 99991 + epoch)``; the port is
        handed the times the JAX step keys give."""
        jm, tm = _pair(seed=3, cls=(JRect, RectifiedFlowModel))
        x0 = np.random.default_rng(5).standard_normal((8, 32, 32, 3)).astype(np.float32)
        x1 = _images(8, seed=6)
        seed, bs = 4, 4
        epoch_key = jax.random.fold_in(jax.random.key(seed), 0)
        times = iter([
            torch.from_numpy(_jax_times(jax.random.fold_in(epoch_key, i), bs, "u_shaped")[0])
            for i in range(2)
        ])
        monkeypatch.setattr(TBF, "sample_times", lambda *a: next(times))
        kw = dict(epochs=1, batch_size=bs, lr=1e-4, seed=seed, data_format="NHWC",
                  progress=False, time_sampling="u_shaped", device_epoch=False)
        jl = JRF.train_rectified_flow(jm, x0, x1, **kw)
        tl = TRF.train_rectified_flow(tm, x0, x1, **kw)
        np.testing.assert_allclose(tl, jl, rtol=0, atol=ATOL)
        _compare_params(tm.params, jm.params, ATOL, 1e-4, 2)

    def test_device_epoch_equals_the_per_step_path(self, tmp_path):
        """Same seeds, same trajectory: twice, and on both paths; EMA
        checkpoints are written beside the model's."""
        data = TD.ArrayDataset(_images(10, size=8, seed=7))
        runs = []
        for i, device_epoch in enumerate((True, True, False)):
            tm = BaseFlowModel(device="cpu", seed=5, **{**TINY, "dropout": 0.1})
            losses = TBF.train_base_flow(
                tm, data, epochs=3, lr=1e-3, batch_size=4, seed=9, ema_decay=0.9,
                save_path=str(tmp_path / f"run{i}"), save_every=2, progress=False,
                device_epoch=device_epoch, warmup_epochs=1.0,
            )
            runs.append((losses, tm.params))
        assert runs[0][0] == runs[1][0] == runs[2][0] and len(runs[0][0]) == 3
        for a, b in zip(_leaves(runs[0][1]).values(), _leaves(runs[2][1]).values()):
            np.testing.assert_array_equal(a, b)
        names = sorted(p.name for p in tmp_path.glob("run0_*"))
        assert names == ["run0_ema_epoch2.npz", "run0_ema_final.npz", "run0_epoch2.npz",
                         "run0_final.npz"]
        ema, cfg = ckpt.load_params(tmp_path / "run0_ema_final.npz")
        assert cfg == tm.config
        w, e = _leaves(runs[0][1]), _leaves(ema)
        assert not np.array_equal(w["['input_conv']['w']"], e["['input_conv']['w']"])
        served = BaseFlowModel.from_checkpoint(str(tmp_path / "run0_ema_final.npz"), device="cpu")
        assert served.sample(num_steps=1, batch_size=2).shape == (2, 3, 8, 8)

    def test_iterable_protocol_and_dataset_checks(self):
        batches = [_images(4, size=8, seed=i) for i in range(3)]
        tm = BaseFlowModel(device="cpu", seed=6, **TINY)
        losses = TBF.train_base_flow(tm, batches, epochs=2, lr=1e-3, progress=False)
        assert len(losses) == 2 and all(np.isfinite(losses))
        with pytest.raises(ValueError, match="batch_size"):
            TBF.train_base_flow(tm, TD.ArrayDataset(batches[0]), epochs=1)
        with pytest.raises(ValueError, match="empty"):
            TBF.train_base_flow(tm, [], epochs=1)
        with pytest.raises(ValueError, match="images"):
            TBF.train_base_flow(tm, batches, epochs=1, device_epoch=True)

    def test_training_lowers_the_loss(self):
        data = TD.ArrayDataset(_images(16, size=8, seed=8))
        tm = BaseFlowModel(device="cpu", seed=7, **{**TINY, "dropout": 0.1})
        losses = TBF.train_base_flow(tm, data, epochs=20, lr=2e-3, batch_size=8, progress=False)
        assert np.mean(losses[-3:]) < 0.92 * np.mean(losses[:3])

    def test_iterative_reflow_promotes_the_ema(self, tmp_path):
        teacher = BaseFlowModel(device="cpu", seed=8, **{**TINY, "dropout": 0.1})
        models = TRF.iterative_reflow(
            teacher, num_iterations=2, epochs_per_iter=1, num_pairs=6, teacher_steps=30,
            lr=1e-3, save_dir=str(tmp_path), pair_batch_size=4, batch_size=2, seed=1,
            init_from_teacher=True, teacher_method="heun", time_sampling="u_shaped",
            ema_decay=0.5,
        )
        assert [m.reflow_iteration for m in models] == [1, 2]
        ema, _ = ckpt.load_params(tmp_path / "reflow_k2_ema_final.npz")
        for a, b in zip(_leaves(models[1].params).values(), _leaves(ema).values()):
            np.testing.assert_array_equal(a, b)
        trained, _ = ckpt.load_params(tmp_path / "reflow_k2_final.npz")
        assert not np.array_equal(_leaves(trained)["['input_conv']['w']"],
                                  _leaves(ema)["['input_conv']['w']"])


class TestDataset:
    def test_image_dataset_matches_jax(self, tmp_path):
        """The same files decode to the same corpus, and one seed gives the
        same batches, tiled up when the corpus is smaller than a batch."""
        import shutil
        from pathlib import Path

        from rectified_flow_vision_tpu.data import dataset as JD

        src = sorted((Path(__file__).resolve().parent.parent / "data" / "mock_images_256")
                     .glob("*.png"))[:5]
        for f in src:
            shutil.copy(f, tmp_path / f.name)
        ours, ref = TD.ImageDataset(tmp_path, 16), JD.ImageDataset(tmp_path, 16)
        assert len(ours) == len(ref) == 5 and ours.images.dtype == np.float32
        np.testing.assert_array_equal(ours.images, ref.images)
        np.testing.assert_array_equal(ours[3], ref[3])
        for bs in (2, 5, 8):
            assert ours.num_batches(bs) == ref.num_batches(bs)
            assert ours.num_batches(bs, drop_last=False) == ref.num_batches(bs, drop_last=False)
            got, want = list(ours.batches(bs, seed=11)), list(ref.batches(bs, seed=11))
            assert len(got) == len(want) == ours.num_batches(bs)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
        assert len(list(ours.batches(2, seed=1, drop_last=False))) == 3
        empty = TD.ImageDataset(tmp_path / "none", 16)
        assert len(empty) == 0 and list(empty.batches(2)) == [] and empty.num_batches(2) == 0

    def test_array_dataset_and_layouts(self):
        from rectified_flow_vision_tpu.data import dataset as JD

        x = _images(6, size=8, seed=9)
        ours, ref = TD.ArrayDataset(x), JD.ArrayDataset(x)
        for a, b in zip(ours.batches(4, seed=3), ref.batches(4, seed=3)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(TD.as_nhwc(TD.as_nchw(x)), x)
        assert TD.as_nchw(x).shape == (6, 3, 8, 8)
        with pytest.raises(ValueError, match="N, H, W, C"):
            TD.ArrayDataset(x[0])


class TestReflowPairs:
    def test_forward_pairs_shapes_padding_and_teacher(self):
        """6 pairs at batch 4: two full-shape batches, cut to 6; x1 is the
        JAX teacher's heun sample from the same noise."""
        jm, tm = _pair(TINY, seed=9)
        x0, x1 = TRF.generate_reflow_pairs(tm, 6, batch_size=4, num_steps=2, seed=3,
                                           method="heun")
        assert x0.shape == x1.shape == (6, 3, 8, 8) and x0.dtype == np.float32
        ref = np.asarray(jm.sample(noise=x0, num_steps=2, method="heun"))
        np.testing.assert_allclose(x1, ref, rtol=0, atol=1e-4)
        again = TRF.generate_reflow_pairs(tm, 6, batch_size=4, num_steps=2, seed=3,
                                          method="heun")
        np.testing.assert_array_equal(again[0], x0)
        assert abs(float(x0.mean())) < 0.15 and abs(float(x0.std()) - 1.0) < 0.1

    def test_data_side_pairs_match_jax(self):
        """3 data-side pairs from 2 real images (inverted once, tiled), then
        forward pairs; the data-side part is deterministic in both packages."""
        jm, tm = _pair(TINY, seed=10)
        real = _images(2, size=8, seed=11)
        kw = dict(batch_size=4, num_steps=3, seed=2, data_format="NHWC", method="euler",
                  real_data=real, data_pair_fraction=0.5)
        jx0, jx1 = JRF.generate_reflow_pairs(jm, 6, **kw)
        tx0, tx1 = TRF.generate_reflow_pairs(tm, 6, **kw)
        assert tx0.shape == tx1.shape == jx0.shape == (6, 8, 8, 3)
        np.testing.assert_allclose(tx0[:3], jx0[:3], rtol=0, atol=1e-4)
        np.testing.assert_array_equal(tx1[:3], jx1[:3])
        np.testing.assert_array_equal(tx1[2], real[0])
        ref = np.asarray(jm.sample(noise=tx0[3:], num_steps=3, data_format="NHWC"))
        np.testing.assert_allclose(tx1[3:], ref, rtol=0, atol=1e-4)
        with pytest.raises(ValueError, match="real_data"):
            TRF.generate_reflow_pairs(tm, 4, data_pair_fraction=0.5)

    def test_straightness_matches_jax(self):
        jm, tm = _pair(TINY, seed=12, cls=(JRect, RectifiedFlowModel))
        r = np.random.default_rng(13)
        x0 = r.standard_normal((3, 3, 8, 8)).astype(np.float32)
        x1 = np.tanh(r.standard_normal((3, 3, 8, 8))).astype(np.float32)
        ref = jm.compute_straightness(x0, x1, num_points=4)
        got = tm.compute_straightness(x0, x1, num_points=4)
        assert isinstance(got, float) and abs(got - ref) <= 1e-4

"""The port's DiT and the flow model around it, held against the JAX package on the CPU.

Every leaf of the parameters is random (numpy, from a seed) and carried across
through ``BaseFlowModel.params``: adaLN-Zero makes a fresh DiT the zero
function, in which no error of a block could reach the output. Only the
initialisation test uses the zeros. Two sizes: the tiny model of
``tests/test_dit.py`` (8x8x4 latents, hidden 32, 16 tokens: the plain
attention) and a narrow one whose 64x64 input gives 1024 tokens, so that the
flash route's plain version is the one exercised; and one block at DiT-XL/2's
widths (16 heads of 72) at 1024 tokens.

Tolerances: fp32 atol 1e-4 on the forward, 1e-5 on the loss, its gradients and
the parameters after three AdamW steps (what Adam does to a gradient that is
rounding noise is stated at ``_compare_params``); bf16 rtol 2e-2 of the
output's scale (both sides round to bf16 after every op, XLA may fuse some
roundings away).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectified_flow_vision_tpu.models import BaseFlowModel as JBase
from rectified_flow_vision_tpu.models import RectifiedFlowModel as JRect
from rectified_flow_vision_tpu.models import base_flow as JBF
from rectified_flow_vision_tpu.models import dit as JD
from rectified_flow_vision_tpu.models.unet import count_parameters as jax_count
from rectified_flow_vision_tpu.utils import checkpoint as jckpt
from rectified_flow_vision_tpu_torch.models import BaseFlowModel, RectifiedFlowModel
from rectified_flow_vision_tpu_torch.models import base_flow as TBF
from rectified_flow_vision_tpu_torch.models import dit as TDIT
from rectified_flow_vision_tpu_torch.ops import build
from rectified_flow_vision_tpu_torch.ops import fused as TF
from rectified_flow_vision_tpu_torch.utils import checkpoint as ckpt
from rectified_flow_vision_tpu_torch.utils import pt_import as TPT

TINY = dict(image_size=8, in_channels=4, backbone="dit", patch_size=2, hidden_size=32,
            depth=2, num_heads=4, sample_dtype="float32")
NARROW = dict(image_size=64, in_channels=4, backbone="dit", patch_size=2, hidden_size=64,
              depth=2, num_heads=2, sample_dtype="float32")
ATOL = 1e-5


def _random_tree(tree, seed, scale=0.1):
    r = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (r.standard_normal(a.shape) * scale).astype(np.float32), tree)


def _pair(cfg=TINY, seed=0, cls=(JBase, BaseFlowModel), **kw):
    """A JAX model and the port's, on the same all-random parameters."""
    jm = cls[0](seed=seed, **{**cfg, **kw})
    jm.params = jax.tree_util.tree_map(jnp.asarray, _random_tree(jm.params, seed + 100))
    tm = cls[1](device="cpu", params=jax.tree_util.tree_map(np.asarray, jm.params),
                **{**cfg, **kw})
    return jm, tm


def _inputs(cfg, batch, seed=0):
    r = np.random.default_rng(seed)
    s = cfg["image_size"]
    x = r.standard_normal((batch, s, s, 4)).astype(np.float32)
    return x, r.random(batch).astype(np.float32)


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _grad_tree(model):
    sd = {k: p.grad.numpy() for k, p in model.named_parameters()}
    return TPT.backbone_state_dict_to_params(sd, "dit")


class TestForward:
    @pytest.mark.parametrize("cfg,batch", [(TINY, 2), (NARROW, 1)], ids=["tiny", "1024_tokens"])
    def test_forward_matches_jax_fp32(self, cfg, batch):
        jm, tm = _pair(cfg)
        x, t = _inputs(cfg, batch)
        want = np.asarray(jax.jit(jm.velocity_net.apply)(jm.params, jnp.asarray(x), jnp.asarray(t)))
        with torch.no_grad():
            got = tm.velocity_net(torch.from_numpy(x), torch.from_numpy(t)).numpy()
        assert got.shape == x.shape and np.abs(want).max() > 0.1
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)

    @pytest.mark.parametrize("cfg,batch", [(TINY, 2), (NARROW, 1)], ids=["tiny", "1024_tokens"])
    def test_forward_matches_jax_bf16(self, cfg, batch):
        """Sampling numerics: every parameter rounded through bf16 first
        (``pos_embed`` too), compute in bf16."""
        jm, tm = _pair(cfg, seed=1)
        x, t = _inputs(cfg, batch, seed=1)
        cparams = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jm.params)
        want = np.asarray(jm.velocity_net.apply(
            cparams, jnp.asarray(x, jnp.bfloat16), jnp.asarray(t),
            compute_dtype=jnp.bfloat16).astype(jnp.float32))
        with torch.no_grad():
            got = tm.velocity_net(torch.from_numpy(x), torch.from_numpy(t), dtype=torch.bfloat16)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                                   atol=2e-2 * np.abs(want).max())

    def test_xl_widths_forward_matches_jax_fp32(self, monkeypatch):
        """DiT-XL/2's widths (hidden 1152, 16 heads of 72, patch 2) at depth 1
        on 64x64x4 latents: 1024 tokens, so head width 72 takes the flash
        route. Parameters carried across by ``tree_to_state_dict``; leaves of
        N(0, 0.02) (DiT's init scale) keep the output of order 1."""
        hidden, _, heads = JD.DIT_SIZES["XL"]
        kw = dict(input_size=64, patch_size=2, in_channels=4, hidden_size=hidden, depth=1,
                  num_heads=heads)
        jd = JD.DiT(**kw)
        params = _random_tree(jax.eval_shape(jd.init, jax.random.key(0)), 11, scale=0.02)
        net = TDIT.DiT(**kw)
        net.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                             for k, v in TPT.tree_to_state_dict(params).items()}, strict=True)
        x, t = _inputs(NARROW, 1, seed=12)
        want = np.asarray(jax.jit(jd.apply)(jax.tree_util.tree_map(jnp.asarray, params),
                                            jnp.asarray(x), jnp.asarray(t)))
        seen = []
        plain = TF.FA.flash_attention_plain
        monkeypatch.setattr(TF.FA, "flash_attention_plain",
                            lambda q, k, v: seen.append(tuple(q.shape)) or plain(q, k, v))
        with torch.no_grad():
            got = net(torch.from_numpy(x), torch.from_numpy(t)).numpy()
        assert seen == [(1, 1024, 16, 72)] and got.shape == x.shape
        assert np.abs(want).max() > 0.1
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)

    def test_heads_of_384_forward_and_gradients_match_jax_fp32(self):
        """DiT-XL/2's hidden 1152 in 3 heads of 384 (both packages' DiT take
        it; on the card the streamed bf16 flash kernels and the fp32 *_wide
        kernels in two chunks) at depth 1 on 8x8x4 latents (16 tokens, the
        plain attention on either side). Parameters carried across by
        ``tree_to_state_dict``; the forward and the gradient of every
        parameter of sum(out * cotangent) against ``DiT.apply`` and
        ``jax.grad``, within 1e-4."""
        kw = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=1152, depth=1,
                  num_heads=3)
        jd = JD.DiT(**kw)
        params = _random_tree(jax.eval_shape(jd.init, jax.random.key(0)), 21, scale=0.02)
        net = TDIT.DiT(**kw)
        net.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                             for k, v in TPT.tree_to_state_dict(params).items()}, strict=True)
        x, t = _inputs(TINY, 2, seed=22)
        cot = np.random.default_rng(23).standard_normal(x.shape).astype(np.float32)
        jp = jax.tree_util.tree_map(jnp.asarray, params)
        xj, tj = jnp.asarray(x), jnp.asarray(t)
        want = np.asarray(jd.apply(jp, xj, tj))
        gref = jax.grad(lambda p: jnp.sum(jd.apply(p, xj, tj) * jnp.asarray(cot)))(jp)
        got = net(torch.from_numpy(x), torch.from_numpy(t), masters=True)
        (got * torch.from_numpy(cot)).sum().backward()
        assert net.cfg.hidden_size // net.cfg.num_heads == 384
        assert np.abs(want).max() > 0.1
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-4)
        grads = {k: p.grad.numpy() for k, p in net.named_parameters()}
        wants = TPT.tree_to_state_dict(jax.tree_util.tree_map(np.asarray, gref))
        assert set(grads) == set(wants)
        for k, w in wants.items():
            np.testing.assert_allclose(grads[k], w, rtol=0, atol=1e-4, err_msg=k)

    def test_the_1024_token_model_takes_the_flash_route(self, monkeypatch):
        _, tm = _pair(NARROW)
        x, t = _inputs(NARROW, 1)
        seen = []
        build.reset_launches()
        plain = TF.FA.flash_attention_plain
        monkeypatch.setattr(TF.FA, "flash_attention_plain",
                            lambda q, k, v: seen.append(tuple(q.shape)) or plain(q, k, v))
        with torch.no_grad():
            tm.velocity_net(torch.from_numpy(x), torch.from_numpy(t))
        assert seen == [(1, 1024, 2, 32)] * 2 and TF.FA.use_flash(1024)
        assert sum(build.LAUNCHES.values()) == 0  # the CPU launches no kernel

    def test_zero_output_at_initialisation(self):
        tm = BaseFlowModel(device="cpu", seed=3, **TINY)
        x, t = _inputs(TINY, 2, seed=2)
        with torch.no_grad():
            y = tm.velocity_net(torch.from_numpy(x), torch.from_numpy(t))
        assert float(y.abs().max()) <= 1e-6
        net = tm.velocity_net
        assert float(net.blocks[0].ada.weight.detach().abs().max()) == 0.0
        assert float(net.final.linear.weight.detach().abs().max()) == 0.0
        assert float(net.pos_embed.detach().std()) == pytest.approx(0.02, rel=0.2)
        w = net.blocks[1].mlp1.weight.detach()
        assert float(w.abs().max()) <= (6.0 / (32 + 128)) ** 0.5
        assert float(net.blocks[1].mlp1.bias.detach().abs().max()) == 0.0

    def test_unpatchify_layout(self):
        """A head that writes patch-index constants gives constant 2x2 tiles
        in row-major (p, p, C) order, as ``tests/test_dit.py`` asks of JAX."""
        tm = BaseFlowModel(device="cpu", **TINY)
        with torch.no_grad():
            tm.velocity_net.final.linear.bias.copy_(torch.arange(16, dtype=torch.float32))
            y = tm.velocity_net(torch.zeros((1, 8, 8, 4)), torch.tensor([0.5]))
        assert (float(y[0, 0, 0, 0]), float(y[0, 0, 1, 0]), float(y[0, 1, 0, 0])) == (0.0, 4.0, 8.0)

    def test_dit_s2_parameter_count_equals_jax(self):
        shapes = jax.eval_shape(JD.DiT(input_size=64, size="S").init, jax.random.key(0))
        want = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes))
        got = TDIT.DiT(input_size=64, size="S")
        assert sum(p.numel() for p in got.parameters()) == want == 32_867_728
        assert TDIT.DIT_SIZES == JD.DIT_SIZES
        assert jax_count(JD.DiT(input_size=8, hidden_size=32, depth=2, num_heads=4)
                         .init(jax.random.key(0))) == BaseFlowModel(device="cpu", **TINY).num_parameters()


class TestLoss:
    @pytest.mark.parametrize("cfg,batch", [(TINY, 4), (NARROW, 1)], ids=["tiny", "1024_tokens"])
    def test_loss_and_grads_match_jax_fp32(self, cfg, batch):
        jm, tm = _pair(cfg, seed=2)
        x1, t = _inputs(cfg, batch, seed=3)
        x0 = np.random.default_rng(4).standard_normal(x1.shape).astype(np.float32)
        rng = jax.random.key(7)
        _, k_t, _ = jax.random.split(rng, 3)
        t = np.asarray(jax.random.uniform(k_t, (batch,), jnp.float32)).copy()

        ref, gref = jax.jit(jax.value_and_grad(
            lambda p: jm.loss_fn(p, jnp.asarray(x1), rng, x0=jnp.asarray(x0))))(jm.params)
        loss = tm.loss_fn(torch.from_numpy(x1), x0=torch.from_numpy(x0), t=torch.from_numpy(t))
        loss.backward()
        assert abs(float(loss.detach()) - float(ref)) <= ATOL
        got, want = _leaves(_grad_tree(tm)), _leaves(gref)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATOL, err_msg=k)

    def test_remat_gives_the_same_gradients(self):
        grads = []
        for remat in (False, True):
            _, tm = _pair(seed=5, remat=remat)
            assert tm.velocity_net.cfg.remat is remat and tm.config["remat"] is remat
            x1, t = _inputs(TINY, 2, seed=6)
            x0 = np.random.default_rng(7).standard_normal(x1.shape).astype(np.float32)
            tm.loss_fn(torch.from_numpy(x1), x0=torch.from_numpy(x0),
                       t=torch.from_numpy(t)).backward()
            grads.append([p.grad.clone() for p in tm.parameters()])
        for a, b in zip(*grads):
            assert torch.equal(a, b)

    def test_bf16_loss_keeps_fp32_masters(self):
        jm, tm = _pair(seed=8, compute_dtype="bfloat16")
        x1, t = _inputs(TINY, 4, seed=9)
        x0 = np.random.default_rng(10).standard_normal(x1.shape).astype(np.float32)
        rng = jax.random.key(3)
        _, k_t, _ = jax.random.split(rng, 3)
        t = np.asarray(jax.random.uniform(k_t, (4,), jnp.float32))
        ref = jm.loss_fn(jm.params, jnp.asarray(x1), rng, x0=jnp.asarray(x0))
        loss = tm.loss_fn(torch.from_numpy(x1), x0=torch.from_numpy(x0), t=torch.from_numpy(t))
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=2e-2)
        assert all(p.grad.dtype == torch.float32 for p in tm.parameters())


GLUE = ("ln_modulate", "bias_act", "gated_residual")


def _glue_sites(depth):
    """The glue entries a forward calls, in order: a block's LayerNorm,
    qkv epilogue, proj + gate + residual, LayerNorm, mlp1 epilogue, mlp2 +
    gate + residual; then the head's LayerNorm."""
    block = ["ln_modulate", "bias_act", "gated_residual"] * 2
    return block * depth + ["ln_modulate"]


def _record_glue(monkeypatch, card=True):
    """Record the calls of ``ops.fused``'s glue entries and of the kernels
    they launch. The kernels are stood in for by their plain versions, and
    with ``card`` the dispatch sees a CUDA tensor, so that it decides as on
    a card (the tiny DiT's 16 tokens keep attention on the plain route)."""
    entries, kernels = [], []
    for name in GLUE:
        entry, plain = getattr(TF, name), getattr(TF.DG, f"{name}_plain")
        monkeypatch.setattr(TF, name, lambda *a, _f=entry, _n=name: entries.append(_n) or _f(*a))
        monkeypatch.setattr(TF.DG, f"{name}_cuda",
                            lambda *a, _f=plain, _n=name: kernels.append(_n) or _f(*a))
    if card:
        monkeypatch.setattr(TF, "_on_cpu", lambda x: False)
    return entries, kernels


class TestGlueDispatch:
    """The DiT block's glue between its GEMMs goes through ``ops.fused``'s
    ``ln_modulate`` / ``bias_act`` / ``gated_residual``; on a CUDA tensor the
    kernels run in every forward and the backward differentiates the eager
    composition, on the CPU the eager composition runs."""

    def _net(self, **kw):
        _, tm = _pair(seed=11, **kw)
        return tm.velocity_net

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_sampling_forward_takes_a_kernel_at_every_site(self, monkeypatch, dtype):
        net = self._net()
        x, t = (torch.from_numpy(a) for a in _inputs(TINY, 2, seed=12))
        with torch.no_grad():
            want = net(x, t, dtype=dtype)
        entries, kernels = _record_glue(monkeypatch)
        with torch.no_grad():
            got = net(x, t, dtype=dtype)
        assert entries == kernels == _glue_sites(2)
        assert torch.equal(got, want)

    @pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
    def test_a_forward_under_autograd_takes_the_eager_composition(self, monkeypatch, remat):
        """Under autograd the kernels run in the forward (with ``remat``, in
        its rerun of the blocks too) and the gradients are the eager
        composition's: with the kernels stood in for by their plain
        versions, the output equals the CPU path's and every gradient is
        its own, its fp32 sums accumulated in another order."""
        net = self._net(remat=remat)
        x, t = (torch.from_numpy(a) for a in _inputs(TINY, 2, seed=13))
        want = net(x, t, masters=True)
        want.square().mean().backward()
        want_grads = [p.grad.clone() for p in net.parameters()]
        net.zero_grad()
        entries, kernels = _record_glue(monkeypatch)
        got = net(x, t, masters=True)
        got.square().mean().backward()
        recomputed = _glue_sites(2)[:-1] if remat else []  # the blocks again, not the head
        assert kernels == entries == _glue_sites(2) + recomputed
        assert torch.equal(got, want)
        for a, b in zip(want_grads, (p.grad for p in net.parameters())):  # summed in other orders
            torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-8)

    def test_grad_mode_with_no_input_requiring_grad_takes_the_kernels(self, monkeypatch):
        net = self._net()
        x, t = (torch.from_numpy(a) for a in _inputs(TINY, 2, seed=14))
        entries, kernels = _record_glue(monkeypatch)
        assert torch.is_grad_enabled()
        net(x, t)  # the cached, detached parameters of a sampling view
        assert kernels == _glue_sites(2)

    def test_a_tensor_parallel_view_takes_the_eager_composition(self, monkeypatch):
        """A block under a tensor-parallel view (a group of one, so that the
        shards are the whole weights) gives the block's output; its
        row-parallel proj and mlp2 take the eager composition (the bias
        added after the psum), its LayerNorms and column-parallel epilogues
        the kernels."""
        from rectified_flow_vision_tpu_torch.models.unet import _View
        from rectified_flow_vision_tpu_torch.parallel import collectives
        from rectified_flow_vision_tpu_torch.parallel.mesh import TensorParallel

        net = self._net()
        blk, hidden = net.blocks[0], net.cfg.hidden_size
        g = torch.Generator().manual_seed(15)
        tokens = torch.randn((2, 16, hidden), generator=g)
        c_emb = torch.randn((2, hidden), generator=g)
        with torch.no_grad():
            want = blk(tokens, c_emb, _View(net._params, torch.float32), net.cfg.num_heads)
        monkeypatch.setattr(collectives, "group_size", lambda group: 1)
        entries, kernels = _record_glue(monkeypatch)
        tp = _View(net._params, torch.float32, tp=TensorParallel(group=None, size=1, rank=0))
        with torch.no_grad():
            got = blk(tokens, c_emb, tp, net.cfg.num_heads)
        assert entries == kernels == ["ln_modulate", "bias_act"] * 2
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)

    def test_the_cpu_launches_no_kernel(self, monkeypatch):
        net = self._net()
        x, t = (torch.from_numpy(a) for a in _inputs(TINY, 2, seed=16))
        entries, kernels = _record_glue(monkeypatch, card=False)
        build.reset_launches()
        with torch.no_grad():
            net(x, t)
        assert entries == _glue_sites(2) and kernels == []
        assert sum(build.LAUNCHES.values()) == 0

    @pytest.mark.parametrize("name", GLUE)
    def test_a_width_the_kernels_do_not_take_stays_plain(self, monkeypatch, name):
        """C not a multiple of 8 stays plain on the CPU only: on a CUDA
        tensor the dispatch has no plain route, it calls the kernel's
        wrapper, which refuses the width (a card test)."""
        g = torch.Generator().manual_seed(17)
        x, y = torch.randn((2, 3, 12), generator=g), torch.randn((2, 3, 12), generator=g)
        row, b = torch.randn((2, 12), generator=g), torch.randn(12, generator=g)
        args = {"ln_modulate": (x, row, row), "bias_act": (y, b), "gated_residual": (x, y, b, row)}
        for card in (False, True):
            _, kernels = _record_glue(monkeypatch, card=card)
            with torch.no_grad():
                got = getattr(TF, name)(*args[name])
            assert kernels == ([name] if card else [])
            assert torch.equal(got, getattr(TF.DG, f"{name}_plain")(*args[name]))
            monkeypatch.undo()
        assert not TF.DG.supports(12) and TF.DG.supports(384)

    @pytest.mark.parametrize("name", GLUE)
    def test_launch_counter_and_c_entry_point(self, name):
        """Each kernel has its ``LAUNCHES`` key, its source in the build and a
        ctypes signature that matches the C entry point's parameters."""
        import re

        assert name in build.LAUNCHES
        assert "dit_glue.cu" in build.SOURCES
        src = (build.CSRC / "dit_glue.cu").read_text()
        m = re.search(r'extern "C" int rfv_' + name + r"\(([^)]*)\)", src)
        assert m, name
        kinds = {"void*": build._P, "long long": build._L, "int": build._I, "float": build._F}
        params = [" ".join(p.replace("const", "").split()[:-1]) for p in m.group(1).split(",")]
        assert [kinds[p] for p in params] == build._SIGNATURES[f"rfv_{name}"]

    def test_plain_versions_are_the_eager_composition(self):
        from rectified_flow_vision_tpu_torch.ops import primitives as P

        g = torch.Generator().manual_seed(18)
        x = torch.randn((2, 5, 16), generator=g).to(torch.bfloat16)
        y = torch.randn((2, 5, 16), generator=g).to(torch.bfloat16)
        shift, scale, gate = torch.randn((2, 48), generator=g).to(torch.bfloat16).chunk(3, -1)
        b = torch.randn(16, generator=g)
        assert torch.equal(TF.ln_modulate(x, shift, scale),
                           P.modulate(P.layer_norm(x), shift, scale))
        w = torch.randn((16, 16), generator=g).to(torch.bfloat16)
        h = torch.matmul(x, w.t())
        assert torch.equal(TF.bias_act(h, b), P.dense(x, w, b))
        assert torch.equal(TF.bias_act(h, b, "gelu_tanh"), P.gelu_tanh(P.dense(x, w, b)))
        assert torch.equal(TF.gated_residual(x, y, b, gate),
                           x + gate[:, None, :] * (y.float() + b).to(y.dtype))
        with pytest.raises(ValueError, match="activation"):
            TF.bias_act(h, b, "relu")

    @pytest.mark.parametrize("name", GLUE)
    def test_kernel_wrappers_refuse_a_cpu_tensor(self, name):
        x, row, b = torch.zeros((1, 2, 8)), torch.zeros((1, 8)), torch.zeros(8)
        args = {"ln_modulate": (x, row, row), "bias_act": (x, b), "gated_residual": (x, x, b, row)}
        with pytest.raises(ValueError, match="CUDA tensors"):
            getattr(TF.DG, f"{name}_cuda")(*args[name])


def _compare_params(got_tree, want_tree, atol, lr, steps, hidden):
    """Parameters after ``steps`` AdamW steps. Adam's update is
    lr * m / (sqrt(v) + eps): a gradient at the level of fp32 rounding noise is
    divided by its own magnitude, so two correct implementations can move such
    an element apart by up to lr per step. Held: every element within
    steps * lr, and all of each leaf within ``atol`` but one element in 10,000
    (two in a small leaf). The key third of every qkv bias has a gradient that
    is zero in exact arithmetic (softmax ignores a shift of the logits along
    the keys): all noise, held only to the first."""
    got, want = _leaves(got_tree), _leaves(want_tree)
    assert set(got) == set(want)
    for k in want:
        diff = np.abs(got[k] - want[k])
        assert diff.max() <= steps * lr * 1.001, k
        if k.endswith("['qkv']['b']"):
            diff = np.delete(diff, np.r_[hidden : 2 * hidden])
        assert np.sum(diff > atol) <= max(2, diff.size // 10000), (k, diff.max())


class TestTraining:
    def test_three_steps_with_ema_match_jax(self, monkeypatch):
        jm, tm = _pair(seed=11)
        lr, decay = 1e-4, 0.9
        batches = [(np.random.default_rng(10 + i).standard_normal((4, 8, 8, 4))
                    .astype(np.float32), _inputs(TINY, 4, seed=20 + i)[0]) for i in range(3)]
        keys = [jax.random.key(30 + i) for i in range(3)]
        times = iter([torch.from_numpy(np.asarray(
            jax.random.uniform(jax.random.split(k, 3)[1], (4,), jnp.float32))) for k in keys])
        monkeypatch.setattr(TBF, "sample_times", lambda *a: next(times))

        tx = JBF.make_optimizer(lr, 2, 2)
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
        _compare_params(tm.params, params, ATOL, lr, 3, 32)
        _compare_params(TBF.ema_params(tema, "dit"), ema, ATOL, lr, 3, 32)

    def test_train_base_flow_runs_and_writes_dit_checkpoints(self, tmp_path):
        from rectified_flow_vision_tpu_torch.models import train_base_flow

        tm = BaseFlowModel(device="cpu", **TINY)
        data = [np.random.RandomState(i).randn(8, 8, 8, 4).astype(np.float32) * 0.5
                for i in range(3)]
        losses = train_base_flow(tm, data, epochs=4, lr=3e-3, progress=False, ema_decay=0.9,
                                 save_path=str(tmp_path / "dit"), save_every=4)
        assert np.isfinite(losses).all() and losses[-1] < losses[0]
        ema = BaseFlowModel.from_checkpoint(str(tmp_path / "dit_ema_final.npz"), device="cpu")
        assert ema.backbone == "dit" and ema.velocity_net.cfg.hidden_size == 32


class TestCheckpoints:
    def test_jax_npz_loads_in_the_port(self, tmp_path):
        jm, _ = _pair(seed=12)
        jm.save(str(tmp_path / "jax_dit.npz"))
        tm = BaseFlowModel.from_checkpoint(str(tmp_path / "jax_dit.npz"), device="cpu")
        assert tm.backbone == "dit" and tm.config == {**jm.config}
        got, want = _leaves(tm.params), _leaves(jm.params)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        x, t = _inputs(TINY, 2)
        np.testing.assert_allclose(
            tm.forward(x, t, data_format="NHWC").numpy(),
            np.asarray(jm.forward(x, t, data_format="NHWC")), rtol=0, atol=1e-4)

    def test_port_npz_loads_in_jax(self, tmp_path):
        _, tm = _pair(seed=13)
        tm.save(str(tmp_path / "torch_dit.npz"))
        jm = JBase.from_checkpoint(str(tmp_path / "torch_dit.npz"))
        assert jm.backbone == "dit" and jm.velocity_net.cfg.depth == 2
        got, want = _leaves(jm.params), _leaves(tm.params)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        params, config = jckpt.load_params(str(tmp_path / "torch_dit.npz"))
        assert config["model_type"] == "BaseFlowModel" and params["pos_embed"].shape == (1, 16, 32)

    def test_state_dict_round_trip_is_strict(self):
        jm, tm = _pair(seed=14)
        tree = jax.tree_util.tree_map(np.asarray, jm.params)
        sd = TPT.tree_to_state_dict(tree, "velocity_net.")
        assert set(sd) == set(tm.state_dict())
        assert sd["velocity_net.pos_embed"].shape == (1, 16, 32)  # a bare parameter
        assert sd["velocity_net.blocks.1.qkv.weight"].shape == (96, 32)  # (out, in)
        assert sd["velocity_net.patch_embed.weight"].shape == (32, 4, 2, 2)  # OIHW
        back = _leaves(TPT.state_dict_to_tree(sd, "velocity_net."))
        for k, v in _leaves(tree).items():
            np.testing.assert_array_equal(back[k], v, err_msg=k)
        with pytest.raises(ValueError, match="shape mismatch"):
            BaseFlowModel(device="cpu", **{**TINY, "hidden_size": 64}).params = tree

    def test_reflow_student_from_a_dit_base(self, tmp_path):
        jm, tm = _pair(seed=15, remat=True)
        student = RectifiedFlowModel.from_base_model(tm)
        assert student.backbone == "dit" and student.velocity_net.cfg.hidden_size == 32
        assert student.velocity_net.cfg.remat and student.device == tm.device
        assert student.config == {**JRect.from_base_model(jm).config}
        copy = RectifiedFlowModel.from_base_model(tm, copy_weights=True)
        for a, b in zip(copy.parameters(), tm.parameters()):
            assert torch.equal(a, b)
        copy.reflow_iteration = 1
        copy.save(str(tmp_path / "student.npz"))
        back = BaseFlowModel.from_checkpoint(str(tmp_path / "student.npz"), device="cpu")
        assert isinstance(back, RectifiedFlowModel) and back.reflow_iteration == 1
        assert ckpt.load_params(str(tmp_path / "student.npz"))[1]["backbone"] == "dit"


class TestSamplingAndReflow:
    def test_sampler_pairs_and_straightness_match_jax(self):
        """Euler and heun sampling, reflow pairs from given noise and the
        straightness of a DiT model, fp32, atol 1e-4."""
        from rectified_flow_vision_tpu_torch.models import generate_reflow_pairs

        jm, tm = _pair(seed=16, cls=(JRect, RectifiedFlowModel))
        noise = np.random.default_rng(17).standard_normal((2, 8, 8, 4)).astype(np.float32)
        for method in ("euler", "heun"):
            want = np.asarray(jm.sample(noise, num_steps=3, data_format="NHWC", method=method))
            got = tm.sample(noise, num_steps=3, data_format="NHWC", method=method).numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        x1 = np.asarray(jm.sample(noise, num_steps=3, data_format="NHWC"))
        want = jm.compute_straightness(noise, x1, num_points=4, data_format="NHWC")
        got = tm.compute_straightness(noise, x1, num_points=4, data_format="NHWC")
        assert abs(got - float(want)) <= 1e-4
        x0, x1 = generate_reflow_pairs(tm, 3, batch_size=2, num_steps=2, data_format="NHWC")
        assert x0.shape == x1.shape == (3, 8, 8, 4) and np.isfinite(x1).all()
        np.testing.assert_allclose(
            x1, np.asarray(jm.sample(x0, num_steps=2, data_format="NHWC")), rtol=0, atol=1e-4)

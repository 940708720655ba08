"""The port's data, tensor and fully sharded parallel training, held against
the JAX package on the CPU.

Four gloo ranks are spawned on the CPU (``torch_parallel_workers.spawn``);
each takes its rows of a global batch of 8 and the tests hold the global
result against one single-device JAX step on that batch, as
``tests/test_parallel.py`` holds the JAX meshes. The model is that file's
``_tiny`` (8x8, 16 channels, mult (1, 2), 1 res-block) with dropout 0 where
JAX is the reference: the two packages' dropout bits cannot agree, so the
tensor-parallel mask contract is held against the port's own single-rank
step. Both packages are handed the same x0 and t (coupled step, ``t`` from
the JAX key), and x1 is scaled so that the gradient's norm is above 1 and the
clip acts on the sharded gradient.

Tolerances are the JAX tests': loss rel 1e-5; parameters rtol 5e-3, atol 1e-4
(``test_parallel.py:78-84``); the mesh device epoch's losses rtol 2e-3, atol
1e-4 (``:261``); the weights after its four AdamW steps by
``tests/test_torch_train.py``'s rule for Adam steps (``_assert_adam_params``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_parallel_workers as W
from rectified_flow_vision_tpu.models import BaseFlowModel as JBase
from rectified_flow_vision_tpu.models import RectifiedFlowModel as JRect
from rectified_flow_vision_tpu.models import base_flow as JBF
from rectified_flow_vision_tpu.models import rectified_flow as JRF
from rectified_flow_vision_tpu.ops import winograd as JW
from rectified_flow_vision_tpu.parallel import mesh as JM
from rectified_flow_vision_tpu_torch.models import BaseFlowModel, DiT
from rectified_flow_vision_tpu_torch.models import base_flow as TBF
from rectified_flow_vision_tpu_torch.parallel import mesh as M

TINY = dict(image_size=8, model_channels=16, channel_mult=[1, 2], num_res_blocks=1,
            dropout=0.0, sample_dtype="float32")
DIT = dict(image_size=8, in_channels=4, backbone="dit", patch_size=2, hidden_size=32, depth=2,
           num_heads=4, sample_dtype="float32")
LR = 1e-3
WINOGRAD = "RFV_CONV_WINOGRAD"
# conv2d_fused sites of TINY: conv1 and conv2 of its 6 res-blocks, 1 upsample
TINY_CONV_SITES = 13
CASES = {
    "dp4": dict(dp=4, tp=1, fsdp=False),
    "fsdp4": dict(dp=4, tp=1, fsdp=True),
    "dp2_tp2": dict(dp=2, tp=2, fsdp=False),
    "tp4": dict(dp=1, tp=4, fsdp=False),
    "fsdp2_tp2": dict(dp=2, tp=2, fsdp=True),
}


def _jax_times(rng, batch):
    """``t`` as the JAX ``loss_fn`` draws it (uniform) from ``rng``."""
    _, k_t, _ = jax.random.split(rng, 3)
    return np.array(jax.random.uniform(k_t, (batch,), jnp.float32))


def _copy(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


@pytest.fixture(scope="module")
def step_run(tmp_path_factory):
    jm = JBase(seed=3, **TINY)
    params = _copy(jm.params)
    r = np.random.default_rng(0)
    x0 = r.standard_normal((8, 8, 8, 3)).astype(np.float32)
    x1 = (3 * r.standard_normal((8, 8, 8, 3))).astype(np.float32)
    key = jax.random.key(7)
    t = _jax_times(key, 8)
    tx = JBF.make_optimizer(LR, 1, 1)
    jstep = JBF.make_train_step(jm, tx, coupled=True)
    start = jax.tree_util.tree_map(jnp.asarray, _copy(params))
    new, _, loss = jstep(start, tx.init(start), (jnp.asarray(x0), jnp.asarray(x1)), key)
    cases = {k: dict(v, cfg=TINY) for k, v in CASES.items()}
    cases["tp4_dropout"] = dict(dp=1, tp=4, fsdp=False, cfg={**TINY, "dropout": 0.1})
    # the same JAX step under the Winograd gate: freshly jitted (the JAX
    # package reads the variable when it traces), a spy counting its convs
    wcalls = []
    real = JW.conv2d_winograd
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(WINOGRAD, "1")
        mp.setattr(JW, "conv2d_winograd", lambda x, p: wcalls.append(x.shape) or real(x, p))
        wstep = JBF.make_train_step(jm, tx, coupled=True)
        wstart = jax.tree_util.tree_map(jnp.asarray, _copy(params))
        wnew, _, wloss = wstep(wstart, tx.init(wstart), (jnp.asarray(x0), jnp.asarray(x1)), key)
    cases["tp4_winograd"] = dict(dp=1, tp=4, fsdp=False, cfg=TINY, winograd=True)
    # the DiT: its heads and MLP columns over 2 ranks, data over 2
    jd = JBase(seed=4, **DIT)
    dparams = jax.tree_util.tree_map(
        lambda a: (r.standard_normal(a.shape) * 0.1).astype(np.float32), jd.params)
    d0, d1 = (r.standard_normal((8, 8, 8, 4)).astype(np.float32) for _ in range(2))
    dkey = jax.random.key(8)
    dt = _jax_times(dkey, 8)
    dstep = JBF.make_train_step(jd, tx, coupled=True)
    dstart = jax.tree_util.tree_map(jnp.asarray, _copy(dparams))
    dnew, _, dloss = dstep(dstart, tx.init(dstart), (jnp.asarray(d0), jnp.asarray(d1)), dkey)
    cases["dit_dp2_tp2"] = dict(dp=2, tp=2, fsdp=False, cfg=DIT, params=dparams, x0=d0, x1=d1,
                                t=dt)
    tmp = tmp_path_factory.mktemp("parallel_step")
    out = W.spawn(W.train_step_cases, 4, tmp, params=params, x0=x0, x1=x1, t=t, lr=LR,
                  cases=cases, save_dir=str(tmp))[0]
    return dict(jax_loss=float(loss), jax_params=W._leaves(_copy(new)), out=out, dir=tmp,
                params=params, x0=x0, x1=x1, t=t, dit_loss=float(dloss),
                dit_params=W._leaves(_copy(dnew)), wino_loss=float(wloss),
                wino_params=W._leaves(_copy(wnew)), wino_convs=len(wcalls))


def _assert_params(got, want, rtol=5e-3, atol=1e-4):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


def _assert_adam_params(got, want, steps, lr=1e-3, atol=1e-4):
    """Weights after ``steps`` AdamW steps, by ``tests/test_torch_train.py``'s
    rule: Adam divides a gradient at the level of rounding noise by its own
    magnitude, so every element lies within steps * lr, and all but one in
    10,000 (two in a small leaf) within ``atol``."""
    assert set(got) == set(want)
    for k in want:
        diff = np.abs(got[k] - want[k])
        assert diff.max() <= steps * lr * 1.001, k
        assert np.sum(diff > atol) <= max(2, diff.size // 10000), (k, diff.max())


def _single_step(run, cfg, monkeypatch):
    """The port's own single-process step on the global batch."""
    monkeypatch.setattr(TBF, "sample_times", lambda *a, **k: torch.from_numpy(run["t"]))
    model = BaseFlowModel(device="cpu", params=run["params"], **cfg)
    opt = TBF.make_optimizer(model, LR, 1, 1)
    step = TBF.make_train_step(model, opt, coupled=True)
    loss = step((torch.from_numpy(run["x0"]), torch.from_numpy(run["x1"])),
                torch.Generator().manual_seed(0))
    return float(loss), W._leaves(model.params), model


@pytest.fixture
def one_rank_group(tmp_path):
    """A process group of this process alone (gloo)."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_the_jax_step(step_run, case):
    """DP, FSDP, DP x TP, TP and FSDP x TP over 4 ranks: the global loss and
    the updated weights of one step on the global batch."""
    got = step_run["out"][case]
    assert got["loss"] == pytest.approx(step_run["jax_loss"], rel=1e-5)
    _assert_params(got["params"], step_run["jax_params"])


def test_dit_tensor_parallel_step_matches_the_jax_step(step_run):
    """The DiT's rows of the tensor-parallel rules (qkv / mlp1 column, proj /
    mlp2 row) over 2 ranks, data over 2, every leaf of the weights random."""
    got = step_run["out"]["dit_dp2_tp2"]
    assert got["loss"] == pytest.approx(step_run["dit_loss"], rel=1e-5)
    _assert_params(got["params"], step_run["dit_params"])
    assert got["stored"] < 0.8  # qkv, proj and the MLP halved; adaLN whole


def test_tensor_parallel_step_under_the_winograd_gate_matches_the_jax_step(step_run):
    """With ``RFV_CONV_WINOGRAD`` set, tensor parallelism over 4 ranks (each
    rank's quarter of a conv's output channels at a column site, of its
    input channels at a row site, the partial sums added over the group) against
    one JAX step under the same variable; every conv site on both sides took
    the Winograd conv."""
    got = step_run["out"]["tp4_winograd"]
    assert step_run["wino_convs"] == TINY_CONV_SITES
    assert got["winograd_calls"] == TINY_CONV_SITES
    assert got["loss"] == pytest.approx(step_run["wino_loss"], rel=1e-5)
    _assert_params(got["params"], step_run["wino_params"])


def test_the_clip_acts_on_the_global_gradient(step_run, monkeypatch):
    """The batch's gradient norm is above 1, so the sharded clip's norm (the
    whole gradient's, each replicated parameter counted once) decides the
    step, and a clip that summed the wrong squares would fail the cases."""
    monkeypatch.setattr(TBF, "sample_times", lambda *a: torch.from_numpy(step_run["t"]))
    model = BaseFlowModel(device="cpu", params=step_run["params"], **TINY)
    model.loss_fn(torch.from_numpy(step_run["x1"]), x0=torch.from_numpy(step_run["x0"])).backward()
    norm = float(torch.linalg.vector_norm(torch.stack([p.grad.norm() for p in model.parameters()])))
    assert norm > 2.0


def test_tensor_parallel_dropout_draws_the_unsharded_mask(step_run, monkeypatch):
    """At dropout 0.1 the 4 tensor-parallel ranks of one data shard drop what
    one process drops: each rank's mask bits are keyed by its channels' place
    in the whole activation."""
    loss, want, _ = _single_step(step_run, {**TINY, "dropout": 0.1}, monkeypatch)
    got = step_run["out"]["tp4_dropout"]
    assert got["loss"] == pytest.approx(loss, rel=1e-5)
    _assert_params(got["params"], want)
    assert got["loss"] != pytest.approx(step_run["jax_loss"], rel=1e-5)  # dropout acted


def test_fsdp_stores_a_share_of_the_weights(step_run):
    """Each rank keeps about 1/dp of the parameters under FSDP (the point is
    memory); tensor parallelism alone keeps part of them."""
    stored = {k: v["stored"] for k, v in step_run["out"].items()}
    assert stored["dp4"] == 1.0
    assert 0.25 <= stored["fsdp4"] < 0.26
    assert stored["fsdp2_tp2"] < stored["dp2_tp2"] / 1.9
    assert stored["tp4"] < 0.5


@pytest.mark.parametrize("case", ["fsdp2_tp2", "dp2_tp2"])
def test_rank0_checkpoint_loads_in_jax(step_run, case):
    """Rank 0 writes the whole weights: the JAX package's BaseFlowModel
    loads the ``.npz`` and holds the JAX step's weights."""
    jm = JBase.from_checkpoint(str(step_run["dir"] / f"{case}.npz"))
    _assert_params(W._leaves(_copy(jm.params)), step_run["jax_params"])


def test_mesh_device_epoch_matches_jax(tmp_path, monkeypatch):
    """``train_rectified_flow`` on the device-resident corpus under a DP mesh
    and an FSDP x TP mesh (every rank holds the corpus and the permutation,
    and takes its rows) against the JAX trainer's epochs on one device, with
    an EMA (kept on the shards, written whole by rank 0); the model holds
    the whole weights again when the trainer returns. Resume on the mesh
    (each rank's state of its shards) repeats the uninterrupted run."""
    cfg = dict(TINY)
    jm = JRect(seed=9, **cfg)
    params = _copy(jm.params)
    r = np.random.default_rng(8)
    x0 = r.standard_normal((16, 8, 8, 3)).astype(np.float32)
    x1 = r.standard_normal((16, 8, 8, 3)).astype(np.float32)
    seed, bs, epochs = 4, 8, 2
    times = [_jax_times(jax.random.fold_in(jax.random.fold_in(jax.random.key(seed), e), i), bs)
             for e in range(epochs) for i in range(2)]
    kw = dict(epochs=epochs, batch_size=bs, lr=1e-3, seed=seed, data_format="NHWC",
              progress=False, device_epoch=True, ema_decay=0.9)
    want = JRF.train_rectified_flow(jm, x0, x1, save_path=str(tmp_path / "jax"),
                                    **{**kw, "device_epoch": False})
    jema = W._leaves(_copy(JRect.from_checkpoint(str(tmp_path / "jax_ema_final.npz")).params))
    out = W.spawn(W.reflow_epoch_cases, 4, tmp_path, cfg=cfg, params=params, x0=x0, x1=x1,
                  times=times, kw=kw, cases={"dp4": (4, 1, False), "fsdp2_tp2": (2, 2, True)},
                  save_dir=str(tmp_path))
    jparams = W._leaves(_copy(jm.params))
    for name in ("dp4", "fsdp2_tp2"):
        np.testing.assert_allclose(out[0][name]["losses"], want, rtol=2e-3, atol=1e-4)
        assert not out[3][name]["tp"]
        _assert_adam_params(out[3][name]["params"], jparams, steps=4)
        saved = JRect.from_checkpoint(str(tmp_path / f"{name}_final.npz"))
        _assert_adam_params(W._leaves(_copy(saved.params)), jparams, steps=4)
        ema = JRect.from_checkpoint(str(tmp_path / f"{name}_ema_final.npz"))
        _assert_adam_params(W._leaves(_copy(ema.params)), jema, steps=4)
        # resumed from each rank's state of the epoch before: the same run
        for rank in out:
            (first, w1), (resumed, w2) = rank[name + "_resume"]
            assert resumed == first
            for k in w1:
                np.testing.assert_array_equal(w2[k], w1[k], err_msg=k)


def test_create_mesh_errors(one_rank_group):
    mesh = M.create_mesh(device="cpu")
    assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.mesh.shape) == (1, 1)
    with pytest.raises(ValueError, match="must divide"):
        M.create_mesh(model_axis=3, device="cpu")
    with pytest.raises(ValueError, match="does not cover"):
        M.create_mesh(data_axis=2, device="cpu")
    with pytest.raises(ValueError, match="must divide"):
        M.create_mesh(model_axis=0, device="cpu")


def test_create_mesh_needs_a_process_group():
    if dist.is_initialized():
        pytest.skip("a process group exists in this process")
    with pytest.raises(RuntimeError, match="process group"):
        M.create_mesh(device="cpu")
    assert M.maybe_init_distributed() is False  # not under torchrun


def test_fsdp_spec_rules():
    """``tests/test_parallel.py::test_fsdp_spec_rules`` with tuples."""
    for args in [((16, 64), 8, None), ((16, 64), 8, (None, "model")), ((3, 5), 8, None),
                 ((), 8, None)]:
        want = JM.fsdp_spec(*args[:2], None if args[2] is None else JM.P(*args[2]))
        assert M.fsdp_spec(*args) == tuple(want) + (None,) * (len(args[0]) - len(want))


def test_tensor_parallel_rules_cover_the_jax_rules():
    """Each parameter the JAX rules split over ``model`` is split by the
    port's rules, on the dim of the same meaning (out channels -> torch dim
    0, in channels -> dim 1), and no other: UNet and DiT."""
    unet = BaseFlowModel(device="cpu", **TINY)
    dit = DiT(input_size=8, hidden_size=32, depth=2, num_heads=4)
    from rectified_flow_vision_tpu.models.dit import DiT as JDiT
    from rectified_flow_vision_tpu.utils.checkpoint import flatten_tree

    trees = [(JBase(seed=0, **TINY).params, unet.velocity_net),
             (JDiT(input_size=8, hidden_size=32, depth=2, num_heads=4).init(jax.random.key(0)),
              dit)]
    for jtree, net in trees:
        jax_split = {}
        for path, arr in flatten_tree(jtree).items():
            spec = tuple(JM.unet_param_spec(path, arr.ndim))
            if "model" in spec:
                # JAX kernels are HWIO / (in, out): the last dim is "out"
                jax_split[path] = "out" if spec.index("model") == arr.ndim - 1 else "in"
        port_split = {}
        for name, p in net.named_parameters():
            spec = M.unet_param_spec(name, p.ndim)
            if "model" in spec:
                port_split[name] = "out" if spec.index("model") == 0 else "in"
        assert sorted(jax_split.values()) == sorted(port_split.values())
        assert len(port_split) == len(jax_split) > 0
    assert M.unet_param_spec("velocity_net.mid_attn.qkv.weight", 4) == ("model", None, None, None)
    assert M.unet_param_spec("velocity_net.mid_attn.proj.weight", 4) == (None, "model", None, None)
    assert M.unet_param_spec("velocity_net.enc_blocks.0.norm1.weight", 1) == (None,)
    assert M.unet_param_spec("velocity_net.enc_blocks.0.conv2.bias", 1) == (None,)


def test_one_rank_mesh_step_equals_no_mesh(step_run, one_rank_group, monkeypatch):
    """An explicit one-device mesh runs the collectives and changes nothing
    (the world-size-1 path of the card's smoke test)."""
    cfg = {**TINY, "dropout": 0.1}
    loss, want, _ = _single_step(step_run, cfg, monkeypatch)
    mesh = M.create_mesh(device="cpu")
    model = BaseFlowModel(device="cpu", params=step_run["params"], **cfg)
    M.place_params(mesh, model, fsdp=True)
    opt = TBF.make_optimizer(model, LR, 1, 1, mesh=mesh)
    step = TBF.make_train_step(model, opt, coupled=True, mesh=mesh)
    got = float(step((torch.from_numpy(step_run["x0"]), torch.from_numpy(step_run["x1"])),
                     torch.Generator().manual_seed(0)))
    assert got == pytest.approx(loss, rel=1e-6)
    _assert_params(W._leaves(model.params), want, rtol=1e-5, atol=1e-6)


def test_unshard_gives_back_a_plain_network(step_run, one_rank_group):
    """After FSDP, ``unshard`` puts the whole weights back in a plain
    network, which samples what the model sampled before it was placed."""
    model = BaseFlowModel(device="cpu", params=step_run["params"], **TINY)
    noise = torch.from_numpy(step_run["x0"][:2])
    before = model.sample(noise, num_steps=2, data_format="NHWC")
    M.place_params(M.create_mesh(device="cpu"), model, fsdp=True)
    assert M.is_parallel(model) and M.is_dtensor(next(model.parameters()))
    M.unshard(model)
    assert not M.is_parallel(model) and not M.is_dtensor(next(model.parameters()))
    after = model.sample(noise, num_steps=2, data_format="NHWC")
    np.testing.assert_array_equal(after.numpy(), before.numpy())

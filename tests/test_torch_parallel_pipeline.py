"""The GPipe pipeline, held against the JAX package on the CPU.

Four gloo ranks are the four stages of ``tests/test_pipeline_parallel.py``'s
``stage`` mesh, over its perturbed depth-4 DiT (every weight moved off the
adaLN-Zero init, which would hide a wrong block). ``DiT.pipeline_apply`` for
2, 4 and 8 microbatches against the JAX ``pipeline_apply`` on a 4-device
``stage`` mesh, and the gradients of the pipeline train step's loss against
``jax.grad`` of the JAX ``make_pipeline_train_step``'s, both at that file's
2e-4; the split / merge round trip exactly; AdamW steps lower the loss.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_parallel_workers as W
from rectified_flow_vision_tpu.models.dit import DiT as JDiT
from rectified_flow_vision_tpu.parallel import pipeline as JPP
from rectified_flow_vision_tpu_torch.models import DiT
from rectified_flow_vision_tpu_torch.parallel import pipeline as PP
from rectified_flow_vision_tpu_torch.utils import pt_import as TPT

CFG = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=32, depth=4, num_heads=4)
MICRO = (2, 4, 8)
TOL = 2e-4


@pytest.fixture(scope="module")
def stage_mesh(eight_devices):
    return Mesh(np.asarray(eight_devices[:4]).reshape(4), ("stage",))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    jdit = JDiT(**CFG)
    params = jdit.init(jax.random.key(0))
    # perturb so blocks are non-identity (adaLN-zero init would hide bugs)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * jax.random.normal(jax.random.key(7), a.shape, a.dtype), params)
    params = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), params)
    r = np.random.default_rng(1)
    x = r.standard_normal((8, 8, 8, 4)).astype(np.float32)
    tx = np.linspace(0.1, 0.9, 8).astype(np.float32)
    x1, x0 = (r.standard_normal((8, 8, 8, 4)).astype(np.float32) for _ in range(2))
    t = r.random(8).astype(np.float32)
    out = W.spawn(W.pipeline_cases, 4, tmp_path_factory.mktemp("pipe"), cfg=CFG,
                  state=TPT.tree_to_state_dict(params), x=x, tx=tx, x1=x1, x0=x0, t=t,
                  microbatches=MICRO, lr=1e-3, steps=8)
    return dict(out=out, jdit=jdit, params=params, x=x, tx=tx, x1=x1, x0=x0, t=t)


@pytest.mark.parametrize("m", MICRO)
def test_pipeline_forward_matches_jax(run, stage_mesh, m):
    want = np.asarray(jax.jit(lambda p, x, t: run["jdit"].pipeline_apply(
        p, x, t, stage_mesh, num_microbatches=m))(run["params"], run["x"], run["tx"]))
    for rank in run["out"]:  # every stage returns the whole output
        np.testing.assert_allclose(rank["fwd"][m], want, rtol=TOL, atol=TOL)


def test_pipeline_gradients_match_jax(run, stage_mesh):
    """Every stage's gradients of the rest (the same on each) and of its own
    blocks, against the JAX pipeline loss's, merged to the DiT tree."""
    import optax

    _, loss_fn = JPP.make_pipeline_train_step(run["jdit"], optax.sgd(1e-3), stage_mesh)
    rest, blocks = JPP.split_pipeline_params(run["params"], stage_mesh)
    args = (jnp.asarray(run[k]) for k in ("x1", "x0", "t"))
    loss, (g_rest, g_blocks) = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1)))(
        rest, blocks, *args)
    want = TPT.tree_to_state_dict(jax.tree_util.tree_map(
        np.asarray, JPP.merge_pipeline_params(g_rest, g_blocks)))
    got = {}
    for rank in run["out"]:
        assert abs(rank["loss"] - float(loss)) <= TOL
        for key, g in rank["grads"].items():
            kind, name = key.split(".", 1)
            if kind == "rest":
                np.testing.assert_allclose(g, want[name], rtol=TOL, atol=TOL, err_msg=name)
                got[name] = g
            else:
                per = g.shape[1]
                for j in range(per):
                    got[f"blocks.{rank['stage'] * per + j}.{name}"] = g[0, j]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL, err_msg=k)


def test_split_merge_round_trip_and_training(run):
    """Merging the split weights gives the DiT's back exactly; eight AdamW
    steps through the pipeline lower the loss, and the merged weights drive
    the plain forward."""
    want = TPT.tree_to_state_dict(run["params"])
    for rank in run["out"]:
        assert set(rank["roundtrip"]) == set(want)
        for k in want:
            np.testing.assert_array_equal(rank["roundtrip"][k], want[k])
        losses = rank["losses"]
        assert np.isfinite(losses).all() and losses[-1] < losses[0]
        assert np.isfinite(rank["served"]).all()
    np.testing.assert_array_equal(run["out"][0]["served"], run["out"][3]["served"])


def test_stacking_shapes_and_indivisible_depth():
    dit = DiT(**CFG)
    stacked = PP.stack_block_params(dit.blocks, 2)
    assert stacked["qkv.weight"].shape == (2, 2, 96, 32)  # [S, L/S, ...]
    with pytest.raises(ValueError, match="not divisible"):
        PP.stack_block_params(dit.blocks, 3)
    with torch.no_grad():
        np.testing.assert_array_equal(stacked["mlp1.bias"][1, 0].numpy(),
                                      dit.blocks[2].mlp1.bias.numpy())

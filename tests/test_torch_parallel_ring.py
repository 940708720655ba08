"""Ring attention and the sequence-parallel DiT, held against the JAX package
on the CPU.

Four gloo ranks hold a quarter of the tokens each. ``ring_attention_sharded``
is held against the JAX function on a 4-device ``seq`` mesh (forward, and the
gradients of a fixed cotangent through ``jax.vjp``) at
``tests/test_ring_attention.py``'s tolerances: 2e-5, and 1e-4 with logits
scaled by 30 (that test holds the forward there; the gradients, which those
logits of magnitude ~900 scale up, are held at 1e-3 relative). The
sequence-parallel ``DiT.forward`` (every leaf of the parameters random, as in
``tests/test_torch_dit.py``) against the unsharded ``DiT.apply`` and
``jax.grad`` of the flow loss, at that file's tolerances: forward 1e-4, loss
and gradients 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as PS

import torch_parallel_workers as W
from rectified_flow_vision_tpu.models.dit import DiT as JDiT
from rectified_flow_vision_tpu.parallel.ring_attention import ring_attention_sharded
from rectified_flow_vision_tpu_torch.utils import pt_import as TPT

DIT = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=32, depth=2, num_heads=4)
# name: (shape, logit scale, forward tolerance, gradient rtol)
RING = {"64x4x16": ((2, 64, 4, 16), 1.0, 2e-5, 2e-5), "128x2x32": ((2, 128, 2, 32), 1.0, 2e-5, 2e-5),
        "extreme": ((1, 64, 2, 16), 30.0, 1e-4, 1e-3)}


@pytest.fixture(scope="module")
def seq_mesh(eight_devices):
    return Mesh(np.asarray(eight_devices[:4]).reshape(1, 4), ("data", "seq"))


@pytest.fixture(scope="module")
def run(seq_mesh, tmp_path_factory):
    r = np.random.default_rng(0)
    ring = {}
    for name, (shape, scale, _, _) in RING.items():
        q, k = (r.standard_normal(shape).astype(np.float32) * scale for _ in range(2))
        v, g = (r.standard_normal(shape).astype(np.float32) for _ in range(2))
        ring[name] = (q, k, v, g)
    jdit = JDiT(**DIT)
    params = jax.tree_util.tree_map(
        lambda a: (r.standard_normal(a.shape) * 0.1).astype(np.float32),
        jdit.init(jax.random.key(0)))
    dit = dict(cfg=DIT, state=TPT.tree_to_state_dict(params),
               x1=r.standard_normal((2, 8, 8, 4)).astype(np.float32),
               x0=r.standard_normal((2, 8, 8, 4)).astype(np.float32),
               t=r.random(2).astype(np.float32))
    out = W.spawn(W.seq_cases, 4, tmp_path_factory.mktemp("seq"), ring=ring, dit=dit)[0]
    return dict(out=out, ring=ring, dit=dit, jdit=jdit, params=params)


@pytest.mark.parametrize("name", list(RING))
def test_ring_attention_matches_jax(run, seq_mesh, name):
    q, k, v, g = run["ring"][name]
    _, _, tol, gtol = RING[name]
    spec = NamedSharding(seq_mesh, PS(None, "seq", None, None))
    want, grads = _jax_ring(seq_mesh)(*(jax.device_put(jnp.asarray(a), spec) for a in (q, k, v)),
                                      jnp.asarray(g))
    got = run["out"][name]
    assert np.isfinite(got["out"]).all()
    np.testing.assert_allclose(got["out"], np.asarray(want), rtol=tol, atol=tol)
    for a, b in zip(got["grads"], grads):
        np.testing.assert_allclose(a, np.asarray(b), rtol=gtol, atol=tol)


_JAX_RING = {}


def _jax_ring(mesh):
    """JAX's ring attention and its vjp, jitted once per mesh (and shape)."""
    if "fn" not in _JAX_RING:
        def fn(q, k, v, g):
            out, vjp = jax.vjp(lambda a, b, c: ring_attention_sharded(a, b, c, mesh), q, k, v)
            return out, vjp(g)

        _JAX_RING["fn"] = jax.jit(fn)
    return _JAX_RING["fn"]


def test_sequence_parallel_dit_matches_jax(run):
    """The whole velocity on every rank, the loss and every gradient (the
    masters' gradients summed over the ranks' tokens), against one device."""
    d = run["dit"]
    x1, x0, t = (jnp.asarray(d[k]) for k in ("x1", "x0", "t"))
    jdit = run["jdit"]

    def loss(p):
        tb = t[:, None, None, None]
        pred = jdit.apply(p, (1 - tb) * x0 + tb * x1, t)
        return jnp.mean(jnp.square(pred - (x1 - x0))), pred

    (want_loss, want_pred), grads = jax.value_and_grad(loss, has_aux=True)(run["params"])
    got = run["out"]["dit"]
    np.testing.assert_allclose(got["pred"], np.asarray(want_pred), rtol=0, atol=1e-4)
    assert abs(got["loss"] - float(want_loss)) <= 1e-5
    want = TPT.tree_to_state_dict(jax.tree_util.tree_map(np.asarray, grads))
    assert set(got["grads"]) == set(want)
    for k in want:
        np.testing.assert_allclose(got["grads"][k], want[k], rtol=0, atol=1e-5, err_msg=k)

"""Mesh serving, Reflow pairs under a mesh, the experiments' mesh and the
dry run over four gloo ranks, held against the JAX package and the port's
one-process path on the CPU.

``SamplerService(mesh=)`` over a data mesh of 4 and over 2 x 2 (data x
tensor parallel) returns the whole batch on every rank: the JAX sampler's
images from the same noise at ``tests/test_parallel.py:96``'s 1e-5, and the
port's one-process service's. ``generate_reflow_pairs`` under the mesh gives
the one-process pairs (1e-5: the same heun steps on each rank's rows).
"""

import jax
import numpy as np
import pytest
import torch

import torch_parallel_workers as W
from rectified_flow_vision_tpu.models import BaseFlowModel as JBase
from rectified_flow_vision_tpu_torch.models import BaseFlowModel, generate_reflow_pairs
from rectified_flow_vision_tpu_torch.serving import SamplerService

TINY = dict(image_size=8, model_channels=16, channel_mult=[1, 2], num_res_blocks=1,
            dropout=0.0, sample_dtype="float32")
BATCH, N, STEPS, SEED = 8, 11, 3, 5
MESHES = {"dp4": (4, 1), "dp2_tp2": (2, 2)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    jm = JBase(seed=1, **TINY)
    params = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jm.params)
    out = W.spawn(W.serving_cases, 4, tmp_path_factory.mktemp("serve"), cfg=TINY,
                  params=params, batch=BATCH, n=N, steps=STEPS, seed=SEED, meshes=MESHES)
    return dict(out=out, jm=jm, params=params)


def _service_noise(batches):
    gen = torch.Generator().manual_seed(SEED)
    return np.concatenate([torch.randn((BATCH, 8, 8, 3), generator=gen).numpy()
                           for _ in range(batches)])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_service_matches_jax_and_one_process(run, mesh):
    noise = _service_noise(2)[:N]
    want = np.clip(np.asarray(run["jm"].sample(noise=noise, num_steps=STEPS,
                                               data_format="NHWC")), -1.0, 1.0)
    one = SamplerService(BaseFlowModel(device="cpu", params=run["params"], **TINY),
                         step_counts=(STEPS,), batch_size=BATCH, seed=SEED, warmup=False)
    alone = one.generate(N, num_steps=STEPS, data_format="NHWC")
    for rank in run["out"]:  # the whole batch on every rank
        assert rank[mesh].shape == (N, 8, 8, 3)
        np.testing.assert_allclose(rank[mesh], want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(rank[mesh], alone, rtol=1e-5, atol=1e-5)


def test_reflow_pairs_under_a_mesh(run):
    teacher = BaseFlowModel(device="cpu", params=run["params"], **TINY)
    x0, x1 = generate_reflow_pairs(teacher, 6, batch_size=4, num_steps=2, seed=3, method="heun")
    for rank in run["out"]:
        np.testing.assert_array_equal(rank["pairs"][0], x0)
        np.testing.assert_allclose(rank["pairs"][1], x1, rtol=1e-5, atol=1e-5)


def test_experiments_mesh_and_dry_run(run):
    """``default_mesh`` lays ``parallel.model_axis = 2`` over the 4 ranks as
    2 x 2, and every path of the dry run ran to its end on every rank."""
    assert all(rank["default_mesh"] == (2, 2) for rank in run["out"])

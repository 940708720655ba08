"""Whole runs of each cell at a tiny size on the CPU, past the harness's look
for a card: sound, they are correct; with the timed path broken underneath,
``correct`` comes out false. The faults are those each kind of cell can
have on one card: a step that returns its state unchanged, an answer altered
where it is produced, and (training) half of the batch left out with the
mean taken over the rest."""

import time

import pytest
import torch

from conftest import SERVE, TRAIN, tiny
from rfbench import run

CPU = torch.device("cpu")


def _run(cell):
    return run.run_cell(tiny(cell), 2**32 + 11, 1.0, False, CPU, time.perf_counter())


@pytest.mark.parametrize("cell", SERVE + TRAIN)
def test_a_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"


def _zero_velocity(monkeypatch):
    from rectified_flow_vision_tpu_torch.models.unet import UNet
    from rectified_flow_vision_tpu_torch.models.dit import DiT

    for net in (UNet, DiT):
        forward = net.forward
        monkeypatch.setattr(net, "forward", lambda self, *a, _f=forward, **k: 0 * _f(self, *a, **k))


def _altered_answer(monkeypatch):
    from rectified_flow_vision_tpu_torch.serving import SamplerService

    produce = SamplerService._run
    monkeypatch.setattr(SamplerService, "_run", lambda self, s, noise: produce(self, s, noise) + 0.1)


@pytest.mark.parametrize("cell", SERVE)
@pytest.mark.parametrize("fault", [_zero_velocity, _altered_answer])
def test_a_broken_serving_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    res = _run(cell)
    assert not res["correct"], res["checks"]


def _state_unchanged(monkeypatch):
    from rectified_flow_vision_tpu_torch.models.base_flow import FlowOptimizer

    def step(self):
        self.step_count += 1

    monkeypatch.setattr(FlowOptimizer, "step", step)


def _half_batch(monkeypatch):
    from rectified_flow_vision_tpu_torch.models.base_flow import BaseFlowModel

    loss_fn = BaseFlowModel.loss_fn
    monkeypatch.setattr(BaseFlowModel, "loss_fn",
                        lambda self, x1, *a, **k: loss_fn(self, x1[: len(x1) // 2], *a, **k))


@pytest.mark.parametrize("cell", TRAIN)
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch])
def test_a_broken_train_step_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    res = _run(cell)
    assert not res["correct"], res["checks"]

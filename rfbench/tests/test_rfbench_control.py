"""The control: the reference computed in emulated fp8 (one step below the
bf16 the configurations state), put in the program's place, must come out
as not correct through the harness's own comparison (``run.run_cell``),
where the program comes out correct. Serving: each batch the service makes
is the fp8 reference's images from that batch's noise. Training: what
set-up read of the program's first steps (losses, first gradient,
parameters, EMA) is the fp8 reference's over the same steps. On the CPU at
a tiny size; marked ``cuda``, at the cell's own size on the card (the limits
come from ``calibrate.py`` over many seeds)."""

import time

import pytest

from conftest import CELLS, tiny
from rfbench import core, run

CPU = "cpu"


def _fp8_in_place(cell, seed, monkeypatch):
    from rectified_flow_vision_tpu_torch.serving import SamplerService

    from rfbench import weights
    from rfbench.kinds import train_epochs
    from rfbench.reference import flow
    from rfbench.reference.numerics import Numerics, exact_fp32

    if cell.traffic["kind"] == "train_epochs":
        setup = train_epochs.Run.setup

        def fp8_setup(self):
            setup(self)
            self.prog = self.reference(Numerics(fp8=True))

        monkeypatch.setattr(train_epochs.Run, "setup", fp8_setup)
        return
    mods = {}

    def fp8_run(self, sampler, noise):
        if not mods:
            mods.update(flow.build(cell.config, weights.make(cell.config, seed, noise.device),
                                   noise.device))
        with exact_fp32():
            return flow.serve(mods, noise, cell.traffic["num_steps"], Numerics(fp8=True),
                              cell.traffic["check_block"])

    monkeypatch.setattr(SamplerService, "_run", fp8_run)


def _run(cell, seed, seconds, device):
    import torch

    return run.run_cell(cell, seed, seconds, False, torch.device(device), time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_at_a_tiny_size(cell, monkeypatch):
    seed = 2**33 + 21
    assert _run(tiny(cell), seed, 1.0, CPU)["correct"]
    _fp8_in_place(tiny(cell), seed, monkeypatch)
    res = _run(tiny(cell), seed, 1.0, CPU)
    assert not res["correct"], res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_on_the_card(cell, card, monkeypatch):
    seed = 2**31 + 77
    _fp8_in_place(core.cell(cell), seed, monkeypatch)
    res = _run(core.cell(cell), seed, 3.0, card.type)
    assert not res["correct"], res["checks"]

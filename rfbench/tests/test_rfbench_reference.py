"""The plain reference against the port's CPU path at tiny widths, in float32.

The port is the system under test; here it only vouches that the reference
computes the same functions. Its CPU path runs the kernels' plain versions.
"""

import numpy as np
import pytest
import torch

from conftest import SERVE, TRAIN, tiny
from rfbench import weights
from rfbench.kinds import train_epochs
from rfbench.reference import flow, philox
from rfbench.reference.numerics import Numerics

CPU = torch.device("cpu")


def _program(cfg, w, dtype="float32"):
    from rectified_flow_vision_tpu_torch.models import BaseFlowModel, ConvVAE

    model = BaseFlowModel(**cfg["model"], compute_dtype=dtype, device=CPU)
    model.velocity_net.load_state_dict(w["velocity_net"])
    vae = None
    if cfg.get("vae"):
        vae = ConvVAE(**cfg["vae"], device=CPU)
        vae.load_state_dict(w["vae"])
    return model, vae


@pytest.mark.parametrize("cell", SERVE)
def test_velocity_and_decode_match_the_port(cell):
    cfg = tiny(cell).config
    w = weights.make(cfg, 3, CPU)
    model, vae = _program(cfg, w)
    mods = flow.build(cfg, w, CPU)
    m = cfg["model"]
    g = torch.Generator().manual_seed(0)
    x = torch.randn((3, m["image_size"], m["image_size"], m["in_channels"]), generator=g)
    t = torch.tensor([0.1, 0.5, 0.9])
    with torch.no_grad():
        got = model.velocity_net(x, t, dtype=torch.float32)
        ref = mods["velocity_net"].velocity(x, t, Numerics())
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
        assert ref.abs().mean() > 0.05  # no branch of the random network is zero
        if vae is not None:
            torch.testing.assert_close(vae.decode(x), mods["vae"].decode(x, Numerics()),
                                       rtol=1e-4, atol=1e-4)


def test_dropout_mask_is_the_programs():
    from rectified_flow_vision_tpu_torch.ops import gn_silu_dropout as D

    shape = (3, 4, 4, 24)
    for seed in (0, 7, 2**31 - 2, -5):
        s = torch.tensor([seed], dtype=torch.int32)
        keep = D.keep_mask(shape, s, 0.1, CPU)
        got = philox.dropout_factor(shape, s[0], 0.1)
        assert torch.equal(got > 0, keep)
        assert torch.all(got[keep] == np.float32(1 / 0.9))
        tail = philox.dropout_factor((2,) + shape[1:], s[0], 0.1, image0=1)
        assert torch.equal(tail, got[1:])


def test_unet_train_forward_with_dropout_matches_the_port():
    cfg = tiny(next(c for c in TRAIN if c.startswith("unet64"))).config
    w = weights.make(cfg, 4, CPU)
    model, _ = _program(cfg, w)
    ref_net = flow.build(cfg, w, CPU)["velocity_net"]
    x = torch.randn((2, 16, 16, 3), generator=torch.Generator().manual_seed(1))
    t = torch.tensor([0.3, 0.7])
    seeds = torch.arange(11, 11 + ref_net.num_dropout_seeds, dtype=torch.int32)
    with torch.no_grad():
        got = model.velocity_net(x, t, dtype=torch.float32, train=True, seeds=seeds, masters=True)
        ref = ref_net.velocity(x, t, Numerics(), seeds)
        assert not torch.allclose(ref, ref_net.velocity(x, t, Numerics()))
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cell", TRAIN)
def test_train_steps_match_the_port(cell):
    from rectified_flow_vision_tpu_torch.models.base_flow import (
        init_ema, make_optimizer, make_train_epoch)

    c = tiny(cell)
    tr = c.traffic
    w = weights.make(c.config, 5, CPU)
    model, _ = _program(c.config, w)
    opt = make_optimizer(model, tr["lr"], tr["epochs"], tr["corpus_batches"])
    ema = init_ema(model)
    epoch = make_train_epoch(model, opt, coupled=False, ema=ema, ema_decay=tr["ema_decay"])
    x1 = train_epochs.corpus(c.config, tr, 5, CPU)
    rows = torch.arange(3 * tr["batch"]).view(3, tr["batch"])
    losses = epoch(x1, rows, torch.Generator().manual_seed(8)).tolist()
    mods = flow.build(c.config, w, CPU)
    run = train_epochs.Run(c, 5, CPU)
    res = flow.train(mods, x1, list(rows), torch.Generator().manual_seed(8), run.opt_params(),
                     Numerics(), block=3)
    assert losses == pytest.approx(res["losses"], rel=1e-4)
    for k, p in model.velocity_net.named_parameters():
        torch.testing.assert_close(p.detach(), res["params"][k], rtol=1e-4, atol=2e-5)
        torch.testing.assert_close(ema["velocity_net." + k], res["ema"][k], rtol=1e-4, atol=2e-5)

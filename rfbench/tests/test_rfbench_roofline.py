"""FLOP and byte counts at known shapes."""

import pytest

from rfbench import core, roofline
from rfbench.reference import dit, unet


def test_conv3x3_least_time_at_a_flagship_shape():
    # (256, 64, 64, 64) -> 64: 2 * 256 * 64 * 64 * 9 * 64 * 64 FLOPs = 77.3 GFLOP
    flops = 2.0 * 256 * 64 * 64 * 9 * 64 * 64
    nbytes = 2 * (256 * 64 * 64 * 128 + 9 * 64 * 64) + 4 * 64
    assert roofline.conv3x3_least([(256, 64, 64, 64, 64)]) == pytest.approx(
        max(flops / 989e12, nbytes / 3.35e12))
    # the two bounds all but meet there: 78.2 us of operations, 80.2 us of bytes
    assert roofline.conv3x3_least([(256, 64, 64, 64, 64)]) == pytest.approx(80.15e-6, rel=1e-3)


def test_groupnorm_and_flash_least_times():
    # gn_silu at (256, 64, 64, 64): 2 x 128 MiB of bf16 at 3.35 TB/s
    n = 256 * 64 * 64 * 64
    assert roofline.gn_silu_least([(256, 64, 64, 64)]) == pytest.approx(
        (4 * n + 4 * (2 * 64 + 2 * 256 * 8)) / 3.35e12)
    assert roofline.gn_silu_backward_least([(256, 64, 64, 64)]) == pytest.approx(
        (6 * n + 4 * (4 * 64 + 2 * 256 * 8)) / 3.35e12)
    # DiT-S/2 attention at batch 64: 4 * 64 * 6 * 1024^2 * 64 FLOPs forward
    fwd = 4.0 * 64 * 6 * 1024 * 1024 * 64
    assert roofline.flash_forward_least([(64, 1024, 6, 64)]) == pytest.approx(fwd / 989e12)
    assert roofline.flash_backward_least([(64, 1024, 6, 64)]) == pytest.approx(2.5 * fwd / 989e12)


def test_kernel_sites_of_the_flagship():
    cfg = core.read_json(core.PACKAGE / "configs" / "unet64.json")["model"]
    sites = unet.kernel_sites(cfg, 256)
    assert len(sites["conv3x3"]) == 30 and len(sites["gn_silu"]) == 29
    assert sites["conv3x3"].count((256, 64, 64, 64, 64)) == 7
    assert sites["conv3x3"].count((256, 16, 16, 256, 256)) == 10
    assert (256, 64, 64, 192, 64) in sites["conv3x3"]
    d = core.read_json(core.PACKAGE / "configs" / "dit-s2-latent.json")["model"]
    assert dit.flash_calls(d, 64) == [(64, 1024, 6, 64)] * 12


def test_model_flops_of_the_configurations():
    unet_cfg = core.read_json(core.PACKAGE / "configs" / "unet64.json")
    dit_cfg = core.read_json(core.PACKAGE / "configs" / "dit-s2-latent.json")
    u, d = roofline.model_flops(unet_cfg), roofline.model_flops(dit_cfg)
    assert u["velocity"] == pytest.approx(12.764e9, rel=1e-3) and u["decode"] == 0.0
    # DiT-S/2 at 1024 tokens: 12 blocks of 2 * 1024 * (12 * 384^2) + attention 4 * 1024^2 * 384
    block = 2 * 1024 * 12 * 384 * 384 + 4 * 1024 * 1024 * 384
    assert d["velocity"] == pytest.approx(12 * block, rel=0.02)
    assert d["decode"] == pytest.approx(19.63e9, rel=1e-3)

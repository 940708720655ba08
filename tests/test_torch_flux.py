"""The port's FLUX backbone (``models/flux.py``) and the conditioning path
around it, on the CPU, against the plain float32 FLUX of
``tests/flux_reference.py`` (written from the published equations; it
imports nothing of the port).

Tiny widths: hidden 64, 4 heads of 16, RoPE axes (4, 6, 6), one double and
two single blocks, 8 text tokens of 32, a pooled vector of 24, latents
8 x 8 x 4 (16 image tokens). Every parameter is random, the QK-RMSNorm
scales 1 + 0.3 z, so that no block is the identity and the norms' scales
reach the output.

Tolerances (float32 on both sides, TF32 irrelevant on the CPU): the forward
within 2e-5 of the output's scale and the parameter gradients within 1e-4
of each gradient's largest entry. The two compute the same function in
another order: the port runs ``linear1`` as two GEMMs and ``linear2`` as two
accumulating ones, its attention takes the flash route's plain version
(probabilities in fp32, P V accumulated in fp32) and its RoPE pairs rotate
in one fused expression; fp32 sums over at most 256 terms reordered differ by
a few 1e-7 relative, and the backward's sums through 3 blocks amplify that.
"""

import threading

import numpy as np
import pytest
import torch

import flux_reference as R
from rectified_flow_vision_tpu_torch import serving_http as H
from rectified_flow_vision_tpu_torch.models import BaseFlowModel, LatentFlowPipeline
from rectified_flow_vision_tpu_torch.models import base_flow as TBF
from rectified_flow_vision_tpu_torch.models import flux as TFX
from rectified_flow_vision_tpu_torch.ops import fused
from rectified_flow_vision_tpu_torch.ops import qk_norm_rope as QR
from rectified_flow_vision_tpu_torch.serving import SamplerService
from rectified_flow_vision_tpu_torch.utils import profiling as TP

TINY = dict(backbone="flux", image_size=8, in_channels=4, patch_size=2, hidden_size=64,
            num_heads=4, mlp_ratio=4.0, depth=1, depth_single_blocks=2, context_in_dim=32,
            context_tokens=8, vec_in_dim=24, axes_dim=(4, 6, 6), theta=10000, qkv_bias=True,
            sample_dtype="float32")
REF_KEYS = dict(in_channels=16, vec_in_dim=24, context_in_dim=32, hidden_size=64, mlp_ratio=4.0,
                num_heads=4, depth=1, depth_single_blocks=2, axes_dim=(4, 6, 6), theta=10000,
                qkv_bias=True)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Six xdist workers share the cores: two OpenMP threads each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _randomise(net: torch.nn.Module, seed: int = 0) -> None:
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in net.named_parameters():
            z = torch.randn(p.shape, generator=g)
            if name.endswith("norm.scale"):
                p.copy_(1.0 + 0.3 * z)
            elif p.ndim == 1:
                p.copy_(0.1 * z)
            else:
                p.copy_(z / p.shape[1] ** 0.5)


def _pair(seed: int = 0):
    model = BaseFlowModel(device="cpu", seed=3, **TINY)
    _randomise(model.velocity_net, seed)
    ref = R.Flux(**REF_KEYS)
    ref.load_state_dict(model.velocity_net.state_dict(), strict=True)
    return model, ref


def _inputs(b: int = 2, seed: int = 1):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, 8, 8, 4), generator=g)
    cond = {"txt": torch.randn((b, 8, 32), generator=g), "vec": torch.randn((b, 24), generator=g)}
    return x, torch.tensor([0.15, 0.8][:b]), cond


def _reference(ref, x, t, cond, rope=True):
    img, img_ids = R.pack(x)
    txt_ids = torch.zeros(x.shape[0], cond["txt"].shape[1], 3)
    out = ref.velocity(img, img_ids, cond["txt"], txt_ids, t, cond["vec"], rope=rope)
    return R.unpack(out, x.shape)


def _close(got, want, rel):
    scale = want.abs().max()
    assert scale > 0.05, "the network's output is all but zero"
    torch.testing.assert_close(got, want, rtol=0, atol=rel * float(scale))


def test_the_state_dict_is_the_published_models():
    model, ref = _pair()
    names = set(model.velocity_net.state_dict())
    assert names == set(ref.state_dict())
    assert {"double_blocks.0.img_attn.norm.query_norm.scale", "single_blocks.1.linear1.weight",
            "final_layer.adaLN_modulation.1.weight", "time_in.in_layer.weight"} <= names
    assert model.cond_shapes == {"txt": (8, 32), "vec": (24,)}


@pytest.mark.parametrize("backbone", ["flux", "dit", "unet"])
def test_given_weights_are_taken_as_they_are(backbone):
    """``weights=`` assigns the state dict's own tensors (nothing drawn, no
    second copy, none left on the meta device) and computes what a model
    that loaded them computes."""
    cfg = TINY if backbone == "flux" else dict(UNCOND[backbone], sample_dtype="float32")
    donor = BaseFlowModel(device="cpu", seed=5, **cfg)
    _randomise(donor.velocity_net, 2)
    weights = {k: v.clone() for k, v in donor.velocity_net.state_dict().items()}
    model = BaseFlowModel(device="cpu", seed=6, weights=weights, **cfg)
    got = dict(model.velocity_net.named_parameters())
    assert set(got) == set(weights)
    assert all(p.data_ptr() == weights[k].data_ptr() and not p.is_meta for k, p in got.items())
    assert all(isinstance(p, torch.nn.Parameter) for p in got.values())
    x, t, cond = _inputs()
    x = x[..., :model.in_channels]
    extra = {"cond": cond} if backbone == "flux" else {}
    with torch.no_grad():
        want = donor.velocity_net(x, t, dtype=torch.float32, **extra)
        torch.testing.assert_close(model.velocity_net(x, t, dtype=torch.float32, **extra), want,
                                   rtol=0, atol=0)


def test_forward_matches_the_reference():
    model, ref = _pair()
    x, t, cond = _inputs()
    with torch.no_grad():
        got = model.velocity_net(x, t, dtype=torch.float32, cond=cond)
        want = _reference(ref, x, t, cond)
    _close(got, want, 2e-5)
    # the model's own entry (NHWC in and out) is the same function
    with torch.no_grad():
        _close(model(x, t, data_format="NHWC", cond=cond), want, 2e-5)


def test_parameter_gradients_of_an_mse_loss_match():
    model, ref = _pair(seed=4)
    x, t, cond = _inputs(seed=5)
    target = torch.randn(x.shape, generator=torch.Generator().manual_seed(6))
    net = model.velocity_net
    loss = torch.mean((net(x, t, dtype=torch.float32, masters=True, cond=cond) - target) ** 2)
    loss.backward()
    ref_loss = torch.mean((_reference(ref, x, t, cond) - target) ** 2)
    ref_loss.backward()
    assert float(loss.detach()) == pytest.approx(float(ref_loss.detach()), rel=1e-5)
    got = dict(net.named_parameters())
    for name, p in ref.named_parameters():
        g, want = got[name].grad, p.grad
        assert g is not None, name
        scale = float(want.abs().max())
        assert scale > 0, name  # every leaf reaches the loss, the norm scales too
        torch.testing.assert_close(g, want, rtol=0, atol=1e-4 * scale, msg=name)


def test_rope_rotates_adjacent_pairs_and_leaves_text_alone():
    ids = TFX.positions(3, 2, 4)
    cos, sin = TFX.rope_tables(ids, (4, 6, 6), 10000)
    assert cos.shape == (11, 8)
    assert torch.equal(cos[:3], torch.ones(3, 8)) and torch.equal(sin[:3], torch.zeros(3, 8))
    assert torch.equal(ids[3:7, 1], torch.zeros(4, dtype=ids.dtype))  # row 0, cols 0-3
    assert torch.equal(ids[3:7, 2], torch.arange(4, dtype=ids.dtype))
    # a head that is a unit vector along dim 2j keeps its energy in (2j, 2j + 1)
    d, heads = 16, 1
    for j in range(8):
        qkv = torch.zeros(1, 11, 3 * d)
        qkv[0, :, 2 * j] = 4.0  # q: its RMS is 1, so the norm gives ~4 e_{2j} (eps 1e-6)
        out = QR.qk_norm_rope_plain(qkv, torch.ones(d), torch.ones(d), cos, sin, heads)
        q = out[0, :, 0, 0]
        want = torch.zeros(11, d)
        want[:, 2 * j] = 4.0 * cos[:, j]
        want[:, 2 * j + 1] = 4.0 * sin[:, j]
        torch.testing.assert_close(q, want, rtol=0, atol=1e-5)
    # the same rotation as the published apply_rope, on random heads
    g = torch.Generator().manual_seed(2)
    qkv = torch.randn(2, 11, 3 * 4 * d, generator=g)
    qs, ks = 1 + 0.3 * torch.randn(d, generator=g), 1 + 0.3 * torch.randn(d, generator=g)
    out = QR.qk_norm_rope_plain(qkv, qs, ks, cos, sin, 4)
    q, k, v = R._split_heads(qkv, 4)
    pe = R.embed_nd(ids[None].repeat(2, 1, 1), [4, 6, 6], 10000)
    norm = R.QKNorm(d)
    with torch.no_grad():
        norm.query_norm.scale.copy_(qs)
        norm.key_norm.scale.copy_(ks)
        rq, rk = R.apply_rope(norm.query_norm(q), norm.key_norm(k), pe)
    torch.testing.assert_close(out[:, :, 0], rq.transpose(1, 2), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(out[:, :, 1], rk.transpose(1, 2), rtol=1e-6, atol=1e-6)
    assert torch.equal(out[:, :, 2], v.transpose(1, 2))


def test_an_image_shifted_by_one_column_is_rotated_consistently():
    """RoPE scores depend on the difference of positions only: moving every
    image token one column over leaves every image-image score, and every
    text-text score, as it was; the text-image scores move."""
    ids = TFX.positions(3, 3, 4)
    shifted = ids.clone()
    shifted[3:, 2] += 1
    g = torch.Generator().manual_seed(8)
    d = 16
    qkv = torch.randn(1, 15, 3 * d, generator=g)
    one = torch.ones(d)

    def scores(pos):
        cos, sin = TFX.rope_tables(pos, (4, 6, 6), 10000)
        out = QR.qk_norm_rope_plain(qkv, one, one, cos, sin, 1)[0, :, :, 0]
        return out[:, 0] @ out[:, 1].T

    a, b = scores(ids), scores(shifted)
    torch.testing.assert_close(a[3:, 3:], b[3:, 3:], rtol=0, atol=1e-4)
    torch.testing.assert_close(a[:3, :3], b[:3, :3], rtol=0, atol=1e-6)
    assert (a[:3, 3:] - b[:3, 3:]).abs().max() > 0.1


def test_rope_left_out_changes_the_output():
    model, ref = _pair()
    x, t, cond = _inputs()
    with torch.no_grad():
        sound, bare = _reference(ref, x, t, cond), _reference(ref, x, t, cond, rope=False)
    assert float((sound - bare).norm() / sound.norm()) > 0.01


def test_a_swapped_prompt_changes_the_output_and_rows_stay_apart():
    model, _ = _pair()
    x, t, cond = _inputs()
    t = torch.tensor([0.4, 0.4])
    net = model.velocity_net
    swapped = {k: c.flip(0) for k, c in cond.items()}
    with torch.no_grad():
        a = net(x, t, dtype=torch.float32, cond=cond)
        b = net(x, t, dtype=torch.float32, cond=swapped)
        c = net(x.flip(0), t, dtype=torch.float32, cond=swapped)
    for i in range(2):
        assert float((a[i] - b[i]).norm() / a[i].norm()) > 0.01  # the prompt reaches the image
    torch.testing.assert_close(c, a.flip(0), rtol=0, atol=1e-5)  # each row its own prompt
    only_vec = {"txt": cond["txt"], "vec": swapped["vec"]}
    only_txt = {"txt": swapped["txt"], "vec": cond["vec"]}
    with torch.no_grad():
        for part in (only_vec, only_txt):
            assert float((net(x, t, dtype=torch.float32, cond=part) - a).norm() / a.norm()) > 0.01


def test_the_fused_entry_is_the_plain_joint_on_the_cpu():
    g = torch.Generator().manual_seed(3)
    cos, sin = TFX.rope_tables(TFX.positions(4, 2, 3), (4, 6, 6), 10000)
    streams = [(torch.randn(2, 4, 96, generator=g), torch.rand(16, generator=g) + 0.5,
                torch.rand(16, generator=g) + 0.5),
               (torch.randn(2, 6, 96, generator=g), torch.rand(16, generator=g) + 0.5,
                torch.rand(16, generator=g) + 0.5)]
    joint = fused.qk_norm_rope(streams, cos, sin, 2)
    assert joint.shape == (2, 10, 3, 2, 16)
    torch.testing.assert_close(joint[:, :4], QR.qk_norm_rope_plain(*streams[0], cos[:4], sin[:4], 2))
    torch.testing.assert_close(joint[:, 4:], QR.qk_norm_rope_plain(*streams[1], cos[4:], sin[4:], 2))
    assert QR.supports(3072, 128, torch.bfloat16) and QR.supports(3072, 128, torch.float32)
    assert not QR.supports(3072, 96, torch.bfloat16)  # 12 vectors a head: not a power of two
    assert not QR.supports(3 * 3072, 128, torch.float32)  # 2304 threads a token


def test_sampling_and_the_service_carry_one_prompt_an_image():
    model, _ = _pair()
    svc = SamplerService(model, step_counts=(2,), batch_size=2, seed=5)
    g = torch.Generator().manual_seed(9)
    cond = {"txt": torch.randn(3, 8, 32, generator=g), "vec": torch.randn(3, 24, generator=g)}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        images = svc.generate(3, num_steps=2, cond=cond, data_format="NHWC")
    names = [e.name for e in prof.events()]
    assert names.count("rfv.generate.cond") == 2  # one a batch
    assert names.count("rfv.flux.double") == 2 * 2 * 1 and names.count("rfv.flux.single") == 8
    assert images.shape == (3, 8, 8, 4)
    s = svc.stats
    assert s["cond_rows"] == 4 and s["padded_images"] == 1 and s["cond_sum_s"] > 0
    # the service's images are the model's, each from its own noise and prompt
    gen = torch.Generator().manual_seed(5)
    noise = torch.cat([torch.randn((2, 8, 8, 4), generator=gen) for _ in range(2)])[:3]
    want = model.sample(noise, num_steps=2, data_format="NHWC", cond=cond)
    np.testing.assert_allclose(images, want.clamp(-1, 1).numpy(), rtol=0, atol=1e-5)
    # the padding row repeats the last prompt: the lone row's image is the same
    alone = model.sample(noise[2:], num_steps=2, data_format="NHWC",
                         cond={k: c[2:] for k, c in cond.items()})
    np.testing.assert_allclose(images[2:], alone.clamp(-1, 1).numpy(), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="needs a prompt"):
        svc.generate(1, num_steps=2)
    with pytest.raises(ValueError, match="takes"):
        svc.generate(2, num_steps=2, cond={k: c[:1] for k, c in cond.items()})


def test_the_latent_pipeline_passes_the_prompt():
    from rectified_flow_vision_tpu_torch.models import ConvVAE

    model, _ = _pair()
    vae = ConvVAE(image_size=32, in_channels=3, latent_channels=4, base_channels=16,
                  downsample=4, device="cpu")
    pipe = LatentFlowPipeline(model, vae, decode_dtype="float32")
    x, _, cond = _inputs()
    noise = x.permute(0, 3, 1, 2)
    out = pipe.sample(noise, num_steps=2, cond=cond)
    z = model.sample(noise, num_steps=2, cond=cond).permute(0, 2, 3, 1)
    torch.testing.assert_close(out, pipe.decode(z).permute(0, 3, 1, 2))
    assert out.shape == (2, 3, 32, 32)


def test_the_batcher_groups_prompted_requests():
    model, _ = _pair()
    svc = SamplerService(model, step_counts=(1,), batch_size=4, seed=2)
    batcher = H.Batcher(svc, max_wait_ms=30.0)
    g = torch.Generator().manual_seed(4)
    prompts = [{"txt": torch.randn(8, 32, generator=g), "vec": torch.randn(24, generator=g)}
               for _ in range(3)]
    out = [None] * 3
    try:
        threads = [threading.Thread(target=lambda i=i: out.__setitem__(
            i, batcher.submit(i + 1, 1, cond=prompts[i]))) for i in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        assert [o.shape[0] for o in out] == [1, 2, 3]
        with pytest.raises(ValueError, match="needs a prompt"):
            batcher.submit(1, 1)
        with pytest.raises(ValueError, match="takes"):
            batcher.submit(1, 1, cond={"txt": torch.zeros(8, 32)})
    finally:
        batcher.shutdown()
    # the two images of one request share its prompt; other requests' differ
    a, b = out[1]
    assert not np.allclose(a, b)  # noise differs
    assert batcher.stats["requests"] == 3 and batcher.stats["cond_rows"] >= 6


def test_the_json_front_end_refuses_a_model_that_needs_prompts():
    import json
    import urllib.error
    import urllib.request

    model, _ = _pair()
    svc = SamplerService(model, step_counts=(1,), batch_size=1, warmup=False)
    httpd, batcher = H.make_server(svc, "127.0.0.1", 0, max_wait_ms=1.0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/generate",
            data=json.dumps({"n": 1, "num_steps": 1}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=60)
        assert err.value.code == 400
        assert "prompt" in json.loads(err.value.read())["error"]
        assert batcher.stats["batches"] == 0
    finally:
        httpd.shutdown()
        batcher.shutdown()
        httpd.server_close()


@pytest.mark.parametrize("entry", ["loss_fn", "make_train_epoch", "params"])
def test_the_training_path_refuses_the_flux_backbone(entry):
    model, _ = _pair()
    with pytest.raises(NotImplementedError, match="flux backbone serves only"):
        if entry == "loss_fn":
            model.loss_fn(torch.zeros(2, 8, 8, 4))
        elif entry == "params":
            model.params
        else:
            opt = TBF.make_optimizer(model, 1e-3, epochs=1, steps_per_epoch=1)
            TBF.make_train_epoch(model, opt, coupled=False)


UNCOND = {
    "unet": dict(image_size=8, model_channels=16, channel_mult=[1], num_res_blocks=1),
    "dit": dict(backbone="dit", image_size=8, in_channels=4, patch_size=2, hidden_size=32,
                depth=2, num_heads=4),
}


@pytest.mark.parametrize("backbone", sorted(UNCOND))
def test_unconditional_backbones_are_untouched(backbone):
    """No conditioning anywhere: the sampler is the plain Euler loop over the
    network, the service and the batcher refuse a prompt, the spans and
    counters of conditioning stay silent."""
    model = BaseFlowModel(device="cpu", sample_dtype="float32", seed=1, **UNCOND[backbone])
    assert model.cond_shapes is None
    noise = torch.randn((2, 8, 8, model.in_channels), generator=torch.Generator().manual_seed(3))
    got = model.sample(noise, num_steps=3, data_format="NHWC")
    x = noise.clone()
    for i in range(3):
        t = torch.full((2,), float(np.float32(i) * np.float32(1 / 3)))
        with torch.no_grad():
            x = x + model.velocity_net(x, t, dtype=torch.float32) * float(np.float32(1 / 3))
    torch.testing.assert_close(got, x, rtol=0, atol=1e-6)
    svc = SamplerService(model, step_counts=(1,), batch_size=2, warmup=False)
    with pytest.raises(ValueError, match="takes no conditioning"):
        svc.generate(1, num_steps=1, cond={"vec": torch.zeros(1, 3)})
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        svc.generate(3, num_steps=1)
    assert not [e for e in prof.events() if e.name in ("rfv.generate.cond", "rfv.flux.double")]
    assert svc.stats["cond_rows"] == 0 and svc.stats["cond_sum_s"] == 0.0
    batcher = H.Batcher(svc)
    try:
        with pytest.raises(ValueError, match="takes no conditioning"):
            batcher.submit(1, 1, cond={"vec": torch.zeros(3)})
        assert batcher.submit(1, 1).shape[0] == 1
    finally:
        batcher.shutdown()
    assert TP.annotate("rfv.flux.single") is TP.annotate("rfv.generate.cond")

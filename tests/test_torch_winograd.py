"""The port's Winograd F(2x2, 3x3) conv and its gate, held against the JAX
package on the CPU.

Inputs and weights come from a numpy seed; the JAX module takes HWIO
weights, the port OHWI (``w.transpose(3, 0, 1, 2)``). Both round at the same
points: V = B^T d B in the compute dtype, U in fp32 rounded to it, the tap
products with an fp32 result, A^T m A and the bias in fp32.

Tolerances: the filter transform 1e-6; the conv against JAX's fp32 1e-5 of
the largest output entry (measured 2e-7: fp32 sums in another order), bf16
1e-2 of it (about one bf16 ulp of the largest entry; measured bit for bit);
against the port's plain conv fp32 atol 2e-4 (the transforms' rounding at
the outputs' scale) and in bf16 at most 4x the plain bf16 conv's error
against the fp32 truth (the JAX test's contract); dx, dw, db against
``jax.grad`` 1e-5 of each gradient's largest entry. With the gate set, a
small UNet (16x16, 32 channels, mult (1, 2), one res-block) against JAX
``UNet.apply`` under the same variable as ``tests/test_torch_unet.py`` holds
it (fp32 atol 1e-4, bf16 3% of the largest output); a train step's loss atol
1e-5 and gradients atol 1e-4 against ``jax.grad``. The JAX package reads the
variable when it traces, so each reference is a freshly jitted function, and
a spy on its ``conv2d_winograd`` counts the convs that took it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectified_flow_vision_tpu.models import BaseFlowModel as JBase
from rectified_flow_vision_tpu.models.unet import UNet as JUNet
from rectified_flow_vision_tpu.ops import winograd as JW
from rectified_flow_vision_tpu_torch.models import BaseFlowModel
from rectified_flow_vision_tpu_torch.models.unet import UNet
from rectified_flow_vision_tpu_torch.ops import build
from rectified_flow_vision_tpu_torch.ops import conv3x3 as C
from rectified_flow_vision_tpu_torch.ops import fused
from rectified_flow_vision_tpu_torch.ops import winograd as W
from rectified_flow_vision_tpu_torch.utils import pt_import as TPT

GATE = "RFV_CONV_WINOGRAD"
# the JAX test's three shapes, and one at the flagship's 64 channels
SHAPES = [((2, 8, 8, 16), 32), ((1, 16, 16, 8), 8), ((3, 4, 6, 4), 4), ((2, 16, 16, 64), 64)]
SMALL = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1)


@pytest.fixture(autouse=True)
def _gate_unset(monkeypatch):
    monkeypatch.delenv(GATE, raising=False)


def _case(shape, k, seed=0):
    """x (NHWC), HWIO weight, bias from a numpy seed."""
    r = np.random.default_rng(seed)
    x = r.standard_normal(shape).astype(np.float32)
    w = (r.standard_normal((3, 3, shape[-1], k)) / np.sqrt(9 * shape[-1])).astype(np.float32)
    b = (0.1 * r.standard_normal(k)).astype(np.float32)
    return x, w, b


def _ohwi(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 0, 1, 2)))


@pytest.mark.parametrize("shape,k", SHAPES)
def test_transform_filter_matches_jax(shape, k):
    _, w, _ = _case(shape, k)
    want = np.asarray(jax.jit(JW.transform_filter)(jnp.asarray(w)))
    got = W.transform_filter(_ohwi(w))
    assert got.dtype == torch.float32 and tuple(got.shape) == (4, 4, shape[-1], k)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,k", SHAPES)
def test_conv_matches_jax_winograd(shape, k, dtype):
    x, w, b = _case(shape, k, seed=1)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = jax.jit(JW.conv2d_winograd)(jnp.asarray(x).astype(jdt),
                                       {"w": jnp.asarray(w), "b": jnp.asarray(b)})
    want = np.asarray(want.astype(jnp.float32))
    got = W.conv2d_winograd(torch.from_numpy(x).to(tdt), _ohwi(w), torch.from_numpy(b))
    assert got.dtype == tdt and tuple(got.shape) == shape[:3] + (k,)
    tol = (1e-5 if dtype == "float32" else 1e-2) * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("shape,k", SHAPES)
def test_conv_matches_the_plain_conv(shape, k):
    """fp32 against ``conv3x3_plain``; bf16 within 4x the plain bf16 conv's
    error against the fp32 truth."""
    x, w, b = _case(shape, k, seed=2)
    xt, wt, bt = torch.from_numpy(x), _ohwi(w), torch.from_numpy(b)
    truth = C.conv3x3_plain(xt, wt, bt)
    np.testing.assert_allclose(W.conv2d_winograd(xt, wt, bt).numpy(), truth.numpy(), rtol=2e-4,
                               atol=2e-4)
    xb = xt.to(torch.bfloat16)
    err_plain = (C.conv3x3_plain(xb, wt, bt).float() - truth).abs().max()
    err_wino = (W.conv2d_winograd(xb, wt, bt).float() - truth).abs().max()
    assert err_wino <= 4.0 * max(float(err_plain), 1e-3), (err_wino, err_plain)


@pytest.mark.parametrize("shape,k", SHAPES[:2] + SHAPES[3:])
def test_gradients_match_jax_grad(shape, k):
    """dx, dw and db of <winograd(x, w, b), ct> against ``jax.grad`` of the
    JAX ``winograd_conv3x3``, fp32."""
    x, w, b = _case(shape, k, seed=3)
    ct = np.random.default_rng(4).standard_normal(shape[:3] + (k,)).astype(np.float32)

    def jloss(x_, w_, b_):
        return jnp.sum(JW.winograd_conv3x3(x_, w_, b_) * ct)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(jnp.asarray(x), jnp.asarray(w),
                                                       jnp.asarray(b))
    xt, wt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    y = W.winograd_conv3x3(xt, wt.permute(3, 0, 1, 2), bt)
    (y * torch.from_numpy(ct)).sum().backward()
    for name, got, ref in zip("xwb", (xt.grad, wt.grad, bt.grad), want):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max(),
                                   err_msg=f"d{name}")


def test_bf16_gradients_are_in_the_operands_dtype():
    """In bf16 the tap product's backward rounds dv and du to bf16, and the
    weight's gradient comes back in the dtype it was given."""
    x, w, b = _case((2, 8, 8, 16), 16, seed=5)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    wt = _ohwi(w).requires_grad_()
    W.conv2d_winograd(xt, wt, torch.from_numpy(b)).float().square().sum().backward()
    assert xt.grad.dtype == torch.bfloat16 and wt.grad.dtype == torch.float32
    assert torch.isfinite(xt.grad.float()).all() and torch.isfinite(wt.grad).all()


@pytest.mark.parametrize("hw", [(5, 8), (8, 7)], ids=["odd_h", "odd_w"])
def test_odd_dims_raise_and_the_gate_passes_them_on(hw, monkeypatch):
    x, w, b = _case((1, *hw, 64), 64, seed=6)
    xt, wt, bt = torch.from_numpy(x), _ohwi(w), torch.from_numpy(b)
    with pytest.raises(ValueError, match="even spatial dims"):
        W.winograd_conv3x3(xt, wt, bt)
    monkeypatch.setenv(GATE, "1")
    W.reset_calls()
    out = fused.conv2d_fused(xt, wt, bt)  # the conv3x3 site: its plain version on the CPU
    assert W.CALLS["winograd"] == 0
    assert torch.equal(out, C.conv3x3_plain(xt, wt, bt))


def test_non_3x3_weight_raises():
    x = torch.zeros((1, 8, 8, 4))
    with pytest.raises(ValueError, match="3x3"):
        W.winograd_conv3x3(x, torch.zeros((4, 1, 1, 4)), torch.zeros(4))


def _unet_pair(seed):
    """The small UNet with the port's seeded init, and its weights as the JAX
    package's param tree (the JAX ``init`` costs seconds unjitted)."""
    net = UNet(**SMALL)
    net.reset_parameters(torch.Generator().manual_seed(seed))
    sd = {f"velocity_net.{k}": v.numpy() for k, v in net.state_dict().items()}
    return net, TPT.state_dict_to_params(sd)[0]


def _jax_spy(monkeypatch):
    """Count the JAX package's Winograd calls (its gate imports the function
    at each call)."""
    calls = []
    real = JW.conv2d_winograd
    monkeypatch.setattr(JW, "conv2d_winograd", lambda x, p: calls.append(x.shape) or real(x, p))
    return calls


# the small UNet's conv2d_fused sites: conv1 and conv2 of its 6 res-blocks
# (one a level in the encoder and in the decoder, two mid) and 1 upsample conv
SMALL_SITES = 2 * 6 + 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gated_unet_forward_matches_jax(dtype, monkeypatch):
    net, params = _unet_pair(seed=7)
    jnet = JUNet(**SMALL)
    r = np.random.default_rng(8)
    x = r.standard_normal((2, 16, 16, 3)).astype(np.float32)
    t = r.random(2).astype(np.float32)
    monkeypatch.setenv(GATE, "1")
    jcalls = _jax_spy(monkeypatch)
    jdt = jnp.dtype(dtype)
    bparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), params)
    ref = jax.jit(lambda p, x_, t_: jnet.apply(p, x_, t_, compute_dtype=jdt))(
        bparams, jnp.asarray(x), jnp.asarray(t))
    ref = np.asarray(ref.astype(jnp.float32))
    W.reset_calls()
    build.reset_launches()
    with torch.no_grad():
        out = net(torch.from_numpy(x), torch.from_numpy(t), dtype=getattr(torch, dtype))
    assert len(jcalls) == SMALL_SITES and W.CALLS["winograd"] == SMALL_SITES
    assert sum(build.LAUNCHES.values()) == 0
    out = out.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    else:
        assert np.abs(out - ref).max() <= 0.03 * np.abs(ref).max()
    # and the gate does change the arithmetic: the direct conv differs
    monkeypatch.delenv(GATE)
    with torch.no_grad():
        direct = net(torch.from_numpy(x), torch.from_numpy(t), dtype=getattr(torch, dtype))
    assert W.CALLS["winograd"] == SMALL_SITES and not np.array_equal(direct.float().numpy(), out)


def test_gated_train_step_loss_and_gradients_match_jax(monkeypatch):
    """``loss_fn`` and every gradient of the fp32 small UNet (16x16, dropout
    0) under the gate, against ``jax.value_and_grad`` of the JAX loss under
    the same variable, on the same x0 and t."""
    cfg = dict(image_size=16, dropout=0.0, sample_dtype="float32", **SMALL)
    params = _unet_pair(seed=9)[1]
    jm = JBase(params=jax.tree_util.tree_map(jnp.asarray, params), **cfg)
    tm = BaseFlowModel(device="cpu", params=params, **cfg)
    r = np.random.default_rng(10)
    x1 = np.tanh(r.standard_normal((4, 16, 16, 3))).astype(np.float32)
    x0 = r.standard_normal(x1.shape).astype(np.float32)
    rng = jax.random.key(11)
    t = np.array(jax.random.uniform(jax.random.split(rng, 3)[1], (4,), jnp.float32))
    monkeypatch.setenv(GATE, "1")
    jcalls = _jax_spy(monkeypatch)
    ref, gref = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, jnp.asarray(x1), rng, x0=jnp.asarray(x0))))(jm.params)
    W.reset_calls()
    loss = tm.loss_fn(torch.from_numpy(x1), x0=torch.from_numpy(x0), t=torch.from_numpy(t))
    loss.backward()
    assert len(jcalls) == SMALL_SITES and W.CALLS["winograd"] == SMALL_SITES
    assert abs(float(loss.detach()) - float(ref)) <= 1e-5
    sd = {k: p.grad.numpy() for k, p in tm.named_parameters()}
    got = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
           jax.tree_util.tree_leaves_with_path(TPT.state_dict_to_params(sd)[0])}
    want = {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(gref)}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4, err_msg=k)

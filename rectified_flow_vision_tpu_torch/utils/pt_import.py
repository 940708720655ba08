"""Reference ``.pt`` state dicts <-> the JAX-layout param tree (numpy only).

The port's UNet keeps the reference module names, so a param tree from a
JAX ``.npz`` becomes its ``state_dict`` through ``params_to_state_dict``
(strip the ``velocity_net.`` prefix) and a ``.pt`` file loads through
``state_dict_to_params`` and back.

The reference saves ``torch.save({'state_dict': ..., 'config':
{'image_size', 'in_channels'}})`` (reference: models/base_flow.py:210-220)
where the state dict is the BaseFlowModel's, i.e. every key is prefixed
``velocity_net.`` and follows the reference UNet's module naming
(reference: models/unet.py:157-227):

    velocity_net.time_mlp.{1,3}.{weight,bias}      # Linear layers of the MLP
    velocity_net.input_conv.{weight,bias}
    velocity_net.enc_blocks.{i}.<resblock>         # flat ModuleList
    velocity_net.downsamples.{level}.{weight,bias} # absent at last level
    velocity_net.mid_block1/.mid_attn/.mid_block2
    velocity_net.dec_blocks.{i}.<resblock>
    velocity_net.upsamples.{j}.1.{weight,bias}     # Sequential(Upsample, Conv)
    velocity_net.output_conv.{0,2}.{weight,bias}   # Sequential(GN, SiLU, Conv)

    <resblock> = norm1/conv1/norm2/conv2/time_mlp.1/shortcut

Layout conversions: torch convs are OIHW -> JAX HWIO (transpose 2,3,1,0);
torch Linear weights are (out, in) -> ours (in, out) (transpose); the
reference's qkv/proj are 1x1 convs (3C, C, 1, 1) -> our dense (C, 3C).

Because the reference checkpoint's config records only image_size and
in_channels, the architecture (model_channels, channel_mult,
num_res_blocks) is inferred from the state-dict shapes, making `.pt` files
fully self-describing for ``BaseFlowModel.from_checkpoint``.

DiT and the ConvVAE have no reference ``.pt`` format: the port's modules are
named after the JAX param tree itself (``blocks.3.qkv``, ``enc.down0.conv``),
so one generic pair (``tree_to_state_dict`` / ``state_dict_to_tree``) carries
any such tree across: ``{w, b}`` with a 4-d ``w`` is a conv, with a 2-d ``w``
a dense layer, ``{scale, bias}`` a norm, and any other leaf (DiT's
``pos_embed``) a bare parameter.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

Params = Dict[str, Any]


def _conv(sd: Dict[str, np.ndarray], key: str) -> dict:
    """torch Conv2d (O, I, H, W) -> {w: HWIO, b}."""
    return {
        "w": np.transpose(sd[f"{key}.weight"], (2, 3, 1, 0)),
        "b": sd[f"{key}.bias"],
    }


def _dense(sd: Dict[str, np.ndarray], key: str) -> dict:
    """torch Linear (out, in) -> {w: (in, out), b}."""
    return {"w": np.transpose(sd[f"{key}.weight"]), "b": sd[f"{key}.bias"]}


def _dense_from_1x1_conv(sd: Dict[str, np.ndarray], key: str) -> dict:
    """torch 1x1 Conv2d (O, I, 1, 1) -> dense {w: (I, O), b}."""
    w = sd[f"{key}.weight"]
    return {"w": np.transpose(w[:, :, 0, 0]), "b": sd[f"{key}.bias"]}


def _norm(sd: Dict[str, np.ndarray], key: str) -> dict:
    return {"scale": sd[f"{key}.weight"], "bias": sd[f"{key}.bias"]}


def _resblock(sd: Dict[str, np.ndarray], prefix: str) -> dict:
    p = {
        "norm1": _norm(sd, f"{prefix}.norm1"),
        "conv1": _conv(sd, f"{prefix}.conv1"),
        "norm2": _norm(sd, f"{prefix}.norm2"),
        "conv2": _conv(sd, f"{prefix}.conv2"),
        # reference ResidualBlock.time_mlp = Sequential(SiLU, Linear)
        "time": _dense(sd, f"{prefix}.time_mlp.1"),
    }
    if f"{prefix}.shortcut.weight" in sd:
        p["shortcut"] = _conv(sd, f"{prefix}.shortcut")
    return p


def infer_architecture(sd: Dict[str, np.ndarray]) -> dict:
    """Recover (model_channels, channel_mult, num_res_blocks) from shapes.

    num_levels comes from the downsample count (one per level except the
    last), NOT from collapsing equal-channel runs — repeated multipliers
    like channel_mult=[1, 2, 2, 4] must survive inference.
    """
    model_channels = sd["velocity_net.input_conv.weight"].shape[0]

    enc_ids = sorted(
        {
            int(k.split(".")[2])
            for k in sd
            if k.startswith("velocity_net.enc_blocks.")
        }
    )
    num_downs = len(
        {
            int(k.split(".")[2])
            for k in sd
            if k.startswith("velocity_net.downsamples.")
        }
    )
    num_levels = num_downs + 1
    if len(enc_ids) % num_levels != 0:
        raise ValueError(
            f"cannot infer architecture: {len(enc_ids)} encoder blocks over "
            f"{num_levels} levels"
        )
    num_res_blocks = len(enc_ids) // num_levels

    enc_out = [
        sd[f"velocity_net.enc_blocks.{i}.conv1.weight"].shape[0] for i in enc_ids
    ]
    channels = [enc_out[level * num_res_blocks] for level in range(num_levels)]
    channel_mult = [c // model_channels for c in channels]
    return {
        "model_channels": int(model_channels),
        "channel_mult": channel_mult,
        "num_res_blocks": int(num_res_blocks),
    }


def state_dict_to_params(sd: Dict[str, np.ndarray]) -> Tuple[Params, dict]:
    """Convert a reference-format state dict into our UNet param tree."""
    arch = infer_architecture(sd)
    num_levels = len(arch["channel_mult"])
    nrb = arch["num_res_blocks"]

    params: Params = {
        "time_mlp": {
            "lin1": _dense(sd, "velocity_net.time_mlp.1"),
            "lin2": _dense(sd, "velocity_net.time_mlp.3"),
        },
        "input_conv": _conv(sd, "velocity_net.input_conv"),
    }

    enc: Params = {}
    for level in range(num_levels):
        for i in range(nrb):
            flat = level * nrb + i
            enc[f"{level}_{i}"] = _resblock(sd, f"velocity_net.enc_blocks.{flat}")
    params["enc_blocks"] = enc

    downs: Params = {}
    for level in range(num_levels - 1):
        downs[str(level)] = _conv(sd, f"velocity_net.downsamples.{level}")
    params["downsamples"] = downs

    params["mid_block1"] = _resblock(sd, "velocity_net.mid_block1")
    params["mid_attn"] = {
        "norm": _norm(sd, "velocity_net.mid_attn.norm"),
        "qkv": _dense_from_1x1_conv(sd, "velocity_net.mid_attn.qkv"),
        "proj": _dense_from_1x1_conv(sd, "velocity_net.mid_attn.proj"),
    }
    params["mid_block2"] = _resblock(sd, "velocity_net.mid_block2")

    dec: Params = {}
    flat = 0
    for level in range(num_levels - 1, -1, -1):
        for i in range(nrb):
            dec[f"{level}_{i}"] = _resblock(sd, f"velocity_net.dec_blocks.{flat}")
            flat += 1
    params["dec_blocks"] = dec

    ups: Params = {}
    # torch creation order: level = num_levels-1 .. 1 maps to j = 0, 1, ...
    # inside Sequential(Upsample, Conv2d) the conv is submodule 1.
    for j, level in enumerate(range(num_levels - 1, 0, -1)):
        ups[str(level)] = _conv(sd, f"velocity_net.upsamples.{j}.1")
    params["upsamples"] = ups

    params["output_conv"] = {
        "norm": _norm(sd, "velocity_net.output_conv.0"),
        "conv": _conv(sd, "velocity_net.output_conv.2"),
    }
    return params, arch


def import_pt_checkpoint(path) -> Tuple[Params, Optional[dict]]:
    """Load a reference ``.pt`` checkpoint into (params, config)."""
    import torch

    ckpt = torch.load(str(path), map_location="cpu", weights_only=True)
    sd_t = ckpt["state_dict"] if "state_dict" in ckpt else ckpt
    sd = {k: v.detach().cpu().numpy() for k, v in sd_t.items()}

    params, arch = state_dict_to_params(sd)
    config = dict(ckpt.get("config") or {})
    config.update(arch)
    # the reference config stores image_size/in_channels (base_flow.py:213-219)
    config.setdefault("in_channels", int(sd["velocity_net.input_conv.weight"].shape[1]))
    return params, config


# ---------------------------------------------------------------------------
# Export (our params -> reference-format torch state dict)
# ---------------------------------------------------------------------------


def _inv_conv(p: dict, out: Dict[str, np.ndarray], key: str) -> None:
    out[f"{key}.weight"] = np.transpose(np.asarray(p["w"]), (3, 2, 0, 1))
    out[f"{key}.bias"] = np.asarray(p["b"])


def _inv_dense(p: dict, out: Dict[str, np.ndarray], key: str) -> None:
    out[f"{key}.weight"] = np.transpose(np.asarray(p["w"]))
    out[f"{key}.bias"] = np.asarray(p["b"])


def _inv_dense_to_1x1_conv(p: dict, out: Dict[str, np.ndarray], key: str) -> None:
    w = np.transpose(np.asarray(p["w"]))  # (O, I)
    out[f"{key}.weight"] = w[:, :, None, None]
    out[f"{key}.bias"] = np.asarray(p["b"])


def _inv_norm(p: dict, out: Dict[str, np.ndarray], key: str) -> None:
    out[f"{key}.weight"] = np.asarray(p["scale"])
    out[f"{key}.bias"] = np.asarray(p["bias"])


def _inv_resblock(p: dict, out: Dict[str, np.ndarray], prefix: str) -> None:
    _inv_norm(p["norm1"], out, f"{prefix}.norm1")
    _inv_conv(p["conv1"], out, f"{prefix}.conv1")
    _inv_norm(p["norm2"], out, f"{prefix}.norm2")
    _inv_conv(p["conv2"], out, f"{prefix}.conv2")
    _inv_dense(p["time"], out, f"{prefix}.time_mlp.1")
    if "shortcut" in p:
        _inv_conv(p["shortcut"], out, f"{prefix}.shortcut")


def params_to_state_dict(
    params: Params, channel_mult: List[int], num_res_blocks: int
) -> Dict[str, np.ndarray]:
    """Our UNet param tree -> reference-named numpy state dict."""
    out: Dict[str, np.ndarray] = {}
    _inv_dense(params["time_mlp"]["lin1"], out, "velocity_net.time_mlp.1")
    _inv_dense(params["time_mlp"]["lin2"], out, "velocity_net.time_mlp.3")
    _inv_conv(params["input_conv"], out, "velocity_net.input_conv")

    num_levels = len(channel_mult)
    for level in range(num_levels):
        for i in range(num_res_blocks):
            flat = level * num_res_blocks + i
            _inv_resblock(
                params["enc_blocks"][f"{level}_{i}"],
                out,
                f"velocity_net.enc_blocks.{flat}",
            )
    for level in range(num_levels - 1):
        _inv_conv(
            params["downsamples"][str(level)], out,
            f"velocity_net.downsamples.{level}",
        )

    _inv_resblock(params["mid_block1"], out, "velocity_net.mid_block1")
    _inv_norm(params["mid_attn"]["norm"], out, "velocity_net.mid_attn.norm")
    _inv_dense_to_1x1_conv(params["mid_attn"]["qkv"], out, "velocity_net.mid_attn.qkv")
    _inv_dense_to_1x1_conv(params["mid_attn"]["proj"], out, "velocity_net.mid_attn.proj")
    _inv_resblock(params["mid_block2"], out, "velocity_net.mid_block2")

    flat = 0
    for level in range(num_levels - 1, -1, -1):
        for i in range(num_res_blocks):
            _inv_resblock(
                params["dec_blocks"][f"{level}_{i}"],
                out,
                f"velocity_net.dec_blocks.{flat}",
            )
            flat += 1
    for j, level in enumerate(range(num_levels - 1, 0, -1)):
        _inv_conv(params["upsamples"][str(level)], out, f"velocity_net.upsamples.{j}.1")

    _inv_norm(params["output_conv"]["norm"], out, "velocity_net.output_conv.0")
    _inv_conv(params["output_conv"]["conv"], out, "velocity_net.output_conv.2")
    return out


def export_pt_checkpoint(model, path) -> None:
    """Save a UNet flow model as a reference-compatible torch ``.pt``
    checkpoint: ``{"state_dict", "config": {"image_size", "in_channels"}}``,
    the state dict the reference's ``BaseFlowModel`` loads."""
    import torch

    net = model.velocity_net
    sd = params_to_state_dict(model.params, list(net.channel_mult), net.num_res_blocks)
    torch.save(
        {
            "state_dict": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
            "config": {"image_size": model.image_size, "in_channels": model.in_channels},
        },
        str(path),
    )
    print(f"Model exported to torch checkpoint: {path}")


# ---------------------------------------------------------------------------
# Trees whose module names are the tree's own keys (DiT, ConvVAE)
# ---------------------------------------------------------------------------


def tree_to_state_dict(tree: Params, prefix: str = "") -> Dict[str, np.ndarray]:
    """A JAX-layout param tree -> a numpy state dict with ``.``-joined names
    under ``prefix``."""
    out: Dict[str, np.ndarray] = {}
    for name, node in tree.items():
        key = f"{prefix}{name}"
        if not isinstance(node, dict):
            out[key] = np.asarray(node)
        elif set(node) == {"w", "b"}:
            if np.ndim(node["w"]) == 4:
                _inv_conv(node, out, key)
            else:
                _inv_dense(node, out, key)
        elif set(node) == {"scale", "bias"}:
            _inv_norm(node, out, key)
        else:
            out.update(tree_to_state_dict(node, f"{key}."))
    return out


def state_dict_to_tree(sd: Dict[str, np.ndarray], prefix: str = "") -> Params:
    """The inverse of ``tree_to_state_dict`` for the keys under ``prefix``."""
    names = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    tree: Params = {}
    for name, arr in names.items():
        *path, last = name.split(".")
        if last == "bias" and ".".join(path + ["weight"]) in names:
            continue  # taken with its weight
        if last == "weight":
            module = prefix + ".".join(path)
            ndim = np.ndim(arr)
            leaf: Any = (
                _conv(sd, module) if ndim == 4
                else _dense(sd, module) if ndim == 2
                else _norm(sd, module)
            )
        else:  # a bare parameter
            path, leaf = path + [last], arr
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = leaf
    return tree


def backbone_state_dict_to_params(sd: Dict[str, np.ndarray], backbone: str) -> Params:
    """A flow model's numpy state dict as the JAX package's param tree."""
    if backbone == "dit":
        return state_dict_to_tree(sd, "velocity_net.")
    return state_dict_to_params(sd)[0]

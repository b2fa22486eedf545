"""JAX LMNet variables -> the port's train-mode state dict.

Takes ``{'params': ..., 'batch_stats': ...}`` as nested dicts of numpy
arrays (``jax.device_get`` of the Flax variables gives that) and returns the
``LMNet`` state dict under the reference model's names, so that
``LMNet.load_state_dict(..., strict=True)`` takes it. Conv kernels go from
HWIO to OIHW and dense kernels from (in, out) to (out, in). This mapping is
the one ``tests/test_full_model_parity.py::_transplant`` uses against the
reference source.

Without ``'batch_stats'`` the running statistics are left out, so a tree
shaped like the params, such as JAX's gradients, maps onto the names of the
port's parameters (``dict(model.named_parameters())``).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _oihw(k) -> torch.Tensor:
    return _t(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def _put_conv(sd, name, p):  # TorchConv {'conv': {kernel[, bias]}}
    sd[f"{name}.weight"] = _oihw(p["conv"]["kernel"])
    if "bias" in p["conv"]:
        sd[f"{name}.bias"] = _t(p["conv"]["bias"])


def _put_raw_conv(sd, name, p):  # plain nn.Conv {kernel, bias} (SE fc)
    sd[f"{name}.weight"] = _oihw(p["kernel"])
    sd[f"{name}.bias"] = _t(p["bias"])


def _sub(s, key):  # the batch_stats subtree, or None without batch_stats
    return None if s is None else s[key]


def _put_bn(sd, name, p, s):
    sd[f"{name}.weight"] = _t(p["scale"])
    sd[f"{name}.bias"] = _t(p["bias"])
    if s is not None:
        sd[f"{name}.running_mean"] = _t(s["mean"])
        sd[f"{name}.running_var"] = _t(s["var"])


def _put_ln(sd, name, p):
    sd[f"{name}.weight"] = _t(p["scale"])
    sd[f"{name}.bias"] = _t(p["bias"])


def _put_dense(sd, name, p):  # TorchDense {'dense': {kernel, bias}}
    sd[f"{name}.weight"] = _t(np.asarray(p["dense"]["kernel"]).T)
    sd[f"{name}.bias"] = _t(p["dense"]["bias"])


def _put_rc(sd, tname, p, s):
    _put_conv(sd, f"{tname}.expand_conv.0", p["expand_conv"])
    _put_bn(sd, f"{tname}.expand_conv.1", p["expand_bn"], _sub(s, "expand_bn"))
    for br in ("large", "square", "ver", "hor"):
        sd[f"{tname}.{br}_conv.conv.weight"] = _oihw(p[f"{br}_conv"]["conv"]["kernel"])
        _put_bn(sd, f"{tname}.{br}_conv.bn", p[f"{br}_bn"], _sub(s, f"{br}_bn"))
    _put_raw_conv(sd, f"{tname}.se.fc1", p["se"]["fc1"])
    _put_raw_conv(sd, f"{tname}.se.fc2", p["se"]["fc2"])
    _put_conv(sd, f"{tname}.pointwise_conv.0", p["pointwise_conv"])
    _put_conv(sd, f"{tname}.shortcut.0", p["shortcut"])


def _put_natt(sd, tname, p):
    _put_conv(sd, f"{tname}.patchembedding.patch_embeddings", p["embed"]["proj"])
    _put_ln(sd, f"{tname}.norm1", p["norm1"])
    _put_dense(sd, f"{tname}.att1.qkv", p["attn"]["qkv"])
    _put_dense(sd, f"{tname}.att1.proj", p["attn"]["proj"])
    sd[f"{tname}.att1.rpb"] = _t(p["attn"]["rpb"])
    _put_ln(sd, f"{tname}.norm2", p["norm2"])
    _put_dense(sd, f"{tname}.mlp.fc1", p["mlp"]["fc1"])
    _put_dense(sd, f"{tname}.mlp.fc2", p["mlp"]["fc2"])


def jax_to_state_dict(variables: Mapping) -> dict[str, torch.Tensor]:
    """Train-mode JAX LMNet variables (numpy leaves) -> ``LMNet`` state dict;
    without ``'batch_stats'``, the parameters alone."""
    p = variables["params"]
    s = variables.get("batch_stats")
    sd: dict[str, torch.Tensor] = {}
    for i in range(1, 5):
        for name in (f"conv{i}", f"dconv{i}"):
            for j in (0, 1):
                _put_rc(sd, f"{name}.{j}", p[f"{name}_{j}"], _sub(s, f"{name}_{j}"))
        _put_conv(sd, f"down{i}.0", p[f"down{i}"])
        _put_conv(sd, f"up{i}.1", p[f"up{i}"])
    g = p["gft"]
    _put_conv(sd, "gft.patchembedding.patch_embeddings", g["embed"]["proj"])
    _put_ln(sd, "gft.norm1", g["norm1"])
    sd["gft.attention.qkv.weight"] = _t(np.asarray(g["attn"]["qkv"]["kernel"]).T)
    sd["gft.attention.qkv.bias"] = _t(g["attn"]["qkv"]["bias"])
    sd["gft.attention.proj.weight"] = _t(np.asarray(g["attn"]["proj"]["kernel"]).T)
    sd["gft.attention.proj.bias"] = _t(g["attn"]["proj"]["bias"])
    _put_ln(sd, "gft.norm2", g["norm2"])
    _put_dense(sd, "gft.mlp.fc1", g["mlp"]["fc1"])
    _put_dense(sd, "gft.mlp.fc2", g["mlp"]["fc2"])
    _put_conv(sd, "gft.conv.0", g["out_conv"])
    # skips (M2 bottom: convs is index 0; M3 / M2 top: convs follows Upsample2x)
    _put_conv(sd, "skip1.convl.0", p["skip1"]["convl"])
    _put_conv(sd, "skip1.convs.0", p["skip1"]["convs"])
    _put_conv(sd, "skip1.fuse_conv.0", p["skip1"]["fuse_conv"])
    _put_bn(sd, "skip1.fuse_conv.1", p["skip1"]["fuse_bn"], _sub(_sub(s, "skip1"), "fuse_bn"))
    for name in ("skip2", "skip3"):
        _put_conv(sd, f"{name}.convl.0", p[name]["convl"])
        _put_conv(sd, f"{name}.convm.0", p[name]["convm"])
        _put_conv(sd, f"{name}.convs.1", p[name]["convs"])
        _put_conv(sd, f"{name}.fuse_conv.0", p[name]["fuse_conv"])
        _put_bn(sd, f"{name}.fuse_conv.1", p[name]["fuse_bn"], _sub(_sub(s, name), "fuse_bn"))
    _put_conv(sd, "skip4.convl.0", p["skip4"]["convl"])
    _put_conv(sd, "skip4.convs.1", p["skip4"]["convs"])
    _put_conv(sd, "skip4.fuse_conv.0", p["skip4"]["fuse_conv"])
    _put_bn(sd, "skip4.fuse_conv.1", p["skip4"]["fuse_bn"], _sub(_sub(s, "skip4"), "fuse_bn"))
    for i in range(1, 5):
        _put_natt(sd, f"natt{i}", p[f"natt{i}"])
    _put_conv(sd, "output_layer", p["output_layer"])
    return sd

"""Serving engine: the LM-Net deploy forward as a pure function over the
deploy state dict, and ``serving_evaluate`` over a loader.

Counterpart of ``lmnet_tpu/serve/engine.py`` (``deploy_forward``,
``serving_evaluate``). Take a train-mode ``LMNet`` state dict,
``structural_reparam`` it, and call ``deploy_forward``. NAT runs through the
CUDA kernel (``nat_backend='flat'``) on the card; everything else is plain
torch. Dtypes follow the JAX engine: the activations carry the compute dtype
(bf16 when serving), every weight is cast to it at its op, BatchNorm's
scale is formed in float32 first, and the SE squeeze stays in the compute
dtype.

Left out here: the int8 NATT interiors, LN folding, composed skips, the
backend autotune and the device mesh (all off by default in JAX), and the
'pallas'/'flat' ReparamConv kernels (``rc_backend='xla'`` is the plain torch
block).
"""

from __future__ import annotations

from typing import Iterable, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from lmnet_tpu_torch.data.augment import eval_pipeline
from lmnet_tpu_torch.losses.losses import cross_entropy_loss
from lmnet_tpu_torch.metrics.confusion import (
    ConfusionAccumulator,
    confusion_matrix,
    derived_metrics,
)
from lmnet_tpu_torch.models.blocks import (
    BN_EPS,
    LN_EPS,
    conv_nhwc,
    gelu,
    global_attention_core,
    nat,
)
from lmnet_tpu_torch.models.lm_net import structural_reparam
from lmnet_tpu_torch.ops.resize import adaptive_avg_pool, upsample2x_align_corners

Tensors = Mapping[str, torch.Tensor]


def _conv(sd: Tensors, name: str, x, stride: int = 1, groups: int = 1):
    return conv_nhwc(x, sd[f"{name}.weight"], sd.get(f"{name}.bias"), stride, groups)


def _bn(sd: Tensors, name: str, x):
    inv = sd[f"{name}.weight"] / torch.sqrt(sd[f"{name}.running_var"] + BN_EPS)
    shift = sd[f"{name}.bias"] - sd[f"{name}.running_mean"] * inv
    return x * inv.to(x.dtype) + shift.to(x.dtype)


def _ln(sd: Tensors, name: str, x):
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + LN_EPS)
    return y * sd[f"{name}.weight"].to(x.dtype) + sd[f"{name}.bias"].to(x.dtype)


def _dense(sd: Tensors, name: str, x, rows: slice = slice(None)):
    """x @ W[rows].T + b[rows]; ``rows`` slices the output features."""
    w = sd[f"{name}.weight"][rows]
    return F.linear(x, w.to(x.dtype), sd[f"{name}.bias"][rows].to(x.dtype))


def _mlp(sd: Tensors, name: str, x):
    return _dense(sd, f"{name}.fc2", gelu(_dense(sd, f"{name}.fc1", x)))


def _m2skip(sd: Tensors, name: str, xl, xs, mode: str):
    if mode == "bottom":
        a = _conv(sd, f"{name}.convl.0", xl, 2)
        b = _conv(sd, f"{name}.convs.0", xs)
    else:
        a = _conv(sd, f"{name}.convl.0", xl)
        b = _conv(sd, f"{name}.convs.1", upsample2x_align_corners(xs))
    fused = _conv(sd, f"{name}.fuse_conv.0", torch.cat([a, b], dim=-1))
    return gelu(_bn(sd, f"{name}.fuse_conv.1", fused))


def _m3skip(sd: Tensors, name: str, xl, xm, xs):
    a = _conv(sd, f"{name}.convl.0", xl, 2)
    b = _conv(sd, f"{name}.convm.0", xm)
    c = _conv(sd, f"{name}.convs.1", upsample2x_align_corners(xs))
    fused = _conv(sd, f"{name}.fuse_conv.0", torch.cat([a, b, c], dim=-1))
    return gelu(_bn(sd, f"{name}.fuse_conv.1", fused))


def _gft(sd: Tensors, x, num_heads: int):
    B, H, W, _ = x.shape
    emb = _conv(sd, "gft.patchembedding.patch_embeddings", x).reshape(B, H * W, -1)
    qkv = _dense(sd, "gft.attention.qkv", _ln(sd, "gft.norm1", emb))
    att = _dense(sd, "gft.attention.proj", global_attention_core(qkv, num_heads)) + emb
    out = _mlp(sd, "gft.mlp", _ln(sd, "gft.norm2", att)) + att
    return _conv(sd, "gft.conv.0", out.reshape(B, H, W, -1))


def _natt(sd: Tensors, name: str, x, num_heads: int, nat_backend: str):
    emb = _conv(sd, f"{name}.patchembedding.patch_embeddings", x)
    C = emb.shape[-1]
    ln1 = _ln(sd, f"{name}.norm1", emb)
    # weight-sliced qkv: three contiguous outputs that reshape to the flat
    # NAT layout without a copy
    q, k, v = (
        _dense(sd, f"{name}.att1.qkv", ln1, slice(i * C, (i + 1) * C)) for i in range(3)
    )
    out = nat(q, k, v, sd[f"{name}.att1.rpb"], num_heads, nat_backend)
    att = _dense(sd, f"{name}.att1.proj", out) + emb
    return _mlp(sd, f"{name}.mlp", _ln(sd, f"{name}.norm2", att)) + att


def _rc(sd: Tensors, name: str, h):
    """Deploy ReparamConv: expand + BN + hardswish -> fused 5x5 depthwise +
    GELU -> SE -> pointwise + shortcut."""
    e = F.hardswish(_bn(sd, f"{name}.expand_conv.1", _conv(sd, f"{name}.expand_conv.0", h)))
    t = gelu(_conv(sd, f"{name}.fuse_conv", e, groups=e.shape[-1]))
    # the SE squeeze stays in the compute dtype (float32 SE weights would
    # promote t, and every later block, to float32)
    m = t.mean(dim=(1, 2), keepdim=True)
    w1 = sd[f"{name}.se.fc1.weight"].flatten(1)
    w2 = sd[f"{name}.se.fc2.weight"].flatten(1)
    m = F.relu(F.linear(m, w1.to(m.dtype), sd[f"{name}.se.fc1.bias"].to(m.dtype)))
    sc = F.hardsigmoid(F.linear(m, w2.to(m.dtype), sd[f"{name}.se.fc2.bias"].to(m.dtype)))
    return _conv(sd, f"{name}.pointwise_conv.0", t * sc) + _conv(sd, f"{name}.shortcut.0", h)


def deploy_forward(
    variables: Tensors,
    x: torch.Tensor,
    num_heads: int = 12,
    nat_backend: str | tuple = "flat",
    rc_backend: str = "xla",
) -> torch.Tensor:
    """Deploy-mode forward: NHWC ``x`` -> float32 NHWC logits.

    ``variables``: the ``structural_reparam`` output, on x's device.
    ``nat_backend``: 'flat' (the CUDA kernel on a CUDA tensor) or 'plain',
    or a 4-tuple giving it per NAT stage (natt1 .. natt4, deepest first).
    ``rc_backend``: 'xla' only (the plain torch ReparamConv; the name is the
    JAX engine's).
    """
    if rc_backend != "xla":
        raise ValueError(f"rc_backend {rc_backend!r} is not ported; use 'xla'")
    nb = nat_backend if isinstance(nat_backend, tuple) else (nat_backend,) * 4
    if len(nb) != 4:
        raise ValueError(f"nat_backend tuple needs 4 entries, got {nb}")
    sd = variables

    def rc2(stage, h):
        return _rc(sd, f"{stage}.1", _rc(sd, f"{stage}.0", h))

    x1 = rc2("conv1", x)
    xd1 = _conv(sd, "down1.0", x1, 2)
    x2 = rc2("conv2", xd1)
    xd2 = _conv(sd, "down2.0", x2, 2)
    x3 = rc2("conv3", xd2)
    xd3 = _conv(sd, "down3.0", x3, 2)
    x4 = rc2("conv4", xd3)
    xd4 = _conv(sd, "down4.0", x4, 2)

    h, w = xd4.shape[1], xd4.shape[2]
    pooled = torch.cat([adaptive_avg_pool(t, (h, w)) for t in (x1, x2, x3, x4)] + [xd4], dim=-1)
    x5 = _gft(sd, pooled, num_heads)

    s1 = _m2skip(sd, "skip1", x3, x4, "bottom")
    s2 = _m3skip(sd, "skip2", x2, x3, x4)
    s3 = _m3skip(sd, "skip3", x1, x2, x3)
    s4 = _m2skip(sd, "skip4", x1, x2, "top")

    x46 = _natt(sd, "natt1", s1, num_heads, nb[0])
    x37 = _natt(sd, "natt2", s2, num_heads, nb[1])
    x28 = _natt(sd, "natt3", s3, num_heads, nb[2])
    x19 = _natt(sd, "natt4", s4, num_heads, nb[3])

    def up(name, h_):
        return _conv(sd, f"{name}.1", upsample2x_align_corners(h_))

    x6 = rc2("dconv1", up("up1", x5) + x46)
    x7 = rc2("dconv2", up("up2", x6) + x37)
    x8 = rc2("dconv3", up("up3", x7) + x28)
    x9 = rc2("dconv4", up("up4", x8) + x19)
    return _conv(sd, "output_layer", x9).float()


def serving_evaluate(
    state: Tensors,
    loader: Iterable[tuple[np.ndarray, np.ndarray]],
    num_classes: int = 2,
    img_size: int = 256,
    nat_backend: str | tuple = "flat",
    rc_backend: str = "xla",
    num_heads: int = 12,
    task: str = "binary",
) -> tuple[float, dict[str, float]]:
    """Evaluate a train-mode state dict through the serving path: reparam
    once, then ``deploy_forward`` in bf16 over the loader's (uint8 images,
    uint8 masks) numpy batches, on the device the state lives on.

    Returns (summed per-batch CE loss, derived metrics), as the JAX engine.
    """
    deploy = structural_reparam(state)
    device = next(iter(deploy.values())).device
    cm = ConfusionAccumulator.init(num_classes, device)
    total = torch.zeros((), dtype=torch.float32, device=device)
    with torch.inference_mode():
        for images, masks in loader:
            x, y = eval_pipeline(
                torch.from_numpy(images).to(device), torch.from_numpy(masks).to(device),
                out_size=img_size,
            )
            logits = deploy_forward(
                deploy, x.to(torch.bfloat16), num_heads=num_heads,
                nat_backend=nat_backend, rc_backend=rc_backend,
            )
            total += cross_entropy_loss(logits, y, (1.0, 4.0), 0.001)
            cm += confusion_matrix(logits.argmax(dim=-1), y, num_classes)
    metrics = {k: float(v) for k, v in derived_metrics(cm, task).items()}
    return float(total), metrics

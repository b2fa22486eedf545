"""PyTorch building blocks for LM-Net, NHWC at every forward.

Counterpart of ``lmnet_tpu/models/blocks.py``, for the eval forward and the
train-mode parameter tree. Module attribute names follow the reference
PyTorch model (``conv1.0.expand_conv.0``, ``natt1.att1.qkv``,
``gft.attention.qkv``, ...), so a state dict converted from the JAX
variables (``lmnet_tpu_torch/convert.py``) loads with ``strict=True``.

Conv weights are stored OIHW as in ``nn.Conv2d``; every conv runs on an NCHW
view of the NHWC activation (a permute, no copy). BatchNorm runs on its
running statistics (eval mode). GELU is the tanh form by default, as in the
JAX package (``LMNet.gelu_exact=False``); the erf form is not ported yet.

Parameters are created empty; ``init_`` fills each leaf from an explicit
``torch.Generator`` with the JAX package's init families: torch's
kaiming-uniform fan-in for convs and linears, kaiming-normal for the SE
convs, truncated normal (0.02) for the attention linears and the NAT bias.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from lmnet_tpu_torch.ops.nat import neighborhood_attention
from lmnet_tpu_torch.ops.nat_flat import nat_flat
from lmnet_tpu_torch.ops.resize import adaptive_avg_pool, upsample2x_align_corners

BN_EPS = 1e-5
LN_EPS = 1e-5


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh GELU (the JAX package's default, ``gelu_exact=False``)."""
    return F.gelu(x, approximate="tanh")


def conv_nhwc(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None = None,
    stride: int = 1,
    groups: int = 1,
) -> torch.Tensor:
    """Conv of NHWC ``x`` with an OIHW ``weight``, torch k//2 padding. The
    weights are cast to the activation dtype."""
    kh, kw = weight.shape[2], weight.shape[3]
    y = F.conv2d(
        x.permute(0, 3, 1, 2), weight.to(x.dtype),
        None if bias is None else bias.to(x.dtype),
        stride, (kh // 2, kw // 2), 1, groups,
    )
    return y.permute(0, 2, 3, 1)


def _trunc_normal_(t: torch.Tensor, std: float, g: torch.Generator) -> None:
    nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=g)


class Conv(nn.Module):
    """``nn.Conv2d``'s parameters applied to NHWC tensors.

    ``init``: 'torch' (kaiming-uniform fan-in weight and bias) or
    'kaiming_normal' (fan-in, gain 2; zero bias), the SE convs' family.
    """

    def __init__(self, cin: int, cout: int, kernel_size=(3, 3), stride: int = 1,
                 groups: int = 1, bias: bool = True, init: str = "torch"):
        super().__init__()
        kh, kw = (kernel_size, kernel_size) if isinstance(kernel_size, int) else kernel_size
        self.stride = stride
        self.groups = groups
        self.init = init
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, kh, kw))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def init_(self, g: torch.Generator) -> None:
        fan_in = self.weight[0].numel()
        if self.init == "kaiming_normal":
            self.weight.normal_(0.0, math.sqrt(2.0 / fan_in), generator=g)
            if self.bias is not None:
                self.bias.zero_()
            return
        bound = 1.0 / math.sqrt(fan_in)
        self.weight.uniform_(-bound, bound, generator=g)
        if self.bias is not None:
            self.bias.uniform_(-bound, bound, generator=g)

    def forward(self, x):
        return conv_nhwc(x, self.weight, self.bias, self.stride, self.groups)


class Dense(nn.Module):
    """``nn.Linear``'s parameters; ``init`` 'torch' or 'trunc_normal'
    (std 0.02, zero bias)."""

    def __init__(self, din: int, dout: int, init: str = "torch"):
        super().__init__()
        self.init = init
        self.weight = nn.Parameter(torch.empty(dout, din))
        self.bias = nn.Parameter(torch.empty(dout))

    def init_(self, g: torch.Generator) -> None:
        if self.init == "trunc_normal":
            _trunc_normal_(self.weight, 0.02, g)
            self.bias.zero_()
            return
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        self.weight.uniform_(-bound, bound, generator=g)
        self.bias.uniform_(-bound, bound, generator=g)

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm over the last (channel) axis of an NHWC tensor.

    Holds exactly the reference's ``weight``, ``bias``, ``running_mean`` and
    ``running_var`` (no ``num_batches_tracked``); the variance is JAX's
    biased one."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        inv = torch.rsqrt(self.running_var + BN_EPS) * self.weight
        return ((x - self.running_mean) * inv + self.bias).to(x.dtype)


class Upsample2x(nn.Module):
    """Parameter-free 2x bilinear upsample (align_corners=True); it holds the
    reference's index 0 in ``up*``/``convs`` so the conv after it is ``.1``."""

    def forward(self, x):
        return upsample2x_align_corners(x)


class ConvBN(nn.Module):
    """A depthwise branch of ReparamConv: bias-free conv then BatchNorm."""

    def __init__(self, channels: int, kernel_size):
        super().__init__()
        self.conv = Conv(channels, channels, kernel_size, groups=channels, bias=False)
        self.bn = BatchNorm(channels)

    def forward(self, x):
        return self.bn(self.conv(x))


class SE(nn.Module):
    """Squeeze-and-excitation (reduction 4, ReLU, hard sigmoid)."""

    def __init__(self, channels: int):
        super().__init__()
        mid = channels // 4
        self.fc1 = Conv(channels, mid, 1, init="kaiming_normal")
        self.fc2 = Conv(mid, channels, 1, init="kaiming_normal")

    def forward(self, x):
        s = x.mean(dim=(1, 2), keepdim=True)
        s = F.hardsigmoid(self.fc2(F.relu(self.fc1(s))))
        return x * s


class ReparamConv(nn.Module):
    """Multi-branch depthwise block, train graph (reference
    ``core/modules.py:525-657``): 1x1 expand + BN + hardswish -> sum of four
    depthwise branches (5x5, 3x3, 3x1, 1x3; each conv+BN) -> GELU -> SE ->
    1x1 pointwise -> + 1x1 shortcut of the input. ``structural_reparam``
    fuses the branches into the deploy graph's one 5x5 depthwise conv."""

    def __init__(self, cin: int, expand: int, cout: int):
        super().__init__()
        self.expand_conv = nn.Sequential(Conv(cin, expand, 1), BatchNorm(expand))
        self.large_conv = ConvBN(expand, (5, 5))
        self.square_conv = ConvBN(expand, (3, 3))
        self.ver_conv = ConvBN(expand, (3, 1))
        self.hor_conv = ConvBN(expand, (1, 3))
        self.se = SE(expand)
        self.pointwise_conv = nn.Sequential(Conv(expand, cout, 1))
        self.shortcut = nn.Sequential(Conv(cin, cout, 1))

    def forward(self, x):
        e = F.hardswish(self.expand_conv(x))
        t = self.large_conv(e) + self.square_conv(e) + self.ver_conv(e) + self.hor_conv(e)
        t = self.se(gelu(t))
        return self.pointwise_conv(t) + self.shortcut(x)


class Mlp(nn.Module):
    """Two linears with GELU between (dropout is off in eval)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Dense(dim, hidden)
        self.fc2 = Dense(hidden, dim)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x)))


class PatchEmbed(nn.Module):
    """Overlapping 3x3 conv patch embedding (reference OverlapPatchEmbed)."""

    def __init__(self, cin: int, dim: int):
        super().__init__()
        self.patch_embeddings = Conv(cin, dim, 3)

    def forward(self, x):
        return self.patch_embeddings(x)


class GlobalAttention(nn.Module):
    """Full multi-head self-attention over (B, N, C) tokens, as an explicit
    matmul and softmax."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Dense(dim, 3 * dim, init="trunc_normal")
        self.proj = Dense(dim, dim, init="trunc_normal")

    def forward(self, x):
        return self.proj(global_attention_core(self.qkv(x), self.num_heads))


def global_attention_core(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd)) v from a fused (B, N, 3C) qkv; (B, N, C)."""
    B, N, C3 = qkv.shape
    C = C3 // 3
    hd = C // num_heads
    q, k, v = qkv.reshape(B, N, 3, num_heads, hd).permute(2, 0, 3, 1, 4)  # (B,h,N,hd)
    attn = torch.softmax((q * hd**-0.5) @ k.transpose(-1, -2), dim=-1)
    return (attn @ v).transpose(1, 2).reshape(B, N, C)


class GFT(nn.Module):
    """Global-former bottleneck: patch embed -> LN -> MHSA (+res) -> LN ->
    MLP (+res) -> 1x1 conv."""

    def __init__(self, dim: int, cout: int, num_heads: int = 12):
        super().__init__()
        self.patchembedding = PatchEmbed(dim, dim)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attention = GlobalAttention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, 2 * dim)
        self.conv = nn.Sequential(Conv(dim, cout, 1))

    def forward(self, x):
        B, H, W, _ = x.shape
        emb = self.patchembedding(x)
        tokens = emb.reshape(B, H * W, -1)
        att = self.attention(self.norm1(tokens)) + tokens
        out = self.mlp(self.norm2(att)) + att
        return self.conv(out.reshape(B, H, W, -1))


def pyramid_pool(xs: Sequence[torch.Tensor], x_last: torch.Tensor) -> torch.Tensor:
    """Adaptive-avg-pool every scale to x_last's (H, W) and concatenate the
    channels."""
    h, w = x_last.shape[1], x_last.shape[2]
    return torch.cat([adaptive_avg_pool(x, (h, w)) for x in xs] + [x_last], dim=-1)


class M2Skip(nn.Module):
    """Two-scale skip fusion. mode='bottom' downsamples the larger map to
    the smaller grid; mode='top' upsamples the smaller map."""

    def __init__(self, channels: tuple[int, int], mode: str = "bottom"):
        super().__init__()
        cl, cs = channels
        if mode == "bottom":
            cout = cs
            self.convl = nn.Sequential(Conv(cl, cout, 3, stride=2))
            self.convs = nn.Sequential(Conv(cs, cout, 3))
        elif mode == "top":
            cout = cl
            self.convl = nn.Sequential(Conv(cl, cout, 3))
            self.convs = nn.Sequential(Upsample2x(), Conv(cs, cout, 3))
        else:
            raise ValueError(f"mode must be 'bottom' or 'top', not {mode!r}")
        self.fuse_conv = nn.Sequential(Conv(2 * cout, cout, 3), BatchNorm(cout))

    def forward(self, xl, xs):
        return gelu(self.fuse_conv(torch.cat([self.convl(xl), self.convs(xs)], dim=-1)))


class M3Skip(nn.Module):
    """Three-scale skip fusion: downsample the large scale, 3x3 the middle,
    upsample the small; concatenate; 3x3 + BN + GELU."""

    def __init__(self, channels: tuple[int, int, int]):
        super().__init__()
        cl, cm, cs = channels
        self.convl = nn.Sequential(Conv(cl, cm, 3, stride=2))
        self.convm = nn.Sequential(Conv(cm, cm, 3))
        self.convs = nn.Sequential(Upsample2x(), Conv(cs, cm, 3))
        self.fuse_conv = nn.Sequential(Conv(3 * cm, cm, 3), BatchNorm(cm))

    def forward(self, xl, xm, xs):
        x = torch.cat([self.convl(xl), self.convm(xm), self.convs(xs)], dim=-1)
        return gelu(self.fuse_conv(x))


class NeighborhoodAttention2D(nn.Module):
    """NAT layer (kernel 3): qkv and proj linears around neighborhood
    attention with a relative position bias (the NATTEN module's
    parameters). Runs ``ops/nat_flat.py``: the CUDA kernel on a CUDA
    tensor, the plain version on a CPU one."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Dense(dim, 3 * dim)
        self.proj = Dense(dim, dim)
        self.rpb = nn.Parameter(torch.empty(num_heads, 5, 5))

    def init_(self, g: torch.Generator) -> None:
        _trunc_normal_(self.rpb, 0.02, g)

    def forward(self, x):
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        return self.proj(nat(q, k, v, self.rpb, self.num_heads, "flat"))


def nat(q, k, v, rpb, num_heads: int, backend: str):
    """Neighborhood attention (kernel 3) on NHWC q, k, v: backend 'flat'
    (``ops/nat_flat.py``) or 'plain' (``ops/nat.py``)."""
    if backend == "flat":
        B, H, W, C = q.shape
        flat = (B, H, W * C)
        return nat_flat(
            q.reshape(flat), k.reshape(flat), v.reshape(flat), rpb, num_heads, C, W
        ).reshape(B, H, W, C)
    if backend == "plain":
        return neighborhood_attention(q, k, v, rpb, 3)
    raise ValueError(f"nat backend must be 'flat' or 'plain', not {backend!r}")


class NeighborhoodTransformer(nn.Module):
    """NAT block: patch embed -> LN -> NAT (+res on the embedding) -> LN ->
    MLP (+res)."""

    def __init__(self, dim: int, num_heads: int = 12):
        super().__init__()
        self.patchembedding = PatchEmbed(dim, dim)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.att1 = NeighborhoodAttention2D(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, 2 * dim)

    def forward(self, x):
        emb = self.patchembedding(x)
        att = self.att1(self.norm1(emb)) + emb
        return self.mlp(self.norm2(att)) + att

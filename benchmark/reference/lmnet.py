"""LM-Net in plain PyTorch, float32: the reference the benchmark holds the
port against.

The graph of the LM-Net paper's code (github.com/Asunatan/LM-Net,
``core/LM_Net.py:5-123``): four encoder stages of two ReparamConv blocks
and a 3x3 stride-2 conv (filters 12/24/48/96, bottleneck 192); a pyramid
pool and the GFT global-attention block at the bottleneck; two- and
three-scale skips feeding four neighbourhood-attention (NAT, kernel 3)
blocks; a decoder of 2x bilinear upsamples (align_corners) and 3x3 convs
with additive skips and two ReparamConv blocks a stage; a 1x1 head.
Inputs and logits are NHWC. GELU is the tanh form, as the port's default.

Written from the model's equations, it imports nothing of the program. It
works on a state dict of float32 tensors under the reference model's
names, the raw train-mode weights: the deploy graph's 5x5 kernels are
folded here (``fold``), and the train-mode branches are computed as four
convs with their BatchNorms.

``q`` is a rounding applied to every weight at its use and to every
activation an op produces (identity for the float32 reference). The
benchmark's control passes ``lmbench.check.fp8_round``, a per-tensor scaled
e4m3 rounding with a straight-through gradient: the reference computed in
the precision below the port's bf16. The loss, AdamW and the schedule are
``reference/train.py``'s, which every architecture shares.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from reference import train as recipe

BN_EPS = 1e-5
LN_EPS = 1e-5
DROPOUT = 0.1
BRANCHES = (("large", 5, 5), ("square", 3, 3), ("ver", 3, 1), ("hor", 1, 3))


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


# ---------------------------------------------------------------------------
# names and shapes


def param_specs(num_classes: int = 2, filters=(12, 24, 48, 96, 192),
                num_heads: int = 12) -> list[tuple[str, tuple, str, int]]:
    """Every entry of the model's state dict in order: (name, shape, kind,
    fan_in). Kinds: 'w' (conv or linear weight), 'b' (its bias), 'w_att' /
    'b_att' (attention linears), 'w_se' (SE convs), 'bn_w', 'bn_b',
    'bn_mean', 'bn_var', 'ln_w', 'ln_b', 'rpb'."""
    f = tuple(filters)
    out: list[tuple[str, tuple, str, int]] = []

    def conv(name, cin, cout, kh, kw=None, groups=1, bias=True, kind="w"):
        kw = kh if kw is None else kw
        fan = cin // groups * kh * kw
        out.append((f"{name}.weight", (cout, cin // groups, kh, kw), kind, fan))
        if bias:
            out.append((f"{name}.bias", (cout,), "b", fan))

    def dense(name, din, dout, kind="w"):
        out.append((f"{name}.weight", (dout, din), kind, din))
        out.append((f"{name}.bias", (dout,), "b_att" if kind == "w_att" else "b", din))

    def bn(name, c):
        for key, kind in (("weight", "bn_w"), ("bias", "bn_b"), ("running_mean", "bn_mean"),
                          ("running_var", "bn_var")):
            out.append((f"{name}.{key}", (c,), kind, 1))

    def ln(name, c):
        out.append((f"{name}.weight", (c,), "ln_w", 1))
        out.append((f"{name}.bias", (c,), "ln_b", 1))

    def rc(name, cin, e, cout):
        conv(f"{name}.expand_conv.0", cin, e, 1)
        bn(f"{name}.expand_conv.1", e)
        for br, kh, kw in BRANCHES:
            conv(f"{name}.{br}_conv.conv", e, e, kh, kw, groups=e, bias=False)
            bn(f"{name}.{br}_conv.bn", e)
        conv(f"{name}.se.fc1", e, e // 4, 1, kind="w_se")
        conv(f"{name}.se.fc2", e // 4, e, 1, kind="w_se")
        conv(f"{name}.pointwise_conv.0", e, cout, 1)
        conv(f"{name}.shortcut.0", cin, cout, 1)

    def rc2(name, cin, e, cout):
        rc(f"{name}.0", cin, e, cout)
        rc(f"{name}.1", cout, e, cout)

    def natt(name, dim):
        conv(f"{name}.patchembedding.patch_embeddings", dim, dim, 3)
        ln(f"{name}.norm1", dim)
        out.append((f"{name}.att1.rpb", (num_heads, 5, 5), "rpb", 1))
        dense(f"{name}.att1.qkv", dim, 3 * dim)
        dense(f"{name}.att1.proj", dim, dim)
        ln(f"{name}.norm2", dim)
        dense(f"{name}.mlp.fc1", dim, 2 * dim)
        dense(f"{name}.mlp.fc2", 2 * dim, dim)

    rc2("conv1", 3, f[1], f[0])
    conv("down1.0", f[0], f[1], 3)
    rc2("conv2", f[1], f[2], f[1])
    conv("down2.0", f[1], f[2], 3)
    rc2("conv3", f[2], f[3], f[2])
    conv("down3.0", f[2], f[3], 3)
    rc2("conv4", f[3], f[4], f[3])
    conv("down4.0", f[3], f[4], 3)
    d = sum(f)
    conv("gft.patchembedding.patch_embeddings", d, d, 3)
    ln("gft.norm1", d)
    dense("gft.attention.qkv", d, 3 * d, "w_att")
    dense("gft.attention.proj", d, d, "w_att")
    ln("gft.norm2", d)
    dense("gft.mlp.fc1", d, 2 * d)
    dense("gft.mlp.fc2", 2 * d, d)
    conv("gft.conv.0", d, f[4], 1)
    # skip1: M2 'bottom' (f2, f3); skip2, skip3: M3; skip4: M2 'top' (f0, f1)
    conv("skip1.convl.0", f[2], f[3], 3)
    conv("skip1.convs.0", f[3], f[3], 3)
    conv("skip1.fuse_conv.0", 2 * f[3], f[3], 3)
    bn("skip1.fuse_conv.1", f[3])
    for name, (cl, cm, cs) in (("skip2", (f[1], f[2], f[3])), ("skip3", (f[0], f[1], f[2]))):
        conv(f"{name}.convl.0", cl, cm, 3)
        conv(f"{name}.convm.0", cm, cm, 3)
        conv(f"{name}.convs.1", cs, cm, 3)
        conv(f"{name}.fuse_conv.0", 3 * cm, cm, 3)
        bn(f"{name}.fuse_conv.1", cm)
    conv("skip4.convl.0", f[0], f[0], 3)
    conv("skip4.convs.1", f[1], f[0], 3)
    conv("skip4.fuse_conv.0", 2 * f[0], f[0], 3)
    bn("skip4.fuse_conv.1", f[0])
    for i, dim in enumerate((f[3], f[2], f[1], f[0])):
        natt(f"natt{i + 1}", dim)
    for i, (cin, cout) in enumerate(((f[4], f[3]), (f[3], f[2]), (f[2], f[1]), (f[1], f[0]))):
        conv(f"up{i + 1}.1", cin, cout, 3)
        rc2(f"dconv{i + 1}", cout, cin, cout)
    conv("output_layer", f[0], num_classes, 1)
    return out


# ---------------------------------------------------------------------------
# the forward


def nat(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, rpb: torch.Tensor,
        heads: int) -> torch.Tensor:
    """Neighbourhood attention, kernel 3, on NHWC q, k, v (C = heads x hd):
    each query attends to the 3x3 window centred on it, slid inside the map
    at the borders, with the bias rpb[head, 2 + key - query] (a 5x5 table
    a head) added to its logits; logits scaled by hd^-1/2."""
    B, H, W, C = q.shape
    hd = C // heads
    dev = q.device
    qs = q.reshape(B, H, W, heads, hd) * hd ** -0.5
    kh, vh = k.reshape(B, H, W, heads, hd), v.reshape(B, H, W, heads, hd)
    ri, ci = torch.arange(H, device=dev), torch.arange(W, device=dev)
    r0, c0 = (ri - 1).clamp(0, H - 3), (ci - 1).clamp(0, W - 3)
    windows, logits = [], []
    for a in range(3):
        for b in range(3):
            rows, cols = r0 + a, c0 + b
            windows.append((rows, cols))
            bias = rpb.index_select(1, rows - ri + 2).index_select(2, cols - ci + 2)
            kw = kh.index_select(1, rows).index_select(2, cols)
            logits.append((qs * kw).sum(-1) + bias.permute(1, 2, 0))
    attn = torch.softmax(torch.stack(logits, dim=-1), dim=-1)
    out = 0
    for j, (rows, cols) in enumerate(windows):
        out = out + attn[..., j:j + 1] * vh.index_select(1, rows).index_select(2, cols)
    return out.reshape(B, H, W, C)


def fold(p: dict, name: str) -> tuple[torch.Tensor, torch.Tensor]:
    """A ReparamConv block's four conv + BatchNorm branches (running
    statistics) as one 5x5 depthwise kernel and bias."""
    kernel, bias = 0, 0
    for br, kh, kw in BRANCHES:
        pre = f"{name}.{br}_conv"
        g = p[f"{pre}.bn.weight"] / torch.sqrt(p[f"{pre}.bn.running_var"] + BN_EPS)
        k = p[f"{pre}.conv.weight"] * g[:, None, None, None]
        ph, pw = (5 - kh) // 2, (5 - kw) // 2
        kernel = kernel + F.pad(k, (pw, pw, ph, ph))
        bias = bias + p[f"{pre}.bn.bias"] - p[f"{pre}.bn.running_mean"] * g
    return kernel, bias


class LMNetRef:
    """The model as functions of a state dict ``p`` (name -> float32 tensor)
    and the rounding ``q``.

    ``forward(x, train=False)`` is the deploy graph: each ReparamConv's
    branches folded by ``fold``, BatchNorm on running statistics.
    ``forward(x, train=True, masks=...)`` is the train-mode graph: batch
    statistics (collected in ``self.stats`` as (BatchNorm name, mean,
    biased variance) for the running update), dropout by the given keep
    masks (``draw_masks``), and with ``remat`` every ReparamConv and NAT
    block recomputed in the backward (``torch.utils.checkpoint``), so that
    a large batch fits."""

    def __init__(self, p: dict, num_heads: int = 12,
                 q: Callable[[torch.Tensor], torch.Tensor] | None = None, remat: bool = False):
        self.p = p
        self.heads = num_heads
        self.q = q or _identity
        self.remat = remat
        self.stats: list[tuple[str, torch.Tensor, torch.Tensor]] = []

    # -- ops --------------------------------------------------------------
    def w(self, name: str) -> torch.Tensor:
        return self.q(self.p[name])

    def conv(self, x, name, stride=1, groups=1, weight=None, bias=None):
        weight = self.w(f"{name}.weight") if weight is None else self.q(weight)
        if bias is None and f"{name}.bias" in self.p:
            bias = self.w(f"{name}.bias")
        kh, kw = weight.shape[2], weight.shape[3]
        y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, stride, (kh // 2, kw // 2), 1, groups)
        return self.q(y.permute(0, 2, 3, 1))

    def dense(self, x, name, rows=slice(None)):
        return self.q(F.linear(x, self.w(f"{name}.weight")[rows], self.w(f"{name}.bias")[rows]))

    def bn(self, x, name, train, stats=None):
        if train:
            mean = x.mean(dim=(0, 1, 2))
            var = (x - mean).square().mean(dim=(0, 1, 2))
            (self.stats if stats is None else stats).append((name, mean.detach(), var.detach()))
        else:
            mean, var = self.p[f"{name}.running_mean"], self.p[f"{name}.running_var"]
        y = (x - mean) * torch.rsqrt(var + BN_EPS) * self.w(f"{name}.weight")
        return self.q(y + self.w(f"{name}.bias"))

    def ln(self, x, name):
        mean = x.mean(dim=-1, keepdim=True)
        var = (x - mean).square().mean(dim=-1, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + LN_EPS) * self.w(f"{name}.weight")
        return self.q(y + self.w(f"{name}.bias"))

    def act(self, fn, x):
        return self.q(fn(x))

    def gelu(self, x):
        return self.q(F.gelu(x, approximate="tanh"))

    def up(self, x):
        y = F.interpolate(x.permute(0, 3, 1, 2), size=(2 * x.shape[1], 2 * x.shape[2]),
                          mode="bilinear", align_corners=True)
        return self.q(y.permute(0, 2, 3, 1))

    def pool(self, x, hw):
        B, H, W, C = x.shape
        return self.q(x.reshape(B, hw[0], H // hw[0], hw[1], W // hw[1], C).mean(dim=(2, 4)))

    @staticmethod
    def drop(x, keep):
        return x if keep is None else x * keep / (1.0 - DROPOUT)

    # -- blocks -----------------------------------------------------------
    def rc(self, x, name, train):
        """One ReparamConv block; in train mode returns (out, its five
        BatchNorms' statistics), else out. The running statistics move
        toward the biased variance."""
        if not train:
            e = self.act(F.hardswish, self.bn(self.conv(x, f"{name}.expand_conv.0"),
                                              f"{name}.expand_conv.1", False))
            kernel, bias = fold(self.p, name)
            t = self.gelu(self.conv(e, name, groups=e.shape[-1], weight=kernel,
                                    bias=self.q(bias)))
            return self._tail(x, t, name)
        stats: list = []
        e = self.act(F.hardswish, self.bn(self.conv(x, f"{name}.expand_conv.0"),
                                          f"{name}.expand_conv.1", True, stats))
        s = 0
        for br, _, _ in BRANCHES:
            pre = f"{name}.{br}_conv"
            y = self.conv(e, f"{pre}.conv", groups=e.shape[-1])
            s = s + self.bn(y, f"{pre}.bn", True, stats)
        return self._tail(x, self.gelu(self.q(s)), name), stats

    def _tail(self, x, t, name):
        m = self.q(t.mean(dim=(1, 2), keepdim=True))
        m = self.act(F.relu, self.conv(m, f"{name}.se.fc1"))
        t = self.q(t * self.act(F.hardsigmoid, self.conv(m, f"{name}.se.fc2")))
        return self.q(self.conv(t, f"{name}.pointwise_conv.0") + self.conv(x, f"{name}.shortcut.0"))

    def rc2(self, stage, x, train):
        for i in range(2):
            name = f"{stage}.{i}"
            if not train:
                x = self.rc(x, name, False)
                continue
            if self.remat:
                x, stats = checkpoint(self.rc, x, name, True, use_reentrant=False)
            else:
                x, stats = self.rc(x, name, True)
            self.stats += [(n, m.detach(), v.detach()) for n, m, v in stats]
        return x

    def mlp(self, x, name, keep):
        h = self.drop(self.gelu(self.dense(x, f"{name}.fc1")), None if keep is None else keep[0])
        return self.drop(self.dense(h, f"{name}.fc2"), None if keep is None else keep[1])

    def gft(self, x, keep):
        B, H, W, _ = x.shape
        emb = self.conv(x, "gft.patchembedding.patch_embeddings").reshape(B, H * W, -1)
        qkv = self.dense(self.ln(emb, "gft.norm1"), "gft.attention.qkv")
        C = emb.shape[-1]
        hd = C // self.heads
        q, k, v = qkv.reshape(B, H * W, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        a = self.q(torch.softmax(self.q(q * hd ** -0.5 @ k.transpose(-1, -2)), dim=-1))
        o = self.q(a @ v).transpose(1, 2).reshape(B, H * W, C)
        att = self.q(self.dense(o, "gft.attention.proj") + emb)
        out = self.q(self.mlp(self.ln(att, "gft.norm2"), "gft.mlp", keep) + att)
        return self.conv(out.reshape(B, H, W, C), "gft.conv.0")

    def natt(self, x, name, keep):
        emb = self.conv(x, f"{name}.patchembedding.patch_embeddings")
        h = self.ln(emb, f"{name}.norm1")
        C = h.shape[-1]
        q, k, v = (self.dense(h, f"{name}.att1.qkv", slice(i * C, (i + 1) * C)) for i in range(3))
        a = self.q(nat(q, k, v, self.w(f"{name}.att1.rpb"), self.heads))
        att = self.q(self.dense(a, f"{name}.att1.proj") + emb)
        return self.q(self.mlp(self.ln(att, f"{name}.norm2"), f"{name}.mlp", keep) + att)

    def skip(self, name, xs, train):
        """M2 ('skip1' bottom, 'skip4' top) or M3 ('skip2', 'skip3')."""
        if name == "skip1":
            parts = [self.conv(xs[0], f"{name}.convl.0", 2), self.conv(xs[1], f"{name}.convs.0")]
        elif name == "skip4":
            parts = [self.conv(xs[0], f"{name}.convl.0"),
                     self.conv(self.up(xs[1]), f"{name}.convs.1")]
        else:
            parts = [self.conv(xs[0], f"{name}.convl.0", 2), self.conv(xs[1], f"{name}.convm.0"),
                     self.conv(self.up(xs[2]), f"{name}.convs.1")]
        y = self.conv(torch.cat(parts, dim=-1), f"{name}.fuse_conv.0")
        return self.gelu(self.bn(y, f"{name}.fuse_conv.1", train))

    def forward(self, x: torch.Tensor, train: bool = False, masks: dict | None = None):
        """float32 logits (B, H, W, classes) of NHWC ``x``; ``masks``: the
        dropout keep masks by block ('gft', 'natt1' .. 'natt4'), or None for
        no dropout."""
        masks = masks or {}
        x = self.q(x.float())
        x1 = self.rc2("conv1", x, train)
        x2 = self.rc2("conv2", self.conv(x1, "down1.0", 2), train)
        x3 = self.rc2("conv3", self.conv(x2, "down2.0", 2), train)
        x4 = self.rc2("conv4", self.conv(x3, "down3.0", 2), train)
        xd4 = self.conv(x4, "down4.0", 2)
        hw = xd4.shape[1:3]
        x5 = self.gft(torch.cat([self.pool(t, hw) for t in (x1, x2, x3, x4)] + [xd4], dim=-1),
                      masks.get("gft"))
        skips = [self.skip("skip1", (x3, x4), train), self.skip("skip2", (x2, x3, x4), train),
                 self.skip("skip3", (x1, x2, x3), train), self.skip("skip4", (x1, x2), train)]
        outs = []
        for i, s in enumerate(skips):
            name = f"natt{i + 1}"
            if train and self.remat:
                outs.append(checkpoint(self.natt, s, name, masks.get(name), use_reentrant=False))
            else:
                outs.append(self.natt(s, name, masks.get(name)))
        h = x5
        for i in range(4):
            h = self.conv(self.up(h), f"up{i + 1}.1")
            h = self.rc2(f"dconv{i + 1}", self.q(h + outs[i]), train)
        return self.conv(h, "output_layer").float()


def draw_masks(batch: int, size: int, generator: torch.Generator, device,
               filters=(12, 24, 48, 96, 192)) -> dict:
    """The dropout keep masks of one train-mode forward at ``size``^2, drawn
    from ``generator`` in the order the blocks use them: the GFT's MLP
    (after its GELU, after fc2), then natt1 .. natt4's MLPs alike; each a
    ``torch.rand`` of the activation's shape below 1 - DROPOUT."""
    f = tuple(filters)

    def pair(lead, dim):
        return tuple(torch.rand((*lead, n), generator=generator, device=device) < 1.0 - DROPOUT
                     for n in (2 * dim, dim))

    g = size // 16
    masks = {"gft": pair((batch, g * g), sum(f))}
    for i, (dim, scale) in enumerate(((f[3], 8), (f[2], 4), (f[1], 2), (f[0], 1))):
        masks[f"natt{i + 1}"] = pair((batch, size // scale, size // scale), dim)
    return masks


# ---------------------------------------------------------------------------
# training


def train_steps(p: dict, batches, generator: torch.Generator, size: int,
                q: Callable | None = None, num_heads: int = 12, filters=(12, 24, 48, 96, 192),
                epochs: int = 200, steps_per_epoch: int = 100, batch_slice=slice(None)):
    """``reference.train.train_steps`` with LM-Net's train-mode forward:
    every ReparamConv and NAT block recomputed in the backward, so that
    B=128 fits, and dropout masks from ``generator`` drawn for the whole
    batch before ``batch_slice`` takes its rows; the loss's class weights
    (1, 4). Returns (the losses, the first step's gradients, the state after
    the last step)."""

    def forward(state, x):
        masks = draw_masks(x.shape[0], size, generator, x.device, filters)
        masks = {k: tuple(m[batch_slice] for m in v) for k, v in masks.items()}
        model = LMNetRef(state, num_heads, q, remat=True)
        return model.forward(x[batch_slice], True, masks), model.stats

    return recipe.train_steps(p, batches, forward, (1.0, 4.0), epochs, steps_per_epoch,
                              batch_slice)

"""SegFormer in plain PyTorch, float32: the reference the benchmark holds
the port's ``models/segformer.py`` against.

The model of github.com/NVlabs/SegFormer (Xie et al., NeurIPS 2021,
arXiv:2105.15203): the MiT encoder of ``mmseg/models/backbones/
mix_transformer.py`` and the all-MLP head of ``mmseg/models/decode_heads/
segformer_head.py``, written from their equations. Inputs and logits are
NHWC.

* Overlapping patch embedding: 7x7 conv at stride 4, padding 3 (stage 1),
  3x3 at stride 2, padding 1 (stages 2-4); LayerNorm (eps 1e-5).
* Block: ``x = x + DropPath(Attn(LN1(x)))``, ``x = x + DropPath(MixFFN(LN2(x)))``,
  eps 1e-6. Attention: ``q = W_q x``; where sr > 1 the keys and values come
  from ``LN(Conv_{sr x sr, stride sr}(x))`` (eps 1e-5); ``softmax(q k^T /
  sqrt(d)) v`` written out, then ``W_proj``. Mix-FFN:
  ``fc2(GELU_erf(DWConv3x3(fc1(x))))``. Drop path rises linearly from 0 to
  ``drop_path`` over the blocks.
* Each stage ends in a LayerNorm (eps 1e-6).
* Head: Linear of each c_i to ``decoder_dim``, bilinear resize
  (align_corners=False) to c1's grid, concat [c4, c3, c2, c1], bias-free
  1x1 conv, BatchNorm, ReLU, Dropout2d, 1x1 conv to the classes, bilinear
  resize of the logits to the input's size.

Departures from the published model and run: the BatchNorm's running
variance moves toward the batch's *biased* variance (the port's, after
flax; torch's ``BatchNorm2d`` takes the unbiased one) and holds no
``num_batches_tracked``; drop path and Dropout2d keep with ``rand < 1 - p``
(timm's ``floor(1 - p + rand)``, the same distribution) from the generator
the program draws from, in its two draws (``draw_masks``); the head's
BatchNorm is one process's (SyncBN over 8 cards in the published run); the
training recipe is the port's (``reference/train.py``: CE with smoothing
0.001 plus Dice, AdamW at 1e-3, a cosine schedule stepped an epoch), not
SegFormer's; no sliding-window inference. The state dict is NVlabs' without
mmseg's ``backbone.`` and ``decode_head.`` prefixes.

``q`` is a rounding applied to every weight at its use and every activation
an op produces (identity for the float32 reference; the control passes
``lmbench.check.fp8_round``). ``remat``: every block and the head's
lateral and fuse part run under ``torch.utils.checkpoint`` (no change of
arithmetic), so that a B=8 step at 1024^2 fits on the card. The forward and
the training steps run with TF32 off for matrix products and cuDNN
(``no_tf32``). It imports nothing of the program.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from reference import train as recipe

BLOCK_LN_EPS = 1e-6
EMBED_LN_EPS = 1e-5
BN_EPS = 1e-5


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


class no_tf32:
    """float32 matrix products and convs without TF32 inside the block; the
    flags are restored after."""

    def __enter__(self):
        self.flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.flags


def drop_rates(m: dict) -> list[float]:
    """Each block's drop-path rate, in order: 0 .. ``drop_path``."""
    n = sum(m["depths"])
    return [m["drop_path"] * i / max(n - 1, 1) for i in range(n)]


def param_specs(m: dict) -> list[tuple[str, tuple, str, int]]:
    """Every entry of the model's state dict: (name, shape, kind, fan_in),
    kinds 'w' (conv or linear weight), 'b' (its bias), 'ln_w', 'ln_b',
    'bn_w', 'bn_b', 'bn_mean', 'bn_var'. ``m``: the configuration's
    ``model``."""
    out: list[tuple[str, tuple, str, int]] = []

    def conv(name, cin, cout, k, groups=1, bias=True):
        fan = cin // groups * k * k
        out.append((f"{name}.weight", (cout, cin // groups, k, k), "w", fan))
        if bias:
            out.append((f"{name}.bias", (cout,), "b", fan))

    def linear(name, din, dout):
        out.extend([(f"{name}.weight", (dout, din), "w", din), (f"{name}.bias", (dout,), "b", din)])

    def ln(name, dim):
        out.extend([(f"{name}.weight", (dim,), "ln_w", 1), (f"{name}.bias", (dim,), "ln_b", 1)])

    cin = 3
    for i, (dim, depth, sr) in enumerate(zip(m["embed_dims"], m["depths"], m["sr_ratios"])):
        s = i + 1
        conv(f"patch_embed{s}.proj", cin, dim, 7 if i == 0 else 3)
        ln(f"patch_embed{s}.norm", dim)
        for j in range(depth):
            b = f"block{s}.{j}"
            ln(f"{b}.norm1", dim)
            linear(f"{b}.attn.q", dim, dim)
            linear(f"{b}.attn.kv", dim, 2 * dim)
            linear(f"{b}.attn.proj", dim, dim)
            if sr > 1:
                conv(f"{b}.attn.sr", dim, dim, sr)
                ln(f"{b}.attn.norm", dim)
            ln(f"{b}.norm2", dim)
            hidden = m["mlp_ratio"] * dim
            linear(f"{b}.mlp.fc1", dim, hidden)
            conv(f"{b}.mlp.dwconv.dwconv", hidden, hidden, 3, groups=hidden)
            linear(f"{b}.mlp.fc2", hidden, dim)
        ln(f"norm{s}", dim)
        cin = dim
    D = m["decoder_dim"]
    for i, dim in enumerate(m["embed_dims"]):
        linear(f"linear_c{i + 1}.proj", dim, D)
    conv("linear_fuse.conv", len(m["embed_dims"]) * D, D, 1, bias=False)
    out.extend((f"linear_fuse.bn.{k}", (D,), kind, 1) for k, kind in (
        ("weight", "bn_w"), ("bias", "bn_b"), ("running_mean", "bn_mean"),
        ("running_var", "bn_var")))
    conv("linear_pred", D, m["num_classes"], 1)
    return out


def draw_masks(batch: int, m: dict, generator: torch.Generator, device):
    """The train-mode masks, drawn as the program draws them: one uniform
    (batch, n) draw, column j for the j-th block half (attention, then
    Mix-FFN, block by block) at a rate above 0, its path kept where u < 1 -
    rate; then (batch, 1, 1, decoder_dim) uniforms for the head's Dropout2d,
    a channel kept where u < 1 - dropout. Returns (per block: the pair of
    (batch, 1, 1, 1) keep masks or None, the head's)."""
    rates = drop_rates(m)
    n = 2 * sum(p > 0 for p in rates)
    u = torch.rand((batch, n), generator=generator, device=device)
    blocks, j = [], 0
    for p in rates:
        if p == 0:
            blocks.append(None)
            continue
        blocks.append(tuple(u[:, j + k].view(batch, 1, 1, 1) < 1.0 - p for k in range(2)))
        j += 2
    head = torch.rand((batch, 1, 1, m["decoder_dim"]), generator=generator,
                      device=device) < 1.0 - m["dropout"]
    return blocks, head


def slice_masks(masks, rows):
    blocks, head = masks
    return [None if b is None else tuple(t[rows] for t in b) for b in blocks], head[rows]


class SegFormerRef:
    """SegFormer as functions of a state dict ``p`` of float32 tensors;
    ``m`` the configuration's ``model``. The train-mode forward records the
    head BatchNorm's batch mean and biased variance in ``stats``."""

    def __init__(self, p: dict, m: dict, q: Callable | None = None, remat: bool = False):
        self.p, self.m, self.q, self.remat = p, m, q or _identity, remat
        self.stats: list = []

    def w(self, name):
        return self.q(self.p[name])

    # -- ops -----------------------------------------------------------------
    def conv(self, x, name, stride=1, padding=None, groups=1):
        w = self.w(f"{name}.weight")
        b = self.w(f"{name}.bias") if f"{name}.bias" in self.p else None
        k = w.shape[-1]
        y = F.conv2d(x.permute(0, 3, 1, 2), w, b, stride, k // 2 if padding is None else padding,
                     1, groups)
        return self.q(y.permute(0, 2, 3, 1))

    def linear(self, x, name):
        return self.q(F.linear(x, self.w(f"{name}.weight"), self.w(f"{name}.bias")))

    def ln(self, x, name, eps):
        return self.q(F.layer_norm(x, x.shape[-1:], self.w(f"{name}.weight"),
                                   self.w(f"{name}.bias"), eps))

    def resize(self, x, size):
        y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size), mode="bilinear",
                          align_corners=False)
        return self.q(y.permute(0, 2, 3, 1))

    @staticmethod
    def drop(y, p, keep):
        return y if keep is None else torch.where(keep, y / (1.0 - p), torch.zeros_like(y))

    # -- the model -----------------------------------------------------------
    def attention(self, x, b, heads, sr):
        B, H, W, C = x.shape
        d = C // heads
        q = self.linear(x, f"{b}.attn.q").reshape(B, H * W, heads, d).transpose(1, 2)
        src = x
        if sr > 1:
            src = self.ln(self.conv(x, f"{b}.attn.sr", sr, 0), f"{b}.attn.norm", EMBED_LN_EPS)
        kv = self.linear(src, f"{b}.attn.kv").reshape(B, -1, 2, heads, d).permute(2, 0, 3, 1, 4)
        scores = self.q(q @ kv[0].transpose(-1, -2) * d ** -0.5)
        o = self.q(self.q(torch.softmax(scores, dim=-1)) @ kv[1])
        return self.linear(o.transpose(1, 2).reshape(B, H, W, C), f"{b}.attn.proj")

    def mix_ffn(self, x, b):
        h = self.linear(x, f"{b}.mlp.fc1")
        h = self.conv(h, f"{b}.mlp.dwconv.dwconv", groups=h.shape[-1])
        return self.linear(self.q(F.gelu(h)), f"{b}.mlp.fc2")

    def block(self, x, b, heads, sr, rate, keep):
        keep = keep or (None, None)
        x = self.q(x + self.drop(self.attention(self.ln(x, f"{b}.norm1", BLOCK_LN_EPS), b,
                                                heads, sr), rate, keep[0]))
        y = self.mix_ffn(self.ln(x, f"{b}.norm2", BLOCK_LN_EPS), b)
        return self.q(x + self.drop(y, rate, keep[1]))

    def encoder(self, x, masks=None):
        m, rates = self.m, drop_rates(self.m)
        feats, n = [], 0
        for i, (heads, depth, sr) in enumerate(zip(m["num_heads"], m["depths"], m["sr_ratios"])):
            s = i + 1
            x = self.conv(x, f"patch_embed{s}.proj", 4 if i == 0 else 2)
            x = self.ln(x, f"patch_embed{s}.norm", EMBED_LN_EPS)
            for j in range(depth):
                keep = None if masks is None else masks[n]
                args = (f"block{s}.{j}", heads, sr, rates[n], keep)
                if self.remat:
                    x = checkpoint(self.block, x, *args, use_reentrant=False)
                else:
                    x = self.block(x, *args)
                n += 1
            x = self.ln(x, f"norm{s}", BLOCK_LN_EPS)
            feats.append(x)
        return feats

    def fuse(self, *feats):
        """Laterals, resize to c1's grid, concat [c4 .. c1], the fuse conv."""
        grid = feats[0].shape[1:3]
        lateral = []
        for i in reversed(range(len(feats))):
            y = self.linear(feats[i], f"linear_c{i + 1}.proj")
            lateral.append(y if y.shape[1:3] == grid else self.resize(y, grid))
        return self.conv(torch.cat(lateral, dim=-1), "linear_fuse.conv")

    def bn(self, x, name, train):
        if train:
            mean = x.mean(dim=(0, 1, 2))
            var = (x - mean).square().mean(dim=(0, 1, 2))
            self.stats.append((name, mean.detach(), var.detach()))
        else:
            mean, var = self.p[f"{name}.running_mean"], self.p[f"{name}.running_var"]
        y = (x - mean) * torch.rsqrt(var + BN_EPS) * self.w(f"{name}.weight")
        return self.q(y + self.w(f"{name}.bias"))

    def forward(self, x, train: bool = False, masks=None):
        """Logits (B, H, W, classes) float32 of NHWC ``x``. ``train``: the
        BatchNorm on batch statistics and, with ``masks`` (``draw_masks``),
        drop path and Dropout2d."""
        with no_tf32():
            return self._forward(x, train, masks)

    def _forward(self, x, train, masks):
        x = self.q(x.float())
        H, W = x.shape[1:3]
        feats = self.encoder(x, None if masks is None else masks[0])
        if self.remat:
            y = checkpoint(self.fuse, *feats, use_reentrant=False)
        else:
            y = self.fuse(*feats)
        y = self.q(F.relu(self.bn(y, "linear_fuse.bn", train)))
        if masks is not None:
            y = self.q(self.drop(y, self.m["dropout"], masks[1]))
        return self.resize(self.conv(y, "linear_pred"), (H, W)).float()


def train_steps(p: dict, batches, generator: torch.Generator, m: dict, q: Callable | None = None,
                epochs: int = 200, steps_per_epoch: int = 100, batch_slice=slice(None)):
    """``reference.train.train_steps`` with SegFormer's train-mode forward:
    every block and the head's fuse recomputed in the backward, the masks
    drawn from ``generator`` for the whole batch before ``batch_slice``
    takes its rows; uniform class weights. Returns (the losses, the first
    step's gradients, the state after the last step)."""

    def forward(state, x):
        masks = slice_masks(draw_masks(x.shape[0], m, generator, x.device), batch_slice)
        model = SegFormerRef(state, m, q, remat=True)
        return model.forward(x[batch_slice], True, masks), model.stats

    with no_tf32():
        return recipe.train_steps(p, batches, forward, (1.0,) * m["num_classes"], epochs,
                                  steps_per_epoch, batch_slice)

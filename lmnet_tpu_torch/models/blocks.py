"""PyTorch building blocks for LM-Net, NHWC at every forward.

Counterpart of ``lmnet_tpu/models/blocks.py``: the train-mode and eval
forward of every block. Module attribute names follow the reference PyTorch
model (``conv1.0.expand_conv.0``, ``natt1.att1.qkv``, ``gft.attention.qkv``,
...), so a state dict converted from the JAX variables
(``lmnet_tpu_torch/convert.py``) loads with ``strict=True``.

As in JAX, the mode is an argument of each forward, not ``nn.Module``'s
``training`` flag: ``train`` selects batch statistics in BatchNorm (and
updates its running statistics), ``deterministic=False`` turns on dropout,
drawn from an explicit ``torch.Generator``.

Conv weights are stored OIHW as in ``nn.Conv2d``; every conv runs on an NCHW
view of the NHWC activation (a permute, no copy). GELU is the tanh form by
default, as in the JAX package; ``gelu_exact=True`` in every block that
takes it selects the erf form (JAX's ``LMNet.gelu_exact``).

Dtypes follow flax: the activations carry the compute dtype (bf16 under
``LMNet(dtype=torch.bfloat16)``), every float32 parameter is cast to it at
its op, and BatchNorm/LayerNorm form their statistics in float32
(E[x^2] - E[x]^2, clamped at 0) and normalise in float32 before casting
back. No ``torch.autocast``: it would keep other ops in float32 than JAX.

Parameters are created empty; ``init_`` fills each leaf from an explicit
``torch.Generator`` with the JAX package's init families: torch's
kaiming-uniform fan-in for convs and linears, kaiming-normal for the SE
convs, truncated normal (0.02) for the attention linears and the NAT bias.

Inside a shard of the mesh's 'spatial' axis (``parallel/batch.py::shard``)
every map is this rank's block of rows, and each block asks
``parallel/spatial.py`` for what XLA's partitioner gives JAX: a conv takes
its kh//2 rows from the neighbours, a ReparamConv's four branches share
one exchange of 2 rows, SE's mean is the global map's, the GFT bottleneck
runs on the gathered map (``batch.whole``) and keeps its rows, NAT runs on
a slab with one row of each neighbour, and a dropout mask is cut out of the
global one. The pyramid pool stays local: each of its bins lies inside one
block.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from lmnet_tpu_torch.ops.nat import neighborhood_attention
from lmnet_tpu_torch.ops.nat_flat import nat_flat
from lmnet_tpu_torch.ops.nat_kernel import neighborhood_attention_pallas
from lmnet_tpu_torch.ops.rc_train import rc_branch_act
from lmnet_tpu_torch.ops.resize import adaptive_avg_pool, upsample2x_align_corners
from lmnet_tpu_torch.parallel.batch import current_shard, dropout_rows, moments, whole
from lmnet_tpu_torch.parallel.spatial import (
    crop,
    gather_rows,
    global_rows,
    halo,
    own_rows,
    spatial_mean,
    spatial_sum,
)
from lmnet_tpu_torch.spans import span

BN_EPS = 1e-5
LN_EPS = 1e-5
BN_MOMENTUM = 0.9  # flax convention: running = 0.9 * running + 0.1 * batch
DROPOUT = 0.1  # Mlp (reference core/modules.py:42-56)
RC_TRAIN_BACKENDS = ("auto", "xla", "fused", "packed")
NAT_BACKENDS = ("flat", "pallas", "plain")


def gelu(x: torch.Tensor, exact: bool = False) -> torch.Tensor:
    """The tanh GELU (the JAX package's default), or the erf form with
    ``exact`` (JAX's ``gelu_exact=True``)."""
    return F.gelu(x, approximate="none" if exact else "tanh")


def conv_nhwc(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None = None,
    stride: int = 1,
    groups: int = 1,
    slab: int = 0,
) -> torch.Tensor:
    """Conv of NHWC ``x`` with an OIHW ``weight``, torch k//2 padding. The
    weights are cast to the activation dtype.

    Inside a shard ``x`` is this rank's rows: the conv takes kh//2 rows of
    each neighbour (at stride 2 only the row above, since every block
    starts on an even row), pads W alone and gives exactly this rank's rows
    of the output. ``slab``: ``x`` already carries ``slab`` >= kh//2
    exchanged rows above and below."""
    kh, kw = weight.shape[2], weight.shape[3]
    ph = kh // 2
    if slab:
        x, ph = x[:, slab - ph:x.shape[1] - slab + ph], 0
    elif current_shard() is not None:
        x, ph = halo(x, ph, max(ph - stride + 1, 0)), 0
    y = F.conv2d(
        x.permute(0, 3, 1, 2), weight.to(x.dtype),
        None if bias is None else bias.to(x.dtype),
        stride, (ph, kw // 2), 1, groups,
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

    def forward(self, x, slab: int = 0):
        return conv_nhwc(x, self.weight, self.bias, self.stride, self.groups, slab)


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


def _stats(x: torch.Tensor, dims) -> tuple[torch.Tensor, torch.Tensor]:
    """flax's ``_compute_stats``: float32 mean and biased variance
    E[x^2] - E[x]^2, clamped at 0."""
    xf = x.float()
    mean = xf.mean(dim=dims)
    var = torch.clamp(xf.square().mean(dim=dims) - mean.square(), min=0.0)
    return mean, var


class BatchNorm(nn.Module):
    """BatchNorm over the last (channel) axis of an NHWC tensor, as flax's
    ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``.

    Holds exactly the reference's ``weight``, ``bias``, ``running_mean`` and
    ``running_var`` (no ``num_batches_tracked``). In train mode it
    normalises with the batch statistics and moves the running ones toward
    them with torch momentum 0.1, keeping JAX's *biased* variance (torch's
    ``F.batch_norm`` would store the unbiased one). Inside a data-parallel
    step the statistics are the global batch's (``parallel/batch.py``), as
    under JAX's mesh, so every rank's running statistics come out equal."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x, train: bool = False):
        if not train:
            return self.normalize(x, self.running_mean, self.running_var)
        y, mean, var = self.train_forward(x)
        self.update_stats(mean, var)
        return y

    def train_forward(self, x):
        """Normalise with the batch statistics; returns (y, mean, var) and
        leaves the running statistics alone."""
        mean, var = moments(x.float(), (0, 1, 2))
        return self.normalize(x, mean, var), mean, var

    def normalize(self, x, mean, var):
        inv = torch.rsqrt(var + BN_EPS) * self.weight
        return ((x - mean) * inv + self.bias).to(x.dtype)

    @torch.no_grad()
    def update_stats(self, mean, var) -> None:
        m = BN_MOMENTUM
        self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1 - m) * var)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis, as flax's ``nn.LayerNorm(epsilon=1e-5)``:
    float32 statistics, float32 normalisation, the result in x's dtype.
    Parameters are ``nn.LayerNorm``'s ``weight`` and ``bias``."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        mean, var = _stats(x, -1)
        y = (x - mean[..., None]) * (torch.rsqrt(var + LN_EPS)[..., None] * self.weight)
        return (y + self.bias).to(x.dtype)


def dropout_keep(shape, p: float, generator: torch.Generator | None,
                 device) -> torch.Tensor:
    """A dropout keep mask of ``shape``: True with probability 1 - p, drawn
    from ``generator``, which must live on ``device``. Inside a
    data-parallel step, this rank's rows of the global batch's mask
    (``parallel/batch.py::dropout_rows``)."""
    if generator is None:
        raise ValueError("dropout needs a torch.Generator (deterministic=False)")
    return dropout_rows(lambda s: torch.rand(s, generator=generator, device=device) < 1.0 - p,
                        shape)


def dropout(x: torch.Tensor, p: float, generator: torch.Generator | None,
            keep: torch.Tensor | None = None) -> torch.Tensor:
    """Inverted dropout as ``flax.linen.Dropout``: keep with probability
    1 - p, scale kept values by 1 / (1 - p). The mask is ``keep`` where the
    caller drew it already, else ``dropout_keep`` from ``generator``."""
    if keep is None:
        keep = dropout_keep(x.shape, p, generator, x.device)
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


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

    def forward(self, x, pooled=None):
        """``pooled``: the (B, 1, 1, C) global mean of x when the caller has
        it already (the fused train-mode block takes it from its kernel's
        channel sums), in x's dtype. Inside a shard the mean is the global
        map's."""
        s = spatial_mean(x) if pooled is None else pooled
        s = F.hardsigmoid(self.fc2(F.relu(self.fc1(s))))
        return x * s


class ReparamConv(nn.Module):
    """Multi-branch depthwise block, train graph (reference
    ``core/modules.py:525-657``): 1x1 expand + BN + hardswish -> sum of four
    depthwise branches (5x5, 3x3, 3x1, 1x3; each conv+BN) -> GELU -> SE ->
    1x1 pointwise -> + 1x1 shortcut of the input. ``structural_reparam``
    fuses the branches into the deploy graph's one 5x5 depthwise conv.

    ``remat`` (JAX's ``LMNet.rc_remat``): True, in train mode the block
    runs under ``torch.utils.checkpoint``, so its backward recomputes the
    block from its input instead of keeping the branch activations.
    'branches': the expand conv runs outside the checkpoint and its output
    (before BN, as JAX's ``checkpoint_name(x1, 'rc_expand')``) is kept;
    everything after it (BN, hardswish, the branches, SE, pointwise and
    shortcut) is recomputed. The checkpointed function returns its five
    batch statistics and the running statistics are updated outside it: the
    recompute during the backward would otherwise update them a second
    time.

    ``train_backend`` (JAX's ``rc_train_backend``) picks the train-mode
    branch graph; every choice computes the same function. 'auto' is
    'xla': the four branch convs and BNs in plain torch. 'fused':
    ``ops/rc_train.py::rc_branch_act``, the batch statistics from the B6
    kernel folded into one 5x5 conv run by the B5 kernel, which also gives
    the SE its channel sums (the plain graph on CPU tensors; inside an H
    shard both kernels run on the block's slab). 'packed': the
    four kernels zero-padded to 5x5 and stacked into one grouped conv.
    JAX also gates 'fused' on its TPU layout (H % 8, W * expand % 128) and
    quietly takes the branch graph elsewhere; the port takes it at every
    shape.

    ``gelu_exact``: the erf GELU after the branch sum. B5 and B6 compute
    the tanh form, so 'fused' with ``gelu_exact`` raises (JAX quietly takes
    the branch graph there).

    Every op of the block runs inside an ``lmnet.rc`` span, the recompute
    too: the span sits inside the function the checkpoint runs again in the
    backward, so with ``remat`` the backward enters ``lmnet.rc`` once more.
    """

    def __init__(self, cin: int, expand: int, cout: int, remat: bool | str = False,
                 train_backend: str = "auto", gelu_exact: bool = False):
        super().__init__()
        if train_backend not in RC_TRAIN_BACKENDS:
            raise ValueError(f"rc_train_backend must be one of {RC_TRAIN_BACKENDS}, "
                             f"not {train_backend!r}")
        if remat not in (False, True, "branches"):
            raise ValueError(f"remat takes False, True or 'branches', not {remat!r}")
        if gelu_exact and train_backend == "fused":
            raise ValueError("rc_train_backend='fused' computes the tanh GELU (the B5 and B6 "
                             "kernels); it does not take gelu_exact=True")
        self.remat = remat
        self.gelu_exact = gelu_exact
        self.train_backend = "xla" if train_backend == "auto" else train_backend
        self.expand_conv = nn.Sequential(Conv(cin, expand, 1), BatchNorm(expand))
        self.large_conv = ConvBN(expand, (5, 5))
        self.square_conv = ConvBN(expand, (3, 3))
        self.ver_conv = ConvBN(expand, (3, 1))
        self.hor_conv = ConvBN(expand, (1, 3))
        self.se = SE(expand)
        self.pointwise_conv = nn.Sequential(Conv(expand, cout, 1))
        self.shortcut = nn.Sequential(Conv(cin, cout, 1))

    def _branches(self):
        return (self.large_conv, self.square_conv, self.ver_conv, self.hor_conv)

    def _branch_convs(self, e):
        """The four branch convs of ``e``; inside a shard they share one
        exchange of 2 rows."""
        rows = 2 if current_shard() is not None else 0
        src = halo(e, rows, rows)
        return [b.conv(src, slab=rows) for b in self._branches()]

    def _tail(self, x, branches):
        t = self.se(gelu(branches[0] + branches[1] + branches[2] + branches[3],
                         self.gelu_exact))
        return self.pointwise_conv(t) + self.shortcut(x)

    def forward(self, x, train: bool = False):
        if not train:
            with span("lmnet.rc"):
                e = F.hardswish(self.expand_conv(x))
                ys = self._branch_convs(e)
                return self._tail(x, [b.bn(y) for b, y in zip(self._branches(), ys)])
        if self.remat == "branches":
            with span("lmnet.rc"):
                x1 = self.expand_conv[0](x)
            out, stats = checkpoint(self._after_expand, x, x1, use_reentrant=False,
                                    preserve_rng_state=False)
        elif self.remat:
            out, stats = checkpoint(self._train_graph, x, use_reentrant=False,
                                    preserve_rng_state=False)
        else:
            out, stats = self._train_graph(x)
        with span("lmnet.rc"):
            bns = [self.expand_conv[1]] + [b.bn for b in self._branches()]
            for bn, (mean, var) in zip(bns, stats):
                bn.update_stats(mean, var)
        return out

    def _train_graph(self, x):
        """Train-mode block on batch statistics; returns (out, the five
        (mean, var) pairs: expand BN, then the four branch BNs)."""
        with span("lmnet.rc"):
            return self._graph(x, self.expand_conv[0](x))

    def _after_expand(self, x, x1):
        """``_train_graph`` from the expand conv's output ``x1`` on."""
        with span("lmnet.rc"):
            return self._graph(x, x1)

    def _graph(self, x, x1):
        e, mean, var = self.expand_conv[1].train_forward(x1)
        e = F.hardswish(e)
        stats = [(mean.detach(), var.detach())]
        if self.train_backend == "fused":
            B, H, W, C = e.shape
            bns = [b.bn for b in self._branches()]
            t_flat, sums, mu, var = rc_branch_act(
                e.reshape(B, H, W * C), *(b.conv.weight for b in self._branches()),
                torch.stack([bn.weight for bn in bns]), torch.stack([bn.bias for bn in bns]),
                C, BN_EPS,
            )
            stats += [(mu[i], var[i]) for i in range(4)]
            # SE's mean over the global map: this rank's sums summed over the
            # spatial group (with a gradient) over the global H x W
            pooled = (spatial_sum(sums) / (global_rows(H) * W)).to(x.dtype).reshape(B, 1, 1, C)
            t = self.se(t_flat.reshape(B, H, W, C), pooled=pooled)
            return self.pointwise_conv(t) + self.shortcut(x), stats
        if self.train_backend == "packed":
            ys = self._packed_branches(e)
        else:
            ys = self._branch_convs(e)
        out = []
        for b, y in zip(self._branches(), ys):
            y, mean, var = b.bn.train_forward(y)
            out.append(y)
            stats.append((mean.detach(), var.detach()))
        return self._tail(x, out), stats

    def _packed_branches(self, e):
        """The four branch convs as one grouped conv: each kernel zero-padded
        to 5x5 (the same taps with the same centre), stacked so that group c
        gives output channels 4c .. 4c+3, one per branch."""
        C = e.shape[-1]
        packed = torch.stack([
            F.pad(b.conv.weight, ((5 - kw) // 2, (5 - kw) // 2, (5 - kh) // 2, (5 - kh) // 2))
            for b, (kh, kw) in zip(self._branches(), ((5, 5), (3, 3), (3, 1), (1, 3)))
        ], dim=1).reshape(4 * C, 1, 5, 5)
        y = conv_nhwc(e, packed, groups=C)
        y = y.reshape(*y.shape[:3], C, 4)
        return [y[..., i] for i in range(4)]


class Mlp(nn.Module):
    """Two linears with GELU between; dropout 0.1 after the GELU and after
    the second linear unless ``deterministic``."""

    def __init__(self, dim: int, hidden: int, gelu_exact: bool = False):
        super().__init__()
        self.gelu_exact = gelu_exact
        self.fc1 = Dense(dim, hidden)
        self.fc2 = Dense(hidden, dim)

    def keep_masks(self, lead_shape, generator: torch.Generator | None, device):
        """The two dropout keep masks for an input of leading shape
        ``lead_shape``, drawn from ``generator`` in the order the forward
        uses them (after the GELU, after fc2)."""
        return (dropout_keep((*lead_shape, self.fc1.weight.shape[0]), DROPOUT, generator, device),
                dropout_keep((*lead_shape, self.fc2.weight.shape[0]), DROPOUT, generator, device))

    def forward(self, x, deterministic: bool = True, generator: torch.Generator | None = None,
                keep=None):
        """``keep``: the pair ``keep_masks`` gives, where the caller drew it
        already; else, unless ``deterministic``, drawn here from
        ``generator``."""
        if not deterministic and keep is None:
            keep = self.keep_masks(x.shape[:-1], generator, x.device)
        h = gelu(self.fc1(x), self.gelu_exact)
        if keep is not None:
            h = dropout(h, DROPOUT, None, keep[0])
        y = self.fc2(h)
        if keep is not None:
            y = dropout(y, DROPOUT, None, keep[1])
        return y


class PatchEmbed(nn.Module):
    """Overlapping 3x3 conv patch embedding (reference OverlapPatchEmbed)."""

    def __init__(self, cin: int, dim: int):
        super().__init__()
        self.patch_embeddings = Conv(cin, dim, 3)

    def forward(self, x):
        return self.patch_embeddings(x)


# JAX's name for the block (its parameter is ``proj``; the state-dict name
# here stays the reference's ``patch_embeddings``)
OverlapPatchEmbed = PatchEmbed


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
    MLP (+res) -> 1x1 conv. Inside a shard every rank gathers the whole
    (H/16, W/16) map, runs the block on it (its dropout masks drawn whole)
    and keeps its own rows; the gather's backward sums the gradients."""

    def __init__(self, dim: int, cout: int, num_heads: int = 12, gelu_exact: bool = False):
        super().__init__()
        self.patchembedding = PatchEmbed(dim, dim)
        self.norm1 = LayerNorm(dim)
        self.attention = GlobalAttention(dim, num_heads)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, 2 * dim, gelu_exact)
        self.conv = nn.Sequential(Conv(dim, cout, 1))

    def forward(self, x, deterministic: bool = True, generator: torch.Generator | None = None):
        x = gather_rows(x)
        B, H, W, _ = x.shape
        with whole():
            emb = self.patchembedding(x)
            tokens = emb.reshape(B, H * W, -1)
            att = self.attention(self.norm1(tokens)) + tokens
            out = self.mlp(self.norm2(att), deterministic, generator) + att
        return self.conv(own_rows(out.reshape(B, H, W, -1)))


def pyramid_pool(xs: Sequence[torch.Tensor], x_last: torch.Tensor) -> torch.Tensor:
    """Adaptive-avg-pool every scale to x_last's (H, W) and concatenate the
    channels. Local inside a shard: each bin lies inside one block."""
    h, w = x_last.shape[1], x_last.shape[2]
    return torch.cat([adaptive_avg_pool(x, (h, w)) for x in xs] + [x_last], dim=-1)


class M2Skip(nn.Module):
    """Two-scale skip fusion. mode='bottom' downsamples the larger map to
    the smaller grid; mode='top' upsamples the smaller map."""

    def __init__(self, channels: tuple[int, int], mode: str = "bottom",
                 gelu_exact: bool = False):
        super().__init__()
        self.gelu_exact = gelu_exact
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

    def forward(self, xl, xs, train: bool = False):
        x = self.fuse_conv[0](torch.cat([self.convl(xl), self.convs(xs)], dim=-1))
        return gelu(self.fuse_conv[1](x, train), self.gelu_exact)


class M3Skip(nn.Module):
    """Three-scale skip fusion: downsample the large scale, 3x3 the middle,
    upsample the small; concatenate; 3x3 + BN + GELU."""

    def __init__(self, channels: tuple[int, int, int], gelu_exact: bool = False):
        super().__init__()
        self.gelu_exact = gelu_exact
        cl, cm, cs = channels
        self.convl = nn.Sequential(Conv(cl, cm, 3, stride=2))
        self.convm = nn.Sequential(Conv(cm, cm, 3))
        self.convs = nn.Sequential(Upsample2x(), Conv(cs, cm, 3))
        self.fuse_conv = nn.Sequential(Conv(3 * cm, cm, 3), BatchNorm(cm))

    def forward(self, xl, xm, xs, train: bool = False):
        x = torch.cat([self.convl(xl), self.convm(xm), self.convs(xs)], dim=-1)
        return gelu(self.fuse_conv[1](self.fuse_conv[0](x), train), self.gelu_exact)


class NeighborhoodAttention2D(nn.Module):
    """NAT layer (kernel 3): qkv and proj linears around neighborhood
    attention with a relative position bias (the NATTEN module's
    parameters). ``backend`` 'flat' runs ``ops/nat_flat.py`` (the CUDA
    kernels B1 and B2, forward and backward, on CUDA tensors; the plain
    version on CPU ones); 'pallas' runs ``ops/nat_kernel.py`` (the B3 forward
    kernel, the backward through the plain NAT, as JAX's 'pallas'); 'plain'
    runs ``ops/nat.py``."""

    def __init__(self, dim: int, num_heads: int, backend: str = "flat"):
        super().__init__()
        if backend not in NAT_BACKENDS:
            raise ValueError(f"nat backend must be one of {NAT_BACKENDS}, not {backend!r}")
        self.num_heads = num_heads
        self.backend = backend
        self.qkv = Dense(dim, 3 * dim)
        self.proj = Dense(dim, dim)
        self.rpb = nn.Parameter(torch.empty(num_heads, 5, 5))

    def init_(self, g: torch.Generator) -> None:
        _trunc_normal_(self.rpb, 0.02, g)

    def forward(self, x):
        # weight-sliced qkv: three contiguous outputs that reshape to the
        # flat NAT layout without a copy
        C = x.shape[-1]
        w, b = self.qkv.weight.to(x.dtype), self.qkv.bias.to(x.dtype)

        def attend(xs):
            q, k, v = (F.linear(xs, w[i * C:(i + 1) * C], b[i * C:(i + 1) * C])
                       for i in range(3))
            return nat(q, k, v, self.rpb, self.num_heads, self.backend)

        return self.proj(nat_rows(x, attend))


def nat_rows(x, attend):
    """``attend(x)``: a NAT layer's attention (kernel 3, clamped windows) on
    NHWC ``x``. Inside a shard it runs on the slab of x with one row of
    each neighbour and none past the global edges, where each window and
    its rpb offset are the global ones (every block holds >= 2 rows), so
    the kernels run unchanged; the result is cut to this rank's rows and
    the halo rows' dk and dv go home through the exchange's backward."""
    if current_shard() is not None and x.shape[1] < 2:
        raise ValueError(f"NAT on an H shard needs 2 rows a rank, this rank holds {x.shape[1]}")
    return crop(attend(halo(x, 1, 1, edges=False)), 1, 1, edges=False)


def nat(q, k, v, rpb, num_heads: int, backend: str):
    """Neighborhood attention (kernel 3) on NHWC q, k, v: backend 'flat'
    (``ops/nat_flat.py``), 'pallas' (``ops/nat_kernel.py``) or 'plain'
    (``ops/nat.py``)."""
    if backend == "flat":
        B, H, W, C = q.shape
        flat = (B, H, W * C)
        return nat_flat(
            q.reshape(flat), k.reshape(flat), v.reshape(flat), rpb, num_heads, C, W
        ).reshape(B, H, W, C)
    if backend == "pallas":
        return neighborhood_attention_pallas(q, k, v, rpb, 3)
    if backend == "plain":
        return neighborhood_attention(q, k, v, rpb, 3)
    raise ValueError(f"nat backend must be one of {NAT_BACKENDS}, not {backend!r}")


class NeighborhoodTransformer(nn.Module):
    """NAT block: patch embed -> LN -> NAT (+res on the embedding) -> LN ->
    MLP (+res).

    ``remat`` (JAX's ``LMNet.natt_remat``): in train mode the block runs
    under ``torch.utils.checkpoint`` and its backward recomputes it from its
    input. The dropout masks are drawn from the generator before the
    checkpointed region, in the order the block uses them, and passed in:
    the recompute sees the forward's masks, and the generator ends where it
    ends without ``remat`` (the checkpoint's own RNG saving covers the
    global generators only).
    """

    def __init__(self, dim: int, num_heads: int = 12, nat_backend: str = "flat",
                 gelu_exact: bool = False, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.patchembedding = PatchEmbed(dim, dim)
        self.norm1 = LayerNorm(dim)
        self.att1 = NeighborhoodAttention2D(dim, num_heads, nat_backend)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, 2 * dim, gelu_exact)

    def forward(self, x, deterministic: bool = True, generator: torch.Generator | None = None,
                train: bool = False):
        # the patch embedding keeps (B, H, W): the MLP's masks follow x's
        keep = None if deterministic else self.mlp.keep_masks(x.shape[:-1], generator, x.device)
        if self.remat and train:
            return checkpoint(self._block, x, keep, use_reentrant=False,
                              preserve_rng_state=False)
        return self._block(x, keep)

    def _block(self, x, keep):
        emb = self.patchembedding(x)
        att = self.att1(self.norm1(emb)) + emb
        return self.mlp(self.norm2(att), keep=keep) + att

"""SegFormer in PyTorch, NHWC at every forward: the Mix Transformer (MiT)
encoder and the all-MLP decode head (Xie et al., NeurIPS 2021,
arXiv:2105.15203), trained by ``train/engine.py::train_step`` as LM-Net is.

From github.com/NVlabs/SegFormer: ``mmseg/models/backbones/
mix_transformer.py`` (``mit_b5``: ``MIT_B5`` here) and ``mmseg/models/
decode_heads/segformer_head.py``. State-dict names are NVlabs' without
mmseg's ``backbone.`` / ``decode_head.`` prefixes (``patch_embed1.proj``,
``block3.17.attn.sr``, ``block1.0.mlp.dwconv.dwconv``, ``norm4``,
``linear_c1.proj``, ``linear_fuse.conv``, ``linear_fuse.bn``,
``linear_pred``); the BatchNorm holds no ``num_batches_tracked``.

* Overlapping patch embedding: a 7x7 stride-4 conv (stage 1) or a 3x3
  stride-2 conv, then LayerNorm (eps 1e-5).
* Block: ``x + DropPath(Attn(LN(x)))``, then ``x + DropPath(MixFFN(LN(x)))``,
  both LayerNorms eps 1e-6. Drop path rises linearly from 0 to
  ``drop_path`` over all blocks.
* Efficient self-attention: q over all N tokens; keys and values from
  ``LN(Conv_{sr x sr, stride sr}(x))`` (M = N / sr^2 tokens; eps 1e-5) where
  sr > 1, else from x; ``softmax(q k^T / sqrt(d)) v`` through
  ``F.scaled_dot_product_attention``, on a card restricted to the flash and
  memory-efficient kernels (a fall-back to the math path raises); then
  ``proj``. The reduction conv is the conv with padding 0 (cuDNN on an NHWC
  view), not a patchify and ``Dense``: it reads x once where the patchify
  copies it first, takes any H and W, and was no slower (forward and
  backward at B=8 on an H100: 1.12-1.21 ms against 1.25-1.55 at stage 1,
  the two within their run-to-run spread at stages 2 and 3).
* Mix-FFN: ``fc2(GELU_erf(DWConv3x3(fc1(x))))``, hidden ``mlp_ratio`` x C,
  the depthwise conv with a bias.
* Each stage ends in a LayerNorm (eps 1e-6) and yields c1 .. c4.
* All-MLP head: each c_i through a Linear to ``decoder_dim``, resized
  bilinearly (align_corners=False) to c1's grid, concatenated as
  [c4, c3, c2, c1]; a bias-free 1x1 conv, BatchNorm (the port's: biased
  running variance, momentum 0.1) and ReLU; Dropout2d; a 1x1 conv to the
  classes; the logits resized bilinearly to the input's size.

As ``LMNet``: parameters are float32, the activations carry ``dtype`` (bf16
is the CLI's ``--apm``) and every parameter is cast at its op; LayerNorm
and BatchNorm are ``models/blocks.py``'s. ``forward(x, train, generator)``:
in train mode BatchNorm takes the batch statistics and drop path and
Dropout2d are on, their masks from uniforms drawn from ``generator`` in
two calls (``SegFormer.draw``).

Training on a card: the train-mode forward and its backward replay CUDA
graphs, a forward and a backward graph a part (``SegFormer.parts``, and the
head), captured in one memory pool at the first call for an input shape
(``_capture``). Eagerly, a B=8 step at 1024^2 issues some 10^4 launches and
the host sets the pace (17 img/s on an H100, 10 % apart between runs);
replayed, the card does (20.5 img/s). Each replay is launched inside its
part's span, so the spans hold its kernels. No graphs on the CPU, without
gradients, or inside a global batch or an H shard (their collectives).

Spans: ``segformer.embed`` (4 a forward: patch embedding and its
LayerNorm), ``segformer.attn`` (one a block: LN, attention, drop path and
residual), ``segformer.ffn`` (one a block, the same for Mix-FFN) and
``segformer.head`` (1: the head, the final resize and ``.float()``
included); the four stage-end LayerNorms sit under none.
"""

from __future__ import annotations

import contextlib
import functools
import math
import weakref

import torch
import torch.nn as nn
import torch.nn.functional as F

from lmnet_tpu_torch.models.blocks import (
    BatchNorm,
    Conv,
    Dense,
    LayerNorm,
    dropout,
    gelu,
)
from lmnet_tpu_torch.parallel.batch import current_shard, dropout_rows, sum_group
from lmnet_tpu_torch.spans import span

MIT_B5 = {"embed_dims": (64, 128, 320, 512), "num_heads": (1, 2, 5, 8),
          "depths": (3, 6, 40, 3), "sr_ratios": (8, 4, 2, 1)}
BLOCK_LN_EPS = 1e-6  # the blocks' and the stage ends' LayerNorms
EMBED_LN_EPS = 1e-5  # the patch embeddings' and the reduction's (nn.LayerNorm's default)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v of (B, heads, N, d) q and (B, heads, M, d)
    k, v. On a card only the flash and memory-efficient SDPA kernels may run
    (a shape or dtype neither takes raises); on the CPU whichever SDPA
    picks."""
    if q.is_cuda:
        from torch.nn.attention import SDPBackend, sdpa_kernel

        with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]):
            return F.scaled_dot_product_attention(q, k, v)
    return F.scaled_dot_product_attention(q, k, v)


def resize(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resize (align_corners=False) of NHWC ``x`` to ``size``."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size), mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1)


class OverlapPatchEmbed(nn.Module):
    def __init__(self, cin: int, dim: int, kernel: int, stride: int):
        super().__init__()
        self.proj = Conv(cin, dim, kernel, stride=stride)
        self.norm = LayerNorm(dim, EMBED_LN_EPS)

    def forward(self, x):
        return self.norm(self.proj(x))


class EfficientSelfAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, sr_ratio: int):
        super().__init__()
        self.num_heads, self.sr_ratio = num_heads, sr_ratio
        self.q = Dense(dim, dim, init="trunc_normal")
        self.kv = Dense(dim, 2 * dim, init="trunc_normal")
        self.proj = Dense(dim, dim, init="trunc_normal")
        if sr_ratio > 1:
            self.sr = Conv(dim, dim, sr_ratio, stride=sr_ratio, padding=0)
            self.norm = LayerNorm(dim, EMBED_LN_EPS)

    def forward(self, x):
        B, H, W, C = x.shape
        h = self.num_heads
        q = self.q(x).reshape(B, H * W, h, C // h).transpose(1, 2)
        src = self.norm(self.sr(x)) if self.sr_ratio > 1 else x
        k, v = self.kv(src).reshape(B, -1, 2, h, C // h).permute(2, 0, 3, 1, 4)
        return self.proj(attention(q, k, v).transpose(1, 2).reshape(B, H, W, C))


class DWConv(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = Conv(dim, dim, 3, groups=dim)

    def forward(self, x):
        return self.dwconv(x)


class MixFFN(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Dense(dim, hidden, init="trunc_normal")
        self.dwconv = DWConv(hidden)
        self.fc2 = Dense(hidden, dim, init="trunc_normal")

    def forward(self, x):
        return self.fc2(gelu(self.dwconv(self.fc1(x)), exact=True))


class Block(nn.Module):
    """One MiT block; ``drop_path`` is its rate."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int, sr_ratio: int,
                 drop_path: float):
        super().__init__()
        self.drop_path = drop_path
        self.norm1 = LayerNorm(dim, BLOCK_LN_EPS)
        self.attn = EfficientSelfAttention(dim, num_heads, sr_ratio)
        self.norm2 = LayerNorm(dim, BLOCK_LN_EPS)
        self.mlp = MixFFN(dim, mlp_ratio * dim)

    def _residual(self, x, y, u):
        """``x + DropPath(y)``, the path kept where the uniform ``u`` (one an
        image) lies under 1 - rate."""
        if u is None:
            return x + y
        return x + dropout(y, self.drop_path, None, u < 1.0 - self.drop_path)

    def attn_residual(self, x, u=None):
        """``x + DropPath(Attn(LN1(x)))``."""
        return self._residual(x, self.attn(self.norm1(x)), u)

    def ffn_residual(self, x, u=None):
        """``x + DropPath(MixFFN(LN2(x)))``."""
        return self._residual(x, self.mlp(self.norm2(x)), u)


class MLP(nn.Module):
    """The head's per-scale Linear (NVlabs' ``MLP``: one ``proj``)."""

    def __init__(self, din: int, dout: int):
        super().__init__()
        self.proj = Dense(din, dout, init="trunc_normal")

    def forward(self, x):
        return self.proj(x)


class ConvModule(nn.Module):
    """mmcv's ``ConvModule`` of the head: a bias-free 1x1 conv, BatchNorm,
    ReLU."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = Conv(cin, cout, 1, bias=False)
        self.bn = BatchNorm(cout)

    def forward(self, x, train: bool = False):
        y = F.linear(x, self.conv.weight.flatten(1).to(x.dtype))
        return F.relu(self.bn(y, train))


class SegFormer(nn.Module):
    """SegFormer: the MiT encoder (``embed_dims``, ``num_heads``, ``depths``,
    ``sr_ratios``, ``mlp_ratio``; MiT-B5 by default) and the all-MLP head of
    ``decoder_dim`` channels.

    Args:
      num_classes: classes of the logits.
      drop_path: the last block's drop-path rate (0 .. drop_path over the
        blocks); dropout: the head's Dropout2d rate.
      generator: the ``torch.Generator`` every initial weight is drawn from
        (a fresh one seeded 0 when omitted), NVlabs' families: trunc-normal
        (0.02) Linears with zero bias, convs normal with std sqrt(2 /
        fan_out) and zero bias, LayerNorm and BatchNorm ones and zeros.
        Parameters are made on the CPU in float32.
      dtype: compute dtype of the activations; None keeps the input's. The
        logits come back float32.
    """

    def __init__(self, num_classes: int = 19, embed_dims=MIT_B5["embed_dims"],
                 num_heads=MIT_B5["num_heads"], depths=MIT_B5["depths"],
                 sr_ratios=MIT_B5["sr_ratios"], mlp_ratio: int = 4, decoder_dim: int = 768,
                 drop_path: float = 0.1, dropout: float = 0.1,
                 generator: torch.Generator | None = None, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype, self.dropout, self.embed_dims = dtype, dropout, tuple(embed_dims)
        self._graphs = None  # (input key, graphed parts), see _graphed
        self._slots = None  # every parameter's and buffer's (module dict, name), see _storage
        total = sum(depths)
        rates = [drop_path * i / max(total - 1, 1) for i in range(total)]
        cin = 3
        for i, (dim, heads, depth, sr) in enumerate(zip(embed_dims, num_heads, depths,
                                                        sr_ratios)):
            kernel, stride = (7, 4) if i == 0 else (3, 2)
            setattr(self, f"patch_embed{i + 1}", OverlapPatchEmbed(cin, dim, kernel, stride))
            first = sum(depths[:i])
            setattr(self, f"block{i + 1}", nn.ModuleList(
                Block(dim, heads, mlp_ratio, sr, rates[first + j]) for j in range(depth)))
            setattr(self, f"norm{i + 1}", LayerNorm(dim, BLOCK_LN_EPS))
            cin = dim
        for i, dim in enumerate(embed_dims):
            setattr(self, f"linear_c{i + 1}", MLP(dim, decoder_dim))
        self.linear_fuse = ConvModule(len(embed_dims) * decoder_dim, decoder_dim)
        self.linear_pred = Conv(decoder_dim, num_classes, 1)

        g = generator if generator is not None else torch.Generator().manual_seed(0)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, Dense):
                    m.init_(g)
                elif isinstance(m, Conv):
                    fan_out = m.weight.shape[0] * m.weight[0, 0].numel() // m.groups
                    m.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=g)
                    if m.bias is not None:
                        m.bias.zero_()

    def parts(self):
        """The encoder as parts in the order the forward runs them: (span,
        function, the modules whose parameters it uses); each function
        takes the running map and, for a block's halves at a rate above 0,
        its drop-path mask. A stage ends in its LayerNorm, under no span,
        whose output is that stage's c_i."""
        out = []
        for i in range(1, len(self.embed_dims) + 1):
            embed, norm = getattr(self, f"patch_embed{i}"), getattr(self, f"norm{i}")
            out.append(("segformer.embed", embed.forward, (embed,)))
            for blk in getattr(self, f"block{i}"):
                out.append(("segformer.attn", blk.attn_residual, (blk.norm1, blk.attn)))
                out.append(("segformer.ffn", blk.ffn_residual, (blk.norm2, blk.mlp)))
            out.append((None, norm.forward, (norm,)))
        return out

    def columns(self, plan) -> list:
        """Each part's column of the drop-path uniforms (``draw``): one a
        block half at a rate above 0, in order; None for the others."""
        cols, n = [], 0
        for _, fn, _ in plan:
            blk = getattr(fn, "__self__", None)
            if isinstance(blk, Block) and blk.drop_path > 0:
                cols.append(n)
                n += 1
            else:
                cols.append(None)
        return cols

    def draw(self, batch: int, n: int, generator, device, out=None):
        """The train-mode masks' uniforms, in this order: (batch, n), column
        j for the j-th masked block half (``columns``), its path kept where
        u < 1 - rate; then (batch, 1, 1, decoder_dim) for the head's
        Dropout2d, each channel kept where u < 1 - dropout. ``out``: two
        tensors to draw into (the graphs' static inputs); else this rank's
        rows of the global batch's draw (``dropout_rows``)."""
        shapes = ((batch, n), (batch, 1, 1, self.linear_fuse.conv.weight.shape[0]))
        if out is not None:
            return tuple(torch.rand(sh, generator=generator, device=device, out=o)
                         for sh, o in zip(shapes, out))
        return tuple(dropout_rows(lambda sh: torch.rand(sh, generator=generator, device=device),
                                  sh) for sh in shapes)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Logits, (B, H, W, num_classes) float32, from NHWC ``x``.

        ``train``: BatchNorm on batch statistics (updating the running ones),
        drop path and Dropout2d on, their uniforms drawn from ``generator``
        (on x's device) in two calls before the first part runs (``draw``).
        A train-mode forward on a card with gradients on and outside a
        global batch or shard runs every part as CUDA graphs
        (``_graphed``)."""
        if self.dtype is not None:
            x = x.to(self.dtype)
        B, H, W, _ = x.shape
        plan = self.parts()
        cols = self.columns(plan)
        n = sum(c is not None for c in cols)
        u = u_head = None
        if train and x.is_cuda and torch.is_grad_enabled() and sum_group() is None \
                and current_shard() is None:
            fns, (u, u_head) = self._graphed(x, plan, cols, n, generator)
        else:
            if train:
                u, u_head = self.draw(B, n, generator, x.device)
            fns = [fn for _, fn, _ in plan] + [functools.partial(self.head, size=(H, W),
                                                                 train=train)]
        feats = []
        for (name, _, _), fn, col in zip(plan, fns, cols):
            with span(name) if name else contextlib.nullcontext():
                x = fn(x) if u is None or col is None else fn(x, u[:, col].view(B, 1, 1, 1))
            if name is None:
                feats.append(x)
        with span("segformer.head"):
            return fns[-1](*feats) if u_head is None else fns[-1](*feats, u_head)

    def _graphed(self, x, plan, cols, n, generator):
        """The parts and the head as CUDA graphs (``_capture``), captured at
        the first call for x's shape and dtype and kept until another
        comes, or until a parameter or buffer is re-assigned or the module
        moved (the graphs read and write the old storage); refused while
        the last forward's backward is pending. The uniforms are drawn into
        their static inputs: their other inputs from a pass without
        gradients, the BatchNorm's running statistics restored after the
        warm-up. Returns (a replaying callable a part, the uniforms)."""
        B = x.shape[0]
        key = (tuple(x.shape), x.dtype, x.device, self._storage())
        if self._graphs is not None and self._graphs[0] == key:
            _, caps, u_static = self._graphs
            if any(c.pending is not None and c.pending() is not None for c in caps):
                raise RuntimeError("SegFormer's CUDA-graphed train forward ran again before the "
                                   "backward of the last; run that backward or free its graph")
            return [functools.partial(_replay, cap) for cap in caps], \
                self.draw(B, n, generator, x.device, out=u_static)
        self._graphs = None
        u, u_head = self.draw(B, n, generator, x.device)
        buffers = [(b, b.clone()) for b in self.buffers()]
        samples = []
        with torch.no_grad():
            h, feats = x, []
            for i, ((name, fn, _), col) in enumerate(zip(plan, cols)):
                args = () if col is None else (u[:, col].view(B, 1, 1, 1),)
                samples.append((h.detach().clone().requires_grad_(i > 0),) + args)
                h = fn(h, *args)
                if name is None:
                    feats.append(h)
        samples.append(tuple(f.detach().clone().requires_grad_() for f in feats) + (u_head,))
        head = functools.partial(self.head, size=tuple(x.shape[1:3]), train=True)
        head_mods = [getattr(self, f"linear_c{i + 1}") for i in range(len(feats))]
        fns = [fn for _, fn, _ in plan] + [head]
        params = [tuple(p for m in mods for p in m.parameters()) for _, _, mods in plan]
        params.append(tuple(p for m in head_mods + [self.linear_fuse, self.linear_pred]
                            for p in m.parameters()))
        caps = _capture(fns, samples, params)
        with torch.no_grad():
            for b, saved in buffers:
                b.copy_(saved)
        self._graphs = (key, caps, (u, u_head))
        return [functools.partial(_replay, cap) for cap in caps], (u, u_head)

    def _storage(self) -> tuple:
        """Which tensor every parameter and buffer is, read through the
        slots of their modules (found once), so one re-assigned after a
        capture shows: ~0.1 ms of host a step at MiT-B5, where reading
        their data pointers slowed its step by 0.4-0.9 % on an H100. A move
        or cast of the module drops the graphs (``_apply``)."""
        if self._slots is None:
            self._slots = [(d, k) for m in self.modules() for d in (m._parameters, m._buffers)
                           for k in d if d[k] is not None]
        return tuple([id(d[k]) for d, k in self._slots])

    def _apply(self, fn, *args, **kwargs):
        self._graphs = None  # they read and write the storage being replaced
        return super()._apply(fn, *args, **kwargs)

    def head(self, *feats_and_u, size, train: bool = False) -> torch.Tensor:
        """The all-MLP head on c1 .. c4 (and, in train mode, the Dropout2d
        uniforms after them): the logits at ``size``."""
        feats, u = feats_and_u[:len(self.embed_dims)], feats_and_u[len(self.embed_dims):]
        grid = feats[0].shape[1:3]
        lateral = []
        for i in reversed(range(len(feats))):
            y = getattr(self, f"linear_c{i + 1}")(feats[i])
            lateral.append(y if y.shape[1:3] == grid else resize(y, grid))
        y = self.linear_fuse(torch.cat(lateral, dim=-1), train)
        if u:  # Dropout2d: whole channels of an image
            y = dropout(y, self.dropout, None, u[0] < 1.0 - self.dropout)
        w, b = self.linear_pred.weight, self.linear_pred.bias
        y = F.linear(y, w.flatten(1).to(y.dtype), b.to(y.dtype))
        return resize(y, size).float()


class _Captured:
    """One part's forward and backward CUDA graphs and their static tensors:
    ``args`` (the part's inputs) and ``params`` in, ``out`` out; ``grad_out``
    in, ``grads`` (one a tensor of ``args`` and ``params``, None where no
    gradient) out. It holds nothing of the model but its parameters, so the
    graphs and their memory go with the model."""

    def __init__(self, args, params):
        self.args, self.params = args, params
        self.fwd, self.bwd = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        self.out = self.grad_out = self.grads = None
        self.pending = None  # the last replay's autograd node until its backward


def _capture(fns, samples, params) -> list[_Captured]:
    """``fns`` (called in this order on ``samples``, each using ``params``)
    as CUDA graphs in one memory pool, as ``torch.cuda.make_graphed_callables``
    captures them: one eager forward and backward each first, on a side
    stream (lazy initialisation stays out of the graphs), then every forward
    in order and
    every backward in reverse, so that a replay in that order reuses the
    pool as the capture did."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn, args, ps in zip(fns, samples, params):
            out = fn(*args)
            torch.autograd.grad(out, [a for a in args if a.requires_grad] + list(ps),
                                torch.zeros_like(out))
            del out  # nothing of the warm-up's graph may live on into a capture
    torch.cuda.synchronize()
    pool = torch.cuda.graph_pool_handle()
    caps = [_Captured(args, ps) for args, ps in zip(samples, params)]
    for fn, cap in zip(fns, caps):
        with torch.cuda.graph(cap.fwd, pool=pool):
            cap.out = fn(*cap.args)
    for cap in reversed(caps):
        cap.grad_out = torch.empty_like(cap.out)
        wrt = [a for a in cap.args if a.requires_grad] + list(cap.params)
        with torch.cuda.graph(cap.bwd, pool=pool):
            grads = iter(torch.autograd.grad(cap.out, wrt, cap.grad_out))
        cap.grads = tuple(next(grads) if t.requires_grad else None
                          for t in cap.args + cap.params)
    return caps


class _Replay(torch.autograd.Function):
    """A captured part in the autograd graph: the forward graph's replay on
    the inputs copied into its static ones, the backward graph's on the
    output's gradient. It keeps its autograd node on the part until the
    backward, so that ``_graphed`` can refuse a replay that would overwrite
    the static tensors a pending backward reads."""

    @staticmethod
    def forward(ctx, cap, *inputs):
        cap.pending = weakref.ref(ctx)
        for static, t in zip(cap.args, inputs):
            if static.data_ptr() != t.data_ptr():
                static.copy_(t)
        cap.fwd.replay()
        ctx.cap = cap
        return cap.out.detach()

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        cap = ctx.cap
        cap.pending = None
        if cap.grad_out.data_ptr() != grad.data_ptr():
            cap.grad_out.copy_(grad)
        cap.bwd.replay()
        return (None,) + tuple(None if g is None else g.detach() for g in cap.grads)


def _replay(cap: _Captured, *args):
    return _Replay.apply(cap, *args, *cap.params)

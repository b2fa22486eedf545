"""The mesh's 'spatial' axis inside a forward: primitives on a block of rows.

Under JAX's mesh the image H can be sharded over the 'spatial' axis, and
XLA's SPMD partitioner inserts the k//2 halo exchange of every conv and NAT
window and the all-reduce of every spatial mean
(``lmnet_tpu/parallel/mesh.py:15-20``). Torch has no partitioner, so the
port's model asks for them itself. Inside ``parallel/batch.py::shard``
every map a forward holds is this rank's block of rows of the global map:
rank ``index`` of ``size`` holds rows [index * h, (index + 1) * h) of a map
of global height size * h. Every rank holds the same number of rows,
because the image's H divides by 16 * size (``parallel/mesh.py::shards_h``),
so each of the model's five scales divides too. Then

* ``halo(x, top, bottom)`` is the slab of x with ``top`` rows of the rank
  above and ``bottom`` rows of the rank below: zeros past the global top
  and bottom (a conv's zero padding), or nothing there with
  ``edges=False`` (NAT's clamped windows); its backward sends the halo
  rows' gradients home and adds them there. ``crop`` cuts a slab's result
  back to this rank's rows;
* ``spatial_mean(x)`` is the mean over the global (H, W), with a gradient
  (SE's squeeze);
* ``gather_rows(x)`` gives every rank the whole map (the GFT bottleneck);
  its backward sums the gradients over the ranks and keeps this rank's
  rows, the adjoint of the gather;
* ``refuse_on_shard(what)`` raises for a kernel that does not take a row
  window yet (ROADMAP A8c).

Outside a shard, and inside ``batch.whole()``, ``halo`` and ``crop`` give x
back and ``spatial_mean`` is ``x.mean``: the one-process code, unchanged.

Every collective here is an ``all_reduce`` sum over the shard's group: the
one collective gloo carries for CUDA tensors as NCCL does (two ranks
sharing one card run over gloo). A halo exchange writes this rank's edge
rows into its slot of a zeroed (size, ...) float32 buffer, sums it, and
reads its neighbours' slots; a gather does the same with whole blocks. A
value plus zeros is exact, so every backend gives the same numbers.
``batch.COUNTS['halo']`` counts the exchanges, forward and backward; the
gathers and spatial sums count as all-reduces ('forward', 'backward').
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from lmnet_tpu_torch.parallel.batch import COUNTS, _AllReduceSum, current_shard

A8C = ("ROADMAP A8c: give B4-B7 a row window, halo rows in, interior rows out and sums "
       "over the interior")


def refuse_on_shard(what: str) -> None:
    """Raise NotImplementedError inside a shard: ``what`` does not run on a
    block of rows yet. Nothing gathers the image to run it whole."""
    if current_shard() is not None:
        raise NotImplementedError(f"{what} does not run on an H shard (--n_spatial > 1) yet "
                                  f"({A8C}); take the plain backend there")


def _sum(buf: torch.Tensor, group, key: str) -> torch.Tensor:
    dist.all_reduce(buf, group=group)
    COUNTS[key] += 1
    return buf


def _edge_rows(top: int, bottom: int, edges: bool, index: int, size: int) -> tuple[int, int]:
    """The rows a slab carries above and below this rank's own."""
    return (top if edges or index > 0 else 0), (bottom if edges or index < size - 1 else 0)


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index, size, top, bottom, edges):
        B, h, W, C = x.shape
        ctx.cfg = (group, index, size, top, bottom, edges, h)
        wide = torch.promote_types(x.dtype, torch.float32)
        buf = x.new_zeros((size, B, bottom + top, W, C), dtype=wide)
        buf[index, :, :bottom] = x[:, :bottom]
        buf[index, :, bottom:] = x[:, h - top:]
        _sum(buf, group, "halo")
        parts = [x]
        if index > 0:
            parts.insert(0, buf[index - 1, :, bottom:].to(x.dtype))
        elif edges and top:
            parts.insert(0, x.new_zeros((B, top, W, C)))
        if index < size - 1:
            parts.append(buf[index + 1, :, :bottom].to(x.dtype))
        elif edges and bottom:
            parts.append(x.new_zeros((B, bottom, W, C)))
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, g):
        group, index, size, top, bottom, edges, h = ctx.cfg
        t, _ = _edge_rows(top, bottom, edges, index, size)
        B, _, W, C = g.shape
        buf = g.new_zeros((size, B, top + bottom, W, C), dtype=torch.float32)
        if index > 0:  # the top halo's gradients belong to the rank above
            buf[index, :, :top] = g[:, :top]
        if index < size - 1:  # the bottom halo's to the rank below
            buf[index, :, top:] = g[:, t + h:]
        _sum(buf, group, "halo")
        gx = g[:, t:t + h].to(torch.float32, copy=True)
        if index < size - 1:
            gx[:, h - top:] += buf[index + 1, :, :top]
        if index > 0:
            gx[:, :bottom] += buf[index - 1, :, top:]
        return gx.to(g.dtype), None, None, None, None, None, None


def halo(x: torch.Tensor, top: int, bottom: int, edges: bool = True) -> torch.Tensor:
    """NHWC ``x`` (this rank's rows) with ``top`` rows of the rank above and
    ``bottom`` rows of the rank below. At the global top and bottom: zero
    rows with ``edges``, else none. Differentiable. ``x`` itself outside a
    shard."""
    s = current_shard()
    if s is None or top + bottom == 0:
        return x
    if max(top, bottom) > x.shape[1]:
        raise ValueError(f"a halo of {max(top, bottom)} rows needs as many rows a rank, "
                         f"this rank holds {x.shape[1]}")
    return _Halo.apply(x, s.group, s.index, s.size, top, bottom, edges)


def crop(y: torch.Tensor, top: int, bottom: int, edges: bool = True) -> torch.Tensor:
    """This rank's rows of ``y``, computed on ``halo(x, top, bottom,
    edges)``; ``y`` itself outside a shard."""
    s = current_shard()
    if s is None:
        return y
    t, b = _edge_rows(top, bottom, edges, s.index, s.size)
    return y[:, t:y.shape[1] - b]


def spatial_mean(x: torch.Tensor) -> torch.Tensor:
    """The (B, 1, 1, C) mean of NHWC ``x`` over H and W, in x's dtype; inside
    a shard over the global map: float32 sums all-reduced over the group,
    with a gradient."""
    s = current_shard()
    if s is None:
        return x.mean(dim=(1, 2), keepdim=True)
    total = _AllReduceSum.apply(x.float().sum(dim=(1, 2), keepdim=True), s.group)
    return (total / (x.shape[1] * s.size * x.shape[2])).to(x.dtype)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index, size):
        ctx.cfg = (group, index, x.shape[1])
        buf = x.new_zeros((size, *x.shape), dtype=torch.promote_types(x.dtype, torch.float32))
        buf[index] = x
        _sum(buf, group, "forward")
        return buf.transpose(0, 1).reshape(x.shape[0], size * x.shape[1], *x.shape[2:]).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        group, index, h = ctx.cfg
        full = _sum(g.to(torch.float32, memory_format=torch.contiguous_format, copy=True),
                    group, "backward")
        return full[:, index * h:(index + 1) * h].to(g.dtype), None, None, None


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The whole map (axis 1 the rows) on every rank of the shard, from each
    rank's block; differentiable. ``x`` itself outside a shard."""
    s = current_shard()
    if s is None:
        return x
    return _GatherRows.apply(x, s.group, s.index, s.size)


def own_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's block of rows of a whole map; ``x`` itself outside a
    shard."""
    s = current_shard()
    if s is None:
        return x
    h = x.shape[1] // s.size
    return x[:, s.index * h:(s.index + 1) * h]

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
* ``spatial_sum(t)`` is ``t`` summed over the shard's ranks, with a
  gradient (the per-rank channel sums of a kernel that runs on a row
  window); ``global_rows(h)`` the global H of a map of ``h`` local rows,
  and ``row_window(x, top, bottom)`` the slab a row-window kernel takes
  with where this rank's rows lie in it and in the global map.

A row-window kernel (B4-B7) takes a slab of ``Hs`` rows and the slab row
``top`` of its first output row; it writes ``rows`` output rows and reads
zero for a tap whose row falls outside the slab, so on a slab made with
``edges=False`` it never needs to know where the global map ends; its sums
cover the output rows alone.

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
        B, h, *rest = x.shape
        ctx.cfg = (group, index, size, top, bottom, edges, h)
        wide = torch.promote_types(x.dtype, torch.float32)
        buf = x.new_zeros((size, B, bottom + top, *rest), dtype=wide)
        buf[index, :, :bottom] = x[:, :bottom]
        buf[index, :, bottom:] = x[:, h - top:]
        _sum(buf, group, "halo")
        parts = [x]
        if index > 0:
            parts.insert(0, buf[index - 1, :, bottom:].to(x.dtype))
        elif edges and top:
            parts.insert(0, x.new_zeros((B, top, *rest)))
        if index < size - 1:
            parts.append(buf[index + 1, :, :bottom].to(x.dtype))
        elif edges and bottom:
            parts.append(x.new_zeros((B, bottom, *rest)))
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, g):
        group, index, size, top, bottom, edges, h = ctx.cfg
        t, _ = _edge_rows(top, bottom, edges, index, size)
        B, _, *rest = g.shape
        buf = g.new_zeros((size, B, top + bottom, *rest), dtype=torch.float32)
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
    """NHWC ``x`` (this rank's rows; any layout with the rows on axis 1)
    with ``top`` rows of the rank above and ``bottom`` rows of the rank
    below. At the global top and bottom: zero
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


def row_window(x: torch.Tensor, top: int, bottom: int, edges: bool = True):
    """(``halo(x, top, bottom, edges)``, the slab row of this rank's first
    row, this rank's rows, the global H, the global row of this rank's
    first row): what a row-window kernel takes. Outside a shard (x, 0, H,
    H, 0)."""
    h = x.shape[1]
    s = current_shard()
    if s is None:
        return x, 0, h, h, 0
    t, _ = _edge_rows(top, bottom, edges, s.index, s.size)
    return halo(x, top, bottom, edges), t, h, h * s.size, h * s.index


def global_rows(h: int) -> int:
    """The global H of a map of which this rank holds ``h`` rows."""
    s = current_shard()
    return h if s is None else h * s.size


def spatial_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the shard's ranks (an all-reduce with a gradient);
    ``t`` itself outside a shard."""
    s = current_shard()
    return t if s is None else _AllReduceSum.apply(t, s.group)


def spatial_mean(x: torch.Tensor) -> torch.Tensor:
    """The (B, 1, 1, C) mean of NHWC ``x`` over H and W, in x's dtype; inside
    a shard over the global map: float32 sums all-reduced over the group,
    with a gradient."""
    if current_shard() is None:
        return x.mean(dim=(1, 2), keepdim=True)
    total = spatial_sum(x.float().sum(dim=(1, 2), keepdim=True))
    return (total / (global_rows(x.shape[1]) * x.shape[2])).to(x.dtype)


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

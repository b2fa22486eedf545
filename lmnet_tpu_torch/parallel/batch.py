"""The data axis inside a train step: sums over the global batch.

Under JAX's mesh a train step sees the global batch as one sharded array,
so the loss's sums, the weighted cross-entropy's denominator and every
BatchNorm statistic are taken over the global batch by construction (XLA
inserts the all-reduces; ``lmnet_tpu/parallel/mesh.py:1-21``). A rank of
the port holds only its own rows, so its step runs inside
``global_batch(group, rows, start)``, where

* ``global_sum`` all-reduces a tensor over ``group``, with a gradient;
* ``moments`` gives the float32 mean and biased variance over the global
  batch (a BatchNorm's statistics) from the all-reduced sums of x and x^2;
* ``global_count`` is a per-pixel count over the global batch;
* ``dropout_rows`` cuts this rank's rows out of a dropout mask drawn at the
  global batch's shape, so W ranks draw the masks one process draws.

Beside it sits the mesh's 'spatial' axis: inside ``shard(group, index,
size)`` every map a forward holds is this rank's block of rows of the
global map (``parallel/spatial.py`` holds the halo exchanges and the other
primitives that work on such a block). Then the group of ``global_batch``
is the world (every rank holds other pixels), ``moments`` and
``global_count`` count the global H (size x the local rows), and
``dropout_rows`` draws the mask at the global H too and cuts this rank's
rows of it in both axes.

Outside the contexts each of these is the one-process computation, unchanged.

Gradient scale: the backward of ``global_sum`` all-reduces the gradient
that reaches it. Every rank computes the same global loss L from the
all-reduced sums, so rank r's gradients are those of the sum of the W
ranks' losses, W * dL/d(rank r's inputs); the mean of the ranks' parameter
gradients (``all_reduce_grads``) is then exactly dL/dtheta.

The context is a module global, not thread-local: the autograd engine runs
a backward, and every recompute inside it, on a thread of its own. Every
rank issues the same all-reduces in the same order, the backward's
included, because every rank runs the same graph. So a process runs one
step at a time: while a global batch is open, only the thread that opened
it and autograd's backward may use it, and any other thread that asks (a
BatchNorm train forward or a loss elsewhere, which would issue all-reduces
the other ranks never match) gets a RuntimeError. The shard is held the
same way.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass

import torch
import torch.distributed as dist

# all-reduces issued by global_sum (and spatial.spatial_mean,
# spatial.gather_rows) in forwards and in backwards, by all_reduce_grads (one
# a step), and the halo exchanges of parallel/spatial.py, forwards and
# backwards
COUNTS = {"forward": 0, "backward": 0, "grads": 0, "halo": 0}


@dataclass(frozen=True)
class _Batch:
    group: object
    rows: int  # the global batch's rows
    start: int  # this rank's first row
    thread: int  # the thread that opened it


@dataclass(frozen=True)
class Shard:
    group: object  # the ranks of the 'spatial' axis that hold this image's rows
    index: int  # this rank's place on the axis: it holds the index-th block of rows
    size: int  # ranks on the axis
    thread: int  # the thread that opened it


_ACTIVE: _Batch | None = None
_SHARD: Shard | None = None


@contextlib.contextmanager
def global_batch(group, rows: int, start: int):
    """Within the block, the batch a rank holds is rows ``start`` onward of
    a global batch of ``rows`` rows, split over ``group``."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("global_batch does not nest")
    _ACTIVE = _Batch(group, int(rows), int(start), threading.get_ident())
    try:
        yield
    finally:
        _ACTIVE = None


def _owned(ctx):
    """``ctx`` (an open global batch or shard, or None); raises on a thread
    other than the one that opened it, outside autograd's backward."""
    if (ctx is not None and threading.get_ident() != ctx.thread
            and torch._C._current_graph_task_id() == -1):
        raise RuntimeError("a global batch or shard is open on another thread: a process runs "
                           "one data-parallel step at a time")
    return ctx


def _batch() -> _Batch | None:
    return _owned(_ACTIVE)


@contextlib.contextmanager
def shard(group, index: int, size: int):
    """Within the block every map is this rank's ``index``-th block of rows
    of a map of ``size`` blocks, the others held by the ranks of ``group``
    (in order)."""
    global _SHARD
    if _SHARD is not None:
        raise RuntimeError("shard does not nest")
    _SHARD = Shard(group, int(index), int(size), threading.get_ident())
    try:
        yield
    finally:
        _SHARD = None


@contextlib.contextmanager
def whole():
    """Within the block, inside a shard, the maps are whole again (each rank
    runs the gathered GFT bottleneck): no halo, no spatial sum, dropout cut
    in rows only. Only forward code runs in it; nothing in it is
    recomputed."""
    global _SHARD
    held, _SHARD = current_shard(), None
    try:
        yield
    finally:
        _SHARD = held


def current_shard() -> Shard | None:
    """The open shard, or None."""
    return _owned(_SHARD)


def _h_blocks() -> int:
    s = current_shard()
    return 1 if s is None else s.size


def active() -> bool:
    return _batch() is not None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        COUNTS["forward"] += 1
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        COUNTS["backward"] += 1
        return g, None


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks of the active global batch (``t`` itself
    outside one); differentiable."""
    b = _batch()
    if b is None:
        return t
    return _AllReduceSum.apply(t, b.group)


def global_count(t: torch.Tensor) -> int:
    """``t.numel()`` at the global batch's rows and the global H (``t``'s
    leading axes are the batch and H)."""
    b = _batch()
    rows = t.shape[0] if b is None else b.rows
    return t.numel() // t.shape[0] * rows * _h_blocks()


def moments(xf: torch.Tensor, dims, h_axis: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 mean and biased variance E[x^2] - E[x]^2 (clamped at 0) of
    float32 ``xf`` over ``dims``, which hold the batch axis 0 (and H, axis
    ``h_axis``: 1 in NHWC, 2 in NCHW, inside a shard). Outside a global batch it is flax's
    ``_compute_stats`` (means of x and x^2); inside, the sums of x and x^2
    are all-reduced in one call and divided by the global count. Inside a
    shard it needs a global batch: a block's own statistics are not the
    map's."""
    b = _batch()
    if b is None and current_shard() is not None:
        raise RuntimeError("batch statistics on an H shard need a global_batch over the world "
                           "(train_step opens both)")
    if b is None:
        mean = xf.mean(dim=dims)
        return mean, torch.clamp(xf.square().mean(dim=dims) - mean.square(), min=0.0)
    n = 1
    for d in dims:
        n *= xf.shape[d]
    n = n // xf.shape[0] * b.rows * (_h_blocks() if h_axis in dims else 1)
    s = global_sum(torch.stack([xf.sum(dim=dims), xf.square().sum(dim=dims)]))
    mean = s[0] / n
    return mean, torch.clamp(s[1] / n - mean.square(), min=0.0)


def dropout_rows(draw, shape):
    """A mask of ``shape`` (leading axes: this rank's rows, then its H rows
    inside a shard) from ``draw(full_shape)``: outside a global batch and a
    shard ``draw(shape)``; inside, the mask of the global batch's rows (and
    the global H), sliced to this rank's rows, so the generator advances as
    it does in one process."""
    b, s = _batch(), current_shard()
    rows, start = (shape[0], 0) if b is None else (b.rows, b.start)
    h = shape[1] if s is None else shape[1] * s.size
    full = draw((rows, h, *shape[2:]))[start:start + shape[0]]
    return full if s is None else full[:, s.index * shape[1]:(s.index + 1) * shape[1]]


def all_reduce_grads(params, group) -> None:
    """Replace every parameter's gradient by its mean over ``group`` (the
    world: every rank of the mesh): one all-reduce of all gradients,
    flattened (a parameter without a gradient counts as zeros). Each rank
    holds world x its share of dL/dtheta (every collective's backward is its
    adjoint), so the mean over the world, not over the data axis alone, is
    dL/dtheta."""
    params = list(params)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    COUNTS["grads"] += 1
    flat /= dist.get_world_size(group)
    offset = 0
    for p, g in zip(params, grads):
        n = g.numel()
        p.grad = flat[offset:offset + n].view_as(g)
        offset += n

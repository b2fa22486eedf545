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

Outside the context each of these is the one-process computation, unchanged.

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
the other ranks never match) gets a RuntimeError.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass

import torch
import torch.distributed as dist

# all-reduces issued by global_sum in forwards and in backwards, and by
# all_reduce_grads (one a step)
COUNTS = {"forward": 0, "backward": 0, "grads": 0}


@dataclass(frozen=True)
class _Batch:
    group: object
    rows: int  # the global batch's rows
    start: int  # this rank's first row
    thread: int  # the thread that opened it


_ACTIVE: _Batch | None = None


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


def _batch() -> _Batch | None:
    """The open global batch, or None; raises on a thread other than the
    one that opened it, outside autograd's backward."""
    b = _ACTIVE
    if (b is not None and threading.get_ident() != b.thread
            and torch._C._current_graph_task_id() == -1):
        raise RuntimeError("a global batch is open on another thread: a process runs one "
                           "data-parallel step at a time")
    return b


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
    """``t.numel()`` at the global batch's rows (``t``'s leading axis is the
    batch)."""
    b = _batch()
    if b is None:
        return t.numel()
    return t.numel() // t.shape[0] * b.rows


def moments(xf: torch.Tensor, dims) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 mean and biased variance E[x^2] - E[x]^2 (clamped at 0) of
    float32 ``xf`` over ``dims``, which hold the batch axis 0. Outside a
    global batch it is flax's ``_compute_stats`` (means of x and x^2); inside,
    the sums of x and x^2 are all-reduced in one call and divided by the
    global count."""
    b = _batch()
    if b is None:
        mean = xf.mean(dim=dims)
        return mean, torch.clamp(xf.square().mean(dim=dims) - mean.square(), min=0.0)
    n = 1
    for d in dims:
        n *= xf.shape[d]
    n = n // xf.shape[0] * b.rows
    s = global_sum(torch.stack([xf.sum(dim=dims), xf.square().sum(dim=dims)]))
    mean = s[0] / n
    return mean, torch.clamp(s[1] / n - mean.square(), min=0.0)


def dropout_rows(draw, shape):
    """A mask of ``shape`` (leading axis: this rank's rows) from
    ``draw(full_shape)``: outside a global batch ``draw(shape)``; inside,
    the global batch's mask, sliced to this rank's rows, so the generator
    advances as it does in one process."""
    b = _batch()
    if b is None:
        return draw(tuple(shape))
    full = draw((b.rows, *shape[1:]))
    return full[b.start:b.start + shape[0]]


def all_reduce_grads(params, group) -> None:
    """Replace every parameter's gradient by its mean over ``group``: one
    all-reduce of all gradients, flattened (a parameter without a gradient
    counts as zeros)."""
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

"""What the per-layer metrics under ``metrics/`` share: each reader takes
a ``Context`` and returns a number, or None where the run holds nothing to
read (no trace, no such kernel), so that the metric is left out."""

from __future__ import annotations

from dataclasses import dataclass, field

from lmbench import arith

# PyTorch's TensorIterator elementwise kernels, its reductions and its
# foreach (multi-tensor) kernels, by the names CUDA gives them
ELTWISE = ("elementwise_kernel", "reduce_kernel", "multi_tensor_apply_kernel")


@dataclass
class Context:
    config: dict
    window: dict  # images, seconds, untraced (images, seconds), batch, ...
    counters: dict = field(default_factory=dict)
    trace: object = None  # profile.Trace of the traced window, or None
    traffic: dict = field(default_factory=dict)  # the cell's traffic mix

    def traced_images(self) -> int:
        return self.window["images"] - self.window["untraced"][0]


def idle_pct(ctx: Context):
    """Share of the traced window in which nothing ran on the device."""
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)


def mfu(ctx: Context, train: bool):
    """The model's operations over the untraced stretch of the window, a
    share of the bf16 tensor-core peak: the deploy graph's a image
    served, or 3x the train-mode forward's a image trained (forward and
    backward, no recompute counted)."""
    if ctx.trace is None:
        return None
    images, seconds = ctx.window["untraced"]
    if images == 0 or seconds <= 0:
        return None
    flops = arith.model_flops(ctx.config, train) * (3 if train else 1)
    return 100.0 * flops * images / seconds / arith.TC_RATE


def share_of_busy(ctx: Context, seconds_of):
    """``seconds_of(trace)`` as a share of the device's busy time; None
    without a trace or where it is 0 (nothing of that kind ran)."""
    if ctx.trace is None:
        return None
    busy, part = ctx.trace.busy_s(), seconds_of(ctx.trace)
    if busy <= 0 or part <= 0:
        return None
    return 100.0 * part / busy


def roofline(ctx: Context, kernels, bound_s_per_batch):
    """A kernel's share of its roofline: the least seconds its calls in
    the traced window need (``bound_s_per_batch(batch)`` a batch, times the
    traced batches) over the device seconds of the kernels whose names
    hold one of ``kernels``; None where they did not run."""
    if ctx.trace is None:
        return None
    t = ctx.trace.kernel_s(lambda n: any(k in n for k in kernels))
    batch = ctx.window["batch"]
    batches = ctx.traced_images() / batch
    if t <= 0 or batches <= 0:
        return None
    return 100.0 * bound_s_per_batch(batch) * batches / t

"""Train-mode BatchNorm over the channel axis of an NHWC tensor: the batch
statistics, the normalisation and their backward.

Replaces no TPU kernel (JAX leaves BatchNorm to XLA). On CUDA tensors
``batch_norm_train`` is a ``torch.autograd.Function`` over the hand-written
kernels of ``csrc/bn_train.cu`` (built by ``ops/_build.py``; a failed build
or launch raises): a forward reads x twice (its float32 sums, then x -> y)
and a backward reads dy and x twice (their float32 sums, then dx), with no
float32 tensor of the activation's size, where the stock float32
composition moved ~10x those bytes. The Function saves x in its own dtype
and the per-channel mean and rstd. On CPU tensors it is
``batch_norm_train_plain``, that composition.

Both compute flax's ``nn.BatchNorm`` in train mode: float32 statistics
E[x^2] - E[x]^2 (clamped at 0) over every axis but the last, the
normalisation in float32, the result rounded once to x's dtype. mean and
var come back for the caller's running-statistics update and take no
gradient. Inside a data-parallel step (``parallel/batch.py::global_batch``)
the statistics are the global batch's: the forward all-reduces its
per-channel sums between the statistics and the apply (``global_sum``) and
divides by the global count (``stat_count``, which counts the global H
inside an H shard too); the backward all-reduces its two per-channel sums
before dx, over the group the forward saw (``reduce_grad``), and returns
this rank's own dgamma and dbeta, as the composition's autograd does. The
kernels combine their sums in float64 and the all-reduced sums are float64,
so that a data-parallel step's statistics are one process's on the same
global batch where E[x^2] - E[x]^2 cancels (float32 partials left them
~1e-3 apart there).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from lmnet_tpu_torch.ops import _build
from lmnet_tpu_torch.ops._build import aligned
from lmnet_tpu_torch.parallel.batch import global_sum, moments, reduce_grad, stat_count, sum_group

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# csrc/bn_train.cu's constants: persistent blocks an SM (the float64 partial
# sums' rows a channel), channels at most, 16-byte vectors a period of
# lcm(vw, C) elements at most
BLOCKS_PER_SM = 4
MAX_C = 1024
PERIOD_VECTORS = 256
_DIMS = (0, 1, 2)


def bn_normalize(x, mean, var, weight, bias, eps: float):
    """``(x - mean) * (rsqrt(var + eps) * weight) + bias`` in float32, cast
    to x's dtype: the normalisation of the plain version, and of
    ``models/blocks.py::BatchNorm`` with its running statistics."""
    inv = torch.rsqrt(var + eps) * weight
    return ((x - mean) * inv + bias).to(x.dtype)


def batch_norm_train_plain(x, weight, bias, eps: float = 1e-5):
    """The plain version: ``parallel/batch.py::moments`` of ``x.float()``,
    then ``bn_normalize``. Returns (y, mean, var)."""
    mean, var = moments(x.float(), _DIMS)
    return bn_normalize(x, mean, var, weight, bias, eps), mean, var


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _fn(name: str, nptr: int, tail: list):
    """The C entry ``name`` of ``csrc/bn_train.cu``, its argument types set
    once: ``nptr`` pointers, then ``tail``, then the stream."""
    fn = getattr(_build.load("bn_train"), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * nptr + tail + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


_LL, _I, _D = ctypes.c_longlong, ctypes.c_int, ctypes.c_double


def _check(x: torch.Tensor, weight: torch.Tensor) -> None:
    """Raises for what the kernels do not take."""
    if x.dim() != 4:
        raise ValueError(f"batch_norm_train takes an NHWC tensor, not shape {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"batch_norm_train takes float32 or bfloat16, not {x.dtype}")
    C = x.shape[-1]
    if not 0 < C <= MAX_C or x.numel() == 0:
        raise ValueError(f"batch_norm_train takes 1 to {MAX_C} channels and a non-empty x, "
                         f"not shape {tuple(x.shape)}")
    vw = 16 // x.element_size()
    if C // math.gcd(vw, C) > PERIOD_VECTORS:
        raise ValueError(f"batch_norm_train takes at most {PERIOD_VECTORS} vectors of {vw} "
                         f"{x.dtype} a period of lcm({vw}, C) elements, not C = {C}")
    if tuple(weight.shape) != (C,):
        raise ValueError(f"weight must be ({C},), got {tuple(weight.shape)}")


def _launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"bn_train {name} launch failed: CUDA error {err}")


def _forward(x, weight, bias, n: int, eps: float):
    """(y, stats (3, C): mean, var, rstd) of contiguous, aligned CUDA x over
    ``n`` elements a channel, its float64 per-channel sums summed over the
    active global batch."""
    C = x.shape[-1]
    N, dev = x.numel() // C, x.device
    sms, code, stream = _sms(dev.index), _DTYPE_CODE[x.dtype], torch._C._cuda_getCurrentRawStream(
        dev.index)
    ws = 2 * C * BLOCKS_PER_SM * sms
    sums = torch.empty(2 * C, dtype=torch.float64, device=dev)
    stats = torch.empty(3, C, dtype=torch.float32, device=dev)
    part = torch.empty(ws, dtype=torch.float64, device=dev)
    _launch("stats", _fn("lmnet_bn_train_stats", 3, [_LL, _LL, _I, _I, _I])(
        x.data_ptr(), sums.data_ptr(), part.data_ptr(), ws, N, C, code, sms, stream))
    sums = global_sum(sums)
    y = torch.empty_like(x)
    w, b = weight.detach().float().contiguous(), bias.detach().float().contiguous()
    _launch("apply", _fn("lmnet_bn_train_apply", 6, [_LL, _I, _I, _I, _D, _D])(
        x.data_ptr(), y.data_ptr(), sums.data_ptr(), w.data_ptr(), b.data_ptr(),
        stats.data_ptr(), N, C, code, sms, float(n), float(eps), stream))
    return y, stats


def batch_norm_train_backward(dy, x, weight, stats, n: int, group=None, need_dx: bool = True):
    """(dx or None, dweight, dbias) of the forward that gave ``stats``
    (3, C) on ``x`` over ``n`` elements a channel, from the output's
    gradient ``dy``: the kernels' two sums (sum dy, sum dy * xhat: dbias and
    dweight, returned in float32), all-reduced in float64 over ``group``
    (None: one process) for dx alone, then dx in x's dtype. One more in
    ``batch_norm_train_backward.launches``."""
    C = x.shape[-1]
    N, dev = x.numel() // C, x.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return batch_norm_train_backward(dy, x, weight, stats, n, group, need_dx)
    dy = aligned(dy.contiguous())
    sms, code, stream = _sms(dev.index), _DTYPE_CODE[x.dtype], torch._C._cuda_getCurrentRawStream(
        dev.index)
    ws = 2 * C * BLOCKS_PER_SM * sms
    out = torch.empty(2, C, dtype=torch.float64, device=dev)
    grads = torch.empty(2, C, dtype=torch.float32, device=dev)
    part = torch.empty(ws, dtype=torch.float64, device=dev)
    _launch("bwd_stats", _fn("lmnet_bn_train_bwd_stats", 6, [_LL, _LL, _I, _I, _I])(
        dy.data_ptr(), x.data_ptr(), stats.data_ptr(), out.data_ptr(), grads.data_ptr(),
        part.data_ptr(), ws, N, C, code, sms, stream))
    dx = None
    if need_dx:
        g = out if group is None else reduce_grad(out, group)
        w = weight.detach().float().contiguous()
        dx = torch.empty_like(x)
        _launch("bwd_apply", _fn("lmnet_bn_train_bwd_apply", 6, [_LL, _I, _I, _I, _D])(
            dy.data_ptr(), x.data_ptr(), dx.data_ptr(), g.data_ptr(), stats.data_ptr(),
            w.data_ptr(), N, C, code, sms, float(n), stream))
    batch_norm_train_backward.launches += 1
    return dx, grads[1].to(weight.dtype), grads[0].to(weight.dtype)


class _BatchNormTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        x = aligned(x.contiguous())
        n = stat_count(x, _DIMS)
        ctx.n, ctx.group = n, sum_group()
        y, stats = _forward(x, weight, bias, n, eps)
        ctx.save_for_backward(x, weight, stats)
        mean, var = stats[0], stats[1]
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, stats = ctx.saved_tensors
        dx, dw, db = batch_norm_train_backward(dy, x, weight, stats, ctx.n, ctx.group,
                                               ctx.needs_input_grad[0])
        return dx, dw, db, None


def batch_norm_train(x, weight, bias, eps: float = 1e-5):
    """Train-mode BatchNorm of NHWC ``x`` with the batch statistics;
    returns (y in x's dtype, mean, var), mean and var float32 (C,) and not
    differentiable. On CUDA tensors the kernels (one more in
    ``batch_norm_train.launches``; two calls give bitwise-equal results);
    on CPU tensors ``batch_norm_train_plain``."""
    if x.device.type == "cpu":
        return batch_norm_train_plain(x, weight, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"batch_norm_train runs on cpu or cuda tensors, not {x.device}")
    _check(x, weight)
    if x.device.index != torch.cuda.current_device():
        with torch.cuda.device(x.device):
            return batch_norm_train(x, weight, bias, eps)
    out = _BatchNormTrain.apply(x, weight, bias, eps)
    batch_norm_train.launches += 1
    return out


batch_norm_train.launches = 0
batch_norm_train_backward.launches = 0

"""LayerNorm over the last axis: its forward and backward.

Replaces no TPU kernel (JAX leaves LayerNorm to XLA). On CUDA tensors
``layer_norm`` is a ``torch.autograd.Function`` over the hand-written
kernels of ``csrc/layer_norm.cu`` (built by ``ops/_build.py``; a failed
build or launch raises): a forward reads x once and writes y once, a
backward reads dy and x once and writes dx once (then a small kernel adds
the per-block sums of dweight and dbias), where the stock float32
composition moved ~15x those bytes. The Function saves x in its own dtype
and two float32 row vectors (mean, rstd), no float32 tensor of the
activation's size. On CPU tensors it is ``layer_norm_plain``, that
composition.

Both compute flax's ``nn.LayerNorm(epsilon=eps)``: float32 statistics
E[x^2] - E[x]^2 (clamped at 0) over the last axis, the normalisation and
the affine in float32 with float32 (or promoted) weight and bias, the result
rounded once to x's dtype. The kernels take float32 and bfloat16 with C
from 1 to ``MAX_C``; on a card anything else raises (no other path).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from lmnet_tpu_torch.ops import _build
from lmnet_tpu_torch.ops._build import aligned

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# csrc/layer_norm.cu's register budget: a row over at most a block's 256
# lanes of 16 float32 values
MAX_C = 4096


def _stats(x: torch.Tensor, dims) -> tuple[torch.Tensor, torch.Tensor]:
    """flax's ``_compute_stats``: float32 mean and biased variance
    E[x^2] - E[x]^2, clamped at 0."""
    xf = x.float()
    mean = xf.mean(dim=dims)
    var = torch.clamp(xf.square().mean(dim=dims) - mean.square(), min=0.0)
    return mean, var


def layer_norm_plain(x, weight, bias, eps: float):
    """The plain version: ``_stats`` over the last axis, then ``(x - mean)
    * (rsqrt(var + eps) * weight) + bias`` in float32, cast to x's dtype."""
    mean, var = _stats(x, -1)
    y = (x - mean[..., None]) * (torch.rsqrt(var + eps)[..., None] * weight)
    return (y + bias).to(x.dtype)


def check(x: torch.Tensor, weight: torch.Tensor) -> None:
    """Raises for what the kernels do not take."""
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"layer_norm takes float32 or bfloat16, not {x.dtype}")
    C = x.shape[-1] if x.dim() else 0
    if not 0 < C <= MAX_C:
        raise ValueError(f"layer_norm takes a last axis of 1 to {MAX_C} elements, not shape "
                         f"{tuple(x.shape)}")
    if x.numel() == 0:
        raise ValueError(f"layer_norm takes a non-empty x, not shape {tuple(x.shape)}")
    if tuple(weight.shape) != (C,):
        raise ValueError(f"weight must be ({C},), got {tuple(weight.shape)}")


def _fn(name: str, argtypes: list):
    """The C entry ``name`` of ``csrc/layer_norm.cu``, its argument types set
    once."""
    fn = getattr(_build.load("layer_norm"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P, _LL, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float


def _launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"layer_norm {name} launch failed: CUDA error {err}")


@functools.lru_cache(maxsize=None)
def _bwd_grid(index: int, N: int, C: int, code: int) -> int:
    """The backward's persistent blocks for this shape on card ``index``,
    the current one: fixed for the shape, so two calls sum in the same
    order."""
    grid = ctypes.c_int(0)
    fn = _fn("lmnet_ln_rows_bwd_grid", [_LL, _I, _I, ctypes.POINTER(ctypes.c_int)])
    _launch("bwd_grid", fn(N, C, code, ctypes.byref(grid)))
    return grid.value


def _stream(dev: torch.device) -> int:
    return torch._C._cuda_getCurrentRawStream(dev.index)


def _params(t: torch.Tensor) -> torch.Tensor:
    return aligned(t.detach().float().contiguous())


def _forward(x, weight, bias, eps: float):
    """(y, mean, rstd) of contiguous, aligned CUDA x: rstd float32 (N,),
    negated where the variance was clamped at 0."""
    C = x.shape[-1]
    N, dev = x.numel() // C, x.device
    y = torch.empty_like(x)
    mean = torch.empty(N, dtype=torch.float32, device=dev)
    rstd = torch.empty(N, dtype=torch.float32, device=dev)
    w, b = _params(weight), _params(bias)
    _launch("fwd", _fn("lmnet_ln_rows_fwd", [_P] * 6 + [_LL, _I, _I, _F, _P])(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), N, C, _DTYPE_CODE[x.dtype], float(eps), _stream(dev)))
    return y, mean, rstd


def layer_norm_backward(dy, x, weight, mean, rstd, need_dx: bool = True):
    """(dx or None, dweight, dbias) of the forward that gave ``mean`` and
    ``rstd`` on ``x``, from the output's gradient ``dy``: dx in x's dtype,
    dweight = sum dy xhat and dbias = sum dy over the rows, float32 sums
    returned in weight's dtype. One more in ``layer_norm_backward.launches``."""
    C = x.shape[-1]
    N, dev = x.numel() // C, x.device
    code = _DTYPE_CODE[x.dtype]
    dy = aligned(dy.contiguous())
    grid = _bwd_grid(dev.index, N, C, code)
    part = torch.empty(2, grid, C, dtype=torch.float32, device=dev)
    grads = torch.empty(2, C, dtype=torch.float32, device=dev)
    dx = torch.empty_like(x) if need_dx else None
    w = _params(weight)
    _launch("bwd", _fn("lmnet_ln_rows_bwd", [_P] * 7 + [_I, _P, _LL, _I, _I, _P])(
        dy.data_ptr(), x.data_ptr(), w.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
        None if dx is None else dx.data_ptr(), part.data_ptr(), grid, grads.data_ptr(), N, C,
        code, _stream(dev)))
    layer_norm_backward.launches += 1
    return dx, grads[0].to(weight.dtype), grads[1].to(weight.dtype)


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        x = aligned(x.contiguous())
        y, mean, rstd = _forward(x, weight, bias, eps)
        ctx.save_for_backward(x, weight, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, rstd = ctx.saved_tensors
        dx, dw, db = layer_norm_backward(dy, x, weight, mean, rstd, ctx.needs_input_grad[0])
        return dx, dw, db, None


def layer_norm(x, weight, bias, eps: float):
    """LayerNorm of ``x`` over its last axis with ``weight`` and ``bias``;
    the result in x's dtype. On CUDA tensors the kernels (one more in
    ``layer_norm.launches``; two calls give bitwise-equal results, gradients
    included); on CPU tensors ``layer_norm_plain``."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, weight, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm runs on cpu or cuda tensors, not {x.device}")
    check(x, weight)
    if x.device.index != torch.cuda.current_device():
        with torch.cuda.device(x.device):
            return layer_norm(x, weight, bias, eps)
    y = _LayerNorm.apply(x, weight, bias, eps)
    layer_norm.launches += 1
    return y


layer_norm.launches = 0
layer_norm_backward.launches = 0

"""Depthwise 5x5 + bias + tanh GELU with the SE channel sums, on flat
``(B, H, W*C)`` activations, and the deploy ReparamConv block built on it.

Counterpart of ``lmnet_tpu/ops/pallas/rc_flat.py`` (``dw_gelu_flat``,
``fused_rc_block``, ``fold_rc_flat_weights``). On CUDA tensors
``dw_gelu_flat`` launches the hand-written kernel ``csrc/rc_dw_gelu.cu``
(built by ``ops/_build.py``; a failed build or launch raises). On CPU
tensors it runs the plain version, ``dw_gelu_flat_plain``. The TPU weight
layout (25 x W*C tiled taps with the border masks folded in) is not part of
the function: the port takes the OIHW depthwise kernel ``(C, 1, 5, 5)`` and
the ``(C,)`` bias. Unlike the TPU kernel it takes every H, W >= 1.
"""

from __future__ import annotations

import ctypes
from typing import Mapping

import torch
import torch.nn.functional as F

from lmnet_tpu_torch.ops import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
BN_EPS = 1e-5


def _kernel():
    lib = _build.load("rc_dw_gelu")
    fn, ws = lib.lmnet_rc_dw_gelu, lib.lmnet_rc_dw_gelu_workspace
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p] * 6 + [i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        ws.argtypes = [i, i, i, i]
        ws.restype = ctypes.c_longlong
    return fn, ws


def check_cuda(name: str, act: torch.Tensor, *weights: torch.Tensor) -> None:
    """What the ReparamConv kernels take: a contiguous float32 or bfloat16
    activation, and contiguous float32 weights on its device."""
    if act.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda tensors, not {act.device}")
    if act.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name} takes float32 or bfloat16, not {act.dtype}")
    if not act.is_contiguous():
        raise ValueError(f"{name}: the activation must be contiguous")
    for w in weights:
        if w.dtype != torch.float32 or w.device != act.device or not w.is_contiguous():
            raise ValueError(f"{name}: weights must be contiguous float32 on {act.device}")


def _check_shapes(e_flat, kernel, bias, C: int) -> tuple[int, int, int]:
    """Validate the flat layout; returns (B, H, W)."""
    if e_flat.dim() != 3 or e_flat.shape[2] % C:
        raise ValueError(f"e must be (B, H, W*{C}), got {tuple(e_flat.shape)}")
    if tuple(kernel.shape) != (C, 1, 5, 5) or tuple(bias.shape) != (C,):
        raise ValueError(f"kernel must be ({C}, 1, 5, 5) and bias ({C},), got "
                         f"{tuple(kernel.shape)} and {tuple(bias.shape)}")
    B, H, WC = e_flat.shape
    return B, H, WC // C


def dw_gelu_flat(e_flat: torch.Tensor, kernel5x5: torch.Tensor, bias: torch.Tensor, C: int):
    """t = gelu_tanh(dw5x5(e) + b) on flat (B, H, W*C) ``e_flat``, zero
    padding (conv semantics), float32 math.

    ``kernel5x5``: OIHW depthwise (C, 1, 5, 5); ``bias``: (C,). Returns
    (t_flat in e's dtype, sums): ``sums`` is (B, C) float32, the per-image
    channel sums of the float32 t before the cast. JAX's ``dw_gelu_flat``
    returns (B, W*C) flat sums; its callers fold them over W, which gives
    these. Each launch of the CUDA kernel adds one to ``dw_gelu_flat.launches``;
    two calls with the same inputs give bitwise-equal sums.
    """
    B, H, W = _check_shapes(e_flat, kernel5x5, bias, C)
    if e_flat.device.type == "cpu":
        return dw_gelu_flat_plain(e_flat, kernel5x5, bias, C)
    kernel5x5 = kernel5x5.float().contiguous()
    bias = bias.float().contiguous()
    check_cuda("dw_gelu_flat", e_flat, kernel5x5, bias)
    fn, ws = _kernel()
    n_part = ws(B, H, W, C)
    if n_part < 0:
        raise ValueError(f"rc_dw_gelu does not take B={B} H={H} W={W} C={C}")
    t = torch.empty_like(e_flat)
    f32 = dict(dtype=torch.float32, device=e_flat.device)
    sums = torch.empty(B, C, **f32)
    part = torch.empty(n_part, **f32)
    with torch.cuda.device(e_flat.device):
        err = fn(e_flat.data_ptr(), kernel5x5.data_ptr(), bias.data_ptr(), t.data_ptr(),
                 sums.data_ptr(), part.data_ptr(), B, H, W, C, _DTYPE_CODE[e_flat.dtype],
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"rc_dw_gelu launch failed: CUDA error {err}")
    dw_gelu_flat.launches += 1
    return t, sums


def dw_gelu_flat_plain(e_flat: torch.Tensor, kernel5x5: torch.Tensor, bias: torch.Tensor,
                       C: int):
    """The plain PyTorch version of ``dw_gelu_flat``: ``F.conv2d`` (groups=C)
    in float32, tanh GELU, sums over H and W, t cast to e's dtype."""
    B, H, W = _check_shapes(e_flat, kernel5x5, bias, C)
    e = e_flat.reshape(B, H, W, C).permute(0, 3, 1, 2).float()
    t = F.gelu(F.conv2d(e, kernel5x5.float(), bias.float(), padding=2, groups=C),
               approximate="tanh")
    t_flat = t.permute(0, 2, 3, 1).to(e_flat.dtype).reshape(B, H, W * C)
    return t_flat, t.sum(dim=(2, 3))


def fold_rc_flat_weights(sd: Mapping[str, torch.Tensor], name: str, eps: float = BN_EPS) -> dict:
    """The deploy block ``name`` of a ``structural_reparam`` state dict, folded
    for ``fused_rc_block``: the expand BN (running statistics) folded into
    the expand weights, everything float32 in ``F.linear`` layouts.

    Keys: we (E, Cin), be (E,), kd (E, 1, 5, 5), bdw (E,), fc1_w (E//4, E),
    fc1_b, fc2_w (E, E//4), fc2_b, wp (Cout, E), bp, wsc (Cout, Cin), bsc.
    """
    def w(key):
        return sd[f"{name}.{key}"].float()

    inv = w("expand_conv.1.weight") / torch.sqrt(w("expand_conv.1.running_var") + eps)
    return dict(
        we=w("expand_conv.0.weight").flatten(1) * inv[:, None],
        be=(w("expand_conv.0.bias") - w("expand_conv.1.running_mean")) * inv
        + w("expand_conv.1.bias"),
        kd=w("fuse_conv.weight"),
        bdw=w("fuse_conv.bias"),
        fc1_w=w("se.fc1.weight").flatten(1),
        fc1_b=w("se.fc1.bias"),
        fc2_w=w("se.fc2.weight").flatten(1),
        fc2_b=w("se.fc2.bias"),
        wp=w("pointwise_conv.0.weight").flatten(1),
        bp=w("pointwise_conv.0.bias"),
        wsc=w("shortcut.0.weight").flatten(1),
        bsc=w("shortcut.0.bias"),
    )


def se_scale(sums: torch.Tensor, w: dict, HW: int) -> torch.Tensor:
    """hardsigmoid(fc2(relu(fc1(mean)))) on the (B, E) float32 channel sums
    of an H*W = ``HW`` map, with the SE weights of ``w``."""
    h = F.relu(F.linear(sums / HW, w["fc1_w"], w["fc1_b"]))
    return F.hardsigmoid(F.linear(h, w["fc2_w"], w["fc2_b"]))


def fused_rc_block(x: torch.Tensor, fw: dict) -> torch.Tensor:
    """Deploy-mode ReparamConv through ``dw_gelu_flat``: NHWC (B, H, W, Cin)
    -> (B, H, W, Cout) in x's dtype, with ``fw`` from ``fold_rc_flat_weights``.

    expand + folded BN + hardswish (one matmul) -> the kernel (dw5x5 + bias
    + GELU + channel sums) -> the SE MLP in float32 on the kernel's sums, its
    scale cast to x's dtype -> pointwise + shortcut. As in JAX the 1x1
    products stay outside the kernel (matmuls here, XLA there).
    """
    B, H, W, _ = x.shape
    E = fw["we"].shape[0]
    dt = x.dtype
    e = F.hardswish(F.linear(x, fw["we"].to(dt), fw["be"].to(dt)))
    t_flat, sums = dw_gelu_flat(e.reshape(B, H, W * E), fw["kd"], fw["bdw"], E)
    s = se_scale(sums, fw, H * W)
    t = t_flat.reshape(B, H, W, E) * s[:, None, None, :].to(dt)
    return (F.linear(t, fw["wp"].to(dt), fw["bp"].to(dt))
            + F.linear(x, fw["wsc"].to(dt), fw["bsc"].to(dt)))


dw_gelu_flat.launches = 0

"""Depthwise 5x5 + bias + tanh GELU with the SE channel sums, on flat
``(B, H, W*C)`` activations, and the deploy ReparamConv block built on it.

Counterpart of ``lmnet_tpu/ops/pallas/rc_flat.py`` (``dw_gelu_flat``,
``fused_rc_block``, ``fold_rc_flat_weights``). On CUDA tensors
``dw_gelu_flat`` launches the hand-written kernel ``csrc/rc_dw_gelu.cu``
(built by ``ops/_build.py``; a failed build or launch raises) with the
launch geometry of ``dw_plan``, which the kernel checks. On CPU
tensors it runs the plain version, ``dw_gelu_flat_plain``. The TPU weight
layout (25 x W*C tiled taps with the border masks folded in) is not part of
the function: the port takes the OIHW depthwise kernel ``(C, 1, 5, 5)`` and
the ``(C,)`` bias. Unlike the TPU kernel it takes every H, W >= 1.

``dw_gelu_flat`` takes a row window (``parallel/spatial.py``): a slab of
rows, the slab row ``top`` of its first output row and its ``rows`` output
rows; taps outside the slab read zero and the sums cover the output rows.
Inside an H shard ``fused_rc_block`` gives it the slab of e with 2 rows of
each neighbour (zero rows past the global edges) and all-reduces its sums
over the spatial group before the SE.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Mapping

import torch
import torch.nn.functional as F

from lmnet_tpu_torch.ops import _build
from lmnet_tpu_torch.ops._build import aligned
from lmnet_tpu_torch.parallel.spatial import row_window, spatial_sum

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
BN_EPS = 1e-5


# csrc/rc_dw_gelu.cu's constants: a block's output tile (rows, columns), its
# channels at most, a block's shared-memory limit on sm_90
DW_TILE = (16, 32)
DW_CHUNK = 32
MAX_SMEM = 232448


def _vec_bytes(n: int) -> int:
    """The widest copy unit of 2, 4, 8 or 16 bytes that divides n bytes."""
    return min(16, n & -n)


def chunk_channels(C: int) -> int:
    """Channels a block of the depthwise kernels (B5, B6) takes: all C up to
    32; above, the largest of 32, 24, 16, 8 that divides C, else 32
    (``csrc/rc_common.cuh::chunk_channels``)."""
    return C if C <= DW_CHUNK else next((c for c in (32, 24, 16, 8) if C % c == 0), DW_CHUNK)


def slab_window(Hs: int, top: int, rows: int | None) -> tuple[int, int]:
    """(top, rows) of a row window on a slab of ``Hs`` rows (``rows`` None:
    the slab's rows from ``top``); raises where the output rows do not lie
    inside the slab."""
    rows = Hs - top if rows is None else rows
    if top < 0 or rows <= 0 or top + rows > Hs:
        raise ValueError(f"output rows [{top}, {top + rows}) do not lie in a slab of {Hs} rows")
    return top, rows


@functools.lru_cache(maxsize=None)
def dw_plan(B: int, H: int, W: int, C: int, dtype: torch.dtype, Hs: int | None = None,
            top: int = 0):
    """The launch geometry of ``csrc/rc_dw_gelu.cu`` for H output rows of e
    (B, Hs, W*C) of ``dtype`` (``Hs`` None: H), output row r at slab row
    ``top`` + r, or None for a shape or window it does not take: ``tile``
    (rows,
    columns), ``chunk`` channels a block (all C up to 32, else the largest of
    32, 24, 16, 8 that divides C, else 32), ``nchunk`` chunks, ``vec`` the copy
    unit in bytes (the widest of 16, 8, 4, 2 that divides C's channel run),
    ``smem`` dynamic shared-memory bytes (the halo and t tile in e's dtype;
    taps and a partial per thread, which computes two rows, in float32),
    ``ntiles`` tiles per image over the output rows, ``workspace`` float32
    per-tile channel sums, ``window`` (Hs, top). Cached: the caller must not
    change the dict."""
    Hs = H if Hs is None else Hs
    if not (0 < B <= 65535 and H > 0 and W > 0 and C > 0) or dtype not in _DTYPE_CODE:
        return None
    if top < 0 or top + H > Hs:
        return None
    rows, cols = DW_TILE
    esize = 4 if dtype == torch.float32 else 2
    ck = chunk_channels(C)
    nchunk = -(-C // ck)
    ntiles = -(-H // rows) * -(-W // cols)
    tiles = ((rows + 4) * (cols + 4) + rows * cols) * ck * esize
    smem = -(-tiles // 16) * 16 + (25 + rows // 2) * ck * 4
    if ntiles > 0x7FFFFFFF or nchunk > 65535 or smem > MAX_SMEM:
        return None
    return dict(tile=DW_TILE, chunk=ck, nchunk=nchunk, vec=_vec_bytes(C * esize), smem=smem,
                ntiles=ntiles, workspace=B * ntiles * C, window=(Hs, top))


def _kernel():
    lib = _build.load("rc_dw_gelu")
    fn = lib.lmnet_rc_dw_gelu
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        ll = ctypes.c_longlong
        fn.argtypes = [p] * 6 + [i] * 11 + [ll, ll, p]
        fn.restype = ctypes.c_int
    return fn


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


def dw_gelu_flat(e_flat: torch.Tensor, kernel5x5: torch.Tensor, bias: torch.Tensor, C: int,
                 top: int = 0, rows: int | None = None):
    """t = gelu_tanh(dw5x5(e) + b) on flat (B, Hs, W*C) ``e_flat``, zero
    padding (conv semantics), float32 math, at the ``rows`` output rows
    from slab row ``top`` (default: the whole slab); a tap outside the slab
    reads zero.

    ``kernel5x5``: OIHW depthwise (C, 1, 5, 5); ``bias``: (C,). Returns
    (t_flat (B, rows, W*C) in e's dtype, sums): ``sums`` is (B, C) float32,
    the per-image channel sums over the output rows of the float32 t before
    the cast. JAX's ``dw_gelu_flat`` returns (B, W*C) flat sums; its
    callers fold them over W, which gives these. Each launch of the CUDA
    kernel adds one to ``dw_gelu_flat.launches``; two calls with the same
    inputs give bitwise-equal sums.
    """
    B, Hs, W = _check_shapes(e_flat, kernel5x5, bias, C)
    top, H = slab_window(Hs, top, rows)
    if e_flat.device.type == "cpu":
        return dw_gelu_flat_plain(e_flat, kernel5x5, bias, C, top, H)
    kernel5x5 = kernel5x5.float().contiguous()
    bias = bias.float().contiguous()
    check_cuda("dw_gelu_flat", e_flat, kernel5x5, bias)
    e_flat = aligned(e_flat)
    plan = dw_plan(B, H, W, C, e_flat.dtype, Hs, top)
    if plan is None:
        raise ValueError(f"rc_dw_gelu does not take B={B} H={H} W={W} C={C} Hs={Hs} top={top}")
    fn = _kernel()
    t = e_flat.new_empty((B, H, W * C))
    sums = torch.empty(B, C, dtype=torch.float32, device=e_flat.device)
    part = torch.empty(plan["workspace"], dtype=torch.float32, device=e_flat.device)
    with torch.cuda.device(e_flat.device):
        err = fn(e_flat.data_ptr(), kernel5x5.data_ptr(), bias.data_ptr(), t.data_ptr(),
                 sums.data_ptr(), part.data_ptr(), B, H, W, C, Hs, top, _DTYPE_CODE[e_flat.dtype],
                 *plan["tile"], plan["chunk"], plan["vec"], plan["smem"], plan["workspace"],
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"rc_dw_gelu launch failed: CUDA error {err}")
    dw_gelu_flat.launches += 1
    return t, sums


def dw_gelu_flat_plain(e_flat: torch.Tensor, kernel5x5: torch.Tensor, bias: torch.Tensor,
                       C: int, top: int = 0, rows: int | None = None):
    """The plain PyTorch version of ``dw_gelu_flat``: ``F.conv2d`` (groups=C)
    in float32 on the zero-padded slab, the output rows cut out, tanh GELU,
    sums over their H and W, t cast to e's dtype."""
    B, Hs, W = _check_shapes(e_flat, kernel5x5, bias, C)
    top, H = slab_window(Hs, top, rows)
    e = e_flat.reshape(B, Hs, W, C).permute(0, 3, 1, 2).float()
    t = F.gelu(F.conv2d(e, kernel5x5.float(), bias.float(), padding=2,
                        groups=C)[:, :, top:top + H], approximate="tanh")
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
    # the mean's 1/HW as addmm's alpha: one launch fewer than sums / HW
    h = torch.addmm(w["fc1_b"], sums, w["fc1_w"].t(), alpha=1.0 / HW).relu_()
    return F.hardsigmoid(F.linear(h, w["fc2_w"], w["fc2_b"]), inplace=True)


def fused_rc_block(x: torch.Tensor, fw: dict) -> torch.Tensor:
    """Deploy-mode ReparamConv through ``dw_gelu_flat``: NHWC (B, H, W, Cin)
    -> (B, H, W, Cout) in x's dtype, with ``fw`` from ``fold_rc_flat_weights``.

    expand + folded BN + hardswish (one matmul) -> the kernel (dw5x5 + bias
    + GELU + channel sums) -> the SE MLP in float32 on the kernel's sums, its
    scale cast to x's dtype -> pointwise + shortcut. As in JAX the 1x1
    products stay outside the kernel (matmuls here, XLA there). Inside an H
    shard the kernel runs on the slab of e with 2 rows of each neighbour
    (zero rows past the global edges, the conv's padding), and the SE mean
    is its sums all-reduced over the group over the global H x W.
    """
    B, H, W, _ = x.shape
    E = fw["we"].shape[0]
    dt = x.dtype
    e = F.hardswish(F.linear(x, fw["we"].to(dt), fw["be"].to(dt)))
    slab, top, _, Hg, _ = row_window(e, 2, 2)
    t_flat, sums = dw_gelu_flat(slab.reshape(B, slab.shape[1], W * E), fw["kd"], fw["bdw"], E,
                                top, H)
    s = se_scale(spatial_sum(sums), fw, Hg * W)
    t = t_flat.reshape(B, H, W, E) * s[:, None, None, :].to(dt)
    return (F.linear(t, fw["wp"].to(dt), fw["bp"].to(dt))
            + F.linear(x, fw["wsc"].to(dt), fw["bsc"].to(dt)))


dw_gelu_flat.launches = 0

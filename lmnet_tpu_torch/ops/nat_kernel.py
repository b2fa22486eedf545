"""Neighborhood attention (k=3) on NHWC tensors through the kernel B3.

Counterpart of ``lmnet_tpu/ops/pallas/nat_kernel.py``
(``neighborhood_attention_pallas``, JAX's ``nat_backend='pallas'``). On CUDA
tensors it launches the hand-written kernel ``csrc/nat_kernel.cu`` (built by
``ops/_build.py``; a failed build, tensor-map encode or launch raises) with
the launch geometry of ``b3_plan``, which the kernel checks against its own:
variant 'vec' (persistent blocks walking tiles whose q and k/v halo the TMA
copies into a two-stage ring, B1's vectorised compute) for head_dim 1, 2, 4
or 8 where a tensor map takes the shape, else 'generic'. Where a gradient is
wanted it is a ``torch.autograd.Function`` that saves q, k, v and rpb and
whose backward recomputes the plain NAT (``ops/nat.py``) and differentiates
it, as JAX's ``custom_vjp`` takes the XLA vjp; elsewhere the call goes
straight to the kernel. On CPU tensors it is the plain NAT, which autograd
differentiates. Unlike the TPU kernel, the CUDA kernel takes every H, W >= 3
and any head_dim.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from lmnet_tpu_torch.ops import _build
from lmnet_tpu_torch.ops._build import aligned
from lmnet_tpu_torch.ops.nat import neighborhood_attention
from lmnet_tpu_torch.ops.nat_flat import (
    MAX_BLOCK_HEADS,
    MAX_SMEM,
    NAT_SMS,
    SMEM_TARGET,
    _group_channels,
    _pixels_per_pass,
    _r16,
    _vec_bytes,
)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_BOX = 256  # elements a TMA box dimension


def _r128(x: int) -> int:
    return -(-x // 128) * 128


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pixel_period(rank: int, pixel_bytes: int) -> int:
    """The pixels a rank-2 box row must start on a multiple of, so that its
    first byte is 16-byte aligned: 16 / gcd(pixel bytes, 16); 1 for rank 3
    (``nat_kernel.cu::pixel_period``)."""
    return 16 // min(pixel_bytes & -pixel_bytes, 16) if rank == 2 else 1


def halo_width(rank: int, cols: int, pixel_bytes: int) -> int:
    """A halo row in pixels: the cols + 2 a tile's windows read, widened for
    rank 2 to start at a multiple of the period and span whole periods."""
    a = pixel_period(rank, pixel_bytes)
    return (cols + 2 * a) // a * a


def b3_layout(rows: int, cols: int, hw: int, nh: int, hd: int, es: int, heads: int) -> dict:
    """Byte offsets of the 'vec' variant's shared memory from its 128-byte
    aligned base (``nat_kernel.cu::layout3``): the two barriers at 0, rpb at
    ``rp``, stage s's q tile, k halo and v halo (``hw`` pixels a row) at
    ``q0``, ``k0``, ``v0`` + s x ``stage``; ``total`` with 128 bytes to
    align the base; ``qbox`` and ``hbox`` the bytes a q box and a halo box
    move."""
    ck = nh * hd * es
    qbox, hbox = rows * cols * ck, (rows + 2) * hw * ck
    q0 = 128 + _r128(25 * heads * 4)
    stage = _r128(qbox) + 2 * _r128(hbox)
    return dict(rp=128, q0=q0, k0=q0 + _r128(qbox), v0=q0 + _r128(qbox) + _r128(hbox),
                stage=stage, total=128 + q0 + 2 * stage, qbox=qbox, hbox=hbox)


def _generic_smem(rows: int, cols: int, nh: int, hd: int, es: int) -> int:
    return _r16(25 * nh * 4) + 2 * _r16((rows + 2) * (cols + 2) * nh * hd * es)


@functools.lru_cache(maxsize=None)
def b3_plan(B: int, H: int, W: int, heads: int, hd: int, dtype: torch.dtype):
    """The launch geometry of ``csrc/nat_kernel.cu`` for (B, H, W, heads*hd)
    activations of ``dtype``, or None for a shape it does not take.

    ``variant`` 'vec' (head_dim 1, 2, 4 or 8 with B1's thread group, and a
    tensor map that takes the shape): ``rank`` 3, a map over (C, W, B*H)
    where a pixel's bytes are a multiple of 16, with boxes of ``heads_per_
    block`` heads' channels; or 2, a map over (W*C, B*H) whose box rows
    hold whole rows of all heads, ``halo_width`` * C <= 256 elements (a box
    row starts on 16 bytes, so the halo starts on a multiple of
    ``pixel_period`` pixels). ``tile`` (rows, cols) of query pixels: 32 x
    32 (rank 2: the widest power of two of columns that fits a box row,
    else the widest width), its larger side halved down to 8 (rank 2: its
    rows, down to 2) while there are fewer than two tiles an SM, then
    shrunk while the two stages pass half an SM's shared memory. ``blocks``
    persistent blocks (two an SM where two fit, at most one a
    tile) walk the ``tiles`` in steps of ``blocks``, each with a ring of
    ``stages`` (2) buffers of its tiles' q, k and v. ``maps`` (dims, byte
    strides) and ``boxes`` (q, halo) as the launch encodes them;
    ``halo_cols`` a halo row's pixels, ``period`` the pixels its first
    column is a multiple of, ``layout`` (``b3_layout``) where the kernel
    places the stages.
    'generic' otherwise: one thread per (pixel, head), a tiled grid (one
    block a tile), the k/v halo copied in units of ``vec_bytes``.
    ``threads``, ``smem`` dynamic shared-memory bytes. The same function as
    ``nat_kernel.cu::b3_plan``. Cached: the caller must not change the
    dict."""
    if dtype not in _DTYPE_CODE or B <= 0 or H < 3 or W < 3 or heads <= 0 or hd <= 0:
        return None
    es = 4 if dtype == torch.float32 else 2
    C = heads * hd
    g = _group_channels(hd, C, es) if hd in (1, 2, 4, 8) else 0
    rank, per, nh, rows, cols = 0, 1, heads, min(32, H), min(32, W)

    def chunk_ok(n):
        return n * hd <= MAX_BOX and n * hd * es % 16 == 0

    def next_chunk(n):  # the next smaller valid head chunk, a multiple of per, or 0
        return next((m for m in range((n - 1) // per * per, per - 1, -per) if chunk_ok(m)), 0)

    if g:
        per = g // hd
        if C * es % 16 == 0:
            nh = heads if chunk_ok(heads) else next_chunk(heads)
            rank = 3 if nh else 0
        elif W * C * es % 16 == 0:
            # the widest power of two that fits, else the widest width
            fits = [c for c in range(cols, 0, -1)
                    if halo_width(2, c, C * es) * C <= MAX_BOX and c * C * es % 16 == 0]
            c = next((c for c in fits if c & (c - 1) == 0), fits[0] if fits else 0)
            if c:
                rank, cols, nh = 2, c, heads
    if rank:
        def tiles():
            return _cdiv(W, cols) * _cdiv(H, rows) * B * _cdiv(heads, nh)

        def smem():
            return b3_layout(rows, cols, halo_width(rank, cols, C * es), nh, hd, es, heads)["total"]

        while tiles() < 2 * NAT_SMS:
            if rank == 3 and cols > rows and cols > 8:
                cols //= 2
            elif rows > (8 if rank == 3 else 2):
                rows //= 2
            elif rank == 3 and cols > 8:
                cols //= 2
            else:
                break
        while smem() > SMEM_TARGET:
            if rank == 3 and cols >= rows and cols > 8:
                cols //= 2
            elif rows > 8:
                rows //= 2
            elif rank == 3 and cols > 8:
                cols //= 2
            elif rank == 3 and next_chunk(nh):
                nh = next_chunk(nh)
            elif rows > 1:
                rows //= 2
            elif rank == 3 and cols > 1:
                cols //= 2
            else:
                break
        if smem() <= MAX_SMEM and tiles() <= 0x7FFFFFFF:
            ppb = _pixels_per_pass(nh // per)
            hw = halo_width(rank, cols, C * es)
            lay = b3_layout(rows, cols, hw, nh, hd, es, heads)
            if rank == 3:
                maps = dict(dims=(C, W, B * H), strides=(C * es, W * C * es))
                boxes = dict(q=(nh * hd, cols, rows), halo=(nh * hd, hw, rows + 2))
            else:
                maps = dict(dims=(W * C, B * H), strides=(W * C * es,))
                boxes = dict(q=(cols * C, rows), halo=(hw * C, rows + 2))
            fit = NAT_SMS * (2 if smem() <= SMEM_TARGET else 1)
            return dict(variant="vec", rank=rank, heads_per_thread=per, tile=(rows, cols),
                        heads_per_block=nh, ppb=ppb, threads=nh // per * ppb,
                        grid=(_cdiv(W, cols), _cdiv(H, rows), B * _cdiv(heads, nh)),
                        tiles=tiles(), blocks=min(tiles(), fit), stages=2, vec_bytes=0,
                        smem=smem(), maps=maps, boxes=boxes, halo_cols=hw,
                        period=pixel_period(rank, C * es), layout=lay)
    # generic: all heads a block up to 32, rows halved while the grid has
    # fewer than two blocks an SM, then heads, columns and rows halved while
    # the halos pass half an SM's shared memory
    nh, rows, cols = min(heads, MAX_BLOCK_HEADS), min(32, H), min(32, W)
    while rows > 2 and _cdiv(W, cols) * _cdiv(H, rows) * B * _cdiv(heads, nh) < 2 * NAT_SMS:
        rows //= 2
    while _generic_smem(rows, cols, nh, hd, es) > SMEM_TARGET:
        if nh > 1:
            nh //= 2
        elif cols > 8:
            cols //= 2
        elif rows > 1:
            rows //= 2
        elif cols > 1:
            cols //= 2
        else:
            break
    sm = _generic_smem(rows, cols, nh, hd, es)
    grid = (_cdiv(W, cols), _cdiv(H, rows), B * _cdiv(heads, nh))
    if sm > MAX_SMEM or grid[1] > 65535 or grid[2] > 65535:
        return None
    last = heads - (_cdiv(heads, nh) - 1) * nh
    ppb = _pixels_per_pass(nh)
    return dict(variant="generic", rank=0, heads_per_thread=1, tile=(rows, cols),
                heads_per_block=nh, ppb=ppb, threads=nh * ppb, grid=grid,
                tiles=grid[0] * grid[1] * grid[2], blocks=grid[0] * grid[1] * grid[2], stages=1,
                vec_bytes=min(_vec_bytes(nh * hd * es), _vec_bytes(C * es),
                              _vec_bytes(last * hd * es)),
                smem=sm, maps=None, boxes=None, halo_cols=None, period=None, layout=None)


def kernel_plan(B: int, H: int, W: int, heads: int, hd: int, dtype: torch.dtype):
    """The plan the CUDA source itself computes for this call
    (``lmnet_nat_tile_plan``), in ``b3_plan``'s keys, with the maps, boxes,
    halo row and layout the launch encodes and the kernel reads; None for a
    shape it refuses. Builds and loads the kernel's library: card only."""
    fn = _build.load("nat_kernel").lmnet_nat_tile_plan
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = None
    out = (ctypes.c_longlong * 37)()
    fn(B, H, W, heads, hd, _DTYPE_CODE[dtype], ctypes.addressof(out))
    (vec, rank, per, rows, cols, nh, ppb, threads, gx, gy, nchunk, tiles, blocks, vb, smem,
     hw, period, *geo, ok) = out
    if not ok:
        return None
    dims, strides, qbox, hbox, lay = geo[:3], geo[3:5], geo[5:8], geo[8:11], geo[11:]
    keys = ("rp", "q0", "k0", "v0", "stage", "total", "qbox", "hbox")
    return dict(variant="vec" if vec else "generic", rank=rank, heads_per_thread=per,
                tile=(rows, cols), heads_per_block=nh, ppb=ppb, threads=threads,
                grid=(gx, gy, B * nchunk), tiles=tiles, blocks=blocks, stages=2 if vec else 1,
                vec_bytes=vb, smem=smem,
                maps=dict(dims=tuple(dims[:rank]), strides=tuple(strides[:rank - 1]))
                if vec else None,
                boxes=dict(q=tuple(qbox[:rank]), halo=tuple(hbox[:rank])) if vec else None,
                halo_cols=hw if vec else None, period=period if vec else None,
                layout=dict(zip(keys, lay)) if vec else None)


def kernel_takes(B: int, H: int, W: int, heads: int, hd: int, dtype: torch.dtype) -> bool:
    """``lmnet_nat_tile_takes``: whether the CUDA source has a plan for this
    call. Card only."""
    fn = _build.load("nat_kernel").lmnet_nat_tile_takes
    fn.argtypes = [ctypes.c_int] * 6
    fn.restype = ctypes.c_int
    return bool(fn(B, H, W, heads, hd, _DTYPE_CODE[dtype]))


def _kernel():
    fn = _build.load("nat_kernel").lmnet_nat_tile
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p] * 5 + [i] * 5 + [ctypes.c_float] + [i] * 8 + [ctypes.c_longlong, p]
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _plan_args(B: int, H: int, W: int, heads: int, hd: int, dtype: torch.dtype) -> tuple:
    """(shape and scale, dtype and plan) in the order the C entry takes
    them; raises for a halo no block's shared memory holds."""
    p = b3_plan(B, H, W, heads, hd, dtype)
    if p is None:
        raise ValueError(f"the B3 kernel's halo of C={heads * hd} channels does not fit shared "
                         f"memory (B={B} H={H} W={W} heads={heads})")
    return ((B, H, W, heads, hd, float(hd) ** -0.5),
            (_DTYPE_CODE[dtype], p["variant"] == "vec", p["rank"], *p["tile"],
             p["heads_per_block"], p["threads"], p["blocks"], p["smem"]))


def _check(q, k, v, rpb, kernel_size: int) -> tuple[int, int]:
    """Validate shapes; returns (heads, head_dim)."""
    if kernel_size != 3:
        raise ValueError(f"the B3 kernel takes kernel_size 3 (the model's), not {kernel_size}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be one NHWC shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    heads = rpb.shape[0]
    if tuple(rpb.shape) != (heads, 5, 5) or q.shape[-1] % heads:
        raise ValueError(f"rpb {tuple(rpb.shape)} does not fit C={q.shape[-1]}")
    return heads, q.shape[-1] // heads


def _launch(q, k, v, rpb, heads: int, hd: int) -> torch.Tensor:
    B, H, W, C = q.shape
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"the B3 kernel takes float32 or bfloat16, not {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q's dtype and device")
    if rpb.dtype != torch.float32 or rpb.device != q.device:
        raise ValueError("rpb must be float32 on q's device")
    for name, t in (("q", q), ("k", k), ("v", v), ("rpb", rpb)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if H < 3 or W < 3:
        raise ValueError(f"feature map {H}x{W} smaller than the 3x3 window")
    dev = q.get_device()
    if dev != torch._C._cuda_getDevice():
        with torch.cuda.device(dev):
            return _launch(q, k, v, rpb, heads, hd)
    shape, plan = _plan_args(B, H, W, heads, hd, q.dtype)
    q, k, v = aligned(q), aligned(k), aligned(v)
    out = torch.empty_like(q)
    err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), rpb.data_ptr(), out.data_ptr(),
                    *shape, *plan, torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        what = "tensor-map encode failed: CUresult" if err < 0 else "launch failed: CUDA error"
        raise RuntimeError(f"nat_kernel {what} {abs(err)}")
    neighborhood_attention_pallas.launches += 1
    return out


class _NatPallas(torch.autograd.Function):
    """The B3 forward; the backward is autograd of the plain NAT."""

    @staticmethod
    def forward(ctx, q, k, v, rpb, heads, hd):
        ctx.save_for_backward(q, k, v, rpb)
        return _launch(q, k, v, rpb, heads, hd)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            prim = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = neighborhood_attention(*prim, 3)
            grads = torch.autograd.grad(out, prim, g)
        return (*grads, None, None)


def neighborhood_attention_pallas(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rpb: torch.Tensor,
    kernel_size: int = 3,
) -> torch.Tensor:
    """NAT (k=3, NATTEN semantics, scale head_dim ** -0.5) on NHWC (B, H, W, C)
    q, k, v with the (heads, 5, 5) float32 bias ``rpb``; differentiable.
    Returns (B, H, W, C) in q's dtype. Each launch of the CUDA forward adds
    one to ``neighborhood_attention_pallas.launches``."""
    heads, hd = _check(q, k, v, rpb, kernel_size)
    if q.is_cpu:
        return neighborhood_attention_pallas_plain(q, k, v, rpb)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, rpb)):
        return _NatPallas.apply(q, k, v, rpb, heads, hd)
    return _launch(q, k, v, rpb, heads, hd)


def neighborhood_attention_pallas_plain(q, k, v, rpb) -> torch.Tensor:
    """The plain PyTorch version: ``ops/nat.py::neighborhood_attention``."""
    return neighborhood_attention(q, k, v, rpb, 3)


neighborhood_attention_pallas.launches = 0

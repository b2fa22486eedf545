"""2x bilinear upsample (align_corners=True) on NHWC tensors through the
kernel B7.

Counterpart of ``lmnet_tpu/ops/pallas/upsample_flat.py`` (``upsample2x_flat``,
selected in JAX by ``LMNET_UPSAMPLE_BACKEND=flat``; here through
``ops/resize.py``). On CUDA tensors it launches the hand-written kernel
``csrc/upsample_flat.cu`` (built by ``ops/_build.py``; a failed build,
tensor-map encode or launch raises) with the launch geometry of
``upsample_plan``, which the kernel checks against its own: variant 'tma'
(a tile and its halo brought into shared memory by TMA copies of up to 6
rows, 16-byte stores of whole output rows) wherever a pixel's bytes are a
multiple of 16, else 'generic'. Where a gradient is wanted it is a
``torch.autograd.Function`` whose backward is the exact adjoint, autograd of
the plain lerp in float32, as JAX's is the transposed lerp matrices in
float32; elsewhere the call goes straight to the kernel. On CPU tensors it
is ``upsample2x_flat_plain``. Unlike the TPU kernel it takes every H, W >= 1
(JAX sends H % 8 != 0 or W*C % 128 != 0 to its einsum path).

The kernel takes a row window (``parallel/spatial.py``): a slab of rows of
a map of global height Hg, and the slab row ``top`` and global row ``row0``
of the first of the ``rows`` input rows whose outputs it writes; the phase
weights and the clamp at the map's edges are the global ones. Inside an H
shard ``upsample2x_flat`` gives it this rank's rows with one row of each
neighbour (none past the global edges); its backward is the adjoint of the
windowed lerp on the slab, and the exchange's backward sends the halo rows'
part home.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from lmnet_tpu_torch.ops import _build
from lmnet_tpu_torch.ops._build import aligned
from lmnet_tpu_torch.parallel.spatial import row_window

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# csrc/upsample_flat.cu's constants: the card's SMs, threads and tile bytes a
# 'tma' block, rows a TMA copy moves, threads a row of the tile a block
# starts from, channels a block (a TMA box dimension's limit), threads a
# 'generic' block, the grid's y and z limit
UP_SMS = 132
UP_MAX_THREADS = 512
UP_TILE_BYTES = 32 * 1024
UP_BOX_ROWS = 6
UP_THREADS_PER_ROW = 48
UP_MAX_CHUNK = 256
UP_GENERIC_THREADS = 256
GRID_MAX = 65535


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _vec_bytes(n: int) -> int:
    """The widest unit of 2, 4, 8 or 16 bytes that divides n bytes."""
    return min(16, n & -n)


@functools.lru_cache(maxsize=None)
def upsample_plan(B: int, H: int, W: int, C: int, dtype: torch.dtype, Hs: int | None = None):
    """The launch geometry of ``csrc/upsample_flat.cu`` for the outputs of H
    input rows of a (B, Hs, W, C) slab x of ``dtype`` (``Hs`` None: H, the
    whole map), or None for a shape it does not take (a grid dimension past
    65535). The tiles cover the H rows; only the tensor map sees Hs.

    ``variant`` 'tma' where a pixel's C x dtype bytes are a multiple of 16
    (every tensor map's stride must be): a block owns ``tile`` (rows,
    columns) of input pixels and ``chunk`` <= 256 channels, copied with
    their one-pixel halo (rows + 2 rows) in ``copies`` TMA copies of a
    ``box`` (channels, columns + 2, up to 6 rows) of the 3-D ``map`` (dims
    (C, W, B*Hs), byte ``strides``), each on its own barrier, into shared
    memory from byte ``offset`` 128 of a 128-byte aligned base, one every
    ``copy_stride`` bytes (the barriers before them, 128 bytes to spare for
    the alignment). The tile has 32 columns, fewer where a block's output
    row of 2 x columns x chunk / vec threads would pass 512, and threads /
    48 rows (8 at 384 threads, 4 at 192; 2 to 16), halved while its shared
    memory passes 32 KB or the grid has fewer blocks than SMs (the fastest
    of the tiles tried on the H100 at the model's four shapes). ``generic``
    otherwise: ``tile`` (1, pixels a block), one thread per (pixel, ``vec``
    elements). ``threads``; ``grid`` (column blocks, row blocks, images x
    channel chunks); ``smem`` dynamic shared-memory bytes. The same function
    as ``upsample_flat.cu::up_plan``. Cached: the caller must not change the
    dict."""
    Hs = H if Hs is None else Hs
    if dtype not in _DTYPE_CODE or B <= 0 or H <= 0 or W <= 0 or C <= 0 or Hs < H:
        return None
    es = 4 if dtype == torch.float32 else 2
    if C * es % 16 == 0:
        V = 16 // es
        cc = min(C, UP_MAX_CHUNK)
        nchunk = _cdiv(C, cc)
        cpp = cc // V
        tw = 32
        while tw > 1 and 2 * tw * cpp > UP_MAX_THREADS:
            tw //= 2
        tw = min(tw, W)
        threads = -(-2 * tw * cpp // 32) * 32
        th = min(H, max(2, min(16, threads // UP_THREADS_PER_ROW)))
        while th > 1 and (th + 2) * (tw + 2) * cc * es > UP_TILE_BYTES:
            th //= 2
        while th > 1 and _cdiv(W, tw) * _cdiv(H, th) * B * nchunk < UP_SMS:
            th //= 2
        grid = (_cdiv(W, tw), _cdiv(H, th), B * nchunk)
        if grid[1] > GRID_MAX or grid[2] > GRID_MAX:
            return None
        rb = min(th + 2, UP_BOX_ROWS)
        copies = _cdiv(th + 2, rb)
        stride = -(-rb * (tw + 2) * cc * es // 128) * 128  # a copy's bytes, on 128
        return dict(variant="tma", tile=(th, tw), chunk=cc, vec=V,
                    threads=threads, grid=grid,
                    smem=256 + copies * stride,
                    map=dict(dims=(C, W, B * Hs), strides=(C * es, W * C * es)),
                    box=(cc, tw + 2, rb), copies=copies, offset=128, copy_stride=stride)
    V = _vec_bytes(C * es) // es
    cpp = C // V
    ppx = min(max(1, UP_GENERIC_THREADS // cpp), W)
    if H > GRID_MAX or B > GRID_MAX:
        return None
    return dict(variant="generic", tile=(1, ppx), chunk=C, vec=V,
                threads=-(-min(ppx * cpp, UP_GENERIC_THREADS) // 32) * 32,
                grid=(_cdiv(W, ppx), H, B), smem=0, map=None, box=None, copies=0, offset=None,
                copy_stride=None)


def kernel_plan(B: int, H: int, W: int, C: int, dtype: torch.dtype, Hs: int | None = None):
    """The plan the CUDA source itself computes for this call
    (``lmnet_upsample2x_plan``), in ``upsample_plan``'s keys, with the map,
    box, copies, offset and copy stride the launch encodes and the kernel
    reads; None for a shape it refuses. Builds and loads the kernel's
    library: card only."""
    fn = _build.load("upsample_flat").lmnet_upsample2x_plan
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = None
    out = (ctypes.c_longlong * 22)()
    fn(B, H, W, C, H if Hs is None else Hs, _DTYPE_CODE[dtype], ctypes.addressof(out))
    tma, th, tw, cc, vec, threads, gx, gy, gz, smem, *geo, ok = out
    if not ok:
        return None
    dims, strides, box, (copies, offset, copy_stride) = geo[:3], geo[3:5], geo[5:8], geo[8:]
    return dict(variant="tma" if tma else "generic", tile=(th, tw), chunk=cc, vec=vec,
                threads=threads, grid=(gx, gy, gz), smem=smem,
                map=dict(dims=tuple(dims), strides=tuple(strides)) if tma else None,
                box=tuple(box) if tma else None, copies=copies,
                offset=offset if tma else None, copy_stride=copy_stride if tma else None)


def _kernel():
    fn = _build.load("upsample_flat").lmnet_upsample2x
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
    return fn


def _check_window(Hs: int, top: int, rows: int, Hg: int, row0: int) -> None:
    """Raise unless the slab of Hs rows holds the ``rows`` input rows from
    slab row ``top`` (global row ``row0`` of Hg) and their neighbours
    inside the global map."""
    if not (0 <= top and top + rows <= Hs and 0 <= row0 and row0 + rows <= Hg
            and (row0 == 0 or top >= 1) and (row0 + rows == Hg or top + rows < Hs)):
        raise ValueError(f"a slab of {Hs} rows does not hold rows [{top}, {top + rows}) (global "
                         f"[{row0}, {row0 + rows}) of {Hg}) and their neighbours")


@functools.lru_cache(maxsize=None)
def _plan_args(B: int, H: int, W: int, C: int, dtype: torch.dtype, Hs: int, top: int, Hg: int,
               row0: int):
    """The shape, dtype, plan and row window as the one array of 16 numbers
    the C entry takes (kept alive by the cache); raises for what the kernel
    does not take."""
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"upsample2x_flat takes float32 or bfloat16, not {dtype}")
    _check_window(Hs, top, H, Hg, row0)
    p = upsample_plan(B, H, W, C, dtype, Hs)
    if p is None:
        raise ValueError(f"upsample2x_flat does not take B={B} H={H} W={W} C={C}")
    return (ctypes.c_longlong * 16)(B, H, W, C, _DTYPE_CODE[dtype], p["variant"] == "tma",
                                    *p["tile"], p["chunk"], p["vec"], p["threads"], p["smem"],
                                    Hs, top, Hg, row0)


def _launch(x: torch.Tensor, window: tuple | None = None) -> torch.Tensor:
    """The kernel on the slab ``x`` (B, Hs, W, C) at ``window`` (top, rows,
    Hg, row0; None: the whole map)."""
    dev = x.get_device()
    if dev != torch._C._cuda_getDevice():
        with torch.cuda.device(dev):
            return _launch(x, window)
    B, Hs, W, C = x.shape
    top, H, Hg, row0 = (0, Hs, Hs, 0) if window is None else window
    args = _plan_args(B, H, W, C, x.dtype, Hs, top, Hg, row0)
    out = x.new_empty((B, 2 * H, 2 * W, C))
    err = _kernel()(x.data_ptr(), out.data_ptr(), args, torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        what = "tensor-map encode failed: CUresult" if err < 0 else "launch failed: CUDA error"
        raise RuntimeError(f"upsample_flat {what} {abs(err)}")
    upsample2x_flat.launches += 1
    return out


def _lerp2x(x: torch.Tensor, axis: int) -> torch.Tensor:
    """The 2x align_corners=True lerp of float32 ``x`` along ``axis``: even
    output 2k = x[k] + a_k (x[k-1] - x[k]), a_k = k / (2S-1); odd 2k+1 =
    x[k] + b_k (x[k+1] - x[k]), b_k = (S-1-k) / (2S-1); the clamped border
    neighbour has weight 0."""
    S = x.shape[axis]
    k = torch.arange(S, device=x.device, dtype=torch.float32)
    shape = [1] * x.dim()
    shape[axis] = S
    a = (k / (2 * S - 1)).reshape(shape)
    b = ((S - 1 - k) / (2 * S - 1)).reshape(shape)
    idx = torch.arange(S, device=x.device)
    xm1 = x.index_select(axis, (idx - 1).clamp_min(0))
    xp1 = x.index_select(axis, (idx + 1).clamp_max(S - 1))
    even = x + a * (xm1 - x)
    odd = x + b * (xp1 - x)
    out = torch.stack([even, odd], dim=axis + 1)
    return out.reshape(*x.shape[:axis], 2 * S, *x.shape[axis + 1:])


def _lerp2x_rows(x: torch.Tensor, top: int, rows: int, Hg: int, row0: int) -> torch.Tensor:
    """``_lerp2x`` along axis 1 at a row window: the outputs of the ``rows``
    input rows from slab row ``top`` of float32 ``x``, which are global rows
    ``row0`` .. of a map of ``Hg`` rows, with the global weights and the
    global clamp (the neighbours read from the slab)."""
    k = torch.arange(row0, row0 + rows, device=x.device, dtype=torch.float32)
    a = (k / (2 * Hg - 1)).reshape(1, rows, 1, 1)
    b = ((Hg - 1 - k) / (2 * Hg - 1)).reshape(1, rows, 1, 1)
    kg = torch.arange(row0, row0 + rows, device=x.device)
    idx = kg - row0 + top
    xk = x.index_select(1, idx)
    xm1 = x.index_select(1, torch.where(kg > 0, idx - 1, idx))
    xp1 = x.index_select(1, torch.where(kg < Hg - 1, idx + 1, idx))
    out = torch.stack([xk + a * (xm1 - xk), xk + b * (xp1 - xk)], dim=2)
    return out.reshape(x.shape[0], 2 * rows, *x.shape[2:])


def upsample2x_flat_plain(x: torch.Tensor, top: int = 0, rows: int | None = None,
                          Hg: int | None = None, row0: int = 0) -> torch.Tensor:
    """The plain PyTorch version: the phase lerp along H, then along W, in
    float32, rounded once to x's dtype; at a row window (the outputs of the
    ``rows`` input rows from slab row ``top``, global row ``row0`` of a map
    of ``Hg`` rows; default the whole map)."""
    rows = x.shape[1] - top if rows is None else rows
    Hg = x.shape[1] if Hg is None else Hg
    _check_window(x.shape[1], top, rows, Hg, row0)
    return _lerp2x(_lerp2x_rows(x.float(), top, rows, Hg, row0), 2).to(x.dtype)


class _Upsample2xFlat(torch.autograd.Function):
    """The B7 forward on a slab; the backward is the float32 adjoint of the
    windowed lerp, the slab's gradient."""

    @staticmethod
    def forward(ctx, x, window):
        ctx.shape, ctx.dtype, ctx.window = x.shape, x.dtype, window
        return _launch(x, window)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            x = torch.zeros(ctx.shape, dtype=torch.float32, device=g.device, requires_grad=True)
            out = _lerp2x(_lerp2x_rows(x, *ctx.window), 2)
            (gx,) = torch.autograd.grad(out, x, g.float())
        return gx.to(ctx.dtype), None


def upsample2x_flat(x: torch.Tensor) -> torch.Tensor:
    """``nn.Upsample(scale_factor=2, mode='bilinear', align_corners=True)`` on
    NHWC (B, H, W, C) ``x`` -> (B, 2H, 2W, C) in x's dtype, float32 math;
    differentiable. On a CUDA tensor a permuted view, or one whose data
    does not start on 16 bytes, is copied to a contiguous one first; each
    launch of the kernel adds one to ``upsample2x_flat.launches``. Inside an
    H shard ``x`` is this rank's rows of a map of global height size x H:
    the kernel runs on its slab with one row of each neighbour, in global
    coordinates, and gives this rank's 2H output rows."""
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC, got {tuple(x.shape)}")
    slab, *window = row_window(x, 1, 1, edges=False)
    window = tuple(window)
    if x.is_cpu:
        return upsample2x_flat_plain(slab, *window)
    slab = aligned(slab.contiguous())
    if slab.requires_grad and torch.is_grad_enabled():
        return _Upsample2xFlat.apply(slab, window)
    return _launch(slab, window)


upsample2x_flat.launches = 0

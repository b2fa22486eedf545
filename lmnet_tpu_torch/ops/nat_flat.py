"""Neighborhood attention (k=3) on flat ``(B, H, W*C)`` activations, with its
gradient.

Counterpart of ``lmnet_tpu/ops/pallas/nat_flat.py`` (``nat_flat`` and its
``custom_vjp`` backward ``nat_flat_bwd``). On CUDA tensors ``nat_flat`` is a
``torch.autograd.Function``: its forward launches the hand-written kernel
``csrc/nat_fwd.cu`` (B1) and saves only q, k, v and rpb, as JAX's
``custom_vjp`` saves the primals; its backward launches ``csrc/nat_bwd.cu``
(B2), which recomputes the softmax in shared memory. Where no gradient is
wanted the forward launches without the Function. Both kernels are tiled:
a block stages the k/v halo of its tile of pixels in shared memory with
``cp.async`` copies of up to 16 bytes and reads q (and g) as vectors, with
the launch geometry of ``nat_plan``, which each kernel checks against its
own. Both are
built by ``ops/_build.py``; a failed build or launch raises. On CPU tensors
``nat_flat`` runs the plain version, ``ops/nat.py::neighborhood_attention``,
and autograd differentiates it. ``nat_flat_bwd_plain`` is the plain backward
the kernel is held against. Unlike the TPU kernels, the CUDA kernels take
every shape with H, W >= 3: any head_dim (1, 2, 4 and 8 in the vectorised
variants, others in a generic one), any row count, any width.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from lmnet_tpu_torch.ops import _build
from lmnet_tpu_torch.ops._build import aligned
from lmnet_tpu_torch.ops.nat import neighborhood_attention

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# csrc/nat_common.cuh's constants: the card's SMs, a block's shared memory
# on sm_90 and the share a plan aims for (two blocks an SM), heads a block,
# threads a block and B1's heads a thread at most, the tiles plans start from
NAT_SMS = 132
MAX_SMEM = 232448
SMEM_TARGET = MAX_SMEM // 2
MAX_BLOCK_HEADS = 32
MAX_THREADS = 384
MAX_HEADS_PER_THREAD = 4
FWD_TILE = (32, 32)
BWD_TILE = (32, 16)


def _r16(x: int) -> int:
    return -(-x // 16) * 16


def _vec_bytes(n: int) -> int:
    """The widest copy unit of 2, 4, 8 or 16 bytes that divides n bytes."""
    return min(16, n & -n)


def _smem(kind: str, vec: bool, rows: int, cols: int, nh: int, hd: int, es: int,
          threads: int) -> int:
    """Dynamic shared-memory bytes of a block (nat_common.cuh::layout)."""
    ck = nh * hd * es
    rp = _r16(25 * nh * 4)
    if kind == "fwd":  # k and v halos, rpb
        return 2 * (_r16((rows + 2) * (cols + 2) * ck) if vec else 0) + rp
    # a record per query-halo pixel and head (head_dim 1: q scaled, g, lse,
    # delta in float32; else lse, delta), rpb, then the k and v halos; the
    # d_rpb sums reuse the space
    rec = 4 if vec and hd == 1 else 2  # a record's floats
    stats = _r16((rows + 4) * (cols + 4) * nh * rec * 4)
    halos = 2 * _r16((rows + 6) * (cols + 6) * ck) if vec else 0
    return max(stats + rp + halos, _r16(25 * threads * 4))


def _group_channels(hd: int, C: int, es: int) -> int:
    """A thread's channels in B1's (and B3's) vectorised variant
    (``nat_common.cuh::group_channels``): 16 or else 8 bytes of at most 4
    whole heads that divide C; a float32 head of 8 takes 32 bytes; 0 if
    none."""
    if hd == 8 and es == 4:
        return 8
    return next((gb // es for gb in (16, 8)
                 if hd <= gb // es <= MAX_HEADS_PER_THREAD * hd and C % (gb // es) == 0), 0)


def _pixels_per_pass(tpp: int) -> int:
    ppb = 128
    while ppb > 1 and tpp * ppb > MAX_THREADS:
        ppb //= 2
    return ppb


@functools.lru_cache(maxsize=None)
def nat_plan(B: int, H: int, W: int, heads: int, hd: int, dtype: torch.dtype, kind: str):
    """The launch geometry of ``csrc/nat_fwd.cu`` (kind 'fwd') or
    ``csrc/nat_bwd.cu`` ('bwd') for (B, H, W*heads*hd) activations of
    ``dtype``, or None for a shape it does not take.

    ``variant`` 'vec' (head_dim 1, 2, 4 or 8 at compile time, halos staged
    in shared memory; B1's thread owns ``heads_per_thread`` heads, 16 or 8
    bytes of channels) or 'generic' (one head a thread, any head_dim, no
    staging); ``tile`` (rows, columns) of pixels a block owns: 32 x 32 (B1)
    or 32 x 16 (B2), with the rows halved while the grid has fewer than two
    blocks an SM; ``heads_per_block``, halved while the shared memory
    passes half an SM's; ``threads``; ``grid`` (column tiles, row tiles,
    images x head chunks); ``smem`` dynamic shared-memory bytes;
    ``vec_bytes`` the halo copy unit; ``workspace`` B2's float32 d_rpb
    partials. The same function as ``nat_common.cuh::make_plan``. Cached:
    the caller must not change the dict."""
    if kind not in ("fwd", "bwd") or dtype not in _DTYPE_CODE:
        return None
    if B <= 0 or H < 3 or W < 3 or heads <= 0 or hd <= 0 or (kind == "bwd" and heads > 256):
        return None
    es = 4 if dtype == torch.float32 else 2
    C = heads * hd
    vec = hd in (1, 2, 4, 8)
    per = 1
    if kind == "fwd":
        g = _group_channels(hd, C, es)
        vec = vec and g > 0
        per = g // hd if vec else 1
        rows, cols = FWD_TILE
    else:
        rows, cols = BWD_TILE
    rows, cols = min(rows, H), min(cols, W)
    nh = min(heads, MAX_BLOCK_HEADS) // per * per

    def blocks():
        return -(-W // cols) * -(-H // rows) * B * -(-heads // nh)

    def smem():
        tpp = nh // per
        return _smem(kind, vec, rows, cols, nh, hd, es, tpp * _pixels_per_pass(tpp))

    while rows > 2 and blocks() < 2 * NAT_SMS:
        rows //= 2
    while smem() > SMEM_TARGET:
        if nh > per:
            nh = max(per, nh // 2 // per * per)
        elif cols > 8:
            cols //= 2
        elif rows > 1:
            rows //= 2
        else:
            break
    if smem() > MAX_SMEM:
        return None
    ppb = _pixels_per_pass(nh // per)
    grid = (-(-W // cols), -(-H // rows), B * -(-heads // nh))
    if grid[1] > 65535 or grid[2] > 65535:
        return None
    return dict(kind=kind, variant="vec" if vec else "generic", heads_per_thread=per,
                tile=(rows, cols), heads_per_block=nh, threads=nh // per * ppb, grid=grid,
                smem=smem(), vec_bytes=min(_vec_bytes(nh * hd * es), _vec_bytes(C * es)),
                workspace=B * grid[0] * grid[1] * heads * 25 if kind == "bwd" else 0)


def _fwd_kernel():
    fn = _build.load("nat_fwd").lmnet_nat_fwd
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = ([p] * 5 + [i] * 5 + [ctypes.c_float] + [i] * 7
                       + [ctypes.c_longlong, i, p])
        fn.restype = ctypes.c_int
    return fn


def _bwd_kernel():
    fn = _build.load("nat_bwd").lmnet_nat_bwd
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        ll = ctypes.c_longlong
        fn.argtypes = [p] * 10 + [i] * 5 + [ctypes.c_float] + [i] * 6 + [ll, i, ll, p]
        fn.restype = ctypes.c_int
    return fn


def _check_shapes(q, k, v, rpb, heads: int, C: int, W: int) -> tuple[int, int, int]:
    """Validate the flat layout; returns (B, H, head_dim)."""
    if q.dim() != 3:
        raise ValueError(f"q must be (B, H, W*C), got {tuple(q.shape)}")
    B, H, WC = q.shape
    if WC != W * C or C % heads:
        raise ValueError(f"W*C={W}*{C} vs {WC}, heads={heads}: inconsistent")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("q, k and v must have one shape")
    if tuple(rpb.shape) != (heads, 5, 5):
        raise ValueError(f"rpb must be ({heads}, 5, 5), got {tuple(rpb.shape)}")
    return B, H, C // heads


def _check_cuda(q, rpb, H: int, W: int, heads: int, **others) -> None:
    """What the CUDA kernels take: float32 or bfloat16 activations of one
    dtype and device, float32 rpb, contiguous, H and W >= 3."""
    if q.device.type != "cuda":
        raise ValueError(f"nat_flat runs on cpu or cuda tensors, not {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"nat_flat takes float32 or bfloat16, not {q.dtype}")
    for name, t in others.items():
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q's dtype and device")
    if rpb.dtype != torch.float32 or rpb.device != q.device:
        raise ValueError("rpb must be float32 on q's device")
    if H < 3 or W < 3:
        raise ValueError(f"feature map {H}x{W} smaller than the 3x3 window")
    for name, t in (("q", q), ("rpb", rpb), *others.items()):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def kernel_plan(B: int, H: int, W: int, heads: int, hd: int, dtype: torch.dtype, kind: str):
    """The plan the CUDA source itself computes for this call
    (``nat_common.cuh::export_plan``), in ``nat_plan``'s keys, or None for a
    shape it refuses. Builds and loads the kernel's library: card only."""
    fn = getattr(_build.load(f"nat_{kind}"), f"lmnet_nat_{kind}_plan")
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = None
    out = (ctypes.c_longlong * 14)()
    fn(B, H, W, heads, hd, _DTYPE_CODE[dtype], ctypes.addressof(out))
    (vec, per, rows, cols, nh, ppb, threads, gx, gy, gz, vb, smem, workspace, ok) = out
    if not ok:
        return None
    return dict(kind=kind, variant="vec" if vec else "generic", heads_per_thread=per,
                tile=(rows, cols), heads_per_block=nh, threads=threads, grid=(gx, gy, gz),
                smem=smem, vec_bytes=vb, workspace=workspace)


@functools.lru_cache(maxsize=None)
def _plan_args(B, H, W, heads, hd, dtype, kind) -> tuple:
    """The plan's numbers in the order the C entry takes them; raises for a
    shape the kernel does not take."""
    p = nat_plan(B, H, W, heads, hd, dtype, kind)
    if p is None:
        raise ValueError(f"nat_{kind} does not take B={B} H={H} W={W} heads={heads} hd={hd}")
    per = (p["heads_per_thread"],) if kind == "fwd" else ()
    ws = (p["workspace"],) if kind == "bwd" else ()
    return (B, H, W, heads, hd), (_DTYPE_CODE[dtype], p["variant"] == "vec", *per, *p["tile"],
                                  p["heads_per_block"], p["threads"], p["smem"],
                                  p["vec_bytes"], *ws), p["workspace"]


def _call(name: str, fn, ptrs, shape, scale, plan, device) -> None:
    """Call the C entry on ``device``'s current stream; raise on its error."""
    if device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return _call(name, fn, ptrs, shape, scale, plan, device)
    err = fn(*ptrs, *shape, scale, *plan, torch._C._cuda_getCurrentRawStream(device.index))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _launch_fwd(q, k, v, rpb, heads: int, C: int, W: int, scale: float) -> torch.Tensor:
    B, H, _ = q.shape
    shape, plan, _ = _plan_args(B, H, W, heads, C // heads, q.dtype, "fwd")
    q, k, v = aligned(q), aligned(k), aligned(v)
    out = torch.empty_like(q)
    _call("nat_fwd", _fwd_kernel(), (q.data_ptr(), k.data_ptr(), v.data_ptr(), rpb.data_ptr(),
                                     out.data_ptr()), shape, scale, plan, q.device)
    nat_flat.launches += 1
    return out


def _launch_bwd(q, k, v, rpb, g, heads: int, C: int, W: int, scale: float):
    B, H, _ = q.shape
    shape, plan, workspace = _plan_args(B, H, W, heads, C // heads, q.dtype, "bwd")
    q, k, v, g = aligned(q), aligned(k), aligned(v), aligned(g)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    drpb = torch.empty_like(rpb)
    part = torch.empty(workspace, dtype=torch.float32, device=q.device)
    _call("nat_bwd", _bwd_kernel(), (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                                     rpb.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                                     drpb.data_ptr(), part.data_ptr()), shape, scale, plan,
          q.device)
    nat_flat_bwd.launches += 1
    return dq, dk, dv, drpb


class _NatFlat(torch.autograd.Function):
    """The CUDA forward, and the CUDA backward from the saved primals."""

    @staticmethod
    def forward(ctx, q, k, v, rpb, heads, C, W, scale):
        ctx.save_for_backward(q, k, v, rpb)
        ctx.config = (heads, C, W, scale)
        return _launch_fwd(q, k, v, rpb, heads, C, W, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, rpb = ctx.saved_tensors
        grads = nat_flat_bwd(q, k, v, rpb, g.contiguous(), *ctx.config)
        return (*grads, None, None, None, None)


def nat_flat(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rpb: torch.Tensor,
    heads: int,
    C: int,
    W: int,
    scale: float | None = None,
) -> torch.Tensor:
    """NAT (k=3, NATTEN semantics) on flat (B, H, W*C) q, k, v; differentiable.

    ``rpb`` is the (heads, 5, 5) float32 bias; ``scale`` defaults to
    head_dim ** -0.5. Returns (B, H, W*C) in q's dtype. Each launch of the
    CUDA forward adds one to ``nat_flat.launches``; its backward counts in
    ``nat_flat_bwd.launches``.
    """
    B, H, hd = _check_shapes(q, k, v, rpb, heads, C, W)
    scale = float(hd) ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        out = neighborhood_attention(
            q.reshape(B, H, W, C), k.reshape(B, H, W, C), v.reshape(B, H, W, C),
            rpb, 3, scale=scale,
        )
        return out.reshape(B, H, W * C)
    _check_cuda(q, rpb, H, W, heads, k=k, v=v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, rpb)):
        return _NatFlat.apply(q, k, v, rpb, heads, C, W, scale)
    return _launch_fwd(q, k, v, rpb, heads, C, W, scale)


def nat_flat_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rpb: torch.Tensor,
    g: torch.Tensor,
    heads: int,
    C: int,
    W: int,
    scale: float,
):
    """Gradient of ``nat_flat`` at (q, k, v, rpb) for the output cotangent
    ``g``: returns (dq, dk, dv, d_rpb), dq/dk/dv in q's dtype, d_rpb float32.

    On CUDA tensors it launches ``csrc/nat_bwd.cu`` (one more in
    ``nat_flat_bwd.launches``); two calls with the same inputs give bitwise
    equal results. On CPU tensors it is ``nat_flat_bwd_plain``.
    """
    B, H, _ = _check_shapes(q, k, v, rpb, heads, C, W)
    if g.shape != q.shape:
        raise ValueError(f"g must have q's shape {tuple(q.shape)}, got {tuple(g.shape)}")
    if q.device.type == "cpu":
        return nat_flat_bwd_plain(q, k, v, rpb, g, heads, C, W, scale)
    _check_cuda(q, rpb, H, W, heads, k=k, v=v, g=g)
    return _launch_bwd(q, k, v, rpb, g, heads, C, W, float(scale))


def nat_flat_bwd_plain(q, k, v, rpb, g, heads: int, C: int, W: int, scale: float):
    """The plain PyTorch backward: ``torch.autograd.grad`` of
    ``ops/nat.py::neighborhood_attention`` at (q, k, v, rpb) for cotangent
    ``g``. Returns (dq, dk, dv, d_rpb) in the dtypes of q, k, v and rpb."""
    B, H, _ = _check_shapes(q, k, v, rpb, heads, C, W)
    with torch.enable_grad():
        prim = [t.detach().requires_grad_() for t in (q, k, v, rpb)]
        out = neighborhood_attention(
            *(t.reshape(B, H, W, C) for t in prim[:3]), prim[3], 3, scale=scale
        )
        return torch.autograd.grad(out.reshape(B, H, W * C), prim, g)


nat_flat.launches = 0
nat_flat_bwd.launches = 0

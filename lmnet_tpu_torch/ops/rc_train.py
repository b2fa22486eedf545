"""The train-mode ReparamConv branches fused: four depthwise convs, their
batch-statistic BatchNorms, the sum, tanh GELU and the SE channel sums,
without writing any branch out.

Counterpart of ``lmnet_tpu/ops/pallas/rc_train.py`` (``rc_branch_stats``,
``_fold_stats``, ``rc_branch_act`` and its ``custom_vjp``). Summing
batch-normalised parallel depthwise branches is one combined depthwise conv,

    sum_i BN_i(dw_i(e)) = dw_K(e) + b,
    K = sum_i (gamma_i / sigma_i) embed_5x5(k_i),
    b = sum_i (beta_i - gamma_i mu_i / sigma_i),

with (mu_i, sigma_i) the batch statistics of branch i. So the forward is the
statistics kernel ``csrc/rc_stats.cu`` (``rc_branch_stats``), the fold
(``ops/reparam.py::fuse_reparam_branches`` with the batch statistics), and
the B5 kernel ``csrc/rc_dw_gelu.cu`` (``ops/rc_flat.py::dw_gelu_flat``).
The backward saves only the primals and differentiates the plain branch
graph, ``rc_branch_act_plain``, as JAX's ``_rc_bwd`` does; mu and var feed
only the running-statistics update and get no gradient. On CPU tensors
``rc_branch_act`` is the plain graph itself.

Inside a data-parallel step (``parallel/batch.py::global_batch``) the
statistics are the global batch's: the forward all-reduces B6's (4, 2, C)
sums before the fold, and the plain graph, which the backward
differentiates, takes its moments through ``parallel/batch.py::moments``
(its sums all-reduced, with a gradient), as JAX's mesh gives both. Kernels are OIHW depthwise:
k5 (C, 1, 5, 5), k3 (C, 1, 3, 3), kv (C, 1, 3, 1), kh (C, 1, 1, 3).

Both kernels take a row window (``parallel/spatial.py``): a slab of rows,
the slab row ``top`` of the first output row and ``rows`` output rows;
taps outside the slab read zero and every sum covers the output rows.
Inside an H shard ``rc_branch_act`` makes the slab with one exchange of 2
rows of each neighbour (zero rows past the global edges) and hands it to
the autograd Function, whose backward returns the slab's gradient; the
exchange's backward sends the halo rows' part home. The statistics go over
the world and the global H (``global_sum``, ``global_count``, ``moments``).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from lmnet_tpu_torch.ops import _build
from lmnet_tpu_torch.ops._build import aligned
from lmnet_tpu_torch.ops.rc_flat import (
    _DTYPE_CODE,
    MAX_SMEM,
    _vec_bytes,
    check_cuda,
    chunk_channels,
    dw_gelu_flat,
    slab_window,
)
from lmnet_tpu_torch.ops.reparam import fuse_reparam_branches
from lmnet_tpu_torch.parallel.batch import global_count, global_sum, moments
from lmnet_tpu_torch.parallel.spatial import row_window

BRANCHES = ("large", "square", "ver", "hor")  # the reference's sum order
_SHAPES = ((5, 5), (3, 3), (3, 1), (1, 3))
# csrc/rc_stats.cu's constants: a block's output tile (rows, columns); the
# taps a channel keeps in shared memory (40, padded to an odd stride)
STATS_TILE = (16, 32)
_TAPS = 41


@functools.lru_cache(maxsize=None)
def stats_plan(B: int, H: int, W: int, C: int, dtype: torch.dtype, Hs: int | None = None,
               top: int = 0):
    """The launch geometry of ``csrc/rc_stats.cu`` for H output rows of e
    (B, Hs, W*C) of ``dtype`` (``Hs`` None: H), output row r at slab row
    ``top`` + r, or None for a shape or window it does not take: ``tile`` (rows,
    columns), ``chunk`` channels a block (``rc_flat.chunk_channels``),
    ``nchunk`` chunks, ``vec`` the copy unit in bytes (the widest of 16, 8,
    4, 2 that divides C's channel run), ``smem`` dynamic shared-memory bytes
    (the 20 x 36 halo in e's dtype; 41 taps a channel and 8 partials a
    thread, which computes two rows, in float32), ``ntiles`` tiles per image
    over the output rows, ``workspace`` float32 per-tile partials (8 C a
    tile), ``window`` (Hs, top). Cached: the caller must not change the
    dict."""
    Hs = H if Hs is None else Hs
    if not (0 < B <= 65535 and H > 0 and W > 0 and C > 0) or dtype not in _DTYPE_CODE:
        return None
    if top < 0 or top + H > Hs:
        return None
    rows, cols = STATS_TILE
    esize = 4 if dtype == torch.float32 else 2
    ck = chunk_channels(C)
    nchunk = -(-C // ck)
    ntiles = -(-H // rows) * -(-W // cols)
    halo = (rows + 4) * (cols + 4) * ck * esize
    smem = -(-halo // 16) * 16 + (_TAPS + 8 * (rows // 2)) * ck * 4
    if B * ntiles > 0x7FFFFFFF or nchunk > 65535 or smem > MAX_SMEM:
        return None
    return dict(tile=STATS_TILE, chunk=ck, nchunk=nchunk, vec=_vec_bytes(C * esize), smem=smem,
                ntiles=ntiles, workspace=B * ntiles * 8 * C, window=(Hs, top))


@functools.lru_cache(maxsize=None)
def _stats_args(B: int, H: int, W: int, C: int, dtype: torch.dtype, Hs: int, top: int) -> tuple:
    """(the window and the plan's numbers in the order the C entry takes
    them, from Hs to the workspace; the outputs' 8 C floats); raises for a
    shape the kernel does not take."""
    p = stats_plan(B, H, W, C, dtype, Hs, top)
    if p is None:
        raise ValueError(f"rc_stats does not take B={B} H={H} W={W} C={C} Hs={Hs} top={top}")
    return (Hs, top, _DTYPE_CODE[dtype], *p["tile"], p["chunk"], p["vec"], p["smem"],
            p["workspace"]), 8 * C


def kernel_stats_plan(B: int, H: int, W: int, C: int, dtype: torch.dtype, Hs: int | None = None,
                      top: int = 0):
    """``csrc/rc_stats.cu``'s own plan for this shape and window, in
    ``stats_plan``'s form, or None where it refuses them (builds the kernel;
    card tests hold the two equal)."""
    if dtype not in _DTYPE_CODE:
        return None
    Hs = H if Hs is None else Hs
    fn = _build.load("rc_stats").lmnet_rc_stats_plan
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * 8)()
    if fn(B, H, W, C, Hs, top, _DTYPE_CODE[dtype], ctypes.addressof(out)) != 0:
        return None
    rows, cols, ck, nchunk, vec, smem, ntiles, workspace = out
    return dict(tile=(rows, cols), chunk=ck, nchunk=nchunk, vec=vec, smem=smem, ntiles=ntiles,
                workspace=workspace, window=(Hs, top))


def _kernel():
    lib = _build.load("rc_stats")
    fn = lib.lmnet_rc_stats
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        ll = ctypes.c_longlong
        fn.argtypes = [p] * 7 + [i] * 11 + [ll, ll, p]
        fn.restype = ctypes.c_int
    return fn


def _check_shapes(e_flat, kernels, C: int) -> tuple[int, int, int]:
    """Validate the flat layout and the four branch kernels; returns (B, H, W)."""
    if e_flat.dim() != 3 or e_flat.shape[2] % C:
        raise ValueError(f"e must be (B, H, W*{C}), got {tuple(e_flat.shape)}")
    for k, (kh, kw) in zip(kernels, _SHAPES):
        if tuple(k.shape) != (C, 1, kh, kw):
            raise ValueError(f"branch kernel must be ({C}, 1, {kh}, {kw}), got {tuple(k.shape)}")
    B, H, WC = e_flat.shape
    return B, H, WC // C


def _branch_outputs(e_flat, kernels, C: int, dtype, top: int = 0, rows: int | None = None):
    """The four branch convs of NHWC e (viewed NCHW) in ``dtype``, NCHW, on
    the zero-padded slab, cut to the ``rows`` output rows from slab row
    ``top``."""
    B, Hs, WC = e_flat.shape
    top, rows = slab_window(Hs, top, rows)
    e = e_flat.reshape(B, Hs, WC // C, C).permute(0, 3, 1, 2).to(dtype)
    ys = [F.conv2d(e, k.to(dtype), padding=(kh // 2, kw // 2), groups=C)
          for k, (kh, kw) in zip(kernels, _SHAPES)]
    return ys if (top, rows) == (0, Hs) else [y[:, :, top:top + rows] for y in ys]


def rc_branch_stats(e_flat, k5, k3, kv, kh, C: int, top: int = 0,
                    rows: int | None = None) -> torch.Tensor:
    """(4, 2, C) float32: per branch (5x5, 3x3, 3x1, 1x3; no bias, zero
    padding) the sum and the sum of squares of its output over B x the
    ``rows`` output rows from slab row ``top`` of ``e_flat`` (B, Hs, W*C)
    (default: the whole slab) x W, the branch outputs never written out; a
    tap outside the slab reads zero. JAX returns (8, W*C) flat accumulators;
    ``_fold_stats`` there folds them over W.

    On CUDA tensors it launches ``csrc/rc_stats.cu`` with the launch
    geometry of ``stats_plan``, which the kernel checks (one more in
    ``rc_branch_stats.launches``; two calls give bitwise-equal results). On
    CPU tensors it is ``rc_branch_stats_plain``.
    """
    kernels = (k5, k3, kv, kh)
    B, Hs, W = _check_shapes(e_flat, kernels, C)
    top, H = slab_window(Hs, top, rows)
    if e_flat.device.type == "cpu":
        return rc_branch_stats_plain(e_flat, *kernels, C, top, H)
    kernels = [k.float().contiguous() for k in kernels]
    check_cuda("rc_branch_stats", e_flat, *kernels)
    e_flat = aligned(e_flat)
    plan, nout = _stats_args(B, H, W, C, e_flat.dtype, Hs, top)
    dev = e_flat.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return rc_branch_stats(e_flat, *kernels, C, top, H)
    # out (4, 2, C) and the partials in one allocation
    buf = torch.empty(nout + plan[-1], dtype=torch.float32, device=dev)
    out = buf[:nout].view(4, 2, C)
    err = _kernel()(e_flat.data_ptr(), *(k.data_ptr() for k in kernels), out.data_ptr(),
                    buf.data_ptr() + 4 * nout, B, H, W, C, *plan,
                    torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"rc_stats launch failed: CUDA error {err}")
    rc_branch_stats.launches += 1
    return out


def rc_branch_stats_plain(e_flat, k5, k3, kv, kh, C: int, top: int = 0,
                          rows: int | None = None) -> torch.Tensor:
    """The plain version of ``rc_branch_stats``: the four convs in float32
    on the zero-padded slab, cut to the output rows, then their sums and
    sums of squares."""
    _check_shapes(e_flat, (k5, k3, kv, kh), C)
    ys = _branch_outputs(e_flat, [k.float() for k in (k5, k3, kv, kh)], C, torch.float32,
                         top, rows)
    return torch.stack([torch.stack([y.sum(dim=(0, 2, 3)), y.square().sum(dim=(0, 2, 3))])
                        for y in ys])


def _fold_stats(stats: torch.Tensor, N: int):
    """(4, 2, C) sums -> (4, C) mu and biased var, max(E[y^2] - E[y]^2, 0)."""
    mu = stats[:, 0] / N
    return mu, torch.clamp(stats[:, 1] / N - mu.square(), min=0.0)


def rc_branch_act_plain(e_flat, k5, k3, kv, kh, gamma, beta, C: int, eps: float = 1e-5,
                        top: int = 0, rows: int | None = None):
    """The plain branch graph (JAX's ``_rc_ref_jnp``): the four branch convs
    in e's dtype (on the zero-padded slab, cut to the ``rows`` output rows
    from slab row ``top``; default the whole slab), float32 batch-statistic
    BN (biased variance, clamped at 0), the float32 sum, tanh GELU cast to
    e's dtype, and the (B, C) float32 channel sums of that t. Returns
    (t_flat, sums, mu, var); mu and var are (4, C) float32, detached."""
    B, Hs, W = _check_shapes(e_flat, (k5, k3, kv, kh), C)
    top, H = slab_window(Hs, top, rows)
    z, mus, vs = None, [], []
    for i, y in enumerate(_branch_outputs(e_flat, (k5, k3, kv, kh), C, e_flat.dtype, top, H)):
        yf = y.float()
        mean, var = moments(yf, (0, 2, 3), h_axis=2)
        bn = ((yf - mean[:, None, None]) * (torch.rsqrt(var + eps) * gamma[i])[:, None, None]
              + beta[i][:, None, None])
        z = bn if z is None else z + bn
        mus.append(mean.detach())
        vs.append(var.detach())
    t = F.gelu(z, approximate="tanh").to(e_flat.dtype)
    t_flat = t.permute(0, 2, 3, 1).reshape(B, H, W * C)
    return t_flat, t.float().sum(dim=(2, 3)), torch.stack(mus), torch.stack(vs)


def _fused_forward(e_flat, k5, k3, kv, kh, gamma, beta, C: int, eps: float, top: int,
                   rows: int):
    """Statistics kernel (its sums over the global batch, and the global H,
    in a data-parallel or sharded step) -> fold -> B5 kernel, both on the
    slab's output rows."""
    _check_shapes(e_flat, (k5, k3, kv, kh), C)
    stats = global_sum(rc_branch_stats(e_flat, k5, k3, kv, kh, C, top, rows))
    mu, var = _fold_stats(stats, global_count(e_flat[:, top:top + rows]) // C)
    branches = {
        name: dict(kernel=k.float(), scale=gamma[i], bias=beta[i], mean=mu[i], var=var[i])
        for i, (name, k) in enumerate(zip(BRANCHES, (k5, k3, kv, kh)))
    }
    K, b = fuse_reparam_branches(branches, 5, eps)
    t_flat, sums = dw_gelu_flat(e_flat, K, b, C, top, rows)
    return t_flat, sums, mu, var


class _RcBranchAct(torch.autograd.Function):
    """The fused forward on a slab; the backward differentiates the plain
    branch graph on the slab from the saved primals (JAX's ``_rc_fwd`` /
    ``_rc_bwd``) and returns the slab's gradient."""

    @staticmethod
    def forward(ctx, e_flat, k5, k3, kv, kh, gamma, beta, C, eps, top=0, rows=None):
        top, rows = slab_window(e_flat.shape[1], top, rows)
        ctx.save_for_backward(e_flat, k5, k3, kv, kh, gamma, beta)
        ctx.config = (C, eps, top, rows)
        t_flat, sums, mu, var = _fused_forward(e_flat, k5, k3, kv, kh, gamma, beta, C, eps,
                                               top, rows)
        ctx.mark_non_differentiable(mu, var)
        return t_flat, sums, mu, var

    @staticmethod
    def backward(ctx, dt, dsums, _dmu, _dvar):
        prim = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            t_flat, sums, _, _ = rc_branch_act_plain(*prim, *ctx.config)
        grads = torch.autograd.grad((t_flat, sums), prim, (dt, dsums))
        return (*grads, None, None, None, None)


def rc_branch_act(e_flat, k5, k3, kv, kh, gamma, beta, C: int, eps: float = 1e-5):
    """Fused four-branch depthwise + batch-statistic BN + sum + tanh GELU on
    flat (B, H, W*C) ``e_flat``; differentiable in every tensor argument.

    ``gamma``/``beta``: (4, C) BN affine parameters in branch order (5x5,
    3x3, 3x1, 1x3). Returns (t_flat (B, H, W*C) in e's dtype, sums (B, C)
    float32, mu (4, C), var (4, C)): the SE channel sums of t, and the batch
    statistics for the caller's running-statistics update (not
    differentiable). On CUDA tensors the forward runs the two kernels; on
    CPU tensors it is ``rc_branch_act_plain``. Inside an H shard
    ``e_flat`` is this rank's rows: both run on its slab with 2 rows of each
    neighbour (zero rows past the global edges), t is this rank's rows, the
    sums its rows' share (the caller all-reduces them for the SE), the
    statistics the global map's.
    """
    slab, top, rows, _, _ = row_window(e_flat, 2, 2)
    if e_flat.device.type == "cpu":
        return rc_branch_act_plain(slab, k5, k3, kv, kh, gamma, beta, C, eps, top, rows)
    return _RcBranchAct.apply(slab, k5, k3, kv, kh, gamma, beta, C, eps, top, rows)


rc_branch_stats.launches = 0

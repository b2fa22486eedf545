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
)
from lmnet_tpu_torch.ops.reparam import fuse_reparam_branches
from lmnet_tpu_torch.parallel.batch import global_count, global_sum, moments

BRANCHES = ("large", "square", "ver", "hor")  # the reference's sum order
_SHAPES = ((5, 5), (3, 3), (3, 1), (1, 3))
# csrc/rc_stats.cu's constants: a block's output tile (rows, columns); the
# taps a channel keeps in shared memory (40, padded to an odd stride)
STATS_TILE = (16, 32)
_TAPS = 41


@functools.lru_cache(maxsize=None)
def stats_plan(B: int, H: int, W: int, C: int, dtype: torch.dtype):
    """The launch geometry of ``csrc/rc_stats.cu`` for e (B, H, W*C) of
    ``dtype``, or None for a shape it does not take: ``tile`` (rows,
    columns), ``chunk`` channels a block (``rc_flat.chunk_channels``),
    ``nchunk`` chunks, ``vec`` the copy unit in bytes (the widest of 16, 8,
    4, 2 that divides C's channel run), ``smem`` dynamic shared-memory bytes
    (the 20 x 36 halo in e's dtype; 41 taps a channel and 8 partials a
    thread, which computes two rows, in float32), ``ntiles`` tiles per image,
    ``workspace`` float32 per-tile partials (8 C a tile). Cached: the caller
    must not change the dict."""
    if not (0 < B <= 65535 and H > 0 and W > 0 and C > 0) or dtype not in _DTYPE_CODE:
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
                ntiles=ntiles, workspace=B * ntiles * 8 * C)


@functools.lru_cache(maxsize=None)
def _stats_args(B: int, H: int, W: int, C: int, dtype: torch.dtype) -> tuple:
    """(the plan's numbers in the order the C entry takes them, from the
    dtype code to the workspace; the outputs' 8 C floats); raises for a
    shape the kernel does not take."""
    p = stats_plan(B, H, W, C, dtype)
    if p is None:
        raise ValueError(f"rc_stats does not take B={B} H={H} W={W} C={C}")
    return (_DTYPE_CODE[dtype], *p["tile"], p["chunk"], p["vec"], p["smem"],
            p["workspace"]), 8 * C


def kernel_stats_plan(B: int, H: int, W: int, C: int, dtype: torch.dtype):
    """``csrc/rc_stats.cu``'s own plan for this shape, in ``stats_plan``'s
    form, or None where it refuses the shape (builds the kernel; card
    tests hold the two equal)."""
    if dtype not in _DTYPE_CODE:
        return None
    fn = _build.load("rc_stats").lmnet_rc_stats_plan
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * 8)()
    if fn(B, H, W, C, _DTYPE_CODE[dtype], ctypes.addressof(out)) != 0:
        return None
    rows, cols, ck, nchunk, vec, smem, ntiles, workspace = out
    return dict(tile=(rows, cols), chunk=ck, nchunk=nchunk, vec=vec, smem=smem, ntiles=ntiles,
                workspace=workspace)


def _kernel():
    lib = _build.load("rc_stats")
    fn = lib.lmnet_rc_stats
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        ll = ctypes.c_longlong
        fn.argtypes = [p] * 7 + [i] * 9 + [ll, ll, p]
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


def _branch_outputs(e_flat, kernels, C: int, dtype):
    """The four branch convs of NHWC e (viewed NCHW) in ``dtype``, NCHW."""
    B, H, WC = e_flat.shape
    e = e_flat.reshape(B, H, WC // C, C).permute(0, 3, 1, 2).to(dtype)
    return [F.conv2d(e, k.to(dtype), padding=(kh // 2, kw // 2), groups=C)
            for k, (kh, kw) in zip(kernels, _SHAPES)]


def rc_branch_stats(e_flat, k5, k3, kv, kh, C: int) -> torch.Tensor:
    """(4, 2, C) float32: per branch (5x5, 3x3, 3x1, 1x3; no bias, zero
    padding) the sum and the sum of squares of its output over B*H*W, the
    branch outputs never written out. JAX returns (8, W*C) flat
    accumulators; ``_fold_stats`` there folds them over W.

    On CUDA tensors it launches ``csrc/rc_stats.cu`` with the launch
    geometry of ``stats_plan``, which the kernel checks (one more in
    ``rc_branch_stats.launches``; two calls give bitwise-equal results). On
    CPU tensors it is ``rc_branch_stats_plain``.
    """
    kernels = (k5, k3, kv, kh)
    B, H, W = _check_shapes(e_flat, kernels, C)
    if e_flat.device.type == "cpu":
        return rc_branch_stats_plain(e_flat, *kernels, C)
    kernels = [k.float().contiguous() for k in kernels]
    check_cuda("rc_branch_stats", e_flat, *kernels)
    e_flat = aligned(e_flat)
    plan, nout = _stats_args(B, H, W, C, e_flat.dtype)
    dev = e_flat.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return rc_branch_stats(e_flat, *kernels, C)
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


def rc_branch_stats_plain(e_flat, k5, k3, kv, kh, C: int) -> torch.Tensor:
    """The plain version of ``rc_branch_stats``: the four convs in float32,
    then their sums and sums of squares."""
    _check_shapes(e_flat, (k5, k3, kv, kh), C)
    ys = _branch_outputs(e_flat, [k.float() for k in (k5, k3, kv, kh)], C, torch.float32)
    return torch.stack([torch.stack([y.sum(dim=(0, 2, 3)), y.square().sum(dim=(0, 2, 3))])
                        for y in ys])


def _fold_stats(stats: torch.Tensor, N: int):
    """(4, 2, C) sums -> (4, C) mu and biased var, max(E[y^2] - E[y]^2, 0)."""
    mu = stats[:, 0] / N
    return mu, torch.clamp(stats[:, 1] / N - mu.square(), min=0.0)


def rc_branch_act_plain(e_flat, k5, k3, kv, kh, gamma, beta, C: int, eps: float = 1e-5):
    """The plain branch graph (JAX's ``_rc_ref_jnp``): the four branch convs
    in e's dtype, float32 batch-statistic BN (biased variance, clamped at
    0), the float32 sum, tanh GELU cast to e's dtype, and the (B, C) float32
    channel sums of that t. Returns (t_flat, sums, mu, var); mu and var are
    (4, C) float32, detached."""
    B, H, W = _check_shapes(e_flat, (k5, k3, kv, kh), C)
    z, mus, vs = None, [], []
    for i, y in enumerate(_branch_outputs(e_flat, (k5, k3, kv, kh), C, e_flat.dtype)):
        yf = y.float()
        mean, var = moments(yf, (0, 2, 3))
        bn = ((yf - mean[:, None, None]) * (torch.rsqrt(var + eps) * gamma[i])[:, None, None]
              + beta[i][:, None, None])
        z = bn if z is None else z + bn
        mus.append(mean.detach())
        vs.append(var.detach())
    t = F.gelu(z, approximate="tanh").to(e_flat.dtype)
    t_flat = t.permute(0, 2, 3, 1).reshape(B, H, W * C)
    return t_flat, t.float().sum(dim=(2, 3)), torch.stack(mus), torch.stack(vs)


def _fused_forward(e_flat, k5, k3, kv, kh, gamma, beta, C: int, eps: float):
    """Statistics kernel (its sums over the global batch in a data-parallel
    step) -> fold -> B5 kernel."""
    _check_shapes(e_flat, (k5, k3, kv, kh), C)
    stats = global_sum(rc_branch_stats(e_flat, k5, k3, kv, kh, C))
    mu, var = _fold_stats(stats, global_count(e_flat) // C)
    branches = {
        name: dict(kernel=k.float(), scale=gamma[i], bias=beta[i], mean=mu[i], var=var[i])
        for i, (name, k) in enumerate(zip(BRANCHES, (k5, k3, kv, kh)))
    }
    K, b = fuse_reparam_branches(branches, 5, eps)
    t_flat, sums = dw_gelu_flat(e_flat, K, b, C)
    return t_flat, sums, mu, var


class _RcBranchAct(torch.autograd.Function):
    """The fused forward; the backward differentiates the plain branch graph
    from the saved primals (JAX's ``_rc_fwd`` / ``_rc_bwd``)."""

    @staticmethod
    def forward(ctx, e_flat, k5, k3, kv, kh, gamma, beta, C, eps):
        ctx.save_for_backward(e_flat, k5, k3, kv, kh, gamma, beta)
        ctx.config = (C, eps)
        t_flat, sums, mu, var = _fused_forward(e_flat, k5, k3, kv, kh, gamma, beta, C, eps)
        ctx.mark_non_differentiable(mu, var)
        return t_flat, sums, mu, var

    @staticmethod
    def backward(ctx, dt, dsums, _dmu, _dvar):
        prim = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            t_flat, sums, _, _ = rc_branch_act_plain(*prim, *ctx.config)
        grads = torch.autograd.grad((t_flat, sums), prim, (dt, dsums))
        return (*grads, None, None)


def rc_branch_act(e_flat, k5, k3, kv, kh, gamma, beta, C: int, eps: float = 1e-5):
    """Fused four-branch depthwise + batch-statistic BN + sum + tanh GELU on
    flat (B, H, W*C) ``e_flat``; differentiable in every tensor argument.

    ``gamma``/``beta``: (4, C) BN affine parameters in branch order (5x5,
    3x3, 3x1, 1x3). Returns (t_flat (B, H, W*C) in e's dtype, sums (B, C)
    float32, mu (4, C), var (4, C)): the SE channel sums of t, and the batch
    statistics for the caller's running-statistics update (not
    differentiable). On CUDA tensors the forward runs the two kernels; on
    CPU tensors it is ``rc_branch_act_plain``.
    """
    if e_flat.device.type == "cpu":
        return rc_branch_act_plain(e_flat, k5, k3, kv, kh, gamma, beta, C, eps)
    return _RcBranchAct.apply(e_flat, k5, k3, kv, kh, gamma, beta, C, eps)


rc_branch_stats.launches = 0

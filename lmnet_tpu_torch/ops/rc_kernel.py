"""The deploy-mode ReparamConv block in two fused passes.

Counterpart of ``lmnet_tpu/ops/pallas/rc_kernel.py`` (``fused_reparam_conv``,
``fold_rc_weights``, ``_rc_xla``). The block is

    e = hardswish(We x + be)                      (expand, BN folded in)
    t = gelu_tanh(dw5x5(e) + bdw)
    s = hardsigmoid(fc2(relu(fc1(mean_hw(t)))))   (squeeze-excitation)
    y = Wp (t * s) + bp + Wsc x + bsc

On CUDA tensors ``fused_reparam_conv`` launches ``csrc/rc_fused.cu`` twice:
phase 1 computes t in the kernel and returns only its per-image channel sums
(B, E); the SE MLP runs here in float32 on them; phase 2 recomputes t, scales
it and computes both 1x1 products and the residual in the kernel body. For
bfloat16 x the kernel's 1x1 products run on the tensor cores with bf16
operands (the weights rounded to bf16 once, by ``pack_rc_weights``, and t * s
rounded to bf16) and float32 accumulation, as JAX's TPU kernel does them on
its matrix unit; float32 x keeps float32 products. ``rc_plan`` chooses the
launch geometry, which the kernel checks. A failed build or launch raises.
On CPU tensors it is ``fused_reparam_conv_plain``, which rounds at the same
points. JAX sends maps under 8x8 to XLA; the CUDA kernel takes every H, W >= 1.

Both phases take a row window (``parallel/spatial.py``; ``rc_phase1``,
``rc_phase2``): a slab of x, the slab row ``top`` of the first output row
and ``rows`` output rows. The expand runs inside the kernel, so a halo row
outside the slab gives e = 0 (the depthwise's padding), not
hardswish(be). Inside an H shard ``fused_reparam_conv`` takes the slab with
2 rows of each neighbour and none past the global edges, all-reduces phase
1's sums over the spatial group before the SE MLP (the global H x W's
mean) and runs phase 2 on the same slab.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Mapping

import torch
import torch.nn.functional as F

from lmnet_tpu_torch.ops import _build
from lmnet_tpu_torch.ops._build import aligned
from lmnet_tpu_torch.ops.rc_flat import (
    BN_EPS,
    MAX_SMEM,
    _DTYPE_CODE,
    check_cuda,
    fold_rc_flat_weights,
    se_scale,
    slab_window,
)
from lmnet_tpu_torch.parallel.spatial import global_rows, row_window, spatial_sum

# csrc/rc_fused.cu's constants: two blocks for each of the H100's 132 SMs,
# the y tiles a warp keeps in registers, the output tile's rows
MIN_BLOCKS = 2 * 132
MAX_PAIRS = 6
TILE_ROWS = 8
# the float32 kernel's tile edge and expanded channels per pass
_F32_TILE = 8
_F32_CHUNK = 32


def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def rc_dims(Cin: int, E: int, Cout: int) -> dict:
    """The bf16 kernel's padded sizes: ``ec`` expanded channels per chunk
    (32, 24, 16 or 8, the largest dividing E rounded up to 8), ``nchunk``
    chunks, ``kc`` (ec rounded up to 16, the pointwise K per chunk), ``kx``
    (Cin rounded up to 16, the expand's and shortcut's K), ``np`` (Cout
    rounded up to 8, the pointwise's and shortcut's N)."""
    e8 = _round_up(E, 8)
    ec = next(c for c in (32, 24, 16, 8) if e8 % c == 0)
    return dict(ec=ec, nchunk=e8 // ec, kc=_round_up(ec, 16), kx=_round_up(Cin, 16),
                np=_round_up(Cout, 8))


def pack_layout(Cin: int, E: int, Cout: int) -> dict:
    """Where each weight lies in ``pack_rc_weights``'s float32 buffer:
    name -> (offset in float32 words, shape, dtype), and ``total`` words.
    float32 weT (Cin, E), wpT (E, Cout), wscT (Cin, Cout), be, kdw (25, E),
    bdw, bp, bsc; then bf16, two to a word, zero-padded: we16 (nchunk*ec,
    kx), wp16 (np, nchunk, kc: chunk j holds Wp's columns j*ec ...), wsc16
    (np, kx). Each entry starts on a 16-byte boundary. ``csrc/rc_fused.cu``'s
    ``pack_layout`` is the same function."""
    d = rc_dims(Cin, E, Cout)
    f32, bf = torch.float32, torch.bfloat16
    entries = [("weT", (Cin, E), f32), ("wpT", (E, Cout), f32), ("wscT", (Cin, Cout), f32),
               ("be", (E,), f32), ("kdw", (25, E), f32), ("bdw", (E,), f32),
               ("bp", (Cout,), f32), ("bsc", (Cout,), f32),
               ("we16", (d["nchunk"] * d["ec"], d["kx"]), bf),
               ("wp16", (d["np"], d["nchunk"], d["kc"]), bf), ("wsc16", (d["np"], d["kx"]), bf)]
    layout, off = {}, 0
    for name, shape, dtype in entries:
        layout[name] = (off, shape, dtype)
        n = 1
        for s in shape:
            n *= s
        off = _round_up(off + (n if dtype == f32 else n // 2), 4)
    layout["total"] = off
    return layout


def _tc_smem(d: dict, tw: int, phase2: bool) -> int:
    hp = (TILE_ROWS + 4) * (tw + 4)
    es = d["ec"] if d["ec"] % 16 == 8 else d["ec"] + 8
    n = hp * (d["kx"] + 8) * 2 + d["ec"] * (d["kx"] + 8) * 2 + hp * es * 4
    if phase2:
        return (n + TILE_ROWS * tw * (d["kc"] + 8) * 2 + d["np"] * (d["kc"] + 8) * 2
                + d["np"] * (d["kx"] + 8) * 2)
    return n + TILE_ROWS * d["ec"] * 4


def _tc_fits(d: dict, tw: int) -> bool:
    nwarps = TILE_ROWS * d["ec"] // 32
    pairs = (TILE_ROWS * tw // 16) * (d["np"] // 8)
    return -(-pairs // nwarps) <= MAX_PAIRS and _tc_smem(d, tw, True) <= MAX_SMEM


@functools.lru_cache(maxsize=None)
def rc_plan(B: int, H: int, W: int, Cin: int, E: int, Cout: int, dtype: torch.dtype,
            Hs: int | None = None, top: int = 0):
    """The launch geometry of ``csrc/rc_fused.cu`` for H output rows of x
    (B, Hs, W, Cin) of ``dtype`` (``Hs`` None: H), output row r at slab row
    ``top`` + r, and a (Cin, E, Cout) block, or None for a shape or window
    it does not take: ``window`` (Hs, top), ``tile`` (rows, columns) of a
    block's output tile, ``smem`` the
    dynamic shared-memory bytes of (phase 1, phase 2), ``workspace`` the
    float32 values of phase 1's per-tile channel sums, ``packed`` the float32
    words of ``pack_rc_weights``'s buffer. bf16 takes an 8x16 tile where it
    fits shared memory and the registers (``MAX_PAIRS`` y tiles a warp) and
    leaves at least two blocks per SM, else 8x8; float32 takes 8x8. Cached:
    the caller must not change the dict."""
    Hs = H if Hs is None else Hs
    if not (0 < B <= 65535 and H > 0 and W > 0 and Cin > 0 and E > 0 and Cout > 0):
        return None
    if top < 0 or top + H > Hs:
        return None
    if -(-H // TILE_ROWS) > 65535:
        return None
    d = rc_dims(Cin, E, Cout)
    if dtype == torch.float32:
        tw = _F32_TILE
        n = (_F32_TILE + 4) ** 2  # the halo's pixels
        base = n * (Cin + 1) + n * (_F32_CHUNK + 1) + _F32_TILE**2 * (_F32_CHUNK + 1)
        smem = (4 * base, 4 * (base + _F32_TILE**2 * Cout))
    elif dtype == torch.bfloat16:
        blocks16 = B * -(-H // TILE_ROWS) * -(-W // 16)
        if _tc_fits(d, 16) and (blocks16 >= MIN_BLOCKS or not _tc_fits(d, 8)):
            tw = 16
        elif _tc_fits(d, 8):
            tw = 8
        else:
            return None
        smem = (_tc_smem(d, tw, False), _tc_smem(d, tw, True))
    else:
        return None
    if smem[1] > MAX_SMEM:
        return None
    ntiles = -(-H // TILE_ROWS) * -(-W // tw)
    return dict(tile=(TILE_ROWS, tw), smem=smem, workspace=B * ntiles * E,
                packed=pack_layout(Cin, E, Cout)["total"], window=(Hs, top))


def _kernels():
    lib = _build.load("rc_fused")
    p1, p2 = lib.lmnet_rc_fused_phase1, lib.lmnet_rc_fused_phase2
    if p1.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        ll = ctypes.c_longlong
        p1.argtypes = [p] * 4 + [i] * 11 + [ll] * 3 + [p]
        p1.restype = ctypes.c_int
        p2.argtypes = [p] * 4 + [i] * 11 + [ll] * 3 + [p]
        p2.restype = ctypes.c_int
    return p1, p2


def pack_rc_weights(w: dict) -> torch.Tensor:
    """``w`` (``fold_rc_weights``'s float32 weights) as the kernel's one
    float32 buffer in ``pack_layout``: the float32 transposes and vectors the
    float32 kernel reads, then We, Wp and Wsc rounded to bf16 and zero-padded
    for the tensor-core kernel. Made once, where the weights are folded."""
    E, Cin = w["we"].shape
    Cout = w["wp"].shape[0]
    lay = pack_layout(Cin, E, Cout)
    d = rc_dims(Cin, E, Cout)
    dev = w["we"].device
    bf = torch.bfloat16
    we16 = torch.zeros(d["nchunk"] * d["ec"], d["kx"], dtype=bf, device=dev)
    we16[:E, :Cin] = w["we"]
    wp = torch.zeros(Cout, d["nchunk"] * d["ec"], device=dev)
    wp[:, :E] = w["wp"]
    wp16 = torch.zeros(d["np"], d["nchunk"], d["kc"], dtype=bf, device=dev)
    wp16[:Cout, :, :d["ec"]] = wp.reshape(Cout, d["nchunk"], d["ec"])
    wsc16 = torch.zeros(d["np"], d["kx"], dtype=bf, device=dev)
    wsc16[:Cout, :Cin] = w["wsc"]
    parts = dict(weT=w["we"].t(), wpT=w["wp"].t(), wscT=w["wsc"].t(), be=w["be"], kdw=w["kdw"],
                 bdw=w["bdw"], bp=w["bp"], bsc=w["bsc"], we16=we16, wp16=wp16, wsc16=wsc16)
    buf = torch.zeros(lay["total"], dtype=torch.float32, device=dev)
    for name, t in parts.items():
        off = lay[name][0]
        flat = t.float().reshape(-1) if t.dtype != bf else t.reshape(-1).view(torch.float32)
        buf[off:off + flat.numel()] = flat
    return buf


def fold_rc_weights(sd: Mapping[str, torch.Tensor], name: str, eps: float = BN_EPS) -> dict:
    """The deploy block ``name`` of a ``structural_reparam`` state dict as the
    kernel's float32 weights, in JAX's ``fold_rc_weights`` layout:
    ``fold_rc_flat_weights`` with the depthwise kernel as kdw (25, E),
    row-major taps, in place of kd; ``packed`` is the kernel's buffer of
    them (``pack_rc_weights``), on the state dict's device."""
    w = fold_rc_flat_weights(sd, name, eps)
    kd = w.pop("kd")
    w["kdw"] = kd.reshape(kd.shape[0], 25).t()
    w["packed"] = pack_rc_weights(w)
    return w


def fused_reparam_conv(x: torch.Tensor, w: dict) -> torch.Tensor:
    """The deploy ReparamConv block: NHWC (B, H, W, Cin) ``x`` -> (B, H, W,
    Cout) in x's dtype, with ``w`` from ``fold_rc_weights`` (the kernel reads
    only its ``packed`` buffer, which must lie on x's device).

    On CUDA tensors it runs the two kernel phases (``rc_phase1``, the SE MLP
    here in float32, ``rc_phase2``); on CPU tensors it is
    ``fused_reparam_conv_plain``. Inside an H shard ``x`` is this rank's
    rows: both phases run on its slab with 2 rows of each neighbour (none
    past the global edges) and phase 1's sums are all-reduced over the
    spatial group before the SE.
    """
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC, got {tuple(x.shape)}")
    slab, top, rows, Hg, _ = row_window(x, 2, 2, edges=False)
    if x.device.type == "cpu":
        return fused_reparam_conv_plain(slab, w, top, rows)
    slab = aligned(slab.contiguous())  # once for both phases
    s = se_scale(spatial_sum(rc_phase1(slab, w, top, rows)), w, Hg * x.shape[2])
    return rc_phase2(slab, w, s, top, rows)


def _cuda_args(x: torch.Tensor, w: dict, top: int, rows: int | None):
    """Check contiguous CUDA ``x`` (a slab of Hs rows) and ``w``: (x made
    contiguous and 16-byte aligned, the launch's shape arguments, the plan,
    the output rows)."""
    x = aligned(x.contiguous())
    B, Hs, W, Cin = x.shape
    top, H = slab_window(Hs, top, rows)
    E, Cout = w["we"].shape[0], w["wp"].shape[0]
    if tuple(w["we"].shape) != (E, Cin) or tuple(w["kdw"].shape) != (25, E):
        raise ValueError(f"weights do not fit x with {Cin} channels: we {tuple(w['we'].shape)}, "
                         f"kdw {tuple(w['kdw'].shape)}")
    packed = w.get("packed")
    if packed is None:
        raise ValueError("w has no 'packed' buffer: fold the weights with fold_rc_weights "
                         "or add pack_rc_weights(w)")
    check_cuda("fused_reparam_conv", x, packed)
    plan = rc_plan(B, H, W, Cin, E, Cout, x.dtype, Hs, top)
    if plan is None or packed.numel() != plan["packed"]:
        raise ValueError(f"rc_fused does not take B={B} H={H} W={W} Cin={Cin} E={E} Cout={Cout} "
                         f"Hs={Hs} top={top} with {packed.numel()} packed weights")
    geo = (B, H, W, Cin, E, Cout, Hs, top, _DTYPE_CODE[x.dtype], *plan["tile"])
    return x, geo, plan, H


def rc_phase1(x: torch.Tensor, w: dict, top: int = 0, rows: int | None = None) -> torch.Tensor:
    """Phase 1 on the slab ``x`` (B, Hs, W, Cin): the per-image channel sums
    of t over the ``rows`` output rows from slab row ``top`` (default the
    whole slab), float32 (B, E). The kernel on a CUDA tensor, else the plain
    version."""
    if x.device.type == "cpu":
        return _plain_t(x, w, top, rows).sum(dim=(2, 3))
    x, geo, plan, _ = _cuda_args(x, w, top, rows)
    sums = torch.empty(geo[0], geo[4], dtype=torch.float32, device=x.device)
    part = torch.empty(plan["workspace"], dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _kernels()[0](x.data_ptr(), w["packed"].data_ptr(), sums.data_ptr(),
                            part.data_ptr(), *geo, plan["smem"][0], plan["workspace"],
                            plan["packed"], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"rc_fused phase 1 launch failed: CUDA error {err}")
    return sums


def rc_phase2(x: torch.Tensor, w: dict, s: torch.Tensor, top: int = 0,
              rows: int | None = None) -> torch.Tensor:
    """Phase 2 on the slab ``x`` with the SE scale ``s`` (B, E) float32: the
    block's ``rows`` output rows from slab row ``top``, (B, rows, W, Cout)
    in x's dtype. The kernel on a CUDA tensor (one more in
    ``fused_reparam_conv.launches``: a block computed), else the plain
    version."""
    if x.device.type == "cpu":
        return _plain_y(x, w, _plain_t(x, w, top, rows), s, top)
    x, geo, plan, H = _cuda_args(x, w, top, rows)
    out = torch.empty(geo[0], H, geo[2], geo[5], dtype=x.dtype, device=x.device)
    s = s.float().contiguous()
    with torch.cuda.device(x.device):
        err = _kernels()[1](x.data_ptr(), s.data_ptr(), w["packed"].data_ptr(), out.data_ptr(),
                            *geo, plan["smem"][1], plan["workspace"], plan["packed"],
                            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"rc_fused phase 2 launch failed: CUDA error {err}")
    fused_reparam_conv.launches += 1
    return out


def _mat(w: dict, k: str, bf16: bool) -> torch.Tensor:
    return w[k].to(torch.bfloat16).float() if bf16 else w[k].float()


def _plain_t(x: torch.Tensor, w: dict, top: int, rows: int | None) -> torch.Tensor:
    """t of the plain version at the output rows, float32 NCHW (B, E, rows,
    W): the expand over the slab, the zero-padded depthwise, GELU."""
    E = w["we"].shape[0]
    top, rows = slab_window(x.shape[1], top, rows)
    e = F.hardswish(F.linear(x.float(), _mat(w, "we", x.dtype == torch.bfloat16),
                             w["be"].float()))
    kd = w["kdw"].float().t().reshape(E, 1, 5, 5)
    t = F.conv2d(e.permute(0, 3, 1, 2), kd, w["bdw"].float(), padding=2, groups=E)
    if (top, rows) != (0, x.shape[1]):
        t = t[:, :, top:top + rows]
    return F.gelu(t, approximate="tanh")


def _plain_y(x: torch.Tensor, w: dict, t: torch.Tensor, s: torch.Tensor, top: int):
    """y of the plain version from its t (B, E, rows, W) and SE scale s."""
    bf16 = x.dtype == torch.bfloat16
    t = (t * s[:, :, None, None]).permute(0, 2, 3, 1)
    if bf16:
        t = t.to(torch.bfloat16).float()
    xf = x[:, top:top + t.shape[1]].float()
    y = (F.linear(t, _mat(w, "wp", bf16), w["bp"].float())
         + F.linear(xf, _mat(w, "wsc", bf16), w["bsc"].float()))
    return y.to(x.dtype)


def fused_reparam_conv_plain(x: torch.Tensor, w: dict, top: int = 0,
                             rows: int | None = None) -> torch.Tensor:
    """The plain version, cast to x's dtype at the end, on the slab ``x`` at
    the ``rows`` output rows from slab row ``top`` (default the whole map).
    float32 x: float32 throughout (JAX's ``_rc_xla``). bfloat16 x: the
    kernel's rounding points, We, Wp, Wsc and t * s rounded to bf16,
    everything else (e included) float32. Inside an H shard the SE's sums
    are all-reduced over the spatial group (the global H x W's mean)."""
    t = _plain_t(x, w, top, rows)
    s = se_scale(spatial_sum(t.sum(dim=(2, 3))), w, global_rows(t.shape[2]) * t.shape[3])
    return _plain_y(x, w, t, s, top)


fused_reparam_conv.launches = 0

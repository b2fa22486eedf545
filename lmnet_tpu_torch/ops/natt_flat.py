"""The fused NATT block interior on flat ``(B, H, W*C)`` embeddings, kernel B8.

Counterpart of ``lmnet_tpu/ops/pallas/natt_flat.py`` (``fold_natt_weights``,
``natt_flat_interior``). As in JAX it is an opt-in op that the deploy graph
does not call. On CUDA tensors ``natt_flat_interior`` launches the
hand-written kernel ``csrc/natt_flat.cu`` (built by ``ops/_build.py``; a
failed build or launch raises); on CPU tensors it is
``natt_flat_interior_plain``. JAX's roll-FMA tables are a TPU layout and not
part of the function: ``fold_natt_weights`` returns the block's weights as
plain float32 tensors in ``F.linear`` layout, plus the kernel's one packed
buffer of them (``pack_natt_weights``), made once at fold time. Both
LayerNorms take the variance as E[(x - mean)^2] (JAX's kernel: E[x^2] -
E[x]^2). Unlike the TPU kernel it takes every H, W >= 3 and any head_dim.
"""

from __future__ import annotations

import ctypes
from typing import Mapping

import torch
import torch.nn.functional as F

from lmnet_tpu_torch.ops import _build
from lmnet_tpu_torch.ops.nat import neighborhood_attention

LN_EPS = 1e-5
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the packed order of the kernel's weights (csrc/natt_flat.cu)
_MATRICES = ("wq", "wk", "wv", "wp", "w1", "w2")
_VECTORS = ("bq", "bk", "bv", "bp", "b1", "b2", "ln1_w", "ln1_b", "ln2_w", "ln2_b")


def _kernel():
    lib = _build.load("natt_flat")
    fn, takes = lib.lmnet_natt_flat, lib.lmnet_natt_flat_takes
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        takes.argtypes = [i]
        takes.restype = ctypes.c_int
    return fn, takes


def pack_natt_weights(fw: dict) -> torch.Tensor:
    """``fw`` as the kernel's one float32 buffer: the matrices transposed to
    (in, out), then the vectors, then rpb."""
    return torch.cat([fw[k].t().reshape(-1) for k in _MATRICES]
                     + [fw[k].reshape(-1) for k in _VECTORS] + [fw["rpb"].reshape(-1)]
                     ).float().contiguous()


def fold_natt_weights(sd: Mapping[str, torch.Tensor], name: str, num_heads: int) -> dict:
    """The NATT block ``name`` of a (deploy or train) state dict as float32
    tensors: wq/bq (the NAT scale head_dim ** -0.5 folded in, as JAX folds
    it), wk/bk, wv/bv (C, C) and (C,), wp/bp, w1 (2C, C)/b1, w2 (C, 2C)/b2,
    the two LayerNorm affines ln1_w/ln1_b and ln2_w/ln2_b, and rpb (heads, 5,
    5). Matrices are in ``F.linear``'s (out, in) layout. ``packed`` is the
    kernel's buffer of them all, on the state dict's device."""
    def w(key):
        return sd[f"{name}.{key}"].float()

    wqkv, bqkv = w("att1.qkv.weight"), w("att1.qkv.bias")
    C = wqkv.shape[1]
    scale = float(C // num_heads) ** -0.5
    fw = dict(
        wq=wqkv[:C] * scale, bq=bqkv[:C] * scale,
        wk=wqkv[C:2 * C], bk=bqkv[C:2 * C],
        wv=wqkv[2 * C:], bv=bqkv[2 * C:],
        wp=w("att1.proj.weight"), bp=w("att1.proj.bias"),
        w1=w("mlp.fc1.weight"), b1=w("mlp.fc1.bias"),
        w2=w("mlp.fc2.weight"), b2=w("mlp.fc2.bias"),
        ln1_w=w("norm1.weight"), ln1_b=w("norm1.bias"),
        ln2_w=w("norm2.weight"), ln2_b=w("norm2.bias"),
        rpb=w("att1.rpb"),
    )
    fw["packed"] = pack_natt_weights(fw)
    return fw


def _check(emb_flat, fw: dict, heads: int, C: int, W: int) -> None:
    if emb_flat.dim() != 3 or emb_flat.shape[2] != W * C:
        raise ValueError(f"emb must be (B, H, {W}*{C}), got {tuple(emb_flat.shape)}")
    if C % heads or tuple(fw["rpb"].shape) != (heads, 5, 5) or tuple(fw["wq"].shape) != (C, C):
        raise ValueError(f"weights do not fit C={C} with {heads} heads")
    if emb_flat.shape[1] < 3 or W < 3:
        raise ValueError(f"feature map {emb_flat.shape[1]}x{W} smaller than the 3x3 window")


def _ln(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + LN_EPS) * g + b


def natt_flat_interior_plain(emb_flat: torch.Tensor, fw: dict, heads: int, C: int,
                             W: int) -> torch.Tensor:
    """The plain PyTorch version: the unfused interior in float32, the result
    in emb's dtype."""
    _check(emb_flat, fw, heads, C, W)
    B, H, _ = emb_flat.shape
    emb = emb_flat.float().reshape(B, H, W, C)
    xn = _ln(emb, fw["ln1_w"], fw["ln1_b"])
    q, k, v = (F.linear(xn, fw[f"w{n}"], fw[f"b{n}"]) for n in "qkv")
    nat = neighborhood_attention(q, k, v, fw["rpb"], 3, scale=1.0)
    att = F.linear(nat, fw["wp"], fw["bp"]) + emb
    h = F.gelu(F.linear(_ln(att, fw["ln2_w"], fw["ln2_b"]), fw["w1"], fw["b1"]),
               approximate="tanh")
    out = F.linear(h, fw["w2"], fw["b2"]) + att
    return out.to(emb_flat.dtype).reshape(B, H, W * C)


def natt_flat_interior(emb_flat: torch.Tensor, fw: dict, heads: int, C: int,
                       W: int) -> torch.Tensor:
    """The NATT interior after the patch-embed conv on flat (B, H, W*C)
    ``emb_flat``: ``mlp(ln2(att)) + att`` with ``att = proj(NAT(qkv(ln1(emb))))
    + emb``, tanh GELU, float32 math; ``fw`` from ``fold_natt_weights`` (the
    kernel reads only its ``packed`` buffer, which must lie on emb's device).
    Returns (B, H, W*C) in emb's dtype. Each launch of the CUDA kernel adds one
    to ``natt_flat_interior.launches``."""
    if emb_flat.device.type == "cpu":
        return natt_flat_interior_plain(emb_flat, fw, heads, C, W)
    _check(emb_flat, fw, heads, C, W)
    if emb_flat.dtype not in _DTYPE_CODE:
        raise ValueError(f"natt_flat_interior takes float32 or bfloat16, not {emb_flat.dtype}")
    if not emb_flat.is_contiguous():
        raise ValueError("emb must be contiguous")
    fn, takes = _kernel()
    if not takes(C):
        raise ValueError(f"the B8 kernel's buffers for C={C} do not fit shared memory")
    weights = fw["packed"]
    if weights.device != emb_flat.device:
        raise ValueError(f"packed weights on {weights.device}, emb on {emb_flat.device}")
    B, H, _ = emb_flat.shape
    out = torch.empty_like(emb_flat)
    with torch.cuda.device(emb_flat.device):
        err = fn(emb_flat.data_ptr(), weights.data_ptr(), out.data_ptr(), B, H, W, heads,
                 C // heads, _DTYPE_CODE[emb_flat.dtype], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"natt_flat launch failed: CUDA error {err}")
    natt_flat_interior.launches += 1
    return out


natt_flat_interior.launches = 0

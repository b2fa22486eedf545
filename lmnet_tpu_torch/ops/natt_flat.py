"""The fused NATT block interior on flat ``(B, H, W*C)`` embeddings, kernel B8.

Counterpart of ``lmnet_tpu/ops/pallas/natt_flat.py`` (``fold_natt_weights``,
``natt_flat_interior``). As in JAX it is an opt-in op that the deploy graph
does not call. On CUDA tensors ``natt_flat_interior`` launches the
hand-written kernel ``csrc/natt_flat.cu`` (built by ``ops/_build.py``; a
failed build or launch raises) with the launch geometry of ``natt_plan``,
which the kernel checks; on CPU tensors it is ``natt_flat_interior_plain``.
For bf16 emb the kernel's six products run on the tensor cores with bf16
operands (the weights rounded once, by ``pack_natt_weights_bf16``; LN1(emb),
the NAT output, LN2(att) and the GELU hidden rounded as A operands) and
float32 sums; the plain version rounds at the same points for bf16 emb.
JAX's roll-FMA tables are a TPU layout and not part of the function:
``fold_natt_weights`` returns the block's weights as plain float32 tensors
in ``F.linear`` layout, plus the kernel's packed buffers of them (float32
``packed``, bf16 ``packed_bf16``), made once at fold time. Both LayerNorms
take the variance as E[(x - mean)^2] (JAX's kernel: E[x^2] - E[x]^2).
Unlike the TPU kernel it takes every H, W >= 3 and any head_dim.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Mapping

import torch
import torch.nn.functional as F

from lmnet_tpu_torch.ops import _build
from lmnet_tpu_torch.ops._build import aligned
from lmnet_tpu_torch.ops.nat import neighborhood_attention

LN_EPS = 1e-5
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the packed order of the kernel's weights (csrc/natt_flat.cu)
_MATRICES = ("wq", "wk", "wv", "wp", "w1", "w2")
_VECTORS = ("bq", "bk", "bv", "bp", "b1", "b2", "ln1_w", "ln1_b", "ln2_w", "ln2_b")


# csrc/natt_flat.cu's constants: the float32 kernel's tiles and its
# shared-memory budget; the bf16 kernel's tiles, threads, the shared memory
# that leaves two blocks on an SM, the largest halo its tables index; a
# block's shared-memory limit on sm_90
_F32_TILES = ((8, 16), (8, 8), (4, 8), (4, 4), (2, 4), (2, 2), (1, 2), (1, 1))
_F32_BUDGET = 96 * 1024
TC_TILES = ((16, 32), (16, 16), (8, 16), (8, 8), (4, 8), (4, 4), (2, 4), (2, 2), (1, 2), (1, 1))
TC_THREADS = 256
TWO_BLOCKS = 113 * 1024
_NAT_MAX = 1023
MAX_SMEM = 232448


def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def _align16(v: int) -> int:
    return _round_up(v, 16)


def tc_dims(C: int, heads: int, tile: tuple[int, int], g: int) -> dict:
    """The bf16 kernel's padded sizes (``kc`` = C to 16, ``sa`` = kc + 8,
    ``nc`` = C to 8, ``n2`` = 2C to 8, ``k2`` = 2C to 16, ``s4`` = k2 + 8),
    its tile's pixels and 16-row tiles (``np``, ``mt``), halo pixels and
    rows (``halo``, ``mh``), the group ``g`` (to 8: ``gn``) and the byte
    sizes of its shared-memory regions: W (one product's bf16 weights), E
    (emb's halo; the group's float32 k, v, q; the bf16 hidden), A (LN1 over
    the halo; float32 att), B (the NAT output; LN2), T (tables, the float32
    vectors, rpb);
    ``smem`` their 16-byte-aligned sum. ``csrc/natt_flat.cu::tc_dims`` is the
    same function."""
    tr, tc = tile
    kc, nc, n2, k2 = _round_up(C, 16), _round_up(C, 8), _round_up(2 * C, 8), _round_up(2 * C, 16)
    sa, s4 = kc + 8, k2 + 8
    np_, halo = tr * tc, (tr + 2) * (tc + 2)
    mt, mh, gn = _round_up(np_, 16), _round_up(halo, 16), _round_up(g, 8)
    regions = dict(
        w=2 * max(3 * gn * sa, nc * sa, n2 * sa, nc * s4),
        e=max(halo * C * 2, (2 * mh * g + mt * g) * 4, mt * s4 * 2),
        a=max(mh * sa * 2, mt * C * 4),
        b=mt * sa * 2,
        t=np_ * 8 + (11 * C + heads * 25) * 4)
    return dict(kc=kc, sa=sa, nc=nc, n2=n2, k2=k2, s4=s4, np=np_, mt=mt, halo=halo, mh=mh, g=g,
                gn=gn, regions=regions, smem=sum(_align16(v) for v in regions.values()))


def _groups(C: int, hd: int):
    """The channel groups the bf16 kernel may take, largest first: all C,
    then the divisors of C that are multiples of 8 and of head_dim; at most
    TC_THREADS heads each."""
    for g in range(C, 0, -1):
        if C % g == 0 and g % hd == 0 and (g == C or g % 8 == 0) and g // hd <= TC_THREADS:
            yield g


@functools.lru_cache(maxsize=None)
def natt_plan(B: int, H: int, W: int, heads: int, hd: int, dtype: torch.dtype):
    """The launch geometry of ``csrc/natt_flat.cu`` for emb (B, H, W*C) of
    ``dtype``, C = heads * hd, or None for a shape it does not take:
    ``tile`` (rows, columns) of a block's output pixels, ``group`` channels
    of q, k, v at a time (C for float32), ``vec`` emb's copy unit in bytes
    (the widest of 16, 8, 4, 2 dividing C's bf16 run; 0 for float32, copied
    element by element), ``smem`` dynamic shared-memory bytes. float32: the
    first of ``_F32_TILES`` whose five float32 buffers fit 96 KB. bf16: the
    first of ``TC_TILES`` and, for it, the largest group (``_groups``) whose
    regions (``tc_dims``) leave two blocks on an SM; failing that, the first
    that fits one. Cached: the caller must not change the dict."""
    C = heads * hd
    if not (0 < B <= 65535 and H >= 3 and W >= 3 and heads > 0 and hd > 0 and C <= 4096
            and H * W <= 0x7FFFFFFF // C) or dtype not in _DTYPE_CODE:
        return None
    if dtype == torch.float32:
        for r, t in _F32_TILES:
            nbytes = (4 * (r + 2) * (t + 2) + r * t) * C * 4
            if nbytes <= _F32_BUDGET or ((r, t) == (1, 1) and nbytes <= MAX_SMEM):
                return dict(tile=(r, t), group=C, vec=0, smem=nbytes)
        return None
    for budget in (TWO_BLOCKS, MAX_SMEM):
        for tile in TC_TILES:
            if (tile[0] + 2) * (tile[1] + 2) > _NAT_MAX:
                continue
            for g in _groups(C, hd):
                smem = tc_dims(C, heads, tile, g)["smem"]
                if smem <= budget:
                    return dict(tile=tile, group=g, vec=min(16, (2 * C) & -(2 * C)), smem=smem)
    return None


def kernel_natt_plan(B: int, H: int, W: int, heads: int, hd: int, dtype: torch.dtype):
    """``csrc/natt_flat.cu``'s own plan for this shape, in ``natt_plan``'s
    form, or None where it refuses the shape (builds the kernel; card tests
    hold the two equal)."""
    if dtype not in _DTYPE_CODE:
        return None
    fn = _build.load("natt_flat").lmnet_natt_flat_plan
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * 5)()
    if fn(B, H, W, heads, hd, _DTYPE_CODE[dtype], ctypes.addressof(out)) != 0:
        return None
    rows, cols, group, vec, smem = out
    return dict(tile=(rows, cols), group=group, vec=vec, smem=smem)


def _kernel():
    lib = _build.load("natt_flat")
    fn = lib.lmnet_natt_flat
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p, p, p, p] + [i] * 10 + [ctypes.c_longlong, p]
        fn.restype = ctypes.c_int
    return fn


def pack_natt_weights(fw: dict) -> torch.Tensor:
    """``fw`` as the kernel's one float32 buffer: the matrices transposed to
    (in, out), then the vectors, then rpb."""
    return torch.cat([fw[k].t().reshape(-1) for k in _MATRICES]
                     + [fw[k].reshape(-1) for k in _VECTORS] + [fw["rpb"].reshape(-1)]
                     ).float().contiguous()


def pack_natt_weights_bf16(fw: dict) -> torch.Tensor:
    """The six matrices for the bf16 kernel, rounded to bf16 once, in
    ``F.linear``'s (out, in) layout, zero-padded to N a multiple of 8 and
    K a multiple of 16, each row followed by 8 zeros (the shared-memory row
    stride, so that a product's weights copy as one run): Wq, Wk, Wv, Wp
    (nc, kc + 8), W1 (n2, kc + 8), W2 (nc, k2 + 8), one flat bf16 tensor
    (``csrc/natt_flat.cu::Pack16``)."""
    C = fw["wq"].shape[0]
    d = tc_dims(C, 1, (1, 1), C)

    def pad(w, n, k):
        out = torch.zeros(n, k, dtype=torch.bfloat16, device=w.device)
        out[:w.shape[0], :w.shape[1]] = w.to(torch.bfloat16)
        return out.reshape(-1)

    return torch.cat([pad(fw[k], d["nc"], d["sa"]) for k in ("wq", "wk", "wv", "wp")]
                     + [pad(fw["w1"], d["n2"], d["sa"]), pad(fw["w2"], d["nc"], d["s4"])])


def fold_natt_weights(sd: Mapping[str, torch.Tensor], name: str, num_heads: int) -> dict:
    """The NATT block ``name`` of a (deploy or train) state dict as float32
    tensors: wq/bq (the NAT scale head_dim ** -0.5 folded in, as JAX folds
    it), wk/bk, wv/bv (C, C) and (C,), wp/bp, w1 (2C, C)/b1, w2 (C, 2C)/b2,
    the two LayerNorm affines ln1_w/ln1_b and ln2_w/ln2_b, and rpb (heads, 5,
    5). Matrices are in ``F.linear``'s (out, in) layout. ``packed`` is the
    kernel's float32 buffer of them all and ``packed_bf16`` the bf16 kernel's
    matrices (``pack_natt_weights_bf16``), on the state dict's device."""
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
    fw["packed_bf16"] = pack_natt_weights_bf16(fw)
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
    in emb's dtype. For bf16 emb it rounds where the bf16 kernel does: the
    six weight matrices, and the four A operands of its products (LN1(emb),
    the NAT output, LN2(att), the GELU hidden) to bf16; everything else
    (biases, q, k, v, the softmax, the residuals) stays float32."""
    _check(emb_flat, fw, heads, C, W)
    B, H, _ = emb_flat.shape
    if emb_flat.dtype == torch.bfloat16:
        def r(x):
            return x.to(torch.bfloat16).float()
    else:
        def r(x):
            return x
    emb = emb_flat.float().reshape(B, H, W, C)
    xn = r(_ln(emb, fw["ln1_w"], fw["ln1_b"]))
    q, k, v = (F.linear(xn, r(fw[f"w{n}"]), fw[f"b{n}"]) for n in "qkv")
    nat = r(neighborhood_attention(q, k, v, fw["rpb"], 3, scale=1.0))
    att = F.linear(nat, r(fw["wp"]), fw["bp"]) + emb
    h = r(F.gelu(F.linear(r(_ln(att, fw["ln2_w"], fw["ln2_b"])), r(fw["w1"]), fw["b1"]),
                 approximate="tanh"))
    out = F.linear(h, r(fw["w2"]), fw["b2"]) + att
    return out.to(emb_flat.dtype).reshape(B, H, W * C)


def natt_flat_interior(emb_flat: torch.Tensor, fw: dict, heads: int, C: int,
                       W: int) -> torch.Tensor:
    """The NATT interior after the patch-embed conv on flat (B, H, W*C)
    ``emb_flat``: ``mlp(ln2(att)) + att`` with ``att = proj(NAT(qkv(ln1(emb))))
    + emb``, tanh GELU; ``fw`` from ``fold_natt_weights`` (the kernel reads
    its ``packed`` buffer, and for bf16 emb its ``packed_bf16`` one, which
    must lie on emb's device). float32 emb: float32 math throughout. bf16
    emb: the products on the tensor cores, rounding where
    ``natt_flat_interior_plain`` does. Returns (B, H, W*C) in emb's dtype.
    Each launch of the CUDA kernel adds one to
    ``natt_flat_interior.launches``."""
    if emb_flat.device.type == "cpu":
        return natt_flat_interior_plain(emb_flat, fw, heads, C, W)
    _check(emb_flat, fw, heads, C, W)
    if emb_flat.dtype not in _DTYPE_CODE:
        raise ValueError(f"natt_flat_interior takes float32 or bfloat16, not {emb_flat.dtype}")
    if not emb_flat.is_contiguous():
        raise ValueError("emb must be contiguous")
    emb_flat = aligned(emb_flat)
    B, H, _ = emb_flat.shape
    plan = natt_plan(B, H, W, heads, C // heads, emb_flat.dtype)
    if plan is None:
        raise ValueError(f"the B8 kernel does not take B={B} H={H} W={W} C={C} heads={heads}")
    bf16 = emb_flat.dtype == torch.bfloat16
    weights = fw["packed"]
    weights16 = fw.get("packed_bf16") if bf16 else None
    if bf16 and weights16 is None:
        raise ValueError("bf16 emb needs fw['packed_bf16'] (fold_natt_weights makes it)")
    for w in (weights, weights16):
        if w is not None and w.device != emb_flat.device:
            raise ValueError(f"packed weights on {w.device}, emb on {emb_flat.device}")
    dev = emb_flat.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return natt_flat_interior(emb_flat, fw, heads, C, W)
    out = torch.empty_like(emb_flat)
    err = _kernel()(emb_flat.data_ptr(), weights.data_ptr(),
                    weights16.data_ptr() if bf16 else None, out.data_ptr(), B, H, W, heads,
                    C // heads, _DTYPE_CODE[emb_flat.dtype], *plan["tile"], plan["group"],
                    plan["vec"], plan["smem"], torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"natt_flat launch failed: CUDA error {err}")
    natt_flat_interior.launches += 1
    return out


natt_flat_interior.launches = 0

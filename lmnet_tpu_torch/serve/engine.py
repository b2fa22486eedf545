"""Serving engine: the LM-Net deploy forward as a pure function over the
deploy state dict, and ``serving_evaluate`` over a loader.

Counterpart of ``lmnet_tpu/serve/engine.py`` (``deploy_forward``,
``serving_evaluate``). Take a train-mode ``LMNet`` state dict,
``structural_reparam`` it, and call ``deploy_forward``. NAT runs through the
B1 CUDA kernel (``nat_backend='flat'``), the tiled B3 kernel (``'pallas'``)
or the plain version (``'plain'``) on the card, and the ReparamConv block
through the plain torch graph (``rc_backend='xla'``, the JAX engine's name),
the B5 kernel (``'flat'``, ``ops/rc_flat.py``) or the two-pass B4 kernel
(``'pallas'``, ``ops/rc_kernel.py``); every 2x upsample goes through
``ops/resize.py``, whose backend switch selects the B7 kernel; everything
else is plain torch. ``rc_backend='auto'`` in ``serving_evaluate`` times the
candidates on the first batch (``autoselect_backends``). Dtypes follow the
JAX engine: the activations carry the compute dtype (bf16 when serving),
every weight is cast to it at its op, BatchNorm's scale is formed in float32
first, and the SE squeeze stays in the compute dtype.

JAX's deploy options are here too: ``natt_int8`` (int8 qkv and fc1 products
off a static-scale int8 LayerNorm), ``ln_fold`` (the LayerNorm affines folded
into qkv and fc1) and ``skip_compose`` (convl/convm/convs composed into the
skip blocks' fuse conv). Unlike JAX, ``natt_int8`` with ``ln_fold`` raises
(JAX drops ``ln_fold``). ``serving_evaluate(mesh=...)`` splits each batch
over the mesh's data axis and sums the results over the ranks, as
``train.loop.evaluate``; each rank serves whole images, so B1 serves there
too (JAX takes its 'xla' NAT under a mesh, because a Pallas call does not
partition). ``serving_evaluate(spatial=True)`` also splits the image H over
the mesh's 'spatial' axis where it divides (``parallel/mesh.py::
shards_h``): ``deploy_forward`` then runs inside the shard, with the halo
exchanges, SE's global mean, the gathered GFT and NAT on slabs of
``models/blocks.py`` (B1 on each rank's slab); 'flat' and 'pallas'
ReparamConv run B5 or B4 on each rank's slab with their SE sums
all-reduced over the spatial group, and the flat upsample B7 on the
rank's slab in global coordinates.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from lmnet_tpu_torch.data.augment import eval_pipeline
from lmnet_tpu_torch.losses.losses import cross_entropy_terms
from lmnet_tpu_torch.metrics.confusion import (
    ConfusionAccumulator,
    confusion_matrix,
    derived_metrics,
)
from lmnet_tpu_torch.models.blocks import (
    BN_EPS,
    LN_EPS,
    conv_nhwc,
    gelu,
    global_attention_core,
    nat,
    nat_rows,
)
from lmnet_tpu_torch.models.lm_net import structural_reparam
from lmnet_tpu_torch.ops.rc_flat import fold_rc_flat_weights, fused_rc_block
from lmnet_tpu_torch.ops.rc_kernel import fold_rc_weights, fused_reparam_conv
from lmnet_tpu_torch.ops.resize import adaptive_avg_pool, upsample2x_align_corners
from lmnet_tpu_torch.parallel.batch import current_shard, whole
from lmnet_tpu_torch.parallel.dist_utils import host_count
from lmnet_tpu_torch.parallel.mesh import (
    eval_totals,
    h_rows,
    hd95_values,
    node_rows,
    shard_context,
    shards_h,
    sum_group,
)
from lmnet_tpu_torch.parallel.spatial import gather_rows, own_rows, spatial_mean
from lmnet_tpu_torch.spans import span

RC_BACKENDS = ("xla", "flat", "pallas")

Tensors = Mapping[str, torch.Tensor]


def _wb(sd: Tensors, name: str, dtype: torch.dtype, rows: slice | None = None,
        flat: bool = False):
    """``name``'s weight and bias (None where it has none) in ``dtype``: the
    weight's output ``rows`` and the bias's, the weight flattened to 2-D
    with ``flat``. Every weight of the deploy forward is cast here or in
    ``_bn_affine``, under the ``lmnet.fold`` span, so that the ops that
    follow take it in the activations' dtype and cast nothing."""
    with span("lmnet.fold"):
        w, b = sd[f"{name}.weight"], sd.get(f"{name}.bias")
        if rows is not None:
            w, b = w[rows], b[rows]
        if flat:
            w = w.flatten(1)
        return w.to(dtype), None if b is None else b.to(dtype)


def _bn_affine(sd: Tensors, name: str, dtype: torch.dtype):
    """BatchNorm ``name``'s scale and shift on its running statistics,
    formed in float32 and cast to ``dtype`` (under ``lmnet.fold``)."""
    with span("lmnet.fold"):
        inv = sd[f"{name}.weight"] / torch.sqrt(sd[f"{name}.running_var"] + BN_EPS)
        shift = sd[f"{name}.bias"] - sd[f"{name}.running_mean"] * inv
        return inv.to(dtype), shift.to(dtype)


def _conv(sd: Tensors, name: str, x, stride: int = 1, groups: int = 1):
    return conv_nhwc(x, *_wb(sd, name, x.dtype), stride, groups)


def _bn(sd: Tensors, name: str, x):
    inv, shift = _bn_affine(sd, name, x.dtype)
    return x * inv + shift


def _ln_noaffine(x):
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + LN_EPS)


def _ln(sd: Tensors, name: str, x):
    y = _ln_noaffine(x)
    g, b = _wb(sd, name, x.dtype)
    return y * g + b


def _dense(sd: Tensors, name: str, x, rows: slice = slice(None)):
    """x @ W[rows].T + b[rows]; ``rows`` slices the output features."""
    return F.linear(x, *_wb(sd, name, x.dtype, rows))


def _mlp(sd: Tensors, name: str, x):
    return _dense(sd, f"{name}.fc2", gelu(_dense(sd, f"{name}.fc1", x)))


def _m2skip(sd: Tensors, name: str, xl, xs, mode: str):
    if mode == "bottom":
        a = _conv(sd, f"{name}.convl.0", xl, 2)
        b = _conv(sd, f"{name}.convs.0", xs)
    else:
        a = _conv(sd, f"{name}.convl.0", xl)
        b = _conv(sd, f"{name}.convs.1", upsample2x_align_corners(xs))
    fused = _conv(sd, f"{name}.fuse_conv.0", torch.cat([a, b], dim=-1))
    return gelu(_bn(sd, f"{name}.fuse_conv.1", fused))


def _m3skip(sd: Tensors, name: str, xl, xm, xs):
    a = _conv(sd, f"{name}.convl.0", xl, 2)
    b = _conv(sd, f"{name}.convm.0", xm)
    c = _conv(sd, f"{name}.convs.1", upsample2x_align_corners(xs))
    fused = _conv(sd, f"{name}.fuse_conv.0", torch.cat([a, b, c], dim=-1))
    return gelu(_bn(sd, f"{name}.fuse_conv.1", fused))


def _compose_kk(k1: torch.Tensor, b1: torch.Tensor, k2: torch.Tensor):
    """Two stacked 'same'-padded convs (k1, then k2) as one, on OIHW kernels
    k1 (cm, ci, kh1, kw1) and k2 (co, cm, kh2, kw2): K[d] = sum over d1 + d2 =
    d of k2[d2] k1[d1] contracted over cm, in float32, and k1's bias through
    k2 (co,). Exact in the interior; the outermost output ring differs from
    the two-pass form, which zero-pads the intermediate. The composed size
    must be odd, so that 'same' padding centres it; else ValueError."""
    cm, _, kh1, kw1 = k1.shape
    co, cm2, kh2, kw2 = k2.shape
    if cm != cm2:
        raise ValueError(f"k1 gives {cm} channels, k2 takes {cm2}")
    if (kh1 + kh2) % 2 == 1 or (kw1 + kw2) % 2 == 1:
        raise ValueError(f"composed kernel {kh1 + kh2 - 1}x{kw1 + kw2 - 1} is not odd-sized")
    k1f, k2f = k1.float(), k2.float()
    K = torch.zeros(co, k1.shape[1], kh1 + kh2 - 1, kw1 + kw2 - 1, device=k1.device)
    for a in range(kh1):
        for b in range(kw1):
            K[:, :, a:a + kh2, b:b + kw2] += torch.einsum("mi,omhw->oihw", k1f[:, :, a, b], k2f)
    return K, torch.einsum("m,omhw->o", b1.float(), k2f)


def _m2skip_composed(sd: Tensors, name: str, xl, xs, mode: str):
    """M2 skip with convs (and, in 'top' mode, convl) composed into the fuse
    conv: the (B, H, W, cm) intermediates are never formed. The strided convl
    of 'bottom' mode stays two-pass (a strided conv does not compose)."""
    dt = xl.dtype
    convs = f"{name}.convs.0" if mode == "bottom" else f"{name}.convs.1"
    with span("lmnet.fold"):
        kf = sd[f"{name}.fuse_conv.0.weight"]
        fb = sd[f"{name}.fuse_conv.0.bias"].float()
        cm = sd[f"{name}.convl.0.weight"].shape[0]
        ks, bs = _compose_kk(sd[f"{convs}.weight"], sd[f"{convs}.bias"], kf[:, cm:])
        if mode == "bottom":
            kl, bl = kf[:, :cm].to(dt), None
            ks, bs = ks.to(dt), (bs + fb).to(dt)
        else:
            kl, bl = _compose_kk(sd[f"{name}.convl.0.weight"], sd[f"{name}.convl.0.bias"],
                                 kf[:, :cm])
            kl, bl, ks, bs = kl.to(dt), (bl + bs + fb).to(dt), ks.to(dt), None
    if mode == "bottom":
        a = _conv(sd, f"{name}.convl.0", xl, 2)
        out = conv_nhwc(a, kl) + conv_nhwc(xs, ks, bs)
    else:
        out = conv_nhwc(xl, kl, bl) + conv_nhwc(upsample2x_align_corners(xs), ks)
    return gelu(_bn(sd, f"{name}.fuse_conv.1", out))


def _m3skip_composed(sd: Tensors, name: str, xl, xm, xs):
    dt = xl.dtype
    with span("lmnet.fold"):
        kf = sd[f"{name}.fuse_conv.0.weight"]
        cm = sd[f"{name}.convm.0.weight"].shape[0]
        km, bm = _compose_kk(sd[f"{name}.convm.0.weight"], sd[f"{name}.convm.0.bias"],
                             kf[:, cm:2 * cm])
        ks, bs = _compose_kk(sd[f"{name}.convs.1.weight"], sd[f"{name}.convs.1.bias"],
                             kf[:, 2 * cm:])
        bias = (bm + bs + sd[f"{name}.fuse_conv.0.bias"].float()).to(dt)
        kl, km, ks = kf[:, :cm].to(dt), km.to(dt), ks.to(dt)
    a = _conv(sd, f"{name}.convl.0", xl, 2)  # strided: not composable
    out = (conv_nhwc(a, kl) + conv_nhwc(xm, km, bias)
           + conv_nhwc(upsample2x_align_corners(xs), ks))
    return gelu(_bn(sd, f"{name}.fuse_conv.1", out))


def _gft(sd: Tensors, x, num_heads: int):
    """The GFT bottleneck; on a shard, on the gathered map (its rows kept),
    as ``models/blocks.py::GFT``."""
    x = gather_rows(x)
    B, H, W, _ = x.shape
    with whole():
        emb = _conv(sd, "gft.patchembedding.patch_embeddings", x).reshape(B, H * W, -1)
        qkv = _dense(sd, "gft.attention.qkv", _ln(sd, "gft.norm1", emb))
        att = _dense(sd, "gft.attention.proj", global_attention_core(qkv, num_heads)) + emb
        out = _mlp(sd, "gft.mlp", _ln(sd, "gft.norm2", att)) + att
    return _conv(sd, "gft.conv.0", own_rows(out.reshape(B, H, W, -1)))


def _ln_static_scale(sd: Tensors, name: str) -> torch.Tensor:
    """A bound on |LN output| with no pass over the data: the normalised
    vector has L2 norm sqrt(C), so |x_hat| <= sqrt(C - 1); scaled by gamma's
    absmax, shifted by beta's; as an int8 step (divided by 127)."""
    g, b = sd[f"{name}.weight"], sd[f"{name}.bias"]
    bound = float(max(g.shape[0] - 1, 1)) ** 0.5 * g.abs().max() + b.abs().max()
    return bound.clamp_min(1e-8) / 127.0


def _ln_q8(sd: Tensors, name: str, x, s_in):
    """LayerNorm in float32, quantised to int8 at the static step ``s_in``
    (round half to even, as jnp.round)."""
    return torch.round(_ln(sd, name, x.float()) / s_in).clamp(-127, 127).to(torch.int8)


def _quant_w_percol(w: torch.Tensor):
    """Symmetric int8 quantisation of an (out, in) weight, one step per
    output feature (JAX's per-column step of its (in, out) kernel)."""
    s = (w.abs().amax(dim=1) / 127.0).clamp_min(1e-8)
    return torch.round(w / s[:, None]).clamp(-127, 127).to(torch.int8), s


def _dense_i8(x8, w8f, scale, bias, out_dtype):
    """int8 x int8 product, rescaled, plus bias, in ``out_dtype``: ``w8f`` is
    the int8 weight in float32 and ``scale`` the product of the input's and
    each output feature's step. The product runs in float32, which is exact
    here: |sum| <= 127^2 C < 2^24."""
    acc = F.linear(x8.float(), w8f)
    return (acc * scale + bias).to(out_dtype)


def _ln_fold(sd: Tensors, ln: str, w: torch.Tensor, b: torch.Tensor):
    """The LN affine folded into the (out, in) dense that follows it, in
    float32: (x_hat g + be) W^T + b = x_hat (W g)^T + (W be + b)."""
    g, be, wf = sd[f"{ln}.weight"].float(), sd[f"{ln}.bias"].float(), w.float()
    return wf * g[None, :], wf @ be + b.float()


def _ln_dense(sd: Tensors, ln: str, dense: str, x, rows: list[slice], natt_int8: bool,
              ln_fold: bool) -> list[torch.Tensor]:
    """The dense ``dense`` on the LayerNorm ``ln`` of x, one output for each
    slice of the output features in ``rows``, in x's dtype: int8 products
    off a static-scale int8 LayerNorm (``natt_int8``), the LN affine folded
    into the dense (``ln_fold``), or the plain graph."""
    w, b = sd[f"{dense}.weight"], sd[f"{dense}.bias"]
    dt = x.dtype
    if natt_int8:
        with span("lmnet.fold"):
            s = _ln_static_scale(sd, ln)
            w8, sw = _quant_w_percol(w)
            folded = [(w8[r].float(), s * sw[r], b[r]) for r in rows]
        x8 = _ln_q8(sd, ln, x, s)
        return [_dense_i8(x8, *f, dt) for f in folded]
    if ln_fold:
        with span("lmnet.fold"):
            wf, bf = _ln_fold(sd, ln, w, b)
            folded = [(wf[r].to(dt), bf[r].to(dt)) for r in rows]
        xn = _ln_noaffine(x)
        return [F.linear(xn, *f) for f in folded]
    xn = _ln(sd, ln, x)
    return [_dense(sd, dense, xn, r) for r in rows]


def _natt(sd: Tensors, name: str, x, num_heads: int, nat_backend: str,
          natt_int8: bool = False, ln_fold: bool = False):
    emb = _conv(sd, f"{name}.patchembedding.patch_embeddings", x)
    return natt_interior(sd, name, emb, num_heads, nat_backend, natt_int8, ln_fold)


def natt_interior(sd: Tensors, name: str, emb, num_heads: int, nat_backend: str,
                  natt_int8: bool = False, ln_fold: bool = False):
    """The NATT block ``name`` after its patch-embed conv, on NHWC ``emb``:
    the unfused counterpart of ``ops/natt_flat.py::natt_flat_interior``."""
    C = emb.shape[-1]

    # weight-sliced qkv: three contiguous outputs that reshape to the flat
    # NAT layout without a copy. Under natt_int8 only qkv and fc1 take int8
    # products; proj and fc2 stay in the compute dtype (their inputs have no
    # static bound)
    def attend(xs):
        q, k, v = _ln_dense(sd, f"{name}.norm1", f"{name}.att1.qkv", xs,
                            [slice(i * C, (i + 1) * C) for i in range(3)], natt_int8, ln_fold)
        return nat(q, k, v, sd[f"{name}.att1.rpb"], num_heads, nat_backend)

    out = nat_rows(emb, attend)
    att = _dense(sd, f"{name}.att1.proj", out) + emb
    (h,) = _ln_dense(sd, f"{name}.norm2", f"{name}.mlp.fc1", att, [slice(None)], natt_int8,
                     ln_fold)
    return _dense(sd, f"{name}.mlp.fc2", gelu(h)) + att


def _rc(sd: Tensors, name: str, h, rc_backend: str):
    """Deploy ReparamConv: expand + BN + hardswish -> fused 5x5 depthwise +
    GELU -> SE -> pointwise + shortcut."""
    if rc_backend in ("flat", "pallas"):
        fold, block = ((fold_rc_flat_weights, fused_rc_block) if rc_backend == "flat"
                       else (fold_rc_weights, fused_reparam_conv))
        with span("lmnet.fold"):
            w = fold(sd, name)
        return block(h, w).to(h.dtype)
    e = F.hardswish(_bn(sd, f"{name}.expand_conv.1", _conv(sd, f"{name}.expand_conv.0", h)))
    t = gelu(_conv(sd, f"{name}.fuse_conv", e, groups=e.shape[-1]))
    # the SE squeeze stays in the compute dtype (float32 SE weights would
    # promote t, and every later block, to float32)
    m = spatial_mean(t)
    m = F.relu(F.linear(m, *_wb(sd, f"{name}.se.fc1", m.dtype, flat=True)))
    sc = F.hardsigmoid(F.linear(m, *_wb(sd, f"{name}.se.fc2", m.dtype, flat=True)))
    return _conv(sd, f"{name}.pointwise_conv.0", t * sc) + _conv(sd, f"{name}.shortcut.0", h)


def deploy_forward(
    variables: Tensors,
    x: torch.Tensor,
    num_heads: int = 12,
    nat_backend: str | tuple = "flat",
    rc_backend: str = "xla",
    natt_int8: bool = False,
    ln_fold: bool = False,
    skip_compose: bool = False,
) -> torch.Tensor:
    """Deploy-mode forward: NHWC ``x`` -> float32 NHWC logits.

    ``variables``: the ``structural_reparam`` output, on x's device.
    ``nat_backend``: 'flat' (the B1 kernel on a CUDA tensor), 'pallas' (the
    B3 kernel) or 'plain', or a 4-tuple giving it per NAT stage (natt1 ..
    natt4, deepest first).
    ``rc_backend``: 'xla' (the plain torch ReparamConv; the name is the JAX
    engine's), 'flat' (the B5 kernel with the 1x1 products as matmuls) or
    'pallas' (the B4 kernel, which computes the whole block in two passes).
    ``natt_int8``: int8 qkv and fc1 products in every NATT interior, off a
    static-scale int8 LayerNorm (a few per cent of activation error).
    ``ln_fold``: the LayerNorm affines folded into qkv and fc1 (exact up to
    rounding); not together with ``natt_int8``.
    ``skip_compose``: convl/convm/convs composed into the skip blocks' fuse
    conv (exact in the interior; the outermost ring of each skip's map
    differs, see ``_compose_kk``).

    Inside a shard (``parallel/batch.py::shard``) ``x`` is this rank's block
    of rows and so are the logits; every backend and option runs there
    ('flat' and 'pallas' ReparamConv on the rank's slab).
    """
    if rc_backend not in RC_BACKENDS:
        raise ValueError(f"rc_backend must be one of {RC_BACKENDS}, not {rc_backend!r}")
    if natt_int8 and ln_fold:
        raise ValueError("natt_int8 and ln_fold are exclusive (JAX's int8 path silently "
                         "drops ln_fold)")
    nb = nat_backend if isinstance(nat_backend, tuple) else (nat_backend,) * 4
    if len(nb) != 4:
        raise ValueError(f"nat_backend tuple needs 4 entries, got {nb}")
    sd = variables

    # every op of the forward runs inside one of the stage spans lmnet.rc,
    # .down, .gft, .skip, .natt, .up and .head (PERF.md, "Spans and counters")
    def rc2(stage, h):
        for i in (0, 1):
            with span("lmnet.rc"):
                h = _rc(sd, f"{stage}.{i}", h, rc_backend)
        return h

    x1 = rc2("conv1", x)
    with span("lmnet.down"):
        xd1 = _conv(sd, "down1.0", x1, 2)
    x2 = rc2("conv2", xd1)
    with span("lmnet.down"):
        xd2 = _conv(sd, "down2.0", x2, 2)
    x3 = rc2("conv3", xd2)
    with span("lmnet.down"):
        xd3 = _conv(sd, "down3.0", x3, 2)
    x4 = rc2("conv4", xd3)
    with span("lmnet.down"):
        xd4 = _conv(sd, "down4.0", x4, 2)

    with span("lmnet.gft"):
        h, w = xd4.shape[1], xd4.shape[2]
        pooled = torch.cat([adaptive_avg_pool(t, (h, w)) for t in (x1, x2, x3, x4)] + [xd4],
                           dim=-1)
        x5 = _gft(sd, pooled, num_heads)

    m2, m3 = (_m2skip_composed, _m3skip_composed) if skip_compose else (_m2skip, _m3skip)
    with span("lmnet.skip"):
        s1 = m2(sd, "skip1", x3, x4, "bottom")
    with span("lmnet.skip"):
        s2 = m3(sd, "skip2", x2, x3, x4)
    with span("lmnet.skip"):
        s3 = m3(sd, "skip3", x1, x2, x3)
    with span("lmnet.skip"):
        s4 = m2(sd, "skip4", x1, x2, "top")

    natts = []
    for i, s in enumerate((s1, s2, s3, s4)):
        with span("lmnet.natt"):
            natts.append(_natt(sd, f"natt{i + 1}", s, num_heads, nb[i], natt_int8, ln_fold))
    x46, x37, x28, x19 = natts

    def up(name, h_, skip):
        with span("lmnet.up"):
            return _conv(sd, f"{name}.1", upsample2x_align_corners(h_)) + skip

    x6 = rc2("dconv1", up("up1", x5, x46))
    x7 = rc2("dconv2", up("up2", x6, x37))
    x8 = rc2("dconv3", up("up3", x7, x28))
    x9 = rc2("dconv4", up("up4", x8, x19))
    with span("lmnet.head"):
        return _conv(sd, "output_layer", x9).float()


# (shape, dtype, heads, rc candidates, nat candidates) -> (the chosen pair,
# the timing table it was chosen from, seconds per forward), for the life
# of the process, as in JAX
AUTOTUNE_CACHE: dict = {}


def pick_fastest(timings: Mapping[tuple, float], default=("xla", "plain")) -> tuple:
    """The (rc, nat) pair with the smallest time; ``default`` for an empty
    table."""
    if not timings:
        return default
    return min(timings, key=timings.get)


def _forward_seconds(deploy_vars: Tensors, x: torch.Tensor, num_heads: int, iters: int,
                     natt_int8: bool = False) -> Callable[[str, str], float]:
    """time_fn(rc, nat): seconds per ``deploy_forward`` after one warm-up
    call, by CUDA events on a CUDA tensor, by the host clock on a CPU one."""
    def time_fn(rc, nat):
        def run():
            return deploy_forward(deploy_vars, x, num_heads=num_heads,
                                  nat_backend=nat, rc_backend=rc, natt_int8=natt_int8)

        with torch.inference_mode():
            run()
            if x.device.type != "cuda":
                t0 = time.perf_counter()
                for _ in range(iters):
                    run()
                return (time.perf_counter() - t0) / iters
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                run()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1000 / iters

    return time_fn


def autoselect_backends(
    deploy_vars: Tensors,
    x: torch.Tensor,
    num_heads: int = 12,
    rc_candidates=("xla", "flat"),
    nat_candidates=("flat", "plain"),
    iters: int = 8,
    natt_int8: bool = False,
    time_fn: Callable[[str, str], float] | None = None,
) -> tuple:
    """Time ``deploy_forward`` for every (rc, nat) candidate pair on the real
    input and return the fastest pair. 'pallas' is not a default candidate
    (as in JAX); pass it to try it. The choice and its timing table are
    cached in ``AUTOTUNE_CACHE`` per (shape, dtype, num_heads, natt_int8,
    candidates). ``time_fn(rc, nat) -> seconds`` can be injected.

    Unlike JAX's sweep, a candidate that raises fails the call: a kernel
    that cannot launch is never hidden behind another backend.
    """
    shard = current_shard()
    key = (tuple(x.shape), str(x.dtype), num_heads, natt_int8, tuple(rc_candidates),
           tuple(nat_candidates), shard and (shard.index, shard.size))
    if key not in AUTOTUNE_CACHE:
        if time_fn is None:
            time_fn = _forward_seconds(deploy_vars, x, num_heads, iters, natt_int8)
        timings = {(rc, nat): time_fn(rc, nat)
                   for rc in rc_candidates for nat in nat_candidates}
        AUTOTUNE_CACHE[key] = (pick_fastest(timings), timings)
    return AUTOTUNE_CACHE[key][0]


def _resolve_auto(deploy_vars: Tensors, x: torch.Tensor, num_heads: int, rc_backend,
                  nat_backend, natt_int8: bool = False) -> tuple:
    """Expand 'auto' in either slot through ``autoselect_backends``, pinning
    a slot that is not 'auto' to its value; 'auto' draws ReparamConv from
    ('xla', 'flat'), on a shard too, as JAX's."""
    rc_cands = ("xla", "flat") if rc_backend == "auto" else (rc_backend,)
    nat_cands = ("flat", "plain") if nat_backend == "auto" else (nat_backend,)
    return autoselect_backends(deploy_vars, x, num_heads, rc_candidates=rc_cands,
                               nat_candidates=nat_cands, natt_int8=natt_int8)


def serving_evaluate(
    state: Tensors,
    loader: Iterable[tuple[np.ndarray, np.ndarray]],
    num_classes: int = 2,
    img_size: int = 256,
    nat_backend: str | tuple = "flat",
    rc_backend: str = "xla",
    num_heads: int = 12,
    natt_int8: bool = False,
    task: str = "binary",
    device: torch.device | str = "cuda",
    compute_hd95: bool = False,
    mesh=None,
    spatial: bool = False,
) -> tuple[float, dict[str, float]]:
    """Evaluate a train-mode state dict through the serving path: reparam
    once, move the deploy state to ``device`` (the card unless the caller
    asks for the CPU), then ``deploy_forward`` in bf16 over the loader's
    (uint8 images, uint8 masks) numpy batches. 'auto' in either backend is
    resolved by ``autoselect_backends`` on the first batch and kept for the
    rest. ``compute_hd95`` adds the mean HD95 of the class-1 masks, on the
    host from the served predictions, as ``train.loop.evaluate``.

    ``mesh``: each of the node's batches split over the node's data ranks,
    each rank serving its rows (with the NAT backend asked for: B1 by
    default), N nodes' batches i making global batch i, as JAX's
    ``shard_batch`` makes it of host-local batches; the matrix, each
    batch's CE numerator and denominator and the HD95 sums are summed over
    the ranks in one float64 all-reduce (``eval_totals``), so the result is
    one process's on the concatenated batches. An 'auto' backend is timed on every rank and rank 0's
    pick is broadcast. ``spatial``: each rank also serves its block of the
    image H where ``shards_h`` allows it (the sums then go over the world,
    HD95 on the gathered maps), else whole images.

    Returns (summed per-batch CE loss, derived metrics), as the JAX engine.
    """
    device = torch.device(device)
    deploy = {k: v.to(device) for k, v in structural_reparam(state).items()}
    cm = ConfusionAccumulator.init(num_classes, device)
    terms = []  # each batch's (CE numerator, denominator)
    hd_sum, hd_cnt = 0.0, 0
    sharded = mesh is not None and shards_h(mesh, img_size, spatial)
    hs = h_rows(mesh, img_size) if sharded else slice(None)
    with torch.inference_mode(), shard_context(mesh, sharded):
        for images, masks in loader:
            rows = (slice(0, images.shape[0]) if mesh is None
                    else node_rows(mesh, images.shape[0]))
            if rows.start == rows.stop:  # a ragged tail left this rank no row
                if "auto" in (rc_backend, nat_backend):
                    raise ValueError("an 'auto' backend is timed on every rank's rows of the "
                                     "first batch, which leaves this rank none")
                terms.append(torch.zeros(2, device=device))
                continue
            x, y = eval_pipeline(
                torch.from_numpy(images[rows]).to(device), torch.from_numpy(masks[rows]).to(device),
                out_size=img_size,
            )
            x, y = x[:, hs].to(torch.bfloat16), y[:, hs]
            if "auto" in (rc_backend, nat_backend):
                picked = _resolve_auto(deploy, x, num_heads, rc_backend, nat_backend, natt_int8)
                if mesh is not None:
                    picked = _rank0_pick(mesh, picked, device)
                rc_backend, nat_backend = picked
            logits = deploy_forward(
                deploy, x, num_heads=num_heads,
                nat_backend=nat_backend, rc_backend=rc_backend, natt_int8=natt_int8,
            )
            terms.append(torch.stack(cross_entropy_terms(logits, y, (1.0, 4.0), 0.001)))
            preds = logits.argmax(dim=-1)
            cm += confusion_matrix(preds, y, num_classes)
            if compute_hd95:
                for v in hd95_values(preds, y):
                    hd_sum, hd_cnt = hd_sum + v, hd_cnt + 1
    cm, total_loss, hd_sum, hd_cnt = eval_totals(
        cm, terms, hd_sum, hd_cnt, sum_group(mesh, sharded) if mesh is not None else None,
        ragged=mesh is not None and host_count() > 1)
    metrics = {k: float(v) for k, v in derived_metrics(cm, task).items()}
    if compute_hd95:
        metrics["hd95"] = hd_sum / hd_cnt if hd_cnt else float("nan")
    return total_loss, metrics


_NAT_NAMES = ("flat", "pallas", "plain")


def _rank0_pick(mesh, picked: tuple, device) -> tuple:
    """Rank 0's (rc, nat) backend pair on every rank of ``mesh`` (one
    broadcast of the two names' indices)."""
    import torch.distributed as dist

    rc, nat_b = picked
    idx = torch.tensor([RC_BACKENDS.index(rc), _NAT_NAMES.index(nat_b)], device=device)
    dist.broadcast(idx, 0)
    return RC_BACKENDS[int(idx[0])], _NAT_NAMES[int(idx[1])]

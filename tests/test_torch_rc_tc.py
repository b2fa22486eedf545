"""B4's bf16 numerics, its packed weights, and the launch plans of B4, B5
and B6.

On the CPU, all at small sizes:
  * ``pack_rc_weights``: each bf16 matrix unpacked from the buffer equals the
    folded weight rounded to bf16, its padding is zero, the float32 entries
    equal the weights, and every shape matches ``rc_dims``/``pack_layout``,
    at every (Cin, E, Cout) of ``RC_SHAPES`` (here and in chip_smoke.py);
  * the plain version with the bf16 kernel's rounding points against JAX's
    ``fused_reparam_conv(bf16 x, interpret=True)``, and against the float32
    plain version;
  * ``rc_plan``, ``dw_plan`` and ``stats_plan`` at every shape of
    ``RC_SHAPES`` and ``DW_SHAPES`` (here and in chip_smoke.py) and a few
    odd maps: shared memory within the block limit, tiles that cover the
    map, the workspace and packed sizes.

On a CUDA card (marker ``gpu``): ``stats_plan`` equals the plan that
``csrc/rc_stats.cu`` computes for itself at every shape above.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from lmnet_tpu_torch.ops.rc_flat import dw_plan
from lmnet_tpu_torch.ops.rc_train import STATS_TILE, kernel_stats_plan, stats_plan
from lmnet_tpu_torch.ops.rc_kernel import (
    MAX_PAIRS,
    MAX_SMEM,
    fold_rc_weights,
    fused_reparam_conv,
    fused_reparam_conv_plain,
    pack_layout,
    pack_rc_weights,
    rc_dims,
    rc_plan,
)
from test_torch_rc import DW_SHAPES, RC_SHAPES, _rc_deploy_variables, _rc_weights


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_shapes", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_SMOKE = _chip_smoke()
ALL_RC = sorted(set(RC_SHAPES) | set(_SMOKE.RC_SHAPES))
ALL_DW = sorted(set(DW_SHAPES) | set(_SMOKE.DW_SHAPES))
# B6 also at its training-forward block shapes and odd maps: 3x3, 1x1, a
# 17-row strip, an odd channel count, a chunked C that 8 does not divide
ALL_STATS = sorted(set(ALL_DW) | {(16, h, h, e) for h, e, _ in _SMOKE.B6_BLOCKS}
                   | {(1, 3, 3, 12), (2, 1, 1, 8), (1, 17, 33, 24), (2, 9, 9, 7), (1, 6, 5, 300)})


def _unpack(buf, name, Cin, E, Cout):
    off, shape, dtype = pack_layout(Cin, E, Cout)[name]
    n = int(np.prod(shape))
    if dtype == torch.float32:
        return buf[off:off + n].reshape(shape)
    return buf[off:off + n // 2].view(torch.bfloat16).reshape(shape)


@pytest.mark.parametrize("Cin,E,Cout", sorted({s[3:] for s in ALL_RC}))
def test_pack_rc_weights_unpacks_to_the_rounded_weights(Cin, E, Cout):
    w = _rc_weights(Cin * E + Cout, Cin, E, Cout, "cpu")
    buf = w["packed"]
    lay = pack_layout(Cin, E, Cout)
    d = rc_dims(Cin, E, Cout)
    assert buf.dtype == torch.float32 and buf.shape == (lay["total"],)
    assert all(v[0] % 4 == 0 for k, v in lay.items() if k != "total")
    for name, key in (("weT", "we"), ("wpT", "wp"), ("wscT", "wsc")):
        assert torch.equal(_unpack(buf, name, Cin, E, Cout), w[key].t())
    for name in ("be", "kdw", "bdw", "bp", "bsc"):
        assert torch.equal(_unpack(buf, name, Cin, E, Cout), w[name])

    we16 = _unpack(buf, "we16", Cin, E, Cout)
    assert we16.shape == (d["nchunk"] * d["ec"], d["kx"]) and d["nchunk"] * d["ec"] >= E
    assert d["kx"] % 16 == 0 and d["kx"] >= Cin
    assert torch.equal(we16[:E, :Cin], w["we"].to(torch.bfloat16))
    assert not we16[E:].any() and not we16[:, Cin:].any()

    wp16 = _unpack(buf, "wp16", Cin, E, Cout)
    assert wp16.shape == (d["np"], d["nchunk"], d["kc"]) and d["kc"] % 16 == 0
    assert d["np"] % 8 == 0 and d["np"] >= Cout
    cols = wp16[:, :, :d["ec"]].reshape(d["np"], -1)
    assert torch.equal(cols[:Cout, :E], w["wp"].to(torch.bfloat16))
    assert not cols[Cout:].any() and not cols[:, E:].any() and not wp16[:, :, d["ec"]:].any()

    wsc16 = _unpack(buf, "wsc16", Cin, E, Cout)
    assert wsc16.shape == (d["np"], d["kx"])
    assert torch.equal(wsc16[:Cout, :Cin], w["wsc"].to(torch.bfloat16))
    assert not wsc16[Cout:].any() and not wsc16[:, Cin:].any()
    # fold_rc_weights packs the same buffer
    assert torch.equal(pack_rc_weights({k: v for k, v in w.items() if k != "packed"}), buf)


def test_fold_rc_weights_packs():
    _, sd = _rc_deploy_variables(4, 5, 16, 6, (8, 8))
    w = fold_rc_weights(sd, "b")
    assert torch.equal(w["packed"], pack_rc_weights({k: v for k, v in w.items()
                                                     if k != "packed"}))


def test_plain_bf16_rounding_matches_jax_kernel():
    """The plain version at the bf16 kernel's rounding points (e float32)
    against JAX ``fused_reparam_conv(bf16 x, interpret=True)`` at 8x8, B=2:
    JAX's TPU kernel also rounds e, the depthwise sums (bf16 arithmetic) and
    t * s to bf16, so the two differ by a few bf16 roundings of the largest
    intermediates; within 3e-2 max|ref|."""
    import jax.numpy as jnp
    from lmnet_tpu.ops.pallas.rc_kernel import fold_rc_weights as j_fold
    from lmnet_tpu.ops.pallas.rc_kernel import fused_reparam_conv as j_fused

    jv, sd = _rc_deploy_variables(4, 5, 16, 6, (8, 8))
    x = np.random.RandomState(5).randn(2, 8, 8, 5).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want = np.asarray(j_fused(jnp.asarray(x).astype(jnp.bfloat16),
                              j_fold(jv["params"], jv["batch_stats"]), interpret=True)
                      .astype(jnp.float32))
    got = fused_reparam_conv(xb, fold_rc_weights(sd, "b"))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 8, 8, 6)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 3e-2 * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("B,H,W,Cin,E,Cout", [RC_SHAPES[1], RC_SHAPES[3], RC_SHAPES[5]])
def test_plain_bf16_rounding_against_float32(B, H, W, Cin, E, Cout):
    """The plain version that rounds at the bf16 kernel's points against
    the float32 plain version on the same bf16 x: it differs (it rounds),
    by at most 2^-6 max|ref| (bf16 weights and t * s, 2^-9 relative each,
    through sums of up to 192 products). That distance is what phase 10 of
    chip_smoke.py scales its bound on the kernel by."""
    w = _rc_weights(E, Cin, E, Cout, "cpu")
    x = torch.randn(B, H, W, Cin, generator=torch.Generator().manual_seed(B + H)).bfloat16()
    r = fused_reparam_conv_plain(x, w)
    f = fused_reparam_conv_plain(x.float(), w)
    assert r.dtype == torch.bfloat16 and f.dtype == torch.float32
    m = f.abs().max().item()
    dist = (r.float() - f).abs().max().item()
    assert 0 < dist <= 2**-6 * m, (dist, m)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,Cin,E,Cout", ALL_RC)
def test_rc_plan_fits_and_covers(dtype, B, H, W, Cin, E, Cout):
    plan = rc_plan(B, H, W, Cin, E, Cout, dtype)
    assert plan is not None
    (rows, cols), (s1, s2) = plan["tile"], plan["smem"]
    assert 0 < s1 <= s2 <= MAX_SMEM
    ty, tx = -(-H // rows), -(-W // cols)
    assert ty * rows >= H > (ty - 1) * rows and tx * cols >= W > (tx - 1) * cols
    assert plan["workspace"] == B * ty * tx * E
    assert plan["packed"] == pack_layout(Cin, E, Cout)["total"]
    if dtype == torch.bfloat16:
        d = rc_dims(Cin, E, Cout)
        assert cols in (8, 16) and rows == 8
        nwarps = rows * d["ec"] // 32
        assert -(-(rows * cols // 16) * (d["np"] // 8) // nwarps) <= MAX_PAIRS
        assert ((rows + 4) * (cols + 4)) % 16 == 0
    else:
        assert (rows, cols) == (8, 8)


def test_rc_plan_refuses_what_the_kernel_does_not_take():
    assert rc_plan(1, 8, 8, 4, 8, 4, torch.float16) is None
    assert rc_plan(0, 8, 8, 4, 8, 4, torch.bfloat16) is None
    # a 2-warp chunk (E = 8) cannot keep 96 outputs' y tiles in registers
    assert rc_plan(1, 8, 8, 4, 8, 192, torch.bfloat16) is None
    # the 32^2 stage at B=16 takes 8x8 tiles (an 8x16 tile leaves 128 blocks)
    assert rc_plan(16, 32, 32, 96, 192, 96, torch.bfloat16)["tile"] == (8, 8)
    assert rc_plan(16, 256, 256, 12, 24, 12, torch.bfloat16)["tile"] == (8, 16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,C", ALL_DW)
def test_dw_plan_fits_and_covers(dtype, B, H, W, C):
    plan = dw_plan(B, H, W, C, dtype)
    assert plan is not None
    rows, cols = plan["tile"]
    assert 0 < plan["smem"] <= MAX_SMEM
    ty, tx = -(-H // rows), -(-W // cols)
    assert plan["ntiles"] == ty * tx and ty * rows >= H and tx * cols >= W
    assert plan["workspace"] == B * plan["ntiles"] * C
    assert plan["chunk"] * plan["nchunk"] >= C > plan["chunk"] * (plan["nchunk"] - 1)
    esize = 4 if dtype == torch.float32 else 2
    vec = plan["vec"]
    assert vec in (2, 4, 8, 16) and (C * esize) % vec == 0 and (plan["chunk"] * esize) % vec == 0
    assert vec == 16 or (C * esize) % (2 * vec) != 0  # the widest that divides


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,C", ALL_STATS)
def test_stats_plan_fits_and_covers(dtype, B, H, W, C):
    """B6's plan: the 16x32 tile covers the map, the chunks cover C, the
    copy unit is the widest that divides C's channel run (and the chunk's),
    shared memory (halo in e's dtype, 41 taps a channel, 8 partials a
    thread of 8 x chunk) within the block limit, and 8 C partials a tile."""
    plan = stats_plan(B, H, W, C, dtype)
    assert plan is not None
    rows, cols = plan["tile"]
    assert (rows, cols) == STATS_TILE == (16, 32)
    ty, tx = -(-H // rows), -(-W // cols)
    assert plan["ntiles"] == ty * tx and plan["workspace"] == B * ty * tx * 8 * C
    ck = plan["chunk"]
    assert ck * plan["nchunk"] >= C > ck * (plan["nchunk"] - 1) and ck <= 32
    esize = 4 if dtype == torch.float32 else 2
    vec = plan["vec"]
    assert vec in (2, 4, 8, 16) and (C * esize) % vec == 0 and (ck * esize) % vec == 0
    assert vec == 16 or (C * esize) % (2 * vec) != 0
    halo = -(-20 * 36 * ck * esize // 16) * 16
    assert plan["smem"] == halo + (41 + 8 * 8) * ck * 4 <= MAX_SMEM
    if (B, H, W, C) in ALL_DW:  # the same tiles and chunks as B5
        d = dw_plan(B, H, W, C, dtype)
        assert (d["chunk"], d["vec"], d["ntiles"]) == (ck, vec, plan["ntiles"])


def test_stats_plan_refuses_what_the_kernel_does_not_take():
    assert stats_plan(1, 8, 8, 8, torch.float16) is None
    assert stats_plan(0, 8, 8, 8, torch.bfloat16) is None
    assert stats_plan(1, 0, 8, 8, torch.bfloat16) is None
    assert stats_plan(70000, 8, 8, 8, torch.bfloat16) is None


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_python_stats_plan_is_the_kernels_plan(cuda, dtype):
    """stats_plan and csrc/rc_stats.cu's geometry are one function: equal at
    every shape above, and both refuse the same shapes."""
    for shape in [*ALL_STATS, (0, 8, 8, 8), (1, 0, 8, 8), (70000, 8, 8, 8)]:
        assert kernel_stats_plan(*shape, dtype) == stats_plan(*shape, dtype), shape


# (B, h, W, Cin, E, Cout) a rank's row window gives B4, B5 and B6: the five
# block shapes of chip_smoke.py phase 21 (B = 4, 256 .. 32 rows a rank) and
# the CPU tests' small maps
WINDOW_RC = sorted({(_SMOKE.SPATIAL_BATCH, *s) for s in _SMOKE.SPATIAL_RC}
                   | {(2, 8, 12, 6, 16, 8), (2, 4, 12, 6, 16, 8), (3, 16, 16, 4, 8, 4),
                      (2, 4, 8, 8, 16, 8)})


def _windows(h, halo, edges):
    """(Hs, top) of the slabs of h rows a rank of 2 or 4 takes with ``halo``
    rows of each neighbour: with ``edges`` zero rows past the global edges
    (every slab h + 2 halo rows), else the first, middle and last rank's."""
    if edges:
        return [(h + 2 * halo, halo)]
    return [(h + halo, 0), (h + 2 * halo, halo), (h + halo, halo)]


def _tiles_cover_and_read_inside(plan, h, W, reach, padded):
    """The plan's tiles cover the h output rows (and W) exactly once; each
    tile's own rows lie inside the slab; with ``padded`` (the slab carries
    the zero rows past the global edges) so does every row its taps reach
    (``reach`` rows each side), else the taps past the slab are the ones the
    kernel zero-fills (the global padding)."""
    Hs, top = plan["window"]
    rows, cols = plan["tile"]
    ty, tx = -(-h // rows), -(-W // cols)
    seen = np.zeros(h, dtype=int)
    for t in range(ty):
        first, last = t * rows, min((t + 1) * rows, h)
        seen[first:last] += 1
        assert 0 <= top + first and top + last <= Hs
        if padded:
            assert top + first - reach >= 0 and top + last + reach <= Hs
    assert (seen == 1).all() and tx * cols >= W > (tx - 1) * cols


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,h,W,Cin,E,Cout", WINDOW_RC)
def test_window_plans_cover_the_rows_and_read_inside_the_slab(dtype, B, h, W, Cin, E, Cout):
    """B5's and B6's plans on slabs of h + 4 rows from row 2 (zero rows past
    the global edges), B4's on the first, middle and last rank's slabs (no
    row past the global edges): the geometry of the whole map's h rows (the
    tiles, chunks, shared memory and partials do not depend on the slab),
    the window recorded, the tiles covering the h output rows once, every
    read inside the slab."""
    for (Hs, top) in _windows(h, 2, edges=True):
        for fn in (dw_plan, stats_plan):
            plan, whole = fn(B, h, W, E, dtype, Hs, top), fn(B, h, W, E, dtype)
            assert plan["window"] == (Hs, top) and whole["window"] == (h, 0)
            assert {k: v for k, v in plan.items() if k != "window"} == \
                {k: v for k, v in whole.items() if k != "window"}
            _tiles_cover_and_read_inside(plan, h, W, 2, padded=True)
    for (Hs, top) in _windows(h, 2, edges=False):
        plan, whole = rc_plan(B, h, W, Cin, E, Cout, dtype, Hs, top), rc_plan(B, h, W, Cin, E,
                                                                               Cout, dtype)
        assert plan["window"] == (Hs, top)
        assert {k: v for k, v in plan.items() if k != "window"} == \
            {k: v for k, v in whole.items() if k != "window"}
        _tiles_cover_and_read_inside(plan, h, W, 2, padded=False)


@pytest.mark.parametrize("fn", ["dw_plan", "stats_plan", "rc_plan"])
def test_window_plans_refuse_rows_outside_the_slab(fn):
    args = {"dw_plan": (2, 8, 8, 8), "stats_plan": (2, 8, 8, 8), "rc_plan": (2, 8, 8, 4, 8, 4)}
    f = {"dw_plan": dw_plan, "stats_plan": stats_plan, "rc_plan": rc_plan}[fn]
    a = args[fn]
    assert f(*a, torch.bfloat16, 10, 2) is not None
    assert f(*a, torch.bfloat16, 10, 3) is None  # rows 3 .. 10 pass the slab's 10
    assert f(*a, torch.bfloat16, 7, 0) is None  # 8 output rows, a slab of 7
    assert f(*a, torch.bfloat16, 12, -1) is None


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_python_stats_plan_is_the_kernels_plan_on_a_window(cuda, dtype):
    """On the slab windows too, stats_plan and the kernel's plan agree, and
    both refuse output rows outside the slab."""
    for B, h, W, _, E, _ in WINDOW_RC:
        for Hs, top in _windows(h, 2, edges=True) + [(h, 1), (h - 1, 0)]:
            assert kernel_stats_plan(B, h, W, E, dtype, Hs, top) == \
                stats_plan(B, h, W, E, dtype, Hs, top), (B, h, W, E, Hs, top)

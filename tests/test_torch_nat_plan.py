"""The launch plans of the two NAT kernels of the default path, B1
(``csrc/nat_fwd.cu``) and B2 (``csrc/nat_bwd.cu``), on the CPU.

``ops/nat_flat.py::nat_plan`` gives each call's variant, tile, heads a
block, threads, grid, shared memory, copy unit and partials; the kernels
compute the same plan in C and refuse one that differs (a card test holds
that). Here, at every shape ``chip_smoke.py`` and the card tests give the
kernels: the tiles cover the map and the heads exactly once, the ragged
last tiles are non-empty, every halo the kernels copy lies inside the map
and inside its shared-memory allocation and holds every pixel a tile's
windows read, the shared memory fits a block, and the four 256^2 stages
take the vectorised variants. Then, in pure Python over small maps, B2's
ownership rule: every (query, head) adds to exactly one block's d_rpb
partial, and every key's inverse neighbourhood lies within its tile's +-2
query halo, whose windows lie within the +-3 key halo.
"""

import importlib.util
import itertools
from pathlib import Path

import pytest
import torch

from lmnet_tpu_torch.ops.nat_flat import MAX_SMEM, nat_plan


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_nat_shapes", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cs = _chip_smoke()

DTYPES = [torch.float32, torch.bfloat16]
# (B, H, W, heads, hd): chip_smoke.py's check shapes, the four 256^2 stages
# at B=16 (timed), the four NAT slabs a rank of a (1 x 2) spatial mesh
# gives the kernels at 512^2 (H = 257, 129, 65, 33; W.C = 6144), the card
# tests' shapes
SHAPES = sorted(set(
    [(B, H, W, cs.HEADS, C // cs.HEADS) for B, H, W, C in cs.CHECK_SHAPES]
    + [(cs.BATCH, H, W, cs.HEADS, C // cs.HEADS) for H, W, C in cs.STAGES_256]
    + [(cs.SPATIAL_BATCH, H, W, cs.HEADS, C // cs.HEADS) for H, W, C in cs.SPATIAL_SLABS]
    + [(2, 3, 3, 2, 2), (1, 28, 28, 12, 3), (2, 9, 17, 3, 1), (1, 16, 8, 2, 8), (1, 5, 7, 1, 16),
       (2, 32, 8, 3, 1), (2, 16, 8, 2, 4), (2, 8, 8, 2, 2), (2, 16, 4, 1, 4), (2, 28, 8, 2, 3),
       (2, 28, 28, 3, 2), (2, 32, 32, 12, 8), (2, 64, 64, 12, 4), (1, 9, 10, 3, 2),
       (1, 4, 4, 2, 2), (1, 20, 37, 12, 1), (2, 9, 17, 12, 1), (1, 3, 3, 12, 1),
       (2, 16, 4, 12, 4), (1, 33, 40, 12, 2), (1, 12, 12, 12, 3), (2, 256, 256, 12, 1)]))


def _ws(x: int, n: int) -> int:
    """First row (column) of the clamped 3-wide window around x in [0, n)."""
    return min(max(x - 1, 0), n - 3)


def _tiles(plan, B, H, W, heads):
    """(b, tile row start, tile column start, first head, rows, cols, heads)
    of every block, as the kernels read blockIdx."""
    (rows, cols), nh = plan["tile"], plan["heads_per_block"]
    gx, gy, gz = plan["grid"]
    nchunk = -(-heads // nh)
    for bx, by, bz in itertools.product(range(gx), range(gy), range(gz)):
        b, h0 = divmod(bz, nchunk)
        tr0, tc0, h0 = by * rows, bx * cols, h0 * nh
        yield b, tr0, tc0, h0, min(rows, H - tr0), min(cols, W - tc0), min(nh, heads - h0)


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,W,heads,hd", SHAPES)
def test_plan_covers_the_map_once_and_fits(kind, dtype, B, H, W, heads, hd):
    plan = nat_plan(B, H, W, heads, hd, dtype, kind)
    assert plan is not None
    (rows, cols), nh, per = plan["tile"], plan["heads_per_block"], plan["heads_per_thread"]
    gx, gy, gz = plan["grid"]
    # the grid covers the map and the heads exactly once; the last tiles are
    # ragged but not empty
    assert (gx - 1) * cols < W <= gx * cols and (gy - 1) * rows < H <= gy * rows
    assert gz == B * -(-heads // nh) and nh % per == 0 and heads % per == 0
    assert gy <= 65535 and gz <= 65535
    assert 0 < plan["smem"] <= MAX_SMEM and 0 < plan["threads"] <= 1024
    assert plan["threads"] % (nh // per) == 0
    es = 4 if dtype == torch.float32 else 2
    vb = plan["vec_bytes"]
    assert vb in (2, 4, 8, 16) and (heads * hd * es) % vb == 0 and (nh * hd * es) % vb == 0
    if plan["variant"] == "vec":
        assert hd in (1, 2, 4, 8)
    if plan["variant"] == "vec" and kind == "fwd":
        # a thread's channels: 8 or 16 bytes, or one f32 head of 8 (32 bytes)
        assert per * hd * es in (8, 16) or (hd == 8 and es == 4 and per == 1)
    else:
        assert per == 1
    assert plan["workspace"] == (B * gx * gy * heads * 25 if kind == "bwd" else 0)
    seen = torch.zeros(B, H, W, heads, dtype=torch.int32)
    for b, tr0, tc0, h0, nr, nc, nhb in _tiles(plan, B, H, W, heads):
        assert nr > 0 and nc > 0 and nhb > 0
        seen[b, tr0:tr0 + nr, tc0:tc0 + nc, h0:h0 + nhb] += 1
    assert bool((seen == 1).all())


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
@pytest.mark.parametrize("B,H,W,heads,hd", SHAPES)
def test_halos_hold_every_window_and_stay_inside(kind, B, H, W, heads, hd):
    """The rows (and columns) each kernel copies: inside the map, inside the
    allocation, and holding every window its pixels read."""
    plan = nat_plan(B, H, W, heads, hd, torch.bfloat16, kind)
    rows, cols = plan["tile"]
    for tr0, nr, n, extent in [(t, min(rows, H - t), H, rows) for t in range(0, H, rows)] + \
                              [(t, min(cols, W - t), W, cols) for t in range(0, W, cols)]:
        if kind == "fwd":
            # k/v halo: from the tile start's window, min(extent + 2, n - start) long
            k0 = _ws(tr0, n)
            kn = min(extent + 2, n - k0)
            want = {_ws(x, n) + i for x in range(tr0, tr0 + nr) for i in range(3)}
            assert 0 <= k0 and k0 + kn <= n and kn <= extent + 2
            assert want <= set(range(k0, k0 + kn))
        else:
            # the +-2 query halo, then the windows of its queries (+-3)
            q0 = max(tr0 - 2, 0)
            qn = min(tr0 + nr + 2, n) - q0
            k0 = _ws(q0, n)
            kn = min(qn + 2, n - k0)
            assert 0 <= q0 and q0 + qn <= n and qn <= extent + 4
            assert 0 <= k0 and k0 + kn <= n and kn <= extent + 6
            queries = set(range(q0, q0 + qn))
            # every query whose window covers a tile key is in the query halo
            for key in range(tr0, tr0 + nr):
                cover = {x for x in range(n) if _ws(x, n) <= key <= _ws(x, n) + 2}
                assert cover <= queries
            want = {_ws(x, n) + i for x in queries for i in range(3)}
            assert want <= set(range(k0, k0 + kn))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["fwd", "bwd"])
@pytest.mark.parametrize("H,W,C", cs.STAGES_256 + cs.STAGES_288)
def test_the_model_stages_take_the_vectorised_variants(dtype, kind, H, W, C):
    plan = nat_plan(cs.BATCH, H, W, cs.HEADS, C // cs.HEADS, dtype, kind)
    assert plan["variant"] == "vec"
    if kind == "fwd" and dtype == torch.bfloat16:
        # 16 bytes of channels a thread, but C = 12 (24-byte pixels): 8 bytes
        assert plan["heads_per_thread"] * (C // cs.HEADS) * 2 == (8 if C == 12 else 16)
        assert plan["vec_bytes"] == (8 if C == 12 else 16)
    # a block for each of the card's 132 SMs at least
    gx, gy, gz = plan["grid"]
    assert gx * gy * gz >= 132


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["fwd", "bwd"])
@pytest.mark.parametrize("H,W,C", cs.SPATIAL_SLABS)
def test_the_spatial_slabs_take_the_vectorised_variants(dtype, kind, H, W, C):
    """The halo slabs of a sharded 512^2 step (a block's rows and one of the
    neighbour's, odd H): 'vec', as at every model stage, with a ragged last
    tile row."""
    B = cs.SPATIAL_BATCH
    plan = nat_plan(B, H, W, cs.HEADS, C // cs.HEADS, dtype, kind)
    assert plan["variant"] == "vec" and W * C == 6144
    rows = plan["tile"][0]
    gx, gy, gz = plan["grid"]
    assert H % rows and gy == -(-H // rows) and gx * gy * gz >= 132


@pytest.mark.parametrize("B,H,W,heads", [(1, 3, 3, 2), (2, 7, 9, 3), (1, 12, 37, 2),
                                         (2, 20, 5, 1), (1, 4, 70, 35)])
def test_bwd_ownership_counts_each_query_once(B, H, W, heads):
    """B2's rule in pure Python: pass 1 of a block visits its +-2 query halo
    and adds a query's dl to the block's d_rpb partial only where the query
    lies in the block's own tile and heads: over all blocks every (image,
    query, head) is added exactly once; pass 2 finds every query whose
    window covers a tile key inside that halo."""
    plan = nat_plan(B, H, W, heads, 1, torch.bfloat16, "bwd")
    counted = torch.zeros(B, H, W, heads, dtype=torch.int32)
    for b, tr0, tc0, h0, nr, nc, nhb in _tiles(plan, B, H, W, heads):
        q0r, q0c = max(tr0 - 2, 0), max(tc0 - 2, 0)
        halo = [(r, c) for r in range(q0r, min(tr0 + nr + 2, H))
                for c in range(q0c, min(tc0 + nc + 2, W))]
        for r, c in halo:
            if tr0 <= r < tr0 + nr and tc0 <= c < tc0 + nc:
                counted[b, r, c, h0:h0 + nhb] += 1
        hs = set(halo)
        for kr, kc in itertools.product(range(tr0, tr0 + nr), range(tc0, tc0 + nc)):
            inv = {(r, c) for r in range(H) for c in range(W)
                   if _ws(r, H) <= kr <= _ws(r, H) + 2 and _ws(c, W) <= kc <= _ws(c, W) + 2}
            assert inv and inv <= hs
            assert all(abs(r - kr) <= 2 and abs(c - kc) <= 2 for r, c in inv)
    assert bool((counted == 1).all())


def test_plan_refuses_what_the_kernels_do_not_take():
    assert nat_plan(1, 8, 8, 2, 2, torch.float16, "fwd") is None
    assert nat_plan(1, 2, 8, 2, 2, torch.bfloat16, "fwd") is None
    assert nat_plan(1, 8, 2, 2, 2, torch.bfloat16, "bwd") is None
    assert nat_plan(0, 8, 8, 2, 2, torch.bfloat16, "bwd") is None
    assert nat_plan(1, 8, 8, 257, 1, torch.bfloat16, "bwd") is None
    assert nat_plan(1, 8, 8, 257, 1, torch.bfloat16, "fwd") is not None
    assert nat_plan(1, 8, 8, 2, 2, torch.bfloat16, "sideways") is None


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
@pytest.mark.parametrize("heads,hd", [(256, 8), (64, 16), (5, 3), (3, 1), (256, 1)])
def test_plan_takes_wide_and_odd_heads(kind, heads, hd):
    """Heads beyond a block's 32 go to head chunks; head_dims other than 1,
    2, 4, 8, or a C no 8-byte group divides (B1), take the generic
    variant."""
    for dtype in DTYPES:
        plan = nat_plan(2, 11, 13, heads, hd, dtype, kind)
        assert plan is not None and plan["heads_per_block"] <= 32
        assert plan["smem"] <= MAX_SMEM
        assert (plan["variant"] == "generic") == (hd not in (1, 2, 4, 8) or (
            kind == "fwd" and hd * heads % (8 // (4 if dtype == torch.float32 else 2)) != 0))


# --------------------------------------------------------------------------
# on the card: the CUDA sources' own plan (python -m pytest --noconftest -m
# gpu tests/test_torch_nat_plan.py)
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["fwd", "bwd"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_python_plan_is_the_kernels_plan(cuda, kind, dtype):
    """nat_plan and nat_common.cuh::make_plan are one function: equal at
    every shape above, at the wide and odd heads, and both refuse the same
    shapes."""
    from lmnet_tpu_torch.ops.nat_flat import kernel_plan

    shapes = SHAPES + [(2, 11, 13, h, d) for h, d in ((256, 8), (64, 16), (5, 3), (3, 1),
                                                       (256, 1), (257, 1))]
    shapes += [(1, 2, 8, 2, 2), (0, 8, 8, 2, 2)]
    for B, H, W, heads, hd in shapes:
        assert kernel_plan(B, H, W, heads, hd, dtype, kind) == nat_plan(
            B, H, W, heads, hd, dtype, kind), (B, H, W, heads, hd)

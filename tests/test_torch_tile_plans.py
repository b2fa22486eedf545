"""The launch plans of B7 (``csrc/upsample_flat.cu``) and B3
(``csrc/nat_kernel.cu``), on the CPU.

``ops/upsample_flat.py::upsample_plan`` and ``ops/nat_kernel.py::b3_plan``
give each call's variant, tile, threads, grid (B3: persistent blocks),
shared memory and the TMA boxes; the kernels compute the same plans in C,
encode their maps and place their copies by them, and refuse one that
differs (the card test at the end holds the two equal, geometry included).
Here, at
every shape ``chip_smoke.py`` and the card tests give the kernels: the
blocks (B3: the tiles) cover the map exactly once; every pixel a block reads
lies inside its TMA box and inside its own image; every box is legal for a
tensor map (each dimension at most 256 elements, the inner row and every
stride a multiple of 16 bytes, the destinations 128-byte aligned, the bytes
a stage's barrier expects below 2^20) and the shared memory fits a block;
the model's shapes take the TMA variants and the odd shapes the generic
ones; and B3's persistent blocks visit every tile exactly once.
"""

import importlib.util
import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from lmnet_tpu_torch.ops.nat_kernel import b3_plan
from lmnet_tpu_torch.ops.upsample_flat import upsample_plan


def _module(name, file):
    path = Path(__file__).resolve().parent / file
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cs = _module("chip_smoke_tile_plans", "../chip_smoke.py")

DTYPES = [torch.float32, torch.bfloat16]
MAX_SMEM = 232448  # a block's shared memory on sm_90
MAX_TX = 2**20 - 1  # an mbarrier's transaction count
# chip_smoke.py phase 14's odd shapes: pixels of 6, 24 and 40 bytes in bf16
# (3, 12 and 20 channels), which no tensor map can stride
UP_ODD = [(2, 5, 7, 3), (2, 1, 1, 8), (3, 9, 13, 12), (1, 7, 3, 20)]
# (B, H, W, C): the model's upsamples at 256^2 and 288^2 (B=16, B=2), the odd
# shapes, the card tests' shapes, channel chunks past 256
UP_SHAPES = sorted(set(
    cs.UPSAMPLE_SHAPES + cs.UPSAMPLE_SHAPES_288
    + [(2, h, w, c) for _, h, w, c in cs.UPSAMPLE_SHAPES] + UP_ODD
    + [(2, 16, 16, 192), (2, 32, 32, 96), (1, 64, 64, 48), (1, 128, 128, 24), (1, 1, 7, 3),
       (2, 5, 9, 12), (1, 8, 9, 5), (3, 7, 3, 4), (2, 16, 16, 8), (1, 8, 32, 4), (1, 16, 24, 16),
       (1, 8, 48, 8), (1, 5, 7, 3), (1, 9, 11, 384), (2, 6, 5, 320), (1, 3, 70, 8)]))
# (B, H, W, heads, hd): chip_smoke.py's check shapes, the four 256^2 stages
# at B=16, the card tests' shapes, head chunks and ragged tiles
NAT_SHAPES = sorted(set(
    [(B, H, W, cs.HEADS, C // cs.HEADS) for B, H, W, C in cs.CHECK_SHAPES]
    + [(cs.BATCH, H, W, cs.HEADS, C // cs.HEADS) for H, W, C in cs.STAGES_256]
    + [(2, 16, 16, 12, 1), (1, 32, 40, 12, 2), (2, 16, 16, 12, 4), (1, 8, 8, 12, 8),
       (2, 3, 3, 2, 2), (1, 28, 28, 12, 3), (2, 16, 4, 12, 4), (1, 5, 7, 1, 16),
       (1, 13, 37, 3, 1), (1, 6, 6, 12, 32), (1, 9, 11, 64, 8), (2, 7, 13, 12, 1),
       (1, 33, 35, 12, 1), (1, 3, 3, 12, 1), (3, 17, 19, 6, 4), (1, 12, 9, 128, 2),
       (1, 8, 8, 6, 1), (2, 9, 10, 6, 1), (1, 7, 12, 3, 2)]))


def _es(dtype):
    return 4 if dtype == torch.float32 else 2


def _ws(x: int, n: int) -> int:
    """First row (column) of the clamped 3-wide window around x in [0, n)."""
    return min(max(x - 1, 0), n - 3)


def _legal_map(dims, strides, boxes, es):
    """The rules of a tiled tensor map: each box dimension 1..256 elements,
    the inner box row a multiple of 16 bytes, every stride a multiple of 16
    bytes, each box no longer than 5 dimensions, as many as the map's."""
    assert 2 <= len(dims) <= 5 and len(strides) == len(dims) - 1
    assert all(s % 16 == 0 for s in strides)
    for box in boxes:
        assert len(box) == len(dims)
        assert all(1 <= d <= 256 for d in box), box
        assert box[0] * es % 16 == 0, box


# --------------------------------------------------------------------------
# B7: upsample_plan
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,W,C", UP_SHAPES)
def test_upsample_plan_covers_every_output_once(dtype, B, H, W, C):
    """Each input pixel and channel (so each output 2x2 and channel) falls
    to exactly one block and one thread's chunk; the grid and the threads
    are within the card's limits."""
    plan = upsample_plan(B, H, W, C, dtype)
    assert plan is not None
    (th, tw), cc, V = plan["tile"], plan["chunk"], plan["vec"]
    gx, gy, gz = plan["grid"]
    assert gy <= 65535 and gz <= 65535 and 32 <= plan["threads"] <= 512
    assert plan["threads"] % 32 == 0 and C % V == 0 and V * _es(dtype) <= 16
    nchunk = gz // B
    assert gz == B * nchunk and (nchunk - 1) * cc < C <= nchunk * cc
    if plan["variant"] == "tma":
        # a thread a 16-byte output chunk of the block's output row segment
        assert V * _es(dtype) == 16 and cc % V == 0
        assert 2 * tw * (cc // V) <= plan["threads"] < 2 * tw * (cc // V) + 32
    else:
        assert th == 1 and cc == C and plan["threads"] <= 256
    seen = np.zeros((B, H, W, C), dtype=np.int32)
    for bx, by, bz in itertools.product(range(gx), range(gy), range(gz)):
        b, ch0 = divmod(bz, nchunk)
        r0, c0, ch0 = by * th, bx * tw, ch0 * cc
        assert r0 < H and c0 < W  # no empty block
        seen[b, r0:r0 + th, c0:c0 + tw, ch0:ch0 + cc] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,W,C", UP_SHAPES)
def test_upsample_tma_box_is_legal_and_holds_every_read(dtype, B, H, W, C):
    """The 'tma' block's box: legal for a 3-D map over (C, W, B*H), its
    shared memory 128-byte aligned and within a block's, the barrier's bytes
    below 2^20; every input row and column a block's outputs read (k-1, k,
    k+1 clamped to the map) lies inside the box and inside the block's
    image: the box's rows in the next image or past the map are never
    read."""
    plan = upsample_plan(B, H, W, C, dtype)
    if plan["variant"] != "tma":
        assert plan["box"] is None and plan["smem"] == 0
        return
    es = _es(dtype)
    (th, tw), cc = plan["tile"], plan["chunk"]
    _legal_map(plan["map"]["dims"], plan["map"]["strides"], [plan["box"]], es)
    assert plan["map"]["dims"] == (C, W, B * H)
    rb, copies, stride = plan["box"][2], plan["copies"], plan["copy_stride"]
    assert plan["box"] == (cc, tw + 2, rb) and copies == -(-(th + 2) // rb) <= 4
    box_bytes = cc * (tw + 2) * rb * es
    # the copies land one every stride bytes from the offset, each on 128
    # bytes, each within the block's shared memory; at most 16 barriers
    # before them
    assert plan["offset"] % 128 == 0 and stride % 128 == 0 and box_bytes <= stride
    assert plan["offset"] + copies * stride + 128 <= plan["smem"] <= 48 * 1024
    assert copies * 8 <= plan["offset"] and box_bytes <= MAX_TX
    for r0 in range(0, H, th):
        rows = {min(max(k + d, 0), H - 1) for k in range(r0, min(r0 + th, H)) for d in (-1, 0, 1)}
        assert rows <= set(range(r0 - 1, r0 - 1 + copies * rb)) and rows <= set(range(H))
    for c0 in range(0, W, tw):
        cols = {min(max(j + d, 0), W - 1) for j in range(c0, min(c0 + tw, W)) for d in (-1, 0, 1)}
        assert cols <= set(range(c0 - 1, c0 + tw + 1)) and cols <= set(range(W))


@pytest.mark.parametrize("dtype", DTYPES)
def test_upsample_variants_follow_the_pixel_bytes(dtype):
    """'tma' exactly where a pixel's bytes are a multiple of 16: every upsample
    of the model, in both dtypes; the odd shapes of chip_smoke.py phase 14
    ((2, 5, 7, 3), (3, 9, 13, 12) and (1, 7, 3, 20) in bf16) take
    'generic'."""
    es = _es(dtype)
    for B, H, W, C in UP_SHAPES:
        plan = upsample_plan(B, H, W, C, dtype)
        assert plan["variant"] == ("tma" if C * es % 16 == 0 else "generic"), (B, H, W, C)
    for shape in cs.UPSAMPLE_SHAPES + cs.UPSAMPLE_SHAPES_288:
        assert upsample_plan(*shape, dtype)["variant"] == "tma"
    if dtype == torch.bfloat16:
        for shape in [(2, 5, 7, 3), (3, 9, 13, 12), (1, 7, 3, 20)]:
            assert upsample_plan(*shape, dtype)["variant"] == "generic"


def test_upsample_plan_refuses_what_the_kernel_does_not_take():
    assert upsample_plan(1, 4, 4, 8, torch.float16) is None
    assert upsample_plan(0, 4, 4, 8, torch.bfloat16) is None
    assert upsample_plan(1, 70000, 4, 3, torch.bfloat16) is None  # a grid row past 65535
    assert upsample_plan(70000, 4, 4, 8, torch.bfloat16) is None
    assert upsample_plan(1, 70000, 4, 8, torch.bfloat16) is not None  # tiles of 16 rows


# (B, h, W, C) a rank's row window gives B7: the four upsample input shapes
# of chip_smoke.py phase 21 (B = 4, 16 .. 128 rows a rank) and small maps, the
# generic variant's odd pixels among them
UP_WINDOW = sorted({(cs.SPATIAL_BATCH, *s) for s in cs.SPATIAL_UP}
                   | {(2, 4, 6, 4), (2, 8, 12, 8), (1, 2, 5, 3), (2, 16, 16, 192)})


def _up_windows(h, size):
    """(Hs, top, Hg, row0) of each rank's slab of a map of size x h rows: one
    row of each neighbour, none past the global edges."""
    Hg = size * h
    return [(h + (r > 0) + (r < size - 1), int(r > 0), Hg, r * h) for r in range(size)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,h,W,C", UP_WINDOW)
def test_upsample_plan_on_a_window_reads_inside_its_box_and_slab(dtype, B, h, W, C):
    """On every rank's slab of 2 and of 4: the plan is the whole map's for
    h rows but for the map's dims (C, W, B*Hs); its blocks cover the h rows
    once; every slab row a block's outputs read (the global rows k-1, k,
    k+1, clamped to the global map, at slab row top + k - row0) lies in
    [0, Hs) and, for 'tma', inside the block's box of rows from slab row
    top + r0 - 1."""
    for size in (2, 4):
        for Hs, top, Hg, row0 in _up_windows(h, size):
            plan, whole = upsample_plan(B, h, W, C, dtype, Hs), upsample_plan(B, h, W, C, dtype)
            assert {k: v for k, v in plan.items() if k != "map"} == \
                {k: v for k, v in whole.items() if k != "map"}
            th = plan["tile"][0]
            assert plan["grid"][1] == -(-h // th)
            if plan["variant"] == "tma":
                assert plan["map"]["dims"] == (C, W, B * Hs)
                box_rows = plan["copies"] * plan["box"][2]
            for r0 in range(0, h, th):
                reads = {top + min(max(row0 + k + d, 0), Hg - 1) - row0
                         for k in range(r0, min(r0 + th, h)) for d in (-1, 0, 1)}
                assert reads <= set(range(Hs)), (Hs, top, Hg, row0, r0)
                if plan["variant"] == "tma":
                    assert reads <= set(range(top + r0 - 1, top + r0 - 1 + box_rows))


def test_upsample_plan_refuses_a_slab_shorter_than_its_rows():
    assert upsample_plan(2, 8, 8, 8, torch.bfloat16, 7) is None
    assert upsample_plan(2, 8, 8, 8, torch.bfloat16, 9)["map"]["dims"] == (8, 8, 18)


# --------------------------------------------------------------------------
# B3: b3_plan
# --------------------------------------------------------------------------


def _b3_tiles(plan, B, H, W, heads):
    """(b, h0, tr0, tc0) of every tile, in the kernel's order (column tiles
    fastest, then row tiles, head chunks, images)."""
    rows, cols = plan["tile"]
    nh = plan["heads_per_block"]
    gx, gy = -(-W // cols), -(-H // rows)
    nchunk = -(-heads // nh)
    for t in range(plan["tiles"]):
        tx, r = t % gx, t // gx
        ty, r = r % gy, r // gy
        chunk, b = r % nchunk, r // nchunk
        yield b, chunk * nh, ty * rows, tx * cols


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,W,heads,hd", NAT_SHAPES)
def test_b3_plan_covers_the_map_once_and_fits(dtype, B, H, W, heads, hd):
    plan = b3_plan(B, H, W, heads, hd, dtype)
    assert plan is not None
    (rows, cols), nh, per = plan["tile"], plan["heads_per_block"], plan["heads_per_thread"]
    gx, gy, gz = plan["grid"]
    nchunk = -(-heads // nh)
    assert (gx - 1) * cols < W <= gx * cols and (gy - 1) * rows < H <= gy * rows
    assert gz == B * nchunk and plan["tiles"] == gx * gy * gz
    assert nh % per == 0 and heads % per == 0
    assert plan["threads"] == nh // per * plan["ppb"] <= 384
    assert 0 < plan["smem"] <= MAX_SMEM
    seen = np.zeros((B, H, W, heads), dtype=np.int32)
    for b, h0, tr0, tc0 in _b3_tiles(plan, B, H, W, heads):
        assert tr0 < H and tc0 < W and h0 < heads and b < B
        seen[b, tr0:tr0 + rows, tc0:tc0 + cols, h0:h0 + nh] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,W,heads,hd", NAT_SHAPES)
def test_b3_persistent_walk_visits_each_tile_once(dtype, B, H, W, heads, hd):
    """Block i takes tiles i, i + blocks, ...: every tile once; two blocks an
    SM at most, and no block without a tile. The generic variant's grid is
    one block a tile."""
    plan = b3_plan(B, H, W, heads, hd, dtype)
    tiles, blocks = plan["tiles"], plan["blocks"]
    if plan["variant"] == "generic":
        assert blocks == tiles
        return
    assert 1 <= blocks <= min(tiles, 2 * 132)
    visits = np.zeros(tiles, dtype=np.int32)
    stages = set()
    for blk in range(blocks):
        for it, t in enumerate(range(blk, tiles, blocks)):
            visits[t] += 1
            stages.add(it & 1)
    assert (visits == 1).all()
    if tiles > blocks:
        assert stages == {0, 1}  # the ring turns


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,W,heads,hd", NAT_SHAPES)
def test_b3_boxes_are_legal_and_hold_every_window(dtype, B, H, W, heads, hd):
    """The 'vec' variant's maps and boxes: legal (rank 3 over (C, W, B*H),
    rank 2 over (W*C, B*H)), the stages' regions 128-byte aligned and inside
    the shared memory, the bytes a stage's barrier expects below 2^20; every
    window pixel of a tile's queries inside its halo box and inside the map,
    every query inside its q box."""
    plan = b3_plan(B, H, W, heads, hd, dtype)
    if plan["variant"] != "vec":
        assert plan["maps"] is None and plan["halo_cols"] is None
        assert plan["vec_bytes"] in (2, 4, 8, 16)
        es = _es(dtype)
        assert heads * hd * es % plan["vec_bytes"] == 0
        return
    es = _es(dtype)
    C = heads * hd
    (rows, cols), nh = plan["tile"], plan["heads_per_block"]
    boxes = plan["boxes"]
    _legal_map(plan["maps"]["dims"], plan["maps"]["strides"], [boxes["q"], boxes["halo"]], es)
    # a box row starts on 16 bytes: rank 2's halo at a multiple of the
    # pixel period at or below the window start, its q box at the tile's
    # first column
    period = 16 // min(C * es & -(C * es), 16) if plan["rank"] == 2 else 1
    hw = -(-(cols + 1 + period) // period) * period
    assert (plan["period"], plan["halo_cols"]) == (period, hw)
    if plan["rank"] == 3:
        assert plan["maps"]["dims"] == (C, W, B * H) and nh * hd * es % 16 == 0
        assert boxes["q"] == (nh * hd, cols, rows)
        assert boxes["halo"] == (nh * hd, cols + 2, rows + 2)
    else:
        assert C * es % 16 != 0 and nh == heads and cols % period == 0
        assert plan["maps"]["dims"] == (W * C, B * H)
        assert boxes["q"] == (cols * C, rows) and boxes["halo"] == (hw * C, rows + 2)
        assert hw * C * es % 16 == 0 and cols * C * es % 16 == 0
    lay = plan["layout"]
    for key in ("rp", "q0", "k0", "v0", "stage"):
        assert lay[key] % 128 == 0, key
    assert lay["rp"] + 25 * heads * 4 <= lay["q0"]
    assert lay["q0"] + lay["qbox"] <= lay["k0"] and lay["k0"] + lay["hbox"] <= lay["v0"]
    assert lay["v0"] + lay["hbox"] <= lay["q0"] + lay["stage"]
    assert lay["q0"] + 2 * lay["stage"] + 128 <= plan["smem"] == lay["total"]
    assert lay["qbox"] + 2 * lay["hbox"] <= MAX_TX
    assert lay["qbox"] == rows * cols * nh * hd * es
    assert lay["hbox"] == (rows + 2) * hw * nh * hd * es
    for t0, n, extent, width, step in ([(t, H, rows, rows + 2, 1) for t in range(0, H, rows)]
                                       + [(t, W, cols, hw, period) for t in range(0, W, cols)]):
        h0 = _ws(t0, n) // step * step
        want = {_ws(x, n) + i for x in range(t0, min(t0 + extent, n)) for i in range(3)}
        assert want <= set(range(h0, h0 + width)) and want <= set(range(n))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H,W,C", cs.STAGES_256 + cs.STAGES_288)
def test_the_model_stages_take_the_tma_variant(dtype, H, W, C):
    """Every NAT stage of the model takes 'vec': a 3-D map wherever a
    pixel's bytes are a multiple of 16, a 2-D map at C = 12 in bf16 (a
    24-byte pixel) with 16 columns of queries and halo box rows of 20
    pixels, 240 elements, starting on an even pixel."""
    plan = b3_plan(cs.BATCH, H, W, cs.HEADS, C // cs.HEADS, dtype)
    assert plan["variant"] == "vec"
    if dtype == torch.bfloat16:
        assert plan["heads_per_block"] == cs.HEADS
    if C * _es(dtype) % 16 == 0:
        assert plan["rank"] == 3
    else:
        assert (plan["rank"], plan["tile"][1], plan["boxes"]["halo"][0]) == (2, 16, 240)
    assert plan["blocks"] == min(plan["tiles"], 2 * 132)


def _compiled_triples():
    """{dtype: {(head_dim, heads a thread, maps' rank)}}: the vec variant's
    instances in nat_kernel.cu's dispatch (LMNET_B3_BF16, LMNET_B3_F32)."""
    src = (Path(__file__).resolve().parent.parent
           / "lmnet_tpu_torch" / "csrc" / "nat_kernel.cu").read_text()
    out = {}
    for name, dtype in (("LMNET_B3_BF16", torch.bfloat16), ("LMNET_B3_F32", torch.float32)):
        body = re.search(rf"#define {name}\(X\)((?:.*\\\n)*.*)", src).group(1)
        out[dtype] = {tuple(map(int, t)) for t in re.findall(r"X\((\d+), (\d+), (\d+)\)", body)}
        assert out[dtype], name
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd", [1, 2, 4, 8])
def test_b3_every_vec_plan_has_a_compiled_kernel(dtype, hd):
    """Every (head_dim, heads a thread, rank) that b3_plan gives the vec
    variant, over 1 to 40 heads and widths 3 to 40 (both map ranks, every C
    mod 8), is one the CUDA source's dispatch compiles: a plan without one
    would fail its launch. The float32 rank-2 plans (C = 2 mod 4) are
    among them."""
    compiled = _compiled_triples()[dtype]
    given = set()
    for heads, W in itertools.product(range(1, 41), range(3, 41)):
        plan = b3_plan(2, 9, W, heads, hd, dtype)
        if plan["variant"] == "vec":
            given.add((hd, plan["heads_per_thread"], plan["rank"]))
    assert given and given <= compiled, given - compiled
    if dtype == torch.float32 and hd <= 2:
        assert (hd, 2 // hd, 2) in given  # C = 2 mod 4: 8 bytes a thread, a rank-2 map


def test_b3_generic_variant_and_what_is_refused():
    """head_dim 3, 16 and 32 take 'generic'; a C no 8-byte group divides at
    head_dim 1 too, and a rank-2 row no box holds; a halo that fits no
    block's shared memory is refused, as are shapes under 3x3."""
    for hd in (3, 16, 32):
        assert b3_plan(1, 9, 9, 12, hd, torch.bfloat16)["variant"] == "generic"
    assert b3_plan(1, 9, 9, 3, 1, torch.bfloat16)["variant"] == "generic"  # C = 3
    assert b3_plan(1, 9, 13, 12, 1, torch.bfloat16)["variant"] == "generic"  # W*C*2 = 312
    assert b3_plan(1, 9, 9, 100, 1, torch.bfloat16)["variant"] == "generic"  # 3 x 100 > 256
    assert b3_plan(1, 9, 9, 1, 40000, torch.bfloat16) is None
    assert b3_plan(1, 2, 9, 12, 1, torch.bfloat16) is None
    assert b3_plan(1, 9, 9, 12, 1, torch.float16) is None
    wide = b3_plan(1, 9, 11, 64, 8, torch.bfloat16)  # C = 512: two chunks of 256
    assert wide["variant"] == "vec" and wide["heads_per_block"] * 8 <= 256


# --------------------------------------------------------------------------
# on the card: the CUDA sources' own plans (python -m pytest --noconftest -m
# gpu tests/test_torch_tile_plans.py)
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_python_plans_are_the_kernels_plans(cuda, dtype):
    """upsample_plan and up_plan, b3_plan and nat_kernel.cu's b3_plan are
    one function each: equal at every shape above, the maps, boxes, copies
    and shared-memory layout that the launches encode and the kernels read
    included, so that the box rules held above hold for the kernels; both
    refuse the same shapes; ``lmnet_nat_tile_takes`` answers as the plan
    does."""
    from lmnet_tpu_torch.ops import nat_kernel, upsample_flat

    for shape in UP_SHAPES + [(1, 70000, 4, 3), (0, 4, 4, 8)]:
        assert upsample_flat.kernel_plan(*shape, dtype) == upsample_plan(*shape, dtype), shape
    for B, h, W, C in UP_WINDOW:  # the row windows' slabs, and one too short
        for Hs in sorted({w[0] for w in _up_windows(h, 4)} | {h - 1}):
            assert upsample_flat.kernel_plan(B, h, W, C, dtype, Hs) == \
                upsample_plan(B, h, W, C, dtype, Hs), (B, h, W, C, Hs)
    for shape in NAT_SHAPES + [(1, 9, 9, 1, 40000), (1, 2, 9, 12, 1), (1, 9, 13, 12, 1)]:
        want = b3_plan(*shape, dtype)
        assert nat_kernel.kernel_takes(*shape, dtype) == (want is not None), shape
        assert nat_kernel.kernel_plan(*shape, dtype) == want, shape

"""B4, B5, B6 and B7 on a row window (``parallel/spatial.py``), on the CPU.

The row window is what each of the four kernels takes inside an H shard of
the mesh's 'spatial' axis: a slab of rows, the slab row of its first output
row and its output rows (B7 also the global height and the global row).
Here, in one process and with no process group, each rank's slab is cut
from a seeded whole map as the rank's exchange would make it, the plain
windowed version runs on it, and its output rows and its sums (summed over
the ranks) are held against the plain version on the whole map, for every
rank of 2 and of 4 (so both global edges and the middle), float32 and
bfloat16:

* B5 (``dw_gelu_flat_plain``) and B6 (``rc_branch_stats_plain``): the slab
  has 2 rows of each neighbour and zero rows past the global edges, as
  ``halo(e, 2, 2)`` gives it;
* B4 (``rc_phase1`` and ``rc_phase2``, which on CPU tensors are the plain
  version): the slab has 2 rows of each neighbour and none past the global
  edges (``halo(x, 2, 2, edges=False)``), since the expand runs inside the
  kernel and a zero row of x would give e = hardswish(be), not the
  depthwise's zero padding; phase 2 runs with the whole map's SE scale;
* B7 (``upsample2x_flat_plain``): one row of each neighbour, none past the
  global edges, the weights and the clamp of the global H.

Tolerances: float32 outputs within 1e-6 x max|ref| (elementwise); bf16
outputs within one rounding of the stored value, 2^-8 |ref| + 1e-6 x
max|ref|; the sums within 1e-5 x max|ref| of the whole map's (float32
sums in another order).
"""

import numpy as np
import pytest
import torch

from lmnet_tpu_torch.ops.rc_flat import dw_gelu_flat_plain, se_scale
from lmnet_tpu_torch.ops.rc_kernel import (
    fused_reparam_conv_plain,
    pack_rc_weights,
    rc_phase1,
    rc_phase2,
)
from lmnet_tpu_torch.ops.rc_train import _branch_outputs, rc_branch_stats_plain
from lmnet_tpu_torch.ops.upsample_flat import upsample2x_flat_plain

PLACES = [(0, 2), (1, 2), (0, 4), (1, 4), (2, 4), (3, 4)]  # (index, size)
DTYPES = [torch.float32, torch.bfloat16]
B, H, W, C = 2, 16, 12, 8  # 4 rows a rank at size 4: the 5x5's reach crosses a block


def _rng(seed):
    return np.random.RandomState(seed)


def _t(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))


def _slab(x, index, size, halo, edges):
    """Rank ``index`` of ``size``'s slab of whole map ``x`` (rows on axis 1)
    with ``halo`` rows of each neighbour: zero rows past the global edges
    with ``edges``, else none. Returns (slab, top, rows, row0)."""
    h = x.shape[1] // size
    lo, hi = index * h - halo, (index + 1) * h + halo
    part = x[:, max(lo, 0):min(hi, x.shape[1])]
    if edges:
        pad = [x.new_zeros((x.shape[0], max(-lo, 0), *x.shape[2:])), part,
               x.new_zeros((x.shape[0], max(hi - x.shape[1], 0), *x.shape[2:]))]
        return torch.cat(pad, dim=1), halo, h, index * h
    return part.contiguous(), index * h - max(lo, 0), h, index * h


def _rows(want, index, size):
    h = want.shape[1] // size
    return want[:, index * h:(index + 1) * h]


def _close(got, want, dtype, what):
    big = want.float().abs().max().item()
    err = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        bound = 1e-6 * big
    else:
        bound = 2**-8 * want.float().abs() + 1e-6 * big
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.shape, want.shape)
    assert bool((err <= bound).all()), f"{what}: max err {err.max().item():.3e}"


def _sums_close(got, want, what):
    bound = 1e-5 * want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= bound, f"{what}: sums off by {err:.3e} (bound {bound:.3e})"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("index,size", PLACES)
def test_b5_window_gives_the_whole_maps_rows_and_sums(index, size, dtype):
    rng = _rng(50)
    e = _t(rng, B, H, W * C).to(dtype)
    k, b = _t(rng, C, 1, 5, 5, scale=0.3), _t(rng, C, scale=0.1)
    want_t, want_s = dw_gelu_flat_plain(e, k, b, C)
    got_s = torch.zeros_like(want_s)
    for r in range(size):
        slab, top, rows, _ = _slab(e, r, size, 2, edges=True)
        t, s = dw_gelu_flat_plain(slab, k, b, C, top, rows)
        got_s += s
        if r == index:
            _close(t, _rows(want_t, r, size), dtype, f"B5 t rank {r}/{size}")
    _sums_close(got_s, want_s, f"B5 sums over {size} ranks")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("index,size", PLACES)
def test_b6_window_sums_add_up_to_the_whole_maps(index, size, dtype):
    """Each rank's (4, 2, C) statistics over its own rows; rank ``index``'s
    share is the whole map's statistics of its rows, and the ranks' add up
    to the whole map's."""
    rng = _rng(60)
    e = _t(rng, B, H, W * C).to(dtype)
    ks = [_t(rng, C, 1, kh, kw, scale=0.3) for kh, kw in ((5, 5), (3, 3), (3, 1), (1, 3))]
    want = rc_branch_stats_plain(e, *ks, C)
    parts = []
    for r in range(size):
        slab, top, rows, _ = _slab(e, r, size, 2, edges=True)
        parts.append(rc_branch_stats_plain(slab, *ks, C, top, rows))
    _sums_close(sum(parts), want, f"B6 statistics over {size} ranks")
    # rank index's share: the whole map's branches at its rows
    ys = _branch_outputs(e, [k.float() for k in ks], C, torch.float32)
    h = H // size
    own = torch.stack([torch.stack([y[:, :, index * h:(index + 1) * h].sum(dim=(0, 2, 3)),
                                    y[:, :, index * h:(index + 1) * h].square().sum(dim=(0, 2, 3))])
                       for y in ys])
    _sums_close(parts[index], own, f"B6 statistics of rank {index}/{size}")


def _b4_weights(Cin, E, Cout, seed):
    rng = _rng(seed)
    w = dict(we=_t(rng, E, Cin, scale=0.4), be=_t(rng, E, scale=0.5),
             kdw=_t(rng, 25, E, scale=0.3), bdw=_t(rng, E, scale=0.1),
             fc1_w=_t(rng, E // 4, E, scale=0.4), fc1_b=_t(rng, E // 4, scale=0.1),
             fc2_w=_t(rng, E, E // 4, scale=0.4), fc2_b=_t(rng, E, scale=0.1),
             wp=_t(rng, Cout, E, scale=0.3), bp=_t(rng, Cout, scale=0.1),
             wsc=_t(rng, Cout, Cin, scale=0.3), bsc=_t(rng, Cout, scale=0.1))
    w["packed"] = pack_rc_weights(w)
    return w


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("index,size", PLACES)
def test_b4_window_gives_the_whole_maps_rows_and_sums(index, size, dtype):
    """Phase 1's sums over the ranks are the whole map's; phase 2 with the
    whole map's SE scale gives the whole map's rows. be is large, so a zero
    row of x past a global edge (hardswish(be) != 0) would show."""
    w = _b4_weights(6, 16, 8, 70)
    x = _t(_rng(71), B, H, W, 6).to(dtype)
    want = fused_reparam_conv_plain(x, w)
    want_s = rc_phase1(x, w)
    got_s = torch.zeros_like(want_s)
    for r in range(size):
        slab, top, rows, _ = _slab(x, r, size, 2, edges=False)
        got_s += rc_phase1(slab, w, top, rows)
    _sums_close(got_s, want_s, f"B4 phase-1 sums over {size} ranks")
    s = se_scale(want_s, w, H * W)
    slab, top, rows, _ = _slab(x, index, size, 2, edges=False)
    _close(rc_phase2(slab, w, s, top, rows), _rows(want, index, size), dtype,
           f"B4 rank {index}/{size}")


def test_b4_window_edge_rows_are_padding_not_hardswish_of_the_bias():
    """The reason B4's slab has no rows past the global edges: with zero rows
    of x there, the top rank's rows differ from the whole map's."""
    w = _b4_weights(6, 16, 8, 70)
    x = _t(_rng(71), B, H, W, 6)
    want = fused_reparam_conv_plain(x, w)
    s = se_scale(rc_phase1(x, w), w, H * W)
    slab, top, rows, _ = _slab(x, 0, 2, 2, edges=True)
    wrong = rc_phase2(slab, w, s, top, rows)
    assert (wrong - want[:, :rows]).abs().max() > 1e-3


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("index,size", PLACES)
def test_b7_window_gives_the_whole_maps_rows(index, size, dtype):
    """Each rank's 2h output rows, from its slab with one row of each
    neighbour, in global coordinates: the last rank's last row reads the
    clamped global H - 1, the first rank's first the clamped row 0."""
    x = _t(_rng(80), B, H, W, C).to(dtype)
    want = upsample2x_flat_plain(x)
    slab, top, rows, row0 = _slab(x, index, size, 1, edges=False)
    got = upsample2x_flat_plain(slab, top, rows, H, row0)
    _close(got, _rows(want, index, size), dtype, f"B7 rank {index}/{size}")


def test_windows_that_miss_a_row_raise():
    """A slab that lacks a row the window reads is refused, not read past."""
    x = torch.randn(1, 8, 4, 8)
    with pytest.raises(ValueError):
        upsample2x_flat_plain(x[:, 2:6], 0, 4, 16, 4)  # row 3 (global) is missing
    with pytest.raises(ValueError):
        dw_gelu_flat_plain(x.reshape(1, 8, 32), torch.zeros(8, 1, 5, 5), torch.zeros(8), 8, 6, 4)
    w = _b4_weights(8, 16, 8, 1)
    with pytest.raises(ValueError):
        rc_phase1(x, w, 5, 4)


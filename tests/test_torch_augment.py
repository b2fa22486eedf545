"""The port's train augmentation (``lmnet_tpu_torch/data/augment.py``)
against the JAX package's, on the CPU at 72^2 -> 64^2.

Each op gets the parameters JAX draws from its keys, replayed by the same
``jax.random`` calls, and is held to JAX's output; the whole pipeline is held
to ``_augment_one`` and ``train_pipeline`` on samples whose keys cover all ten
OneOf branches. The random streams themselves differ (torch generator against
JAX key tree), so the draws are held to the pipeline's probabilities and
ranges instead.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lmnet_tpu.data import augment as J
from lmnet_tpu_torch.data import augment as T

H, S = 72, 64  # the 'train' split's 9/8 load size and the crop
U = jax.random.uniform


def _close(got, want, atol, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=name)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


@pytest.fixture(scope="module")
def keys():
    return jax.random.split(jax.random.key(1), 3)


@pytest.fixture(scope="module")
def smooth():
    """Three smooth 64^2 RGB images (float 0..255): steep enough to move
    every op, smooth enough that a float32 ulp of a coordinate moves a value
    by little."""
    rng = np.random.RandomState(0)
    base = np.cumsum(rng.normal(0, 4, (3, S, S, 3)), 1).cumsum(2)
    return np.clip(base / 40 + 128, 0, 255).astype(np.float32)


def _jitter_factors(k):
    _, kb, kc, ks, kh = jax.random.split(k, 5)
    return jnp.stack([U(kb, (), minval=1 - 0.2, maxval=1 + 0.2),
                      U(kc, (), minval=1 - 0.2, maxval=1 + 0.2),
                      U(ks, (), minval=1 - 0.2, maxval=1 + 0.2),
                      U(kh, (), minval=-0.2, maxval=0.2)])


def _hsv_shifts(k):
    k1, k2, k3 = jax.random.split(k, 3)
    return jnp.stack([U(k1, (), minval=-20.0, maxval=20.0) * 2.0,
                      U(k2, (), minval=-30.0, maxval=30.0) / 255.0,
                      U(k3, (), minval=-20.0, maxval=20.0) / 255.0])


def _grid_stretch(k):
    k1, k2 = jax.random.split(k)
    return jnp.stack([1.0 + U(k1, (6,), minval=-0.3, maxval=0.3),
                      1.0 + U(k2, (6,), minval=-0.3, maxval=0.3)])


def _elastic_coarse(k):
    return U(jax.random.split(k)[0], (1, 16, 16, 2), minval=-1.0, maxval=1.0)[0]


# (name, JAX op on (key, img), port op on (img, replayed params), parameters
# replayed from the key, absolute tolerance on the 0..255 scale). The
# tolerances are float32 rounding of the same arithmetic in another order:
# a few ulps of 255 (3e-5), 1e-3 where a sum or division differs by an ulp,
# 5e-3 for HSV, whose hue divides by a small max - min.
OPS = [
    ("color_jitter", lambda k, x: J.color_jitter(k, x, p=1.0),
     T.color_jitter, _jitter_factors, 1e-3),
    ("hue_saturation_value", J.hue_saturation_value, T.hue_saturation_value, _hsv_shifts, 5e-3),
    ("to_gray", J.to_gray, lambda x, p: T.to_gray(x), None, 1e-4),
    ("channel_shuffle", J.channel_shuffle, T.channel_shuffle,
     lambda k: jax.random.permutation(k, 3), 0.0),
    ("rgb_shift", J.rgb_shift, T.rgb_shift,
     lambda k: U(k, (3,), minval=-20.0, maxval=20.0), 0.0),
    ("gaussian_blur", J.gaussian_blur, T.gaussian_blur,
     lambda k: U(k, (), minval=0.5, maxval=2.0), 1e-3),
    ("grid_dropout", J.grid_dropout, lambda x, p: T.grid_dropout(x), None, 0.0),
]


@pytest.mark.parametrize("name,jop,top,replay,atol", OPS, ids=[o[0] for o in OPS])
def test_photometric_op_matches_jax(name, jop, top, replay, atol, keys, smooth):
    """Each colour op on three images with per-sample parameters replayed
    from JAX's keys: within ``atol`` (0..255 scale) of JAX's op."""
    want = jax.jit(jax.vmap(jop))(keys, smooth)
    params = None
    if replay is not None:
        params = _t(jax.jit(jax.vmap(replay))(keys))
        if name == "channel_shuffle":
            params = params.long()
    got = top(torch.from_numpy(smooth), params)
    _close(got, want, atol, name)


@pytest.mark.parametrize("order", [0, 1])
def test_warp_matches_jax(order, keys):
    """The composed RRC @ SSR @ flips resample of a noise image (the worst
    case: 255-level steps between neighbours). Order 0 exactly; order 1
    within 5e-3 of 255: JAX forms the coordinates with a dot, the port with
    multiply-adds, an ulp apart (8e-6 at 72 px), times a 255 step."""
    rng = np.random.RandomState(2)
    imgs = rng.randint(0, 256, (3, H, H, 3)).astype(np.float32)
    mats = jax.vmap(lambda k: J.random_resized_crop_matrix(k, (H, H), S)
                    @ J.shift_scale_rotate_matrix(jax.random.fold_in(k, 1), (S, S), p=1.0)
                    @ J.flip_matrices(jax.random.fold_in(k, 2), (S, S)))(keys)
    want = jax.jit(jax.vmap(lambda i, m: J._warp(i, m, (S, S), order)))(imgs, mats)
    got = T._warp(torch.from_numpy(imgs), _t(mats), (S, S), order)
    _close(got, want, 0.0 if order == 0 else 5e-3, f"order {order}")


def test_map_coordinates_rounds_half_away_and_zeroes_each_corner():
    """Order 0 at coordinates exactly on .5 (where F.grid_sample's nearest
    rounds half to even) and order 1 with corners outside the map, against
    jax.scipy.ndimage.map_coordinates; exact."""
    from jax.scipy.ndimage import map_coordinates

    img = np.arange(20.0, dtype=np.float32).reshape(4, 5)
    rows = np.array([[-0.5, 0.5, 1.5, 2.5, 3.5, -1.0, 3.2, 0.0]], np.float32)
    cols = np.array([[0.5, 1.5, 2.5, 3.5, 4.5, 2.0, -0.7, 4.6]], np.float32)
    for order in (0, 1):
        want = map_coordinates(jnp.asarray(img), [rows, cols], order=order, cval=0.0)
        got = T._map_coordinates(torch.from_numpy(img)[None, ..., None], _t(rows),
                                 _t(cols), order)[..., 0]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_displacement_fields_and_warp_match_jax(keys, smooth):
    """Elastic and grid-distortion fields from replayed parameters (elastic
    within 1e-5 px: JAX's lerp coefficients are float64, F.interpolate's
    float32; grid exactly), then the displacement warp of image (order 1,
    1e-3 of 255) and mask (order 0, exact)."""
    jd = jax.vmap(lambda k: J.elastic_displacement(k, (S, S)))(keys)
    td = T.elastic_displacement(_t(jax.vmap(_elastic_coarse)(keys)), (S, S))
    jg = jax.vmap(lambda k: J.grid_distortion_displacement(k, (S, S)))(keys)
    tg = T.grid_distortion_displacement(_t(jax.vmap(_grid_stretch)(keys)), (S, S))
    for got, want, atol, name in ((td, jd, 1e-5, "elastic"), (tg, jg, 0.0, "grid")):
        _close(got[0], want[0], atol, name + " dr")
        _close(got[1], want[1], atol, name + " dc")
    mask = (smooth[..., 0] > 128).astype(np.float32)
    for order, x, atol in ((1, smooth, 1e-3), (0, mask, 0.0)):
        want = jax.vmap(lambda i, a, b: J._displacement_warp(i, a, b, order))(x, *jd)
        xt = torch.from_numpy(x if x.ndim == 4 else x[..., None])
        got = T._displacement_warp(xt, *(_t(a) for a in jd), order)
        _close(got if x.ndim == 4 else got[..., 0], want, atol, f"order {order}")


def test_elastic_upsample_is_jax_lerp_with_its_clamp():
    """ops/resize.bilinear_resize (F.interpolate, align_corners=False) on the
    16x16 field against JAX's bilinear_resize (_lerp_coeffs: source clamped
    at 0), at the pipeline's square sizes and an odd one, within 2e-6 of
    the field's unit range (float32 source coordinates against float64)."""
    from lmnet_tpu.ops.resize import bilinear_resize as j_resize
    from lmnet_tpu_torch.ops.resize import bilinear_resize as t_resize

    f = np.random.RandomState(3).uniform(-1, 1, (2, 16, 16, 2)).astype(np.float32)
    for hw in ((64, 64), (256, 256), (40, 24)):
        _close(t_resize(torch.from_numpy(f), hw, align_corners=False),
               j_resize(jnp.asarray(f), hw, align_corners=False), 2e-6, str(hw))


def test_lab_round_trip_matches_jax(smooth):
    """RGB -> cv2 LAB -> RGB: within 1e-4 of JAX on the 0..255 scale (cube
    root as a power of 1/3 against jnp.cbrt, an ulp apart)."""
    lab = jax.vmap(J._rgb_to_lab)(smooth)
    for got, want, n in zip(T._rgb_to_lab(torch.from_numpy(smooth)), lab, "Lab"):
        _close(got, want, 1e-4, n)
    _close(T._lab_to_rgb(*(_t(c) for c in lab)), jax.vmap(J._lab_to_rgb)(*lab), 1e-4, "rgb")


def test_clahe_matches_jax(keys, smooth):
    """``_clahe_lum`` on JAX's own L plane with the replayed clip limits is
    exact; the whole CLAHE (Lab in, LUT, Lab out) within 1e-3 of 255 except
    where an ulp of L crosses a .5 and rounds into the next histogram bin:
    at most 1e-3 of the values (8e-5 measured)."""
    clip = jax.vmap(lambda k: U(k, (), minval=1.0, maxval=4.0))(keys)
    lum = jax.vmap(J._rgb_to_lab)(smooth)[0]
    want = jax.jit(jax.vmap(J._clahe_lum))(lum, clip)
    _close(T._clahe_lum(_t(lum), _t(clip)), want, 0.0, "lum")
    got = T.clahe(torch.from_numpy(smooth), _t(clip)).numpy()
    want = np.asarray(jax.jit(jax.vmap(J.clahe))(keys, smooth))
    assert (np.abs(got - want) > 1e-3).mean() <= 1e-3


@pytest.mark.parametrize("shape", [(64, 64), (96, 96), (70, 90)])
def test_clahe_lum_matches_cv2(shape):
    """cv2.createCLAHE(4.0, (8, 8)) on cv2's integer L plane: within the
    final-rounding half-level (0.5), as tests/test_augment.py holds JAX."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.RandomState(11)
    h, w = shape
    base = np.cumsum(rng.normal(0, 4, (h, w, 3)), axis=0).cumsum(axis=1)
    smooth = np.clip(base / 40 + 128, 0, 255).astype(np.uint8)
    noisy = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    for img in (smooth, noisy):
        lab = cv2.cvtColor(img, cv2.COLOR_RGB2LAB)
        want = cv2.createCLAHE(clipLimit=4.0, tileGridSize=(8, 8)).apply(lab[..., 0])
        got = T._clahe_lum(torch.from_numpy(lab[..., 0].astype(np.float32))[None],
                           torch.tensor([4.0]))[0]
        assert np.abs(got.numpy() - want.astype(np.float64)).max() <= 0.5 + 1e-3


def _replay(key, load=H, out=S):
    """The parameters ``_augment_one(key, ...)`` draws on a ``load``^2
    image cropped to ``out``^2, by its own key splits."""
    keys = jax.random.split(key, 6)
    mat = (J.random_resized_crop_matrix(keys[0], (load, load), out)
           @ J.shift_scale_rotate_matrix(keys[1], (out, out))
           @ J.flip_matrices(keys[2], (out, out)))
    k_sel, k_op, k_warp = jax.random.split(keys[4], 3)
    return {
        "mat": mat, "jitter": U(jax.random.split(keys[3], 5)[0]) < 0.4,
        "jitter_factors": _jitter_factors(keys[3]),
        "branch": jnp.where(U(k_sel) < 0.4, jax.random.randint(k_op, (), 0, 9), 9),
        "hsv": _hsv_shifts(k_warp), "perm": jax.random.permutation(k_warp, 3),
        "rgb_shift": U(k_warp, (3,), minval=-20.0, maxval=20.0),
        "sigma": U(k_warp, (), minval=0.5, maxval=2.0),
        "clahe_clip": U(k_warp, (), minval=1.0, maxval=4.0),
        "elastic": _elastic_coarse(k_warp), "grid": _grid_stretch(k_warp),
    }


def _port_params(jax_params) -> dict:
    """JAX's replayed parameters as ``draw_params``' dict."""
    p = {k: _t(v) for k, v in jax.device_get(jax_params).items()}
    p["perm"], p["branch"] = p["perm"].long(), p["branch"].long()
    return p


def _batch(B, seed):
    """Smooth uint8 images at the load size and circle masks."""
    rng = np.random.RandomState(seed)
    base = np.cumsum(rng.normal(0, 6, (B, H, H, 3)), 1).cumsum(2)
    imgs = np.clip(base / 30 + 128, 0, 255).astype(np.uint8)
    yy, xx = np.mgrid[:H, :H]
    masks = np.stack([(yy - 30 - i) ** 2 + (xx - 36) ** 2 < (12 + i) ** 2 for i in range(B)])
    return imgs, masks.astype(np.uint8)


def _hold(got, want):
    """Normalised images within 1e-4 (a 0.006 gray level: float32 rounding
    of the same arithmetic, CLAHE's rare bin crossings allowed on 1e-3 of
    the values), masks equal on at least 99.9 % of the pixels."""
    gx, gy = (t.numpy() for t in got)
    wx, wy = (np.asarray(a) for a in want)
    assert gx.shape == wx.shape and gx.dtype == np.float32 and gy.dtype == np.int64
    d = np.abs(gx - wx)
    assert (d > 1e-4).mean() <= 1e-3, d.max()
    assert (gy == wy).mean() >= 0.999


@pytest.fixture(scope="module")
def branch_keys():
    """Thirteen keys whose samples draw every OneOf branch (0..9), and the
    warping and CLAHE branches (1, 2, 3) twice: the first key for each from
    512 keys split off key(0)."""
    cand = jax.random.split(jax.random.key(0), 512)
    br = np.asarray(jax.jit(jax.vmap(lambda k: _replay(k)["branch"]))(cand))
    pick = [int(np.nonzero(br == b)[0][0]) for b in range(10)]
    pick += [int(np.nonzero(br == b)[0][1]) for b in (1, 2, 3)]
    return cand[np.array(pick)]


def test_pipeline_matches_augment_one_on_every_branch(branch_keys):
    """``apply_params`` with each sample's parameters replayed from its key
    against JAX's ``_augment_one`` on the same uint8 batch, one sample per
    branch (and the three warping and CLAHE branches twice)."""
    imgs, masks = _batch(len(branch_keys), 0)
    want = jax.jit(jax.vmap(lambda k, i, m: J._augment_one(k, i.astype(jnp.float32), m, S)))(
        branch_keys, imgs, masks)
    params = _port_params(jax.jit(jax.vmap(_replay))(branch_keys))
    assert sorted(set(params["branch"].tolist())) == list(range(10))
    _hold(T.apply_params(torch.from_numpy(imgs), torch.from_numpy(masks), params, S), want)


def test_pipeline_matches_train_pipeline():
    """JAX's batched ``train_pipeline(key, ...)`` on 6 samples: its per-sample
    keys are ``split(key, 6)``, replayed one by one."""
    key = jax.random.key(5)
    imgs, masks = _batch(6, 1)
    want = J.train_pipeline(key, jnp.asarray(imgs), jnp.asarray(masks), out_size=S)
    params = _port_params(jax.jit(jax.vmap(_replay))(jax.random.split(key, 6)))
    _hold(T.apply_params(torch.from_numpy(imgs), torch.from_numpy(masks), params, S), want)


def test_grouped_branches_equal_one_sample_at_a_time():
    """The OneOf runs each branch once on its samples: the batch equals the
    samples augmented one at a time with their own parameters (exactly)."""
    imgs, masks = _batch(24, 2)
    params = T.draw_params(torch.Generator().manual_seed(4), 24, (H, H), S)
    x, y = T.apply_params(torch.from_numpy(imgs), torch.from_numpy(masks), params, S)
    assert len(set(params["branch"].tolist())) >= 5
    for i in range(24):
        one = {k: v[i:i + 1] for k, v in params.items()}
        xi, yi = T.apply_params(torch.from_numpy(imgs[i:i + 1]),
                                torch.from_numpy(masks[i:i + 1]), one, S)
        torch.testing.assert_close(x[i:i + 1], xi, rtol=0, atol=0)
        assert torch.equal(y[i:i + 1], yi)


def test_train_pipeline_contract():
    """(B, S, S, 3) float32 normalised images and (B, S, S) int64 binary
    masks; the same generator seed gives the same batch, another seed
    another."""
    imgs, masks = (torch.from_numpy(a) for a in _batch(4, 3))

    def run(seed):
        return T.train_pipeline(torch.Generator().manual_seed(seed), imgs, masks, S)

    (x1, y1), (x2, y2), (x3, _) = run(7), run(7), run(8)
    assert x1.shape == (4, S, S, 3) and x1.dtype == torch.float32
    assert y1.shape == (4, S, S) and y1.dtype == torch.int64
    assert torch.equal(x1, x2) and torch.equal(y1, y2) and not torch.equal(x1, x3)
    assert set(y1.unique().tolist()) <= {0, 1}


def test_draws_follow_the_pipeline_probabilities():
    """20,000 samples from ``draw_params``: each share within 0.01 of its
    probability (over 6 binomial standard deviations at this count): the
    identity branch 0.6 and each other 0.4/9, the colour jitter 0.4, SSR
    0.5, each flip 0.5, each of the 6 channel orders 1/6; every factor inside
    its range."""
    n = 20000
    g = torch.Generator().manual_seed(0)
    p = T.draw_params(g, n, (H, H), S)
    shares = torch.bincount(p["branch"], minlength=10).double() / n
    assert abs(shares[9] - 0.6) < 0.01
    assert (shares[:9] - 0.4 / 9).abs().max() < 0.01
    assert abs(p["jitter"].double().mean() - 0.4) < 0.01
    g = torch.Generator().manual_seed(1)
    ssr = T.shift_scale_rotate_matrix(g, n, (S, S))
    assert abs((ssr[:, 0, 0] != 1).double().mean() - 0.5) < 0.01
    flips = T.flip_matrices(torch.Generator().manual_seed(2), n, (S, S))
    assert abs((flips[:, 0, 0] < 0).double().mean() - 0.5) < 0.01
    assert abs((flips[:, 1, 1] < 0).double().mean() - 0.5) < 0.01
    orders = torch.unique(p["perm"], dim=0, return_counts=True)[1].double() / n
    assert len(orders) == 6 and (orders - 1 / 6).abs().max() < 0.01
    f = p["jitter_factors"]
    assert f[:, :3].min() >= 0.8 and f[:, :3].max() <= 1.2 and f[:, 3].abs().max() <= 0.2
    assert p["hsv"][:, 0].abs().max() <= 40 and p["hsv"][:, 1].abs().max() <= 30 / 255
    assert p["rgb_shift"].abs().max() <= 20 and 0.5 <= p["sigma"].min() <= p["sigma"].max() <= 2
    assert 1 <= p["clahe_clip"].min() and p["clahe_clip"].max() <= 4
    assert p["elastic"].abs().max() <= 1 and (p["grid"] - 1).abs().max() <= 0.3
    # the crop keeps 80-100 % of the area, less where a side is clipped to
    # the image (down to sqrt(0.8 x 0.75) at the extreme aspect ratio)
    rrc = T.random_resized_crop_matrix(torch.Generator().manual_seed(3), n, (H, H), S)
    area = rrc[:, 0, 0] * rrc[:, 1, 1] * S * S / (H * H)
    assert area.min() >= 0.8 ** 0.5 * 0.75 ** 0.5 - 1e-4 and area.max() <= 1.0 + 1e-4

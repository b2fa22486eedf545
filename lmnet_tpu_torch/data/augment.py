"""Image preprocessing as torch ops on the batch's device: the train
augmentation, ``normalize`` and ``eval_pipeline``.

Counterpart of ``lmnet_tpu/data/augment.py``. The train pipeline is the same
Albumentations stack, with the same parameter ranges and probabilities:

  RandomResizedCrop(S, scale=(0.8, 1.0)) -> ShiftScaleRotate(0.1, 0.1, 30 deg,
  p=0.5) -> H/V flips (0.5 each), composed into ONE inverse affine per
  sample and resampled once (bilinear image, nearest mask);
  ColorJitter(0.2, 0.2, 0.2, 0.2, p=0.4), in JAX's fixed order brightness ->
  contrast -> saturation -> hue (a documented deviation from Albumentations'
  random order);
  OneOf([ToGray, GridDistortion, ElasticTransform, CLAHE, HueSaturationValue,
  ChannelShuffle, GridDropout, RGBShift(20), GaussianBlur], p=0.4);
  Normalize(ImageNet).

JAX draws every parameter from a key tree inside one vmapped program. Here the
pipeline is split in two so that its randomness can be replayed:
``draw_params`` draws every sample's parameters from a ``torch.Generator`` on
the CPU (a few hundred numbers a batch, so the stream does not depend on the
device), and ``apply_params`` does the work on the images' device, batched
over the samples: the OneOf runs each branch once on the samples that drew it.

The arithmetic follows JAX's op for op, so that the same parameters give the
same images up to float32 rounding:
  * ``_map_coordinates`` is ``jax.scipy.ndimage.map_coordinates`` in
    'constant' mode as an explicit gather: order 0 rounds half away from zero
    (``F.grid_sample`` rounds half to even and normalises its coordinates),
    order 1 zeroes each out-of-range corner on its own, and the four corner
    terms are summed in JAX's order;
  * CLAHE is cv2's (``_clahe_lum``): reflect-101 padding, round half to even,
    the integer clip limit, the stepped redistribution of the residual and
    the four-tile LUT blend;
  * HSV uses ``torch.remainder`` (JAX's float ``%``) and a truncating cast;
  * the Gaussian blur pads with zeros, as ``conv_general_dilated`` does.
Products that JAX writes as a dot (the affine map, gray, Lab's 3x3) are
written out as multiply-adds, which gives the card and the CPU the same
coordinates.

Images are float32 0..255 RGB inside the pipeline; the outputs are
normalised float32 images and int64 masks.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from lmnet_tpu_torch.ops.resize import bilinear_resize

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# the OneOf's branches, in JAX's lax.switch order; 9 (identity) is drawn with
# probability 0.6
BRANCHES = ("gray", "grid", "elastic", "clahe", "hsv", "shuffle", "dropout", "rgbshift", "blur")
IDENTITY = len(BRANCHES)
ONE_OF_P = 0.4
ELASTIC_COARSE = 16
GRID_STEPS = 5


def normalize(img: torch.Tensor) -> torch.Tensor:
    """A.Normalize(): x/255, subtract the ImageNet mean, divide by the std
    (float32, channels last)."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=img.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=img.device)
    return (img.to(torch.float32) / 255.0 - mean) / std


def eval_pipeline(images: torch.Tensor, masks: torch.Tensor, out_size: int = 256):
    """Val/test path: the host has already resized to ``out_size``; this
    normalizes the (B, H, W, 3) uint8 images and turns the (B, H, W) masks
    into int64 class ids."""
    return normalize(images), masks.to(torch.int64)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def _uniform(g: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=g, dtype=torch.float32)


def _scale_offset(ar, br, ac, bc) -> torch.Tensor:
    """(B, 3, 3) [[ar, 0, br], [0, ac, bc], [0, 0, 1]] from (B,) tensors."""
    z, o = torch.zeros_like(ar), torch.ones_like(ar)
    return torch.stack([torch.stack([ar, z, br], -1), torch.stack([z, ac, bc], -1),
                        torch.stack([z, z, o], -1)], -2)


def random_resized_crop_matrix(g, B, in_hw, out_size, scale=(0.8, 1.0),
                               ratio=(0.75, 4.0 / 3.0)) -> torch.Tensor:
    """Inverse affines of A.RandomResizedCrop: a random area fraction and
    aspect ratio, resized to (out_size, out_size) with cv2's half-pixel
    centres (JAX ``random_resized_crop_matrix``)."""
    h, w = in_hw
    area = h * w * _uniform(g, B, *scale)
    r = torch.exp(_uniform(g, B, math.log(ratio[0]), math.log(ratio[1])))
    cw = torch.sqrt(area * r).clamp(1.0, w)
    ch = torch.sqrt(area / r).clamp(1.0, h)
    top = torch.rand(B, generator=g) * (h - ch)
    left = torch.rand(B, generator=g) * (w - cw)
    s = float(out_size)
    ar, ac = ch / s, cw / s
    return _scale_offset(ar, top + 0.5 * ar - 0.5, ac, left + 0.5 * ac - 0.5)


def shift_scale_rotate_matrix(g, B, hw, shift_limit=0.1, scale_limit=0.1,
                              rotate_limit=30.0, p=0.5) -> torch.Tensor:
    """Inverse affines of A.ShiftScaleRotate about the image centre."""
    h, w = hw
    apply = torch.rand(B, generator=g) < p
    ang = torch.deg2rad(_uniform(g, B, -rotate_limit, rotate_limit))
    sc = 1.0 + _uniform(g, B, -scale_limit, scale_limit)
    tr = _uniform(g, B, -shift_limit, shift_limit) * h
    tc = _uniform(g, B, -shift_limit, shift_limit) * w
    ang = torch.where(apply, ang, 0.0)
    sc = torch.where(apply, sc, 1.0)
    tr = torch.where(apply, tr, 0.0)
    tc = torch.where(apply, tc, 0.0)
    cr, cc = (h - 1) / 2.0, (w - 1) / 2.0
    cos, sin = torch.cos(ang), torch.sin(ang)
    # forward: p' = s R (p - c) + c + t  =>  inverse: p = R^T (p' - c - t) / s + c
    i00, i01, i10, i11 = cos / sc, sin / sc, -sin / sc, cos / sc
    b0 = cr - (i00 * (cr + tr) + i01 * (cc + tc))
    b1 = cc - (i10 * (cr + tr) + i11 * (cc + tc))
    z, o = torch.zeros_like(cos), torch.ones_like(cos)
    return torch.stack([torch.stack([i00, i01, b0], -1), torch.stack([i10, i11, b1], -1),
                        torch.stack([z, z, o], -1)], -2)


def flip_matrices(g, B, hw, p=0.5) -> torch.Tensor:
    h, w = hw
    hflip = torch.rand(B, generator=g) < p
    vflip = torch.rand(B, generator=g) < p
    one = torch.ones(B)
    return _scale_offset(torch.where(vflip, -one, one), torch.where(vflip, float(h - 1), 0.0),
                         torch.where(hflip, -one, one), torch.where(hflip, float(w - 1), 0.0))


def draw_params(generator: torch.Generator, B: int, in_hw, out_size: int) -> dict:
    """Every random parameter of ``B`` samples, drawn from ``generator`` (a
    CPU generator) as CPU tensors:

    * ``mat`` (B, 3, 3): the inverse affine RRC @ SSR @ flips, mapping output
      (row, col, 1) to input coordinates;
    * ``jitter`` (B,) bool and ``jitter_factors`` (B, 4): colour jitter's
      flag and its brightness, contrast, saturation and hue factors;
    * ``branch`` (B,) int64: the OneOf's branch, 0..8 (``BRANCHES``) with
      probability 0.4, else 9 (identity);
    * each branch's own: ``hsv`` (B, 3) hue/saturation/value shifts,
      ``perm`` (B, 3) channel order, ``rgb_shift`` (B, 3), ``sigma`` (B,)
      of the blur, ``clahe_clip`` (B,), ``elastic`` (B, 16, 16, 2) the
      coarse displacement field in [-1, 1), ``grid`` (B, 2, 6) the
      distortion's column and row stretches.

    Every sample draws every parameter, whatever its branch, so a sample's
    values depend only on the generator and B."""
    g = generator
    s = (out_size, out_size)
    mat = (random_resized_crop_matrix(g, B, in_hw, out_size)
           @ shift_scale_rotate_matrix(g, B, s) @ flip_matrices(g, B, s))
    jitter = torch.rand(B, generator=g) < 0.4
    jitter_factors = torch.stack([_uniform(g, B, 0.8, 1.2), _uniform(g, B, 0.8, 1.2),
                                  _uniform(g, B, 0.8, 1.2), _uniform(g, B, -0.2, 0.2)], -1)
    pick = torch.rand(B, generator=g) < ONE_OF_P
    op = torch.randint(0, len(BRANCHES), (B,), generator=g)
    branch = torch.where(pick, op, IDENTITY)
    hsv = torch.stack([_uniform(g, B, -20.0, 20.0) * 2.0, _uniform(g, B, -30.0, 30.0) / 255.0,
                       _uniform(g, B, -20.0, 20.0) / 255.0], -1)
    perm = torch.argsort(torch.rand(B, 3, generator=g), dim=-1)
    return {
        "mat": mat, "jitter": jitter, "jitter_factors": jitter_factors, "branch": branch,
        "hsv": hsv, "perm": perm, "rgb_shift": _uniform(g, (B, 3), -20.0, 20.0),
        "sigma": _uniform(g, B, 0.5, 2.0), "clahe_clip": _uniform(g, B, 1.0, 4.0),
        "elastic": _uniform(g, (B, ELASTIC_COARSE, ELASTIC_COARSE, 2), -1.0, 1.0),
        "grid": 1.0 + _uniform(g, (B, 2, GRID_STEPS + 1), -0.3, 0.3),
    }


# ---------------------------------------------------------------------------
# resampling
# ---------------------------------------------------------------------------


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    """``lax.round``: half away from zero (exact: x - trunc(x) is exact)."""
    t = torch.trunc(x)
    return t + torch.where((x - t).abs() >= 0.5, torch.sign(x), torch.zeros_like(x))


def _map_coordinates(img: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                     order: int) -> torch.Tensor:
    """``map_coordinates(img[n, ..., ch], [rows[n], cols[n]], order, cval=0)``
    for every sample n and channel: img (N, H, W, C) float32, rows and cols
    (N, h, w) float32 -> (N, h, w, C)."""
    N, H, W, C = img.shape
    flat = img.reshape(N * H * W, C)
    base = (torch.arange(N, device=img.device) * (H * W)).view(N, 1, 1)

    def tap(ri, ci):
        valid = (ri >= 0) & (ri < H) & (ci >= 0) & (ci < W)
        idx = base + ri.clamp(0, H - 1) * W + ci.clamp(0, W - 1)
        v = flat.index_select(0, idx.reshape(-1)).reshape(*rows.shape, C)
        return torch.where(valid[..., None], v, torch.zeros((), device=img.device))

    if order == 0:
        return tap(_round_half_away(rows).long(), _round_half_away(cols).long())
    r0, c0 = torch.floor(rows), torch.floor(cols)
    wr1, wc1 = rows - r0, cols - c0
    wr0, wc0 = 1 - wr1, 1 - wc1
    ri, ci = r0.long(), c0.long()
    out = (wr0 * wc0)[..., None] * tap(ri, ci) + (wr0 * wc1)[..., None] * tap(ri, ci + 1)
    out = out + (wr1 * wc0)[..., None] * tap(ri + 1, ci)
    return out + (wr1 * wc1)[..., None] * tap(ri + 1, ci + 1)


def _grid(h: int, w: int, device):
    rr = torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(h, w)
    cc = torch.arange(w, dtype=torch.float32, device=device)[None, :].expand(h, w)
    return rr, cc


def _warp(img: torch.Tensor, mat: torch.Tensor, out_hw, order: int) -> torch.Tensor:
    """Resample (N, H, W, C) ``img`` through the inverse affines ``mat``
    (N, 3, 3) onto an ``out_hw`` grid (JAX ``_warp``)."""
    rr, cc = _grid(*out_hw, img.device)
    m = mat[:, :2, :, None, None]
    rows = m[:, 0, 0] * rr + m[:, 0, 1] * cc + m[:, 0, 2]
    cols = m[:, 1, 0] * rr + m[:, 1, 1] * cc + m[:, 1, 2]
    return _map_coordinates(img, rows, cols, order)


def _displacement_warp(img: torch.Tensor, dr: torch.Tensor, dc: torch.Tensor,
                       order: int) -> torch.Tensor:
    """Resample (N, H, W, C) ``img`` at (row + dr, col + dc), dr and dc (N, H, W)."""
    rr, cc = _grid(img.shape[1], img.shape[2], img.device)
    return _map_coordinates(img, rr + dr, cc + dc, order)


def elastic_displacement(coarse: torch.Tensor, hw, alpha: float = 40.0):
    """ElasticTransform's field: the (N, 16, 16, 2) coarse field in [-1, 1)
    upsampled bilinearly (align_corners=False, the smoothing) to ``hw`` and
    scaled by ``alpha``. Returns (dr, dc), each (N, H, W)."""
    field = bilinear_resize(coarse, hw, align_corners=False) * alpha
    return field[..., 0], field[..., 1]


def grid_distortion_displacement(stretch: torch.Tensor, hw, num_steps: int = GRID_STEPS):
    """GridDistortion as a displacement field: ``stretch`` (N, 2, steps + 1)
    holds the column (0) and row (1) stretches of each grid cell. Returns
    (dr, dc), each (N, H, W)."""
    h, w = hw

    def axis_map(steps, size):
        seg = size / num_steps
        edges = [torch.zeros_like(steps[:, 0])]
        for i in range(num_steps):  # a running sum in JAX's order
            edges.append(edges[-1] + steps[:, i] * seg)
        edges = torch.stack(edges, -1)
        edges = edges / edges[:, -1:] * (size - 1)  # normalised to the full span
        t = torch.arange(size, dtype=torch.float32, device=steps.device) / (size - 1) * num_steps
        idx = t.to(torch.int64).clamp(0, num_steps - 1)
        frac = t - idx
        return edges[:, idx] * (1 - frac) + edges[:, idx + 1] * frac

    rr, cc = _grid(h, w, stretch.device)
    src_r = axis_map(stretch[:, 1], h)
    src_c = axis_map(stretch[:, 0], w)
    return src_r[:, :, None] - rr, src_c[:, None, :] - cc


# ---------------------------------------------------------------------------
# photometric ops on (N, H, W, 3) float32 RGB 0..255, parameters per sample
# ---------------------------------------------------------------------------


def _rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    r, g, b = img.unbind(-1)
    return r * 0.299 + g * 0.587 + b * 0.114


def _col(t: torch.Tensor) -> torch.Tensor:
    """(N,) per-sample values broadcast over (N, H, W, C)."""
    return t.view(-1, 1, 1, 1)


def _rgb_to_hsv(img: torch.Tensor) -> torch.Tensor:
    px = img / 255.0
    r, g, b = px.unbind(-1)
    mx, mn = px.amax(-1), px.amin(-1)
    d = mx - mn
    safe = torch.where(d == 0, 1.0, d)
    h = torch.where(
        d == 0, 0.0,
        torch.where(mx == r, torch.remainder((g - b) / safe, 6.0),
                    torch.where(mx == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0)),
    ) * 60.0
    s = torch.where(mx == 0, 0.0, d / torch.where(mx == 0, 1.0, mx))
    return torch.stack([h, s, mx], -1)


_HSV_TABLE = ((0, 1, 2), (1, 0, 2), (2, 0, 1), (2, 1, 0), (1, 2, 0), (0, 2, 1))


def _hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = torch.remainder(hsv[..., 0], 360.0), hsv[..., 1], hsv[..., 2]
    c = v * s
    x = c * (1 - torch.abs(torch.remainder(h / 60.0, 2.0) - 1))
    m = v - c
    idx = (h / 60.0).to(torch.int32).long() % 6  # truncates, as astype(int32)
    table = torch.tensor(_HSV_TABLE, device=hsv.device)
    vals = torch.stack([c, x, torch.zeros_like(c)], -1)
    return vals.gather(-1, table[idx]) + m[..., None]


def _shift_hue(img: torch.Tensor, degrees: torch.Tensor) -> torch.Tensor:
    hsv = _rgb_to_hsv(img)
    hsv = torch.stack([hsv[..., 0] + degrees.view(-1, 1, 1), hsv[..., 1], hsv[..., 2]], -1)
    return torch.clamp(_hsv_to_rgb(hsv) * 255.0, 0, 255)


def color_jitter(img: torch.Tensor, factors: torch.Tensor) -> torch.Tensor:
    """torchvision-style ColorJitter with per-sample (brightness, contrast,
    saturation, hue) ``factors`` (N, 4), in JAX's fixed order."""
    fb, fc, fs, fh = (_col(f) for f in factors.unbind(-1))
    x = torch.clamp(img * fb, 0, 255)
    mean_gray = _rgb_to_gray(x).mean(dim=(1, 2)).view(-1, 1, 1, 1)
    x = torch.clamp(fc * x + (1 - fc) * mean_gray, 0, 255)
    gray = _rgb_to_gray(x)[..., None]
    x = torch.clamp(fs * x + (1 - fs) * gray, 0, 255)
    return _shift_hue(x, fh.view(-1) * 360.0)


def hue_saturation_value(img: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """HueSaturationValue with per-sample (hue degrees, saturation, value)
    ``shifts`` (N, 3)."""
    dh, ds, dv = (t.view(-1, 1, 1) for t in shifts.unbind(-1))
    hsv = _rgb_to_hsv(img)
    hsv = torch.stack([hsv[..., 0] + dh, torch.clamp(hsv[..., 1] + ds, 0, 1),
                       torch.clamp(hsv[..., 2] + dv, 0, 1)], -1)
    return torch.clamp(_hsv_to_rgb(hsv) * 255.0, 0, 255)


def to_gray(img: torch.Tensor) -> torch.Tensor:
    return _rgb_to_gray(img)[..., None].expand(img.shape).contiguous()


def channel_shuffle(img: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    return img.gather(-1, perm.view(-1, 1, 1, 3).expand(img.shape))


def rgb_shift(img: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    return torch.clamp(img + shift.view(-1, 1, 1, 3), 0, 255)


def gaussian_blur(img: torch.Tensor, sigma: torch.Tensor, ksize: int = 5) -> torch.Tensor:
    """Separable Gaussian blur (rows, then columns) with per-sample
    ``sigma``, zero padding."""
    r = ksize // 2
    xs = torch.arange(-r, r + 1, dtype=torch.float32, device=img.device)
    t = xs / sigma[:, None]
    k = torch.exp(-0.5 * (t * t))
    k = k / k.sum(-1, keepdim=True)
    H, W = img.shape[1], img.shape[2]
    x = F.pad(img, (0, 0, 0, 0, r, r))
    out = sum(_col(k[:, j]) * x[:, j:j + H] for j in range(ksize))
    x = F.pad(out, (0, 0, r, r))
    return sum(_col(k[:, j]) * x[:, :, j:j + W] for j in range(ksize))


def grid_dropout(img: torch.Tensor, ratio: float = 0.5, grid: int = 8) -> torch.Tensor:
    h, w = img.shape[1], img.shape[2]
    ch, cw = max(h // grid, 1), max(w // grid, 1)
    hole_h, hole_w = max(int(ch * ratio), 1), max(int(cw * ratio), 1)
    rr = torch.arange(h, device=img.device) % ch
    cc = torch.arange(w, device=img.device) % cw
    hole = (rr[:, None] < hole_h) & (cc[None, :] < hole_w)
    return torch.where(hole[None, :, :, None], 0.0, img)


# cv2 LAB conventions (cvtColor COLOR_RGB2LAB on uint8): sRGB de-gamma,
# linear RGB -> XYZ (D65), CIE L*a*b*, then L*255/100, a+128, b+128
_LAB_RGB2XYZ = ((0.412453, 0.357580, 0.180423),
                (0.212671, 0.715160, 0.072169),
                (0.019334, 0.119193, 0.950227))
_LAB_XYZ2RGB = ((3.240479, -1.537150, -0.498535),
                (-0.969256, 1.875992, 0.041556),
                (0.055648, -0.204043, 1.057311))
_LAB_WHITE = (0.950456, 1.0, 1.088754)


def _mix3(c: torch.Tensor, m) -> list[torch.Tensor]:
    """The three rows of the 3x3 ``m`` applied to the last axis of ``c``."""
    c0, c1, c2 = c.unbind(-1)
    return [c0 * row[0] + c1 * row[1] + c2 * row[2] for row in m]


def _rgb_to_lab(img: torch.Tensor):
    """RGB (float 0..255) -> cv2 8-bit LAB channels (each float 0..255)."""
    c = img / 255.0
    c = torch.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)
    xyz = torch.stack([x / wt for x, wt in zip(_mix3(c, _LAB_RGB2XYZ), _LAB_WHITE)], -1)
    f = torch.where(xyz > 0.008856, torch.clamp(xyz, min=0.0) ** (1.0 / 3.0),
                    7.787 * xyz + 16.0 / 116.0)
    y = xyz[..., 1]
    lum = torch.where(y > 0.008856, 116.0 * f[..., 1] - 16.0, 903.3 * y)
    a = 500.0 * (f[..., 0] - f[..., 1]) + 128.0
    b = 200.0 * (f[..., 1] - f[..., 2]) + 128.0
    return lum * (255.0 / 100.0), a, b


def _lab_to_rgb(lum: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inverse of ``_rgb_to_lab`` (cv2 COLOR_LAB2RGB on uint8 LAB)."""
    lum = lum * (100.0 / 255.0)
    fy = (lum + 16.0) / 116.0
    fx = fy + (a - 128.0) / 500.0
    fz = fy - (b - 128.0) / 200.0

    def f_inv(t):
        t3 = t * t * t
        return torch.where(t3 > 0.008856, t3, (t - 16.0 / 116.0) / 7.787)

    y = torch.where(lum > 903.3 * 0.008856, fy * fy * fy, lum / 903.3)
    xyz = torch.stack([f_inv(fx) * _LAB_WHITE[0], y * _LAB_WHITE[1],
                       f_inv(fz) * _LAB_WHITE[2]], -1)
    c = torch.clamp(torch.stack(_mix3(xyz, _LAB_XYZ2RGB), -1), min=0.0)
    c = torch.where(c <= 0.0031308, 12.92 * c, 1.055 * c ** (1.0 / 2.4) - 0.055)
    return torch.clamp(c * 255.0, 0.0, 255.0)


def _clahe_lum(lum: torch.Tensor, clip_limit: torch.Tensor, grid: int = 8,
               bins: int = 256) -> torch.Tensor:
    """cv2's CLAHE tile-LUT equalization on (N, H, W) luminance planes with a
    per-plane ``clip_limit`` (N,) (JAX ``_clahe_lum``, cv2-exact up to the
    final uint8 round)."""
    N, h, w = lum.shape
    th, tw = -(-h // grid), -(-w // grid)
    ph, pw = th * grid - h, tw * grid - w
    lum_p = F.pad(lum[:, None], (0, pw, 0, ph), mode="reflect")[:, 0] if ph or pw else lum
    q = torch.round(lum_p).clamp(0, bins - 1).long()
    tiles = q.reshape(N, grid, th, grid, tw).permute(0, 1, 3, 2, 4).reshape(N * grid * grid, -1)
    hist = torch.zeros(N * grid * grid, bins, dtype=torch.float32, device=lum.device)
    hist.scatter_add_(1, tiles, torch.ones_like(tiles, dtype=torch.float32))
    npix = th * tw
    # cv2: clip = max(int(clipLimit * tileSize / histSize), 1)
    clip = (clip_limit.to(torch.float32) * npix / bins).to(torch.int32).clamp(min=1)
    clip = clip.to(torch.float32).repeat_interleave(grid * grid)[:, None]
    excess = torch.clamp(hist - clip, min=0).sum(1).to(torch.int64)
    hist = torch.minimum(hist, clip)
    # cv2's redistribution: +excess//bins everywhere, then +1 on bins
    # 0, step, 2*step, ... (step = max(bins//residual, 1)), residual times
    batch = excess // bins
    resid = excess - batch * bins
    step = (bins // resid.clamp(min=1)).clamp(min=1)
    idx = torch.arange(bins, device=lum.device)
    inc = ((idx[None, :] % step[:, None]) == 0) & ((idx[None, :] // step[:, None]) < resid[:, None])
    hist = hist + batch[:, None].to(torch.float32) + inc.to(torch.float32)
    luts = torch.round(torch.cumsum(hist, 1) * ((bins - 1.0) / npix)).reshape(-1)

    # bilinear interpolation between the 4 neighbouring tile LUTs
    rr = torch.arange(h, dtype=torch.float32, device=lum.device) / th - 0.5
    cc = torch.arange(w, dtype=torch.float32, device=lum.device) / tw - 0.5
    r0 = torch.floor(rr).clamp(0, grid - 1).long()
    c0 = torch.floor(cc).clamp(0, grid - 1).long()
    r1, c1 = (r0 + 1).clamp(0, grid - 1), (c0 + 1).clamp(0, grid - 1)
    fr = torch.clamp(rr - r0, 0, 1)[:, None]
    fc = torch.clamp(cc - c0, 0, 1)[None, :]
    q_crop = q[:, :h, :w]
    base = (torch.arange(N, device=lum.device) * (grid * grid)).view(N, 1, 1)

    def lut_at(ri, ci):
        tile = base + (ri[:, None] * grid + ci[None, :])
        return luts[tile * bins + q_crop]

    return (lut_at(r0, c0) * (1 - fr) * (1 - fc) + lut_at(r0, c1) * (1 - fr) * fc
            + lut_at(r1, c0) * fr * (1 - fc) + lut_at(r1, c1) * fr * fc)


def clahe(img: torch.Tensor, clip_limit: torch.Tensor) -> torch.Tensor:
    """CLAHE(clip_limit, 8x8) on the L of cv2's LAB, a and b untouched."""
    lum, a, b = _rgb_to_lab(img)
    return _lab_to_rgb(_clahe_lum(lum, clip_limit), a, b)


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------


# the parameter each branch reads, by branch name
_BRANCH_PARAM = {"grid": "grid", "elastic": "elastic", "clahe": "clahe_clip", "hsv": "hsv",
                 "shuffle": "perm", "rgbshift": "rgb_shift", "blur": "sigma"}


def _branch_op(name: str, img: torch.Tensor, param: torch.Tensor | None) -> torch.Tensor:
    """A colour branch of the OneOf on the samples that drew it."""
    return {
        "gray": lambda: to_gray(img),
        "clahe": lambda: clahe(img, param),
        "hsv": lambda: hue_saturation_value(img, param),
        "shuffle": lambda: channel_shuffle(img, param),
        "dropout": lambda: grid_dropout(img),
        "rgbshift": lambda: rgb_shift(img, param),
        "blur": lambda: gaussian_blur(img, param),
    }[name]()


def apply_params(images: torch.Tensor, masks: torch.Tensor, params: dict, out_size: int):
    """The train augmentation of ``draw_params``' ``params`` on (B, H, W, 3)
    images (uint8 or float 0..255) and (B, H, W) integer masks, on their
    device. Returns (normalised float32 images (B, S, S, 3), int64 masks
    (B, S, S))."""
    dev = images.device
    p = {k: v.to(dev, non_blocking=True) for k, v in params.items()
         if k not in ("jitter", "branch")}  # the grouping reads these on the host
    S = (out_size, out_size)
    img = _warp(images.to(torch.float32), p["mat"], S, 1)
    mask = _warp(masks.to(torch.float32)[..., None], p["mat"], S, 0)

    def select(flags: torch.Tensor):
        """The device indices of the samples where the CPU ``flags`` hold,
        or None; the grouping needs no read from the device."""
        idx = flags.nonzero().flatten()
        return idx.to(dev, non_blocking=True) if len(idx) else None

    idx = select(params["jitter"])
    if idx is not None:
        img.index_copy_(0, idx, color_jitter(img.index_select(0, idx),
                                             p["jitter_factors"].index_select(0, idx)))
    for k, name in enumerate(BRANCHES):
        idx = select(params["branch"] == k)
        if idx is None:
            continue
        key = _BRANCH_PARAM.get(name)
        param = p[key].index_select(0, idx) if key else None
        sub = img.index_select(0, idx)
        if name in ("grid", "elastic"):  # a displacement warp of image and mask
            make = grid_distortion_displacement if name == "grid" else elastic_displacement
            dr, dc = make(param, S)
            img.index_copy_(0, idx, _displacement_warp(sub, dr, dc, 1))
            mask.index_copy_(0, idx, _displacement_warp(mask.index_select(0, idx), dr, dc, 0))
        else:
            img.index_copy_(0, idx, _branch_op(name, sub, param))
    return normalize(img), mask[..., 0].to(torch.int64)


def train_pipeline(generator: torch.Generator, images: torch.Tensor, masks: torch.Tensor,
                   out_size: int = 256):
    """Batched train-time augmentation: ``draw_params`` from ``generator``
    (CPU), then ``apply_params`` on the images' device.

    Args:
      generator: CPU ``torch.Generator`` for the batch.
      images: (B, H, W, 3) uint8/float host-decoded images (RGB, 0..255).
      masks: (B, H, W) integer labels.
      out_size: output spatial size.

    Returns (images (B, S, S, 3) float32 normalised, masks (B, S, S) int64).
    """
    params = draw_params(generator, images.shape[0], tuple(images.shape[1:3]), out_size)
    return apply_params(images, masks, params, out_size)

"""What a run feeds both sides, made from ``--seed``: the raw weights of the
model's state dict, images and their label maps (blob masks for two
classes, bands of a smooth field for more).

Everything is drawn on the run's device by a ``torch.Generator`` there, in
a few large calls, so that set-up stays short and the same seed gives the
same tensors.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

ROLES = ("weights", "data", "dropout", "sample", "traffic")

# (low, high) of each kind of entry (an architecture's ``param_specs``); a
# conv or linear weight and its bias take +-1/sqrt(fan_in) (torch's
# family), the SE convs +-sqrt(6/fan_in) (kaiming's range), the attention
# linears a std of 0.02; BatchNorm and LayerNorm affines, running
# statistics and the NAT bias are drawn too, so every term of the graph
# reaches the output
_RANGES = {
    "bn_w": (0.5, 1.5), "bn_b": (-0.2, 0.2), "bn_mean": (-0.2, 0.2), "bn_var": (0.5, 1.5),
    "ln_w": (0.5, 1.5), "ln_b": (-0.2, 0.2), "rpb": (-0.5, 0.5),
    "w_att": (-0.035, 0.035), "b_att": (-0.035, 0.035),
}


def seeds(seed: int) -> dict[str, int]:
    """Independent 63-bit seeds for each role, from the run's ``seed``."""
    state = np.random.SeedSequence(int(seed)).generate_state(len(ROLES), dtype=np.uint64)
    return {role: int(s) >> 1 for role, s in zip(ROLES, state)}


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(int(seed))


def weights(specs, seed: int, device) -> dict[str, torch.Tensor]:
    """float32 state dict of ``specs`` ((name, shape, kind, fan_in), as an
    architecture's ``param_specs`` gives them): one uniform draw for all
    entries, scaled into each entry's range; the entries are views of one
    buffer."""
    lo, hi, sizes = [], [], []
    for _, shape, kind, fan in specs:
        if kind in _RANGES:
            a, b = _RANGES[kind]
        else:
            bound = (6.0 / fan) ** 0.5 if kind == "w_se" else fan ** -0.5
            a, b = -bound, bound
        lo.append(a)
        hi.append(b)
        sizes.append(int(np.prod(shape)))
    dev = torch.device(device)
    counts = torch.tensor(sizes, device=dev)
    low = torch.repeat_interleave(torch.tensor(lo, device=dev), counts)
    span = torch.repeat_interleave(torch.tensor(hi, device=dev), counts) - low
    flat = torch.rand(sum(sizes), generator=generator(seed, dev), device=dev) * span + low
    return {name: t.view(shape)
            for (name, shape, _, _), t in zip(specs, torch.split(flat, sizes))}


def _fields(n: int, channels: int, size: int, g: torch.Generator, device) -> torch.Tensor:
    """n smooth random fields in [0, 1], (n, channels, size, size): an 8x8
    uniform grid upsampled bilinearly."""
    low = torch.rand((n, channels, 8, 8), generator=g, device=device)
    return F.interpolate(low, size=(size, size), mode="bilinear", align_corners=False)


def _bands(field: torch.Tensor, classes: int) -> torch.Tensor:
    """Label maps of ``classes`` classes from smooth fields (n, H, W): class
    k where the field lies between the batch's k/classes and
    (k+1)/classes quantiles, so that every class covers about as many of
    the batch's pixels and occurs in it."""
    flat = field.flatten().sort().values
    cuts = flat[torch.arange(1, classes, device=field.device) * flat.numel() // classes]
    return torch.bucketize(field, cuts, right=True).to(torch.int32)


def images_and_masks(n: int, size: int, g: torch.Generator, device,
                     dtype=torch.float32, classes: int = 2) -> tuple[torch.Tensor, torch.Tensor]:
    """n distinct normalised NHWC images and their (n, size, size) int32
    label maps. Two classes: blob masks, a smooth field thresholded at a
    level drawn per image (0.35 to 0.75, so the foreground share varies);
    more: the field cut into ``classes`` bands at the batch's quantiles
    (``_bands``). The images are a smooth colour field plus the label
    (scaled to 0 .. 0.5) and pixel noise, each normalised to mean 0 and
    std 1."""
    mask_field = _fields(n, 1, size, g, device)[:, 0]
    if classes == 2:
        level = 0.35 + 0.4 * torch.rand((n, 1, 1), generator=g, device=device)
        masks = (mask_field > level).to(torch.int32)
    else:
        masks = _bands(mask_field, classes)
    img = _fields(n, 3, size, g, device) + 0.5 / (classes - 1) * masks[:, None].float()
    img = img + 0.1 * torch.randn((n, 3, size, size), generator=g, device=device)
    img = (img - img.mean(dim=(1, 2, 3), keepdim=True)) / img.std(dim=(1, 2, 3), keepdim=True)
    return img.permute(0, 2, 3, 1).contiguous().to(dtype), masks


def pool(batches: int, batch: int, size: int, seed: int, device, dtype, classes: int = 2):
    """``batches`` batches of ``batch`` distinct images and label maps of
    ``classes`` classes, one draw at a time, so that a large pool never
    holds a float32 copy whole."""
    g = generator(seed, device)
    out = [images_and_masks(batch, size, g, device, dtype, classes) for _ in range(batches)]
    return [x for x, _ in out], [y for _, y in out]

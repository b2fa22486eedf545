"""The comparisons that decide ``correct``: what the timed path produced
against the plain reference of the configuration's architecture
(``reference/<arch>.py``), run once the window has closed; and the
rounding the controls put the reference in (``fp8_round``).

Serving: the worst image's relative RMS distance of the served logits from
the reference's (``logit_err``). Masks: the widest gap by which the
reference's logit of a served pixel's class lies below its best, as a
share of the RMS of the reference's margin between the classes
(``mask_gap``). Training: per step the loss's relative gap; per leaf the
gap between the program's norm and the reference's of the first gradient,
of the parameters' change after the checked steps and of the running
statistics' change, each against the larger of that leaf's reference norm
and the median leaf's (``train_numbers``).
"""

from __future__ import annotations

import contextlib

import torch

from reference.train import is_param

FP8_MAX = 448.0  # largest finite float8 e4m3


@contextlib.contextmanager
def exact_fp32():
    """float32 matrix products and convolutions without TF32 inside the
    block (the reference's precision); the flags are restored after."""
    mm, cd = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = mm, cd


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale for the tensor (its
    absolute maximum at 448), back in t's dtype; the gradient passes
    through unrounded."""
    with torch.no_grad():
        s = t.detach().abs().amax().float().clamp_min(1e-30) / FP8_MAX
        r = ((t.detach() / s).to(torch.float8_e4m3fn).to(t.dtype) * s).to(t.dtype)
    return t + (r - t).detach()


CHUNK = 8  # images a reference forward: a 512^2 float32 chunk stays under ~10 GiB


def reference_logits(model, images: torch.Tensor) -> torch.Tensor:
    """The reference's float32 logits of ``images``, CHUNK at a time."""
    out = []
    with torch.no_grad(), exact_fp32():
        for i in range(0, images.shape[0], CHUNK):
            out.append(model.forward(images[i:i + CHUNK].float()))
    return torch.cat(out)


def logit_err(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """Worst image's ||prog - ref|| / ||ref|| over the leading axis."""
    d = (prog.float() - ref).flatten(1).norm(dim=1)
    return float((d / ref.flatten(1).norm(dim=1).clamp_min(1e-30)).max())


def margin_rms(ref: torch.Tensor) -> float:
    """RMS of the reference's logit margin between the best and the second
    class, over every pixel."""
    top = ref.topk(2, dim=-1).values
    return float((top[..., 0] - top[..., 1]).square().mean().sqrt())


def mask_gap(masks: torch.Tensor, ref: torch.Tensor, scale: float) -> float:
    """Widest gap ref[best] - ref[served class] over the pixels of
    ``masks`` (n, H, W) against reference logits ``ref`` (n, H, W, C), as a
    share of ``scale``."""
    served = ref.gather(-1, masks.long().to(ref.device)[..., None])[..., 0]
    return float((ref.amax(dim=-1) - served).max()) / scale


def leaves(tensors: dict) -> dict:
    """The compared leaves: each entry, with a fused q/k/v linear's weight
    and bias split into its three parts (a key's bias has no gradient under
    softmax, so it is a leaf of its own)."""
    out = {}
    for k, v in tensors.items():
        if ".qkv." in k:
            for part, t in zip("qkv", v.float().chunk(3, dim=0)):
                out[f"{k}[{part}]"] = t
        else:
            out[k] = v.float()
    return out


def norm_gaps(prog: dict, ref: dict, names) -> dict[str, float]:
    """Per leaf of ``names``: | ||prog|| - ||ref|| | / max(||ref||, the
    median leaf's ||ref||)."""
    rn = {k: float(ref[k].norm()) for k in names}
    med = float(torch.tensor(list(rn.values())).median())
    return {k: abs(float(prog[k].norm()) - rn[k]) / max(rn[k], med, 1e-30) for k in names}


def worst(gaps: dict) -> tuple[float, str]:
    k = max(gaps, key=gaps.get)
    return gaps[k], k


def median(gaps: dict) -> tuple[float, str]:
    v = sorted(gaps.values())
    return v[(len(v) - 1) // 2], f"median of {len(v)} leaves"


def train_numbers(p0: dict, prog: dict, ref: dict) -> dict:
    """The training comparison. Each of ``prog`` and ``ref`` holds 'losses'
    (the checked steps'), 'grad1' (the first gradient by parameter) and
    'state' (parameters and running statistics after the checked steps);
    ``p0`` the state before; ``reference.train.is_param`` tells a trained
    leaf from a running statistic. Leaves whose first reference gradient is under
    a thousandth of the median leaf's (a bias before a BatchNorm, a key's
    bias: nought but for round-off) are left out of the first gradient and
    of the change.

    Compared: 'loss' (the worst step's relative gap), 'grad1' and 'change'
    (the median leaf's gap: the worst leaf's is the noise of a leaf whose
    gradient nearly cancels, which bf16 reads at a tenth or more of the
    median leaf's on every seed; 'grad1_worst' and 'change_worst' keep it,
    readings that are not compared) and 'bn_stats' (the worst running
    statistic's). Returns name -> (value, worst leaf or step)."""
    out = {}
    gaps = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    step = max(range(len(gaps)), key=gaps.__getitem__)
    out["loss"] = (gaps[step], f"step {step + 1}")
    g_p, g_r = leaves(prog["grad1"]), leaves(ref["grad1"])
    gn = {k: float(v.norm()) for k, v in g_r.items()}
    med = float(torch.tensor(list(gn.values())).median())
    moved = [k for k in g_r if gn[k] >= 1e-3 * med]
    grad = norm_gaps(g_p, g_r, moved)
    out["grad1"], out["grad1_worst"] = median(grad), worst(grad)
    d0 = leaves(p0)
    d_p = {k: v - d0[k] for k, v in leaves(prog["state"]).items()}
    d_r = {k: v - d0[k] for k, v in leaves(ref["state"]).items()}
    change = norm_gaps(d_p, d_r, moved)
    out["change"], out["change_worst"] = median(change), worst(change)
    out["bn_stats"] = worst(norm_gaps(d_p, d_r, [k for k in d_r if not is_param(k)]))
    out["_left_out"] = (float(len(g_r) - len(moved)), ",".join(sorted(set(g_r) - set(moved))))
    return out

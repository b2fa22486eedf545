"""The yardstick's arithmetic: the card's peaks, the model's operations a
image, and the NAT kernels' least bytes and operations.

The peaks are NVIDIA's data sheet for the H100 SXM (dense, 700 W). The
model's operations are counted by the configuration's architecture
(``arch/<arch>.py``: ``forward_flops``) on its plain reference, with
``counted_flops`` (``torch.utils.flop_counter`` on meta tensors: 2 a
multiply-add, every conv and matrix product) plus what that counter does
not see, so the count does not depend on what implements the model. The
NAT bounds (the kernel-3 NAT of four stages that ``nat_stages`` lists)
count each input byte read once and each output byte written once.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

HBM_RATE = 3.35e12  # bytes/s
F32_RATE = 67e12  # float32 operations/s outside the tensor cores
TC_RATE = 989e12  # bf16 operations/s on the tensor cores, dense


def nat_stages(size: int, filters) -> list[tuple[int, int, int]]:
    """(H, W, C) of the four NAT blocks at ``size``^2 inputs: natt1 on the
    1/8 map with filters[3] channels, ..., natt4 on the full map with
    filters[0]."""
    f = tuple(filters)
    return [(size // s, size // s, c) for s, c in ((8, f[3]), (4, f[2]), (2, f[1]), (1, f[0]))]


def nat_flops_per_image(size: int, filters) -> float:
    """NAT's multiply-adds a image, x2: for every element of q the 9 logit
    and 9 weighted-sum products."""
    return sum(2 * 18 * h * w * c for h, w, c in nat_stages(size, filters))


def counted_flops(fn) -> float:
    """The operations of the convs and matrix products that ``fn()`` runs
    (on meta tensors: nothing is computed), 2 a multiply-add."""
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        fn()
    return float(counter.get_total_flops())


def model_flops(config: dict, train: bool) -> float:
    """Operations of one image's forward: the deploy graph (``train``
    False) or the train-mode graph, as the configuration's architecture
    counts them."""
    import arch

    return arch.load(config).forward_flops(config, train)


def nat_fwd_bound_s(batch: int, size: int, filters, heads: int, elem_bytes: int) -> float:
    """Least seconds of one forward's four B1 calls: q, k, v in and the
    output once at HBM_RATE, or its float32 operations (9 logit and 9
    weighted-sum multiply-adds an element, ~36 softmax operations a pixel
    and head) at F32_RATE, whichever is longer."""
    n = sum(batch * h * w * c for h, w, c in nat_stages(size, filters))
    pix = sum(batch * h * w for h, w, _ in nat_stages(size, filters))
    return max(4 * n * elem_bytes / HBM_RATE, (36 * n + 36 * pix * heads) / F32_RATE)


def nat_bwd_bound_s(batch: int, size: int, filters, heads: int, elem_bytes: int) -> float:
    """Least seconds of one step's four B2 calls: q, k, v and the output's
    gradient in, dq, dk, dv out once, or the float32 operations (90 an
    element, ~50 a pixel and head), whichever is longer."""
    n = sum(batch * h * w * c for h, w, c in nat_stages(size, filters))
    pix = sum(batch * h * w for h, w, _ in nat_stages(size, filters))
    return max(7 * n * elem_bytes / HBM_RATE, (90 * n + 50 * pix * heads) / F32_RATE)

#!/usr/bin/env python3
"""Times the two ReparamConv serving kernels, B4 (rc_fused) and B5
(rc_dw_gelu), at the five block shapes of a 256^2, B=16 LM-Net forward on
one CUDA card, three ways: eagerly (CUDA events over back-to-back calls, as
chip_smoke.py times them), replayed as a CUDA graph (no host work), and
per CUDA kernel under torch.profiler. Random bf16 inputs and weights from a
seed; each kernel is held against its plain version first.

Run from the repository root: ``python3 rc_kernel_times.py``. It exits 1
without a card.
"""

from __future__ import annotations

import sys

import torch

import chip_smoke as cs

# (H, Cin, E, Cout, blocks of the served forward with this shape)
SHAPES = [(256, 3, 24, 12, 1), (256, 12, 24, 12, 3), (128, 24, 48, 24, 4),
          (64, 48, 96, 48, 4), (32, 96, 192, 96, 4)]


def device_us(fn, calls=5):
    """Device microseconds per call of ``fn`` by CUDA kernel name."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        dt = getattr(ev, "device_time_total", 0) or getattr(ev, "cuda_time_total", 0)
        if dt:
            out[ev.key[:60]] = dt / calls
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def main() -> int:
    if not torch.cuda.is_available():
        print("rc_kernel_times: no CUDA device", file=sys.stderr)
        return 1
    from lmnet_tpu_torch.ops.rc_flat import dw_gelu_flat, dw_gelu_flat_plain
    from lmnet_tpu_torch.ops.rc_kernel import fused_reparam_conv, fused_reparam_conv_plain

    card = cs.card()
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    total = {}
    for H, Cin, E, Cout, n in SHAPES:
        w = cs.rc_weights(H + Cin, Cin, E, Cout, dev)
        x = torch.randn(16, H, H, Cin, generator=g).to(dev, torch.bfloat16)
        cs.check_rc("rc_kernel_times", x, w, fused_reparam_conv(x, w))
        e = torch.randn(16, H, H * E, generator=g).to(dev, torch.bfloat16)
        k = (torch.randn(E, 1, 5, 5, generator=g) * 0.2).to(dev)
        b = (torch.randn(E, generator=g) * 0.1).to(dev)
        cs.check_dw("rc_kernel_times", e, k, b, *dw_gelu_flat(e, k, b, E), E)
        b4, b5 = (lambda: fused_reparam_conv(x, w)), (lambda: dw_gelu_flat(e, k, b, E))
        ms = {"B4": cs.cuda_ms(b4), "B4 graph": cs.graph_ms(b4),
              "B4 plain": cs.cuda_ms(lambda: fused_reparam_conv_plain(x, w)),
              "B5": cs.cuda_ms(b5), "B5 graph": cs.graph_ms(b5),
              "B5 plain": cs.cuda_ms(lambda: dw_gelu_flat_plain(e, k, b, E))}
        print(f"{H}^2 Cin={Cin} E={E} Cout={Cout} B=16 bf16, ms a call: "
              + ", ".join(f"{kk} {v:.4f}" for kk, v in ms.items()) + f" [{card}]")
        for name, fn in (("B4", b4), ("B5", b5)):
            print(f"   {name} device us a call by kernel: "
                  + "; ".join(f"{kk} {v:.1f}" for kk, v in list(device_us(fn).items())[:6]))
        for kk, v in ms.items():
            total[kk] = total.get(kk, 0.0) + n * v
    print("the 16 blocks of a served forward, ms: "
          + ", ".join(f"{kk} {v:.4f}" for kk, v in total.items()) + f" [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())

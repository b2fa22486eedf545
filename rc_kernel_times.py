#!/usr/bin/env python3
"""Times the ReparamConv kernels on one CUDA card: B4 (rc_fused) and B5
(rc_dw_gelu) at the five block shapes of a 256^2, B=16 LM-Net forward, and
B6 (rc_stats) at the four block shapes of a 256^2, B=16 training forward
(``chip_smoke.B6_BLOCKS``). Each three ways: eagerly (CUDA events over
back-to-back calls, as chip_smoke.py times them), replayed as a CUDA graph
(no host work), and per CUDA kernel under torch.profiler. Beside B6: its
plain version, the stock bf16 composition that 'xla' training runs for the
same statistics (``chip_smoke.stats_stock``), and its bound (96 float32
operations an element at 67 TFLOP/s; e's bytes at 3.35 TB/s). Random bf16
inputs and weights from a seed; each kernel is held against its plain
version first.

``--kernels steps`` instead profiles whole 256^2, B=16 bf16 training steps
(``rc_remat=True``, ``rc_train_backend='fused'``, flat NAT; chip_smoke.py
phase 12's model and batch) and prints the device ms a step of B6, B5 and
their partials' reductions (``chip_smoke.rc_step_ms``) and the device busy
ms a step: the measure in which B6's redesign shows on the training path.
``--kernels options`` times a 256^2, B=16 bf16 training step under each of
phase 18's model options (``chip_smoke.OPTIONS``: the default, ``rc_remat``
False and 'branches', 'branches' with 'fused', ``natt_remat``) in three
turns, with peak device memory, then profiles two steps of each (device
kernels and device busy ms a step).

Run from the repository root: ``python3 rc_kernel_times.py``.
``--kernels B6`` times only the kernels named (comma-separated; default
B4,B5,B6). With ``--tree DIR`` it times the kernels of the
``lmnet_tpu_torch`` package under DIR instead (an unpacked earlier commit,
for a comparison in one call). It exits 1 without a card. The last line is
one JSON object with the per-shape times.
"""

from __future__ import annotations

import argparse
import json
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


def time_served(dev, card, rows) -> dict:
    """B4 and B5 at the served block shapes; their sums over the 16 blocks."""
    from lmnet_tpu_torch.ops.rc_flat import dw_gelu_flat, dw_gelu_flat_plain
    from lmnet_tpu_torch.ops.rc_kernel import fused_reparam_conv, fused_reparam_conv_plain

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
        rows.append({"H": H, "Cin": Cin, "E": E, "Cout": Cout, "blocks": n, **ms})
        for kk, v in ms.items():
            total[kk] = total.get(kk, 0.0) + n * v
    print("the 16 blocks of a served forward, ms: "
          + ", ".join(f"{kk} {v:.4f}" for kk, v in total.items()) + f" [{card}]")
    return total


def time_b6(dev, card, rows) -> dict:
    """B6 at the training forward's block shapes; sums over its 16 blocks."""
    from lmnet_tpu_torch.ops.rc_train import rc_branch_stats, rc_branch_stats_plain

    total = {}
    for i, (H, E, n) in enumerate(cs.B6_BLOCKS):
        e, ks = cs.branch_inputs(cs.BATCH, H, H, E, torch.bfloat16, 900 + i, dev)
        cs.check_stats("rc_kernel_times", e, ks, rc_branch_stats(e, *ks, E), E)
        fn = lambda: rc_branch_stats(e, *ks, E)  # noqa: E731
        stock = lambda: cs.stats_stock(e, ks, E)  # noqa: E731
        with torch.no_grad():
            ms = {"B6": cs.cuda_ms(fn), "B6 graph": cs.graph_ms(fn),
                  "B6 plain": cs.cuda_ms(lambda: rc_branch_stats_plain(e, *ks, E), iters=5),
                  "B6 stock": cs.cuda_ms(stock), "B6 stock graph": cs.graph_ms(stock)}
        flops, nbytes = 96 * e.numel(), e.numel() * e.element_size()
        bound = max(flops / cs.F32_RATE, nbytes / cs.HBM_RATE) * 1e3
        print(f"B6 {H}^2 E={E} B={cs.BATCH} bf16, ms a call: "
              + ", ".join(f"{kk} {v:.4f}" for kk, v in ms.items())
              + f"; bound {bound:.4f} ms (operations), {flops / ms['B6'] / 1e9:.2f} TFLOP/s "
              f"eager, {flops / ms['B6 graph'] / 1e9:.2f} as a graph, "
              f"{nbytes / ms['B6'] / 1e6:.1f} GB/s eager [{card}]")
        with torch.no_grad():
            us = device_us(fn)
        print("   B6 device us a call by kernel: "
              + "; ".join(f"{kk} {v:.1f}" for kk, v in list(us.items())[:4]))
        rows.append({"H": H, "E": E, "blocks": n, "bound_ms": bound, **ms})
        for kk, v in (*ms.items(), ("B6 bound", bound)):
            total[kk] = total.get(kk, 0.0) + n * v
        del e, ks
    print("the 16 blocks of a training forward, ms: "
          + ", ".join(f"{kk} {v:.4f}" for kk, v in total.items()) + f" [{card}]")
    return total


def time_steps(dev, card, rows, turns=2, steps=2) -> dict:
    """'fused' training steps under torch.profiler, ``turns`` times
    ``steps`` after four warm-up steps; the mean per-step device ms of
    B5, B6 and their reductions over the turns."""
    from lmnet_tpu_torch.ops import _build
    from lmnet_tpu_torch.train import create_train_state

    _build.build("rc_stats", "rc_dw_gelu", "nat_fwd", "nat_bwd")
    state = create_train_state(cs._train_model(dev, rc_train_backend="fused", seed=4),
                               (cs.BATCH, cs.IMG, cs.IMG, 3), seed=0)
    x, y = cs._batch(cs.BATCH, cs.IMG, "val", 7, dev)
    cs._time_steps(state, x, y, 1)
    total = {}
    for turn in range(turns):
        state, kernels, busy_ms, wall_ms, _ = cs._profile_steps(state, x, y, steps)
        rc = {**cs.rc_step_ms(kernels, steps), "busy": busy_ms / steps,
              "kernels": len(kernels) / steps}
        print(f"profiled {steps} train steps {cs.IMG}^2 B={cs.BATCH} bf16 rc_remat fused, turn "
              f"{turn}: device ms a step: B5 + B6 and their reductions {rc['sum']:.4f} (B6 "
              f"{rc['B6']:.4f}, B5 {rc['B5']:.4f}, reductions {rc['reductions']:.4f}); device "
              f"busy {rc['busy']:.3f} of {wall_ms / steps:.3f} ms profiled wall, "
              f"{rc['kernels']:.0f} device kernels [{card}]")
        rows.append({"steps": steps, "turn": turn, **rc})
        for k, v in rc.items():
            total[f"step {k}"] = total.get(f"step {k}", 0.0) + v / turns
    return total


def time_options(dev, card, rows, turns=3, steps=5) -> dict:
    """ms a train step (CUDA events over ``steps`` steps, after one) of
    each model option in ``turns`` turns, alternating the order, peak
    device memory, then two profiled steps each."""
    from lmnet_tpu_torch.metrics import ConfusionAccumulator
    from lmnet_tpu_torch.ops import _build
    from lmnet_tpu_torch.train import create_train_state, train_step

    _build.build("rc_stats", "rc_dw_gelu", "nat_fwd", "nat_bwd")
    x, y = cs._batch(cs.BATCH, cs.IMG, "val", 7, dev)
    states = {n: create_train_state(cs._option_models(dev, torch.bfloat16, 4, (n,))[n],
                                    (cs.BATCH, cs.IMG, cs.IMG, 3), seed=0) for n in cs.OPTIONS}
    cm = ConfusionAccumulator.init(2, dev)
    ms = {n: [] for n in cs.OPTIONS}
    peak = {}
    for turn in range(turns):
        for n in (cs.OPTIONS if turn % 2 == 0 else reversed(cs.OPTIONS)):
            train_step(states[n], x, y, cm)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(steps):
                train_step(states[n], x, y, cm)
            end.record()
            end.synchronize()
            ms[n].append(start.elapsed_time(end) / steps)
            peak[n] = torch.cuda.max_memory_allocated() / 2**30
    total = {}
    for n in cs.OPTIONS:
        _, kernels, busy_ms, wall_ms, _ = cs._profile_steps(states[n], x, y, 2)
        row = {"option": n, "ms": ms[n], "peak_gib": peak[n], "kernels": len(kernels) / 2,
               "busy": busy_ms / 2, "profiled_wall": wall_ms / 2}
        print(f"train_step {cs.IMG}^2 B={cs.BATCH} bf16 {n}: "
              f"{', '.join(f'{t:.2f}' for t in ms[n])} ms a step in turns, peak "
              f"{peak[n]:.2f} GiB; profiled: {row['kernels']:.0f} device kernels, device busy "
              f"{row['busy']:.2f} of {row['profiled_wall']:.2f} ms a step [{card}]")
        rows.append(row)
        total[f"{n} ms"] = sum(ms[n]) / turns
    return total


def main() -> int:
    args = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    args.add_argument("--tree", help="time the lmnet_tpu_torch package under this directory")
    args.add_argument("--kernels", default="B4,B5,B6",
                      help="comma-separated: B4, B5, B6, steps, options")
    opts = args.parse_args()
    if opts.tree:
        sys.path.insert(0, opts.tree)
    if not torch.cuda.is_available():
        print("rc_kernel_times: no CUDA device", file=sys.stderr)
        return 1
    kernels = set(opts.kernels.split(","))
    card = cs.card()
    dev = torch.device("cuda")
    rows, total = [], {}
    if kernels & {"B4", "B5"}:
        total.update(time_served(dev, card, rows))
    if "B6" in kernels:
        total.update(time_b6(dev, card, rows))
    if "steps" in kernels:
        total.update(time_steps(dev, card, rows))
    if "options" in kernels:
        total.update(time_options(dev, card, rows))
    import lmnet_tpu_torch

    print(json.dumps({"card": card, "package": lmnet_tpu_torch.__file__, "shapes": rows,
                      "total": total}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Times the NAT kernels and B7 on one CUDA card at the shapes of a 256^2,
B=16 LM-Net forward (12 heads, bf16). B1 (nat_fwd) and B2 (nat_bwd) at the
four NAT stages, three ways: eagerly (CUDA events over back-to-back calls,
as chip_smoke.py times them), replayed as a CUDA graph (device time alone,
no host work), and per CUDA kernel under torch.profiler. Beside each stage:
its bytes (B1: q, k, v in and out once; B2: q, k, v, g in and dq, dk, dv
out once), their bound at 3.35 TB/s, the rate reached and the launch plan's
variant. B8 (natt_flat, the fused NATT interior) at the four NATT stages of
the same forward (emb (16, H, W*C), the stages' C and head_dim), eagerly and
as a CUDA graph, beside its plain version and the unfused bf16 interior
that ``deploy_forward`` runs (``serve.engine.natt_interior``), with its
bound (``chip_smoke.natt_work``). B3 (nat_kernel, ``nat_backend='pallas'``)
at the four NAT stages beside B1 on the same inputs, eagerly, as a CUDA
graph of one call and of 10 calls (the device time of a call, without the
replay's host cost) and under the profiler, with its plan. B7
(upsample_flat) at the 7 upsamples of a served batch (``B7_SERVED``), the
same ways, with the host's microseconds a call (eager less the device
time, a graph of 10 calls) and to enqueue a call, beside the plain version and
``F.interpolate``; its sums count each shape's calls. Random inputs and
weights from a seed; each kernel is held against its plain version first.

Run from the repository root: ``python3 nat_kernel_times.py``;
``--kernels B3,B7`` times only the kernels named (comma-separated, of B1,
B2, B3, B7, B8; default B1,B2,B8). With ``--tree DIR`` it times the kernels
of the ``lmnet_tpu_torch`` package under DIR instead (an unpacked earlier
commit, for a comparison in one call: run parent, new, new, parent). It
exits 1 without a card. The last line is one JSON object with the per-stage
times.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

import chip_smoke as cs
from rc_kernel_times import device_us


def _variant(kind, B, H, W, C) -> str:
    """The plan's variant for this call, where the tree has a plan."""
    import importlib

    nf = importlib.import_module("lmnet_tpu_torch.ops.nat_flat")
    plan = getattr(nf, "nat_plan", None)
    if plan is None:
        return "n/a"
    p = plan(B, H, W, cs.HEADS, C // cs.HEADS, torch.bfloat16, kind)
    return p["variant"] if p else "refused"


def time_b8(dev, card, total) -> list[dict]:
    """B8 at the four NATT stages; adds its sums to ``total``."""
    from lmnet_tpu_torch.ops import natt_flat as nf
    from lmnet_tpu_torch.serve import engine

    rows = []
    for i, (H, W, C) in enumerate(cs.STAGES_256):
        B, heads = cs.BATCH, cs.HEADS
        sd = cs.natt_state(600 + i, C, heads, dev)
        fw = nf.fold_natt_weights(sd, "natt", heads)
        emb = torch.randn(B, H, W, C, generator=torch.Generator().manual_seed(650 + i))
        emb = emb.to(dev, torch.bfloat16)
        e = emb.reshape(B, H, W * C)
        with torch.inference_mode():
            got = nf.natt_flat_interior(e, fw, heads, C, W)
            if hasattr(cs, "check_b8") and hasattr(nf, "natt_plan"):
                cs.check_b8("nat_kernel_times", e, fw, heads, C, W, got)
            else:  # an earlier tree: its own bound, against the float32 plain version
                ref = nf.natt_flat_interior_plain(e.float(), fw, heads, C, W)
                err = (got.float() - ref).abs()
                cs.check(bool((err <= 1e-4 * (1 + ref.abs().max()) + 2**-8 * ref.abs()).all()),
                         f"natt_flat disagrees with plain at H={H}")
            fn = lambda: nf.natt_flat_interior(e, fw, heads, C, W)  # noqa: E731
            unf = lambda: engine.natt_interior(sd, "natt", emb, heads, "flat")  # noqa: E731
            ms = {"ms": cs.cuda_ms(fn), "graph_ms": cs.graph_ms(fn),
                  "plain_ms": cs.cuda_ms(lambda: nf.natt_flat_interior_plain(e, fw, heads, C, W),
                                         iters=5),
                  "unfused_ms": cs.cuda_ms(unf), "unfused_graph_ms": cs.graph_ms(unf)}
            us = device_us(fn)
        work = cs.natt_work(B, H, W, C, heads, fw["packed"].numel())
        bound, by = work.bound()
        row = {"H": H, "W": W, "C": C, "hd": C // heads, "natt_flat": {
            **ms, "bound_ms": bound, "bound_by": by, "bound_terms_ms": work.terms(),
            "tc_tflop_s": work.tc_flops / ms["ms"] / 1e9}}
        rows.append(row)
        for kk, v in (*ms.items(), ("bound_ms", bound)):
            total[f"natt_flat {kk}"] = total.get(f"natt_flat {kk}", 0.0) + v
        print(f"natt_flat H={H} W={W} C={C} hd={C // heads} B={B} bf16: "
              + ", ".join(f"{kk} {v:.4f}" for kk, v in ms.items())
              + f"; bound {bound:.4f} ms ({by}; terms "
              + ", ".join(f"{kk} {v:.4f}" for kk, v in work.terms().items())
              + f"), {work.tc_flops / ms['ms'] / 1e9:.2f} TFLOP/s of product work eager [{card}]")
        print("   natt_flat device us a call by kernel: "
              + "; ".join(f"{kk} {v:.1f}" for kk, v in list(us.items())[:4]))
    return rows


# (B, H, W, C) of the 7 upsamples of a served 256^2, B=16 batch, each with
# its number of calls: up4, then up3 .. up1 and the three skip inputs
B7_SERVED = [((16, 16, 16, 192), 1), ((16, 32, 32, 96), 2), ((16, 64, 64, 48), 2),
             ((16, 128, 128, 24), 2)]


def graph10(fn) -> float:
    """Milliseconds a call of ``fn`` in a CUDA graph of 10 calls: device time
    and the gaps between launches, without the replay's host cost."""
    return cs.graph_ms(fn, iters=20, calls=10)


def host_us(fn, calls=200) -> float:
    """Host microseconds to enqueue one call of ``fn`` (host clock over
    back-to-back calls, no synchronisation inside the loop)."""
    import time

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def time_b7(dev, card, total) -> list[dict]:
    """B7 at the 7 upsamples of a served batch: eager, CUDA graph, the host's
    enqueue time, the device time under the profiler, beside F.interpolate
    and the plain version; adds the sums (by calls) to ``total``."""
    import torch.nn.functional as F

    from lmnet_tpu_torch.ops.upsample_flat import upsample2x_flat, upsample2x_flat_plain

    rows = []
    for i, (shape, n) in enumerate(B7_SERVED):
        x = torch.randn(*shape, generator=torch.Generator().manual_seed(900 + i))
        x = x.to(dev, torch.bfloat16)
        with torch.inference_mode():
            cs.check_up("nat_kernel_times", upsample2x_flat(x), x)
            fn = lambda: upsample2x_flat(x)  # noqa: E731
            lib = lambda: F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2,  # noqa: E731
                                        mode="bilinear", align_corners=True)
            ms = {"ms": cs.cuda_ms(fn, iters=50), "graph_ms": cs.graph_ms(fn, iters=50),
                  "graph10_ms": graph10(fn), "host_enqueue_us": host_us(fn),
                  "plain_ms": cs.cuda_ms(lambda: upsample2x_flat_plain(x), iters=5),
                  "library_ms": cs.cuda_ms(lib, iters=50)}
            us = device_us(fn)
        ms["host_us"] = (ms["ms"] - ms["graph10_ms"]) * 1e3
        nbytes = 5 * x.numel() * x.element_size()
        ms["bound_ms"] = nbytes / cs.HBM_RATE * 1e3
        variant = cs.up_variant(x)
        rows.append({"shape": list(shape), "calls": n, "variant": variant, **ms,
                     "device_us": dict(list(us.items())[:3])})
        for kk, v in ms.items():
            total[f"upsample_flat {kk}"] = total.get(f"upsample_flat {kk}", 0.0) + n * v
        print(f"upsample_flat {tuple(shape)} x{n} bf16 [{variant}]: "
              + ", ".join(f"{kk} {v:.4f}" for kk, v in ms.items())
              + f"; {nbytes / ms['graph_ms'] / 1e6:.1f} GB/s as a graph [{card}]")
        print("   upsample_flat device us a call by kernel: "
              + "; ".join(f"{kk} {v:.1f}" for kk, v in list(us.items())[:3]))
    return rows


def time_b3(dev, card, total) -> list[dict]:
    """B3 at the four 256^2 NAT stages beside B1 on the same inputs: eager,
    CUDA graph and the device time under the profiler; adds the sums to
    ``total``."""
    from lmnet_tpu_torch.ops.nat_flat import nat_flat
    from lmnet_tpu_torch.ops.nat_kernel import neighborhood_attention_pallas

    rows = []
    B = cs.BATCH
    for i, (H, W, C) in enumerate(cs.STAGES_256):
        q, k, v, rpb = cs.nat_inputs(B, H, W, C, torch.bfloat16, 1400 + i, dev)
        q4, k4, v4 = (t.reshape(B, H, W, C) for t in (q, k, v))
        with torch.inference_mode():
            cs.check_b3("nat_kernel_times", neighborhood_attention_pallas(q4, k4, v4, rpb),
                        q, k, v, rpb, B, H, W, C)
            b3 = lambda: neighborhood_attention_pallas(q4, k4, v4, rpb)  # noqa: E731
            b1 = lambda: nat_flat(q, k, v, rpb, cs.HEADS, C, W)  # noqa: E731
            ms = {"ms": cs.cuda_ms(b3, iters=50), "graph_ms": cs.graph_ms(b3, iters=50),
                  "graph10_ms": graph10(b3), "b1_ms": cs.cuda_ms(b1, iters=50),
                  "b1_graph_ms": cs.graph_ms(b1, iters=50), "b1_graph10_ms": graph10(b1)}
            us = device_us(b3)
        nbytes = 4 * q.numel() * q.element_size()
        ms["bound_ms"] = nbytes / cs.HBM_RATE * 1e3
        variant = cs.b3_variant(B, H, W, C, torch.bfloat16)
        rows.append({"H": H, "W": W, "C": C, "variant": variant, **ms,
                     "device_us": dict(list(us.items())[:3])})
        for kk, v in ms.items():
            total[f"nat_kernel {kk}"] = total.get(f"nat_kernel {kk}", 0.0) + v
        print(f"nat_kernel H={H} W={W} C={C} hd={C // cs.HEADS} B={B} bf16 [{variant}]: "
              + ", ".join(f"{kk} {v:.4f}" for kk, v in ms.items())
              + f"; {nbytes / ms['graph_ms'] / 1e6:.1f} GB/s as a graph [{card}]")
        print("   nat_kernel device us a call by kernel: "
              + "; ".join(f"{kk} {v:.1f}" for kk, v in list(us.items())[:3]))
    return rows


def main() -> int:
    args = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    args.add_argument("--tree", help="time the lmnet_tpu_torch package under this directory")
    args.add_argument("--kernels", default="B1,B2,B8",
                      help="comma-separated: B1, B2, B3, B7, B8")
    opts = args.parse_args()
    if opts.tree:
        sys.path.insert(0, opts.tree)
    kernels = set(opts.kernels.split(","))
    if not torch.cuda.is_available():
        print("nat_kernel_times: no CUDA device", file=sys.stderr)
        return 1
    from lmnet_tpu_torch.ops.nat_flat import nat_flat, nat_flat_bwd

    card = cs.card()
    dev = torch.device("cuda")
    B = cs.BATCH
    stages, total = [], {}
    for i, (H, W, C) in enumerate(cs.STAGES_256 if kernels & {"B1", "B2"} else []):
        q, k, v, rpb = cs.nat_inputs(B, H, W, C, torch.bfloat16, 700 + i, dev)
        g = torch.randn(B, H, W * C, generator=torch.Generator().manual_seed(800 + i))
        g = g.to(dev, torch.bfloat16)
        scale = float(C // cs.HEADS) ** -0.5
        with torch.inference_mode():
            cs.check_fwd("nat_kernel_times", nat_flat(q, k, v, rpb, cs.HEADS, C, W),
                         q, k, v, rpb, B, H, W, C)
        cs.check_bwd("nat_kernel_times", nat_flat_bwd(q, k, v, rpb, g, cs.HEADS, C, W, scale),
                     q, k, v, rpb, g, B, H, W, C, scale)
        fwd = lambda: nat_flat(q, k, v, rpb, cs.HEADS, C, W)  # noqa: E731
        bwd = lambda: nat_flat_bwd(q, k, v, rpb, g, cs.HEADS, C, W, scale)  # noqa: E731
        row = {"H": H, "W": W, "C": C, "hd": C // cs.HEADS}
        for name, fn, nio, kind in (("nat_fwd", fwd, 4, "fwd"), ("nat_bwd", bwd, 7, "bwd")):
            nbytes = nio * q.numel() * q.element_size()
            with torch.inference_mode():
                eager, graph = cs.cuda_ms(fn), cs.graph_ms(fn)
            row[name] = {"ms": eager, "graph_ms": graph, "mb": nbytes / 1e6,
                         "bound_ms": nbytes / cs.HBM_RATE * 1e3,
                         "gb_s": nbytes / eager / 1e6, "graph_gb_s": nbytes / graph / 1e6,
                         "variant": _variant(kind, B, H, W, C)}
            for key in ("ms", "graph_ms", "bound_ms"):
                total[f"{name} {key}"] = total.get(f"{name} {key}", 0.0) + row[name][key]
            r = row[name]
            print(f"{name} H={H} W={W} C={C} hd={C // cs.HEADS} B={B} bf16 [{r['variant']}]: "
                  f"eager {r['ms']:.4f} ms ({r['gb_s']:.1f} GB/s), graph {r['graph_ms']:.4f} ms "
                  f"({r['graph_gb_s']:.1f} GB/s) of {r['mb']:.1f} MB, bound {r['bound_ms']:.4f} ms "
                  f"[{card}]")
            with torch.inference_mode():
                us = device_us(fn)
            print(f"   {name} device us a call by kernel: "
                  + "; ".join(f"{kk} {v:.1f}" for kk, v in list(us.items())[:4]))
        stages.append(row)
    if "B8" in kernels:
        stages += time_b8(dev, card, total)
    if "B3" in kernels:
        stages += time_b3(dev, card, total)
    if "B7" in kernels:
        stages += time_b7(dev, card, total)
    print("the four 256^2 stages, ms: "
          + ", ".join(f"{kk} {v:.4f}" for kk, v in total.items()) + f" [{card}]")
    import lmnet_tpu_torch

    print(json.dumps({"card": card, "package": lmnet_tpu_torch.__file__, "stages": stages,
                      "total": total}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

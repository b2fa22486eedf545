#!/usr/bin/env python3
"""Smoke test of the PyTorch port (lmnet_tpu_torch) on one CUDA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.

Phases, each printing a line, any failure raising (exit code != 0):
  1. the device (nvidia-smi name and power limit, torch and CUDA versions);
  2. build the NAT kernel (csrc/nat_fwd.cu) with nvcc for sm_90a;
  3. the kernel against its plain PyTorch version, in float32 (TF32 off)
     and bfloat16, at the four NAT stage shapes of the 256^2 model (B=2),
     at H=W=28 with head_dim 3 and at H=W=3;
  4. the serving path: the full-width LMNet from a seeded generator (BN
     running statistics randomised from it too), serving_evaluate over
     make_loader(SyntheticDataset(32, 256, 'val', seed=0), 16) with every
     kernel launch counted, and two checks of the output: the deploy graph
     against the model's own eval forward (float32, small input), and the
     'flat' NAT backend against 'plain' on one served bf16 batch;
  5. times from CUDA events after a warm-up: the kernel against the plain
     version at each 256^2 stage shape (B=16, bf16), and the serving rate
     at 256^2, B=16.

The line before the last is the card's name and power limit as nvidia-smi
prints them; the one before that lists every kernel of the path as JSON; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

BATCH = 16
IMG = 256
# (H, W, C) of the four NAT stages at 256^2 inputs, 12 heads: natt4 .. natt1
STAGES_256 = [(256, 256, 12), (128, 128, 24), (64, 64, 48), (32, 32, 96)]
HEADS = 12


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` by CUDA events, after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nat_inputs(B, H, W, C, dtype, seed, dev):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v = (torch.randn(B, H, W * C, generator=g).to(dev, dtype) for _ in range(3))
    rpb = (torch.randn(HEADS, 5, 5, generator=g) * 0.3).to(dev)
    return q, k, v, rpb


def phase_kernel_vs_plain(dev) -> float:
    from lmnet_tpu_torch.ops.nat import neighborhood_attention
    from lmnet_tpu_torch.ops.nat_flat import nat_flat

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shapes = [(2, h, w, c) for h, w, c in STAGES_256] + [(2, 28, 28, 36), (2, 3, 3, 24)]
    worst = 0.0
    for i, (B, H, W, C) in enumerate(shapes):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, rpb = nat_inputs(B, H, W, C, dtype, i, dev)
            got = nat_flat(q, k, v, rpb, HEADS, C, W)
            torch.cuda.synchronize()
            ref = neighborhood_attention(
                *(t.float().reshape(B, H, W, C) for t in (q, k, v)), rpb, 3
            ).reshape(B, H, W * C)
            err = (got.float() - ref).abs()
            if dtype == torch.float32:
                tol = "abs 1e-5"
                ok = bool((err <= 1e-5).all())
            else:  # one bf16 rounding of the stored result (2^-9 relative), with margin
                tol = "2^-8*|ref| + 1e-4"
                ok = bool((err <= 2**-8 * ref.abs() + 1e-4).all())
            e = err.max().item()
            worst = max(worst, e)
            print(f"phase 3: nat_fwd vs plain B={B} H={H} W={W} C={C} hd={C // HEADS} "
                  f"{str(dtype).split('.')[-1]}: max_abs_err={e:.3e} (tol {tol}) "
                  f"{'ok' if ok else 'FAIL'}")
            check(ok, f"nat_fwd disagrees with plain at {(B, H, W, C, dtype)}: {e}")
    return worst


def seeded_model(dev):
    from lmnet_tpu_torch.models import LMNet
    from lmnet_tpu_torch.models.blocks import BatchNorm

    g = torch.Generator().manual_seed(0)
    model = LMNet(generator=g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.normal_(0.0, 0.2, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)
    return model.to(dev).eval()


def phase_serving(model, dev):
    from lmnet_tpu_torch.data import SyntheticDataset, make_loader
    from lmnet_tpu_torch.models import structural_reparam
    from lmnet_tpu_torch.ops.nat_flat import nat_flat
    from lmnet_tpu_torch.serve import deploy_forward, serving_evaluate

    n_images = 32
    n_batches = (n_images + BATCH - 1) // BATCH
    state = model.state_dict()
    deploy = structural_reparam(state)
    torch.cuda.synchronize()

    nat_flat.launches = 0
    t0 = time.perf_counter()
    loss, metrics = serving_evaluate(
        state, make_loader(SyntheticDataset(n_images, IMG, "val", seed=0), BATCH),
        num_classes=2, img_size=IMG, num_heads=HEADS,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = nat_flat.launches
    print(f"phase 4: serving_evaluate {n_images} images at {IMG}^2 B={BATCH}: "
          f"loss={loss:.6f} metrics={json.dumps(metrics)} wall={wall:.3f}s "
          f"nat_fwd launches={launches}")
    check(np.isfinite(loss) and all(np.isfinite(v) for v in metrics.values()),
          "non-finite loss or metrics")
    check(launches == 4 * n_batches,
          f"nat_fwd launched {launches} times, want 4 x {n_batches} batches")

    # the deploy graph against the model's own eval forward (float32, TF32
    # off): reparam and the CUDA NAT kernel change only summation order
    x = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(1)).to(dev)
    with torch.inference_mode():
        ref = model(x)
        out = deploy_forward(deploy, x, num_heads=HEADS, nat_backend="flat")
    torch.cuda.synchronize()
    scale = ref.abs().max().item()
    err = (out - ref).abs().max().item()
    ok = out.shape == (2, 64, 64, 2) and bool(torch.isfinite(out).all()) and err <= 1e-4 * max(scale, 1.0)
    print(f"phase 4: deploy_forward(flat) vs LMNet eval forward, fp32 64^2 B=2: "
          f"max_abs_err={err:.3e} on logits of max {scale:.3e} (tol 1e-4 x max(scale, 1)) "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "deploy forward disagrees with the eval forward")

    # 'flat' against 'plain' on one served batch, bf16 on both sides
    from lmnet_tpu_torch.data.augment import eval_pipeline

    images, masks = next(iter(make_loader(SyntheticDataset(BATCH, IMG, "val", seed=0), BATCH)))
    xb, _ = eval_pipeline(torch.from_numpy(images).to(dev), torch.from_numpy(masks).to(dev), IMG)
    xb = xb.to(torch.bfloat16)
    with torch.inference_mode():
        lf = deploy_forward(deploy, xb, num_heads=HEADS, nat_backend="flat")
        lp = deploy_forward(deploy, xb, num_heads=HEADS, nat_backend="plain")
    torch.cuda.synchronize()
    scale = lp.abs().max().item()
    err = (lf - lp).abs().max().item()
    flips = (lf.argmax(-1) != lp.argmax(-1)).float().mean().item()
    ok = (lf.shape == (BATCH, IMG, IMG, 2) and bool(torch.isfinite(lf).all())
          and err <= 0.05 * max(scale, 1.0) and flips < 0.025)
    print(f"phase 4: deploy_forward bf16 {IMG}^2 B={BATCH} flat vs plain: max_abs_diff={err:.3e} "
          f"on logits of max {scale:.3e}, argmax flips={flips:.4%} "
          f"(tol 0.05 x max(scale, 1), flips < 2.5%) {'ok' if ok else 'FAIL'}")
    check(ok, "flat and plain NAT backends disagree on the served batch")
    return deploy, launches, xb


def phase_times(deploy, xb, card_line):
    from lmnet_tpu_torch.ops.nat import neighborhood_attention
    from lmnet_tpu_torch.ops.nat_flat import nat_flat
    from lmnet_tpu_torch.serve import deploy_forward

    dev = xb.device
    k_total = p_total = 0.0
    for i, (H, W, C) in enumerate(STAGES_256):
        q, k, v, rpb = nat_inputs(BATCH, H, W, C, torch.bfloat16, 100 + i, dev)
        q4, k4, v4 = (t.reshape(BATCH, H, W, C) for t in (q, k, v))
        with torch.inference_mode():
            k_ms = cuda_ms(lambda: nat_flat(q, k, v, rpb, HEADS, C, W))
            p_ms = cuda_ms(lambda: neighborhood_attention(q4, k4, v4, rpb, 3))
        nbytes = 4 * q.numel() * q.element_size()
        k_total += k_ms
        p_total += p_ms
        print(f"phase 5: nat stage H={H} W={W} C={C} hd={C // HEADS} B={BATCH} bf16: "
              f"kernel {k_ms:.4f} ms ({nbytes / k_ms / 1e6:.1f} GB/s of {nbytes / 1e6:.1f} MB), "
              f"plain {p_ms:.4f} ms [{card_line}]")
    with torch.inference_mode():
        torch.cuda.reset_peak_memory_stats()
        f_ms = cuda_ms(lambda: deploy_forward(deploy, xb, num_heads=HEADS), iters=10)
        peak = torch.cuda.max_memory_allocated() / 2**30
        pl_ms = cuda_ms(lambda: deploy_forward(deploy, xb, num_heads=HEADS, nat_backend="plain"),
                        iters=10)
    print(f"phase 5: deploy_forward bf16 {IMG}^2 B={BATCH}: nat flat {f_ms:.3f} ms/batch = "
          f"{BATCH * 1000 / f_ms:.1f} img/s (peak {peak:.2f} GiB); nat plain {pl_ms:.3f} ms/batch = "
          f"{BATCH * 1000 / pl_ms:.1f} img/s [{card_line}]")
    return k_total, p_total


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card", file=sys.stderr)
        return 1
    from lmnet_tpu_torch.ops import _build

    card_line = card()
    dev = torch.device("cuda")
    print(f"phase 1: device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} "
          f"[{card_line}] torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.load("nat_fwd")
    print(f"phase 2: nat_fwd built from {_build.CSRC / 'nat_fwd.cu'} -> "
          f"{_build.library_path('nat_fwd').name} in {time.perf_counter() - t0:.2f}s")

    worst = phase_kernel_vs_plain(dev)
    model = seeded_model(dev)
    deploy, launches, xb = phase_serving(model, dev)
    k_ms, p_ms = phase_times(deploy, xb, card_line)

    print(json.dumps({"kernels": [{
        "name": "nat_fwd",
        "route": "cuda",
        "source": "lmnet_tpu_torch/csrc/nat_fwd.cu",
        "replaces": "lmnet_tpu/ops/pallas/nat_flat.py:249",
        "launches": launches,
        "max_abs_err": worst,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

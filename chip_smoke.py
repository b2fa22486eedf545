#!/usr/bin/env python3
"""Smoke test of the PyTorch port (lmnet_tpu_torch) on one CUDA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.

Phases, each printing a line, any failure raising (exit code != 0):
  1. the device (nvidia-smi name and power limit, torch and CUDA versions);
  2. build both NAT kernels (csrc/nat_fwd.cu, csrc/nat_bwd.cu) with nvcc
     for sm_90a, one process per source, in parallel;
  3. the forward kernel against its plain PyTorch version, in float32
     (TF32 off) and bfloat16, at the four NAT stage shapes of the 256^2
     model (B=2) and of the 288^2 training epoch (B=16), at H=W=28 with
     head_dim 3, at H=W=3 and on a narrow W=4 map;
  4. the serving path: the full-width LMNet from a seeded generator (BN
     running statistics randomised from it too), serving_evaluate over
     make_loader(SyntheticDataset(32, 256, 'val', seed=0), 16) with every
     kernel launch counted, and two checks of the output: the deploy graph
     against the model's own eval forward (float32, small input), and the
     'flat' NAT backend against 'plain' on one served bf16 batch;
  5. serving times from CUDA events after a warm-up: the forward kernel
     against the plain version at each 256^2 stage shape (B=16, bf16; the
     kernel's output held against the plain one as in phase 3), and the
     serving rate at 256^2, B=16;
  6. the backward kernel against the plain backward (autograd of the plain
     NAT) for dq, dk, dv and d_rpb, in float32 and bfloat16, at the shapes
     of phase 3, and two calls bitwise equal (288^2 stage, B=16);
  7. the training path: create_train_state(LMNet(dtype=bf16, rc_remat=True))
     -> train_one_epoch(augment_on_device=False) over
     make_loader(SyntheticDataset(32, 256, 'train'), 16) (the 'train' split
     loads 288^2 images, as the JAX loop sees them without augmentation) ->
     evaluate over a 256^2 val set, every kernel launch counted; then 8
     steps on one fixed batch must lower the loss;
  8. 'flat' against 'plain' NAT on one train_step: float32 at 64^2, B=2
     (the loss and every gradient), bf16 at full width, 256^2, B=16 (the
     loss and the gradients of every NAT layer, each backend against a
     float32 step from the same weights);
  9. training times from CUDA events after a warm-up: the backward kernel
     against the plain backward at each 256^2 stage (B=16, bf16; the
     kernel's output held against the plain one as in phase 6), and
     train_step at 256^2, B=16, bf16, rc_remat=True with flat and with
     plain NAT in turns (img/s, peak device memory, NAT launches per step);
     a torch.profiler pass over flat train steps (kernel launches, device
     busy time and the top ops by device time per step); one more step
     under CUDA's sync debug mode must make no host sync.

The line before the last is the card's name and power limit as nvidia-smi
prints them; the one before that lists every kernel of the path as JSON; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

BATCH = 16
IMG = 256
# (H, W, C) of the four NAT stages at 256^2 inputs, 12 heads: natt4 .. natt1
STAGES_256 = [(256, 256, 12), (128, 128, 24), (64, 64, 48), (32, 32, 96)]
# the same at the 'train' split's 288^2 load size, which the training epoch sees
STAGES_288 = [(288, 288, 12), (144, 144, 24), (72, 72, 48), (36, 36, 96)]
HEADS = 12
# (B, H, W, C) at which phases 3 and 6 hold each kernel against its plain
# version: the 256^2 stages at B=2, the training epoch's 288^2 stages at
# B=16, and the shapes TPU kernels leave to XLA (head_dim 3, H=W=3, W=4);
# the 256^2 stages at B=16 are checked on the inputs phases 5 and 9 time
CHECK_SHAPES = ([(2, h, w, c) for h, w, c in STAGES_256]
                + [(BATCH, h, w, c) for h, w, c in STAGES_288]
                + [(2, 28, 28, 36), (2, 3, 3, 24), (2, 16, 4, 48)])


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


def check_fwd(label, got, q, k, v, rpb, B, H, W, C) -> float:
    """Hold the forward kernel's output ``got`` against the plain NAT on q,
    k, v upcast to float32; print one line; raise if they disagree."""
    from lmnet_tpu_torch.ops.nat import neighborhood_attention

    ref = neighborhood_attention(
        *(t.float().reshape(B, H, W, C) for t in (q, k, v)), rpb, 3
    ).reshape(B, H, W * C)
    err = (got.float() - ref).abs()
    if q.dtype == torch.float32:
        tol = "abs 1e-5"
        ok = bool((err <= 1e-5).all())
    else:  # one bf16 rounding of the stored result (2^-9 relative), with margin
        tol = "2^-8*|ref| + 1e-4"
        ok = bool((err <= 2**-8 * ref.abs() + 1e-4).all())
    e = err.max().item()
    print(f"{label}: nat_fwd vs plain B={B} H={H} W={W} C={C} hd={C // HEADS} "
          f"{str(q.dtype).split('.')[-1]}: max_abs_err={e:.3e} (tol {tol}) "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, f"nat_fwd disagrees with plain at {(B, H, W, C, q.dtype)}: {e}")
    return e


def phase_kernel_vs_plain(dev) -> float:
    from lmnet_tpu_torch.ops.nat_flat import nat_flat

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst = 0.0
    for i, (B, H, W, C) in enumerate(CHECK_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, rpb = nat_inputs(B, H, W, C, dtype, i, dev)
            got = nat_flat(q, k, v, rpb, HEADS, C, W)
            worst = max(worst, check_fwd("phase 3", got, q, k, v, rpb, B, H, W, C))
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
    k_total = p_total = worst = 0.0
    for i, (H, W, C) in enumerate(STAGES_256):
        q, k, v, rpb = nat_inputs(BATCH, H, W, C, torch.bfloat16, 100 + i, dev)
        q4, k4, v4 = (t.reshape(BATCH, H, W, C) for t in (q, k, v))
        with torch.inference_mode():
            got = nat_flat(q, k, v, rpb, HEADS, C, W)
            worst = max(worst, check_fwd("phase 5", got, q, k, v, rpb, BATCH, H, W, C))
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
    return k_total, p_total, worst


def check_bwd(label, got, q, k, v, rpb, g, B, H, W, C, scale) -> float:
    """Hold the backward kernel's (dq, dk, dv, d_rpb) ``got`` against the
    plain backward on q, k, v, g upcast to float32; print one line; raise if
    they disagree. d_rpb is a sum over B*H*W pixels: a norm-relative bound."""
    from lmnet_tpu_torch.ops.nat_flat import nat_flat_bwd_plain

    ref = nat_flat_bwd_plain(q.float(), k.float(), v.float(), rpb, g.float(),
                             HEADS, C, W, scale)
    errs, ok = [], True
    for a, b in zip(got[:3], ref[:3]):
        err = (a.float() - b).abs()
        big = b.abs().max()
        if q.dtype == torch.float32:
            bound = 1e-5 * (1 + big)
        else:  # one bf16 rounding of the stored gradient, with margin
            bound = 2**-8 * b.abs() + 1e-4 * (1 + big)
        ok = ok and bool((err <= bound).all()) and a.dtype == q.dtype
        errs.append(err.max().item())
    rel = ((got[3] - ref[3]).norm() / ref[3].norm()).item()
    ok = ok and rel <= 1e-4 and got[3].dtype == torch.float32
    tol = ("1e-5*(1+max|ref|)" if q.dtype == torch.float32
           else "2^-8*|ref| + 1e-4*(1+max|ref|)")
    print(f"{label}: nat_bwd vs plain B={B} H={H} W={W} C={C} hd={C // HEADS} "
          f"{str(q.dtype).split('.')[-1]}: max_abs_err dq={errs[0]:.3e} dk={errs[1]:.3e} "
          f"dv={errs[2]:.3e} (tol {tol}); d_rpb norm-rel err={rel:.3e} (tol 1e-4) "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, f"nat_bwd disagrees with plain at {(B, H, W, C, q.dtype)}")
    return max(errs)


def phase_bwd_vs_plain(dev) -> float:
    from lmnet_tpu_torch.ops.nat_flat import nat_flat_bwd

    worst = 0.0
    for i, (B, H, W, C) in enumerate(CHECK_SHAPES):
        scale = float(C // HEADS) ** -0.5
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, rpb = nat_inputs(B, H, W, C, dtype, 200 + i, dev)
            g = torch.randn(B, H, W * C, generator=torch.Generator().manual_seed(300 + i))
            g = g.to(dev, dtype)
            got = nat_flat_bwd(q, k, v, rpb, g, HEADS, C, W, scale)
            worst = max(worst, check_bwd("phase 6", got, q, k, v, rpb, g, B, H, W, C, scale))
    for dtype in (torch.float32, torch.bfloat16):
        B, (H, W, C) = BATCH, STAGES_288[0]
        q, k, v, rpb = nat_inputs(B, H, W, C, dtype, 400, dev)
        g = torch.randn(B, H, W * C, generator=torch.Generator().manual_seed(401)).to(dev, dtype)
        a = nat_flat_bwd(q, k, v, rpb, g, HEADS, C, W, 0.5)
        b = nat_flat_bwd(q, k, v, rpb, g, HEADS, C, W, 0.5)
        same = all(torch.equal(x, y) for x, y in zip(a, b))
        print(f"phase 6: nat_bwd twice on the same inputs B={B} H={H} W={W} C={C} "
              f"{str(dtype).split('.')[-1]}: dq, dk, dv, d_rpb bitwise equal: {same}")
        check(same, "nat_bwd is not bitwise repeatable")
    return worst


def _train_model(dev, dtype=torch.bfloat16, nat_backend="flat", seed=0):
    from lmnet_tpu_torch.models import LMNet

    model = LMNet(generator=torch.Generator().manual_seed(seed), dtype=dtype,
                  nat_backend=nat_backend, rc_remat=True)
    return model.to(dev)


def _batch(n, img, split, seed, dev):
    from lmnet_tpu_torch.data import SyntheticDataset, make_loader
    from lmnet_tpu_torch.data.augment import eval_pipeline

    images, masks = next(iter(make_loader(SyntheticDataset(n, img, split, seed=seed), n)))
    return eval_pipeline(torch.from_numpy(images).to(dev), torch.from_numpy(masks).to(dev), img)


def phase_training(dev):
    from lmnet_tpu_torch.data import SyntheticDataset, make_loader
    from lmnet_tpu_torch.metrics import ConfusionAccumulator
    from lmnet_tpu_torch.ops.nat_flat import nat_flat, nat_flat_bwd
    from lmnet_tpu_torch.train import create_train_state, evaluate, train_one_epoch, train_step

    n_images = 32
    steps = (n_images + BATCH - 1) // BATCH
    load = IMG * 9 // 8  # the 'train' split's load size
    state = create_train_state(_train_model(dev), (BATCH, load, load, 3), seed=0,
                               epochs=10, steps_per_epoch=steps)
    torch.cuda.synchronize()

    nat_flat.launches = nat_flat_bwd.launches = 0
    t0 = time.perf_counter()
    state, total, metrics = train_one_epoch(
        state, make_loader(SyntheticDataset(n_images, IMG, "train", seed=0), BATCH),
        img_size=IMG, augment_on_device=False,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train_launches = {"nat_fwd": nat_flat.launches, "nat_bwd": nat_flat_bwd.launches}
    print(f"phase 7: train_one_epoch {n_images} images ({load}^2, B={BATCH}, bf16, rc_remat) "
          f"{steps} steps: loss={total:.6f} metrics={json.dumps(metrics)} wall={wall:.3f}s "
          f"nat_fwd launches={train_launches['nat_fwd']} nat_bwd launches={train_launches['nat_bwd']}")
    check(np.isfinite(total) and all(np.isfinite(v) for v in metrics.values()),
          "non-finite training loss or metrics")
    check(train_launches == {"nat_fwd": 4 * steps, "nat_bwd": 4 * steps},
          f"NAT kernels launched {train_launches}, want 4 x {steps} steps each")

    nat_flat.launches = nat_flat_bwd.launches = 0
    val = make_loader(SyntheticDataset(n_images, IMG, "val", seed=1), BATCH)
    loss, vmetrics = evaluate(state, val, img_size=IMG)
    torch.cuda.synchronize()
    eval_launches = {"nat_fwd": nat_flat.launches, "nat_bwd": nat_flat_bwd.launches}
    print(f"phase 7: evaluate {n_images} images at {IMG}^2: ce_loss={loss:.6f} "
          f"metrics={json.dumps(vmetrics)} nat_fwd launches={eval_launches['nat_fwd']} "
          f"nat_bwd launches={eval_launches['nat_bwd']}")
    check(np.isfinite(loss) and all(np.isfinite(v) for v in vmetrics.values()),
          "non-finite eval loss or metrics")
    check(eval_launches == {"nat_fwd": 4 * steps, "nat_bwd": 0},
          f"evaluate launched {eval_launches}, want nat_fwd 4 x {steps} batches")

    # eight steps on one fixed batch lower the loss (tests/test_train.py in JAX)
    state = create_train_state(_train_model(dev, seed=1), (BATCH, IMG, IMG, 3), seed=1,
                               epochs=10, steps_per_epoch=4)
    x, y = _batch(BATCH, IMG, "val", 2, dev)
    cm = ConfusionAccumulator.init(2, dev)
    losses = []
    for _ in range(8):
        state, l, cm = train_step(state, x, y, cm)
        losses.append(l)
    losses = [float(v) for v in losses]
    ok = all(np.isfinite(losses)) and losses[-1] < losses[0]
    print(f"phase 7: 8 train steps on one batch ({IMG}^2, B={BATCH}, bf16): losses "
          f"{' '.join(f'{v:.5f}' for v in losses)} {'ok' if ok else 'FAIL'}")
    check(ok, "the loss did not fall over 8 steps on one batch")
    return {k: train_launches[k] + eval_launches[k] for k in train_launches}


def _one_step(model, x, y, seed):
    from lmnet_tpu_torch.metrics import ConfusionAccumulator
    from lmnet_tpu_torch.train import create_train_state, train_step

    state = create_train_state(model, tuple(x.shape), seed=seed)
    state, loss, _ = train_step(state, x, y, ConfusionAccumulator.init(2, x.device))
    return float(loss), {n: p.grad for n, p in model.named_parameters()}


def _same_start(dev, seed, *specs):
    """One model per (compute dtype, NAT backend), each with the first one's
    weights."""
    models = [_train_model(dev, dtype, nb, seed=seed) for dtype, nb in specs]
    for m in models[1:]:
        m.load_state_dict(models[0].state_dict())
    return models


def phase_flat_vs_plain_step(dev):
    from lmnet_tpu_torch.models.blocks import NeighborhoodAttention2D

    # float32 at 64^2, B=2, TF32 off: the loss and every gradient. Both
    # models start from the same weights and draw the same dropout masks
    # (generators seeded alike); the backends differ in float32 summation
    # order only. Per tensor ||flat - plain|| <= 1e-3 ||plain|| + 1e-5 G,
    # G the largest gradient norm: the floor covers the gradients that are
    # zero in exact arithmetic (the bias of a conv feeding a train-mode BN),
    # float32 noise of ~1e-8 that differs between any two runs (plain
    # against plain differs there as much, and by 5e-7 over all gradients).
    x, y = _batch(2, 64, "val", 3, dev)
    flat, plain = _same_start(dev, 2, (torch.float32, "flat"), (torch.float32, "plain"))
    lf, gf = _one_step(flat, x, y, seed=5)
    lp, gp = _one_step(plain, x, y, seed=5)
    big = max(g.norm().item() for g in gp.values())
    worst = max((gf[k] - gp[k]).norm().item() / (1e-3 * gp[k].norm().item() + 1e-5 * big)
                for k in gp)
    total = (torch.cat([(gf[k] - gp[k]).flatten() for k in gp]).norm()
             / torch.cat([g.flatten() for g in gp.values()]).norm()).item()
    ok = abs(lf - lp) <= 1e-5 * abs(lp) and worst <= 1.0
    print(f"phase 8: train_step fp32 64^2 B=2 flat vs plain: loss {lf:.7f} vs {lp:.7f} "
          f"(tol rel 1e-5); {len(gp)} gradients: worst ||flat-plain|| / (1e-3 ||plain|| + "
          f"1e-5 max||g||) = {worst:.3e} (tol 1), all gradients ||flat-plain||/||plain|| = "
          f"{total:.3e} {'ok' if ok else 'FAIL'}")
    check(ok, "flat and plain NAT disagree on the fp32 train step")

    # bf16 at full width, 256^2, B=16: the loss and the gradients of every
    # NAT layer (qkv, proj, rpb), which the backward kernel produces. bf16
    # moves both backends off the exact step, so each is measured against a
    # float32 plain step from the same weights and dropout masks, and the
    # kernel's step may be off by at most twice as much as the plain one's,
    # plus 1e-4 of the loss or 1e-3 of the gradient's norm.
    x, y = _batch(BATCH, IMG, "val", 4, dev)
    flat, plain, ref = _same_start(dev, 3, (torch.bfloat16, "flat"), (torch.bfloat16, "plain"),
                                   (torch.float32, "plain"))
    nat = [f"{mn}.{pn}" for mn, m in flat.named_modules()
           if isinstance(m, NeighborhoodAttention2D) for pn, _ in m.named_parameters()]
    lf, gf = _one_step(flat, x, y, seed=6)
    lp, gp = _one_step(plain, x, y, seed=6)
    lr, gr = _one_step(ref, x, y, seed=6)
    ok = np.isfinite(lf) and abs(lf - lr) <= 2 * abs(lp - lr) + 1e-4 * abs(lr)
    print(f"phase 8: train_step bf16 {IMG}^2 B={BATCH} flat vs plain: loss {lf:.6f} vs "
          f"{lp:.6f}, fp32 {lr:.6f} (tol |flat-fp32| <= 2 |plain-fp32| + 1e-4 |fp32|) "
          f"{'ok' if ok else 'FAIL'}")
    ratios = {}
    for n in nat:
        ef, ep = (gf[n] - gr[n]).norm().item(), (gp[n] - gr[n]).norm().item()
        ratios[n] = ef / (2 * ep + 1e-3 * gr[n].norm().item())
        fp = ((gf[n] - gp[n]).norm() / gp[n].norm()).item()
        print(f"phase 8:   {n}: ||flat-fp32|| {ef:.3e} ||plain-fp32|| {ep:.3e} "
              f"||fp32|| {gr[n].norm().item():.3e} ||flat-plain||/||plain|| {fp:.3e}")
    worst = max(ratios.values())
    ok = ok and bool(np.isfinite(worst)) and worst <= 1.0
    print(f"phase 8: train_step bf16 {IMG}^2 B={BATCH}: {len(nat)} NAT-layer gradients, worst "
          f"||flat-fp32|| / (2 ||plain-fp32|| + 1e-3 ||fp32||) = {worst:.3e} (tol 1), at "
          f"{max(ratios, key=ratios.get)} {'ok' if ok else 'FAIL'}")
    check(ok, "flat and plain NAT disagree on the bf16 train step")


def _time_steps(state, x, y, n):
    from lmnet_tpu_torch.metrics import ConfusionAccumulator
    from lmnet_tpu_torch.train import train_step

    cm = ConfusionAccumulator.init(2, x.device)

    def step():
        nonlocal state, cm
        state, _, cm = train_step(state, x, y, cm)

    return cuda_ms(step, iters=n, warmup=3)


def phase_train_times(dev, card_line):
    from lmnet_tpu_torch.metrics import ConfusionAccumulator
    from lmnet_tpu_torch.ops.nat_flat import nat_flat, nat_flat_bwd, nat_flat_bwd_plain
    from lmnet_tpu_torch.train import create_train_state, train_step

    k_total = p_total = worst = 0.0
    for i, (H, W, C) in enumerate(STAGES_256):
        q, k, v, rpb = nat_inputs(BATCH, H, W, C, torch.bfloat16, 500 + i, dev)
        g = torch.randn(BATCH, H, W * C, generator=torch.Generator().manual_seed(600 + i))
        g = g.to(dev, torch.bfloat16)
        scale = float(C // HEADS) ** -0.5
        got = nat_flat_bwd(q, k, v, rpb, g, HEADS, C, W, scale)
        worst = max(worst, check_bwd("phase 9", got, q, k, v, rpb, g, BATCH, H, W, C, scale))
        k_ms = cuda_ms(lambda: nat_flat_bwd(q, k, v, rpb, g, HEADS, C, W, scale))
        p_ms = cuda_ms(lambda: nat_flat_bwd_plain(q, k, v, rpb, g, HEADS, C, W, scale))
        k_total += k_ms
        p_total += p_ms
        nbytes = 7 * q.numel() * q.element_size()
        print(f"phase 9: nat_bwd stage H={H} W={W} C={C} hd={C // HEADS} B={BATCH} bf16: "
              f"kernel {k_ms:.4f} ms ({nbytes / k_ms / 1e6:.1f} GB/s of {nbytes / 1e6:.1f} MB "
              f"q,k,v,g in + dq,dk,dv out), plain {p_ms:.4f} ms [{card_line}]")

    x, y = _batch(BATCH, IMG, "val", 7, dev)
    states = {nb: create_train_state(_train_model(dev, nat_backend=nb, seed=4),
                                     (BATCH, IMG, IMG, 3), seed=0)
              for nb in ("flat", "plain")}
    results = {"flat": [], "plain": []}
    n = 10
    for nb in ("plain", "flat", "flat", "plain"):
        nat_flat.launches = nat_flat_bwd.launches = 0
        torch.cuda.reset_peak_memory_stats()
        ms = _time_steps(states[nb], x, y, n)
        peak = torch.cuda.max_memory_allocated() / 2**30
        per_step = (nat_flat.launches / (n + 3), nat_flat_bwd.launches / (n + 3))
        results[nb].append(ms)
        print(f"phase 9: train_step bf16 {IMG}^2 B={BATCH} rc_remat nat {nb}: {ms:.3f} ms/step = "
              f"{BATCH * 1000 / ms:.1f} img/s, peak {peak:.2f} GiB, NAT launches per step "
              f"fwd {per_step[0]:g} bwd {per_step[1]:g} [{card_line}]")

    from torch.profiler import ProfilerActivity, profile

    state, cm, steps = states["flat"], ConfusionAccumulator.init(2, dev), 3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _, cm = train_step(state, x, y, cm)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1000
    nat_ms = sum(e.time_range.elapsed_us() for e in kernels if "nat_" in e.name) / 1000
    print(f"phase 9: profiled {steps} flat train steps: {len(kernels) / steps:.0f} device "
          f"kernels per step, device busy {busy_ms / steps:.3f} ms per step of "
          f"{wall_ms / steps:.3f} ms profiled wall (idle share {1 - busy_ms / wall_ms:.3f} "
          f"under the profiler), NAT kernels {nat_ms / steps:.3f} ms per step [{card_line}]")
    ops = sorted(prof.key_averages(), key=lambda e: e.self_device_time_total, reverse=True)
    for e in ops[:12]:
        print(f"phase 9:   device time by op: {e.self_device_time_total / 1000 / steps:8.3f} ms "
              f"per step, {e.count / steps:5.0f} calls per step  {e.key[:70]}")
    # the per-step path makes no host sync: one more step with CUDA's sync
    # debug mode on records a warning for every synchronising call
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            state, _, cm = train_step(state, x, y, cm)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message) for w in caught if "called a synchronizing" in str(w.message)]
    print(f"phase 9: one train_step under torch.cuda.set_sync_debug_mode('warn'): "
          f"{len(syncs)} host syncs {'ok' if not syncs else syncs[:3]}")
    check(not syncs, "train_step synchronises the host with the device")
    flat_ms = float(np.mean(results["flat"]))
    plain_ms = float(np.mean(results["plain"]))
    print(f"phase 9: train_step mean of two turns: flat {flat_ms:.3f} ms "
          f"({BATCH * 1000 / flat_ms:.1f} img/s), plain {plain_ms:.3f} ms "
          f"({BATCH * 1000 / plain_ms:.1f} img/s) [{card_line}]")
    return k_total, p_total, worst


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
    _build.build("nat_fwd", "nat_bwd")
    for name in ("nat_fwd", "nat_bwd"):
        _build.load(name)
    print(f"phase 2: nat_fwd, nat_bwd built in parallel from {_build.CSRC} -> "
          f"{_build.library_path('nat_fwd').name}, {_build.library_path('nat_bwd').name} "
          f"in {time.perf_counter() - t0:.2f}s")

    worst = phase_kernel_vs_plain(dev)
    model = seeded_model(dev)
    deploy, serve_launches, xb = phase_serving(model, dev)
    k_ms, p_ms, worst_timed = phase_times(deploy, xb, card_line)
    del model, deploy, xb
    worst_bwd = phase_bwd_vs_plain(dev)
    launches = phase_training(dev)
    phase_flat_vs_plain_step(dev)
    kb_ms, pb_ms, worst_bwd_timed = phase_train_times(dev, card_line)

    print(json.dumps({"kernels": [{
        "name": "nat_fwd",
        "route": "cuda",
        "source": "lmnet_tpu_torch/csrc/nat_fwd.cu",
        "replaces": "lmnet_tpu/ops/pallas/nat_flat.py:249",
        "launches": launches["nat_fwd"],
        "launches_by_path": {"training": launches["nat_fwd"], "serving": serve_launches},
        "max_abs_err": max(worst, worst_timed),
        "ms": k_ms,
        "plain_ms": p_ms,
    }, {
        "name": "nat_bwd",
        "route": "cuda",
        "source": "lmnet_tpu_torch/csrc/nat_bwd.cu",
        "replaces": "lmnet_tpu/ops/pallas/nat_flat.py:563",
        "launches": launches["nat_bwd"],
        "max_abs_err": max(worst_bwd, worst_bwd_timed),
        "ms": kb_ms,
        "plain_ms": pb_ms,
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

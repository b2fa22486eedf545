#!/usr/bin/env python3
"""Smoke test of the PyTorch port (lmnet_tpu_torch) on one CUDA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.

Phases, each printing a line, any failure raising (exit code != 0):
  1. the device (nvidia-smi name and power limit, torch and CUDA versions);
  2. build the five kernels (csrc/nat_fwd.cu, nat_bwd.cu, rc_dw_gelu.cu,
     rc_stats.cu, rc_fused.cu) with nvcc for sm_90a, one process per
     source, all started together;
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
     under CUDA's sync debug mode must make no host sync;
 10. the ReparamConv kernels against their plain versions, float32 (TF32
     off for convs and matmuls) and bfloat16: B5 (rc_dw_gelu) and B6
     (rc_stats) at every ReparamConv shape of the 256^2 model (B=2) and of
     the 288^2 training epoch (B=16), B4 (rc_fused) at the five
     (H, Cin, E, Cout) of the 256^2 model (B=2), all three on a 5x5 map, a
     28^2 map with E=20 and a W=7 strip; B5's sums and B6's statistics
     bitwise equal over two calls;
 11. serving at full width, 256^2, B=16, bf16, with rc_backend 'flat',
     'pallas' and 'auto' (serving_evaluate, launches counted; the pair
     'auto' picked and its timing table), each backend's logits against
     'xla' on one batch, deploy_forward times per backend in turns, and B4
     and B5 against their plain versions at the inputs of the 16 blocks of
     a served batch, timed;
 12. training with LMNet(dtype=bf16, rc_remat=True,
     rc_train_backend='fused'): one 'train' epoch at 288^2, B=16 with the
     B5 and B6 launches counted, evaluate; 'fused' against 'xla' on one
     train_step (float32 at 64^2, B=2: the loss, every gradient, all
     running statistics; bf16 at 256^2, B=16: the loss and the gradients
     of every ReparamConv block, each against a float32 'xla' step);
     train_step times for both in three turns each with peak memory, a
     torch.profiler pass over two steps of each (device kernels and busy
     time per step), and B6 against its plain version at the inputs of the
     16 blocks of a training forward, timed.

The script's wall seconds come on a line before the kernels line, which
lists every kernel of the paths as JSON; the line before the last is the
card's name and power limit as nvidia-smi prints them; the last line is
{"ok": true, "device": {...}}.
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
# (B, H, W, Cin, E, Cout) at which phase 10 holds B4 against its plain
# version: the five distinct ReparamConv shapes of the 256^2 model at B=2,
# then a 5x5 map, a 28^2 map with E=20 and a W=7 strip
RC_SHAPES = ([(2, 256, 256, 3, 24, 12), (2, 256, 256, 12, 24, 12), (2, 128, 128, 24, 48, 24),
              (2, 64, 64, 48, 96, 48), (2, 32, 32, 96, 192, 96)]
             + [(2, 5, 5, 24, 48, 24), (2, 28, 28, 12, 20, 12), (2, 32, 7, 24, 48, 24)])
# (B, H, W, E) at which phase 10 holds B5 and B6 against theirs: the
# depthwise shapes of the 256^2 model (B=2), of the 288^2 training epoch
# (B=16), and the small maps above
DW_SHAPES = ([(2, h, w, 2 * c) for h, w, c in STAGES_256]
             + [(BATCH, h, w, 2 * c) for h, w, c in STAGES_288]
             + [(2, 5, 5, 48), (2, 28, 28, 20), (2, 32, 7, 48)])
RC_KERNELS = ("rc_dw_gelu", "rc_stats", "rc_fused")


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


def _train_model(dev, dtype=torch.bfloat16, nat_backend="flat", rc_train_backend="auto", seed=0):
    from lmnet_tpu_torch.models import LMNet

    model = LMNet(generator=torch.Generator().manual_seed(seed), dtype=dtype,
                  nat_backend=nat_backend, rc_remat=True, rc_train_backend=rc_train_backend)
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
    """One model per (compute dtype, NAT backend[, ReparamConv train
    backend]), each with the first one's weights."""
    models = [_train_model(dev, *spec, seed=seed) for spec in specs]
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


def _profile_steps(state, x, y, steps):
    """``steps`` train steps under torch.profiler; returns (state, the device
    kernel events, device busy ms, wall ms, the profiler)."""
    from torch.profiler import ProfilerActivity, profile

    from lmnet_tpu_torch.metrics import ConfusionAccumulator
    from lmnet_tpu_torch.train import train_step

    cm = ConfusionAccumulator.init(2, x.device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _, cm = train_step(state, x, y, cm)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1000
    return state, kernels, busy_ms, wall_ms, prof


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

    steps = 3
    state, kernels, busy_ms, wall_ms, prof = _profile_steps(states["flat"], x, y, steps)
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
    cm = ConfusionAccumulator.init(2, dev)
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


def _dt(dtype) -> str:
    return str(dtype).split(".")[-1]


def check_dw(label, e, k, b, t, sums, C) -> float:
    """Hold B5's (t, sums) against the plain version on e upcast to float32:
    t f32 within 1e-5 (1 + |ref|), bf16 within one rounding of the stored
    value (2^-8 |ref| + 1e-5); each channel sum (both from the float32 t)
    within 1e-5 of the sum of |t| + 1e-6. Print one line; raise on a
    mismatch. Returns the max abs error of t."""
    from lmnet_tpu_torch.ops.rc_flat import dw_gelu_flat_plain

    B, H, WC = e.shape
    ref, ref_sums = dw_gelu_flat_plain(e.float(), k, b, C)
    err = (t.float() - ref).abs()
    bound = 1e-5 * (1 + ref.abs()) if e.dtype == torch.float32 else 2**-8 * ref.abs() + 1e-5
    serr = (sums - ref_sums).abs()
    sbound = 1e-5 * ref.abs().reshape(B, -1, C).sum(1) + 1e-6
    ok = bool((err <= bound).all()) and bool((serr <= sbound).all()) and t.dtype == e.dtype
    print(f"{label}: rc_dw_gelu vs plain B={B} H={H} W={WC // C} C={C} {_dt(e.dtype)}: "
          f"max_abs_err t={err.max().item():.3e} sums={serr.max().item():.3e} "
          f"(tol t {'1e-5*(1+|ref|)' if e.dtype == torch.float32 else '2^-8*|ref| + 1e-5'}, "
          f"sums 1e-5*sum|t| + 1e-6) {'ok' if ok else 'FAIL'}")
    check(ok, f"rc_dw_gelu disagrees with plain at {(B, H, WC // C, C, e.dtype)}")
    return err.max().item()


def check_stats(label, e, ks, got, C) -> float:
    """Hold B6's (4, 2, C) statistics against the plain version on e upcast
    to float32: each within 1e-5 of the matching sum of |y| (or of y^2) +
    1e-6. Print one line; raise on a mismatch. Returns the max abs error."""
    from lmnet_tpu_torch.ops import rc_train

    B, H, WC = e.shape
    ys = rc_train._branch_outputs(e.float(), [k.float() for k in ks], C, torch.float32)
    ref = torch.stack([torch.stack([y.sum(dim=(0, 2, 3)), y.square().sum(dim=(0, 2, 3))])
                       for y in ys])
    scale = torch.stack([torch.stack([y.abs().sum(dim=(0, 2, 3)), y.square().sum(dim=(0, 2, 3))])
                         for y in ys])
    del ys
    err = (got - ref).abs()
    rel = (err / scale.clamp_min(1e-30)).max().item()
    ok = bool((err <= 1e-5 * scale + 1e-6).all()) and got.shape == (4, 2, C)
    print(f"{label}: rc_stats vs plain B={B} H={H} W={WC // C} C={C} {_dt(e.dtype)}: "
          f"max_abs_err={err.max().item():.3e}, max err / sum|y| (or sum y^2) = {rel:.3e} "
          f"(tol 1e-5 + 1e-6 abs) {'ok' if ok else 'FAIL'}")
    check(ok, f"rc_stats disagrees with plain at {(B, H, WC // C, C, e.dtype)}")
    return err.max().item()


def check_rc(label, x, w, got) -> float:
    """Hold B4's output against the plain block on x upcast to float32: f32
    within 1e-4 (1 + max|ref|) (sums of up to 192 + 96 products and the SE
    scale in another order), bf16 within 2^-8 |ref| more (one rounding of
    the store). Print one line; raise on a mismatch. Returns the max abs
    error."""
    from lmnet_tpu_torch.ops.rc_kernel import fused_reparam_conv_plain

    ref = fused_reparam_conv_plain(x.float(), w)
    err = (got.float() - ref).abs()
    bound = 1e-4 * (1 + ref.abs().max())
    if x.dtype == torch.bfloat16:
        bound = bound + 2**-8 * ref.abs()
    ok = bool((err <= bound).all()) and got.shape == ref.shape and got.dtype == x.dtype
    B, H, W, Cin = x.shape
    print(f"{label}: rc_fused vs plain B={B} H={H} W={W} Cin={Cin} E={w['we'].shape[0]} "
          f"Cout={w['wp'].shape[0]} {_dt(x.dtype)}: max_abs_err={err.max().item():.3e} on "
          f"outputs of max {ref.abs().max().item():.3e} (tol 1e-4*(1+max|ref|)"
          f"{' + 2^-8*|ref|' if x.dtype == torch.bfloat16 else ''}) {'ok' if ok else 'FAIL'}")
    check(ok, f"rc_fused disagrees with plain at {(B, H, W, Cin, x.dtype)}")
    return err.max().item()


def rc_weights(seed, Cin, E, Cout, dev):
    """Random ``fold_rc_weights``-shaped float32 weights, fan-in scaled."""
    g = torch.Generator().manual_seed(seed)

    def n(*shape, s=1.0):
        return (torch.randn(*shape, generator=g) * s).to(dev)

    return dict(we=n(E, Cin, s=Cin**-0.5), be=n(E, s=0.1), kdw=n(25, E, s=0.2), bdw=n(E, s=0.1),
                fc1_w=n(E // 4, E, s=E**-0.5), fc1_b=n(E // 4, s=0.1),
                fc2_w=n(E, E // 4, s=(E // 4) ** -0.5), fc2_b=n(E, s=0.1),
                wp=n(Cout, E, s=E**-0.5), bp=n(Cout, s=0.1), wsc=n(Cout, Cin, s=Cin**-0.5),
                bsc=n(Cout, s=0.1))


def branch_inputs(B, H, W, C, dtype, seed, dev):
    g = torch.Generator().manual_seed(seed)
    e = torch.randn(B, H, W * C, generator=g).to(dev, dtype)
    ks = [(torch.randn(C, 1, kh, kw, generator=g) * 0.3).to(dev)
          for kh, kw in ((5, 5), (3, 3), (3, 1), (1, 3))]
    return e, ks


def phase_rc_kernels(dev) -> dict:
    """Phase 10; returns the worst error of each kernel."""
    from lmnet_tpu_torch.ops.rc_flat import dw_gelu_flat
    from lmnet_tpu_torch.ops.rc_kernel import fused_reparam_conv
    from lmnet_tpu_torch.ops.rc_train import rc_branch_stats

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst = {k: 0.0 for k in RC_KERNELS}
    for i, (B, H, W, C) in enumerate(DW_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            e, ks = branch_inputs(B, H, W, C, dtype, 700 + i, dev)
            k = (ks[0] * 0.7).contiguous()
            b = torch.randn(C, generator=torch.Generator().manual_seed(i)).to(dev) * 0.1
            t, sums = dw_gelu_flat(e, k, b, C)
            worst["rc_dw_gelu"] = max(worst["rc_dw_gelu"], check_dw("phase 10", e, k, b, t, sums, C))
            stats = rc_branch_stats(e, *ks, C)
            worst["rc_stats"] = max(worst["rc_stats"], check_stats("phase 10", e, ks, stats, C))
            if B == BATCH and H == STAGES_288[0][0]:
                same = (torch.equal(sums, dw_gelu_flat(e, k, b, C)[1])
                        and torch.equal(stats, rc_branch_stats(e, *ks, C)))
                print(f"phase 10: rc_dw_gelu sums and rc_stats twice on the same inputs "
                      f"B={B} H={H} W={W} C={C} {_dt(dtype)}: bitwise equal: {same}")
                check(same, "rc_dw_gelu or rc_stats is not bitwise repeatable")
            del e, ks, t
    for i, (B, H, W, Cin, E, Cout) in enumerate(RC_SHAPES):
        w = rc_weights(800 + i, Cin, E, Cout, dev)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(B, H, W, Cin, generator=torch.Generator().manual_seed(i)).to(dev, dtype)
            got = fused_reparam_conv(x, w)
            worst["rc_fused"] = max(worst["rc_fused"], check_rc("phase 10", x, w, got))
    return worst


def _capture(module, name, calls):
    """Patch ``module.name`` with a recorder of its arguments that calls the
    original; returns the original."""
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)

    setattr(module, name, spy)
    return real


def phase_rc_serving(model, dev, card_line):
    """Phase 11; returns (serving launches of B5 and B4, B5 and B4 worst
    errors and summed kernel and plain ms at the timed inputs)."""
    from lmnet_tpu_torch.data import SyntheticDataset, make_loader
    from lmnet_tpu_torch.data.augment import eval_pipeline
    from lmnet_tpu_torch.models import structural_reparam
    from lmnet_tpu_torch.ops.nat_flat import nat_flat
    from lmnet_tpu_torch.ops.rc_flat import (
        dw_gelu_flat,
        dw_gelu_flat_plain,
        fold_rc_flat_weights,
    )
    from lmnet_tpu_torch.ops.rc_kernel import (
        fold_rc_weights,
        fused_reparam_conv,
        fused_reparam_conv_plain,
    )
    from lmnet_tpu_torch.serve import deploy_forward, engine, serving_evaluate

    n_images = 32
    n_batches = (n_images + BATCH - 1) // BATCH
    state = model.state_dict()
    deploy = structural_reparam(state)
    launches = {}
    for rc in ("flat", "pallas", "auto"):
        torch.cuda.synchronize()
        nat_flat.launches = dw_gelu_flat.launches = fused_reparam_conv.launches = 0
        t0 = time.perf_counter()
        loss, metrics = serving_evaluate(
            state, make_loader(SyntheticDataset(n_images, IMG, "val", seed=0), BATCH),
            num_classes=2, img_size=IMG, num_heads=HEADS, rc_backend=rc,
        )
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[rc] = {"rc_dw_gelu": dw_gelu_flat.launches,
                        "rc_fused": fused_reparam_conv.launches, "nat_fwd": nat_flat.launches}
        print(f"phase 11: serving_evaluate rc_backend={rc} {n_images} images at {IMG}^2 B={BATCH} "
              f"bf16: loss={loss:.6f} metrics={json.dumps(metrics)} wall={wall:.3f}s launches "
              f"{json.dumps(launches[rc])}")
        check(np.isfinite(loss) and all(np.isfinite(v) for v in metrics.values()),
              f"non-finite loss or metrics with rc_backend={rc}")
    check(launches["flat"] == {"rc_dw_gelu": 16 * n_batches, "rc_fused": 0,
                               "nat_fwd": 4 * n_batches},
          f"rc_backend='flat' launched {launches['flat']}, want rc_dw_gelu 16 x {n_batches}")
    check(launches["pallas"] == {"rc_dw_gelu": 0, "rc_fused": 16 * n_batches,
                                 "nat_fwd": 4 * n_batches},
          f"rc_backend='pallas' launched {launches['pallas']}, want rc_fused 16 x {n_batches}")
    (choice, table), = (v for k, v in engine.AUTOTUNE_CACHE.items() if k[0][1] == IMG)
    print(f"phase 11: rc_backend='auto' picked (rc, nat) = {choice} from "
          + ", ".join(f"{k}: {v * 1000:.3f} ms" for k, v in table.items())
          + f" (CUDA events, warm-up + 8 calls each) [{card_line}]")
    # the sweep runs 'flat' 9 times (warm-up + 8), then the chosen pair serves
    want_b5 = 16 * (9 + (n_batches if choice[0] == "flat" else 0))
    check(launches["auto"]["rc_dw_gelu"] == want_b5,
          f"rc_backend='auto' launched rc_dw_gelu {launches['auto']['rc_dw_gelu']}, want {want_b5}")

    images, masks = next(iter(make_loader(SyntheticDataset(BATCH, IMG, "val", seed=0), BATCH)))
    xb, _ = eval_pipeline(torch.from_numpy(images).to(dev), torch.from_numpy(masks).to(dev), IMG)
    xb = xb.to(torch.bfloat16)
    with torch.inference_mode():
        ref = deploy_forward(deploy, xb, num_heads=HEADS, rc_backend="xla")
        for rc in ("flat", "pallas"):
            out = deploy_forward(deploy, xb, num_heads=HEADS, rc_backend=rc)
            scale = ref.abs().max().item()
            err = (out - ref).abs().max().item()
            flips = (out.argmax(-1) != ref.argmax(-1)).float().mean().item()
            ok = (out.shape == ref.shape and bool(torch.isfinite(out).all())
                  and err <= 0.05 * max(scale, 1.0) and flips < 0.025)
            print(f"phase 11: deploy_forward bf16 {IMG}^2 B={BATCH} rc {rc} vs xla: "
                  f"max_abs_diff={err:.3e} on logits of max {scale:.3e}, argmax flips={flips:.4%} "
                  f"(tol 0.05 x max(scale, 1), flips < 2.5%) {'ok' if ok else 'FAIL'}")
            check(ok, f"rc_backend={rc} disagrees with xla on the served batch")
        times = {"xla": [], "flat": [], "pallas": []}
        for rc in ("xla", "flat", "pallas", "pallas", "flat", "xla"):
            times[rc].append(cuda_ms(lambda: deploy_forward(deploy, xb, num_heads=HEADS,
                                                            rc_backend=rc), iters=10))
    print("phase 11: deploy_forward bf16 256^2 B=16 by rc_backend, turns xla, flat, pallas, "
          "pallas, flat, xla: " + "; ".join(
              f"{rc} {' / '.join(f'{t:.3f}' for t in ts)} ms = "
              f"{BATCH * 1000 / float(np.mean(ts)):.1f} img/s" for rc, ts in times.items())
          + f" [{card_line}]")

    # B4 and B5 against their plain versions at the inputs of the 16 blocks
    calls = []
    real = _capture(engine, "_rc", calls)
    try:
        with torch.inference_mode():
            deploy_forward(deploy, xb, num_heads=HEADS, rc_backend="xla")
    finally:
        engine._rc = real
    check(len(calls) == 16, f"captured {len(calls)} ReparamConv inputs, want 16")
    res = {"rc_dw_gelu": [0.0, 0.0, 0.0], "rc_fused": [0.0, 0.0, 0.0]}  # err, ms, plain ms
    with torch.inference_mode():
        for sd, name, h, _ in calls:
            w = fold_rc_weights(sd, name)
            got = fused_reparam_conv(h, w)
            res["rc_fused"][0] = max(res["rc_fused"][0], check_rc("phase 11", h, w, got))
            res["rc_fused"][1] += cuda_ms(lambda: fused_reparam_conv(h, w))
            res["rc_fused"][2] += cuda_ms(lambda: fused_reparam_conv_plain(h, w))
            fw = fold_rc_flat_weights(sd, name)
            B, H, W, _ = h.shape
            E = fw["we"].shape[0]
            e = torch.nn.functional.hardswish(torch.nn.functional.linear(
                h, fw["we"].to(h.dtype), fw["be"].to(h.dtype))).reshape(B, H, W * E)
            t, sums = dw_gelu_flat(e, fw["kd"], fw["bdw"], E)
            res["rc_dw_gelu"][0] = max(res["rc_dw_gelu"][0],
                                       check_dw("phase 11", e, fw["kd"], fw["bdw"], t, sums, E))
            res["rc_dw_gelu"][1] += cuda_ms(lambda: dw_gelu_flat(e, fw["kd"], fw["bdw"], E))
            res["rc_dw_gelu"][2] += cuda_ms(lambda: dw_gelu_flat_plain(e, fw["kd"], fw["bdw"], E))
    for k, (_, ms, pms) in res.items():
        print(f"phase 11: {k} over the 16 ReparamConv blocks of a served batch (256^2, B=16, "
              f"bf16): kernel {ms:.4f} ms, plain {pms:.4f} ms [{card_line}]")
    serve_launches = {"rc_dw_gelu": launches["flat"]["rc_dw_gelu"],
                      "rc_fused": launches["pallas"]["rc_fused"]}
    return serve_launches, res


def phase_rc_training(dev, card_line):
    """Phase 12; returns (training launches of B5 and B6, B6's worst error
    and summed kernel and plain ms at the timed inputs)."""
    from lmnet_tpu_torch.data import SyntheticDataset, make_loader
    from lmnet_tpu_torch.models import blocks
    from lmnet_tpu_torch.ops.rc_flat import dw_gelu_flat
    from lmnet_tpu_torch.ops.rc_train import rc_branch_stats, rc_branch_stats_plain
    from lmnet_tpu_torch.train import create_train_state, evaluate, train_one_epoch

    n_images = 32
    steps = (n_images + BATCH - 1) // BATCH
    load = IMG * 9 // 8
    state = create_train_state(_train_model(dev, rc_train_backend="fused"),
                               (BATCH, load, load, 3), seed=0, epochs=10, steps_per_epoch=steps)
    torch.cuda.synchronize()
    dw_gelu_flat.launches = rc_branch_stats.launches = 0
    t0 = time.perf_counter()
    state, total, metrics = train_one_epoch(
        state, make_loader(SyntheticDataset(n_images, IMG, "train", seed=0), BATCH),
        img_size=IMG, augment_on_device=False,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train_launches = {"rc_dw_gelu": dw_gelu_flat.launches, "rc_stats": rc_branch_stats.launches}
    print(f"phase 12: train_one_epoch rc_train_backend=fused {n_images} images ({load}^2, "
          f"B={BATCH}, bf16, rc_remat) {steps} steps: loss={total:.6f} "
          f"metrics={json.dumps(metrics)} wall={wall:.3f}s launches {json.dumps(train_launches)}")
    check(np.isfinite(total) and all(np.isfinite(v) for v in metrics.values()),
          "non-finite fused training loss or metrics")
    # 16 blocks, each run forward and again in the checkpoint's recompute
    want = {"rc_dw_gelu": 2 * 16 * steps, "rc_stats": 2 * 16 * steps}
    check(train_launches == want, f"fused training launched {train_launches}, want {want}")
    dw_gelu_flat.launches = rc_branch_stats.launches = 0
    loss, vmetrics = evaluate(state, make_loader(SyntheticDataset(n_images, IMG, "val", seed=1),
                                                 BATCH), img_size=IMG)
    torch.cuda.synchronize()
    eval_launches = {"rc_dw_gelu": dw_gelu_flat.launches, "rc_stats": rc_branch_stats.launches}
    print(f"phase 12: evaluate {n_images} images at {IMG}^2: ce_loss={loss:.6f} "
          f"metrics={json.dumps(vmetrics)} launches {json.dumps(eval_launches)}")
    check(np.isfinite(loss) and eval_launches == {"rc_dw_gelu": 0, "rc_stats": 0},
          f"evaluate gave {loss} and launched {eval_launches}, want no ReparamConv kernel")
    del state

    # float32 at 64^2, B=2, TF32 off: the loss, every gradient and every
    # running statistic. 'fused' folds the batch statistics into one conv
    # and 'xla' sums four; in float32 they differ in rounding only. Bounds
    # as phase 8: loss rel 1e-5, each gradient ||fused - xla|| <= 1e-3
    # ||xla|| + 1e-5 G; each running statistic 1e-4 |xla| + 1e-5 max|xla|.
    x, y = _batch(2, 64, "val", 3, dev)
    fused, xla = _same_start(dev, 2, (torch.float32, "flat", "fused"),
                             (torch.float32, "flat", "xla"))
    lf, gf = _one_step(fused, x, y, seed=5)
    lx, gx = _one_step(xla, x, y, seed=5)
    big = max(g.norm().item() for g in gx.values())
    worst = max((gf[k] - gx[k]).norm().item() / (1e-3 * gx[k].norm().item() + 1e-5 * big)
                for k in gx)
    sf, sx = fused.state_dict(), xla.state_dict()
    stat_keys = [k for k in sx if "running" in k]
    stat_worst = max(((sf[k] - sx[k]).abs() / (1e-4 * sx[k].abs() + 1e-5 * sx[k].abs().max()))
                     .max().item() for k in stat_keys)
    ok = abs(lf - lx) <= 1e-5 * abs(lx) and worst <= 1.0 and stat_worst <= 1.0
    print(f"phase 12: train_step fp32 64^2 B=2 rc fused vs xla: loss {lf:.7f} vs {lx:.7f} "
          f"(tol rel 1e-5); {len(gx)} gradients: worst ||fused-xla|| / (1e-3 ||xla|| + 1e-5 "
          f"max||g||) = {worst:.3e} (tol 1); {len(stat_keys)} running statistics: worst "
          f"|fused-xla| / (1e-4 |xla| + 1e-5 max|xla|) = {stat_worst:.3e} (tol 1) "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "fused and xla ReparamConv disagree on the fp32 train step")
    del fused, xla

    # bf16 at full width, 256^2, B=16: the loss and the gradients of every
    # ReparamConv block (its 24 parameters as one vector), each backend
    # measured against a float32 'xla' step from the same weights; 'fused'
    # may be off by at most twice as much as 'xla', plus 1e-4 of the loss or
    # 1e-3 of the block gradient's norm. Per block, not per parameter: a few
    # single gradients are mostly bf16 noise (the first block's expand
    # weight is 14 % off float32 in 'xla' itself), and there the ratio of
    # two noise draws spreads past 2 while the block's does not.
    x, y = _batch(BATCH, IMG, "val", 4, dev)
    fused, xla, ref = _same_start(dev, 3, (torch.bfloat16, "flat", "fused"),
                                  (torch.bfloat16, "flat", "xla"), (torch.float32, "flat", "xla"))
    rc_blocks = {mn: [f"{mn}.{pn}" for pn, _ in m.named_parameters()]
                 for mn, m in fused.named_modules() if isinstance(m, blocks.ReparamConv)}
    lf, gf = _one_step(fused, x, y, seed=6)
    lx, gx = _one_step(xla, x, y, seed=6)
    lr, gr = _one_step(ref, x, y, seed=6)
    del fused, xla, ref
    ok = np.isfinite(lf) and abs(lf - lr) <= 2 * abs(lx - lr) + 1e-4 * abs(lr)
    print(f"phase 12: train_step bf16 {IMG}^2 B={BATCH} rc fused vs xla: loss {lf:.6f} vs "
          f"{lx:.6f}, fp32 {lr:.6f} (tol |fused-fp32| <= 2 |xla-fp32| + 1e-4 |fp32|) "
          f"{'ok' if ok else 'FAIL'}")

    def dist(g, names):
        return sum((g[n] - gr[n]).square().sum().item() for n in names) ** 0.5

    def norm(names):
        return sum(gr[n].square().sum().item() for n in names) ** 0.5

    ratios, rel = {}, {}
    for mn, names in rc_blocks.items():
        df, dx = dist(gf, names), dist(gx, names)
        ratios[mn] = df / (2 * dx + 1e-3 * norm(names))
        rel[mn] = (df / norm(names), dx / norm(names))
    names = [n for ns in rc_blocks.values() for n in ns]
    per_param = [(gf[n] - gr[n]).norm().item() / max((gx[n] - gr[n]).norm().item(), 1e-30)
                 for n in names]
    worst = max(ratios.values())
    ok = ok and bool(np.isfinite(worst)) and worst <= 1.0
    print(f"phase 12: train_step bf16 {IMG}^2 B={BATCH}: {len(rc_blocks)} ReparamConv blocks "
          f"({len(names)} gradients), ||g-fp32|| / ||fp32|| per block fused "
          f"{min(r[0] for r in rel.values()):.4f}-{max(r[0] for r in rel.values()):.4f}, xla "
          f"{min(r[1] for r in rel.values()):.4f}-{max(r[1] for r in rel.values()):.4f}; all "
          f"ReparamConv gradients fused {dist(gf, names) / norm(names):.4f} xla "
          f"{dist(gx, names) / norm(names):.4f}; worst ||fused-fp32|| / "
          f"(2 ||xla-fp32|| + 1e-3 ||fp32||) = {worst:.3e} (tol 1), at {max(ratios, key=ratios.get)}; "
          f"per parameter ||fused-fp32|| / ||xla-fp32|| median {float(np.median(per_param)):.3f}, "
          f"max {max(per_param):.3f} (not bounded) {'ok' if ok else 'FAIL'}")
    check(ok, "fused and xla ReparamConv disagree on the bf16 train step")

    # train_step times in turns, then B6 at the inputs of a training forward
    x, y = _batch(BATCH, IMG, "val", 7, dev)
    states = {rb: create_train_state(_train_model(dev, rc_train_backend=rb, seed=4),
                                     (BATCH, IMG, IMG, 3), seed=0) for rb in ("xla", "fused")}
    results = {"xla": [], "fused": []}
    n = 10
    # three turns each: steps of one call vary by up to 20 % between turns
    for rb in ("xla", "fused", "fused", "xla", "xla", "fused"):
        dw_gelu_flat.launches = rc_branch_stats.launches = 0
        torch.cuda.reset_peak_memory_stats()
        ms = _time_steps(states[rb], x, y, n)
        peak = torch.cuda.max_memory_allocated() / 2**30
        results[rb].append(ms)
        print(f"phase 12: train_step bf16 {IMG}^2 B={BATCH} rc_remat rc_train_backend {rb}: "
              f"{ms:.3f} ms/step = {BATCH * 1000 / ms:.1f} img/s, peak {peak:.2f} GiB, B5/B6 "
              f"launches per step {dw_gelu_flat.launches / (n + 3):g}/"
              f"{rc_branch_stats.launches / (n + 3):g} [{card_line}]")
    print(f"phase 12: train_step over three turns each: fused mean "
          f"{np.mean(results['fused']):.3f} ms (min {min(results['fused']):.3f}), xla mean "
          f"{np.mean(results['xla']):.3f} ms (min {min(results['xla']):.3f}) [{card_line}]")
    for rb in ("xla", "fused"):
        steps = 2
        states[rb], kernels, busy_ms, wall_ms, _ = _profile_steps(states[rb], x, y, steps)
        rc_ms = sum(e.time_range.elapsed_us() for e in kernels
                    if "rc_stats" in e.name or "dw_gelu" in e.name) / 1000
        print(f"phase 12: profiled {steps} train steps, rc_train_backend {rb}: "
              f"{len(kernels) / steps:.0f} device kernels per step, device busy "
              f"{busy_ms / steps:.3f} ms per step of {wall_ms / steps:.3f} ms profiled wall, "
              f"B5 + B6 kernels {rc_ms / steps:.3f} ms per step [{card_line}]")

    calls = []
    real = _capture(blocks, "rc_branch_act", calls)
    try:
        with torch.no_grad():
            states["fused"].model(x.to(torch.bfloat16), train=True, deterministic=True)
    finally:
        blocks.rc_branch_act = real
    del states
    check(len(calls) == 16, f"captured {len(calls)} fused ReparamConv inputs, want 16")
    err = ms = pms = 0.0
    with torch.no_grad():
        for e, k5, k3, kv, kh, *_, C, _eps in calls:
            ks = [k5, k3, kv, kh]
            got = rc_branch_stats(e, *ks, C)
            err = max(err, check_stats("phase 12", e, ks, got, C))
            ms += cuda_ms(lambda: rc_branch_stats(e, *ks, C))
            pms += cuda_ms(lambda: rc_branch_stats_plain(e, *ks, C))
    print(f"phase 12: rc_stats over the 16 ReparamConv blocks of a training forward (256^2, "
          f"B=16, bf16): kernel {ms:.4f} ms, plain {pms:.4f} ms [{card_line}]")
    return train_launches, (err, ms, pms)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card", file=sys.stderr)
        return 1
    from lmnet_tpu_torch.ops import _build

    card_line = card()
    dev = torch.device("cuda")
    print(f"phase 1: device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} "
          f"[{card_line}] torch {torch.__version__} cuda {torch.version.cuda}")

    t_start = t0 = time.perf_counter()
    names = ("nat_fwd", "nat_bwd", *RC_KERNELS)
    _build.build(*names)
    for name in names:
        _build.load(name)
    print(f"phase 2: {', '.join(names)} built in parallel from {_build.CSRC} -> "
          f"{', '.join(_build.library_path(n).name for n in names)} "
          f"in {time.perf_counter() - t0:.2f}s")

    worst = phase_kernel_vs_plain(dev)
    model = seeded_model(dev)
    deploy, serve_launches, xb = phase_serving(model, dev)
    k_ms, p_ms, worst_timed = phase_times(deploy, xb, card_line)
    del deploy, xb
    worst_bwd = phase_bwd_vs_plain(dev)
    launches = phase_training(dev)
    phase_flat_vs_plain_step(dev)
    kb_ms, pb_ms, worst_bwd_timed = phase_train_times(dev, card_line)
    worst_rc = phase_rc_kernels(dev)
    rc_serve_launches, rc_timed = phase_rc_serving(model, dev, card_line)
    del model
    rc_train_launches, stats_timed = phase_rc_training(dev, card_line)

    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s wall")
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
    }, {
        "name": "rc_fused",
        "route": "cuda",
        "source": "lmnet_tpu_torch/csrc/rc_fused.cu",
        "replaces": "lmnet_tpu/ops/pallas/rc_kernel.py:145",
        "launches": rc_serve_launches["rc_fused"],
        "max_abs_err": max(worst_rc["rc_fused"], rc_timed["rc_fused"][0]),
        "ms": rc_timed["rc_fused"][1],
        "plain_ms": rc_timed["rc_fused"][2],
    }, {
        "name": "rc_dw_gelu",
        "route": "cuda",
        "source": "lmnet_tpu_torch/csrc/rc_dw_gelu.cu",
        "replaces": "lmnet_tpu/ops/pallas/rc_flat.py:119",
        "launches": rc_serve_launches["rc_dw_gelu"] + rc_train_launches["rc_dw_gelu"],
        "launches_by_path": {"serving": rc_serve_launches["rc_dw_gelu"],
                             "training": rc_train_launches["rc_dw_gelu"]},
        "max_abs_err": max(worst_rc["rc_dw_gelu"], rc_timed["rc_dw_gelu"][0]),
        "ms": rc_timed["rc_dw_gelu"][1],
        "plain_ms": rc_timed["rc_dw_gelu"][2],
    }, {
        "name": "rc_stats",
        "route": "cuda",
        "source": "lmnet_tpu_torch/csrc/rc_stats.cu",
        "replaces": "lmnet_tpu/ops/pallas/rc_train.py:140",
        "launches": rc_train_launches["rc_stats"],
        "max_abs_err": max(worst_rc["rc_stats"], stats_timed[0]),
        "ms": stats_timed[1],
        "plain_ms": stats_timed[2],
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

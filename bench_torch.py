"""Benchmark of the PyTorch port (lmnet_tpu_torch) on one CUDA card: the
protocol of ``bench.py``, JAX's benchmark, run through the port.

Run from the repository root on a machine with a card:
``python3 bench_torch.py``. It builds the NAT kernels it launches (B1,
``csrc/nat_fwd.cu``; B2, ``csrc/nat_bwd.cu``) at their first use, then
prints one line for each configuration (ms a chain step, min / median / max
over the reps, by the host clock and by CUDA events; peak device memory; B1
and B2 launches; the card's name and power limit) and, as its last line,
one JSON object with ``bench.py``'s seven keys and ``device``, the card's
name and power limit.

The protocol (``bench.py``):
  * serving: ``LMNet(num_classes=2)`` from a seeded generator, reparameterised
    (``structural_reparam``), served by ``deploy_forward(nat_backend='flat')``
    with the default 'xla' ReparamConv and 'einsum' upsample, bf16 ones
    images at 256^2, B=128; then 384^2 and 512^2 at B=128;
  * training: ``LMNet(num_classes=2, dtype=bf16)`` (``rc_remat=True``,
    'flat' NAT), AdamW over 200 epochs of 100 steps, float32 ones images and
    zero labels at 256^2, B=128, a fresh confusion matrix each step;
  * a chain of ITERS calls, each fed ``x + acc * 1e-20`` with the scalar
    ``acc`` (the sum of the logits, or of the losses) kept on the device,
    and one scalar read by the host at its end; one untimed chain warms up;
    the rate is batch x ITERS over the chain's seconds by the host clock,
    the best of REPS chains (2 at 384^2 and 512^2).

The chains run eagerly, one launch at a time: CUDA graphs of the forward
and of the train step are later work. ``bench.py`` subtracts a round trip
to its remote TPU from each chain; here the card is local and nothing is
subtracted.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import torch

# Documented assumption (BASELINE.md, as in bench.py): PyTorch LM-Net (4.7M
# params, NATTEN CUDA op at 256^2 with head_dim 1-8, fp16) single-A100
# inference estimate at 256x256. An estimate, not a measurement: the
# reference publishes no numbers. vs_baseline is kept so that the keys match
# bench.py's.
A100_EST_IMG_S = 1500.0

BATCH = 128  # bench.py's serving batch, at every size
TRAIN_BATCH = 128
ITERS = 10
REPS = 3
SIZE = 256
LARGE_SIZES = (384, 512)
LARGE_REPS = 2  # bench.py's reps at 384^2 and 512^2


def card_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them, or 'cpu'."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def serving_model(device, seed: int = 0) -> dict:
    """The reparameterised deploy weights of ``LMNet(num_classes=2)`` drawn
    from a generator seeded ``seed``, on ``device``."""
    from lmnet_tpu_torch.models import LMNet, structural_reparam

    model = LMNet(num_classes=2, generator=torch.Generator().manual_seed(seed))
    return structural_reparam(model.to(device).eval().state_dict())


def training_state(device, seed: int = 0):
    """The train state of ``LMNet(num_classes=2, dtype=bf16)`` drawn from a
    generator seeded ``seed``: AdamW scheduled over 200 epochs of 100
    steps, the dropout generator seeded ``seed``."""
    from lmnet_tpu_torch.models import LMNet
    from lmnet_tpu_torch.train import create_train_state

    model = LMNet(num_classes=2, dtype=torch.bfloat16,
                  generator=torch.Generator().manual_seed(seed))
    return create_train_state(model, (1, 64, 64, 3), seed=seed, device=device,
                              epochs=200, steps_per_epoch=100)


def _launches() -> dict:
    from lmnet_tpu_torch.ops.nat_flat import nat_flat, nat_flat_bwd

    return {"nat_fwd": nat_flat.launches, "nat_bwd": nat_flat_bwd.launches}


def _chain(call, x: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` calls, each fed ``x + acc * 1e-20``; ``acc`` sums the
    scalars they return, on the device."""
    acc = torch.zeros((), device=x.device)
    for _ in range(iters):
        acc = acc + call(x + acc.to(x.dtype) * 1e-20)
    return acc


def _measure(call, x: torch.Tensor, batch: int, iters: int, reps: int) -> dict:
    """One untimed chain, then ``reps`` timed ones. Returns the best rate
    (img/s by the host clock), ms a chain step by the host clock and by
    CUDA events (min, median, max over the reps), the last chain's
    accumulator, the peak device memory in GiB and the B1 and B2 launches
    of all the chains."""
    cuda = x.device.type == "cuda"
    before = _launches()
    if cuda:
        torch.cuda.synchronize(x.device)
        torch.cuda.reset_peak_memory_stats(x.device)
    float(_chain(call, x, iters))
    host, events, acc = [], [], None
    for _ in range(reps):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        out = _chain(call, x, iters)
        if cuda:
            end.record()
        acc = float(out)  # the host reads one scalar, which waits for the chain
        host.append((time.perf_counter() - t0) * 1e3 / iters)
        if cuda:
            events.append(start.elapsed_time(end) / iters)
    after = _launches()

    def spread(ms):
        return [min(ms), statistics.median(ms), max(ms)] if ms else None

    return {"img_s": batch * 1e3 / min(host), "ms_step": spread(host),
            "event_ms_step": spread(events), "acc": acc, "reps": reps,
            "peak_gib": torch.cuda.max_memory_allocated(x.device) / 2**30 if cuda else None,
            "launches": {k: after[k] - before[k] for k in after}}


def serve_rate(deploy: dict, size: int, batch: int, iters: int, reps: int, device,
               dtype: torch.dtype = torch.bfloat16) -> dict:
    """Serving rate of the deploy weights ``deploy`` on ones images of
    ``size``^2 in ``dtype`` (bf16 as bench.py), B=``batch``, through
    ``deploy_forward(nat_backend='flat')``; see ``_measure`` for what it
    returns. The head count is read from the weights."""
    from lmnet_tpu_torch.serve import deploy_forward

    heads = deploy["natt1.att1.rpb"].shape[0]
    x = torch.ones((batch, size, size, 3), dtype=dtype, device=device)

    def call(xi):
        return deploy_forward(deploy, xi, num_heads=heads, nat_backend="flat").sum()

    with torch.inference_mode():
        return _measure(call, x, batch, iters, reps)


def train_rate(state, size: int, batch: int, iters: int, reps: int, device) -> dict:
    """Training rate of ``state`` (updated in place) on float32 ones images
    of ``size``^2 and zero labels, B=``batch``: ``train_step`` with a fresh
    confusion matrix each step, the chain summing the losses; see
    ``_measure``. The steps of the reps continue one run (bench.py restarts
    each rep from one state), which leaves the time of a step as it is; the
    ``acc * 1e-20`` added to the ones rounds away in float32, as bench.py's
    training chain feeds ``x`` itself."""
    from lmnet_tpu_torch.metrics import ConfusionAccumulator
    from lmnet_tpu_torch.train import train_step

    x = torch.ones((batch, size, size, 3), dtype=torch.float32, device=device)
    y = torch.zeros((batch, size, size), dtype=torch.int32, device=device)
    cm0 = ConfusionAccumulator.init(2, device)

    def call(xi):
        return train_step(state, xi, y, cm0)[1]

    return _measure(call, x, batch, iters, reps)


def run(device) -> dict:
    """The protocol in bench.py's order: serving at SIZE, training at SIZE,
    serving at each of LARGE_SIZES. Returns each configuration's
    ``_measure`` result by name."""
    deploy = serving_model(device)
    out = {f"serve_{SIZE}": serve_rate(deploy, SIZE, BATCH, ITERS, REPS, device)}
    out[f"train_{SIZE}"] = train_rate(training_state(device), SIZE, TRAIN_BATCH, ITERS, REPS,
                                      device)
    for size in LARGE_SIZES:
        out[f"serve_{size}"] = serve_rate(deploy, size, BATCH, ITERS, LARGE_REPS, device)
    return out


def summary(results: dict, device_line: str) -> dict:
    """bench.py's seven keys from ``run``'s results, and ``device``."""
    best = results[f"serve_{SIZE}"]["img_s"]
    return {
        "metric": f"inference images/sec/card @{SIZE}x{SIZE} bf16 (batch {BATCH}, serving "
                  "engine, flat-layout NAT)",
        "value": round(best, 1),
        "unit": "img/s",
        "vs_baseline": round(best / A100_EST_IMG_S, 3),
        "train_img_s": round(results[f"train_{SIZE}"]["img_s"], 1),
        **{f"img_s_{s}": round(results[f"serve_{s}"]["img_s"], 1) for s in LARGE_SIZES},
        "device": device_line,
    }


def config_line(name: str, r: dict, batch: int, device_line: str) -> str:
    """One configuration's numbers on a line."""

    def ms(v):
        return "n/a" if v is None else "/".join(f"{t:.3f}" for t in v)

    peak = "n/a" if r["peak_gib"] is None else f"{r['peak_gib']:.2f} GiB"
    return (f"bench_torch: {name} B={batch}: {r['img_s']:.1f} img/s; ms a chain step "
            f"min/median/max over {r['reps']} reps: host {ms(r['ms_step'])}, CUDA events "
            f"{ms(r['event_ms_step'])}; peak {peak}; launches B1 {r['launches']['nat_fwd']} "
            f"B2 {r['launches']['nat_bwd']} [{device_line}]")


def main(device="cuda") -> dict:
    """Run the protocol on ``device`` (the card unless the caller asks for
    the CPU) and print its lines; returns the summary. Raises without a
    card: a device number is never taken on the CPU by default."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench_torch: no CUDA device; the benchmark runs on the card "
                           "(pass device='cpu' to run the protocol on the CPU)")
    line = card_line(device)
    results = run(device)
    for name, r in results.items():
        print(config_line(name, r, TRAIN_BATCH if name.startswith("train") else BATCH, line))
    out = summary(results, line)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

"""The controls of the correctness check: the reference put in the
program's place in a lower precision, and (training) the reference with a
planted fault, each held against the float32 reference by the cell's own
comparison at the cell's own sizes. They set the upper readings that the
limits in ``workloads/<cell>.json`` lie below; the benchmark's runs do not
run them.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 [--kinds fp8,half]

on a machine with a card (``--device cpu`` runs them on the CPU). Prints
one JSON line a seed and kind: the cell's compared numbers.

* ``fp8``: the reference with every weight and activation rounded to
  float8 e4m3 with a per-tensor scale (``lmbench.check.fp8_round``), the
  precision below the configuration's bf16.
* ``half`` (training): the reference's loss taken over the first half of
  each batch alone, the dropout masks drawn for the whole batch.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE)]

import torch  # noqa: E402

import arch  # noqa: E402
from lmbench import check, inputs  # noqa: E402


def serve_control(config: dict, traffic: dict, seed: int, device) -> dict:
    """logit_err of the fp8 reference on as many pool images as a serving
    run checks (two rows of ``check_batches`` batches)."""
    s = inputs.seeds(seed)
    n = 2 * traffic["check_batches"]
    x, _ = inputs.images_and_masks(n, config["image_size"], inputs.generator(s["data"], device),
                                   device, torch.bfloat16, config["model"]["num_classes"])
    A = arch.load(config)
    raw = arch.weights(config, s["weights"], device)
    ref = check.reference_logits(A.reference(config, raw), x)
    low = check.reference_logits(A.reference(config, raw, q=check.fp8_round), x)
    return {"logit_err": check.logit_err(low, ref)}


def open_loop_control(config: dict, traffic: dict, seed: int, device) -> dict:
    """mask_gap of the fp8 reference's masks on the pool's images, the head
    centred as a run centres it."""
    from lmbench.cells import centre_margin

    s = inputs.seeds(seed)
    A = arch.load(config)
    raw = arch.weights(config, s["weights"], device)
    x, _ = inputs.images_and_masks(traffic["pool_images"], config["image_size"],
                                   inputs.generator(s["data"], device), device,
                                   classes=config["model"]["num_classes"])
    centre_margin(config, raw, x[:2])
    ref = check.reference_logits(A.reference(config, raw), x)
    low = check.reference_logits(A.reference(config, raw, q=check.fp8_round), x)
    return {"mask_gap": check.mask_gap(low.argmax(dim=-1), ref, check.margin_rms(ref))}


def train_control(config: dict, traffic: dict, seed: int, device, kinds) -> dict:
    """The training numbers of the fp8 reference and of the half-batch
    fault (``kinds``) against the float32 reference over the checked
    steps; kind -> numbers."""
    s = inputs.seeds(seed)
    A = arch.load(config)
    B, size = traffic["batch"], config["image_size"]
    xs, ys = inputs.pool(traffic["check_steps"], B, size, s["data"], device, torch.float32,
                         config["model"]["num_classes"])
    batches = list(zip(xs, ys))

    def steps(q=None, rows=slice(None)):
        with check.exact_fp32():
            losses, g, st = A.train_steps(
                config, traffic, arch.weights(config, s["weights"], device), batches,
                inputs.generator(s["dropout"], device), q=q, batch_slice=rows)
        return {"losses": losses, "grad1": g, "state": st}

    ref = steps()
    out = {}
    for kind in kinds:
        low = steps(q=check.fp8_round) if kind == "fp8" else steps(rows=slice(0, B // 2))
        nums = check.train_numbers(arch.weights(config, s["weights"], device), low, ref)
        out[kind] = {k: v[0] for k, v in nums.items() if not k.startswith("_")}
        del low
    return out


def control(cell: dict, seed: int, device, kinds=("fp8",)) -> dict:
    """kind -> the cell's compared numbers for each of ``kinds`` ('fp8'
    for every cell, 'half' for a training cell)."""
    config, traffic = cell["config"], cell["traffic"]
    if traffic["kind"] == "train":
        return train_control(config, traffic, seed, device, kinds)
    if kinds != ("fp8",):
        raise ValueError("the 'half' fault is a training cell's")
    fn = serve_control if traffic["kind"] == "serve" else open_loop_control
    return {"fp8": fn(config, traffic, seed, device)}


def main(argv=None) -> int:
    from run import load_cell

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--kinds", default="fp8", help="fp8 and, for a training cell, half")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE.parent))
    cell = load_cell(args.workload)
    device = torch.device(args.device)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        out = control(cell, seed, device, tuple(args.kinds.split(",")))
        for kind, nums in out.items():
            print(json.dumps({"workload": args.workload, "kind": kind, "seed": seed, **nums,
                              "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

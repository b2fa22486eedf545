"""Run one cell of the benchmark of lmnet_tpu_torch once, on this machine's
CUDA cards, and print its result as one JSON line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. ``BENCHMARK.json`` names the cell's model
configuration (``benchmark/configs/<config>.json``) and traffic
(``benchmark/traffic/<traffic>.json``, whose ``kind`` picks the window:
``lmbench/cells.py``); ``benchmark/workloads/<cell>.json`` holds the
limits of its correctness check; ``benchmark/metrics/<metric>.py`` reads
each per-layer metric. With ``--trace 0`` the result's metrics are the
cell's end-to-end ones; with ``--trace 1`` the last seconds of the window
run under ``torch.profiler`` and the metrics are the per-layer ones.

Exits 2, printing no result, without as many CUDA cards as the cell asks
for, and 3 if JAX or the JAX package was loaded. The kernels the port
builds go to the checkout's ``build/``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "lmnet_tpu")


def load_cell(name: str) -> dict:
    """The cell ``name`` with its configuration, traffic, limits and
    metrics, as ``BENCHMARK.json`` and the files it names hold them."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json ({', '.join(cells)})")
    w = cells[name]
    conf = next(c for c in spec["configs"] if c["name"] == w["config"])

    def mine(m):
        return name in m.get("workloads", [name])

    e2e = [m for m in spec["end_to_end"] if mine(m)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return {
        "name": name, "chips": w["chips"],
        "config": json.loads((ROOT / conf["file"]).read_text()),
        "traffic": json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text()),
        "limits": json.loads((HERE / "workloads" / f"{name}.json").read_text())["limits"],
        "end_to_end": e2e, "per_layer": per_layer,
    }


def metric_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or
    the JAX package's (compared whole: lmnet_tpu_torch is not lmnet_tpu)."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in BANNED})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)

    # every cache of the run inside the checkout, at fixed paths
    build = ROOT / "build"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(build / sub)
    os.environ.update(cell["traffic"].get("env", {}))
    sys.path[:0] = [str(HERE), str(ROOT)]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: {cell['chips']} CUDA card(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} here",
              file=sys.stderr)
        return 2
    from lmbench import cells

    run = cells.Run(args.workload, cell["config"], cell["traffic"], cell["limits"], args.seed,
                    args.seconds, bool(args.trace), torch.device("cuda", 0), T_START)
    res = cells.DRIVERS[cell["traffic"]["kind"]](run)
    return report(cell, res, args.trace, torch.cuda.get_device_name(0))


def verdict(res) -> bool:
    """``correct``: every compared number finite and within its limit, and
    nothing attempted in the window failed."""
    return res.failed == 0 and all(math.isfinite(v) and v <= lim
                                   for v, lim, _ in res.numbers.values())


def report(cell: dict, res, trace: int, kind: str) -> int:
    """Print the notes and the compared numbers on standard error and the
    result line on standard output; 3 and no result if JAX was loaded."""
    from lmbench import readers

    found = banned_modules()
    if found:
        print(f"benchmark: JAX or the JAX package was loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": kind, "count": cell["chips"],
              "memory_peak_bytes": res.memory_peak}
    out = {}
    if trace:
        ctx = readers.Context(cell["config"], res.window, res.counters, res.trace,
                              cell["traffic"])
        metrics = {}
        for m in cell["per_layer"]:
            value = metric_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if res.trace is not None:
            device.update(busy_s=res.trace.busy_s(), window_s=res.trace.window_s)
            out["breakdown"] = {"device_ops": res.trace.top_ops(10),
                                "idle_gaps": res.trace.idle_by_host(10)}
    else:
        metrics = {m["name"]: {"value": res.e2e[m["name"]], "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    ok = verdict(res)
    for line in res.lines:
        print(f"benchmark: {line}", file=sys.stderr)
    for name, (v, lim, note) in res.numbers.items():
        print(f"check {name} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'} ({note})",
              file=sys.stderr)
    sys.stderr.flush()
    result = {"correct": ok, "attempted": res.attempted, "failed": res.failed,
              "metrics": metrics, "device": device, **out,
              "checks": {n: {"value": v, "limit": lim} for n, (v, lim, _) in res.numbers.items()}}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The benchmark's CPU tests: the harness's modules and the repository root
on the path, and cells cut to a tiny model on the CPU."""

from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {"num_classes": 2, "filters": [4, 8, 12, 16, 24], "num_heads": 2, "nat_kernel": 3,
        "gelu": "tanh"}
# the cells' traffic at sizes the CPU runs in seconds
SMALL = {
    "serve": {"batch": 4, "chain": 2, "trace_seconds": 0.5},
    "train": {"batch": 4, "trace_seconds": 0.5},
    "open_loop": {"rate_rps": 20, "max_batch": 8, "pool_images": 8, "trace_seconds": 0.5},
}


def load(name: str) -> dict:
    """The cell ``name`` as ``run.load_cell`` gives it; a cell whose files
    are here but which ``BENCHMARK.json`` does not list (the open-loop
    batcher, left for later) from its configuration, traffic and limits
    files."""
    import json

    import run as runner

    try:
        return runner.load_cell(name)
    except SystemExit:
        config, traffic = name.split(".", 1)
        return {"name": name, "chips": 1, "end_to_end": [], "per_layer": [],
                "config": json.loads((BENCH / "configs" / f"{config}.json").read_text()),
                "traffic": json.loads((BENCH / "traffic" / f"{traffic}.json").read_text()),
                "limits": json.loads((BENCH / "workloads" / f"{name}.json").read_text())["limits"]}


@pytest.fixture
def tiny_cell():
    """``make(name, size=32, **model)`` -> (cell as ``run.load_cell`` gives
    it, with the tiny model at size^2 and the small traffic; a function
    from (seed, seconds, trace, faults) to its ``cells.Run`` on the CPU)."""
    import torch

    from lmbench import cells

    def make(name, size=32, **model):
        cell = load(name)
        cell["config"] = dict(cell["config"], model=dict(TINY, **model), image_size=size)
        cell["traffic"] = dict(cell["traffic"], **SMALL[cell["traffic"]["kind"]])

        def run(seed=2**31 + 5, seconds=1.0, trace=False, faults=None):
            return cells.Run(name, cell["config"], cell["traffic"], cell["limits"], seed, seconds,
                             trace, torch.device("cpu"), time.perf_counter(), faults or {})

        return cell, run

    return make

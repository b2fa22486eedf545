"""Find the open-loop cell's knee once: the highest rate of requests the
batcher sustains without a growing backlog, by a sweep of fixed rates in
one process.

    python3 benchmark/sweep.py --workload lmnet-256.batcher-open --rates 100,150,200 \\
        --seconds 8 --seed 7

Prints one JSON line a rate: the latency percentiles, the generator's
lateness, the batcher's counters, and the median latency of the last fifth
of the requests over the first fifth's (well above 1 where the queue
grows). The cell's rate is then set at about four fifths of the knee.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE), str(HERE.parent)]
    import numpy as np
    import torch

    import run as runner
    from lmbench import cells, inputs, openloop

    cell = runner.load_cell(args.workload)
    run = cells.Run(args.workload, cell["config"], cell["traffic"], cell["limits"], args.seed,
                    args.seconds, False, torch.device("cuda", 0), time.perf_counter())
    s = inputs.seeds(args.seed)
    _, host, batcher, _ = cells.batcher_setup(run, s)
    try:
        for rate in (float(r) for r in args.rates.split(",")):
            out, _, counters = cells.offer(run, batcher, host, rate, args.seconds, s,
                                           cells.Result())
            lat = out.latencies_ms()
            fifth = max(1, len(lat) // 5)
            growth = float(np.median(lat[-fifth:]) / np.median(lat[:fifth]))
            print(json.dumps({
                "rate_rps": rate,
                "img_s_answered": sum(len(a) for a in out.answers if a is not None) / args.seconds,
                "p50_ms": openloop.percentile(lat, 50), "p95_ms": openloop.percentile(lat, 95),
                "p99_ms": openloop.percentile(lat, 99), "failed": int(out.failed.sum()),
                "late_p50_ms": openloop.percentile(out.lateness_ms(), 50),
                "late_max_ms": float(np.nanmax(out.lateness_ms())),
                "last_over_first_fifth": growth, **counters}), flush=True)
    finally:
        batcher.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())

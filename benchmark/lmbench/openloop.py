"""The open-loop generator: requests sent on a schedule whatever the system
does, each timed from when it was due.

A schedule at ``rate`` requests a second over ``seconds`` holds
N = round(rate x seconds) requests. Every seed gets the same set of gaps
between arrivals (the N stratified quantiles of an exponential of mean
1/rate, scaled to end at ``seconds``) and the same set of sizes (the
``sizes`` in equal shares), in an order drawn from the seed: a Poisson
process's gaps and a uniform size, with the amount of work fixed.
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Schedule:
    due: np.ndarray  # seconds after the start
    sizes: np.ndarray  # images a request


def schedule(rate: float, seconds: float, sizes, seed: int) -> Schedule:
    n = max(1, round(rate * seconds))
    rng = np.random.default_rng(seed)
    q = (np.arange(n) + 0.5) / n
    gaps = rng.permutation(-np.log1p(-q) / rate)
    due = np.cumsum(gaps)
    due *= seconds / due[-1]
    reps = np.resize(np.asarray(sizes, dtype=np.int64), n)
    return Schedule(due, rng.permutation(reps))


@dataclass
class Result:
    due: np.ndarray
    sent: np.ndarray  # seconds after the start, nan where not sent
    done: np.ndarray  # seconds after the start, nan where unanswered
    failed: np.ndarray  # bool: raised, or never answered
    answers: list = field(default_factory=list)  # per request: the answer or None

    def latencies_ms(self) -> np.ndarray:
        """Due-to-done milliseconds; inf for a failed or unanswered one."""
        lat = (self.done - self.due) * 1e3
        return np.where(self.failed | np.isnan(lat), np.inf, lat)

    def lateness_ms(self) -> np.ndarray:
        return (self.sent - self.due) * 1e3


def percentile(values, pct: float) -> float:
    """Nearest-rank percentile: the smallest value with ``pct`` per cent of
    the values at or below it (inf counts as the largest)."""
    v = np.sort(np.asarray(values, dtype=np.float64))
    if v.size == 0:
        return math.nan
    return float(v[max(0, math.ceil(pct / 100.0 * v.size) - 1)])


def drive(submit, sched: Schedule, payload, wait_s: float) -> Result:
    """Send request i with ``submit(payload(i))`` (which returns a
    ``concurrent.futures.Future``) at its due time, from this thread; then
    wait up to ``wait_s`` past the last due time for the answers. Times
    are ``time.perf_counter`` seconds after the start."""
    n = len(sched.due)
    sent = np.full(n, np.nan)
    done = np.full(n, np.nan)
    failed = np.zeros(n, dtype=bool)
    answers: list = [None] * n
    lock = threading.Lock()
    left = [n]
    all_done = threading.Event()
    t0 = time.perf_counter()

    def finish(i, fut):
        t = time.perf_counter() - t0
        with lock:
            done[i] = t
            if fut.exception() is not None:
                failed[i] = True
            else:
                answers[i] = fut.result()
            left[0] -= 1
            if left[0] == 0:
                all_done.set()

    for i in range(n):
        wait = sched.due[i] - (time.perf_counter() - t0)
        if wait > 0:
            time.sleep(wait)
        x = payload(i)
        sent[i] = time.perf_counter() - t0
        try:
            fut = submit(x)
        except Exception:  # a refused request is a failed one
            with lock:
                failed[i] = True
                done[i] = sent[i]
                left[0] -= 1
                if left[0] == 0:
                    all_done.set()
            continue
        fut.add_done_callback(lambda f, i=i: finish(i, f))
    all_done.wait(timeout=max(0.0, sched.due[-1] + wait_s - (time.perf_counter() - t0)))
    with lock:
        unanswered = np.isnan(done)
        failed |= unanswered
        return Result(sched.due.copy(), sent, done.copy(), failed.copy(), list(answers))

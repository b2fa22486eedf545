"""Profiling and tracing hooks.

Counterpart of ``lmnet_tpu/train/profiling.py``:

    with trace("/tmp/torch-trace"):        # Chrome trace of host + card
        run_steps(...)

    timer = StepTimer(device)
    for batch in loader:
        with timer:
            state, loss, cm = train_step(...)
    print(timer.summary())
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` trace around a block (host ops, and the card's
    kernels where CUDA is available), written to ``log_dir`` as a Chrome
    trace (``trace_<pid>_<ns>.json``)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named region in profiler timelines: a ``record_function`` range, and
    an NVTX range where CUDA is available."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class StepTimer:
    """Wall-clock per-step timing with a percentile summary. On a CUDA
    ``device`` it synchronises the card at the start and end of each step,
    so a step's time includes its kernels, not only their launch."""

    def __init__(self, device: torch.device | str | None = None):
        self.times: list[float] = []
        self._t0 = None
        self._cuda = device is not None and torch.device(device).type == "cuda"
        self._device = device

    def _sync(self):
        if self._cuda:
            torch.cuda.synchronize(self._device)

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.times.append(time.perf_counter() - self._t0)
        return False

    def summary(self) -> dict:
        if not self.times:
            return {}
        a = np.asarray(self.times[1:] or self.times)  # drop the first (warm-up) step
        return {
            "steps": len(self.times),
            "mean_ms": float(a.mean() * 1e3),
            "p50_ms": float(np.percentile(a, 50) * 1e3),
            "p95_ms": float(np.percentile(a, 95) * 1e3),
            "max_ms": float(a.max() * 1e3),
        }

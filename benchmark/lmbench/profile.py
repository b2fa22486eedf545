"""The traced run's device timeline, read from ``torch.profiler``'s trace.

A ``Tracer`` profiles the CPU and the card over a stretch of a run and
gives a ``Trace``: every device operation in the traced window (kernels,
copies, sets) with the host operations that launched it, and the host
operations themselves. The trace is read in the Chrome trace format the
profiler exports (``ts``/``dur`` in microseconds; a kernel's
``correlation`` names its launch, the runtime call on the host thread that
made it), which has kept its shape across PyTorch versions.

What the per-layer metrics read from it: the device's busy time (the union
of its operations), the idle gaps and what the launching host thread was
doing in each, the time of kernels by name, and the time of kernels
launched inside given host operations (``aten::convolution`` and its
children, say).
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "benchmark.window"


@dataclass
class DeviceOp:
    name: str
    start: float  # us
    dur: float  # us
    host: tuple[str, ...] = ()  # host ops around its launch, innermost first
    tid: object = None  # the launching host thread


@dataclass
class _Thread:
    starts: list = field(default_factory=list)
    ops: list = field(default_factory=list)  # (start, end, name, parent index)


class Trace:
    """Device operations clipped to the window [start, end] (us), and the
    host threads' operations, nested by time."""

    def __init__(self, start: float, end: float, device: list[DeviceOp], host: list[tuple]):
        self.start, self.end = start, end
        self.device = []
        for d in sorted(device, key=lambda d: d.start):
            a, b = max(d.start, start), min(d.start + d.dur, end)
            if b > a:
                self.device.append(DeviceOp(d.name, a, b - a, d.host, d.tid))
        self._threads: dict = defaultdict(_Thread)
        for name, t0, dur, tid in sorted(host, key=lambda h: (h[1], -h[2])):
            th = self._threads[tid]
            parent = len(th.ops) - 1  # the innermost op still open at t0
            while parent >= 0 and th.ops[parent][1] <= t0:
                parent = th.ops[parent][3]
            th.ops.append((t0, t0 + dur, name, parent))
            th.starts.append(t0)

    # -- host ----------------------------------------------------------------
    def host_stack(self, tid, t: float) -> tuple[str, ...]:
        """Names of the host ops on thread ``tid`` running at time ``t``,
        innermost first."""
        th = self._threads.get(tid)
        if th is None:
            return ()
        # the last op to start by t; the ops that hold t are it or its
        # ancestors, since the ops of a thread nest
        i = bisect.bisect_right(th.starts, t) - 1
        while i >= 0 and th.ops[i][1] < t:
            i = th.ops[i][3]
        out = []
        while i >= 0:
            out.append(th.ops[i][2])
            i = th.ops[i][3]
        return tuple(out)

    # -- device --------------------------------------------------------------
    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def busy_intervals(self) -> list[tuple[float, float]]:
        out: list[list[float]] = []
        for d in self.device:
            a, b = d.start, d.start + d.dur
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def kernel_s(self, match) -> float:
        """Seconds of device ops whose name ``match`` accepts."""
        return sum(d.dur for d in self.device if match(d.name)) / 1e6

    def under_host_s(self, match) -> float:
        """Seconds of device ops launched inside a host op whose name
        ``match`` accepts (at any depth)."""
        return sum(d.dur for d in self.device if any(match(h) for h in d.host)) / 1e6

    def top_ops(self, n: int = 10) -> list[list]:
        tot: dict[str, float] = defaultdict(float)
        for d in self.device:
            tot[d.name] += d.dur / 1e6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self) -> list[tuple[float, float, DeviceOp | None]]:
        """(start, end, the first device op after it or None) of every
        stretch of the window with nothing running on the device."""
        gaps, t = [], self.start
        busy = self.busy_intervals()
        firsts = {}
        for d in self.device:
            firsts.setdefault(d.start, d)
        for a, b in busy:
            if a > t:
                gaps.append((t, a, firsts.get(a)))
            t = max(t, b)
        if self.end > t:
            gaps.append((t, self.end, None))
        return gaps

    def idle_by_host(self, n: int = 10) -> list[list]:
        """The idle seconds summed by what the host thread that launched
        the next device op was doing in the middle of the gap (its
        innermost op, 'host: no op' where it ran none, 'end of window'
        after the last op)."""
        tot: dict[str, float] = defaultdict(float)
        for a, b, nxt in self.idle_gaps():
            if nxt is None:
                name = "end of window"
            else:
                stack = self.host_stack(nxt.tid, (a + b) / 2)
                name = stack[0] if stack else "host: no op"
            tot[name] += (b - a) / 1e6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def from_events(events: list[dict], window: str = WINDOW) -> Trace:
    """A ``Trace`` from Chrome trace events: the window is the host
    annotation named ``window`` (the last one)."""
    marks = [e for e in events if e.get("name") == window and e.get("ph") == "X"
             and e.get("cat") in ("user_annotation", "cpu_op")]
    if not marks:
        raise ValueError(f"the trace holds no '{window}' annotation")
    w = marks[-1]
    host, launches, device = [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        args = e.get("args") or {}
        if cat in ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"):
            host.append((e["name"], float(e["ts"]), float(e.get("dur", 0.0)), e.get("tid")))
            if cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
                launches[args["correlation"]] = (float(e["ts"]), e.get("tid"))
        elif cat in DEVICE_CATS:
            device.append(e)
    trace = Trace(float(w["ts"]), float(w["ts"]) + float(w["dur"]), [], host)
    ops = []
    for e in device:
        t, tid = launches.get((e.get("args") or {}).get("correlation"), (None, None))
        stack = trace.host_stack(tid, t) if t is not None else ()
        ops.append(DeviceOp(e["name"], float(e["ts"]), float(e.get("dur", 0.0)), stack, tid))
    return Trace(trace.start, trace.end, ops, host)


def warm(device) -> None:
    """Start and stop the profiler once: its first start initialises the
    device tracing, which takes seconds; a traced run does it in set-up so
    that its window does not stall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts):
        torch.zeros(1, device=device).add_(1)


class Tracer:
    """Profiles the CPU and CUDA activity from its creation to ``stop()``,
    which returns the ``Trace`` of that window. ``sync``: wait for the
    device before the window opens (a caller that owns the device's only
    stream); an open loop's generator does not wait."""

    def __init__(self, device, sync: bool = True):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._torch = torch
        self.cuda = torch.device(device).type == "cuda"
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self._prof = profile(activities=acts)
        self._prof.start()
        if sync and self.cuda:
            torch.cuda.synchronize(device)
        self._mark = torch.profiler.record_function(WINDOW)
        self._mark.__enter__()
        self.device = device

    def stop(self) -> Trace:
        if self.cuda:
            self._torch.cuda.synchronize(self.device)
        self._mark.__exit__(None, None, None)
        self._prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh)["traceEvents"]
        finally:
            os.unlink(path)
        return from_events(events)

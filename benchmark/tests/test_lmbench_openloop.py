"""The open-loop generator: the schedule repeats from the seed and keeps
its set of gaps and sizes across seeds; a request is timed from when it was
due; a failure or a missing answer counts as a miss."""

from __future__ import annotations

import math
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

from lmbench import openloop


def test_schedule_repeats_and_keeps_its_work_across_seeds():
    a, b = openloop.schedule(200, 3.0, [1, 2, 3, 4], 11), openloop.schedule(200, 3.0,
                                                                           [1, 2, 3, 4], 11)
    c = openloop.schedule(200, 3.0, [1, 2, 3, 4], 12)
    assert np.array_equal(a.due, b.due) and np.array_equal(a.sizes, b.sizes)
    assert len(a.due) == 600 and a.due[-1] == pytest.approx(3.0)
    assert not np.array_equal(a.due, c.due)
    assert np.allclose(np.sort(np.diff(a.due, prepend=0)), np.sort(np.diff(c.due, prepend=0)))
    assert np.array_equal(np.sort(a.sizes), np.sort(c.sizes))
    assert np.bincount(a.sizes).tolist() == [0, 150, 150, 150, 150]
    gaps = np.diff(a.due, prepend=0)
    assert gaps.mean() == pytest.approx(1 / 200, rel=0.01)
    assert np.std(gaps) / gaps.mean() == pytest.approx(1.0, abs=0.1)  # exponential


def test_percentile_nearest_rank_with_misses():
    assert openloop.percentile([1, 2, 3, 4], 50) == 2
    assert openloop.percentile(list(range(1, 101)), 95) == 95
    assert openloop.percentile([1.0] * 95 + [math.inf] * 5, 95) == 1.0
    assert openloop.percentile([1.0] * 94 + [math.inf] * 6, 95) == math.inf


class _Server:
    """Answers each request after ``delay`` s on a thread; stalls for
    ``stall`` s at request ``at``; fails request ``bad``; never answers
    request ``lost``."""

    def __init__(self, delay=0.002, stall=0.0, at=-1, bad=-1, lost=-1):
        self.delay, self.stall, self.at, self.bad, self.lost = delay, stall, at, bad, lost
        self.threads = []

    def submit(self, i):
        fut = Future()

        def answer():
            time.sleep(self.delay + (self.stall if i == self.at else 0.0))
            if i == self.bad:
                fut.set_exception(RuntimeError("device error"))
            else:
                fut.set_result(i)

        if i != self.lost:
            th = threading.Thread(target=answer)
            th.start()
            self.threads.append(th)
        return fut


def test_latency_is_timed_from_the_due_time():
    sched = openloop.Schedule(np.array([0.01, 0.02, 0.03]), np.array([1, 1, 1]))
    srv = _Server()

    def slow_payload(i):
        if i == 1:
            time.sleep(0.05)  # the generator itself runs late for request 1
        return i

    res = openloop.drive(srv.submit, sched, slow_payload, wait_s=2.0)
    lat = res.latencies_ms()
    assert lat[1] >= 50  # its lateness counts
    assert res.lateness_ms()[1] >= 50
    assert res.answers == [0, 1, 2] and not res.failed.any()


def test_failed_and_unanswered_requests_are_misses():
    sched = openloop.Schedule(np.array([0.0, 0.005, 0.01, 0.015]), np.ones(4, dtype=int))
    srv = _Server(bad=1, lost=2)
    t = time.perf_counter()
    res = openloop.drive(srv.submit, sched, lambda i: i, wait_s=0.3)
    assert time.perf_counter() - t < 2.0
    assert res.failed.tolist() == [False, True, True, False]
    lat = res.latencies_ms()
    assert math.isinf(lat[1]) and math.isinf(lat[2]) and math.isfinite(lat[3])
    assert res.answers[0] == 0 and res.answers[2] is None
    for th in srv.threads:
        th.join(timeout=5)
        assert not th.is_alive()

"""Named spans in the profiler's timeline, free when no profiler runs.

    from lmnet_tpu_torch.spans import span

    with span("lmnet.rc"):
        ...

With a ``torch.profiler`` session running, ``span(name)`` is a
``torch.profiler.record_function`` range: it lands in the same Kineto trace
as the card's kernels, on the same clock, and each kernel's launch sits
inside it on its host thread. With none running it is one read of the
profiler's flag and a shared null context: nothing is allocated and no
``record_function`` is entered (which costs ~16 us even with no profiler).
The flag is read on entry, so a span entered before a profiler starts stays
unrecorded.

The autograd engine's threads inherit a profiler of the thread that runs
``backward()``, so the recompute's spans in the backward are recorded too.

The port's span names are a contract that the benchmark's per-layer metrics
read (PERF.md, "Spans and counters"). This module imports nothing of the
package: ``models/``, ``serve/`` and ``train/`` all import it.
"""

from __future__ import annotations

import contextlib

import torch
import torch.autograd.profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler runs,
    else a shared null context."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)

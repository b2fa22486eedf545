"""``bn_roofline.train``'s compulsory bytes: which BatchNorms the traffic's
branch backend sends through the kernels, and how often ``rc_remat`` runs
them forward, counted on the reference at a tiny size."""

from __future__ import annotations

import types

import pytest

from conftest import TINY

CONFIG = {"image_size": 32, "dtype": "bfloat16", "model": TINY}


def _reader():
    import run

    return run.metric_reader("bn_roofline.train")


def test_the_reference_has_an_expand_four_branches_and_a_skip_batchnorm_per_block():
    m = _reader()
    expand, branch, skip = m.bn_elements(32, tuple(TINY["filters"]), TINY["num_heads"],
                                         TINY["num_classes"])
    assert expand > 0 and skip > 0
    assert branch == 4 * expand  # the four branches run at the expand width


@pytest.mark.parametrize("remat,backend,fwd", [
    (True, "xla", (2, 2)), ("full", "auto", (2, 2)), ("branches", "packed", (1, 2)),
    (False, "xla", (1, 1)), (True, "fused", (2, 0)), ("branches", "fused", (1, 0)),
    (False, "fused", (1, 0)),
])
def test_bytes_count_the_batchnorms_the_backend_sends_through_the_kernels(remat, backend, fwd):
    """2 bytes an element read and written a forward, 3 a backward (bf16);
    'fused' keeps the branch BatchNorms out of the kernels."""
    m = _reader()
    expand, branch, skip = m.bn_elements(32, tuple(TINY["filters"]), TINY["num_heads"],
                                         TINY["num_classes"])
    forwards = fwd[0] * expand + fwd[1] * branch + skip
    backwards = expand + (branch if fwd[1] else 0) + skip
    assert m.bytes_per_image(CONFIG, remat, backend) == 2 * (2 * forwards + 3 * backwards)


@pytest.mark.parametrize("model", [{"rc_train_backend": "another"}, {"rc_remat": "some"}])
def test_a_traffic_it_cannot_count_reads_none(model):
    m = _reader()
    assert m.read(types.SimpleNamespace(config=CONFIG, trace=object(),
                                        traffic={"model": model})) is None


def test_no_trace_reads_none():
    m = _reader()
    assert m.read(types.SimpleNamespace(config=CONFIG, trace=None, traffic={"model": {}})) is None


def test_the_traffic_comes_from_the_context(monkeypatch):
    """The cell's traffic as ``run.py`` hands it over in ``readers.Context``,
    not from the process's arguments: 'fused' counts fewer bytes than 'xla'
    for the same kernel time, so it reads a lower share."""
    from lmbench import readers

    m = _reader()
    monkeypatch.setattr("sys.argv", ["run.py", "--workload", "no-such-cell"])
    seen = []
    monkeypatch.setattr(readers, "roofline", lambda ctx, k, bound: seen.append(bound(1)) or 1.0)
    for backend in ("xla", "fused"):
        traffic = {"model": {"rc_remat": True, "rc_train_backend": backend}}
        ctx = readers.Context(CONFIG, {}, trace=object(), traffic=traffic)
        assert m.read(ctx) == 1.0
    assert seen[0] == m.bytes_per_image(CONFIG, True, "xla") / 3.35e12
    assert seen[1] == m.bytes_per_image(CONFIG, True, "fused") / 3.35e12 < seen[0]

"""The port's named spans (``lmnet_tpu_torch/spans.py``) under
``torch.profiler`` on the CPU at TINY: every op of ``deploy_forward`` inside
exactly one stage span, ``lmnet.fold`` on weights alone, the ReparamConv
recompute entering ``lmnet.rc`` outside the step's forward, and
``/healthz``'s two clocks; and with no profiler running, no
``record_function`` entered anywhere."""

import http.client
import json
import threading
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from conftest import TINY

from lmnet_tpu_torch.models import LMNet, structural_reparam
from lmnet_tpu_torch.serve import deploy_forward
from lmnet_tpu_torch.serve.daemon import DynamicBatcher, make_server
from lmnet_tpu_torch.spans import span
from lmnet_tpu_torch.train import create_train_state, train_step

HW = 32
B = 5  # no weight of TINY has a leading 5: a leading 5 marks an activation
HEADS = TINY["num_heads"]
STAGES = {"lmnet.rc": 16, "lmnet.down": 4, "lmnet.gft": 1, "lmnet.skip": 4, "lmnet.natt": 4,
          "lmnet.up": 4, "lmnet.head": 1}
PACKAGE = Path(__file__).resolve().parents[1] / "lmnet_tpu_torch"


@pytest.fixture(scope="module")
def deploy():
    return structural_reparam(LMNet(**TINY, generator=torch.Generator().manual_seed(0))
                              .state_dict())


def _x(n=B):
    return torch.randn(n, HW, HW, 3, generator=torch.Generator().manual_seed(1))


def _ancestors(e):
    out, p = [], e.cpu_parent
    while p is not None:
        out.append(p.name)
        p = p.cpu_parent
    return out


def _profiled(fn, record_shapes=False):
    """The profiler's events of ``fn()`` run inside a ``test.call`` range."""
    with profile(activities=[ProfilerActivity.CPU], record_shapes=record_shapes) as prof:
        with torch.profiler.record_function("test.call"):
            fn()
    return [e for e in prof.events() if "test.call" in _ancestors(e)]


@pytest.mark.parametrize("skip_compose", [False, True])
@pytest.mark.parametrize("rc_backend", ["xla", "flat", "pallas"])
def test_every_op_of_deploy_forward_lies_in_one_stage_span(deploy, rc_backend, skip_compose):
    x = _x()
    with torch.inference_mode():
        events = _profiled(lambda: deploy_forward(deploy, x, num_heads=HEADS, nat_backend="flat",
                                                  rc_backend=rc_backend,
                                                  skip_compose=skip_compose))
    counts = Counter(e.name for e in events if e.name.startswith("lmnet."))
    assert {k: counts[k] for k in STAGES} == STAGES
    ops = [e for e in events if e.name.startswith("aten::")]
    assert len(ops) > 300
    outside = [e.name for e in ops if sum(a in STAGES for a in _ancestors(e)) != 1]
    assert not outside, Counter(outside)
    # the folds sit inside the stages, and no stage inside another
    for e in events:
        if e.name in STAGES:
            assert not any(a.startswith("lmnet.") for a in _ancestors(e)), e.name
        if e.name == "lmnet.fold":
            assert sum(a in STAGES for a in _ancestors(e)) == 1
    assert counts["lmnet.fold"] > 0


@pytest.mark.parametrize("opts", [{}, {"skip_compose": True}, {"natt_int8": True},
                                  {"ln_fold": True}], ids=lambda o: ",".join(o) or "plain")
@pytest.mark.parametrize("rc_backend", ["xla", "flat", "pallas"])
def test_fold_takes_weights_alone(deploy, rc_backend, opts):
    """No op inside ``lmnet.fold`` takes an activation (a leading batch of
    B = 5) in a bf16 forward, whatever the backend and option."""
    x = _x().to(torch.bfloat16)
    with torch.inference_mode():
        events = _profiled(lambda: deploy_forward(deploy, x, num_heads=HEADS, nat_backend="flat",
                                                  rc_backend=rc_backend, **opts),
                           record_shapes=True)

    def batched(e):
        return any(len(s) >= 2 and s[0] == B for s in e.input_shapes if isinstance(s, list))

    fold = [e for e in events if e.name.startswith("aten::") and "lmnet.fold" in _ancestors(e)]
    assert fold and not [e.name for e in fold if batched(e)]
    rest = [e for e in events if e.name.startswith("aten::") and e not in fold]
    assert any(batched(e) for e in rest)
    assert any(e.name == "aten::_to_copy" for e in fold)  # the weights' casts


@pytest.mark.parametrize("rc_remat", [True, False, "branches"])
def test_recompute_enters_lmnet_rc_outside_the_forward(rc_remat):
    model = LMNet(**TINY, generator=torch.Generator().manual_seed(0), nat_backend="flat",
                  rc_remat=rc_remat)
    state = create_train_state(model, (2, HW, HW, 3), seed=0, device="cpu")
    x, y = torch.rand(2, HW, HW, 3), (torch.rand(2, HW, HW) > 0.5).long()
    cm = torch.zeros(2, 2, dtype=torch.int64)
    train_step(state, x, y, cm)  # the first step makes AdamW's state
    events = _profiled(lambda: train_step(state, x, y, cm))
    names = Counter(e.name for e in events if e.name.startswith("lmnet."))
    for step in ("forward", "loss", "backward", "metrics"):
        assert names[f"lmnet.step.{step}"] == 1
    for stage, n in STAGES.items():
        if stage != "lmnet.rc":
            assert names[stage] == n, stage
    rc = [_ancestors(e) for e in events if e.name == "lmnet.rc"]
    forward = [a for a in rc if "lmnet.step.forward" in a]
    later = [a for a in rc if "lmnet.step.forward" not in a]
    assert forward
    assert bool(later) == bool(rc_remat)
    # the recompute runs in the backward: once per block, each with its ops
    assert all("lmnet.step.backward" in a for a in later)
    assert len(later) == (16 if rc_remat else 0)
    assert any("lmnet.step.backward" in _ancestors(e) and "lmnet.rc" in _ancestors(e)
               for e in events if e.name.startswith("aten::")) == bool(rc_remat)


def _fn(x):
    return torch.stack([x[..., 0], x[..., 1]], dim=-1)


def test_no_record_function_without_a_profiler(deploy, monkeypatch):
    """With no profiler running the spans enter no ``record_function``: made
    to raise, it breaks none of the serving forward, a train step and a
    batcher round trip. And the package enters one only through ``span``."""
    assert not torch.autograd.profiler._is_profiler_enabled

    def refuse(name, *a, **k):
        raise AssertionError(f"record_function({name!r}) entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with pytest.raises(AssertionError):
        with torch.profiler.record_function("x"):
            pass
    with torch.inference_mode():
        for rc in ("xla", "flat", "pallas"):
            deploy_forward(deploy, _x(1), num_heads=HEADS, nat_backend="flat", rc_backend=rc)
    model = LMNet(**TINY, generator=torch.Generator().manual_seed(0), nat_backend="flat")
    state = create_train_state(model, (2, HW, HW, 3), seed=0, device="cpu")
    _, loss, _ = train_step(state, torch.rand(2, HW, HW, 3),
                            (torch.rand(2, HW, HW) > 0.5).long(),
                            torch.zeros(2, 2, dtype=torch.int64))
    assert torch.isfinite(loss)
    b = DynamicBatcher(_fn, img_size=4, max_batch=4, max_wait_ms=1.0, dtype=torch.float32,
                       device="cpu")
    try:
        assert b.predict(np.zeros((2, 4, 4, 3), np.float32), timeout=60).shape == (2, 4, 4)
    finally:
        b.stop()
    users = sorted(p.relative_to(PACKAGE).as_posix() for p in PACKAGE.rglob("*.py")
                   if "record_function" in p.read_text())
    assert users == ["spans.py"]
    assert span("a") is span("b")


def test_healthz_reports_queue_and_busy_seconds():
    """The batcher's stats, and so ``/healthz``, carry ``queue_s`` and
    ``busy_s`` for the batches served."""
    b = DynamicBatcher(_fn, img_size=4, max_batch=4, max_wait_ms=1.0, dtype=torch.float32,
                       device="cpu")
    srv = make_server(b, "127.0.0.1", 0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        for n in (1, 3):
            assert b.predict(np.ones((n, 4, 4, 3), np.float32), timeout=60).shape == (n, 4, 4)
        b.stop()
        host, port = srv.server_address
        conn = http.client.HTTPConnection(host, port, timeout=60)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        assert health["requests"] == 2 and health["batches"] == 2 and health["padded"] == 1
        assert health["queue_s"] > 0 and health["busy_s"] > 0
        assert set(b.stats) == {"requests", "images", "batches", "padded", "queue_s", "busy_s"}
    finally:
        b.stop()
        srv.shutdown()
        srv.server_close()
        t.join(timeout=10)
    assert not t.is_alive()

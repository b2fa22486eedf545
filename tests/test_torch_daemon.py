"""The port's serving daemon (``lmnet_tpu_torch/serve/daemon.py``) at TINY on
the CPU: JAX ``tests/test_daemon.py``'s cases (padding buckets, merging and
per-request results, single images and validation, the HTTP round trip),
a device error reaching every waiting caller, and ``main`` run as a
subprocess on a saved artifact.

The artifact is exported once (float32, about 10 s here) from JAX weights
converted to the port, so the served masks are held against JAX's
``deploy_forward(nat_backend='xla', rc_backend='xla')`` argmax wherever
JAX's top-two logit margin exceeds 1e-4 (elsewhere float32 rounding may
pick either class).
"""

import http.client
import io
import json
import os
import queue
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import TINY, TINY_HW
from test_torch_serve import jax_variables

from lmnet_tpu_torch.convert import jax_to_state_dict
from lmnet_tpu_torch.models import structural_reparam as t_structural_reparam
from lmnet_tpu_torch.serve import daemon
from lmnet_tpu_torch.serve.daemon import DynamicBatcher, _bucket, make_server
from lmnet_tpu_torch.serve.export import load_deploy_file, save_deploy

HW = TINY_HW
HEADS = TINY["num_heads"]
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def variables():
    return jax_variables(0, HW)


@pytest.fixture(scope="module")
def artifact(variables, tmp_path_factory):
    path = tmp_path_factory.mktemp("artifact") / "tiny.pt2"
    return save_deploy(str(path), t_structural_reparam(jax_to_state_dict(variables)),
                       img_size=HW, num_heads=HEADS, dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def deploy_fn(artifact):
    return load_deploy_file(artifact, device="cpu")


@pytest.fixture(scope="module")
def jax_masks(variables):
    """x -> (JAX's argmax masks, where its top-two margin exceeds 1e-4)."""
    from lmnet_tpu.models import structural_reparam
    from lmnet_tpu.serve import deploy_forward

    deploy = jax.device_get(structural_reparam(variables))

    def run(x):
        logits = np.asarray(deploy_forward(deploy, jnp.asarray(x), num_heads=HEADS,
                                           nat_backend="xla", rc_backend="xla"))
        top2 = np.sort(logits, axis=-1)[..., -2:]
        return logits.argmax(-1), top2[..., 1] - top2[..., 0] > 1e-4

    return run


def _assert_masks(got, x, jax_masks):
    want, sure = jax_masks(x)
    assert got.shape == x.shape[:3] and got.dtype == np.int32
    assert sure.mean() > 0.99
    np.testing.assert_array_equal(got[sure], want[sure])


@pytest.fixture()
def batcher(deploy_fn):
    b = DynamicBatcher(deploy_fn, img_size=HW, max_batch=8, max_wait_ms=1000.0,
                       dtype=torch.float32, device="cpu")
    yield b
    b.stop()
    assert not b._worker.is_alive()


def _images(n, seed):
    return np.random.RandomState(seed).rand(n, HW, HW, 3).astype(np.float32)


def test_bucket():
    assert [_bucket(n, 8) for n in (1, 2, 3, 4, 5, 8, 9)] == [1, 2, 4, 4, 8, 8, 8]


def test_batching_merges_and_matches(batcher, jax_masks):
    """Concurrent small requests coalesce into fewer device batches, each
    request gets its own images' masks, and the odd total is padded to the
    bucket."""
    xs = [_images(n, n) for n in (1, 2)]
    futs = [batcher.submit(x) for x in xs]
    for x, f in zip(xs, futs):
        _assert_masks(f.result(timeout=600), x, jax_masks)
    st = batcher.stats
    assert st["requests"] == 2 and st["images"] == 3
    assert st["batches"] < st["requests"]  # they coalesced
    assert st["padded"] >= 1  # 3 images -> bucket 4


def test_single_image_and_validation(batcher):
    out = batcher.predict(_images(1, 3)[0])
    assert out.shape == (1, HW, HW)
    with pytest.raises(ValueError):
        batcher.submit(np.zeros((1, HW + 1, HW, 3), np.float32))
    with pytest.raises(ValueError):
        batcher.submit(np.zeros((9, HW, HW, 3), np.float32))
    with pytest.raises(ValueError):
        batcher.submit(np.zeros((0, HW, HW, 3), np.float32))


def _post(host, port, x):
    buf = io.BytesIO()
    np.save(buf, x)
    conn = http.client.HTTPConnection(host, port, timeout=600)
    conn.request("POST", "/predict", body=buf.getvalue())
    resp = conn.getresponse()
    return conn, resp.status, resp.read()


def test_http_roundtrip(batcher, jax_masks):
    srv = make_server(batcher, "127.0.0.1", 0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        host, port = srv.server_address
        x = _images(2, 4)
        conn, status, body = _post(host, port, x)
        assert status == 200
        _assert_masks(np.load(io.BytesIO(body), allow_pickle=False), x, jax_masks)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        assert health["ok"] and health["requests"] == 1 and health["images"] == 2
        # a malformed body answers 400 and the daemon stays up
        conn.request("POST", "/predict", body=b"not an npy")
        assert conn.getresponse().status == 400
        conn.request("GET", "/healthz")
        assert json.loads(conn.getresponse().read())["ok"]
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=10)
    assert not t.is_alive()


def test_an_error_in_fn_reaches_every_waiting_caller():
    """A device call that raises fails every request of its batch, and the
    worker goes on serving the next."""
    calls = []

    def fn(x):
        calls.append(x.shape[0])
        if len(calls) == 1:
            raise RuntimeError("device lost")
        return torch.zeros(*x.shape[:3], 2)

    b = DynamicBatcher(fn, img_size=4, max_batch=8, max_wait_ms=1000.0, dtype=torch.float32,
                       device="cpu")
    try:
        futs = [b.submit(np.zeros((n, 4, 4, 3), np.float32)) for n in (1, 2, 1)]
        for f in futs:
            with pytest.raises(RuntimeError, match="device lost"):
                f.result(timeout=60)
        assert b.predict(np.zeros((4, 4, 3), np.float32), timeout=60).shape == (1, 4, 4)
        assert calls == [4, 1] and b.stats["batches"] == 1
    finally:
        b.stop()


def test_main_serves_an_artifact_in_a_subprocess(artifact, jax_masks):
    """``python -m lmnet_tpu_torch.serve.daemon --artifact ... --device cpu
    --port 0``: it prints its address, answers a request with JAX's masks,
    and stops when terminated."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]),
        OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "lmnet_tpu_torch.serve.daemon", "--artifact", artifact,
         "--img_size", str(HW), "--port", "0", "--device", "cpu", "--max_wait_ms", "1"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)
    lines = queue.Queue()
    reader = threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout], daemon=True)
    reader.start()
    try:
        said = []
        while not said or not said[-1].startswith("serving on http://"):
            said.append(lines.get(timeout=300))
        host, port = said[-1].split("http://")[1].split()[0].split(":")
        x = _images(3, 5)
        _, status, body = _post(host, int(port), x)
        assert status == 200, body
        _assert_masks(np.load(io.BytesIO(body), allow_pickle=False), x, jax_masks)
    finally:
        proc.terminate()
        proc.wait(timeout=60)
    reader.join(timeout=10)
    assert proc.returncode is not None and not reader.is_alive()


def test_main_without_a_card_is_refused(tmp_path):
    """The daemon serves on the card unless told otherwise, and does not
    fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(SystemExit, match="--device cpu"):
        daemon.main(["--artifact", str(tmp_path / "absent.pt2")])

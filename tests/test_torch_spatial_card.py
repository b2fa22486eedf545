"""The sharded train step on the card: two gloo ranks sharing one CUDA device
on a (1 x 2) ('data', 'spatial') mesh, each holding 32 rows of every 64^2
image and running ``tests/_torch_spatial_worker.py``'s 'card' case, against
one process on the same card.

The step is the full-width model's at float32, 64^2, a batch of 2, 'flat'
NAT (B1 and B2 on each rank's slabs of 33, 17, 9 and 5 rows),
``rc_remat=True``, dropout on: the halo exchanges of CUDA tensors through
gloo, and the kernels on slabs, which the CPU runs only as plain graphs.
Tolerances are the fp32 rule of the kernels' train step: loss rel 1e-5,
each gradient ||2 ranks - 1 process|| <= 1e-3 ||1 process|| + 1e-5
max||g||, the running statistics within 1e-4 |ref| + 1e-5 max|ref|, the
confusion matrix equal; B1 and B2 launch 4 times on each rank.

Imports no JAX: on the card it runs with
``python -m pytest --noconftest -m gpu tests/test_torch_spatial_card.py``.
Without a card it skips.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from lmnet_tpu_torch.metrics import ConfusionAccumulator
from lmnet_tpu_torch.models import LMNet
from lmnet_tpu_torch.ops import _build
from lmnet_tpu_torch.train import create_train_state, train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_spatial_worker.py")
HW, B, SEED = 64, 2, 8


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.gpu
def test_two_gloo_ranks_on_h_blocks_match_one_process(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build("nat_fwd", "nat_bwd")  # once, before the ranks
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(B, HW, HW, 3).astype(np.float32))
    y = (x.mean(-1) > 0.1).long()
    torch.save({"x": x, "y": y}, tmp_path / "batch.pt")
    spec = dict(device="cuda", seed=SEED, n_spatial=2, batch=str(tmp_path / "batch.pt"),
                dir=str(tmp_path), cases=["card"])
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen([sys.executable, WORKER, str(tmp_path / "spec.json")],
                                      env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            assert p.returncode == 0, out[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)["card"] for r in range(2)]

    for r in ranks:
        assert r["launches"] == {"nat_fwd": 4, "nat_bwd": 4}, r["launches"]
    assert all(torch.equal(ranks[0]["state"][k], ranks[1]["state"][k]) for k in ranks[0]["state"])
    dev = torch.device("cuda")
    model = LMNet(generator=torch.Generator().manual_seed(SEED), nat_backend="flat")
    state = create_train_state(model, tuple(x.shape), seed=SEED, device=dev)
    state, loss, cm = train_step(state, x.to(dev), y.to(dev), ConfusionAccumulator.init(2, dev))
    got, lo = ranks[0], float(loss)
    assert abs(got["loss"] - lo) <= 1e-5 * abs(lo), (got["loss"], lo)
    assert torch.equal(got["cm"], cm.cpu())
    go = {n: p.grad.cpu() for n, p in state.model.named_parameters()}
    big = max(v.norm().item() for v in go.values())
    for k, ref in go.items():
        err = (got["grads"][k] - ref).norm().item()
        assert err <= 1e-3 * ref.norm().item() + 1e-5 * big, (k, err)
    for k, ref in state.model.state_dict().items():
        if "running" in k:
            ref = ref.cpu()
            bound = 1e-4 * ref.abs() + 1e-5 * ref.abs().max().item()
            assert bool(((got["state"][k] - ref).abs() <= bound).all()), k

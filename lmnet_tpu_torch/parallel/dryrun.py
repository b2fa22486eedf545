"""The multi-rank dry run: one full train step over a ('data', 'spatial')
mesh of n ranks, held equal to one process.

Counterpart of ``__graft_entry__.py::dryrun_multichip``: JAX jits the full
training step (forward, CE + Dice, backward, AdamW, the BatchNorm running
statistics, the on-device confusion matrix) over an n-device mesh, with
n_spatial = 2 when n is even and at least 4, on the full-width
``LMNet(num_classes=2)`` at 32^2 and a batch of 2 x n_data, and asserts the
loss (rtol 1e-4) and the confusion matrix equal to one device's. Here the
n devices are n processes joined in a gloo group on this host (``device``
'cpu', or 'cuda': every rank on the card, whose tensors gloo carries
through the host); each runs ``train.engine.train_step`` on its rows and,
with the spatial axis, its block of H (``parallel/mesh.py::shard_batch``),
dropout on, while this process runs the same step on the whole batch.

    python -m lmnet_tpu_torch.parallel.dryrun N [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

HW = 32  # every block runs: the smallest NAT map is 4 x 4, 2 rows a block
SEED, DROPOUT_SEED = 0, 1


def _plan(n_ranks: int) -> tuple[int, int]:
    """(n_data, n_spatial), JAX's: 2 on 'spatial' for an even n >= 4."""
    n_spatial = 2 if n_ranks % 2 == 0 and n_ranks >= 4 else 1
    return n_ranks // n_spatial, n_spatial


def _batch(n_data: int):
    rng = np.random.RandomState(0)
    batch = 2 * n_data
    images = rng.randn(batch, HW, HW, 3).astype(np.float32)
    labels = rng.randint(0, 2, (batch, HW, HW)).astype(np.int64)
    return images, labels


@contextlib.contextmanager
def _float32_exact():
    """TF32 off in cuDNN's convs and cuBLAS's matmuls (cuDNN's is on by
    default): the ranks and the one process compare float32 steps, and a
    TF32 rounding flips argmaxes of the confusion matrix."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@_float32_exact()
def _step(device, images, labels, mesh=None):
    """The loss and confusion matrix of one train_step of the seeded
    full-width model (summed over the ranks under a mesh), TF32 off."""
    import torch.distributed as dist

    from lmnet_tpu_torch.metrics import ConfusionAccumulator
    from lmnet_tpu_torch.models import LMNet
    from lmnet_tpu_torch.parallel.mesh import replicate, shard_batch, shards_h, sum_group
    from lmnet_tpu_torch.train import create_train_state, train_step

    model = LMNet(num_classes=2, generator=torch.Generator().manual_seed(SEED))
    state = create_train_state(model, images.shape, seed=DROPOUT_SEED, device=device,
                               steps_per_epoch=1)
    cm = ConfusionAccumulator.init(2, device)
    if mesh is None:
        x, y = torch.from_numpy(images).to(device), torch.from_numpy(labels).to(device)
        _, loss, cm = train_step(state, x, y, cm, num_classes=2)
    else:
        replicate(mesh, state)
        sharded = shards_h(mesh, HW)
        x, y = shard_batch(mesh, images, labels, spatial=True)
        _, loss, cm = train_step(state, x, y, cm, num_classes=2, mesh=mesh,
                                 global_rows=len(images), spatial=sharded)
        dist.all_reduce(cm, group=sum_group(mesh, sharded))
    return float(loss), cm.cpu()


def _worker(out_dir: str, device_type: str) -> None:
    """One rank, under RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT."""
    from lmnet_tpu_torch.parallel import dist_utils
    from lmnet_tpu_torch.parallel.mesh import make_mesh

    if device_type == "cpu":
        torch.set_num_threads(1)
    dist_utils.init_distributed_mode(device_type, backend="gloo")
    n_data, n_spatial = _plan(dist_utils.get_world_size())
    mesh = make_mesh(n_data, n_spatial, device_type=device_type)
    device = (torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda"
              else torch.device("cpu"))
    loss, cm = _step(device, *_batch(n_data), mesh=mesh)
    torch.save({"loss": loss, "cm": cm}, Path(out_dir) / f"rank{dist_utils.get_rank()}.pt")
    dist_utils.cleanup()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_ranks: int, device: str = "cuda", timeout: float = 900) -> dict:
    """Run one full train step on ``n_ranks`` gloo ranks over an (n_data x
    n_spatial) mesh and on one process, on ``device`` ('cuda' or 'cpu'), and
    assert their losses equal within rtol 1e-4 and their confusion
    matrices equal (JAX's rtol 1e-5 on counts). Returns the mesh, both
    losses and matrices and the seconds taken."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip(device='cuda'): no CUDA device here; pass "
                           "device='cpu' to run on the CPU")
    t0 = time.perf_counter()
    n_data, n_spatial = _plan(n_ranks)
    root = str(Path(__file__).resolve().parents[2])
    port = _free_port()
    with tempfile.TemporaryDirectory(prefix="lmnet_dryrun_") as out:
        procs = []
        for rank in range(n_ranks):
            env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                       WORLD_SIZE=str(n_ranks), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       PYTHONPATH=os.pathsep.join(
                           [root, *filter(None, [os.environ.get("PYTHONPATH")])]))
            if device == "cpu":
                env["OMP_NUM_THREADS"] = "1"
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "lmnet_tpu_torch.parallel.dryrun", "--worker", out,
                 "--device", device], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        try:
            loss_1, cm_1 = _step(torch.device(device), *_batch(n_data))
            for rank, p in enumerate(procs):
                said, _ = p.communicate(timeout=timeout)
                if p.returncode != 0:
                    raise RuntimeError(f"dry-run rank {rank} exited {p.returncode}:\n"
                                       f"{said[-4000:]}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        ranks = [torch.load(Path(out) / f"rank{r}.pt") for r in range(n_ranks)]
    loss_n, cm_n = ranks[0]["loss"], ranks[0]["cm"]
    assert np.isfinite(loss_n), "non-finite loss in the multi-rank dry run"
    assert all(r["loss"] == loss_n and torch.equal(r["cm"], cm_n) for r in ranks), \
        "the ranks disagree on the loss or the confusion matrix"
    np.testing.assert_allclose(loss_n, loss_1, rtol=1e-4,
                               err_msg="multi-rank loss diverges from one process")
    np.testing.assert_allclose(cm_n.numpy(), cm_1.numpy(), rtol=1e-5,
                               err_msg="multi-rank confusion matrix diverges from one process")
    seconds = time.perf_counter() - t0
    print(f"dryrun_multichip ok: mesh=({n_data}x{n_spatial}) ranks={n_ranks} on {device} "
          f"loss={loss_n:.6f} == one process {loss_1:.6f} (rtol 1e-4), confusion matrix "
          f"equal ({seconds:.1f}s)")
    return {"mesh": (n_data, n_spatial), "loss": loss_n, "loss_one": loss_1, "cm": cm_n,
            "cm_one": cm_1, "seconds": seconds}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="one full train step on N gloo ranks against "
                                            "one process")
    p.add_argument("n_ranks", type=int, nargs="?", default=4)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--worker", metavar="DIR", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        _worker(args.worker, args.device)
        return
    dryrun_multichip(args.n_ranks, args.device)


if __name__ == "__main__":
    main()

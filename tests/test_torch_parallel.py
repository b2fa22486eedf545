"""The port's data-parallel path (``lmnet_tpu_torch/parallel/``, the mesh
arguments of the loops, the serving engine and the CLI) on two gloo ranks
on the CPU, at TINY.

The two ranks are processes running ``tests/_torch_dp_worker.py``, which
imports torch and the port only (one thread each). They start first; while
they run, this process compiles JAX's whole-model gradient on the same
global batch and runs the port in one process. A W-rank run must compute
what one process computes, so every check holds the two ranks against JAX's
train step on the global batch (float32, dropout off; loss rtol 1e-5, every
gradient as ``tests/test_torch_train.py::_close_grads``, the running
statistics rtol 1e-4 / atol 1e-5 x max) and against one process of the
port.
"""

import csv
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import TINY
from test_torch_train import _close, _close_grads, _filled

from lmnet_tpu_torch import convert
from lmnet_tpu_torch.cli import train as cli
from lmnet_tpu_torch.data import SyntheticDataset, make_loader
from lmnet_tpu_torch.metrics import ConfusionAccumulator
from lmnet_tpu_torch.models import LMNet as TLMNet
from lmnet_tpu_torch.models import blocks as t_blocks
from lmnet_tpu_torch.models.blocks import _stats
from lmnet_tpu_torch.parallel import batch as pbatch
from lmnet_tpu_torch.parallel import dist_utils
from lmnet_tpu_torch.parallel.mesh import make_mesh, shard_rows
from lmnet_tpu_torch.serve import serving_evaluate
from lmnet_tpu_torch.train import create_train_state, evaluate, train_one_epoch, train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_dp_worker.py")
HW, B, SEED = 32, 3, 3  # the global batch of 3 splits 2 / 1 over the ranks
CLI_ARGS = [
    "--synthetic", "--k_fold", "False", "--batch_size", "2", "--img_size", str(HW),
    "--filters", "4,8,12,16,24", "--num_heads", "2", "--seed", "42", "--device", "cpu",
    "--num_workers", "1",
]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _global_batch():
    rng = np.random.RandomState(11)
    x = rng.randn(B, HW, HW, 3).astype(np.float32)
    return x, (x.mean(-1) > 0.3).astype(np.int32)


def _cli_argv(root):
    return CLI_ARGS + ["--ckpt_dir", str(root / "ckpt"), "--out_dir", str(root / "out")]


@pytest.fixture(scope="module")
def variables():
    from lmnet_tpu.models import LMNet

    return _filled(LMNet(**TINY), (1, HW, HW, 3), 0)


@pytest.fixture(scope="module")
def launched(variables, tmp_path_factory):
    """The two ranks, started: (their directory, the processes)."""
    d = tmp_path_factory.mktemp("dp")
    torch.save(convert.jax_to_state_dict(variables), d / "sd.pt")
    x, y = _global_batch()
    torch.save({"x": torch.from_numpy(x), "y": torch.from_numpy(y).long()}, d / "batch.pt")
    spec = dict(tiny=TINY, hw=HW, seed=SEED, state_dict=str(d / "sd.pt"),
                batch=str(d / "batch.pt"), dir=str(d), cli_argv=_cli_argv(d),
                cases=["dist", "step", "epoch", "cross", "cli"])
    (d / "spec.json").write_text(json.dumps(spec))
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, WORKER, str(d / "spec.json")], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    yield d, procs
    for p in procs:
        if p.poll() is None:
            p.kill()


@pytest.fixture(scope="module")
def jax_step(variables, launched):
    """JAX's train-mode loss, running statistics and gradients on the global
    batch (the TINY model, 'xla' NAT, dropout off), compiled while the
    ranks run."""
    from lmnet_tpu.losses import segmentation_loss
    from lmnet_tpu.models import LMNet

    model = LMNet(**TINY, nat_backend="xla", rc_remat=False)

    def loss_fn(params, batch_stats, x, y):
        logits, mut = model.apply({"params": params, "batch_stats": batch_stats}, x, train=True,
                                  deterministic=True, mutable=["batch_stats"])
        return segmentation_loss(logits, y), mut["batch_stats"]

    x, y = _global_batch()
    (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"], jnp.asarray(x), jnp.asarray(y))
    loss, stats, grads = jax.device_get((loss, stats, grads))
    sd = convert.jax_to_state_dict({"params": variables["params"], "batch_stats": stats})
    return (float(loss), {k: v.numpy() for k, v in sd.items() if "running" in k},
            {k: v.numpy() for k, v in convert.jax_to_state_dict({"params": grads}).items()})


@pytest.fixture(scope="module")
def ranks(launched):
    """Both ranks' results, once they have ended."""
    d, procs = launched
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out[-4000:]
    return [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(2)]


def _port_model(variables, **kw):
    m = TLMNet(**TINY, **kw)
    m.load_state_dict(convert.jax_to_state_dict(variables), strict=True)
    return m


@pytest.mark.parametrize("backend", ["xla", "fused"])
def test_two_rank_step_matches_jax_and_one_process(variables, jax_step, ranks, backend,
                                                   monkeypatch):
    """One train_step over 2 ranks (rows 2 / 1) against JAX on the global
    batch and against the port's one-process step: the loss, every
    gradient (the ranks' mean) and the running statistics; both ranks end
    with bitwise-equal parameters and statistics."""
    j_loss, j_stats, j_grads = jax_step
    got = [r[f"step_{backend}"] for r in ranks]
    np.testing.assert_allclose(float(got[0]["loss"]), j_loss, rtol=1e-5)
    assert torch.equal(got[0]["loss"], got[1]["loss"])
    _close_grads({k: g.numpy() for k, g in got[0]["grads"].items()}, j_grads)
    for k, want in j_stats.items():
        _close(got[0]["state"][k].numpy(), want, 1e-4, 1e-5, k)
    for k, v in got[0]["state"].items():
        assert torch.equal(v, got[1]["state"][k]), k

    monkeypatch.setattr(t_blocks, "DROPOUT", 0.0)
    x, y = _global_batch()
    state = create_train_state(_port_model(variables, rc_train_backend=backend), (B, HW, HW, 3),
                               device="cpu")
    state, loss, cm = train_step(state, torch.from_numpy(x), torch.from_numpy(y).long(),
                                 ConfusionAccumulator.init(2))
    np.testing.assert_allclose(float(got[0]["loss"]), float(loss), rtol=1e-5)
    assert torch.equal(got[0]["cm"], cm)
    _close_grads({k: g.numpy() for k, g in got[0]["grads"].items()},
                 {n: p.grad.numpy() for n, p in state.model.named_parameters()})
    one = state.model.state_dict()
    for k in j_stats:
        _close(got[0]["state"][k].numpy(), one[k].numpy(), 1e-4, 1e-5, k)


def test_collectives_a_step(ranks):
    """Each train-mode BatchNorm all-reduces its sums once in the forward and
    once in the backward; rc_remat's recompute repeats the 16 ReparamConv
    blocks' 80; the loss takes two (CE, Dice); the gradients one."""
    bns = 16 * 5 + 4
    want = {"forward": bns + 16 * 5 + 2, "backward": bns + 2, "grads": 1}
    for r in ranks:
        assert r["step_xla"]["collectives"] == want
        assert r["step_fused"]["collectives"] == want


def test_dist_utils_and_mesh_on_two_ranks(ranks):
    """The six dist_utils names, reduce_value, the mesh's dims, the row
    split (numpy.array_split's), shard_batch, and replicate making every
    parameter, statistic and the step count rank 0's."""
    x = np.arange(5 * 4, dtype=np.float32).reshape(5, 2, 2)
    for rank, r in enumerate(ranks):
        d = r["dist"]
        assert (d["rank"], d["world"], d["main"], d["initialized"]) == (rank, 2, rank == 0, True)
        assert d["sum"] == 3.0 and d["mean"] == 1.5
        assert d["mesh"] == (("data", "spatial"), (2, 1))
        assert d["placements"] == ["Shard(dim=0)", "Replicate()"]
        want_rows = [(0, 1), (0, 1), (0, 3), (0, 4)] if rank == 0 else [(1, 1), (1, 2), (3, 5),
                                                                        (4, 8)]
        assert [tuple(t) for t in d["rows"]] == want_rows
        part = np.array_split(x, 2)[rank]
        np.testing.assert_array_equal(d["shard"][0].numpy(), part)
        np.testing.assert_array_equal(d["shard"][1].numpy(), part[..., 0] > 5)
        assert d["step"] == 0
    for k, v in ranks[0]["dist"]["replicated"].items():
        assert torch.equal(v, ranks[1]["dist"]["replicated"][k]), k


def test_two_rank_epoch_eval_and_serving_match_one_process(variables, ranks):
    """Two epochs of train_one_epoch (augmentation and dropout on, batches
    of 3 over 5 images: rows 2 / 1, then 1 / 1) against one process: the
    train loss rtol 1e-5 and the train metrics to 1e-12 (the same
    confusion matrix), the parameters after each epoch within 1e-2. The
    ranks' evaluate with HD95 (batches of 2 over 5 images: the tail leaves
    rank 1 none) and serving_evaluate against one process on the ranks'
    own state: eval loss rtol 1e-5, metrics to 1e-12; served (bf16) by
    PERF.md's bf16 serving rule: loss rtol 0.02, accuracy within 0.025
    (argmax flips < 2.5 %), the other metrics within 0.02; HD95 within a
    pixel.

    Why the parameters only within 1e-2: a gradient that is zero in exact
    arithmetic (a conv bias before a train-mode BatchNorm) is float noise
    whose sign follows the order of the sums, and AdamW turns it into steps
    of up to the learning rate; the train-mode BatchNorm cancels them, the
    eval forward on running statistics does not, so eval is compared on
    one state. Why served metrics only within a rule: bf16 on the CPU
    rounds a batch of 1 and of 2 rows differently (one process shows the
    same flips at batch sizes 1 and 2)."""
    state = create_train_state(_port_model(variables), (3, HW, HW, 3), seed=SEED, device="cpu",
                               epochs=2, steps_per_epoch=2)
    train = SyntheticDataset(5, HW, "train", seed=SEED)
    val = SyntheticDataset(5, HW, "val", seed=SEED + 1)
    got = ranks[0]["epoch"]
    assert got["losses"] == ranks[1]["epoch"]["losses"]
    assert got["metrics"] == ranks[1]["epoch"]["metrics"]

    def close_metrics(have, want, atol=1e-12):
        assert have.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_allclose(have[k], v, rtol=0, atol=atol, err_msg=k)

    for epoch in range(2):
        state, tl, tm = train_one_epoch(state, make_loader(train, 3, shuffle=True, seed=SEED,
                                                           epoch=epoch, num_threads=1),
                                        img_size=HW, seed=SEED, epoch=epoch)
        tm.pop("images_per_sec")
        np.testing.assert_allclose(got["losses"][epoch][0], tl, rtol=1e-5)
        close_metrics(got["metrics"][epoch][0], tm)
        for k, v in state.model.state_dict().items():
            np.testing.assert_allclose(got["states"][epoch][k].numpy(), v.numpy(), atol=1e-2,
                                       err_msg=k)
        same = create_train_state(TLMNet(**TINY), (3, HW, HW, 3), device="cpu")
        same.model.load_state_dict(got["states"][epoch])
        vl, vm = evaluate(same, make_loader(val, 2, num_threads=1), img_size=HW,
                          compute_hd95=True)
        np.testing.assert_allclose(got["losses"][epoch][1], vl, rtol=1e-5)
        close_metrics(got["metrics"][epoch][1], vm)
    sl, sm = serving_evaluate(got["states"][-1], make_loader(val, 2, num_threads=1), 2, HW,
                              num_heads=TINY["num_heads"], device="cpu", compute_hd95=True)
    np.testing.assert_allclose(got["serve"][0], sl, rtol=2e-2)
    for k, v in sm.items():
        np.testing.assert_allclose(got["serve"][1][k], v, err_msg=k,
                                   atol={"accuracy": 2.5e-2, "hd95": 1.0}.get(k, 2e-2))


def test_cross_host_evaluate_sums_the_ranks_shards(variables, ranks):
    """evaluate(cross_host=True): each rank evaluates its own shard whole;
    the matrix, the loss and the HD95 sums are summed over the ranks
    (JAX's _allreduce_eval): the loss is the sum of the shards' losses and
    the metrics those of the summed matrix."""
    from lmnet_tpu_torch.metrics import confusion_matrix, derived_metrics
    from lmnet_tpu_torch.data.augment import eval_pipeline

    state = create_train_state(_port_model(variables), (2, HW, HW, 3), device="cpu")
    total, cm = 0.0, ConfusionAccumulator.init(2)
    for rank in range(2):
        shard = SyntheticDataset(5, HW, "val", seed=SEED + 2).shard(rank, 2)
        total += evaluate(state, make_loader(shard, 2, num_threads=1), img_size=HW)[0]
        for images, masks in make_loader(shard, 2, num_threads=1):
            x, y = eval_pipeline(torch.from_numpy(images), torch.from_numpy(masks), HW)
            with torch.no_grad():
                cm += confusion_matrix(state.model(x).argmax(-1), y, 2)
    assert ranks[0]["cross"] == ranks[1]["cross"]
    loss, metrics = ranks[0]["cross"]
    np.testing.assert_allclose(loss, total, rtol=1e-6)
    want = {k: float(v) for k, v in derived_metrics(cm).items()}
    assert {k: metrics[k] for k in want} == want
    assert np.isnan(metrics["hd95"]) or metrics["hd95"] >= 0


def test_cli_distributed_matches_one_process(ranks, launched, tmp_path):
    """``--distributed True --device cpu`` on 2 ranks (2 epochs, --resume to
    3, --test) writes the CSV rows one process writes, within 5e-4 (the
    rows carry 4 decimals), and rank 0 alone writes: one row per epoch,
    one best row, one test row."""
    d, _ = launched
    cli.main(_cli_argv(tmp_path) + ["--epochs", "2"])
    cli.main(_cli_argv(tmp_path) + ["--epochs", "3", "--resume"])
    cli.main(_cli_argv(tmp_path) + ["--epochs", "3", "--test"])
    names = {"LM_NetKvasir_0.csv": 3, "LM_NetKvasirbestresult_0.csv": 1,
             "LM_NetKvasirtest_rvd_class.csv": 1}
    assert sorted(os.listdir(d / "out")) == sorted(names)
    for name, n in names.items():
        def rows(p):
            with open(p, encoding="utf-8") as f:
                return np.array([r for r in csv.reader(f) if r], dtype=np.float64)

        got, want = rows(d / "out" / name), rows(tmp_path / "out" / name)
        assert got.shape == want.shape and len(got) == n, name
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-4, err_msg=name)
    assert sorted(os.listdir(d / "ckpt")) == ["LM_NetKvasir_0_checkpoint", "LM_NetKvasirbest_0"]


@pytest.mark.parametrize("n,world", [(1, 2), (3, 2), (5, 2), (8, 4), (7, 3), (2, 4)])
def test_shard_rows_is_numpy_array_split(n, world):
    """The row blocks of every rank tile the batch as numpy.array_split
    does (the first n % W ranks one row longer)."""
    class Mesh:
        def __init__(self, rank):
            self.rank = rank

        def size(self, dim):
            return world

        def get_local_rank(self, dim):
            return self.rank

    parts = np.array_split(np.arange(n), world)
    for rank in range(world):
        np.testing.assert_array_equal(np.arange(n)[shard_rows(Mesh(rank), n)], parts[rank])


def test_one_process_is_a_no_op(monkeypatch):
    """Without a launcher's environment init_distributed_mode does nothing,
    as JAX's; rank 0 of 1, reduce_value gives its argument back, cleanup
    does nothing; make_mesh needs a group and refuses n_spatial > 1."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "SLURM_PROCID", "SLURM_NTASKS"):
        monkeypatch.delenv(k, raising=False)
    dist_utils.init_distributed_mode("cpu")
    assert not dist_utils.is_dist_avail_and_initialized()
    assert (dist_utils.get_rank(), dist_utils.get_world_size()) == (0, 1)
    assert dist_utils.is_main_process()
    v = torch.tensor([1.5])
    assert dist_utils.reduce_value(v) is v and dist_utils.reduce_value(2.0, False) == 2.0
    dist_utils.cleanup()
    with pytest.raises(RuntimeError, match="init_distributed_mode"):
        make_mesh(device_type="cpu")
    with pytest.raises(NotImplementedError, match="A8b"):
        make_mesh(n_spatial=2, device_type="cpu")


def test_a_group_of_one_from_a_launcher(monkeypatch):
    """A launcher's environment for one process (``torchrun --nproc_per_node
    1``) makes a group of one, on which a (1, 1) mesh is built and a
    train_step under it equals the plain step."""
    for k in ("SLURM_PROCID", "SLURM_NTASKS"):
        monkeypatch.delenv(k, raising=False)
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(_free_port())).items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(t_blocks, "DROPOUT", 0.0)
    dist_utils.init_distributed_mode("cpu")
    try:
        assert dist_utils.get_world_size() == 1 and dist_utils.is_dist_avail_and_initialized()
        assert torch.distributed.get_backend() == "gloo"
        mesh = make_mesh(device_type="cpu")
        assert tuple(mesh.shape) == (1, 1)
        x, y = _global_batch()
        out = []
        for m in (mesh, None):
            state = create_train_state(TLMNet(**TINY, generator=torch.Generator().manual_seed(0)),
                                       (B, HW, HW, 3), device="cpu")
            out.append(train_step(state, torch.from_numpy(x), torch.from_numpy(y).long(),
                                  ConfusionAccumulator.init(2), mesh=m)[1])
        torch.testing.assert_close(out[0], out[1], rtol=1e-6, atol=0)
    finally:
        dist_utils.cleanup()


def test_a_global_batch_refuses_other_threads():
    """While a global batch is open, a thread other than the one that opened
    it gets a RuntimeError from every helper instead of issuing all-reduces
    the other ranks never match, unless it runs a backward (autograd runs a
    card's backward on a thread of its own); the opening thread's backward,
    a checkpoint's recompute included, uses it too."""
    import threading

    import torch.utils.checkpoint

    errors, seen = [], []

    class Probe(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t):
            return t * 2

        @staticmethod
        def backward(ctx, g):
            seen.append(pbatch.dropout_rows(torch.ones, (1, 3)).shape)
            return g * 2

    def other():
        for call in (pbatch.active, lambda: pbatch.global_sum(torch.ones(2)),
                     lambda: pbatch.moments(torch.ones(2, 3), (0,)),
                     lambda: pbatch.global_count(torch.ones(2, 3)),
                     lambda: pbatch.dropout_rows(torch.ones, (1, 3))):
            try:
                call()
            except RuntimeError as e:
                errors.append(str(e))
        Probe.apply(torch.ones(3, requires_grad=True)).sum().backward()

    def body(t):
        seen.append(pbatch.dropout_rows(torch.ones, (1, 3)).shape)
        return t * t

    with pbatch.global_batch(None, 4, 1):
        thread = threading.Thread(target=other)
        thread.start()
        thread.join()
        x = torch.ones(3, requires_grad=True)
        torch.utils.checkpoint.checkpoint(body, x, use_reentrant=False).sum().backward()
        assert pbatch.active()
    assert len(errors) == 5 and all("another thread" in e for e in errors)
    # the foreign thread's backward, the forward and its recompute: each
    # this rank's row of a mask of the global batch's 4
    assert seen == [(1, 3)] * 3 and torch.equal(x.grad, 2 * torch.ones(3))
    assert not pbatch.active()
    other()
    assert len(errors) == 5 and len(seen) == 4


def test_batch_helpers_outside_a_global_batch():
    """Outside global_batch every helper is the one-process computation:
    moments is flax's statistics (_stats), global_sum the identity,
    global_count the element count, dropout_rows draws the shape asked."""
    xf = torch.randn(3, 4, 5, 6)
    for a, b in zip(pbatch.moments(xf, (0, 1, 2)), _stats(xf, (0, 1, 2))):
        assert torch.equal(a, b)
    assert pbatch.global_sum(xf) is xf and pbatch.global_count(xf) == xf.numel()
    assert pbatch.dropout_rows(lambda s: torch.zeros(s), (3, 4)).shape == (3, 4)
    assert not pbatch.active()

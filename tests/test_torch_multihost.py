"""The port's multi-node mode on the CPU, at TINY: a node stands for one JAX
process, with its own manifest shard, a global batch of N x the node's
batch and cross-host eval (``parallel/dist_utils.py``'s nodes,
``parallel/mesh.py::node_rows``, the loops, ``serving_evaluate`` and the
CLI).

Two simulated nodes of 1 rank and of 2 ranks are processes running
``tests/_torch_multihost_worker.py`` with the environment torchrun gives
the ranks of a multi-node job (GROUP_RANK, LOCAL_WORLD_SIZE, ...), each
node reading its own data; two more launches give a rank order and node
sizes the port refuses. While they run, this process compiles JAX's
gradient on the concatenated batch (node 0's rows, then node 1's: JAX's
``tests/test_multihost.py`` check 2, without its two-process JAX launch)
and runs the port in one process on the same concatenations. Tolerances
are ``PERF.md`` section 2's: the training row (loss rtol 1e-5, every
gradient as ``tests/test_torch_train.py::_close_grads``, running
statistics rtol 1e-4), an epoch's metrics to 1e-12, the serving rule, the
CLI's rows within 5e-4.
"""

import csv
import itertools
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
from lmnet_tpu_torch.data.augment import apply_params, draw_params
from lmnet_tpu_torch.metrics import ConfusionAccumulator, derived_metrics
from lmnet_tpu_torch.models import LMNet as TLMNet
from lmnet_tpu_torch.models import blocks as t_blocks
from lmnet_tpu_torch.serve import serving_evaluate
from lmnet_tpu_torch.train import create_train_state, evaluate, train_step
from lmnet_tpu_torch.train.loop import DROPOUT_STREAM, augment_generator, fold_seed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_multihost_worker.py")
HW, B, SEED = 32, 2, 3  # each node's batch of 2; the global batch of 4
TRAIN, VAL = (11, "train", SEED), (7, "val", SEED + 1)  # shards of 6 / 5 and 4 / 3
CLI_SEED = 42
CLI_ARGS = [
    "--synthetic", "--k_fold", "False", "--batch_size", str(B), "--img_size", str(HW),
    "--filters", "4,8,12,16,24", "--num_heads", "2", "--seed", str(CLI_SEED), "--device", "cpu",
    "--num_workers", "1",
]
# (nodes, ranks a node, cases); the refusals give each rank (node, local
# rank, ranks on its node) themselves
LAYOUTS = {
    "2x1": (2, 1, ["dist", "step", "epoch", "eval", "serve", "cli"]),
    "2x2": (2, 2, ["dist", "step", "epoch", "eval", "serve", "batch"]),
}
REFUSALS = {
    "order": [(1, 0, 1), (0, 0, 1)],  # rank 0 on node 1
    "sizes": [(0, 0, 2), (0, 1, 2), (1, 0, 1)],  # nodes of 2 and 1 ranks
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _global_batch():
    rng = np.random.RandomState(13)
    x = rng.randn(2 * B, HW, HW, 3).astype(np.float32)
    return x, (x.mean(-1) > 0.3).astype(np.int32)


def _shard(spec, node):
    n, mode, seed = spec
    return SyntheticDataset(n, HW, mode, seed=seed).shard(node, 2)


def _start(d, ranks, spec, port):
    """One worker a rank: ``ranks`` lists each rank's (node, local rank,
    ranks on its node)."""
    spec = dict(spec, dir=str(d))
    (d / "spec.json").write_text(json.dumps(spec))
    procs = []
    for rank, (node, local, size) in enumerate(ranks):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("SLURM_", "GROUP_", "LOCAL_", "RANK", "WORLD_"))}
        env.update(RANK=str(rank), WORLD_SIZE=str(len(ranks)), LOCAL_RANK=str(local),
                   LOCAL_WORLD_SIZE=str(size), GROUP_RANK=str(node), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, WORKER, str(d / "spec.json")], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    return procs


@pytest.fixture(scope="module")
def variables():
    from lmnet_tpu.models import LMNet

    return _filled(LMNet(**TINY), (1, HW, HW, 3), 0)


@pytest.fixture(scope="module")
def launched(variables, tmp_path_factory):
    """Every launch, started: {name: (its directory, its processes)}."""
    root = tmp_path_factory.mktemp("mh")
    torch.save(convert.jax_to_state_dict(variables), root / "sd.pt")
    x, y = _global_batch()
    for node in range(2):
        rows = slice(node * B, (node + 1) * B)
        torch.save({"x": torch.from_numpy(x[rows]), "y": torch.from_numpy(y[rows]).long()},
                   root / f"batch{node}.pt")
    base = dict(tiny=TINY, hw=HW, seed=SEED, batch=B, train=TRAIN, val=VAL,
                state_dict=str(root / "sd.pt"), node_batch=str(root / "batch{node}.pt"))
    out = {}
    for name, (nodes, local, cases) in LAYOUTS.items():
        d = root / name
        d.mkdir()
        spec = dict(base, cases=cases, cli_argv=CLI_ARGS + [
            "--ckpt_dir", str(d / "ckpt"), "--out_dir", str(d / "out")])
        ranks = [(n, r, local) for n in range(nodes) for r in range(local)]
        out[name] = d, _start(d, ranks, spec, _free_port())
    for name, ranks in REFUSALS.items():
        d = root / name
        d.mkdir()
        out[name] = d, _start(d, ranks, dict(base, cases=[]), _free_port())
    yield out
    for _, procs in out.values():
        for p in procs:
            if p.poll() is None:
                p.kill()


def _results(launched, name):
    d, procs = launched[name]
    for p in procs:
        said, _ = p.communicate(timeout=300)
        assert p.returncode == 0, said[-4000:]
    return [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(len(procs))]


@pytest.fixture(scope="module")
def jax_step(variables, launched):
    """JAX's train-mode loss, running statistics and gradients on the
    concatenated batch (the TINY model, 'xla' NAT, dropout off), compiled
    while the ranks run."""
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
    """Each layout's ranks' results, once they have ended."""
    return {name: _results(launched, name) for name in LAYOUTS}


def _state(variables, rows, **kw):
    m = TLMNet(**TINY)
    m.load_state_dict(convert.jax_to_state_dict(variables), strict=True)
    return create_train_state(m, (rows, HW, HW, 3), device="cpu", **kw)


def _close_metrics(have, want, atol=1e-12):
    assert have.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(have[k], v, rtol=0, atol=atol, err_msg=k)


def _node_batches(spec, node):
    return list(make_loader(_shard(spec, node), B, num_threads=1))


def _concatenated(spec):
    """The global batches: each node's batch i, node 0's rows first."""
    out = []
    for b0, b1 in itertools.zip_longest(*(_node_batches(spec, k) for k in range(2))):
        parts = [b for b in (b0, b1) if b is not None]
        out.append(tuple(np.concatenate([p[i] for p in parts]) for i in range(2)))
    return out


def _one_process(variables):
    """The port in one process on the concatenations (dropout off): the
    train step on the global batch (loss, gradients, state, matrix); the
    augmented epoch over the nodes' train shards, each node's batch i
    augmented with batch i's draws (the draws, the loss, the metrics);
    evaluate over both val shards in node order and over the global
    batches; serving_evaluate over the global batches."""
    held, t_blocks.DROPOUT = t_blocks.DROPOUT, 0.0
    try:
        x, y = _global_batch()
        state, loss, cm = train_step(_state(variables, 2 * B), torch.from_numpy(x),
                                     torch.from_numpy(y).long(), ConfusionAccumulator.init(2))
        step = {"loss": loss, "cm": cm, "state": state.model.state_dict(),
                "grads": {n: p.grad.numpy() for n, p in state.model.named_parameters()}}
        state = _state(variables, B, seed=SEED, epochs=1, steps_per_epoch=2)
        cm, total, draws = ConfusionAccumulator.init(2), 0.0, []
        loaders = [iter(make_loader(_shard(TRAIN, k), B, shuffle=True, seed=SEED,
                                    drop_last=True, num_threads=1)) for k in range(2)]
        for bi in range(2):
            xs, ys = [], []
            for loader in loaders:
                images, masks = next(loader)
                params = draw_params(augment_generator(SEED, 0, bi), B, images.shape[1:3], HW)
                x, y = apply_params(torch.from_numpy(images), torch.from_numpy(masks), params,
                                    HW)
                xs.append(x)
                ys.append(y)
            draws.append(params)
            state, loss, cm = train_step(state, torch.cat(xs), torch.cat(ys), cm)
            total += float(loss)
        epoch = {"draws": draws, "loss": total,
                 "metrics": {k: float(v) for k, v in derived_metrics(cm).items()}}
    finally:
        t_blocks.DROPOUT = held
    state = _state(variables, B)
    evals = {"cross": evaluate(state, itertools.chain(*(_node_batches(VAL, k) for k in range(2))),
                               img_size=HW, compute_hd95=True),
             "global": evaluate(state, _concatenated(VAL), img_size=HW, compute_hd95=True)}
    serve = serving_evaluate(convert.jax_to_state_dict(variables), _concatenated(VAL), 2, HW,
                             num_heads=TINY["num_heads"], device="cpu", compute_hd95=True)
    return {"step": step, "epoch": epoch, "eval": evals, "serve": serve}


@pytest.fixture(scope="module")
def one_process(variables, launched):
    """``_one_process``, computed while the ranks run."""
    return _one_process(variables)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_step_on_node_batches_matches_jax_and_one_process(jax_step, one_process, ranks, layout):
    """One train_step on each node's own batch of 2 (a global batch of 4)
    against JAX's step on the concatenated batch and against the port's one
    process on it: the loss, every gradient, the running statistics and
    the confusion matrix; every rank ends with bitwise-equal parameters and
    statistics."""
    j_loss, j_stats, j_grads = jax_step
    got = [r["step"] for r in ranks[layout]]
    np.testing.assert_allclose(float(got[0]["loss"]), j_loss, rtol=1e-5)
    _close_grads({k: g.numpy() for k, g in got[0]["grads"].items()}, j_grads)
    for k, want in j_stats.items():
        _close(got[0]["state"][k].numpy(), want, 1e-4, 1e-5, k)
    for other in got[1:]:
        assert torch.equal(other["loss"], got[0]["loss"])
        for k, v in got[0]["state"].items():
            assert torch.equal(v, other["state"][k]), k

    one = one_process["step"]
    np.testing.assert_allclose(float(got[0]["loss"]), float(one["loss"]), rtol=1e-5)
    assert torch.equal(got[0]["cm"], one["cm"])
    _close_grads({k: g.numpy() for k, g in got[0]["grads"].items()}, one["grads"])
    for k in j_stats:
        _close(got[0]["state"][k].numpy(), one["state"][k].numpy(), 1e-4, 1e-5, k)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_augmented_epoch_matches_one_process_on_the_concatenation(one_process, ranks, layout):
    """train_one_epoch over each node's train shard (6 and 5 images, batches
    of 2: 3 and 2 batches, so every node takes the smallest node's 2 steps).
    Every node's draws are draw_params for its 2 rows from batch i's
    generator, the same on every node (JAX's shared aug_key); the epoch's
    loss (rtol 1e-5) and metrics (1e-12) are one process's that augments
    each node's batch with those draws and steps on the concatenation."""
    got = [r["epoch"] for r in ranks[layout]]
    one = one_process["epoch"]
    local = LAYOUTS[layout][1]
    assert [g["steps"] for g in got] == [2] * len(got)
    assert [g["shard"] for g in got] == [6] * local + [5] * local
    for g in got:
        for have, want in zip(g["draws"], one["draws"], strict=True):
            assert have.keys() == want.keys()
            assert all(torch.equal(have[k], v) for k, v in want.items())
        assert g["loss"] == got[0]["loss"]
        np.testing.assert_allclose(g["loss"], one["loss"], rtol=1e-5)
        metrics = dict(g["metrics"])
        assert metrics.pop("images_per_sec") > 0
        _close_metrics(metrics, one["metrics"])


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_evaluate_counts_each_shard_once(one_process, ranks, layout):
    """evaluate on each node's val shard (4 and 3 images, batches of 2; with
    2 ranks a node the node's ranks split each batch, and node 1's tail of
    1 leaves its second rank none). Cross-host: the loss is the sum of the
    two shards' losses (rtol 1e-6) and the metrics those of their summed
    matrix, not L times it; without it, the nodes' batches i are one batch
    (loss rtol 1e-5, metrics to 1e-12)."""
    got = [r["eval"] for r in ranks[layout]]
    assert all(g == got[0] for g in got)
    want = one_process["eval"]
    np.testing.assert_allclose(got[0]["cross"][0], want["cross"][0], rtol=1e-6)
    _close_metrics(got[0]["cross"][1], want["cross"][1])
    np.testing.assert_allclose(got[0]["global"][0], want["global"][0], rtol=1e-5)
    _close_metrics(got[0]["global"][1], want["global"][1])


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_serving_on_node_batches_matches_one_process(one_process, ranks, layout):
    """serving_evaluate (bf16) of each node's val batches against one
    process serving the concatenated batches, by the serving rule: loss
    rtol 0.02, accuracy within 0.025, the other metrics within 0.02, HD95
    within a pixel."""
    got = [r["serve"] for r in ranks[layout]]
    assert all(g == got[0] for g in got)
    loss, metrics = one_process["serve"]
    np.testing.assert_allclose(got[0][0], loss, rtol=2e-2)
    assert got[0][1].keys() == metrics.keys()
    for k, v in metrics.items():
        np.testing.assert_allclose(got[0][1][k], v, err_msg=k,
                                   atol={"accuracy": 2.5e-2, "hd95": 1.0}.get(k, 2e-2))


def _rows(path):
    with open(path, encoding="utf-8") as f:
        return np.array([r for r in csv.reader(f) if r], dtype=np.float64)


def test_cli_on_two_nodes_matches_one_process(ranks, launched, monkeypatch):
    """``--synthetic --distributed True --device cpu --epochs 1`` on 2 nodes
    (train shards of 4, batches of 2 a node: 2 steps of 4 rows), then
    ``--test``: rank 0 alone writes one 16-column row, one best row and one
    cross-host test row, each within 5e-4 of one process driving the same
    loops over the two shards' batches in node order (the same draws on
    both, dropout on: the masks are drawn at the global batch's shape)."""
    d, _ = launched["2x1"]
    assert all(r["cli"] for r in ranks["2x1"])
    monkeypatch.setattr(t_blocks, "DROPOUT", 0.1)
    model = TLMNet(**TINY, generator=torch.Generator().manual_seed(CLI_SEED))
    state = create_train_state(model, (B, HW, HW, 3), seed=CLI_SEED, device="cpu",
                               base_lr=1e-3, weight_decay=1e-4, epochs=1, steps_per_epoch=2)
    state.generator.manual_seed(fold_seed(CLI_SEED, 0, DROPOUT_STREAM))
    shards = [SyntheticDataset(n, HW, mode, seed=CLI_SEED).shard(k, 2)
              for n, mode in ((8, "train"), (4, "val")) for k in range(2)]
    loaders = [iter(make_loader(ds, B, shuffle=True, seed=CLI_SEED, drop_last=True,
                                num_threads=1)) for ds in shards[:2]]
    cm, total = ConfusionAccumulator.init(2), 0.0
    for bi in range(2):
        xs, ys = [], []
        for loader in loaders:
            images, masks = next(loader)
            params = draw_params(augment_generator(CLI_SEED, 0, bi), B, images.shape[1:3], HW)
            x, y = apply_params(torch.from_numpy(images), torch.from_numpy(masks), params, HW)
            xs.append(x)
            ys.append(y)
        state, loss, cm = train_step(state, torch.cat(xs), torch.cat(ys), cm)
        total += float(loss)
    names = ["accuracy", "precision", "recall", "specificity", "dice", "iou", "mean_iou"]
    tm = derived_metrics(cm)
    vl, vm = evaluate(state, itertools.chain(*(make_loader(ds, B, num_threads=1)
                                                for ds in shards[2:])), img_size=HW)
    row = [total] + [float(tm[k]) for k in names] + [vl] + [vm[k] for k in names]
    files = {"LM_NetKvasir_0.csv": [row], "LM_NetKvasirbestresult_0.csv": [row],
             "LM_NetKvasirtest_rvd_class.csv": [[vl] + [vm[k] for k in names]]}
    assert sorted(os.listdir(d / "out")) == sorted(files)
    for name, want in files.items():
        got = _rows(d / "out" / name)
        assert got.shape == np.shape(want), name
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-4, err_msg=name)
    assert sorted(os.listdir(d / "ckpt")) == ["LM_NetKvasir_0_checkpoint", "LM_NetKvasirbest_0"]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_nodes_rows_and_spatial_axis(ranks, layout):
    """Each rank knows its node (host_index, host_count, local_world_size);
    node_rows splits the node's batch over the node's data ranks, inside the
    global batch's rows of the rank (shard_rows of 2 nodes' 4 rows a node);
    shard_batch takes them; a 'spatial' axis stays inside a node or is
    refused."""
    nodes, local, _ = LAYOUTS[layout]
    x = np.arange(5 * 32 * 2, dtype=np.float32).reshape(5, 32, 2)
    for rank, r in enumerate(ranks[layout]):
        d = r["dist"]
        node, lr = divmod(rank, local)
        assert d["hosts"] == (node, nodes, local)
        for n, (start, stop) in d["rows"].items():
            part = np.array_split(np.arange(n), local)[lr]
            assert (start, stop) == ((part[0], part[-1] + 1) if len(part) else (stop, stop)), n
        g0, g1 = d["global_rows"]
        assert (g0 - 4 * node, g1 - 4 * node) == d["rows"][4]
        part = np.array_split(x, local)[lr]
        np.testing.assert_array_equal(d["shard"][0].numpy(), part)
        np.testing.assert_array_equal(d["shard"][1].numpy(), part > 7)
        if local == 1:
            assert "must divide the 1 ranks of a node" in d["spatial"]
        else:
            assert d["spatial"] == [2 * node, 2 * node + 1]


def test_batch_size_must_split_over_a_nodes_ranks(ranks):
    """--batch_size 3 on 2 nodes of 2 ranks: SystemExit on every rank before
    anything is written (JAX checks the global data axis, 4 here)."""
    for r in ranks["2x2"]:
        assert "must be divisible by the 2-rank data axis of a node" in r["batch"]


@pytest.mark.parametrize("name,words", [("order", "numbered node-major"),
                                        ("sizes", "unequal numbers of ranks")])
def test_refused_layouts(launched, name, words):
    """A rank order that is not node-major, and nodes of unequal sizes: every
    rank's init_distributed_mode raises, and leaves no process group."""
    for r in _results(launched, name):
        assert words in r["error"] and not r["initialized"], r


@pytest.mark.parametrize("img,world,local,want", [(512, 4, 1, 1), (512, 4, 2, 2), (512, 6, 3, 1),
                                                  (256, 4, 2, 1), (512, 2, 2, 2)])
def test_n_spatial_auto_on_nodes(img, world, local, want):
    """'auto' picks 2 at --img_size >= 512 only where a node's ranks are
    even; a given value must divide them (SystemExit otherwise)."""
    args = cli.build_parser().parse_args(["--img_size", str(img)])
    assert cli.resolve_n_spatial(args, world, local) == want
    args.n_spatial = 2
    if local % 2:
        with pytest.raises(SystemExit, match=f"must divide the {local} ranks of a node"):
            cli.resolve_n_spatial(args, world, local)
    else:
        assert cli.resolve_n_spatial(args, world, local) == 2

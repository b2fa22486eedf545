"""One rank of the port's multi-node runs (tests/test_torch_multihost.py).

Launched once for each rank with the environment torchrun gives a rank of
a multi-node job (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE,
GROUP_RANK, MASTER_ADDR, MASTER_PORT) and the path of a JSON spec the
parent wrote. A node stands for one JAX process; every rank of a node
reads the node's own data. Imports torch and lmnet_tpu_torch only, never
JAX. Joins a gloo group on the CPU and runs, in this order:

  init    the group alone; a RuntimeError from the node check is saved
  dist    the nodes, node_rows, shard_batch of the node's batch, make_mesh
          with a 'spatial' axis that does and does not divide a node
  step    one train_step on the node's batch of the global batch (dropout
          off): loss, every gradient, the state after the update
  epoch   train_one_epoch (augmentation on, dropout off) over the node's
          train shard for the smallest node's steps, with the draws each
          batch took
  eval    evaluate of the node's val shard, cross-host and as global
          batches, with HD95
  serve   serving_evaluate of the node's val batches
  cli     the CLI with --distributed True --device cpu: 1 epoch, --test
  batch   the CLI with a --batch_size that does not split over a node

and saves what each case gave to ``rank{RANK}.pt`` in the spec's directory.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

torch.set_num_threads(1)

from lmnet_tpu_torch.data import SyntheticDataset, make_loader  # noqa: E402
from lmnet_tpu_torch.metrics import ConfusionAccumulator  # noqa: E402
from lmnet_tpu_torch.models import LMNet, blocks  # noqa: E402
from lmnet_tpu_torch.parallel import dist_utils  # noqa: E402
from lmnet_tpu_torch.parallel.mesh import (  # noqa: E402
    make_mesh,
    node_rows,
    replicate,
    shard_batch,
    shard_rows,
    spatial_group,
)
from lmnet_tpu_torch.serve import serving_evaluate  # noqa: E402
from lmnet_tpu_torch.train import (  # noqa: E402
    create_train_state,
    evaluate,
    loop,
    train_one_epoch,
    train_step,
)


def _model(spec):
    m = LMNet(**spec["tiny"])
    m.load_state_dict(torch.load(spec["state_dict"], weights_only=True), strict=True)
    return m


def _state(spec, rows, **kw):
    return create_train_state(_model(spec), (rows, spec["hw"], spec["hw"], 3), device="cpu",
                              **kw)


def _shard(spec, name):
    n, mode, seed = spec[name]
    return SyntheticDataset(n, spec["hw"], mode, seed=seed).shard(dist_utils.host_index(),
                                                                  dist_utils.host_count())


def case_dist(spec, mesh, out):
    x = torch.arange(5 * 32 * 2, dtype=torch.float32).reshape(5, 32, 2)
    xs, ys = shard_batch(mesh, x.numpy(), (x > 7).numpy())
    try:  # the ranks of the 'spatial' axis, or why there is none
        spatial = sorted(torch.distributed.get_process_group_ranks(
            spatial_group(make_mesh(n_spatial=2, device_type="cpu"))))
    except ValueError as e:
        spatial = str(e)
    out["dist"] = {
        "hosts": (dist_utils.host_index(), dist_utils.host_count(),
                  dist_utils.local_world_size()),
        "rows": {n: (node_rows(mesh, n).start, node_rows(mesh, n).stop) for n in (1, 2, 4, 5)},
        "global_rows": (shard_rows(mesh, 8).start, shard_rows(mesh, 8).stop),
        "shard": (xs, ys), "spatial": spatial,
    }


def case_step(spec, mesh, out):
    data = torch.load(spec["node_batch"].format(node=dist_utils.host_index()), weights_only=True)
    x, y = data["x"], data["y"]
    rows = node_rows(mesh, len(x))
    state = _state(spec, len(x))
    replicate(mesh, state)
    cm = ConfusionAccumulator.init(2)
    state, loss, cm = train_step(state, x[rows], y[rows], cm, mesh=mesh,
                                 global_rows=len(x) * dist_utils.host_count())
    torch.distributed.all_reduce(cm)
    out["step"] = {
        "loss": loss, "cm": cm,
        "grads": {n: p.grad.clone() for n, p in state.model.named_parameters()},
        "state": {k: v.clone() for k, v in state.model.state_dict().items()},
    }


def case_epoch(spec, mesh, out):
    from lmnet_tpu_torch.cli.train import _common_steps

    hw, seed, b = spec["hw"], spec["seed"], spec["batch"]
    shard = _shard(spec, "train")
    steps = _common_steps(len(shard), b, torch.device("cpu"))
    draws = []
    draw = loop.draw_params

    def recorded(*args, **kw):
        draws.append(draw(*args, **kw))
        return draws[-1]

    loop.draw_params = recorded
    state = _state(spec, b, seed=seed, epochs=1, steps_per_epoch=steps)
    replicate(mesh, state)
    state, tl, tm = train_one_epoch(state, make_loader(shard, b, shuffle=True, seed=seed,
                                                       drop_last=True, num_threads=1),
                                    img_size=hw, seed=seed, epoch=0, mesh=mesh, steps=steps)
    loop.draw_params = draw
    out["epoch"] = {"loss": tl, "metrics": tm, "steps": steps, "shard": len(shard),
                    "draws": draws,
                    "state": {k: v.clone() for k, v in state.model.state_dict().items()}}


def case_eval(spec, mesh, out):
    state = _state(spec, 2)
    loader = lambda: make_loader(_shard(spec, "val"), spec["batch"], num_threads=1)  # noqa: E731
    out["eval"] = {
        "cross": evaluate(state, loader(), img_size=spec["hw"], compute_hd95=True, mesh=mesh,
                          cross_host=True),
        "global": evaluate(state, loader(), img_size=spec["hw"], compute_hd95=True, mesh=mesh),
    }


def case_serve(spec, mesh, out):
    loader = make_loader(_shard(spec, "val"), spec["batch"], num_threads=1)
    out["serve"] = serving_evaluate(_model(spec).state_dict(), loader, 2, spec["hw"],
                                    num_heads=spec["tiny"]["num_heads"], device="cpu",
                                    compute_hd95=True, mesh=mesh)


def case_cli(spec, mesh, out):
    from lmnet_tpu_torch.cli import train as cli

    argv = spec["cli_argv"] + ["--distributed", "True"]
    cli.main(argv + ["--epochs", "1"])
    cli.main(argv + ["--epochs", "1", "--test"])
    out["cli"] = True


def case_batch(spec, mesh, out):
    from lmnet_tpu_torch.cli import train as cli

    argv = spec["cli_argv"] + ["--distributed", "True", "--epochs", "1", "--batch_size", "3"]
    try:
        cli.main(argv)
        out["batch"] = "ran"
    except SystemExit as e:
        out["batch"] = str(e)


def main():
    with open(sys.argv[1], encoding="utf-8") as f:
        spec = json.load(f)
    rank = int(os.environ["RANK"])
    try:
        dist_utils.init_distributed_mode("cpu")
    except RuntimeError as e:
        torch.save({"error": str(e), "initialized": dist_utils.is_dist_avail_and_initialized()},
                   os.path.join(spec["dir"], f"rank{rank}.pt"))
        return
    blocks.DROPOUT = 0.0
    mesh = make_mesh(device_type="cpu")
    out = {}
    for case in spec["cases"]:
        if case == "cli":  # the CLI trains with dropout on
            blocks.DROPOUT = 0.1
        globals()[f"case_{case}"](spec, mesh, out)
    torch.save(out, os.path.join(spec["dir"], f"rank{rank}.pt"))
    dist_utils.cleanup()


if __name__ == "__main__":
    main()

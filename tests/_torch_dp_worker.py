"""One rank of the port's data-parallel runs (tests/test_torch_parallel.py).

Launched once for each rank with torchrun's environment (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and the path of a JSON spec the
parent wrote. Imports torch and lmnet_tpu_torch only, never JAX: the parent
holds the results against JAX and against one process. Joins a gloo group
on the spec's device (the CPU, or ranks sharing one card, whose CUDA
tensors gloo carries through the host) and runs, in this order:

  dist    the dist_utils names, reduce_value, the mesh helpers, replicate
  step    one train_step per rc_train_backend ('xla', 'fused') on the
          spec's global batch (dropout off): loss, every gradient, the
          running statistics and the parameters after the update
  epoch   train_one_epoch (augmentation and dropout on) + evaluate over
          loaders with ragged batches, then serving_evaluate
  cross   evaluate(cross_host=True) on this rank's shard of a val set
  cli     the CLI with --distributed True --device cpu: 2 epochs, --resume
          to 3, --test
  card    on the card: one float32 train_step of the full-width model,
          'flat' NAT and rc_train_backend='fused' (dropout on), and the
          rank's B1, B2, B5 and B6 launches in it

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
from lmnet_tpu_torch.parallel import batch as pbatch  # noqa: E402
from lmnet_tpu_torch.parallel import dist_utils  # noqa: E402
from lmnet_tpu_torch.parallel.mesh import (  # noqa: E402
    batch_sharding,
    make_mesh,
    replicate,
    shard_batch,
    shard_rows,
)
from lmnet_tpu_torch.serve import serving_evaluate  # noqa: E402
from lmnet_tpu_torch.train import (  # noqa: E402
    create_train_state,
    evaluate,
    train_one_epoch,
    train_step,
)


def _model(spec, **kw):
    m = LMNet(**spec["tiny"], **kw)
    m.load_state_dict(torch.load(spec["state_dict"], weights_only=True), strict=True)
    return m


def case_dist(spec, mesh, out):
    rank, world = dist_utils.get_rank(), dist_utils.get_world_size()
    x = torch.arange(5 * 4, dtype=torch.float32).reshape(5, 2, 2)
    xs, ys = shard_batch(mesh, x.numpy(), (x[..., 0] > 5).numpy())
    m = LMNet(**spec["tiny"], generator=torch.Generator().manual_seed(100 + rank))
    state = create_train_state(m, (2, spec["hw"], spec["hw"], 3), seed=rank, device="cpu")
    state.step = 7 * rank
    replicate(mesh, state)
    out["dist"] = {
        "rank": rank, "world": world, "main": dist_utils.is_main_process(),
        "initialized": dist_utils.is_dist_avail_and_initialized(),
        "sum": float(dist_utils.reduce_value(float(rank + 1), average=False)),
        "mean": float(dist_utils.reduce_value(torch.tensor(float(rank + 1)))),
        "mesh": (mesh.mesh_dim_names, tuple(mesh.shape)),
        "rows": [(shard_rows(mesh, n).start, shard_rows(mesh, n).stop) for n in (1, 2, 5, 8)],
        "placements": [repr(p) for p in batch_sharding(mesh, spatial=False)],
        "shard": (xs, ys),
        "replicated": {k: v.clone() for k, v in state.model.state_dict().items()},
        "step": state.step,
    }


def case_step(spec, mesh, out):
    blocks.DROPOUT = 0.0
    data = torch.load(spec["batch"], weights_only=True)
    x, y = data["x"], data["y"]
    rows = shard_rows(mesh, len(x))
    for backend in ("xla", "fused"):
        state = create_train_state(_model(spec, rc_train_backend=backend),
                                   (len(x), spec["hw"], spec["hw"], 3), device="cpu")
        replicate(mesh, state)
        before = dict(pbatch.COUNTS)
        cm = ConfusionAccumulator.init(2)
        state, loss, cm = train_step(state, x[rows], y[rows], cm, mesh=mesh, global_rows=len(x))
        torch.distributed.all_reduce(cm)
        out[f"step_{backend}"] = {
            "loss": loss, "cm": cm,
            "grads": {n: p.grad.clone() for n, p in state.model.named_parameters()},
            "state": {k: v.clone() for k, v in state.model.state_dict().items()},
            "collectives": {k: pbatch.COUNTS[k] - before[k] for k in before},
        }
    blocks.DROPOUT = 0.1


def case_epoch(spec, mesh, out):
    hw, seed = spec["hw"], spec["seed"]
    state = create_train_state(_model(spec), (3, hw, hw, 3), seed=seed, device="cpu",
                               epochs=2, steps_per_epoch=2)
    replicate(mesh, state)
    train = SyntheticDataset(5, hw, "train", seed=seed)
    val = SyntheticDataset(5, hw, "val", seed=seed + 1)
    losses, metrics, states = [], [], []
    for epoch in range(2):
        state, tl, tm = train_one_epoch(state, make_loader(train, 3, shuffle=True, seed=seed,
                                                           epoch=epoch, num_threads=1),
                                        img_size=hw, seed=seed, epoch=epoch, mesh=mesh)
        states.append({k: v.clone() for k, v in state.model.state_dict().items()})
        vl, vm = evaluate(state, make_loader(val, 2, num_threads=1), img_size=hw,
                          compute_hd95=True, mesh=mesh)
        tm.pop("images_per_sec")
        losses.append((tl, vl))
        metrics.append((tm, vm))
    sl, sm = serving_evaluate(state.model.state_dict(), make_loader(val, 2, num_threads=1), 2, hw,
                              num_heads=spec["tiny"]["num_heads"], device="cpu",
                              compute_hd95=True, mesh=mesh)
    out["epoch"] = {"losses": losses, "metrics": metrics, "serve": (sl, sm), "states": states}


def case_cross(spec, mesh, out):
    rank, world = dist_utils.get_rank(), dist_utils.get_world_size()
    state = create_train_state(_model(spec), (2, spec["hw"], spec["hw"], 3), device="cpu")
    val = SyntheticDataset(5, spec["hw"], "val", seed=spec["seed"] + 2).shard(rank, world)
    out["cross"] = evaluate(state, make_loader(val, 2, num_threads=1), img_size=spec["hw"],
                            compute_hd95=True, mesh=mesh, cross_host=True)


def case_cli(spec, out):
    from lmnet_tpu_torch.cli import train as cli

    argv = spec["cli_argv"] + ["--distributed", "True"]
    cli.main(argv + ["--epochs", "2"])
    cli.main(argv + ["--epochs", "3", "--resume"])
    cli.main(argv + ["--epochs", "3", "--test"])
    out["cli"] = True


def case_card(spec, mesh, out):
    from lmnet_tpu_torch.ops.nat_flat import nat_flat, nat_flat_bwd
    from lmnet_tpu_torch.ops.rc_flat import dw_gelu_flat
    from lmnet_tpu_torch.ops.rc_train import rc_branch_stats

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    data = torch.load(spec["batch"], weights_only=True)
    x, y = data["x"].to(dev), data["y"].to(dev)
    model = LMNet(generator=torch.Generator().manual_seed(spec["seed"]), nat_backend="flat",
                  rc_train_backend="fused", rc_remat=True)
    state = create_train_state(model, tuple(x.shape), seed=spec["seed"], device=dev)
    replicate(mesh, state)
    kernels = {"nat_fwd": nat_flat, "nat_bwd": nat_flat_bwd, "rc_dw_gelu": dw_gelu_flat,
               "rc_stats": rc_branch_stats}
    for fn in kernels.values():
        fn.launches = 0
    rows = shard_rows(mesh, len(x))
    cm = ConfusionAccumulator.init(2, dev)
    state, loss, cm = train_step(state, x[rows], y[rows], cm, mesh=mesh, global_rows=len(x))
    torch.distributed.all_reduce(cm)
    torch.cuda.synchronize()
    out["card"] = {
        "loss": float(loss), "cm": cm.cpu(),
        "grads": {n: p.grad.cpu() for n, p in state.model.named_parameters()},
        "state": {k: v.cpu() for k, v in state.model.state_dict().items()},
        "launches": {k: fn.launches for k, fn in kernels.items()},
    }


def main():
    with open(sys.argv[1], encoding="utf-8") as f:
        spec = json.load(f)
    device = spec.get("device", "cpu")
    dist_utils.init_distributed_mode(device, backend="gloo")
    mesh = make_mesh(device_type=device)
    out = {}
    for case in spec["cases"]:
        if case == "cli":
            case_cli(spec, out)
        else:
            globals()[f"case_{case}"](spec, mesh, out)
    torch.save(out, os.path.join(spec["dir"], f"rank{dist_utils.get_rank()}.pt"))
    dist_utils.cleanup()


if __name__ == "__main__":
    main()

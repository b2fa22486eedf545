"""One rank of the port's spatial-axis runs (tests/test_torch_spatial.py).

Launched once for each rank with torchrun's environment (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and the path of a JSON spec the
parent wrote. Imports torch and lmnet_tpu_torch only, never JAX: the parent
holds the results against JAX and against one process. Joins a gloo group
on the spec's device (the CPU, or ranks sharing one card), builds a (world
/ n_spatial, n_spatial) mesh and runs, in this order, the spec's cases:

  prims     each primitive on this rank's block of rows (float32, with its
            gradients): the convs, the upsample, the pyramid pool, SE's
            mean, the GFT, NAT on a slab, the dropout cut
  step      one train_step of the TINY model on the spec's global batch
            (dropout off): loss, gradients, running statistics, parameters
  fused     the same step with rc_train_backend='fused' and the 'flat'
            upsample (B6, B5 and B7 on the rank's slabs; their plain
            versions on the CPU), and its collectives
  serve_rc  the float32 logits of this rank's block through deploy_forward
            with rc_backend 'flat' (B5) and 'pallas' (B4), with the
            'einsum' and the 'flat' upsample (B7)
  eval      evaluate and serving_evaluate with HD95 over a val set
  options   the float32 logits of this rank's block: deploy_forward with
            natt_int8, ln_fold and skip_compose, and the train-mode forward
            with rc_train_backend='packed'
  fallback  an epoch and evaluate at an H the axis does not shard
  cli       the CLI with --distributed True --n_spatial 2 --device cpu
  cli_fused the same with --rc_train_backend fused and the 'flat' upsample
  card      on the card: one float32 train_step of the full-width model,
            'flat' NAT (B1 and B2 on the rank's slabs), dropout on, and
            the rank's B1 and B2 launches in it

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
from lmnet_tpu_torch.ops import resize  # noqa: E402
from lmnet_tpu_torch.ops.resize import upsample2x_align_corners  # noqa: E402
from lmnet_tpu_torch.parallel import batch as pbatch  # noqa: E402
from lmnet_tpu_torch.parallel import dist_utils  # noqa: E402
from lmnet_tpu_torch.parallel.mesh import (  # noqa: E402
    h_rows,
    make_mesh,
    replicate,
    shard_batch,
    shard_context,
    sum_group,
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


def _grad_run(fn, inputs, g_out, params=()):
    """fn(*inputs) on leaf copies, backward of sum(y * g_out): (y, the
    inputs' gradients, the params' gradients)."""
    leaves = [t.clone().requires_grad_() for t in inputs]
    y = fn(*leaves)
    (y * g_out).sum().backward()
    return y.detach(), [t.grad for t in leaves], [p.grad.clone() for p in params]


def case_prims(spec, mesh, out):
    """Each primitive inside the shard on this rank's block, from the
    parent's inputs (their whole maps): outputs and gradients."""
    from lmnet_tpu_torch.ops.nat import neighborhood_attention

    data = torch.load(spec["prims"], weights_only=True)
    got = {}
    with shard_context(mesh, True):
        def block(t):
            return t[:, h_rows(mesh, t.shape[1])]

        for name, c in data["convs"].items():
            got[name] = _grad_run(
                lambda x, w, b: blocks.conv_nhwc(x, w, b, c["stride"], c["groups"]),
                [block(c["x"]), c["w"], c["b"]], block(c["g"]))
        u = data["up"]
        got["up"] = _grad_run(upsample2x_align_corners, [block(u["x"])], block(u["g"]))
        p = data["pool"]
        got["pool"] = _grad_run(lambda *xs: blocks.pyramid_pool(xs[:-1], xs[-1]),
                                [block(x) for x in p["xs"]], block(p["g"]))
        s = data["se"]
        torch.manual_seed(0)
        se = blocks.SE(s["x"].shape[-1])
        se.load_state_dict(s["sd"])
        got["se"] = _grad_run(se, [block(s["x"])], block(s["g"]), list(se.parameters()))
        f = data["gft"]
        gft = blocks.GFT(f["x"].shape[-1], f["cout"], f["heads"])
        gft.load_state_dict(f["sd"])
        got["gft"] = _grad_run(gft, [block(f["x"])], block(f["g"]), list(gft.parameters()))
        for name, n in data["nat"].items():
            rpb = n["rpb"].clone().requires_grad_()
            C = n["x"].shape[-1] // 3

            def attend(xs):
                return neighborhood_attention(xs[..., :C], xs[..., C:2 * C], xs[..., 2 * C:],
                                              rpb, 3)

            y, gx, _ = _grad_run(lambda x: blocks.nat_rows(x, attend), [block(n["x"])],
                                 block(n["g"]))
            got[name] = (y, gx, [rpb.grad])
        d = data["dropout"]
        gen = torch.Generator().manual_seed(d["seed"])
        got["dropout"] = blocks.dropout_keep(tuple(block(d["like"]).shape), 0.5, gen, "cpu")
    out["prims"] = got


def _sharded_step(spec, mesh, **model_kw):
    """One train_step of the TINY model on the spec's global batch, dropout
    off: loss, confusion matrix, collectives, gradients and state."""
    blocks.DROPOUT = 0.0
    data = torch.load(spec["batch"], weights_only=True)
    x, y = data["x"], data["y"]
    state = create_train_state(_model(spec, **model_kw), tuple(x.shape), device="cpu")
    replicate(mesh, state)
    xs, ys = shard_batch(mesh, x, y, spatial=True)
    before = dict(pbatch.COUNTS)
    state, loss, cm = train_step(state, xs, ys, ConfusionAccumulator.init(2), mesh=mesh,
                                 global_rows=len(x), spatial=True)
    counts = {k: pbatch.COUNTS[k] - before[k] for k in before}
    torch.distributed.all_reduce(cm, group=sum_group(mesh, True))
    blocks.DROPOUT = 0.1
    return {
        "loss": loss, "cm": cm, "collectives": counts,
        "grads": {n: p.grad.clone() for n, p in state.model.named_parameters()},
        "state": {k: v.clone() for k, v in state.model.state_dict().items()},
    }


def case_step(spec, mesh, out):
    out["step"] = _sharded_step(spec, mesh)


def case_fused(spec, mesh, out):
    resize.UPSAMPLE_BACKEND = "flat"
    out["fused"] = _sharded_step(spec, mesh, rc_train_backend="fused")
    resize.UPSAMPLE_BACKEND = "einsum"


def case_serve_rc(spec, mesh, out):
    from lmnet_tpu_torch.models import structural_reparam
    from lmnet_tpu_torch.serve import deploy_forward

    data = torch.load(spec["batch"], weights_only=True)
    x = data["x"][:, h_rows(mesh, data["x"].shape[1])]
    deploy = structural_reparam(_model(spec).state_dict())
    got = {}
    with shard_context(mesh, True), torch.no_grad():
        for up in ("einsum", "flat"):
            resize.UPSAMPLE_BACKEND = up
            for rc in ("flat", "pallas"):
                got[rc, up] = deploy_forward(deploy, x, spec["tiny"]["num_heads"], "plain", rc)
    resize.UPSAMPLE_BACKEND = "einsum"
    out["serve_rc"] = got


def case_eval(spec, mesh, out):
    hw = spec["hw"]
    state = create_train_state(_model(spec), (2, hw, hw, 3), device="cpu")
    val = SyntheticDataset(5, hw, "val", seed=spec["seed"] + 1)
    ev = evaluate(state, make_loader(val, 2, num_threads=1), img_size=hw, compute_hd95=True,
                  mesh=mesh, spatial=True)
    sv = serving_evaluate(state.model.state_dict(), make_loader(val, 2, num_threads=1), 2, hw,
                          num_heads=spec["tiny"]["num_heads"], device="cpu", compute_hd95=True,
                          mesh=mesh, spatial=True, rc_backend="auto")
    out["eval"] = {"evaluate": ev, "serve": sv}


def case_options(spec, mesh, out):
    from lmnet_tpu_torch.models import structural_reparam
    from lmnet_tpu_torch.serve import deploy_forward

    data = torch.load(spec["batch"], weights_only=True)
    x = data["x"][:, h_rows(mesh, data["x"].shape[1])]
    deploy = structural_reparam(_model(spec).state_dict())
    got = {}
    with shard_context(mesh, True), torch.no_grad():
        for opt in ("natt_int8", "ln_fold", "skip_compose"):
            got[opt] = deploy_forward(deploy, x, spec["tiny"]["num_heads"], "plain",
                                      **{opt: True})
        with pbatch.global_batch(torch.distributed.group.WORLD, len(x), 0):
            got["packed"] = _model(spec, rc_train_backend="packed")(x, train=True,
                                                                    deterministic=True)
    out["options"] = got


def case_fallback(spec, mesh, out):
    hw = spec["fallback_hw"]
    state = create_train_state(_model(spec), (2, hw, hw, 3), seed=spec["seed"], device="cpu",
                               epochs=1, steps_per_epoch=2)
    replicate(mesh, state)
    train = SyntheticDataset(4, hw, "train", seed=spec["seed"])
    state, tl, tm = train_one_epoch(state, make_loader(train, 2, shuffle=True, seed=spec["seed"],
                                                       num_threads=1),
                                    img_size=hw, seed=spec["seed"], mesh=mesh, spatial=True)
    tm.pop("images_per_sec")
    ev = evaluate(state, make_loader(SyntheticDataset(3, hw, "val", seed=1), 2, num_threads=1),
                  img_size=hw, mesh=mesh, spatial=True)
    out["fallback"] = {"train": (tl, tm), "eval": ev,
                       "state": {k: v.clone() for k, v in state.model.state_dict().items()}}


def case_cli(spec, out, fused=False):
    from lmnet_tpu_torch.cli import train as cli

    argv = spec["cli_argv" if not fused else "cli_fused_argv"]
    argv = argv + ["--distributed", "True", "--n_spatial", "2"]
    if fused:
        argv += ["--rc_train_backend", "fused"]
        resize.UPSAMPLE_BACKEND = "flat"
    cli.main(argv + ["--epochs", "2"])
    cli.main(argv + ["--epochs", "2", "--test", "--hd95"])
    cli.main(argv + ["--epochs", "2", "--test", "--serve"])
    resize.UPSAMPLE_BACKEND = "einsum"
    out["cli_fused" if fused else "cli"] = True


def case_card(spec, mesh, out):
    from lmnet_tpu_torch.ops.nat_flat import nat_flat, nat_flat_bwd

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    data = torch.load(spec["batch"], weights_only=True)
    model = LMNet(generator=torch.Generator().manual_seed(spec["seed"]), nat_backend="flat")
    state = create_train_state(model, tuple(data["x"].shape), seed=spec["seed"], device=dev)
    replicate(mesh, state)
    x, y = shard_batch(mesh, data["x"], data["y"], spatial=True)
    nat_flat.launches = nat_flat_bwd.launches = 0
    state, loss, cm = train_step(state, x, y, ConfusionAccumulator.init(2, dev), mesh=mesh,
                                 global_rows=len(data["x"]), spatial=True)
    torch.distributed.all_reduce(cm, group=sum_group(mesh, True))
    torch.cuda.synchronize()
    out["card"] = {
        "loss": float(loss), "cm": cm.cpu(),
        "grads": {n: p.grad.cpu() for n, p in state.model.named_parameters()},
        "state": {k: v.cpu() for k, v in state.model.state_dict().items()},
        "launches": {"nat_fwd": nat_flat.launches, "nat_bwd": nat_flat_bwd.launches},
    }


def main():
    with open(sys.argv[1], encoding="utf-8") as f:
        spec = json.load(f)
    device = spec.get("device", "cpu")
    dist_utils.init_distributed_mode(device, backend="gloo")
    mesh = make_mesh(n_spatial=spec["n_spatial"], device_type=device)
    out = {}
    for case in spec["cases"]:
        if case in ("cli", "cli_fused"):
            case_cli(spec, out, fused=case == "cli_fused")
        else:
            globals()[f"case_{case}"](spec, mesh, out)
    torch.save(out, os.path.join(spec["dir"], f"rank{dist_utils.get_rank()}.pt"))
    dist_utils.cleanup()


if __name__ == "__main__":
    main()

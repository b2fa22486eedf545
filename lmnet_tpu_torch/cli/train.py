"""Training/eval CLI: ``python -m lmnet_tpu_torch.cli.train``.

Counterpart of ``lmnet_tpu/cli/train.py``, with the same flags, defaults,
modes and files, plus ``--device`` (default ``cuda``; ``cpu`` runs on the
CPU, nothing falls back to it on its own) and ``--rc_train_backend`` (the
model's ``rc_train_backend``, a field of JAX's ``LMNet`` that its CLI does
not expose; 'fused' trains through B6 and B5).

Modes:
  (default)        5-fold training loop (k_fold) or single fold
  --resume         restore rolling checkpoint, continue at epoch+1
  --test           load checkpoint, evaluate on test manifest, append CSV
                   (``--hd95``; ``--serve`` through the serving engine with
                   ``--natt_int8``, ``--rc_backend`` and ``--nat_backend``)
  --visualization  load best checkpoint, render predictions, exit
  --export PATH    structural_reparam the best checkpoint and write its
                   deploy graph as a torch.export artifact (serve/export.py;
                   served by ``python -m lmnet_tpu_torch.serve.daemon``), exit
  --plot           mDice curves from per-fold CSVs

Logging contract (reference train.py:218-224): per-epoch append of 16
columns (train/val x loss, accuracy, precision, recall, specificity, dice,
iou, mean_iou) to ``{model}{dataset}_{fold}.csv``; the best row to
``...bestresult_{fold}.csv``; test rows (8 columns, 9 with ``--hd95``) to
``{model}{dataset}test_rvd_class.csv``; checkpoints per
``train/checkpoint.py``.

``--distributed True`` trains data-parallel over the ranks of a process
group: ``torchrun --nproc_per_node N -m lmnet_tpu_torch.cli.train
--distributed True ...`` (NCCL, one card a rank; gloo with ``--device
cpu``; without a launcher, one process and no mesh). Every rank reads the
whole data set and builds the same global batches of ``--batch_size``
rows, takes its own rows of each (``parallel/mesh.py``), and computes the
loss and the BatchNorm statistics over the global batch, so N ranks train
as one process does; rank 0 alone writes the CSVs, checkpoints, figures and
artifacts. ``--n_spatial S`` puts S of the N ranks on the mesh's 'spatial'
axis: each image's H is split over them (halo exchanges between the
ranks, ``parallel/spatial.py``) where ``--img_size`` divides by 16 S, else
they run whole images; 0, the default, is JAX's 'auto': 2 at
``--img_size`` >= 512 on an even world size, else 1. S must divide N, and
``--batch_size`` the N / S ranks of the data axis. The reference's inert
flags (``--mixup``, ``--deep_supervision``, ``--smoothing``) stay inert, as in JAX;
``--syncBN`` too: the statistics are the global batch's under
``--distributed`` whatever it says.
"""

from __future__ import annotations

import argparse
import csv
import os
import random

import numpy as np
import torch


def set_seed(seed: int = 42) -> None:
    """Reference set_seed (data_loading.py:28-35): python and numpy; every
    torch draw takes an explicit generator, so nothing global."""
    random.seed(seed)
    np.random.seed(seed)


def str2bool(v) -> bool:
    """Boolean flag parser: '--k_fold False' really means False (the
    reference's ``type=bool`` parses every non-empty string as True)."""
    if isinstance(v, bool):
        return v
    if v.lower() in ("true", "t", "yes", "y", "1"):
        return True
    if v.lower() in ("false", "f", "no", "n", "0"):
        return False
    raise argparse.ArgumentTypeError(f"boolean value expected, got {v!r}")


def _rc_remat_arg(v):
    """--rc_remat value: a bool word, 'full', or 'branches'."""
    if v.lower() in ("full", "branches"):
        return v.lower()
    return str2bool(v)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="LM-Net training (PyTorch/CUDA port)")
    p.add_argument("--num_classes", type=int, default=2)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--syncBN", type=str2bool, default=True,
                   help="accepted for parity; under --distributed the BatchNorm "
                        "statistics are always the global batch's")
    p.add_argument("--smoothing", type=float, default=0.001,
                   help="accepted for parity; the loss uses 0.001, as in JAX")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--dataset", type=str, default="Kvasir",
                   choices=["Basic", "Kvasir", "BUSI", "CVCDataset", "VOC2012"])
    p.add_argument("--model", type=str, default="LM_Net")
    p.add_argument("--categories", type=str, default="binary",
                   choices=["binary", "multiclass", "multilabel"])
    p.add_argument("--visualization", action="store_true", default=False)
    p.add_argument("--test", action="store_true", default=False)
    p.add_argument("--resume", action="store_true", default=False)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--deep_supervision", type=str2bool, default=False,
                   help="accepted for parity; unused by the model (as in reference)")
    p.add_argument("--mixup", type=str2bool, default=False,
                   help="inert in the reference (train.py:150-153); kept for parity")
    p.add_argument("--apm", action="store_true", default=False,
                   help="mixed precision: bf16 compute policy (AMP analogue)")
    p.add_argument("--plot", action="store_true", default=False)
    p.add_argument("--plot_datasets", type=str, default="Kvasir,Basic,BUSI",
                   help="comma-separated datasets for the comparative "
                        "--plot figure (reference train.py:57)")
    p.add_argument("--distributed", type=str2bool, default=False,
                   help="split every batch over the ranks of the process group "
                        "(torchrun or SLURM; one process without a launcher)")
    p.add_argument("--n_spatial", type=int, default=0,
                   help="ranks on the mesh's 'spatial' axis, each holding a block "
                        "of every image's rows (under --distributed); 0 (auto): "
                        "2 at --img_size >= 512 on an even world size, else 1")
    p.add_argument("--k_fold", type=str2bool, default=True)
    p.add_argument("--hd95", action="store_true", default=False,
                   help="report 95th-pct Hausdorff distance on eval/test")
    p.add_argument("--natt_int8", action="store_true", default=False,
                   help="(with --test --serve) int8 NATT interiors")
    p.add_argument("--serve", action="store_true", default=False,
                   help="run --test inference through the serving engine "
                        "(structural_reparam + serve.deploy_forward)")
    p.add_argument("--export", type=str, default=None, metavar="PATH",
                   help="export the best checkpoint's re-parameterized deploy "
                        "graph (symbolic batch, --img_size square, bf16, "
                        "--natt_int8 honoured) to a torch.export artifact at "
                        "PATH and exit (serve/export.py)")
    p.add_argument("--rc_backend", type=str, default="xla",
                   choices=("auto", "xla", "flat", "pallas"),
                   help="(with --serve) ReparamConv backend: 'xla' the plain "
                        "graph, 'flat' the B5 kernel, 'pallas' the B4 kernel, "
                        "'auto' timed on the first batch")
    p.add_argument("--nat_backend", type=str, default="",
                   choices=("", "auto", "flat", "pallas", "xla"),
                   help="(with --serve) NAT backend: ''/'flat' the B1 kernel, "
                        "'pallas' the B3 kernel, 'xla' the plain NAT, 'auto' "
                        "timed on the first batch")
    p.add_argument("--img_size", type=int, default=256)
    p.add_argument("--manifest_dir", type=str, default="manifests")
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--ckpt_dir", type=str, default="checkpoints")
    p.add_argument("--out_dir", type=str, default="results")
    p.add_argument("--synthetic", action="store_true", default=False,
                   help="use the synthetic dataset (smoke tests, no files needed)")
    p.add_argument("--native_cache", action="store_true", default=False,
                   help="decode each image once into a binary cache, then "
                        "stream batches via the mmap'd C++ loader; falls back "
                        "to the threaded Python loader without a C++ toolchain")
    p.add_argument("--cache_dir", type=str, default="native_cache")
    p.add_argument("--filters", type=str, default=None,
                   help="comma-separated per-stage channel plan "
                        "(default: the reference's 12,24,48,96,192)")
    p.add_argument("--num_heads", type=int, default=None,
                   help="NAT heads (default: the reference's 12)")
    p.add_argument("--rc_remat", type=_rc_remat_arg, default=True,
                   help="recompute the ReparamConv blocks in the backward: "
                        "true/full (the whole block), branches (all but the "
                        "expand conv's output) or false")
    p.add_argument("--rc_train_backend", type=str, default="auto",
                   choices=("auto", "xla", "fused", "packed"),
                   help="the train-mode ReparamConv branch graph (LMNet's "
                        "rc_train_backend): 'auto'/'xla' the plain branches, "
                        "'fused' the B6 and B5 kernels, 'packed' one grouped conv")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train and evaluate on (default the "
                        "card; 'cpu' to run on the CPU)")
    return p


# the serving engine's names for the CLI's --nat_backend values
_NAT_BACKENDS = {"": "flat", "flat": "flat", "pallas": "pallas", "xla": "plain", "auto": "auto"}


def resolve_n_spatial(args, world: int) -> int:
    """``--n_spatial`` for a world of ``world`` ranks: 0 is JAX's 'auto' (2
    at ``--img_size`` >= 512 on an even world size, else 1); SystemExit
    unless it divides the world size."""
    n = args.n_spatial or (2 if args.img_size >= 512 and world % 2 == 0 else 1)
    if n < 1 or world % n:
        raise SystemExit(f"--n_spatial {n} must divide the world size {world}")
    return n


def _manifest(args, split: str, fold: int) -> str:
    name = {"CVCDataset": "CVC"}.get(args.dataset, args.dataset)
    if split == "test":
        return os.path.join(args.manifest_dir, f"test_{name}_0.1.csv")
    return os.path.join(args.manifest_dir, f"{split}_{name}_{fold}.csv")


def _datasets(args, fold: int):
    from lmnet_tpu_torch.data.datasets import SegmentationDataset, SyntheticDataset

    if args.synthetic:
        def mk(mode, n):
            return SyntheticDataset(n, args.img_size, mode, seed=args.seed)

        return mk("train", 8), mk("val", 4), mk("val", 4)
    kw = dict(img_size=args.img_size, root=args.data_root)
    train = SegmentationDataset.from_csv(_manifest(args, "train", fold), "train", **kw)
    val = SegmentationDataset.from_csv(_manifest(args, "val", fold), "val", **kw)
    test_csv = _manifest(args, "test", fold)
    test = SegmentationDataset.from_csv(test_csv, "val", **kw) if os.path.exists(test_csv) else val
    return train, val, test


def _loaders(args, datasets, epoch: int):
    from lmnet_tpu_torch.data.datasets import make_loader

    train, val, test = datasets
    if args.native_cache:
        from lmnet_tpu_torch.data import native_loader as nl

        if nl.native_available():
            def mkn(ds, sh, ep):
                return nl.make_native_loader(
                    ds, args.cache_dir, args.batch_size, shuffle=sh, seed=args.seed,
                    epoch=ep, num_threads=args.num_workers, drop_last=sh)

            return mkn(train, True, epoch), mkn(val, False, 0), mkn(test, False, 0)
        if not getattr(args, "_native_notice_printed", False):
            args._native_notice_printed = True
            print("--native_cache: C++ loader unavailable; using the threaded Python loader")

    def mk(ds, sh, ep):
        return make_loader(ds, args.batch_size, shuffle=sh, seed=args.seed, epoch=ep,
                           num_threads=args.num_workers, drop_last=sh)

    return mk(train, True, epoch), mk(val, False, 0), mk(test, False, 0)


def _write_row(path: str, row, mode: str = "a") -> None:
    with open(path, mode, encoding="utf-8", newline="") as fw:
        csv.writer(fw).writerow(f"{e:.4f}" for e in row)


def _device(args) -> torch.device:
    """``--device``, with a card's index made explicit: each rank's own
    (``init_distributed_mode`` made it the current one)."""
    device = torch.device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def main_single(fold: int, args) -> dict:
    from lmnet_tpu_torch.models import LMNet
    from lmnet_tpu_torch.parallel.dist_utils import (
        get_world_size,
        is_dist_avail_and_initialized,
        is_main_process,
    )
    from lmnet_tpu_torch.train import checkpoint as ckpt
    from lmnet_tpu_torch.train.engine import create_train_state
    from lmnet_tpu_torch.train.loop import evaluate, train_one_epoch, visualize

    set_seed(args.seed)
    datasets = _datasets(args, fold)
    steps_per_epoch = max(len(datasets[0]) // args.batch_size, 1)
    device = _device(args)

    mesh, spatial = None, False
    n_spatial = resolve_n_spatial(args, get_world_size()) if args.distributed else 1
    if args.distributed and is_dist_avail_and_initialized():
        from lmnet_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(n_spatial=n_spatial, device_type=device.type)
        spatial = n_spatial > 1
        n_data = mesh.size(0)
        if args.batch_size % n_data:
            raise SystemExit(f"--batch_size {args.batch_size} must be divisible by the "
                             f"{n_data}-rank data axis under --distributed")

    model_kw = {}
    if args.filters:
        model_kw["filters"] = tuple(int(c) for c in args.filters.split(","))
    if args.num_heads:
        model_kw["num_heads"] = args.num_heads
    model = LMNet(
        num_classes=args.num_classes,
        generator=torch.Generator().manual_seed(args.seed),
        dtype=torch.bfloat16 if args.apm else None,
        rc_remat=args.rc_remat,
        rc_train_backend=args.rc_train_backend,
        **model_kw,
    )
    state = create_train_state(
        model, (args.batch_size, args.img_size, args.img_size, 3), seed=args.seed,
        device=device, base_lr=args.lr, weight_decay=args.weight_decay,
        epochs=args.epochs, steps_per_epoch=steps_per_epoch,
    )
    if mesh is not None:
        from lmnet_tpu_torch.parallel.mesh import replicate

        state = replicate(mesh, state)

    tag = f"{args.model}{args.dataset}"
    rolling = f"{tag}_{fold}_checkpoint"
    best_name = f"{tag}best_{fold}"
    os.makedirs(args.out_dir, exist_ok=True)

    # -inf start: epoch 1 always writes a best checkpoint and bestresult row,
    # so --test/--visualization never see random-init weights
    start_epoch = 0
    resumed_best_iou = float("-inf")
    if args.resume and ckpt.checkpoint_exists(args.ckpt_dir, rolling):
        state, last_epoch, resumed_best_iou = ckpt.restore_checkpoint(args.ckpt_dir, rolling, state)
        start_epoch = last_epoch + 1
        print(f"resumed fold {fold} at epoch {start_epoch} (best_iou {resumed_best_iou:.4f})")

    def _require_checkpoint(name: str, mode: str):
        """Fail loudly when an eval mode has no trained weights."""
        if not ckpt.checkpoint_exists(args.ckpt_dir, name):
            raise SystemExit(f"{mode}: checkpoint '{name}' not found in {args.ckpt_dir!r} "
                             f"— train first (it is written every epoch)")
        return ckpt.restore_checkpoint(args.ckpt_dir, name, state)[0]

    if args.visualization:
        state = _require_checkpoint(best_name, "--visualization")
        if is_main_process():
            _, _, test_loader = _loaders(args, datasets, 0)
            n = visualize(state, test_loader, os.path.join(args.out_dir, "viz"),
                          args.num_classes, args.img_size)
            print(f"wrote {n} visualizations")
        return {}

    if args.export and not is_main_process():
        return {}
    if args.export:
        from lmnet_tpu_torch.models import structural_reparam
        from lmnet_tpu_torch.serve.export import save_deploy

        state = _require_checkpoint(best_name, "--export")
        path = save_deploy(
            args.export, structural_reparam(state.model.state_dict()), img_size=args.img_size,
            num_heads=args.num_heads or 12, natt_int8=args.natt_int8,
        )
        print(f"wrote serving artifact {path} ({os.path.getsize(path) / 1e6:.1f} MB)")
        return {}

    if args.test:
        state = _require_checkpoint(rolling, "--test")
        _, _, test_loader = _loaders(args, datasets, 0)
        if args.serve:
            from lmnet_tpu_torch.serve.engine import serving_evaluate

            test_loss, m = serving_evaluate(
                state.model.state_dict(), test_loader, args.num_classes, args.img_size,
                nat_backend=_NAT_BACKENDS[args.nat_backend], rc_backend=args.rc_backend,
                num_heads=args.num_heads or 12, natt_int8=args.natt_int8,
                task=args.categories, device=device, compute_hd95=args.hd95, mesh=mesh,
                spatial=spatial,
            )
        else:
            test_loss, m = evaluate(state, test_loader, args.num_classes, args.img_size,
                                    compute_hd95=args.hd95, task=args.categories, mesh=mesh,
                                    spatial=spatial)
        names = ["loss", "accuracy", "precision", "recall",
                 "specificity", "dice", "iou", "mean_iou"]
        if args.hd95:
            names.append("hd95")
        row = [test_loss] + [m[k] for k in names[1:]]
        print(" " + " ".join(f"test_{n}:{v:.4f}" for n, v in zip(names, row)))
        if is_main_process():
            _write_row(os.path.join(args.out_dir, f"{tag}test_rvd_class.csv"), row)
        return dict(zip(names, row))

    # resume restores the watermark, so a worse post-resume epoch cannot
    # overwrite the best checkpoint (fixes reference train.py:231-238)
    best_iou = resumed_best_iou
    last_metrics: dict = {}
    for epoch in range(start_epoch, args.epochs):
        print(f"epoch:{epoch + 1}")
        train_loader, val_loader, _ = _loaders(args, datasets, epoch)
        state, train_loss, tm = train_one_epoch(
            state, train_loader, args.num_classes, args.img_size, task=args.categories,
            seed=args.seed, epoch=epoch, mesh=mesh, spatial=spatial,
        )
        val_loss, vm = evaluate(state, val_loader, args.num_classes, args.img_size,
                                compute_hd95=args.hd95, task=args.categories, mesh=mesh,
                                spatial=spatial)
        print(
            " train_loss:{:.4f} train_dice:{:.4f} train_iou:{:.4f} "
            "val_loss:{:.4f} val_dice:{:.4f} val_iou:{:.4f} ({:.1f} img/s)".format(
                train_loss, tm["dice"], tm["iou"], val_loss, vm["dice"], vm["iou"],
                tm["images_per_sec"],
            )
        )
        row = [
            train_loss, tm["accuracy"], tm["precision"], tm["recall"],
            tm["specificity"], tm["dice"], tm["iou"], tm["mean_iou"],
            val_loss, vm["accuracy"], vm["precision"], vm["recall"],
            vm["specificity"], vm["dice"], vm["iou"], vm["mean_iou"],
        ]
        if is_main_process():
            _write_row(os.path.join(args.out_dir, f"{tag}_{fold}.csv"), row)
        # every rank calls save_checkpoint: rank 0 writes, the others wait;
        # vm is the ranks' sum, so every rank takes the same branch
        ckpt.save_checkpoint(args.ckpt_dir, rolling, state, epoch,
                             best_iou=max(best_iou, vm["iou"]))
        if vm["iou"] > best_iou:
            best_iou = vm["iou"]
            ckpt.save_checkpoint(args.ckpt_dir, best_name, state, epoch, best_iou=best_iou)
            if is_main_process():
                _write_row(os.path.join(args.out_dir, f"{tag}bestresult_{fold}.csv"), row, "w")
        last_metrics = {"val_iou": vm["iou"], "val_dice": vm["dice"],
                        "best_iou": best_iou, "epoch": epoch}
    return last_metrics


# display-name mapping from the reference's plot mode (train.py:63-86)
_MODEL_DISPLAY = {
    "my_unet": "LM-Net", "LM_Net": "LM-Net", "unet": "Unet",
    "unet++": "Unet++", "att_unet": "AttUnet", "res_unet": "ResUnet",
    "res_unet++": "ResUnet++", "trans_unet": "TransUnet",
    "res50+trans_unet": "R50-TransUnet", "uctrans_net": "UCTransNet",
    "swin_unet": "Swin-Unet", "deeplabv3+": "Deeplabv3+",
    "FCN_ResNet50": "FCN",
}
_DATASET_DISPLAY = {"Basic": "LGG", "BUSI": "Breast Ultrasound"}


def _val_dice_column(path: str) -> list[float]:
    with open(path, encoding="utf-8") as f:
        rows = list(csv.reader(f))
    # val mDice is the 3rd-from-last of the 16-column row (reference
    # ``data.iloc[:, -3]``, train.py:61)
    return [float(r[-3]) for r in rows if len(r) >= 16]


def plot_curves(args, fold: int = 0) -> None:
    """Comparative validation-mDice figure (reference plot mode,
    train.py:44-106): one subplot per dataset, one curve per model, read
    from ``{model}{dataset}_{fold}.csv`` in ``--out_dir``; without a match,
    one axis with every per-fold CSV found. matplotlib is imported here."""
    import glob
    import re

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    datasets = [d for d in args.plot_datasets.split(",") if d]
    per_dataset: dict[str, list[tuple[str, str]]] = {}
    for ds in datasets:
        found = []
        for path in sorted(glob.glob(os.path.join(args.out_dir, f"*{ds}_{fold}.csv"))):
            stem = os.path.basename(path)[: -len(f"{ds}_{fold}.csv")]
            if re.search(r"(bestresult|test)$", stem):
                continue
            found.append((stem, path))
        if found:
            per_dataset[ds] = found

    if per_dataset:
        n = len(per_dataset)
        fig, axs = plt.subplots(1, n, figsize=(8 * n, 5), squeeze=False)
        for ax, (ds, entries) in zip(axs[0], per_dataset.items()):
            for model, path in entries:
                curve = _val_dice_column(path)
                if curve:
                    ax.plot(curve, label=_MODEL_DISPLAY.get(model, model), linewidth=2)
            ax.legend(fontsize=8)
            ax.set_title(f"Validation mDice on the {_DATASET_DISPLAY.get(ds, ds)} dataset")
        fig.supxlabel("Epochs")
        fig.supylabel("mDice")
        fig.tight_layout()
        out = os.path.join(args.out_dir, "Validation_mDice_curves.png")
        fig.savefig(out, dpi=150)
        print(f"wrote {out}")
        return

    fig, ax = plt.subplots(figsize=(8, 5))
    for path in sorted(glob.glob(os.path.join(args.out_dir, "*_[0-9].csv"))):
        curve = _val_dice_column(path)
        if curve:
            ax.plot(curve, label=os.path.basename(path)[:-4])
    ax.set_xlabel("epoch")
    ax.set_ylabel("val mDice")
    ax.legend(fontsize=6)
    out = os.path.join(args.out_dir, "mdice_curves.png")
    fig.savefig(out, dpi=150)
    print(f"wrote {out}")


def main(argv=None) -> None:
    from lmnet_tpu_torch.parallel import dist_utils

    args = build_parser().parse_args(argv)
    if args.plot:
        if dist_utils.is_main_process():
            plot_curves(args)
        return
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device here; pass --device cpu "
                         "to run on the CPU")
    # the process group from torchrun's or SLURM's environment, before any
    # device work (JAX's and the reference's order). A group made here is
    # destroyed here.
    owned = not dist_utils.is_dist_avail_and_initialized()
    dist_utils.init_distributed_mode(args.device)
    owned = owned and dist_utils.is_dist_avail_and_initialized()
    try:
        one_fold = args.test or args.visualization or args.export
        folds = range(5) if (args.k_fold and not one_fold) else [0]
        for fold in folds:
            print(f"========fold {fold} train begin========")
            main_single(fold, args)
            print(f"========fold {fold} train end========")
    finally:
        if owned:
            dist_utils.cleanup()


if __name__ == "__main__":
    main()

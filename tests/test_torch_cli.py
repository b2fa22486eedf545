"""The port's training CLI (``lmnet_tpu_torch/cli/train.py``) and what it
runs: checkpoints, HD95, visualize, profiling, and the slice as a whole
against JAX, on the CPU at TINY width.

The cycle mirrors ``tests/test_cli_e2e.py``: train -> 16-column CSV ->
--resume -> --test --hd95 -> --test --serve -> --visualization -> --plot,
with ``--device cpu``.
"""

import csv
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import TINY
from test_torch_augment import _port_params, _replay
from test_torch_train import _close_grads, _filled

from lmnet_tpu_torch import convert
from lmnet_tpu_torch.cli import train as cli
from lmnet_tpu_torch.data import SyntheticDataset, make_loader
from lmnet_tpu_torch.data import augment as T
from lmnet_tpu_torch.data.png import read_png
from lmnet_tpu_torch.metrics import ConfusionAccumulator, batch_hd95, hausdorff_distance_95
from lmnet_tpu_torch.models import LMNet as TLMNet
from lmnet_tpu_torch.models import blocks as t_blocks
from lmnet_tpu_torch.train import checkpoint as ckpt
from lmnet_tpu_torch.train import loop, profiling
from lmnet_tpu_torch.train import create_train_state, eval_step, evaluate, train_step

HW = 32


def _argv(root, epochs):
    return [
        "--synthetic", "--k_fold", "False", "--epochs", str(epochs), "--lr", "0.02",
        "--batch_size", "2", "--img_size", str(HW), "--filters", "4,8,12,16,24",
        "--num_heads", "2", "--ckpt_dir", str(root / "ckpt"), "--out_dir", str(root / "out"),
        "--seed", "42", "--device", "cpu", "--num_workers", "1",
    ]


def _rows(path):
    with open(path, encoding="utf-8") as f:
        return [r for r in csv.reader(f) if r]


def test_cli_end_to_end_on_the_cpu(tmp_path, capsys):
    """Train 2 epochs (the on-device augmentation on), resume to 3, test
    with HD95 and through the serving engine, visualize, plot: every file
    contract of the JAX CLI."""
    out, ck = tmp_path / "out", tmp_path / "ckpt"
    cli.main(_argv(tmp_path, 2))
    per_epoch = out / "LM_NetKvasir_0.csv"
    rows = _rows(per_epoch)
    assert len(rows) == 2 and all(len(r) == 16 for r in rows)
    assert all(np.isfinite(float(v)) for r in rows for v in r)
    assert len(_rows(out / "LM_NetKvasirbestresult_0.csv")) == 1
    assert (ck / "LM_NetKvasir_0_checkpoint").is_file() and (ck / "LM_NetKvasirbest_0").is_file()

    cli.main(_argv(tmp_path, 3) + ["--resume"])
    said = capsys.readouterr().out
    assert "resumed fold 0 at epoch 2" in said
    restored_best = float(said.split("best_iou ")[1].split(")")[0])
    assert abs(restored_best - max(float(r[14]) for r in rows)) < 1e-3
    assert len(_rows(per_epoch)) == 3

    cli.main(_argv(tmp_path, 3) + ["--test", "--hd95"])
    test_csv = out / "LM_NetKvasirtest_rvd_class.csv"
    trows = _rows(test_csv)
    assert len(trows) == 1 and len(trows[0]) == 9

    cli.main(_argv(tmp_path, 3) + ["--test", "--serve"])
    trows = _rows(test_csv)
    assert len(trows) == 2 and len(trows[1]) == 8
    # the serving engine (bf16 deploy graph) agrees with the eval forward:
    # loss within max(5 %, 0.05), Dice within 0.02 (tests/test_cli_e2e.py)
    loss, serve_loss = float(trows[0][0]), float(trows[1][0])
    assert abs(loss - serve_loss) <= max(0.05 * abs(loss), 0.05)
    assert abs(float(trows[0][5]) - float(trows[1][5])) <= 0.02

    cli.main(_argv(tmp_path, 3) + ["--visualization"])
    viz = sorted(os.listdir(out / "viz"))
    assert viz == [f"pred_{i:05d}.png" for i in range(4)]
    assert all(read_png(str(out / "viz" / f)).shape == (HW, HW, 3) for f in viz)

    cli.main(_argv(tmp_path, 3) + ["--plot", "--plot_datasets", "Kvasir"])
    assert (out / "Validation_mDice_curves.png").is_file()


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A TINY run trained for one epoch, and its --test row."""
    root = tmp_path_factory.mktemp("trained")
    cli.main(_argv(root, 1))
    cli.main(_argv(root, 1) + ["--test"])
    return root, _rows(root / "out" / "LM_NetKvasirtest_rvd_class.csv")[0]


@pytest.mark.parametrize("flags", [
    ["--natt_int8"], ["--rc_backend", "flat", "--nat_backend", "xla"],
    ["--rc_backend", "pallas", "--nat_backend", "pallas"], ["--rc_backend", "auto"],
])
def test_test_serve_options_agree_with_the_eval_path(trained, flags):
    """``--test --serve`` with the serving options and backends (the
    kernels' plain versions on the CPU): one 8-column row, its loss within
    max(5 %, 0.05) and its Dice within 0.03 of the eval path's (the
    looser of tests/test_cli_e2e.py's two bands, for int8)."""
    root, eval_row = trained
    test_csv = root / "out" / "LM_NetKvasirtest_rvd_class.csv"
    before = len(_rows(test_csv))
    cli.main(_argv(root, 1) + ["--test", "--serve"] + flags)
    rows = _rows(test_csv)
    assert len(rows) == before + 1 and len(rows[-1]) == 8
    loss, serve_loss = float(eval_row[0]), float(rows[-1][0])
    assert abs(loss - serve_loss) <= max(0.05 * abs(loss), 0.05)
    assert abs(float(eval_row[5]) - float(rows[-1][5])) <= 0.03


def test_export_writes_the_served_graph(trained, tmp_path, capsys):
    """``--export PATH`` writes the best checkpoint's artifact (bf16,
    symbolic batch) and exits; loaded on the CPU, its logits at batch 1 and
    3 equal those of the graph ``--test --serve`` runs (``deploy_forward``
    of the reparameterized checkpoint, default backends, bf16)."""
    from lmnet_tpu_torch.models import structural_reparam
    from lmnet_tpu_torch.serve import deploy_forward
    from lmnet_tpu_torch.serve.export import input_dtype, load_deploy_file

    root, _ = trained
    path = tmp_path / "lmnet.pt2"
    cli.main(_argv(root, 1) + ["--export", str(path)])
    assert f"wrote serving artifact {path}" in capsys.readouterr().out
    fn = load_deploy_file(str(path), device="cpu")
    assert input_dtype(fn) == torch.bfloat16
    state, _, _ = ckpt.restore_checkpoint(str(root / "ckpt"), "LM_NetKvasirbest_0", _state())
    deploy = structural_reparam(state.model.state_dict())
    for b in (1, 3):
        x = torch.from_numpy(np.random.RandomState(b).randn(b, HW, HW, 3).astype(np.float32))
        with torch.inference_mode():
            got = fn(x.to(torch.bfloat16))
            want = deploy_forward(deploy, x.to(torch.bfloat16), num_heads=2)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_rc_remat_branches_trains_as_rc_remat_true(tmp_path):
    """An epoch with ``--rc_remat branches`` (the expand conv's output kept,
    the rest recomputed) gives the ``--rc_remat true`` run's 16-column row
    and its weights (dropout and augmentation on in both: the ReparamConv
    blocks draw no random numbers)."""
    cli.main(_argv(tmp_path / "full", 1) + ["--rc_remat", "true"])
    cli.main(_argv(tmp_path / "branches", 1) + ["--rc_remat", "branches"])
    rows = [_rows(tmp_path / r / "out" / "LM_NetKvasir_0.csv") for r in ("full", "branches")]
    assert len(rows[0]) == 1 and rows[0] == rows[1]
    name = "LM_NetKvasir_0_checkpoint"
    full, branches = (torch.load(tmp_path / r / "ckpt" / name, weights_only=True)["model"]
                      for r in ("full", "branches"))
    for k, v in full.items():
        torch.testing.assert_close(branches[k], v, rtol=1e-5, atol=1e-7, msg=k)


def test_native_cache_gives_the_python_loaders_rows(tmp_path):
    """--native_cache streams the same bytes as the threaded loader, so the
    first epoch's 16-column row is identical (tests/test_cli_e2e.py); where
    the C++ loader cannot build, the CLI says so and uses the Python
    loader."""
    from lmnet_tpu_torch.data.native_loader import native_available

    cli.main(_argv(tmp_path / "py", 1))
    cli.main(_argv(tmp_path / "nat", 1) + ["--native_cache", "--cache_dir",
                                            str(tmp_path / "cache")])
    assert _rows(tmp_path / "nat" / "out" / "LM_NetKvasir_0.csv") == _rows(
        tmp_path / "py" / "out" / "LM_NetKvasir_0.csv")
    if native_available():
        assert any(f.startswith("lmnet_") for f in os.listdir(tmp_path / "cache"))


class _Preempted(Exception):
    pass


def test_resumed_run_reproduces_the_unbroken_run(tmp_path, monkeypatch):
    """4 epochs in one run against the same command stopped after its
    second epoch (its checkpoint and rows written) and rerun with --resume:
    the same 16-column rows, and the same final weights and optimiser state,
    exactly (dropout and augmentation are drawn per epoch from the seed)."""
    cli.main(_argv(tmp_path / "a", 4))

    real = loop.train_one_epoch

    def stop_at_third(*args, **kw):
        if kw["epoch"] == 2:
            raise _Preempted
        return real(*args, **kw)

    monkeypatch.setattr(loop, "train_one_epoch", stop_at_third)
    with pytest.raises(_Preempted):
        cli.main(_argv(tmp_path / "b", 4))
    monkeypatch.undo()
    b_csv = tmp_path / "b" / "out" / "LM_NetKvasir_0.csv"
    assert len(_rows(b_csv)) == 2
    cli.main(_argv(tmp_path / "b", 4) + ["--resume"])
    a_rows = _rows(tmp_path / "a" / "out" / "LM_NetKvasir_0.csv")
    assert len(a_rows) == 4 and _rows(b_csv) == a_rows
    name = "LM_NetKvasir_0_checkpoint"
    pa, pb = (torch.load(tmp_path / r / "ckpt" / name, weights_only=True) for r in "ab")
    assert pa["epoch"] == pb["epoch"] == 3 and pa["step"] == pb["step"] == 16
    for k, v in pa["model"].items():
        assert torch.equal(v, pb["model"][k]), k
    for i, s in pa["optimizer"]["state"].items():
        for k, v in s.items():
            assert torch.equal(v, pb["optimizer"]["state"][i][k]), (i, k)


def _state(seed=1):
    model = TLMNet(**TINY, generator=torch.Generator().manual_seed(seed))
    return create_train_state(model, (2, HW, HW, 3), device="cpu", epochs=3, steps_per_epoch=2)


def test_checkpoint_round_trip_is_exact(tmp_path):
    """After two steps, save and restore into a fresh state: parameters, BN
    running statistics, AdamW moments and step counts, the global step, the
    epoch and the best-IoU watermark come back exactly; the save leaves no
    temporary file."""
    state = _state()
    loader = make_loader(SyntheticDataset(4, HW, "train", seed=0), 2)
    state, _, _ = loop.train_one_epoch(state, loader, img_size=HW, seed=3, epoch=0)
    ckpt.save_checkpoint(str(tmp_path), "run_0_checkpoint", state, 5, best_iou=0.25)
    assert os.listdir(tmp_path) == ["run_0_checkpoint"]
    assert ckpt.checkpoint_exists(str(tmp_path), "run_0_checkpoint")
    assert not ckpt.checkpoint_exists(str(tmp_path), "other")
    fresh = _state(seed=2)
    fresh, epoch, best = ckpt.restore_checkpoint(str(tmp_path), "run_0_checkpoint", fresh)
    assert state.step == 2 and (epoch, best, fresh.step) == (5, 0.25, 2)
    want = state.model.state_dict()
    assert len(want) == len(fresh.model.state_dict())
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    got_opt, want_opt = fresh.optimizer.state_dict(), state.optimizer.state_dict()
    assert len(want_opt["state"]) == len(list(state.model.parameters()))
    for i, s in want_opt["state"].items():
        assert set(s) == {"step", "exp_avg", "exp_avg_sq"}
        for k, v in s.items():
            assert torch.equal(got_opt["state"][i][k], v), (i, k)
    assert any("running_var" in k for k in want)


def _blob_masks(n, seed):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:40, :40]
    out = []
    for _ in range(n):
        cy, cx, r = rng.randint(8, 32), rng.randint(8, 32), rng.randint(0, 12)
        out.append((yy - cy) ** 2 + (xx - cx) ** 2 < r * r)
    return np.stack(out)


def test_hd95_equals_jax_on_the_same_masks():
    """The port's copy of hd95 gives JAX's numbers exactly, empty masks
    (nan) included, per pair and as a batch mean."""
    from lmnet_tpu.metrics.hd95 import batch_hd95 as j_batch
    from lmnet_tpu.metrics.hd95 import hausdorff_distance_95 as j_hd95

    preds, targets = _blob_masks(12, 0), _blob_masks(12, 1)
    for p, t in zip(preds, targets):
        np.testing.assert_equal(hausdorff_distance_95(p, t), j_hd95(p, t))
    np.testing.assert_equal(batch_hd95(preds, targets), j_batch(preds, targets))
    assert np.isnan(hausdorff_distance_95(np.zeros((4, 4)), np.ones((4, 4))))


def test_evaluate_hd95_comes_from_eval_step_preds():
    """``evaluate(compute_hd95=True)``: the mean HD95 over the non-empty
    pairs of ``eval_step``'s own predictions (no second forward), and the
    other metrics unchanged by it."""
    state = _state()
    ds = SyntheticDataset(4, HW, "val", seed=0)
    loss, m = evaluate(state, make_loader(ds, 2), img_size=HW, compute_hd95=True)
    loss0, m0 = evaluate(state, make_loader(ds, 2), img_size=HW)
    assert loss == loss0 and {k: v for k, v in m.items() if k != "hd95"} == m0
    vals = []
    for images, masks in make_loader(ds, 2):
        x, y = T.eval_pipeline(torch.from_numpy(images), torch.from_numpy(masks))
        _, _, preds = eval_step(state, x, y, ConfusionAccumulator.init(2))
        vals += [hausdorff_distance_95(p == 1, t == 1) for p, t in zip(preds.numpy(), y.numpy())]
    vals = [v for v in vals if not np.isnan(v)]
    np.testing.assert_equal(m["hd95"], np.mean(vals) if vals else float("nan"))


def test_serving_evaluate_reports_hd95():
    from lmnet_tpu_torch.serve import serving_evaluate

    state = _state()
    ds = SyntheticDataset(4, HW, "val", seed=0)
    _, m = serving_evaluate(state.model.state_dict(), make_loader(ds, 2), 2, HW, num_heads=2,
                            device="cpu", compute_hd95=True)
    _, m0 = serving_evaluate(state.model.state_dict(), make_loader(ds, 2), 2, HW, num_heads=2,
                             device="cpu")
    assert "hd95" in m and "hd95" not in m0
    assert {k: v for k, v in m.items() if k != "hd95"} == m0


@pytest.mark.parametrize("flags,item", [
    (["--distributed", "True", "--n_spatial", "2"], "must divide the world size 1"),
    (["--distributed", "True", "--n_spatial", "3"], "must divide the world size 1"),
])
def test_unported_flags_are_refused(tmp_path, flags, item):
    """Every flag is ported; what is refused is a 'spatial' axis that does
    not divide the ranks (one process here: no launcher), as JAX refuses
    one that does not divide the devices, before anything is written."""
    with pytest.raises(SystemExit, match=item):
        cli.main(_argv(tmp_path, 1) + flags)
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("img,world,want", [(256, 2, 1), (512, 2, 2), (512, 3, 1),
                                            (512, 1, 1), (640, 4, 2)])
def test_n_spatial_auto_is_jax_rule(img, world, want):
    """--n_spatial 0 (the default) is JAX's 'auto': 2 at --img_size >= 512
    on an even world size, else 1; a given value is kept."""
    args = cli.build_parser().parse_args(["--img_size", str(img)])
    assert cli.resolve_n_spatial(args, world) == want
    args.n_spatial = world
    assert cli.resolve_n_spatial(args, world) == world


def test_device_cuda_without_a_card_is_refused(tmp_path):
    """The default device is the card, and no run falls back to the CPU."""
    assert cli.build_parser().parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(SystemExit, match="--device cpu"):
        cli.main([a for a in _argv(tmp_path, 1) if a not in ("--device", "cpu")])


def test_augmentation_and_dropout_streams_follow_seed_and_epoch():
    """Each batch's augmentation generator depends on (seed, epoch, batch)
    alone, and the epoch's dropout generator on (seed, epoch): train_one_epoch
    reseeds the state's generator, so two states from different
    create_train_state seeds train identically."""
    def draw(*k):
        return loop.augment_generator(*k).initial_seed()

    assert draw(1, 2, 3) == draw(1, 2, 3)
    assert len({draw(1, 2, 3), draw(1, 2, 4), draw(1, 3, 3), draw(2, 2, 3)}) == 4
    runs = []
    for gen_seed in (0, 9):
        model = TLMNet(**TINY, generator=torch.Generator().manual_seed(1))
        state = create_train_state(model, (2, HW, HW, 3), seed=gen_seed, device="cpu")
        loader = make_loader(SyntheticDataset(4, HW, "train", seed=0), 2)
        runs.append(loop.train_one_epoch(state, loader, img_size=HW, seed=5, epoch=1)[1])
    assert runs[0] == runs[1]


def test_profiling_hooks(tmp_path):
    """trace writes a Chrome trace holding the annotated region; StepTimer
    keeps JAX's summary keys."""
    timer = profiling.StepTimer("cpu")
    with profiling.trace(str(tmp_path)):
        for _ in range(3):
            with timer, profiling.annotate("lmnet_step"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    (trace,) = os.listdir(tmp_path)
    assert trace.endswith(".json") and "lmnet_step" in (tmp_path / trace).read_text()
    s = timer.summary()
    assert set(s) == {"steps", "mean_ms", "p50_ms", "p95_ms", "max_ms"} and s["steps"] == 3
    assert profiling.StepTimer().summary() == {}


@pytest.fixture
def no_dropout(monkeypatch):
    monkeypatch.setattr(t_blocks, "DROPOUT", 0.0)


def test_augmented_batch_train_step_matches_jax(no_dropout):
    """The slice as a whole: a synthetic 'train' batch (36^2) through the
    augmentation with parameters replayed from JAX's train_pipeline key,
    then train_step at float32 with dropout off, against JAX's pipeline and
    its train-mode loss and gradients on converted weights: the batch as
    ``test_torch_augment`` holds it (1e-4 normalised, masks equal), the
    loss within rtol 1e-5 and every gradient as ``test_torch_train``'s
    ``_close_grads``."""
    from lmnet_tpu.data import augment as J
    from lmnet_tpu.losses import segmentation_loss
    from lmnet_tpu.models import LMNet as JLMNet

    images, masks = next(iter(make_loader(SyntheticDataset(2, HW, "train", seed=3), 2)))
    key = jax.random.key(11)
    jx, jy = J.train_pipeline(key, jnp.asarray(images), jnp.asarray(masks), out_size=HW)
    params = _port_params(jax.jit(jax.vmap(lambda k: _replay(k, images.shape[1], HW)))(
        jax.random.split(key, 2)))
    x, y = T.apply_params(torch.from_numpy(images), torch.from_numpy(masks), params, HW)
    assert np.abs(x.numpy() - np.asarray(jx)).max() <= 1e-4
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))

    variables = _filled(JLMNet(**TINY), (1, HW, HW, 3), 0)
    model = JLMNet(**TINY, nat_backend="xla", rc_remat=False)

    def loss_fn(p):
        logits, _ = model.apply({"params": p, "batch_stats": variables["batch_stats"]}, jx,
                                train=True, deterministic=True, mutable=["batch_stats"])
        return segmentation_loss(logits, jy)

    j_loss, j_grads = jax.device_get(jax.jit(jax.value_and_grad(loss_fn))(variables["params"]))

    port = TLMNet(**TINY)
    port.load_state_dict(convert.jax_to_state_dict(variables), strict=True)
    state = create_train_state(port, (2, HW, HW, 3), device="cpu")
    state, loss, _ = train_step(state, x, y, ConfusionAccumulator.init(2))
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    _close_grads({k: p.grad.numpy() for k, p in port.named_parameters()},
                 {k: w.numpy() for k, w in convert.jax_to_state_dict({"params": j_grads}).items()})

"""The PyTorch port's ops, loss, metrics and data against the JAX package,
plus the port's import hygiene and its full-width parameter count.

Inputs come from ``np.random.RandomState``; both sides get the same numpy
arrays. Float32, tolerances stated per test.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lmnet_tpu_torch.data import SyntheticDataset as TSyntheticDataset
from lmnet_tpu_torch.data import make_loader as t_make_loader
from lmnet_tpu_torch.data.augment import eval_pipeline as t_eval_pipeline
from lmnet_tpu_torch.losses import cross_entropy_loss as t_ce
from lmnet_tpu_torch.metrics import confusion_matrix as t_cm
from lmnet_tpu_torch.metrics import derived_metrics as t_derived
from lmnet_tpu_torch.models import LMNet as TLMNet
from lmnet_tpu_torch.ops import reparam as t_reparam
from lmnet_tpu_torch.ops import resize as t_resize

PORT = Path(__file__).resolve().parent.parent / "lmnet_tpu_torch"


def _hwio_to_oihw(k):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(k), (3, 2, 0, 1))))


# ---------------------------------------------------------------- resize


@pytest.mark.parametrize(
    "shape,out_hw,align",
    [
        ((2, 5, 7, 3), (10, 14), True),
        ((1, 8, 8, 4), (13, 5), True),
        ((2, 6, 9, 2), (11, 4), False),
        ((1, 1, 4, 2), (3, 8), False),
    ],
)
def test_bilinear_resize_matches_jax(shape, out_hw, align):
    """float32, rtol 1e-5 / atol 1e-6 (source coordinates are formed in
    float32 by torch and in float64 by the JAX op)."""
    from lmnet_tpu.ops.resize import bilinear_resize

    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    want = np.asarray(bilinear_resize(jnp.asarray(x), out_hw, align_corners=align))
    got = t_resize.bilinear_resize(torch.from_numpy(x), out_hw, align_corners=align)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_upsample2x_align_corners_matches_jax():
    from lmnet_tpu.ops.resize import upsample2x_align_corners

    x = np.random.RandomState(1).randn(2, 6, 5, 3).astype(np.float32)
    want = np.asarray(upsample2x_align_corners(jnp.asarray(x)))
    got = t_resize.upsample2x_align_corners(torch.from_numpy(x))
    assert got.shape == (2, 12, 10, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize(
    "shape,out_hw", [((2, 16, 16, 3), (4, 4)), ((1, 10, 7, 2), (3, 4)), ((1, 5, 5, 2), (5, 5))]
)
def test_adaptive_avg_pool_matches_jax(shape, out_hw):
    """Divisible, non-divisible (torch floor/ceil regions) and identity;
    float32, rtol 1e-6 / atol 1e-6."""
    from lmnet_tpu.ops.resize import adaptive_avg_pool, global_avg_pool

    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    want = np.asarray(adaptive_avg_pool(jnp.asarray(x), out_hw))
    got = t_resize.adaptive_avg_pool(torch.from_numpy(x), out_hw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        t_resize.global_avg_pool(torch.from_numpy(x)).numpy(),
        np.asarray(global_avg_pool(jnp.asarray(x))), rtol=1e-6, atol=1e-6,
    )


# ---------------------------------------------------------------- reparam


def test_reparam_matches_jax():
    """fuse_bn, embed_kernel, merge_branches and fuse_reparam_branches on
    OIHW kernels == the JAX functions on HWIO ones (float32, rtol 1e-6 /
    atol 1e-7)."""
    from lmnet_tpu.ops import reparam as j_reparam

    rng = np.random.RandomState(3)
    C = 6
    shapes = {"large": (5, 5), "square": (3, 3), "ver": (3, 1), "hor": (1, 3)}
    jb, tb = {}, {}
    for name, (kh, kw) in shapes.items():
        kern = rng.randn(kh, kw, 1, C).astype(np.float32)
        bn = dict(
            scale=rng.uniform(0.5, 1.5, C).astype(np.float32),
            bias=rng.randn(C).astype(np.float32),
            mean=rng.randn(C).astype(np.float32),
            var=rng.uniform(0.5, 2.0, C).astype(np.float32),
        )
        jb[name] = dict(kernel=kern, **bn)
        tb[name] = dict(kernel=_hwio_to_oihw(kern), **{k: torch.from_numpy(v) for k, v in bn.items()})

    def close(t, j, oihw=True):
        j = np.asarray(j)
        np.testing.assert_allclose(
            t.numpy(), np.transpose(j, (3, 2, 0, 1)) if oihw else j, rtol=1e-6, atol=1e-7
        )

    b = jb["square"]
    jk, jbias = j_reparam.fuse_bn(b["kernel"], b["scale"], b["bias"], b["mean"], b["var"])
    b = tb["square"]
    tk, tbias = t_reparam.fuse_bn(b["kernel"], b["scale"], b["bias"], b["mean"], b["var"])
    close(tk, jk)
    close(tbias, jbias, oihw=False)
    close(t_reparam.embed_kernel(tb["ver"]["kernel"], 5, 5),
          j_reparam.embed_kernel(jb["ver"]["kernel"], 5, 5))
    pairs_t = [(tb[n]["kernel"], tb[n]["bias"]) for n in shapes]
    pairs_j = [(jb[n]["kernel"], jb[n]["bias"]) for n in shapes]
    mk, mb = t_reparam.merge_branches(pairs_t, 5)
    jk, jbias = j_reparam.merge_branches(pairs_j, 5)
    close(mk, jk)
    close(mb, jbias, oihw=False)
    fk, fb = t_reparam.fuse_reparam_branches(tb, 5)
    jk, jbias = j_reparam.fuse_reparam_branches(jb, 5)
    close(fk, jk)
    close(fb, jbias, oihw=False)


# ---------------------------------------------------------------- loss


@pytest.mark.parametrize(
    "weight,smoothing,C", [((1.0, 4.0), 0.001, 2), (None, 0.0, 3), ((0.5, 1.0, 2.0), 0.1, 3)]
)
def test_cross_entropy_matches_jax(weight, smoothing, C):
    """float32, rtol 1e-6."""
    from lmnet_tpu.losses import cross_entropy_loss

    rng = np.random.RandomState(4)
    logits = rng.randn(2, 8, 9, C).astype(np.float32) * 3
    labels = rng.randint(0, C, (2, 8, 9))
    want = float(cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels), weight, smoothing))
    got = float(t_ce(torch.from_numpy(logits), torch.from_numpy(labels), weight, smoothing))
    np.testing.assert_allclose(got, want, rtol=1e-6)


# ---------------------------------------------------------------- metrics


@pytest.mark.parametrize("task,C", [("binary", 2), ("multiclass", 3), ("multilabel", 4)])
def test_confusion_and_derived_metrics_match_jax(task, C):
    """Counts are equal; metrics agree to rtol 1e-6 (JAX derives them in
    float32 from a float32 matrix, the port in float64 from int64 counts)."""
    from lmnet_tpu.metrics.confusion import confusion_matrix, derived_metrics

    rng = np.random.RandomState(5)
    pred = rng.randint(0, C, (3, 7, 5))
    target = rng.randint(0, C, (3, 7, 5))
    pred[0, 0, :C] = np.arange(C)  # every class occurs
    jcm = np.asarray(confusion_matrix(jnp.asarray(pred), jnp.asarray(target), C))
    tcm = t_cm(torch.from_numpy(pred), torch.from_numpy(target), C)
    assert tcm.dtype == torch.int64
    np.testing.assert_array_equal(tcm.numpy(), jcm)
    want = {k: float(v) for k, v in derived_metrics(jnp.asarray(jcm), task).items()}
    got = {k: float(v) for k, v in t_derived(tcm, task).items()}
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    with pytest.raises(ValueError):
        t_derived(tcm, "regression")


# ---------------------------------------------------------------- data


def test_synthetic_batches_and_eval_pipeline_match_jax():
    """Byte-equal uint8 batches for the same seed; the normalized images
    agree to 1 ulp-scale (rtol 1e-6) and the masks exactly."""
    from lmnet_tpu.data.augment import eval_pipeline
    from lmnet_tpu.data.datasets import SyntheticDataset, make_loader

    for mode in ("val", "train"):
        jb = list(make_loader(SyntheticDataset(5, 24, mode, seed=7), 2))
        tb = list(t_make_loader(TSyntheticDataset(5, 24, mode, seed=7), 2))
        assert len(jb) == len(tb) == 3
        for (ji, jm), (ti, tm) in zip(jb, tb):
            assert ti.dtype == ji.dtype == np.uint8 and tm.dtype == jm.dtype
            assert ti.tobytes() == ji.tobytes() and tm.tobytes() == jm.tobytes()
    images, masks = jb[0]
    jx, jy = eval_pipeline(jnp.asarray(images), jnp.asarray(masks), out_size=24)
    tx, ty = t_eval_pipeline(torch.from_numpy(images), torch.from_numpy(masks), out_size=24)
    assert tx.dtype == torch.float32 and tx.shape == images.shape
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


# ---------------------------------------------------------------- model


def test_full_width_parameter_count():
    """The default LMNet has the JAX model's 3,966,566 parameters."""
    m = TLMNet()
    assert sum(p.numel() for p in m.parameters()) == 3_966_566


def test_seeded_init_is_reproducible():
    a = TLMNet(filters=(4, 8, 12, 16, 24), num_heads=2,
               generator=torch.Generator().manual_seed(5)).state_dict()
    b = TLMNet(filters=(4, 8, 12, 16, 24), num_heads=2,
               generator=torch.Generator().manual_seed(5)).state_dict()
    c = TLMNet(filters=(4, 8, 12, 16, 24), num_heads=2,
               generator=torch.Generator().manual_seed(6)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["natt1.att1.rpb"], c["natt1.att1.rpb"])
    assert all(torch.isfinite(v).all() for v in a.values())


# ---------------------------------------------------------------- hygiene

FORBIDDEN = ("jax", "flax", "optax", "orbax", "lmnet_tpu")


def _port_modules():
    return sorted(PORT.rglob("*.py"))


def test_port_imports_no_jax_in_source():
    """No import of jax, flax, optax, orbax or lmnet_tpu anywhere in the
    port's source (lmnet_tpu_torch itself is allowed)."""
    bad = []
    for path in _port_modules():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                if n.split(".")[0] in FORBIDDEN:
                    bad.append(f"{path.relative_to(PORT.parent)}:{node.lineno} {n}")
    assert len(_port_modules()) >= 15
    assert not bad, bad


def test_port_imports_no_jax_at_runtime():
    """A fresh interpreter that imports every port module ends with no JAX
    module loaded."""
    mods = [
        ".".join(p.relative_to(PORT.parent).with_suffix("").parts).removesuffix(".__init__")
        for p in _port_modules()
    ]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(len(bad)); sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=PORT.parent,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr

"""The port's public surface: every (module, name) pair that
``tests/test_migration_surface.py`` pins for ``lmnet_tpu`` (MIGRATION.md's
API table) exists in ``lmnet_tpu_torch`` under the same module path, and no
module of the port, nor ``chip_smoke.py``, imports JAX or the JAX
package."""

import importlib
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_migration_surface.py's SURFACE, lmnet_tpu -> lmnet_tpu_torch
SURFACE = [
    ("lmnet_tpu_torch.models", "LMNet"),
    ("lmnet_tpu_torch.models", "structural_reparam"),
    ("lmnet_tpu_torch.models.blocks", "ReparamConv"),
    ("lmnet_tpu_torch.models.blocks", "SE"),
    ("lmnet_tpu_torch.models.blocks", "GFT"),
    ("lmnet_tpu_torch.models.blocks", "GlobalAttention"),
    ("lmnet_tpu_torch.models.blocks", "pyramid_pool"),
    ("lmnet_tpu_torch.models.blocks", "M2Skip"),
    ("lmnet_tpu_torch.models.blocks", "M3Skip"),
    ("lmnet_tpu_torch.models.blocks", "OverlapPatchEmbed"),
    ("lmnet_tpu_torch.models.blocks", "Mlp"),
    ("lmnet_tpu_torch.models.blocks", "NeighborhoodTransformer"),
    ("lmnet_tpu_torch.ops.nat", "neighborhood_attention"),
    ("lmnet_tpu_torch.losses", "bce_dice_loss"),
    ("lmnet_tpu_torch.losses", "dice_loss"),
    ("lmnet_tpu_torch.losses", "official_dice_loss"),
    ("lmnet_tpu_torch.losses", "mmseg_dice_loss"),
    ("lmnet_tpu_torch.losses", "mmseg_binary_dice_loss"),
    ("lmnet_tpu_torch.losses", "focal_loss"),
    ("lmnet_tpu_torch.losses", "focal_loss_per_class"),
    ("lmnet_tpu_torch.losses", "sigmoid_focal_loss"),
    ("lmnet_tpu_torch.losses", "class_balanced_loss"),
    ("lmnet_tpu_torch.losses", "effective_number_weights"),
    ("lmnet_tpu_torch.losses", "segmentation_loss"),
    ("lmnet_tpu_torch.metrics", "Evaluator"),
    ("lmnet_tpu_torch.metrics", "ConfusionMatrix"),
    ("lmnet_tpu_torch.metrics", "get_multi_ConfusionMatrix"),
    ("lmnet_tpu_torch.metrics", "binary_eval"),
    ("lmnet_tpu_torch.metrics", "multi_eval"),
    ("lmnet_tpu_torch.metrics", "MetricTracker"),
    ("lmnet_tpu_torch.metrics", "iou_pytorch"),
    ("lmnet_tpu_torch.metrics", "dice_pytorch"),
    ("lmnet_tpu_torch.metrics", "ConfusionAccumulator"),
    ("lmnet_tpu_torch.metrics", "get_stats"),
    ("lmnet_tpu_torch.metrics", "compute_metric"),
    ("lmnet_tpu_torch.metrics", "relative_volume_difference"),
    ("lmnet_tpu_torch.metrics", "hausdorff_distance_95"),
    ("lmnet_tpu_torch.train.loop", "train_one_epoch"),
    ("lmnet_tpu_torch.train.loop", "evaluate"),
    ("lmnet_tpu_torch.serve.engine", "serving_evaluate"),
    ("lmnet_tpu_torch.parallel.dist_utils", "init_distributed_mode"),
    ("lmnet_tpu_torch.parallel.dist_utils", "get_rank"),
    ("lmnet_tpu_torch.parallel.dist_utils", "get_world_size"),
    ("lmnet_tpu_torch.parallel.dist_utils", "is_main_process"),
    ("lmnet_tpu_torch.parallel.dist_utils", "reduce_value"),
    ("lmnet_tpu_torch.parallel.dist_utils", "cleanup"),
    ("lmnet_tpu_torch.parallel", "make_mesh"),
    ("lmnet_tpu_torch.parallel", "shard_batch"),
    ("lmnet_tpu_torch.data", "create_kvasir_manifest"),
    ("lmnet_tpu_torch.data", "calculate_sample_weights"),
    ("lmnet_tpu_torch.data", "make_loader"),
    ("lmnet_tpu_torch.data", "augment"),
    ("lmnet_tpu_torch.serve", "deploy_forward"),
    ("lmnet_tpu_torch.serve", "save_deploy"),
    ("lmnet_tpu_torch.serve", "load_deploy"),
    ("lmnet_tpu_torch.serve", "DynamicBatcher"),
]


@pytest.mark.parametrize("module,name", SURFACE, ids=lambda v: str(v))
def test_symbol_exists(module, name):
    mod = importlib.import_module(module)
    assert hasattr(mod, name), f"{module}.{name} (MIGRATION.md's lmnet_tpu counterpart)"


def test_the_surface_is_the_jax_surface_mapped():
    """The list above is test_migration_surface.py's, module by module."""
    from test_migration_surface import SURFACE as JAX_SURFACE

    assert SURFACE == [(m.replace("lmnet_tpu", "lmnet_tpu_torch", 1), n) for m, n in JAX_SURFACE]


def test_metrics_functional_namespace():
    from lmnet_tpu_torch.metrics import functional

    for fn in ("iou_score", "f1_score", "accuracy", "recall"):
        assert callable(getattr(functional, fn))


def test_package_exports():
    """JAX's losses, metrics, parallel and serve exports, and the aliases
    that keep the port's own names."""
    import lmnet_tpu_torch.losses as losses
    import lmnet_tpu_torch.metrics as metrics
    import lmnet_tpu_torch.parallel as parallel
    import lmnet_tpu_torch.serve as serve
    from lmnet_tpu_torch.models import blocks
    from lmnet_tpu_torch.serve import daemon, export

    assert len(losses.__all__) == 12 and all(callable(getattr(losses, n)) for n in losses.__all__)
    assert {"functional", "get_stats", "compute_metric", "binary_iou"} <= set(metrics.__all__)
    assert {"make_mesh", "batch_sharding", "shard_batch", "replicate"} <= set(parallel.__all__)
    assert serve.DynamicBatcher is daemon.DynamicBatcher
    assert (serve.save_deploy, serve.load_deploy, serve.export_deploy) == (
        export.save_deploy, export.load_deploy, export.export_deploy)
    assert blocks.OverlapPatchEmbed is blocks.PatchEmbed
    assert "patch_embeddings.weight" in blocks.OverlapPatchEmbed(3, 4).state_dict()


def test_no_module_of_the_port_imports_jax():
    """Every module of lmnet_tpu_torch, chip_smoke.py, bench_torch.py, the
    multi-node names and the multi-node test's worker import in a fresh
    interpreter where ``jax``, ``flax`` and ``lmnet_tpu`` cannot be
    imported."""
    code = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "lmnet_tpu"):
    sys.modules[name] = None
import lmnet_tpu_torch
names = [m.name for m in pkgutil.walk_packages(lmnet_tpu_torch.__path__, "lmnet_tpu_torch.")]
assert {"lmnet_tpu_torch.parallel.spatial", "lmnet_tpu_torch.parallel.dryrun",
        "lmnet_tpu_torch.parity.convergence"} <= set(names)
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
importlib.import_module("bench_torch")
from lmnet_tpu_torch.parallel.dist_utils import host_count, host_index, local_world_size
from lmnet_tpu_torch.parallel.mesh import node_ranks, node_rows
sys.path.insert(0, "tests")
importlib.import_module("_torch_multihost_worker")
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "lmnet_tpu")
            and sys.modules[m] is not None]
print(len(names))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[-1]) >= 40


def test_convergence_script_runs_without_jax():
    """``python -m lmnet_tpu_torch.parity.convergence`` (the card's side of
    the convergence protocol) starts, parses its flags and finds its JAX
    record in an interpreter where ``jax``, ``flax`` and ``lmnet_tpu`` cannot
    be imported."""
    code = """
import runpy, sys
for name in ("jax", "jaxlib", "flax", "optax", "lmnet_tpu"):
    sys.modules[name] = None
from lmnet_tpu_torch.parity import convergence as cv
import json, os
for arm in cv.ARMS:
    assert json.load(open(cv.ref_path(arm)))["protocol"]["arm"] == arm
sys.argv = ["convergence", "--help"]
runpy.run_module("lmnet_tpu_torch.parity.convergence", run_name="__main__")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "--arm" in out.stdout and "--plain" in out.stdout

"""The port's multi-rank dry run (``lmnet_tpu_torch/parallel/dryrun.py``),
the counterpart of ``__graft_entry__.py::dryrun_multichip``: four gloo ranks
on the CPU over a (2 x 2) ('data', 'spatial') mesh run one full train step
of the full-width ``LMNet(num_classes=2)`` at 32^2 (a batch of 4, dropout
on), each on its rows and its block of 16 image rows, and their loss and
confusion matrix equal one process's (loss rtol 1e-4, the matrix's counts
rtol 1e-5, as JAX asserts)."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from lmnet_tpu_torch.parallel import dryrun


def test_dryrun_multichip_on_four_cpu_ranks():
    got = dryrun.dryrun_multichip(4, device="cpu")
    assert got["mesh"] == (2, 2)
    assert np.isfinite(got["loss"]) and abs(got["loss"] - got["loss_one"]) <= 1e-4 * abs(
        got["loss_one"])
    assert torch.equal(got["cm"], got["cm_one"]) and int(got["cm"].sum()) == 4 * 32 * 32


@pytest.mark.parametrize("n,want", [(1, (1, 1)), (2, (2, 1)), (3, (3, 1)), (4, (2, 2)),
                                    (6, (3, 2)), (8, (4, 2))])
def test_the_mesh_is_jax_rule(n, want):
    """n_spatial = 2 for an even n >= 4, as ``__graft_entry__.py:55``."""
    assert dryrun._plan(n) == want


def test_the_module_runs_as_a_script():
    """``python -m lmnet_tpu_torch.parallel.dryrun --help`` names its use."""
    out = subprocess.run([sys.executable, "-m", "lmnet_tpu_torch.parallel.dryrun", "--help"],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "n_ranks" in out.stdout

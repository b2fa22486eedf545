"""What a run loads: never JAX or the JAX package (top-level names compared
whole), and a reference that imports nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys

from conftest import BENCH, ROOT


def _modules(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300, check=True).stdout
    return set(out.split())


PRELUDE = (f"import sys; sys.path[:0] = [{str(BENCH)!r}, {str(ROOT)!r}]; ")


def test_the_harness_and_the_entry_points_it_calls_load_no_jax():
    mods = _modules(
        PRELUDE + "import run, control; from lmbench import cells, check, arith, readers, profile; "
        "import lmnet_tpu_torch.models, lmnet_tpu_torch.serve, lmnet_tpu_torch.train, "
        "lmnet_tpu_torch.metrics; "
        "[run.metric_reader(m) for m in ('mfu.serve', 'conv_share.serve', 'batch_fill.batcher')]; "
        "print(' '.join(sys.modules))")
    tops = {m.split(".")[0] for m in mods}
    assert not tops & {"jax", "jaxlib", "flax", "lmnet_tpu"}
    assert "lmnet_tpu_torch" in tops


def test_banned_names_are_compared_whole(monkeypatch):
    import run

    monkeypatch.setitem(sys.modules, "lmnet_tpu_torchx", sys)
    assert "lmnet_tpu_torchx" not in run.banned_modules()
    monkeypatch.setitem(sys.modules, "lmnet_tpu.models", sys)
    assert "lmnet_tpu.models" in run.banned_modules()


def test_the_reference_imports_nothing_of_the_program():
    mods = _modules(PRELUDE + "import reference.lmnet; from lmbench import check, inputs; "
                    "print(' '.join(sys.modules))")
    assert not {m.split(".")[0] for m in mods} & {"lmnet_tpu_torch", "lmnet_tpu", "jax"}
    tree = ast.parse((BENCH / "reference" / "lmnet.py").read_text())
    imported = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    imported |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert {m.split(".")[0] for m in imported} <= {"__future__", "math", "typing", "torch"}

"""What a run loads: never JAX or the JAX package (top-level names compared
whole), and a reference that imports nothing of the program."""

from __future__ import annotations

import ast
import re
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
        PRELUDE + "import run, control, arch; from lmbench import cells, check, arith, readers, "
        "profile; arch.load({}); "
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
    """Every module of ``reference/`` imports only the standard library's
    typing and math, torch, and the reference package itself."""
    refs = sorted(p.stem for p in (BENCH / "reference").glob("*.py") if p.stem != "__init__")
    assert {"lmnet", "train"} <= set(refs)
    mods = _modules(PRELUDE + "".join(f"import reference.{r}; " for r in refs)
                    + "from lmbench import check, inputs; print(' '.join(sys.modules))")
    assert not {m.split(".")[0] for m in mods} & {"lmnet_tpu_torch", "lmnet_tpu", "jax"}
    for r in refs:
        tree = ast.parse((BENCH / "reference" / f"{r}.py").read_text())
        imported = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
        imported |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
        assert {m.split(".")[0] for m in imported} <= {"__future__", "math", "typing", "torch",
                                                        "reference"}, r


# the names of LM-Net's port, glue and reference that only arch/lmnet.py may use
LMNET_NAMES = re.compile(r"(reference|arch)[./]lmnet|LMNet|structural_reparam|deploy_forward")


def test_the_harness_names_no_architecture():
    """The windows, checks, controls, inputs, readers' helpers and
    arithmetic, the entry, the sweep and the loader take the model from
    ``arch.load``: none of them names LM-Net's modules or its glue
    ``arch/lmnet.py``."""
    files = sorted((BENCH / "lmbench").glob("*.py")) + [BENCH / n for n in (
        "run.py", "sweep.py", "control.py", "arch/__init__.py")]
    assert {"cells.py", "check.py", "inputs.py", "readers.py", "arith.py", "__init__.py"} <= {
        f.name for f in files}
    for f in files:
        text = f.read_text()
        assert not LMNET_NAMES.search(text), (f, LMNET_NAMES.search(text).group())

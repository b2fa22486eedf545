"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on first use into
``build/lmnet_tpu_torch/<name>-<hash>.so`` beside the package, where the hash
covers the source bytes and the compiler flags, so an edited source or a
changed flag builds anew and an unchanged one is loaded as it is. The library
has a plain C interface; callers set ``argtypes``/``restype`` on what they
use. Nothing here runs when the module is imported. ``aligned`` is the one
launch rule every wrapper shares.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "lmnet_tpu_torch"

# sm_90a keeps Hopper-only instructions (wgmma, setmaxnreg) available to the
# sources; plain sm_90 would refuse them. -Xptxas=-v reports each kernel's
# registers and spills (``build`` returns the report).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then /usr/local/cuda/bin, then $PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str) -> Path:
    """Content-hashed path of the library built from ``csrc/<name>.cu``."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(*names: str) -> dict[str, str]:
    """Compile every ``csrc/<name>.cu`` whose library is missing, one nvcc
    process per source, all started together; raise if any fails. Returns
    the compiler's messages (ptxas's registers and spills) by the names it
    compiled."""
    jobs = []
    for name in names:
        path = library_path(name)
        if path.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # compile to a private name, then rename: a concurrent process never
        # sees a half-written library
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs.append((name, path, tmp, proc))
    failed, logs = [], {}
    for name, path, tmp, proc in jobs:
        out, err = proc.communicate()
        logs[name] = out + err
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{out}\n{err}")
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if its library is missing, then load it."""
    build(name)
    return ctypes.CDLL(str(library_path(name)))


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where its data does not start on 16 bytes (a
    contiguous view at an offset): the kernels copy their inputs in units
    of up to 16 bytes, and a misaligned unit would fault on the card."""
    return t if t.data_ptr() % 16 == 0 else t.clone()

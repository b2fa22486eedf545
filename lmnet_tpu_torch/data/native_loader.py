"""Native (C++) dataset cache + batch loader, on the host.

A copy of ``lmnet_tpu/data/native_loader.py`` with its own copy of the
source (``lmnet_tpu_torch/native/loader.cpp``): decode every image ONCE into
a flat binary cache (``build_cache``), then stream shuffled batches out of
the OS page cache via the mmap'd C++ library, with no Python per sample.
This replaces the reference's 10-process torch DataLoader that re-decodes
with cv2 every epoch (reference ``train.py:128-133``).

Two changes from the JAX module: the library is compiled (g++, libjpeg) into
the git-ignored ``build/lmnet_tpu_torch/`` beside the CUDA kernels, not next
to its source; and a ``SegmentationDataset``'s manifest is its list of rows
(stdlib csv), not a DataFrame. If the toolchain or libjpeg is missing,
``native_available()`` is False and the caller falls back to
``datasets.make_loader``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import struct
from pathlib import Path

import numpy as np

from lmnet_tpu_torch.ops._build import BUILD_DIR

_MAGIC = 0x4C4D4E45545F4331
_SRC = Path(__file__).resolve().parent.parent / "native" / "loader.cpp"


def _ensure_lib() -> str:
    """Compile loader.cpp to a content-addressed .so under ``BUILD_DIR``.

    The library name embeds the source hash, so a stale or foreign binary can
    never be picked up: a source change always compiles to a new path, and a
    fresh clone always compiles from source.
    """
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = str(BUILD_DIR / f"libloader-{digest}.so")
    if not os.path.exists(lib):
        tmp = f"{lib}.tmp.{os.getpid()}"
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
             str(_SRC), "-o", tmp, "-ljpeg"],
            check=True,
        )
        os.replace(tmp, lib)
    return lib


def native_available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


_lib_handle = None


def _load():
    global _lib_handle
    if _lib_handle is None:
        lib = ctypes.CDLL(_ensure_lib())
        lib.lm_open.restype = ctypes.c_void_p
        lib.lm_open.argtypes = [ctypes.c_char_p]
        for f in (lib.lm_count, lib.lm_height, lib.lm_width):
            f.restype = ctypes.c_long
            f.argtypes = [ctypes.c_void_p]
        lib.lm_gather.restype = None
        lib.lm_gather.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_long),
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.c_int,
        ]
        lib.lm_close.restype = None
        lib.lm_close.argtypes = [ctypes.c_void_p]
        lib.lm_build_cache_jpeg.restype = ctypes.c_long
        lib.lm_build_cache_jpeg.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_long,
            ctypes.c_long,
            ctypes.c_char_p,
            ctypes.c_int,
        ]
        _lib_handle = lib
    return _lib_handle


def build_cache_jpeg(
    image_paths: list[str], mask_paths: list[str], size: int, out_path: str,
    num_threads: int = 4,
) -> str:
    """Native decode stage: libjpeg decode + resize + threshold straight
    into the cache layout — no Python per sample (see loader.cpp
    ``lm_build_cache_jpeg``). All paths must be JPEG."""
    lib = _load()
    n = len(image_paths)
    assert n == len(mask_paths) and n > 0
    imgs = (ctypes.c_char_p * n)(*[p.encode() for p in image_paths])
    msks = (ctypes.c_char_p * n)(*[p.encode() for p in mask_paths])
    tmp = out_path + ".tmp"
    rc = lib.lm_build_cache_jpeg(imgs, msks, n, size, tmp.encode(), num_threads)
    if rc != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise OSError(
            f"native JPEG cache build failed at sample {rc - 1} "
            f"({image_paths[rc - 1] if rc > 0 else 'io error'})"
        )
    os.replace(tmp, out_path)
    return out_path


def _jpeg_paths(dataset):
    """(image_paths, mask_paths) if the dataset is a JPEG-file manifest
    dataset eligible for the native decode stage, else None."""
    manifest = getattr(dataset, "rows", None)
    if manifest is None or getattr(dataset, "mask_mode", None) != "binary":
        return None
    try:
        rows = [dataset._resolve(r, "images") for r in manifest]
        masks = [dataset._resolve(r, "masks") for r in manifest]
    except KeyError:
        return None
    ok = all(p.lower().endswith((".jpg", ".jpeg")) for p in rows + masks)
    return (rows, masks) if ok else None


def build_cache(dataset, out_path: str) -> str:
    """Decode a SegmentationDataset-like object into a binary cache file.

    ``dataset[i]`` must yield (uint8 image (H,W,3), uint8 mask (H,W)) with a
    consistent shape (the dataset's load/img size).
    """
    img0, mask0 = dataset[0]
    h, w = img0.shape[0], img0.shape[1]
    n = len(dataset)
    tmp = out_path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<QQQQ", _MAGIC, n, h, w))
        for i in range(n):
            img, _ = dataset[i]
            assert img.shape == (h, w, 3), f"inconsistent image shape at {i}"
            f.write(np.ascontiguousarray(img, dtype=np.uint8).tobytes())
        for i in range(n):
            _, mask = dataset[i]
            f.write(np.ascontiguousarray(mask, dtype=np.uint8).tobytes())
    os.replace(tmp, out_path)
    return out_path


def dataset_cache_key(dataset) -> str:
    """Content-derived cache id: manifests, mode, sizes — a changed split or
    size never reuses a stale cache file."""
    h = hashlib.sha256()
    if hasattr(dataset, "rows"):
        h.update(str(sorted(tuple(r.items()) for r in dataset.rows)).encode())
        h.update(
            f"{dataset.mode}:{dataset.img_size}:{dataset.load_size}:"
            f"{dataset.mask_mode}:{dataset.root}".encode()
        )
    else:
        h.update(
            repr((
                type(dataset).__name__, len(dataset),
                getattr(dataset, "img_size", 0), getattr(dataset, "mode", ""),
                getattr(dataset, "seed", 0), getattr(dataset, "_offset", 0),
                getattr(dataset, "_stride", 1),
            )).encode()
        )
    return h.hexdigest()[:16]


_open_loaders: dict[str, "NativeCacheLoader"] = {}


def make_native_loader(
    dataset,
    cache_dir: str,
    batch_size: int,
    shuffle: bool = False,
    seed: int = 0,
    epoch: int = 0,
    num_threads: int = 4,
    drop_last: bool = False,
):
    """Drop-in replacement for ``datasets.make_loader`` through the native
    path: build the binary cache once (first call decodes with the dataset's
    own ``__getitem__``), then stream every epoch via the mmap'd C++ library.
    Loader handles are kept open across epochs (one mmap per cache file).
    """
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, f"lmnet_{dataset_cache_key(dataset)}.bin")
    if not os.path.exists(path):
        jpaths = _jpeg_paths(dataset)
        if jpaths is not None:
            # all-JPEG manifest: decode natively (libjpeg), no Python/cv2
            size = (
                dataset.load_size if dataset.mode == "train" else dataset.img_size
            )
            build_cache_jpeg(*jpaths, size, path, num_threads=num_threads)
        else:
            build_cache(dataset, path)
    if path not in _open_loaders:
        _open_loaders[path] = NativeCacheLoader(path, num_threads=num_threads)
    return _open_loaders[path].epoch(
        batch_size, shuffle=shuffle, seed=seed, epoch=epoch, drop_last=drop_last
    )


class NativeCacheLoader:
    """Batched loader over a binary cache, assembled by the C++ library."""

    def __init__(self, cache_path: str, num_threads: int = 4):
        self._lib = _load()
        self._h = self._lib.lm_open(cache_path.encode())
        if not self._h:
            raise OSError(f"failed to open cache {cache_path}")
        self.n = int(self._lib.lm_count(self._h))
        self.height = int(self._lib.lm_height(self._h))
        self.width = int(self._lib.lm_width(self._h))
        self.num_threads = num_threads

    def gather(self, indices: np.ndarray):
        """(B,H,W,3) uint8 images + (B,H,W) uint8 masks for given indices."""
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        b = len(idx)
        imgs = np.empty((b, self.height, self.width, 3), np.uint8)
        masks = np.empty((b, self.height, self.width), np.uint8)
        self._lib.lm_gather(
            self._h,
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
            b,
            imgs.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            masks.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            self.num_threads,
        )
        return imgs, masks

    def epoch(self, batch_size: int, shuffle: bool = True, seed: int = 0,
              epoch: int = 0, drop_last: bool = False):
        order = np.arange(self.n)
        if shuffle:
            order = np.random.RandomState(seed + epoch).permutation(self.n)
        nb = self.n // batch_size if drop_last else -(-self.n // batch_size)
        for bi in range(nb):
            yield self.gather(order[bi * batch_size : (bi + 1) * batch_size])

    def close(self):
        if self._h:
            self._lib.lm_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

"""Host-side dataset: CSV-manifest reading, image decode, batched prefetch.

Counterpart of ``lmnet_tpu/data/datasets.py`` (``SegmentationDataset``,
``make_loader``, ``SyntheticDataset``): the same code, so the batches are
byte-equal to the JAX package's. The host only decodes and resizes (cv2);
every random augmentation runs on the device (``data/augment.py``). A small
thread pool decodes and a background thread prefetches, so host work
overlaps the device.

Unlike JAX, the manifest is read with the stdlib ``csv`` module (the card
host has no pandas): a ``SegmentationDataset`` holds its rows as dicts of
strings, and an empty ``directory`` cell counts as absent, as pandas' NaN
does. cv2 is imported only where an image is decoded.
"""

from __future__ import annotations

import csv
import os
import queue
import threading
from dataclasses import dataclass

import numpy as np


def _imread(path: str, gray: bool = False):
    import cv2

    flag = cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR
    img = cv2.imread(path, flag)
    if img is None:
        raise FileNotFoundError(path)
    if not gray:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    return img


def read_manifest(csv_path: str) -> list[dict[str, str]]:
    """The rows of a manifest CSV (header ``images,masks[,diagnosis,directory]``)."""
    with open(csv_path, newline="", encoding="utf-8") as f:
        return [dict(row) for row in csv.DictReader(f)]


@dataclass
class SegmentationDataset:
    """CSV-manifest dataset yielding (uint8 image HWC RGB, uint8 mask HW).

    Decode parity with the reference: masks are grayscale binarised at 127
    (``mask_mode='binary'``) or kept as class ids (``'index'``, VOC). Train
    images are decoded at ``load_size`` (default 9/8 of ``img_size``) so the
    on-device RandomResizedCrop has headroom; val images straight at
    ``img_size``."""

    rows: list
    mode: str  # 'train' | 'val' | 'test'
    img_size: int = 256
    load_size: int | None = None  # decode size for train mode
    root: str | None = None  # optional prefix for relative manifest paths
    mask_mode: str = "binary"  # 'binary' (>127 threshold) | 'index' (class ids)

    @classmethod
    def from_csv(cls, csv_path: str, mode: str, **kw) -> "SegmentationDataset":
        return cls(read_manifest(csv_path), mode, **kw)

    def __post_init__(self):
        if self.load_size is None:
            self.load_size = int(self.img_size * 9 / 8)

    def __len__(self):
        return len(self.rows)

    def shard(self, rank: int, world: int) -> "SegmentationDataset":
        """Per-host manifest sharding (the DistributedSampler analogue):
        process ``rank`` of ``world`` sees rows rank::world."""
        if world <= 1:
            return self
        return SegmentationDataset(self.rows[rank::world], self.mode, self.img_size,
                                   self.load_size, self.root, self.mask_mode)

    def _resolve(self, row: dict, col: str) -> str:
        p = row[col]
        if row.get("directory"):  # an empty cell is pandas' NaN: no directory
            p = os.path.join(row["directory"], p)
        if self.root is not None:
            p = os.path.join(self.root, p)
        return p

    def __getitem__(self, idx: int):
        import cv2

        row = self.rows[idx]
        img = _imread(self._resolve(row, "images"))
        mask = _imread(self._resolve(row, "masks"), gray=True)
        if self.mask_mode == "binary":
            mask = (mask > 127).astype(np.uint8)
        else:  # 'index': mask already holds class ids (e.g. VOC)
            mask = mask.astype(np.uint8)
        size = self.load_size if self.mode == "train" else self.img_size
        img = cv2.resize(img, (size, size), interpolation=cv2.INTER_LINEAR)
        mask = cv2.resize(mask, (size, size), interpolation=cv2.INTER_NEAREST)
        return img, mask


def make_loader(
    dataset,
    batch_size: int,
    shuffle: bool = False,
    seed: int = 0,
    drop_last: bool = False,
    num_threads: int = 4,
    prefetch: int = 2,
    epoch: int = 0,
):
    """Iterate (images (B,H,W,3) uint8, masks (B,H,W) uint8) numpy batches.

    Deterministic order per (seed, epoch); decode happens in a thread pool
    and batches are prefetched so device work overlaps host IO.
    """
    n = len(dataset)
    order = np.arange(n)
    if shuffle:
        order = np.random.RandomState(seed + epoch).permutation(n)
    if drop_last:
        nb = n // batch_size
    else:
        nb = (n + batch_size - 1) // batch_size

    import concurrent.futures as cf

    pool = cf.ThreadPoolExecutor(max(num_threads, 1)) if num_threads > 1 else None

    def load_batch(bi):
        idxs = [int(i) for i in order[bi * batch_size : (bi + 1) * batch_size]]
        if pool is not None:
            items = list(pool.map(dataset.__getitem__, idxs))
        else:
            items = [dataset[i] for i in idxs]
        imgs = np.stack([it[0] for it in items])
        masks = np.stack([it[1] for it in items])
        return imgs, masks

    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def worker():
        try:
            for bi in range(nb):
                if stop.is_set():
                    return
                q.put(load_batch(bi))
        finally:
            q.put(None)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                break
            yield item
    finally:
        stop.set()
        while t.is_alive():  # a consumer that stopped early: free a worker blocked on put
            try:
                q.get(timeout=0.05)
            except queue.Empty:
                pass
        if pool is not None:
            pool.shutdown(wait=False)


class SyntheticDataset:
    """CPU-runnable stand-in for smoke tests and benchmarking: random blobs
    with circle masks (no files needed)."""

    def __init__(self, n: int = 8, img_size: int = 256, mode: str = "train", seed: int = 0):
        self.n = n
        self.img_size = img_size
        self.load_size = int(img_size * 9 / 8) if mode == "train" else img_size
        self.mode = mode
        self.seed = seed

    def __len__(self):
        return self.n

    def shard(self, rank: int, world: int) -> "SyntheticDataset":
        """Every ``world``-th image from ``rank`` on (JAX's per-host shard)."""
        if world <= 1:
            return self
        out = SyntheticDataset((self.n - rank + world - 1) // world, self.img_size, self.mode,
                               self.seed)
        out._offset = rank
        out._stride = world
        return out

    _offset = 0
    _stride = 1

    def __getitem__(self, idx: int):
        rng = np.random.RandomState(self.seed + self._offset + idx * self._stride)
        s = self.load_size if self.mode == "train" else self.img_size
        img = rng.randint(0, 256, (s, s, 3), dtype=np.uint8)
        yy, xx = np.mgrid[:s, :s]
        cy, cx = rng.randint(s // 4, 3 * s // 4, 2)
        r = rng.randint(s // 8, s // 4)
        mask = ((yy - cy) ** 2 + (xx - cx) ** 2 < r**2).astype(np.uint8)
        # paint the circle brighter so the task is learnable
        img = np.where(mask[..., None] > 0, np.minimum(img + 60, 255), img).astype(np.uint8)
        return img, mask

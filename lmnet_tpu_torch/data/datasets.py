"""Host-side batching, numpy only.

Counterpart of ``lmnet_tpu/data/datasets.py``'s ``make_loader`` and
``SyntheticDataset``: the same code, so the batches are byte-equal to the JAX
package's for the same seed. A small thread pool decodes and a background
thread prefetches, so host work overlaps the device. ``SegmentationDataset``
(CSV manifests and image decode) is not ported yet.
"""

from __future__ import annotations

import queue
import threading

import numpy as np


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

    def __getitem__(self, idx: int):
        rng = np.random.RandomState(self.seed + idx)
        s = self.load_size if self.mode == "train" else self.img_size
        img = rng.randint(0, 256, (s, s, 3), dtype=np.uint8)
        yy, xx = np.mgrid[:s, :s]
        cy, cx = rng.randint(s // 4, 3 * s // 4, 2)
        r = rng.randint(s // 8, s // 4)
        mask = ((yy - cy) ** 2 + (xx - cx) ** 2 < r**2).astype(np.uint8)
        # paint the circle brighter so the task is learnable
        img = np.where(mask[..., None] > 0, np.minimum(img + 60, 255), img).astype(np.uint8)
        return img, mask

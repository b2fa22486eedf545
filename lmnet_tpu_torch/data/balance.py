"""Class-imbalance helpers (reference ``dataset/data_loading.py:343-394``).

A copy of ``lmnet_tpu/data/balance.py`` (numpy only)."""

from __future__ import annotations

import numpy as np


def calculate_sample_weights(labels: np.ndarray) -> np.ndarray:
    """Inverse-frequency per-sample weights for weighted sampling
    (reference :343-348)."""
    labels = np.asarray(labels)
    classes, counts = np.unique(labels, return_counts=True)
    class_weight = {c: len(labels) / (len(classes) * n) for c, n in zip(classes, counts)}
    return np.asarray([class_weight[l] for l in labels], dtype=np.float32)


def calculate_class_weights(
    mask_pixel_counts: np.ndarray, c: float = 1.02
) -> np.ndarray:
    """Log-inverse-frequency class weights (reference :350-373):
    w_c = 1 / ln(c + p_c) with p_c the pixel frequency of class c."""
    counts = np.asarray(mask_pixel_counts, dtype=np.float64)
    p = counts / counts.sum()
    return (1.0 / np.log(c + p)).astype(np.float32)


def merge_multi_masks(masks: list[np.ndarray]) -> np.ndarray:
    """Union of multiple binary mask files for one image — BUSI images can
    have several ``*_mask_N`` files (reference ``addpicture``, :375-394)."""
    out = np.zeros_like(masks[0])
    for m in masks:
        out = np.maximum(out, m)
    return out

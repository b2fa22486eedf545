"""Neighborhood attention (NAT) in plain PyTorch, NATTEN semantics.

Counterpart of ``lmnet_tpu/ops/nat.py``:
  * every query pixel attends to exactly ``k x k`` keys;
  * the window is centred on the query in the interior and *clamped* (slid,
    not zero-padded) at the image borders so it stays inside the map;
  * a learned relative position bias ``rpb`` of shape ``(heads, 2k-1, 2k-1)``
    is added to the logits, indexed by the key-query offset.

This is the plain version of the CUDA kernel (``ops/nat_flat.py``): the path
for tensors on the CPU, and the reference the kernel is held against on the
card. It runs in the dtype of ``q``, as the JAX op does.
"""

from __future__ import annotations

import numpy as np
import torch


def _rpb_index_1d(size: int, kernel_size: int, offset: int) -> np.ndarray:
    """Key position and bias index along one axis for window slot ``offset``.

    For query position i the key position is clip(i-c, 0, size-k) + offset;
    the displacement (key - query) indexes the (2k-1)-wide bias table at
    ``displacement + (k-1)``. Returns (key positions, bias indices).
    """
    k, c = kernel_size, kernel_size // 2
    i = np.arange(size)
    key_pos = np.clip(i - c, 0, size - k) + offset
    return key_pos, key_pos - i + (k - 1)


def neighborhood_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rpb: torch.Tensor,
    kernel_size: int = 3,
    scale: float | None = None,
) -> torch.Tensor:
    """NATTEN-semantics neighborhood attention.

    Args:
      q, k, v: (B, H, W, C) with C = heads * head_dim.
      rpb: (heads, 2*kernel_size-1, 2*kernel_size-1) relative position bias.
      kernel_size: neighborhood size (odd).
      scale: logit scale; defaults to head_dim ** -0.5.

    Returns:
      (B, H, W, C) attention output (before the output projection).
    """
    B, H, W, C = q.shape
    heads = rpb.shape[0]
    if C % heads:
        raise ValueError(f"C={C} not divisible by heads={heads}")
    hd = C // heads
    kk = kernel_size
    if H < kk or W < kk:
        raise ValueError(f"feature map {H}x{W} smaller than the NAT kernel {kk}")
    if scale is None:
        scale = hd**-0.5

    dev = q.device
    qs = (q * scale).reshape(B, H, W, heads, hd)
    rows = [_rpb_index_1d(H, kk, o) for o in range(kk)]
    cols = [_rpb_index_1d(W, kk, o) for o in range(kk)]

    def window(t, oh, ow):
        """Keys/values every query sees at window slot (oh, ow)."""
        ih = torch.from_numpy(rows[oh][0]).to(dev)
        iw = torch.from_numpy(cols[ow][0]).to(dev)
        return t.index_select(1, ih).index_select(2, iw).reshape(B, H, W, heads, hd)

    offsets = [(oh, ow) for oh in range(kk) for ow in range(kk)]
    logits = []
    for oh, ow in offsets:
        bh = torch.from_numpy(rows[oh][1]).to(dev)
        bw = torch.from_numpy(cols[ow][1]).to(dev)
        bias = rpb.index_select(1, bh).index_select(2, bw)  # (heads, H, W)
        l = (qs * window(k, oh, ow)).sum(-1)  # (B, H, W, heads)
        logits.append(l + bias.permute(1, 2, 0).to(l.dtype))
    attn = torch.softmax(torch.stack(logits, dim=-1), dim=-1)  # (B,H,W,heads,kk*kk)

    out = torch.zeros_like(qs)
    for idx, (oh, ow) in enumerate(offsets):
        out = out + attn[..., idx : idx + 1] * window(v, oh, ow)
    return out.reshape(B, H, W, C)

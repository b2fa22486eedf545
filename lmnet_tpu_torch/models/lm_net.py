"""LM-Net in PyTorch: the train-mode and eval forward, and
``structural_reparam``.

Counterpart of ``lmnet_tpu/models/lm_net.py``. The graph (reference
``core/LM_Net.py:5-123``):
  * 4 encoder stages of 2x ReparamConv + 3x3/s2 downsample
    (filters 12/24/48/96, bottleneck 192),
  * pyramid pool + GFT global attention at the bottleneck,
  * M2/M3 multi-scale skips feeding 4 NeighborhoodTransformer blocks,
  * decoder of bilinear 2x (align_corners=True) + 3x3 conv, additive skip,
    2x ReparamConv per stage; 1x1 conv head -> raw logits.

Inputs and logits are NHWC. ``structural_reparam`` is a pure function from
the train-mode state dict to the deploy state dict that
``serve/engine.py::deploy_forward`` runs.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn as nn

from lmnet_tpu_torch.models.blocks import (
    GFT,
    Conv,
    M2Skip,
    M3Skip,
    NeighborhoodTransformer,
    ReparamConv,
    Upsample2x,
    pyramid_pool,
)
from lmnet_tpu_torch.ops.reparam import fuse_reparam_branches

_BRANCHES = ("large", "square", "ver", "hor")


class LMNet(nn.Module):
    """The LM-Net segmentation model.

    Args:
      num_classes: output channels of the 1x1 head.
      filters: per-stage channel plan.
      num_heads: heads of the GFT and NAT attention.
      generator: the ``torch.Generator`` every initial weight is drawn from
        (a fresh one seeded 0 when omitted). Parameters are made on the CPU
        in float32; move the model with ``.to(device)``.
      dtype: compute dtype of the activations (``torch.bfloat16`` is the
        CLI's ``--apm``); None keeps the input's. Parameters stay float32
        and are cast at each op; the logits come back float32.
      nat_backend: 'flat' (``ops/nat_flat.py``: the CUDA kernels B1 and B2 on
        a card), 'pallas' (``ops/nat_kernel.py``: the B3 forward kernel, the
        backward through the plain NAT) or 'plain' (``ops/nat.py``).
      rc_remat: JAX's ``rc_remat``. True or 'full' (the default): recompute
        every ReparamConv in the backward (``torch.utils.checkpoint``);
        'branches': keep each block's expand conv output and recompute the
        rest; False: keep everything.
      rc_train_backend: the train-mode branch graph of every ReparamConv:
        'auto' (= 'xla', plain torch), 'fused' (the B6 statistics and B5
        conv kernels on a card, ``ops/rc_train.py``) or 'packed' (one
        grouped conv); see ``blocks.ReparamConv``.
      gelu_exact: the erf GELU in every block (JAX's ``gelu_exact``); the
        default is the tanh form. Not with ``rc_train_backend='fused'``.
      natt_remat: recompute each of the four NeighborhoodTransformer blocks
        in the backward, with the forward's dropout masks (JAX's
        ``natt_remat``).
    """

    def __init__(self, num_classes: int = 2, filters=(12, 24, 48, 96, 192),
                 num_heads: int = 12, generator: torch.Generator | None = None,
                 dtype: torch.dtype | None = None, nat_backend: str = "flat",
                 rc_remat: bool | str = True, rc_train_backend: str = "auto",
                 gelu_exact: bool = False, natt_remat: bool = False):
        super().__init__()
        if rc_remat not in (True, False, "full", "branches"):
            raise ValueError(f"rc_remat takes True, False, 'full' or 'branches', "
                             f"not {rc_remat!r}")
        rc_remat = True if rc_remat == "full" else rc_remat
        self.dtype = dtype
        f = tuple(filters)
        ge = gelu_exact

        def rc(cin, expand, cout):
            return ReparamConv(cin, expand, cout, remat=rc_remat,
                               train_backend=rc_train_backend, gelu_exact=ge)

        self.conv1 = nn.Sequential(rc(3, f[1], f[0]), rc(f[0], f[1], f[0]))
        self.down1 = nn.Sequential(Conv(f[0], f[1], 3, stride=2))
        self.conv2 = nn.Sequential(rc(f[1], f[2], f[1]), rc(f[1], f[2], f[1]))
        self.down2 = nn.Sequential(Conv(f[1], f[2], 3, stride=2))
        self.conv3 = nn.Sequential(rc(f[2], f[3], f[2]), rc(f[2], f[3], f[2]))
        self.down3 = nn.Sequential(Conv(f[2], f[3], 3, stride=2))
        self.conv4 = nn.Sequential(rc(f[3], f[4], f[3]), rc(f[3], f[4], f[3]))
        self.down4 = nn.Sequential(Conv(f[3], f[4], 3, stride=2))

        self.gft = GFT(sum(f), f[4], num_heads, ge)

        self.skip1 = M2Skip((f[2], f[3]), "bottom", ge)
        self.skip2 = M3Skip((f[1], f[2], f[3]), ge)
        self.skip3 = M3Skip((f[0], f[1], f[2]), ge)
        self.skip4 = M2Skip((f[0], f[1]), "top", ge)

        def natt(dim):
            return NeighborhoodTransformer(dim, num_heads, nat_backend, ge, natt_remat)

        self.natt1 = natt(f[3])
        self.natt2 = natt(f[2])
        self.natt3 = natt(f[1])
        self.natt4 = natt(f[0])

        def up(cin, cout):
            return nn.Sequential(Upsample2x(), Conv(cin, cout, 3))

        self.up1 = up(f[4], f[3])
        self.dconv1 = nn.Sequential(rc(f[3], f[4], f[3]), rc(f[3], f[4], f[3]))
        self.up2 = up(f[3], f[2])
        self.dconv2 = nn.Sequential(rc(f[2], f[3], f[2]), rc(f[2], f[3], f[2]))
        self.up3 = up(f[2], f[1])
        self.dconv3 = nn.Sequential(rc(f[1], f[2], f[1]), rc(f[1], f[2], f[1]))
        self.up4 = up(f[1], f[0])
        self.dconv4 = nn.Sequential(rc(f[0], f[1], f[0]), rc(f[0], f[1], f[0]))

        self.output_layer = Conv(f[0], num_classes, 1)

        g = generator if generator is not None else torch.Generator().manual_seed(0)
        with torch.no_grad():
            for m in self.modules():
                if hasattr(m, "init_"):
                    m.init_(g)

    def forward(
        self,
        x: torch.Tensor,
        train: bool = False,
        deterministic: bool | None = None,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """Logits, (B, H, W, num_classes) float32, from NHWC ``x``.

        ``train``: BatchNorm on batch statistics, updating the running ones.
        ``deterministic`` (default ``not train``): dropout off; with it on,
        the masks are drawn from ``generator`` (on x's device).
        """
        det = (not train) if deterministic is None else deterministic
        if self.dtype is not None:
            x = x.to(self.dtype)

        def rc2(stage, h):
            return stage[1](stage[0](h, train), train)

        x1 = rc2(self.conv1, x)
        xd1 = self.down1(x1)
        x2 = rc2(self.conv2, xd1)
        xd2 = self.down2(x2)
        x3 = rc2(self.conv3, xd2)
        xd3 = self.down3(x3)
        x4 = rc2(self.conv4, xd3)
        xd4 = self.down4(x4)

        x5 = self.gft(pyramid_pool([x1, x2, x3, x4], xd4), det, generator)

        x46 = self.natt1(self.skip1(x3, x4, train), det, generator, train)
        x37 = self.natt2(self.skip2(x2, x3, x4, train), det, generator, train)
        x28 = self.natt3(self.skip3(x1, x2, x3, train), det, generator, train)
        x19 = self.natt4(self.skip4(x1, x2, train), det, generator, train)

        x6 = rc2(self.dconv1, self.up1(x5) + x46)
        x7 = rc2(self.dconv2, self.up2(x6) + x37)
        x8 = rc2(self.dconv3, self.up3(x7) + x28)
        x9 = rc2(self.dconv4, self.up4(x8) + x19)
        return self.output_layer(x9).float()


def structural_reparam(state: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Fuse every ReparamConv's four branches for deployment.

    Input: a train-mode ``LMNet`` state dict. Output: a new dict in which each
    block's ``{large,square,ver,hor}_conv.{conv,bn}.*`` entries are replaced
    by one 5x5 depthwise ``fuse_conv.weight`` / ``fuse_conv.bias``; every
    other entry is passed through (the same tensors, not copies).
    """
    suffix = ".large_conv.conv.weight"
    blocks = [k[: -len(suffix)] for k in state if k.endswith(suffix)]
    out = {
        k: v for k, v in state.items()
        if not any(k.startswith(f"{b}.{br}_conv.") for b in blocks for br in _BRANCHES)
    }
    with torch.no_grad():
        for b in blocks:
            branches = {
                br: dict(
                    kernel=state[f"{b}.{br}_conv.conv.weight"],
                    scale=state[f"{b}.{br}_conv.bn.weight"],
                    bias=state[f"{b}.{br}_conv.bn.bias"],
                    mean=state[f"{b}.{br}_conv.bn.running_mean"],
                    var=state[f"{b}.{br}_conv.bn.running_var"],
                )
                for br in _BRANCHES
            }
            large = state[f"{b}.large_conv.conv.weight"].shape[-1]
            out[f"{b}.fuse_conv.weight"], out[f"{b}.fuse_conv.bias"] = (
                fuse_reparam_branches(branches, large)
            )
    return out

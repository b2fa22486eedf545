"""LM-Net in PyTorch: the train-mode parameter tree, the eval forward, and
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
    """The LM-Net segmentation model (train-mode parameters, eval forward).

    Args:
      num_classes: output channels of the 1x1 head.
      filters: per-stage channel plan.
      num_heads: heads of the GFT and NAT attention.
      generator: the ``torch.Generator`` every initial weight is drawn from
        (a fresh one seeded 0 when omitted). Parameters are made on the CPU;
        move the model with ``.to(device)``.
    """

    def __init__(self, num_classes: int = 2, filters=(12, 24, 48, 96, 192),
                 num_heads: int = 12, generator: torch.Generator | None = None):
        super().__init__()
        f = tuple(filters)
        rc = ReparamConv

        self.conv1 = nn.Sequential(rc(3, f[1], f[0]), rc(f[0], f[1], f[0]))
        self.down1 = nn.Sequential(Conv(f[0], f[1], 3, stride=2))
        self.conv2 = nn.Sequential(rc(f[1], f[2], f[1]), rc(f[1], f[2], f[1]))
        self.down2 = nn.Sequential(Conv(f[1], f[2], 3, stride=2))
        self.conv3 = nn.Sequential(rc(f[2], f[3], f[2]), rc(f[2], f[3], f[2]))
        self.down3 = nn.Sequential(Conv(f[2], f[3], 3, stride=2))
        self.conv4 = nn.Sequential(rc(f[3], f[4], f[3]), rc(f[3], f[4], f[3]))
        self.down4 = nn.Sequential(Conv(f[3], f[4], 3, stride=2))

        self.gft = GFT(sum(f), f[4], num_heads)

        self.skip1 = M2Skip((f[2], f[3]), "bottom")
        self.skip2 = M3Skip((f[1], f[2], f[3]))
        self.skip3 = M3Skip((f[0], f[1], f[2]))
        self.skip4 = M2Skip((f[0], f[1]), "top")

        self.natt1 = NeighborhoodTransformer(f[3], num_heads)
        self.natt2 = NeighborhoodTransformer(f[2], num_heads)
        self.natt3 = NeighborhoodTransformer(f[1], num_heads)
        self.natt4 = NeighborhoodTransformer(f[0], num_heads)

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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Eval-mode logits, (B, H, W, num_classes) float32, from NHWC ``x``."""
        x1 = self.conv1(x)
        xd1 = self.down1(x1)
        x2 = self.conv2(xd1)
        xd2 = self.down2(x2)
        x3 = self.conv3(xd2)
        xd3 = self.down3(x3)
        x4 = self.conv4(xd3)
        xd4 = self.down4(x4)

        x5 = self.gft(pyramid_pool([x1, x2, x3, x4], xd4))

        x46 = self.natt1(self.skip1(x3, x4))
        x37 = self.natt2(self.skip2(x2, x3, x4))
        x28 = self.natt3(self.skip3(x1, x2, x3))
        x19 = self.natt4(self.skip4(x1, x2))

        x6 = self.dconv1(self.up1(x5) + x46)
        x7 = self.dconv2(self.up2(x6) + x37)
        x8 = self.dconv3(self.up3(x7) + x28)
        x9 = self.dconv4(self.up4(x8) + x19)
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

from lmnet_tpu_torch.ops import reparam
from lmnet_tpu_torch.ops.nat import neighborhood_attention
from lmnet_tpu_torch.ops.nat_flat import nat_flat
from lmnet_tpu_torch.ops.resize import (
    adaptive_avg_pool,
    bilinear_resize,
    global_avg_pool,
    upsample2x_align_corners,
)

__all__ = [
    "adaptive_avg_pool",
    "bilinear_resize",
    "global_avg_pool",
    "upsample2x_align_corners",
    "nat_flat",
    "neighborhood_attention",
    "reparam",
]

from lmnet_tpu_torch.ops import reparam
from lmnet_tpu_torch.ops.nat import neighborhood_attention
from lmnet_tpu_torch.ops.nat_flat import nat_flat
from lmnet_tpu_torch.ops.rc_flat import dw_gelu_flat
from lmnet_tpu_torch.ops.rc_kernel import fused_reparam_conv
from lmnet_tpu_torch.ops.rc_train import rc_branch_act, rc_branch_stats
from lmnet_tpu_torch.ops.resize import (
    adaptive_avg_pool,
    bilinear_resize,
    global_avg_pool,
    upsample2x_align_corners,
)

__all__ = [
    "adaptive_avg_pool",
    "bilinear_resize",
    "dw_gelu_flat",
    "fused_reparam_conv",
    "global_avg_pool",
    "upsample2x_align_corners",
    "nat_flat",
    "neighborhood_attention",
    "rc_branch_act",
    "rc_branch_stats",
    "reparam",
]

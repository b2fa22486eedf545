from lmnet_tpu_torch.ops import reparam
from lmnet_tpu_torch.ops.bn_train import batch_norm_train
from lmnet_tpu_torch.ops.nat import neighborhood_attention
from lmnet_tpu_torch.ops.nat_flat import nat_flat
from lmnet_tpu_torch.ops.nat_kernel import neighborhood_attention_pallas
from lmnet_tpu_torch.ops.natt_flat import fold_natt_weights, natt_flat_interior
from lmnet_tpu_torch.ops.rc_flat import dw_gelu_flat
from lmnet_tpu_torch.ops.rc_kernel import fused_reparam_conv
from lmnet_tpu_torch.ops.rc_train import rc_branch_act, rc_branch_stats
from lmnet_tpu_torch.ops.resize import (
    adaptive_avg_pool,
    bilinear_resize,
    global_avg_pool,
    upsample2x_align_corners,
)
from lmnet_tpu_torch.ops.upsample_flat import upsample2x_flat

__all__ = [
    "adaptive_avg_pool",
    "batch_norm_train",
    "bilinear_resize",
    "dw_gelu_flat",
    "fold_natt_weights",
    "fused_reparam_conv",
    "global_avg_pool",
    "upsample2x_align_corners",
    "nat_flat",
    "natt_flat_interior",
    "neighborhood_attention",
    "neighborhood_attention_pallas",
    "rc_branch_act",
    "rc_branch_stats",
    "reparam",
    "upsample2x_flat",
]

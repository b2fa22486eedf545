from lmnet_tpu_torch.models import blocks
from lmnet_tpu_torch.models.lm_net import LMNet, structural_reparam

__all__ = ["LMNet", "structural_reparam", "blocks"]

from lmnet_tpu_torch.metrics.confusion import (
    ConfusionAccumulator,
    confusion_matrix,
    derived_metrics,
)
from lmnet_tpu_torch.metrics.hd95 import batch_hd95, hausdorff_distance_95

__all__ = [
    "ConfusionAccumulator",
    "batch_hd95",
    "confusion_matrix",
    "derived_metrics",
    "hausdorff_distance_95",
]

from lmnet_tpu_torch.metrics.confusion import (
    ConfusionAccumulator,
    confusion_matrix,
    derived_metrics,
)

__all__ = ["ConfusionAccumulator", "confusion_matrix", "derived_metrics"]

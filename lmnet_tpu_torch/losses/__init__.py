from lmnet_tpu_torch.losses.losses import (
    bce_dice_loss,
    class_balanced_loss,
    cross_entropy_loss,
    dice_loss,
    effective_number_weights,
    focal_loss,
    focal_loss_per_class,
    mmseg_binary_dice_loss,
    mmseg_dice_loss,
    official_dice_loss,
    segmentation_loss,
    sigmoid_focal_loss,
)

__all__ = [
    "bce_dice_loss",
    "class_balanced_loss",
    "cross_entropy_loss",
    "dice_loss",
    "effective_number_weights",
    "focal_loss",
    "focal_loss_per_class",
    "sigmoid_focal_loss",
    "mmseg_binary_dice_loss",
    "mmseg_dice_loss",
    "official_dice_loss",
    "segmentation_loss",
]

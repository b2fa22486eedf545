from lmnet_tpu_torch.losses.losses import cross_entropy_loss, dice_loss, segmentation_loss

__all__ = ["cross_entropy_loss", "dice_loss", "segmentation_loss"]

from lmnet_tpu_torch.losses.losses import cross_entropy_loss

__all__ = ["cross_entropy_loss"]

from lmnet_tpu_torch.data import augment
from lmnet_tpu_torch.data.datasets import SyntheticDataset, make_loader

__all__ = ["augment", "SyntheticDataset", "make_loader"]

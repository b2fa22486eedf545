from lmnet_tpu_torch.data import augment
from lmnet_tpu_torch.data.balance import (
    calculate_class_weights,
    calculate_sample_weights,
    merge_multi_masks,
)
from lmnet_tpu_torch.data.datasets import SegmentationDataset, SyntheticDataset, make_loader
from lmnet_tpu_torch.data.manifests import (
    create_basic_manifest,
    create_busi_manifest,
    create_cvc_manifest,
    create_kvasir_manifest,
    create_thyroid_manifest,
    create_voc_manifest,
)

__all__ = [
    "augment",
    "calculate_class_weights",
    "calculate_sample_weights",
    "create_basic_manifest",
    "create_busi_manifest",
    "create_cvc_manifest",
    "create_kvasir_manifest",
    "create_thyroid_manifest",
    "create_voc_manifest",
    "make_loader",
    "merge_multi_masks",
    "SegmentationDataset",
    "SyntheticDataset",
]

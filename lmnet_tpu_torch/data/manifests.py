"""CSV manifest builders: deterministic dataset split protocol.

A copy of ``lmnet_tpu/data/manifests.py``: the same pandas and scikit-learn
calls, so the splits are the JAX package's to the row. pandas and sklearn
are imported inside the builders, so importing this module needs neither
(the card host has neither; manifests are built where the data lives).

Reproduces the reference's split semantics (reference
``dataset/data_loading.py:36-155``): seed-10086 shuffled splits of 10% test,
then 10% val, plus 5-fold (Stratified)KFold over train+val, written as
``{train,val,test}_{name}_{fold}.csv`` with the column contract
``images,masks[,diagnosis,directory]``.

Deviations from the reference, on purpose (SURVEY Appendix A):
  * data roots are arguments, not hard-coded absolute paths;
  * the KFold gets an explicit random_state (the reference's
    ``KFold(shuffle=True)`` without a seed is nondeterministic);
  * the Kvasir walker only pairs files under ``images/`` (the reference
    walks the whole tree and also emits mask-as-image rows).
"""

from __future__ import annotations

import os

import numpy as np

SPLIT_SEED = 10086


def _write_protocol(
    df,
    name: str,
    out_dir: str,
    stratify_col: str | None = None,
    seed: int = SPLIT_SEED,
) -> None:
    from sklearn.model_selection import KFold, StratifiedKFold, train_test_split

    os.makedirs(out_dir, exist_ok=True)
    strat = df[stratify_col] if stratify_col else None
    train_val, test = train_test_split(
        df, random_state=seed, test_size=0.1, shuffle=True, stratify=strat
    )
    test.to_csv(os.path.join(out_dir, f"test_{name}_0.1.csv"), index=False)
    train, val = train_test_split(
        train_val, random_state=seed, test_size=0.1, shuffle=True
    )
    val.to_csv(os.path.join(out_dir, f"val_{name}_0.1.csv"), index=False)
    train.to_csv(os.path.join(out_dir, f"train_{name}_0.8.csv"), index=False)

    if stratify_col:
        kf = StratifiedKFold(n_splits=5, shuffle=True, random_state=seed)
        splits = kf.split(train_val, train_val[stratify_col])
    else:
        kf = KFold(n_splits=5, shuffle=True, random_state=seed)
        splits = kf.split(train_val)
    for fold, (tr_idx, va_idx) in enumerate(splits):
        train_val.iloc[tr_idx].to_csv(
            os.path.join(out_dir, f"train_{name}_{fold}.csv"), index=False
        )
        train_val.iloc[va_idx].to_csv(
            os.path.join(out_dir, f"val_{name}_{fold}.csv"), index=False
        )


def create_kvasir_manifest(data_dir: str, out_dir: str, seed: int = SPLIT_SEED):
    """Kvasir-SEG: pair images/<f> with masks/<f>."""
    import pandas as pd

    images_dir = os.path.join(data_dir, "images")
    images, masks = [], []
    for root, _folders, files in os.walk(images_dir):
        for f in sorted(files):
            p = os.path.join(root, f)
            images.append(p)
            masks.append(p.replace("images", "masks"))
    df = pd.DataFrame({"images": images, "masks": masks})
    _write_protocol(df, "Kvasir", out_dir, seed=seed)
    return df


def create_basic_manifest(data_dir: str, out_dir: str, seed: int = SPLIT_SEED):
    """LGG kaggle_3m: diagnosis label = (mask has any foreground)."""
    import cv2
    import pandas as pd

    images, masks, diagnosis = [], [], []
    for root, _folders, files in os.walk(data_dir):
        for f in sorted(files):
            if "mask" in f:
                mp = os.path.join(root, f)
                diagnosis.append(1 if np.max(cv2.imread(mp)) > 0 else 0)
                masks.append(mp)
                images.append(mp.replace("_mask", ""))
    df = pd.DataFrame({"images": images, "masks": masks, "diagnosis": diagnosis})
    _write_protocol(df, "Basic", out_dir, stratify_col="diagnosis", seed=seed)
    return df


def create_busi_manifest(data_dir: str, out_dir: str, seed: int = SPLIT_SEED):
    """BUSI breast ultrasound: benign/malignant/normal stratification."""
    import pandas as pd

    images, masks, diagnosis = [], [], []
    for root, _folders, files in os.walk(data_dir):
        for f in sorted(files):
            if "_mask" in f:
                mp = os.path.join(root, f)
                masks.append(mp)
                images.append(mp.replace("_mask", ""))
                diagnosis.append(
                    1 if "benign" in f else 2 if "malignant" in f else 0
                )
    df = pd.DataFrame({"images": images, "masks": masks, "diagnosis": diagnosis})
    _write_protocol(df, "BUSI", out_dir, stratify_col="diagnosis", seed=seed)
    return df


def create_cvc_manifest(data_dir: str, out_dir: str | None = None, seed: int = 42):
    """CVC-ClinicDB: Original/ vs Ground Truth/ pairing; 80/20 split
    (reference :134-145 returns dataframes; we also write CSVs if out_dir)."""
    import pandas as pd
    from sklearn.model_selection import train_test_split

    dirs, images, masks = [], [], []
    orig = os.path.join(data_dir, "Original")
    for root, _folders, files in os.walk(orig):
        for f in sorted(files):
            dirs.append(data_dir)
            images.append(os.path.join("Original", f))
            masks.append(os.path.join("Ground Truth", f))
    df = pd.DataFrame({"directory": dirs, "images": images, "masks": masks})
    train, val = train_test_split(df, random_state=seed, test_size=0.2, shuffle=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        train.to_csv(os.path.join(out_dir, "train_CVC_0.csv"), index=False)
        val.to_csv(os.path.join(out_dir, "val_CVC_0.csv"), index=False)
    return train, val


def create_voc_manifest(voc_root: str, out_dir: str | None = None):
    """Pascal VOC2012 segmentation lists (reference My_VOC,
    data_loading.py:328-341): JPEGImages/ + SegmentationClass/ paired via
    ImageSets/Segmentation/{train,val}.txt. Masks are class-index PNGs —
    use ``SegmentationDataset(..., mask_mode='index')``."""
    import pandas as pd

    dfs = {}
    for split in ("train", "val"):
        lst = os.path.join(voc_root, "ImageSets", "Segmentation", f"{split}.txt")
        with open(lst) as f:
            names = [ln.strip() for ln in f if ln.strip()]
        df = pd.DataFrame(
            {
                "images": [
                    os.path.join(voc_root, "JPEGImages", n + ".jpg") for n in names
                ],
                "masks": [
                    os.path.join(voc_root, "SegmentationClass", n + ".png")
                    for n in names
                ],
            }
        )
        dfs[split] = df
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            df.to_csv(os.path.join(out_dir, f"{split}_VOC2012_0.csv"), index=False)
    return dfs["train"], dfs["val"]


def create_thyroid_manifest(data_dir: str, out_dir: str | None = None, seed: int = 42):
    """Thyroid: image/ dir paired with mask/ dir by filename; 80/20 split."""
    import pandas as pd
    from sklearn.model_selection import train_test_split

    images, masks = [], []
    for f in sorted(os.listdir(data_dir)):
        images.append(os.path.join(data_dir, f))
        masks.append(os.path.join(data_dir.replace("image", "mask"), f))
    df = pd.DataFrame({"images": images, "masks": masks})
    train, val = train_test_split(df, random_state=seed, test_size=0.2, shuffle=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        train.to_csv(os.path.join(out_dir, "train_Thyroid_0.csv"), index=False)
        val.to_csv(os.path.join(out_dir, "val_Thyroid_0.csv"), index=False)
    return train, val

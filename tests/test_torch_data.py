"""The port's host data path against the JAX package's: the manifest
dataset, the manifest builders, the balance helpers, the native C++ loader
and the stdlib PNG codec. All host-side numpy, so every comparison is exact.
"""

import os

import numpy as np
import pytest

from lmnet_tpu_torch.data import balance as t_balance
from lmnet_tpu_torch.data import manifests as t_manifests
from lmnet_tpu_torch.data import native_loader as t_native
from lmnet_tpu_torch.data.datasets import SegmentationDataset, make_loader, read_manifest
from lmnet_tpu_torch.data.png import read_png, write_png

cv2 = pytest.importorskip("cv2")


def _write_set(root, n, ext=".png", size=(40, 52), classes=2):
    """``n`` image/mask pairs under root/images and root/masks, written with
    cv2; masks are 0/255 circles (binary) or class ids (``classes`` > 2)."""
    rng = np.random.RandomState(n)
    os.makedirs(root / "images", exist_ok=True)
    os.makedirs(root / "masks", exist_ok=True)
    names = []
    for i in range(n):
        h, w = size[0] + 2 * i, size[1] - i
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        yy, xx = np.mgrid[:h, :w]
        circle = (yy - h // 2) ** 2 + (xx - w // 3) ** 2 < (h // 4) ** 2
        mask = (circle * (255 if classes == 2 else 1 + i % (classes - 1))).astype(np.uint8)
        name = f"s{i:02d}{ext}"
        cv2.imwrite(str(root / "images" / name), img)
        cv2.imwrite(str(root / "masks" / name), mask)
        names.append(name)
    return names


def _manifest_csv(path, rows, with_directory=False):
    import csv

    cols = ["images", "masks"] + (["directory"] if with_directory else [])
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(cols)
        for r in rows:
            w.writerow([r[c] for c in cols])


def _batches(loader):
    return [(i.copy(), m.copy()) for i, m in loader]


@pytest.mark.parametrize("mode,mask_mode", [("train", "binary"), ("val", "binary"),
                                            ("val", "index")])
def test_segmentation_dataset_batches_equal_jax(tmp_path, mode, mask_mode):
    """The manifest dataset through make_loader: byte-equal batches to the
    JAX package's on the same CSV (relative paths under a ``directory``
    column with one empty cell, plus ``root``), in train (9/8 load size) and
    val mode, binary and class-id masks, whole and sharded."""
    from lmnet_tpu.data.datasets import SegmentationDataset as JSegmentationDataset
    from lmnet_tpu.data.datasets import make_loader as j_make_loader

    names = _write_set(tmp_path / "data", 5, classes=2 if mask_mode == "binary" else 4)
    rows = [{"images": f"images/{n}", "masks": f"masks/{n}", "directory": "data" if i else ""}
            for i, n in enumerate(names)]
    rows[0]["images"], rows[0]["masks"] = f"data/images/{names[0]}", f"data/masks/{names[0]}"
    csv_path = tmp_path / "m.csv"
    _manifest_csv(csv_path, rows, with_directory=True)
    kw = dict(img_size=32, root=str(tmp_path), mask_mode=mask_mode)
    t_ds = SegmentationDataset.from_csv(str(csv_path), mode, **kw)
    j_ds = JSegmentationDataset.from_csv(str(csv_path), mode, **kw)
    assert len(t_ds) == len(j_ds) == 5 and t_ds.load_size == j_ds.load_size == 36
    for (t, j) in ((t_ds, j_ds), (t_ds.shard(1, 2), j_ds.shard(1, 2))):
        got = _batches(make_loader(t, 2, shuffle=True, seed=3, epoch=1))
        want = _batches(j_make_loader(j, 2, shuffle=True, seed=3, epoch=1))
        assert len(got) == len(want) > 0
        for (gi, gm), (wi, wm) in zip(got, want):
            assert gi.dtype == wi.dtype == np.uint8 and gm.dtype == wm.dtype == np.uint8
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gm, wm)


def test_read_manifest_keeps_strings_and_empty_cells(tmp_path):
    p = tmp_path / "m.csv"
    p.write_text("images,masks,diagnosis,directory\na.png,b.png,1,\nc.png,d.png,0,/x\n")
    rows = read_manifest(str(p))
    assert rows == [{"images": "a.png", "masks": "b.png", "diagnosis": "1", "directory": ""},
                    {"images": "c.png", "masks": "d.png", "diagnosis": "0", "directory": "/x"}]
    ds = SegmentationDataset(rows, "val")
    assert ds._resolve(rows[0], "images") == "a.png"
    assert ds._resolve(rows[1], "masks") == "/x/d.png"


def _tree(root, kind):
    """A directory tree for one manifest builder (empty files: only the
    names are read, but LGG masks, which are decoded)."""
    def touch(p, data=b""):
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p, "wb") as f:
            f.write(data)

    if kind == "kvasir":
        for i in range(20):
            touch(root / "images" / f"k{i:02d}.jpg")
            touch(root / "masks" / f"k{i:02d}.jpg")
    elif kind == "basic":
        for i in range(30):
            d = root / f"case{i % 3}"
            os.makedirs(d, exist_ok=True)
            cv2.imwrite(str(d / f"p{i:02d}_mask.png"), np.full((4, 4), 255 * (i % 2), np.uint8))
            touch(d / f"p{i:02d}.png")
    elif kind == "busi":
        for label in ("benign", "malignant", "normal"):
            for i in range(10):
                touch(root / label / f"{label} ({i}).png")
                touch(root / label / f"{label} ({i})_mask.png")
    elif kind == "cvc":
        for i in range(10):
            touch(root / "Original" / f"{i}.png")
    elif kind == "voc":
        for split, n in (("train", 6), ("val", 4)):
            touch(root / "ImageSets" / "Segmentation" / f"{split}.txt",
                  "".join(f"{split}{i}\n" for i in range(n)).encode())
    elif kind == "thyroid":
        for i in range(10):
            touch(root / "image" / f"t{i}.png")


@pytest.mark.parametrize("kind", ["kvasir", "basic", "busi", "cvc", "voc", "thyroid"])
def test_manifest_builders_write_jax_csvs(tmp_path, kind):
    """Each builder on the same tree writes the same CSV files, byte for
    byte, as the JAX package's (seeded splits and folds included)."""
    from lmnet_tpu.data import manifests as j_manifests

    data = tmp_path / "data"
    _tree(data, kind)
    fn = {"kvasir": "create_kvasir_manifest", "basic": "create_basic_manifest",
          "busi": "create_busi_manifest", "cvc": "create_cvc_manifest",
          "voc": "create_voc_manifest", "thyroid": "create_thyroid_manifest"}[kind]
    src = str(data / "image") if kind == "thyroid" else str(data)
    for mod, out in ((j_manifests, tmp_path / "j"), (t_manifests, tmp_path / "t")):
        getattr(mod, fn)(src, str(out))
    files = sorted(os.listdir(tmp_path / "j"))
    assert files and files == sorted(os.listdir(tmp_path / "t"))
    for f in files:
        assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes(), f


def test_balance_helpers_equal_jax():
    from lmnet_tpu.data import balance as j_balance

    rng = np.random.RandomState(0)
    labels = rng.randint(0, 3, 50)
    np.testing.assert_array_equal(t_balance.calculate_sample_weights(labels),
                                  j_balance.calculate_sample_weights(labels))
    counts = rng.randint(1, 10**6, 4)
    np.testing.assert_array_equal(t_balance.calculate_class_weights(counts),
                                  j_balance.calculate_class_weights(counts))
    masks = [rng.randint(0, 2, (5, 6)).astype(np.uint8) for _ in range(3)]
    np.testing.assert_array_equal(t_balance.merge_multi_masks(masks),
                                  j_balance.merge_multi_masks(masks))


@pytest.fixture
def native():
    if not t_native.native_available():
        pytest.skip("the native loader does not build here (no g++ or libjpeg)")
    from lmnet_tpu.data import native_loader as j_native

    if not j_native.native_available():
        pytest.skip("JAX's native loader does not build here")
    return j_native


@pytest.mark.parametrize("source", ["synthetic", "png", "jpeg"])
def test_native_loader_batches_equal_jax(tmp_path, native, source):
    """The C++ cache loader, built from the port's copy of the source into
    build/: every epoch batch byte-equal to JAX's loader on the same dataset
    (a synthetic set through build_cache; PNG and JPEG manifests, the JPEG
    one through the libjpeg decode stage)."""
    from lmnet_tpu.data.datasets import SegmentationDataset as JSegmentationDataset
    from lmnet_tpu.data.datasets import SyntheticDataset as JSyntheticDataset
    from lmnet_tpu_torch.data.datasets import SyntheticDataset

    if source == "synthetic":
        t_ds, j_ds = SyntheticDataset(6, 32, "train", seed=1), JSyntheticDataset(6, 32, "train", seed=1)
    else:
        ext = ".png" if source == "png" else ".jpg"
        names = _write_set(tmp_path / "data", 5, ext=ext)
        rows = [{"images": f"images/{n}", "masks": f"masks/{n}"} for n in names]
        _manifest_csv(tmp_path / "m.csv", rows)
        kw = dict(img_size=32, root=str(tmp_path / "data"))
        t_ds = SegmentationDataset.from_csv(str(tmp_path / "m.csv"), "train", **kw)
        j_ds = JSegmentationDataset.from_csv(str(tmp_path / "m.csv"), "train", **kw)
    assert (t_native._jpeg_paths(t_ds) is not None) == (source == "jpeg")
    for epoch in (0, 1):
        got = _batches(t_native.make_native_loader(t_ds, str(tmp_path / "t"), 2, shuffle=True,
                                                   seed=4, epoch=epoch, drop_last=True))
        want = _batches(native.make_native_loader(j_ds, str(tmp_path / "j"), 2, shuffle=True,
                                                  seed=4, epoch=epoch, drop_last=True))
        assert len(got) == len(want) == len(t_ds) // 2
        for (gi, gm), (wi, wm) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gm, wm)
    assert str(t_native.BUILD_DIR).endswith(os.path.join("build", "lmnet_tpu_torch"))
    assert any(f.startswith("libloader-") for f in os.listdir(t_native.BUILD_DIR))


def test_png_round_trip_and_cv2_reads_it(tmp_path):
    """write_png's file decodes to the same pixels with read_png and with
    cv2 (an independent decoder), odd sizes included."""
    rng = np.random.RandomState(5)
    for h, w in ((1, 1), (7, 13), (32, 32)):
        rgb = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        path = str(tmp_path / f"x{h}_{w}.png")
        write_png(path, rgb)
        np.testing.assert_array_equal(read_png(path), rgb)
        np.testing.assert_array_equal(cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB), rgb)
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "bad.png"), np.zeros((4, 4), np.uint8))


def test_port_modules_import_no_jax_and_no_optional_host_libraries():
    """Importing the port (CLI included) loads neither JAX nor the JAX
    package, and none of cv2, pandas, sklearn or matplotlib, which the card
    host lacks: a fresh interpreter lists what the imports added."""
    import subprocess
    import sys

    code = ("import sys; before = set(sys.modules); import lmnet_tpu_torch.cli.train, "
            "lmnet_tpu_torch.data, lmnet_tpu_torch.train, lmnet_tpu_torch.metrics, "
            "lmnet_tpu_torch.serve, lmnet_tpu_torch.data.native_loader; "
            "print(sorted({m.split('.')[0] for m in set(sys.modules) - before} & {'jax', 'flax', "
            "'lmnet_tpu', 'cv2', 'pandas', 'sklearn', 'matplotlib'}))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env, capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert out.strip() == "[]"

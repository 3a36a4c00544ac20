"""The port's data pipeline against the JAX package's (CPU, numpy and PIL on
both sides, so every comparison is equality, tolerance 0, except the
polygon rasterisers, which are two algorithms: the native scanline form
against PIL within ``tests/test_native.py``'s bound).

The COCO trees come from ``generate_synthetic_coco`` (each package's own)
at 96 x 128, where every blob's box passes the datasets' 16-pixel minimum.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from human_instance_segmentation_tpu.data import augment as jaug
from human_instance_segmentation_tpu.data import coco as jcoco
from human_instance_segmentation_tpu.data import dataset as jds
from human_instance_segmentation_tpu.data import loader as jloader
from human_instance_segmentation_tpu.data import synthetic as jsyn
from human_instance_segmentation_tpu_torch.data import augment as paug
from human_instance_segmentation_tpu_torch.data import coco as pcoco
from human_instance_segmentation_tpu_torch.data import dataset as pds
from human_instance_segmentation_tpu_torch.data import loader as ploader
from human_instance_segmentation_tpu_torch.data import native as pnative
from human_instance_segmentation_tpu_torch.data import synthetic as psyn

REPO = Path(__file__).resolve().parents[1]
HW = (96, 128)
K = 2  # below the trees' 5 instances an image, so the K-slot rotation shows


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco")
    ann, imgs = psyn.generate_synthetic_coco(str(root / "port"), n_images=6, image_size=HW,
                                             max_instances=5, seed=3)
    return ann, imgs, root


def _assert_tree_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


def test_synthetic_writer_matches_jax(tree):
    from PIL import Image

    ann, imgs, root = tree
    jann, jimgs = jsyn.generate_synthetic_coco(str(root / "jax"), n_images=6, image_size=HW,
                                               max_instances=5, seed=3)
    assert json.loads(Path(ann).read_text()) == json.loads(Path(jann).read_text())
    files = sorted(p.name for p in Path(imgs).iterdir())
    assert files == sorted(p.name for p in Path(jimgs).iterdir()) and len(files) == 6
    for f in files:
        np.testing.assert_array_equal(np.asarray(Image.open(Path(imgs) / f)),
                                      np.asarray(Image.open(Path(jimgs) / f)))
    per_image = {}
    for a in json.loads(Path(ann).read_text())["annotations"]:
        per_image[a["image_id"]] = per_image.get(a["image_id"], 0) + 1
    assert max(per_image.values()) > K  # an image with more instances than slots


def test_native_builds_into_build_dir_and_is_used():
    assert pnative.get_lib() is not None, pnative.build_error  # g++ is on this host
    path = pnative.library_path()
    assert path.is_file() and path.parent == REPO / "build" / "native"
    package = REPO / "human_instance_segmentation_tpu_torch"
    assert not list(package.rglob("*.so"))
    # the codec routes through the native library: a decode that the
    # native form and the Python form give the same mask for
    m = pcoco.rle_decode_counts([3, 4, 5], 4, 3)
    assert m.shape == (4, 3)
    np.testing.assert_array_equal(m, pcoco.rle_decode_counts([3, 4, 5], 4, 3, use_native=False))


def _masks():
    rng = np.random.default_rng(0)
    return {"random": (rng.random((23, 17)) > 0.5).astype(np.uint8),
            "sparse": (rng.random((31, 9)) > 0.9).astype(np.uint8),
            "empty": np.zeros((13, 29), np.uint8),
            "full": np.ones((7, 5), np.uint8),
            "starts_on": np.pad(np.ones((4, 4), np.uint8), ((0, 3), (0, 3)))}


@pytest.mark.parametrize("name", sorted(_masks()))
def test_rle_and_leb_codecs_match_jax(name):
    m = _masks()[name]
    h, w = m.shape
    rle = pcoco.rle_encode(m)
    assert rle == jcoco.rle_encode(m)
    counts = rle["counts"]
    assert pnative.rle_encode_native(m) == counts
    for use_native in (True, False):
        np.testing.assert_array_equal(pcoco.rle_decode_counts(counts, h, w, use_native=use_native),
                                      m)
    np.testing.assert_array_equal(jcoco.rle_decode_counts(counts, h, w), m)
    s = pcoco._leb_string_encode(counts)
    assert s == jcoco._leb_string_encode(counts) == pnative.leb_encode_native(counts)
    for use_native in (True, False):
        assert pcoco._leb_string_decode(s, use_native=use_native) == counts
    assert jcoco._leb_string_decode(s) == counts
    compressed = {"size": [h, w], "counts": s}
    np.testing.assert_array_equal(pcoco.rle_decode(compressed), jcoco.rle_decode(compressed))
    np.testing.assert_array_equal(pcoco.ann_to_mask({"segmentation": compressed}, h, w), m)


def test_polygon_rasterizers():
    """The native scanline rasteriser against the port's PIL form within
    test_native.py's bound, and the PIL form equal to JAX's."""
    polys = [[10.0, 10.0, 50.0, 12.0, 45.0, 55.0, 8.0, 40.0],
             [30.0, 5.0, 60.0, 8.0, 58.0, 30.0]]
    nat = pcoco.polygons_to_mask(polys, 64, 64)
    pil = pcoco.polygons_to_mask(polys, 64, 64, use_native=False)
    np.testing.assert_array_equal(nat, pnative.rasterize_polygons_native(polys, 64, 64))
    np.testing.assert_array_equal(pil, jcoco.polygons_to_mask(polys, 64, 64, use_native=False))
    np.testing.assert_array_equal(nat, jcoco.polygons_to_mask(polys, 64, 64))
    assert (nat & pil).sum() / (nat | pil).sum() > 0.95
    assert nat[30, 30] == pil[30, 30] == 1 and nat[0, 0] == pil[0, 0] == 0
    assert not pcoco.polygons_to_mask([], 8, 8).any()


def test_coco_index_matches_jax(tree):
    ann = tree[0]
    p, j = pcoco.COCOIndex(ann), jcoco.COCOIndex(ann)
    assert p.get_img_ids() == j.get_img_ids()
    for i in p.get_img_ids():
        for crowd in (None, True, False):
            assert p.get_ann_ids(i, iscrowd=crowd) == j.get_ann_ids(i, iscrowd=crowd)
        assert p.load_imgs(i) == j.load_imgs(i)
        for a in p.load_anns(p.get_ann_ids(i)):
            np.testing.assert_array_equal(p.ann_to_mask(a), j.ann_to_mask(a))
    assert p.load_anns([1, 2]) == j.load_anns([1, 2])


DATASET_CASES = {
    "plain": (dict(), None),
    "light": (dict(), dict(heavy=False)),
    "heavy": (dict(), dict(heavy=True, blur_prob=0.5, noise_prob=0.5, weather_prob=0.5,
                            compression_prob=0.5)),
    "padding_and_filter": (dict(roi_padding=0.1, filter_min_box=30.0,
                                filter_aspect_range=(0.3, 3.0), min_roi_size=20), None),
}


@pytest.mark.parametrize("case", sorted(DATASET_CASES))
def test_instance_dataset_matches_jax(tree, case):
    """Every sample (image, boxes, masks, valid, image_id) of every index
    over 3 epochs; the K-slot rotation moves the targets between epochs."""
    ann, imgs, _ = tree
    cfg_kw, aug_kw = DATASET_CASES[case]
    kw = dict(image_size=HW, mask_size=(32, 24), rois_per_image=K, **cfg_kw)
    p = pds.COCOInstanceSegmentationDataset(ann, imgs, pds.DatasetConfig(**kw),
                                            augment=paug.AugmentConfig(**aug_kw)
                                            if aug_kw else None, seed=5)
    j = jds.COCOInstanceSegmentationDataset(ann, imgs, jds.DatasetConfig(**kw),
                                            augment=jaug.AugmentConfig(**aug_kw)
                                            if aug_kw else None, seed=5)
    assert p.samples == j.samples and len(p) > 0
    boxes_by_epoch = []
    for epoch in range(3):
        p.set_epoch(epoch)
        j.set_epoch(epoch)
        for i in range(len(p)):
            _assert_tree_equal(p[i], j[i])
        boxes_by_epoch.append([p[i]["boxes"].tolist() for i in range(len(p))])
    if case == "plain":
        assert boxes_by_epoch[0] != boxes_by_epoch[1]  # the rotation shows


@pytest.mark.parametrize("augment", [False, True])
def test_binary_dataset_matches_jax(tree, augment):
    ann, imgs, _ = tree
    aug = dict(heavy=True) if augment else None
    p = pds.COCOPersonBinaryDataset(ann, imgs, HW, paug.AugmentConfig(**aug) if aug else None)
    j = jds.COCOPersonBinaryDataset(ann, imgs, HW, jaug.AugmentConfig(**aug) if aug else None)
    assert p.img_ids == j.img_ids
    for epoch in range(2):
        p.set_epoch(epoch)
        j.set_epoch(epoch)
        for i in range(len(p)):
            _assert_tree_equal(p[i], j[i])


def _sample(seed=0):
    rng = np.random.default_rng(seed)
    return {"image": rng.random((40, 56, 3), dtype=np.float32),
            "boxes": rng.random((3, 4)).astype(np.float32),
            "masks": rng.integers(0, 3, (3, 16, 12)).astype(np.int32),
            "full_mask": (rng.random((40, 56)) > 0.5).astype(np.float32)}


AUGMENTS = ["brightness_contrast", "saturation_hue", "gamma", "gaussian_noise",
            "gaussian_blur", "rain", "fog", "sun_flare", "iso_noise", "jpeg_compression",
            "downscale"]


@pytest.mark.parametrize("name", AUGMENTS)
def test_augmentation_matches_jax(name):
    """Each transform under one generator state: the same image and the
    same draws left in the generator afterwards."""
    img = _sample()["image"]
    gp, gj = np.random.default_rng(11), np.random.default_rng(11)
    out_p = getattr(paug, name)(img, gp)
    out_j = getattr(jaug, name)(img, gj)
    np.testing.assert_array_equal(out_p, out_j)
    assert out_p.dtype == out_j.dtype
    assert gp.random() == gj.random()


def test_hflip_and_augment_sample_match_jax():
    s = _sample()
    _assert_tree_equal(paug.hflip(s), jaug.hflip(s))
    np.testing.assert_array_equal(paug.hflip(paug.hflip(s))["masks"], s["masks"])
    for heavy in (False, True):
        cfg = dict(heavy=heavy, color_prob=0.9, gamma_prob=0.9, blur_prob=0.9, noise_prob=0.9,
                   weather_prob=0.9, compression_prob=0.9)
        for seed in range(4):
            _assert_tree_equal(
                paug.augment_sample(s, np.random.default_rng(seed), paug.AugmentConfig(**cfg)),
                jaug.augment_sample(s, np.random.default_rng(seed), jaug.AugmentConfig(**cfg)))


class _Counter:
    """A dataset whose sample is its index (and the epoch it was read in)."""

    def __init__(self, n):
        self.n, self.epoch = n, 0

    def __len__(self):
        return self.n

    def set_epoch(self, e):
        self.epoch = e

    def __getitem__(self, i):
        return {"image": np.full((2, 2, 3), i, np.float32), "valid": np.ones((2,), np.float32),
                "epoch": np.asarray(self.epoch)}


def _stack(batches):
    return [{k: v.tolist() for k, v in b.items()} for b in batches]


@pytest.mark.parametrize("shuffle", [False, True])
def test_batch_iterators_match_jax(shuffle):
    ds = _Counter(11)
    for drop_last in (True, False):
        p = _stack(pds.batch_iterator(ds, 4, shuffle=shuffle, seed=3, drop_last=drop_last))
        assert p == _stack(jds.batch_iterator(ds, 4, shuffle=shuffle, seed=3,
                                              drop_last=drop_last))
        assert len(p) == (2 if drop_last else 3)
    p = _stack(pds.padded_batch_iterator(ds, 4, shuffle=shuffle, seed=3))
    assert p == _stack(jds.padded_batch_iterator(ds, 4, shuffle=shuffle, seed=3))
    assert len(p) == 3 and p[-1]["valid"] == [[1, 1], [1, 1], [1, 1], [0, 0]]
    seen = [int(img[0][0][0]) for batch in p for img in batch["images"]][:11]
    assert sorted(seen) == list(range(11))  # every sample once before the pads
    assert "images" in p[0] and "image" not in p[0]  # collate's renaming


def test_threaded_loader_forever_matches_jax(tree):
    """The first two epochs' batches of ``forever()`` with 2 workers equal
    the JAX loader's, augmentation and K-slot rotation included."""
    ann, imgs, _ = tree
    kw = dict(image_size=HW, mask_size=(32, 24), rois_per_image=K)
    p = pds.COCOInstanceSegmentationDataset(ann, imgs, pds.DatasetConfig(**kw),
                                            augment=paug.AugmentConfig(), seed=1)
    j = jds.COCOInstanceSegmentationDataset(ann, imgs, jds.DatasetConfig(**kw),
                                            augment=jaug.AugmentConfig(), seed=1)
    pl = ploader.ThreadedLoader(p, 2, num_workers=2, seed=4, prefetch=1)
    jl = jloader.ThreadedLoader(j, 2, num_workers=2, seed=4, prefetch=1)
    assert len(pl) == len(jl) == len(p) // 2
    pf, jf = pl.forever(), jl.forever()
    for _ in range(2 * len(pl)):
        _assert_tree_equal(next(pf), next(jf))
    pf.close()
    jf.close()


def test_threaded_loader_raises_a_failed_batch():
    class Broken(_Counter):
        def __getitem__(self, i):
            if i == 5:
                raise ValueError("bad sample 5")
            return super().__getitem__(i)

    loader = ploader.ThreadedLoader(Broken(12), 2, num_workers=2, shuffle=False)
    got = []
    with pytest.raises(ValueError, match="bad sample 5"):
        for b in loader.epoch(0):
            got.append(b)
    assert len(got) == 2


def test_prefetch_to_device_on_cpu_passes_batches_through():
    batches = [{"images": np.full((2, 3), i, np.float32), "masks": np.arange(4, dtype=np.int32),
                "image_id": np.asarray([i, i + 1], np.int64)} for i in range(5)]
    out = list(ploader.prefetch_to_device(iter(batches), size=2, device="cpu"))
    assert len(out) == len(batches)
    for o, b in zip(out, batches):
        assert o.keys() == b.keys()
        for k in b:
            assert isinstance(o[k], torch.Tensor) and o[k].device.type == "cpu"
            np.testing.assert_array_equal(o[k].numpy(), b[k])
            assert o[k].numpy().dtype == b[k].dtype

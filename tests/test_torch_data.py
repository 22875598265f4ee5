"""The PyTorch port's data layer held against the JAX package's on the CPU:
catalogs, transforms, the mapper, the COCO json loader, the samplers and the
train and test loaders. The two loaders read the same synthetic COCO json
(images of both orientations written as png files, made here from a numpy
seed) and must yield the same batches: every array bit-equal and the same
``image_id`` order, for ``NUM_WORKERS`` 0 and 4 and each of the three
samplers. Also: the torch bilinear resize that stands in where cv2 is
missing stays within one grey level of ``cv2.INTER_LINEAR``. The mapper's
NEED_MASKS, USE_NORI and DATALOADER.OSS_ROOT are held by
``tests/test_torch_borders.py`` and ``tests/test_torch_recordpack.py``.
"""

import json
import os

import cv2
import numpy as np
import pytest

from slenderobjdet_torch.config import get_cfg as torch_get_cfg
from slenderobjdet_torch.data import build as tbuild
from slenderobjdet_torch.data import catalog as tcatalog
from slenderobjdet_torch.data import mapper as tmapper
from slenderobjdet_torch.data import transforms as tT
from slenderobjdet_torch.data.datasets import coco as tcoco
from slenderobjdet_tpu.config import get_cfg as jax_get_cfg
from slenderobjdet_tpu.data import build as jbuild
from slenderobjdet_tpu.data import catalog as jcatalog
from slenderobjdet_tpu.data import mapper as jmapper
from slenderobjdet_tpu.data import transforms as jT
from slenderobjdet_tpu.data.datasets import coco as jcoco

NAME = "torch_data_synth"
GREY_TOL = 1      # torch bilinear vs cv2.INTER_LINEAR, uint8 grey levels


def write_dataset(tmpdir, seed=0, num_images=12):
    """A COCO instances json with png images of both orientations, slender
    and compact boxes with polygons, one crowd annotation and one image
    without annotations."""
    rs = np.random.RandomState(seed)
    cat_ids = [1, 4, 7]
    root = os.path.join(str(tmpdir), "images")
    os.makedirs(root, exist_ok=True)
    images, annotations = [], []
    ann_id = 1
    for img_id in range(1, num_images + 1):
        h, w = (96, 128) if rs.rand() < 0.5 else (128, 96)
        name = f"{img_id:06d}.png"
        cv2.imwrite(os.path.join(root, name), rs.randint(0, 256, (h, w, 3)).astype(np.uint8))
        images.append({"id": img_id, "file_name": name, "height": h, "width": w})
        for k in range(0 if img_id == 3 else rs.randint(1, 5)):
            if rs.rand() < 0.5:
                bw, bh = rs.randint(40, 60), rs.randint(4, 9)
            else:
                bw, bh = rs.randint(10, 50), rs.randint(10, 50)
            x, y = rs.randint(0, w - bw), rs.randint(0, h - bh)
            annotations.append({
                "id": ann_id, "image_id": img_id, "category_id": int(rs.choice(cat_ids)),
                "bbox": [float(x), float(y), float(bw), float(bh)], "area": float(bw * bh),
                "iscrowd": int(img_id == 5 and k == 0),
                "segmentation": [[x, y, x + bw, y, x + bw, y + bh, x, y + bh]]})
            ann_id += 1
    path = os.path.join(str(tmpdir), "instances.json")
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": annotations, "categories": [
            {"id": c, "name": f"cat{i}", "supercategory": "obj"}
            for i, c in enumerate(cat_ids)]}, f)
    return path, root


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    path, root = write_dataset(tmp_path_factory.mktemp("torch_data"))
    for catalog, coco in ((jcatalog, jcoco), (tcatalog, tcoco)):
        catalog.DatasetCatalog.remove(NAME)
        coco.register_coco_instances(NAME, path, root)
    return path, root


def cfg_pair(**overrides):
    base = {"DATASETS.TRAIN": (NAME,), "DATASETS.TEST": (NAME,),
            "INPUT.MIN_SIZE_TRAIN": (48, 64), "INPUT.MAX_SIZE_TRAIN": 160,
            "INPUT.MIN_SIZE_TEST": 64, "INPUT.MAX_SIZE_TEST": 100,
            "TPU.MAX_GT_PER_IMAGE": 6, "SOLVER.IMS_PER_BATCH": 3, **overrides}
    out = []
    for get_cfg in (jax_get_cfg, torch_get_cfg):
        cfg = get_cfg()
        cfg.merge_from_list([x for kv in base.items() for x in kv])
        cfg.freeze()
        out.append(cfg)
    return out


def assert_batches_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        if k in ("image_id", "batch_valid"):
            assert got[k] == want[k], k
        else:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ------------------------------------------------------------------ loaders
@pytest.mark.parametrize("workers", [0, 4])
@pytest.mark.parametrize("sampler", ["TrainingSampler", "RatioFactorTrainingSampler",
                                     "RepeatFactorTrainingSampler"])
def test_train_loader_yields_the_jax_loaders_batches(dataset, sampler, workers):
    jcfg, tcfg = cfg_pair(**{"DATALOADER.NUM_WORKERS": workers,
                             "DATALOADER.SAMPLER_TRAIN": sampler,
                             "DATALOADER.REPEAT_THRESHOLD": 0.3})
    want = iter(jbuild.build_detection_train_loader(jcfg, seed=5, shard_id=0, num_shards=1))
    got = iter(tbuild.build_detection_train_loader(tcfg, seed=5))
    shapes = set()
    for _ in range(7):
        w, g = next(want), next(got)
        assert_batches_equal(g, w)
        shapes.add(g["image"].shape)
        assert g["gt_boxes"].shape == (3, 6, 4) and g["image"].dtype == np.uint8
    # both orientation buckets were seen: (short pad, long pad) and its transpose
    assert shapes == {(3, 128, 256, 3), (3, 256, 128, 3)}


@pytest.mark.parametrize("workers", [0, 4])
def test_test_loader_yields_the_jax_loaders_batches(dataset, workers):
    jcfg, tcfg = cfg_pair(**{"DATALOADER.NUM_WORKERS": workers,
                             "INPUT.MAX_SIZE_TEST": 160})
    want = list(jbuild.build_detection_test_loader(jcfg, NAME, batch_size=5,
                                                   shard_id=0, num_shards=1))
    got = list(tbuild.build_detection_test_loader(tcfg, NAME, batch_size=5))
    assert len(got) == len(want) >= 3
    for g, w in zip(got, want):
        assert_batches_equal(g, w)
    ids = [i for b in got for i, v in zip(b["image_id"], b["batch_valid"]) if v]
    assert sorted(ids) == list(range(1, 13))
    assert {b["image"].shape[1:3] for b in got} == {(128, 256), (256, 128)}


def test_loaders_are_one_shard_of_one_until_data_parallel(dataset):
    """With no arguments and no process group, and with the one-shard
    layout named, the loaders yield the same batches; a layout that does
    not divide the global batch raises, as the JAX loader's assert does.
    (Sharded layouts: ``tests/test_torch_ddp.py``.)"""
    jcfg, tcfg = cfg_pair(**{"SOLVER.IMS_PER_BATCH": 4, "DATALOADER.NUM_WORKERS": 2})
    plain = iter(tbuild.build_detection_train_loader(tcfg, seed=1))
    named = iter(tbuild.build_detection_train_loader(tcfg, seed=1, shard_id=0, num_shards=1))
    for _ in range(3):
        assert_batches_equal(next(named), next(plain))
    for got, want in zip(tbuild.build_detection_test_loader(tcfg, NAME, 2, shard_id=0,
                                                            num_shards=1),
                         tbuild.build_detection_test_loader(tcfg, NAME, 2)):
        assert_batches_equal(got, want)
    assert tbuild._resolve_shard(None, None) == (0, 1)
    for build in (jbuild.build_detection_train_loader, tbuild.build_detection_train_loader):
        cfg = jcfg if build is jbuild.build_detection_train_loader else tcfg
        with pytest.raises(AssertionError, match="not divisible by 3"):
            build(cfg, shard_id=1, num_shards=3)


def test_unknown_sampler_raises(dataset):
    _, tcfg = cfg_pair(**{"DATALOADER.SAMPLER_TRAIN": "Nope"})
    with pytest.raises(ValueError, match="Nope"):
        tbuild.build_detection_train_loader(tcfg)


def test_flagship_buckets_are_896x1408_and_its_transpose():
    from pathlib import Path

    cfg = torch_get_cfg()
    cfg.merge_from_file(str(Path(__file__).resolve().parents[1]
                            / "configs/fcos/fcos_R_50_FPN_1x.yaml"))
    for is_train in (True, False):
        m = tmapper.DatasetMapper(cfg, is_train=is_train)
        assert m.pad_landscape == (896, 1408) and m.pad_portrait == (1408, 896)
    assert tmapper.DatasetMapper(cfg).max_gt == 100


# ------------------------------------------------------------------- samplers
def test_samplers_equal_the_jax_samplers(dataset):
    import itertools

    for shuffle in (True, False):
        want = list(itertools.islice(jbuild.training_sampler(7, seed=3, shuffle=shuffle), 30))
        assert list(itertools.islice(tbuild.training_sampler(7, seed=3, shuffle=shuffle),
                                     30)) == want
    dicts = tcatalog.DatasetCatalog.get(NAME)
    want = jbuild.repeat_factors_from_ratios(jcatalog.DatasetCatalog.get(NAME))
    got = tbuild.repeat_factors_from_ratios(dicts)
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) <= {1.0, 1.1, 1.5, 2.0} and got.max() == 2.0
    assert list(itertools.islice(tbuild.repeat_factor_sampler(got, seed=2), 60)) == list(
        itertools.islice(jbuild.repeat_factor_sampler(want, seed=2), 60))


def test_mp_map_stream_keeps_order_and_seeds_by_sequence():
    def mapper(d, rng):
        return (d, float(rng.random()))

    items = list(range(20))
    idx = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5]
    got = list(tbuild.mp_map_stream(items, mapper, iter(idx), num_workers=3, seed=8))
    want = list(jbuild.mp_map_stream(items, mapper, iter(idx), num_workers=3, seed=8))
    assert got == want and [g[0] for g in got] == idx
    assert got[1][1] != got[3][1]       # same item, another sequence number


# --------------------------------------------------------- json and catalogs
def test_load_coco_json_equals_the_jax_loader(dataset):
    path, root = dataset
    want = jcoco.load_coco_json(path, root, NAME)
    got = tcoco.load_coco_json(path, root, NAME)
    assert got == want and len(got) == 12
    assert tcatalog.DatasetCatalog.get(NAME) == want
    jm, tm = jcatalog.MetadataCatalog.get(NAME), tcatalog.MetadataCatalog.get(NAME)
    assert tm.as_dict() == jm.as_dict()
    assert tm.thing_dataset_id_to_contiguous_id == {1: 0, 4: 1, 7: 2}
    assert tm.get("evaluator_type") == "coco" and tm.get("nope", 5) == 5
    assert tcoco.COCO_THING_CLASSES == jcoco.COCO_THING_CLASSES


def test_catalogs_are_the_ports_own(dataset):
    assert tcatalog.DatasetCatalog is not jcatalog.DatasetCatalog
    tcatalog.DatasetCatalog.register("torch_only_name", lambda: [{"a": 1}])
    try:
        assert "torch_only_name" in tcatalog.DatasetCatalog
        assert "torch_only_name" not in jcatalog.DatasetCatalog
        assert "torch_only_name" in tcatalog.DatasetCatalog.list()
        with pytest.raises(KeyError, match="already registered"):
            tcatalog.DatasetCatalog.register("torch_only_name", list)
    finally:
        tcatalog.DatasetCatalog.remove("torch_only_name")
    with pytest.raises(KeyError, match="not registered"):
        tcatalog.DatasetCatalog.get("torch_only_name")
    # the builtin COCO names are registered, and their rotated views
    assert {"coco_2017_train", "coco_2017_val"} <= set(tcatalog.DatasetCatalog.list())
    assert {"rcoco_2017_train", "rcoco_2017_val"} <= set(tcatalog.DatasetCatalog.list())
    assert tcatalog.MetadataCatalog.get("rcoco_2017_val").evaluator_type == "rcoco"
    assert tbuild.get_detection_dataset_dicts([NAME, NAME]) == 2 * tbuild.get_detection_dataset_dicts(NAME)


# ------------------------------------------------------------ transforms, mapper
def _image_and_boxes(rs, h, w, n=5):
    xy = rs.rand(n, 2) * [w - 20, h - 20]
    boxes = np.concatenate([xy, xy + rs.rand(n, 2) * 18 + 2], 1).astype(np.float32)
    return rs.randint(0, 256, (h, w, 3)).astype(np.uint8), boxes


@pytest.mark.parametrize("hw,short,max_size", [((96, 128), 64, 100), ((128, 96), 48, 60),
                                               ((64, 80), 64, 200), ((50, 70), 100, 333)])
def test_transforms_equal_the_jax_transforms(hw, short, max_size):
    rs = np.random.RandomState(11)
    image, boxes = _image_and_boxes(rs, *hw)
    for got, want in zip(tT.resize_shortest_edge(image, boxes, short, max_size),
                         jT.resize_shortest_edge(image, boxes, short, max_size)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tT.resize_longest_edge(image, boxes, short),
                         jT.resize_longest_edge(image, boxes, short)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tT.horizontal_flip(image, boxes), jT.horizontal_flip(image, boxes)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tT.pad_to(image, (130, 140)), jT.pad_to(image, (130, 140)))
    with pytest.raises(AssertionError):
        tT.pad_to(image, (10, 10))
    for sampling, sizes in (("choice", (48, 56, 64)), ("range", (48, 64))):
        a, b = np.random.default_rng(4), np.random.default_rng(4)
        assert [tT.choose_train_size(a, sizes, sampling) for _ in range(20)] == [
            jT.choose_train_size(b, sizes, sampling) for _ in range(20)]


@pytest.mark.parametrize("src,dst", [((120, 160), (64, 85)), ((50, 70), (128, 179)),
                                     ((96, 128), (75, 100)), ((37, 23), (36, 24))])
def test_torch_bilinear_resize_is_within_one_grey_level_of_cv2(src, dst):
    rs = np.random.RandomState(12)
    image = rs.randint(0, 256, src + (3,)).astype(np.uint8)
    got = tT.bilinear_resize(image, (dst[1], dst[0]))
    want = cv2.resize(image, (dst[1], dst[0]), interpolation=cv2.INTER_LINEAR)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= GREY_TOL
    plane = rs.rand(*src).astype(np.float32)
    np.testing.assert_allclose(
        tT.bilinear_resize(plane, (dst[1], dst[0])),
        cv2.resize(plane, (dst[1], dst[0]), interpolation=cv2.INTER_LINEAR), atol=1e-5)


@pytest.mark.parametrize("fmt", ["BGR", "RGB"])
def test_mapper_equals_the_jax_mapper_on_inlined_dicts(fmt):
    """Dicts that inline their image, with rotated boxes, a crowd annotation
    and a box that the clip makes empty; train (flips) and test."""
    rs = np.random.RandomState(13)
    jcfg, tcfg = cfg_pair(**{"INPUT.FORMAT": fmt, "TPU.MAX_GT_PER_IMAGE": 3})
    for is_train in (True, False):
        jm, tm = jmapper.DatasetMapper(jcfg, is_train), tmapper.DatasetMapper(tcfg, is_train)
        for i, hw in enumerate([(96, 128), (128, 96), (64, 64)] * 2):
            image, boxes = _image_and_boxes(rs, *hw)
            annos = [{"bbox": b.tolist(), "category_id": int(rs.randint(3)),
                      "iscrowd": int(k == 4),
                      "rbox": [float(b[0]), float(b[1]), 9.0, 4.0, float(rs.rand() * 90)]}
                     for k, b in enumerate(boxes)]
            annos[1]["bbox"] = [hw[1] + 5.0, 3.0, hw[1] + 9.0, 9.0]     # outside the image
            if i % 2:
                for a in annos:
                    del a["rbox"]
            d = {"image": image, "image_id": 100 + i, "annotations": annos}
            want = jm(d, rng=np.random.default_rng((2, i)))
            got = tm(d, rng=np.random.default_rng((2, i)))
            assert_batches_equal({k: v for k, v in got.items() if k != "image_id"},
                                 {k: v for k, v in want.items() if k != "image_id"})
            assert got["image_id"] == want["image_id"] == 100 + i
            assert ("gt_rboxes" in got) == (i % 2 == 0) and got["gt_valid"].sum() == 3


def test_mapper_without_cv2_resizes_with_torch_and_refuses_files(dataset, monkeypatch):
    path, root = dataset
    _, tcfg = cfg_pair()
    mapper = tmapper.DatasetMapper(tcfg, is_train=False)
    d = tcatalog.DatasetCatalog.get(NAME)[0]
    want = mapper(d)
    inlined = dict(d, image=cv2.imread(d["file_name"], cv2.IMREAD_COLOR))
    monkeypatch.setattr(tT, "cv2", None)
    monkeypatch.setattr(tmapper, "cv2", None)
    got = mapper(inlined)
    assert got["image"].shape == want["image"].shape
    assert np.abs(got["image"].astype(np.int32) - want["image"].astype(np.int32)).max() <= GREY_TOL
    np.testing.assert_array_equal(got["gt_boxes"], want["gt_boxes"])
    with pytest.raises(RuntimeError, match="cv2"):
        mapper(d)
    # a size that needs no resize goes through untouched
    same = {"image": np.full((64, 80, 3), 7, np.uint8), "annotations": []}
    assert mapper(same)["scale"] == 1.0 and mapper(same)["image"][:64, :80].min() == 7


def test_read_image_reports_a_missing_file(tmp_path):
    with pytest.raises(FileNotFoundError):
        tmapper.read_image({"file_name": str(tmp_path / "nope.png")})


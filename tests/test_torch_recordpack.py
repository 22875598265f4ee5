"""The port's other data sources held against the JAX package on the CPU:
``slenderobjdet_torch/data/recordpack.py`` (RecordPacks), ``utils/
smart_path.py``, ``data/datasets/objects365.py``, the mapper's USE_NORI +
NORI_PATH image pack, its ``<split>_sizes.pack`` maps and
DATALOADER.OSS_ROOT, and ``python -m slenderobjdet_torch.tools.coco_to_pack``:

- packs round-trip, refuse a bad magic, write from a thread (whose errors
  reach ``write`` and ``close``) and serve concurrent reads; a pack is the
  same bytes from either package's writer, and each package reads the
  other's;
- ``smart_path`` gates ``s3://`` behind the optional ``s3path`` as JAX does,
  and the Objects365 name map and registrations are JAX's;
- the mapper on packs (images and sizes) and on an OSS root gives the JAX
  mapper's examples bit for bit, resized and flipped; ``coco_to_pack
  --sizes`` writes the JAX tool's packs byte for byte;
- without cv2 the precomputed maps are resized on torch within
  FLOAT_RESIZE_RATIO of cv2's, and an image from a pack raises.

Every input comes from a numpy generator seeded in its test.
"""

import importlib.util
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))

from synthetic import make_coco_json  # noqa: E402

from slenderobjdet_torch.config import get_cfg as torch_get_cfg  # noqa: E402
from slenderobjdet_torch.data import catalog as tcatalog  # noqa: E402
from slenderobjdet_torch.data import mapper as tmapper  # noqa: E402
from slenderobjdet_torch.data import recordpack as tpack  # noqa: E402
from slenderobjdet_torch.data import transforms as tT  # noqa: E402
from slenderobjdet_torch.data.datasets import coco as tcoco  # noqa: E402
from slenderobjdet_torch.data.datasets import objects365 as tobj365  # noqa: E402
from slenderobjdet_torch.tools import coco_to_pack as tcoco_to_pack  # noqa: E402
from slenderobjdet_torch.utils.smart_path import smart_path as tsmart_path  # noqa: E402
from slenderobjdet_tpu.config import get_cfg as jax_get_cfg  # noqa: E402
from slenderobjdet_tpu.data import catalog as jcatalog  # noqa: E402
from slenderobjdet_tpu.data import mapper as jmapper  # noqa: E402
from slenderobjdet_tpu.data import recordpack as jpack  # noqa: E402
from slenderobjdet_tpu.data.datasets import coco as jcoco  # noqa: E402
from slenderobjdet_tpu.data.datasets import objects365 as jobj365  # noqa: E402
from slenderobjdet_tpu.utils.smart_path import smart_path as jsmart_path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SPLIT = "torch_packtest"
# torch bilinear against cv2.INTER_LINEAR on float32 maps, max |diff| over
# the map's largest |value|: the same taps, cv2's weights rounded coarser
FLOAT_RESIZE_RATIO = 1e-4


def ratio(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30))


# ------------------------------------------------------------------ packs
def _records(seed, n=24):
    rs = np.random.RandomState(seed)
    return {f"rec{i:03d}.png": rs.bytes(int(rs.randint(0, 300))) for i in range(n)}


@pytest.mark.parametrize("writer", ["PackWriter", "AsyncPackWriter"])
def test_pack_roundtrip(tmp_path, writer):
    blobs = _records(1)
    path = str(tmp_path / "a.pack")
    w = getattr(tpack, writer)(path)
    with w:
        for name, data in blobs.items():
            w.write(data, name)
    r = tpack.PackReader(path)
    assert len(r) == len(blobs) and list(r.keys()) == list(blobs)
    for name, data in blobs.items():
        assert name in r and r.get(name) == data
    with pytest.raises(KeyError):
        r.get("missing")
    r.close()
    with tpack.PackWriter(str(tmp_path / "dup.pack")) as w, pytest.raises(KeyError):
        w.write(b"x", "a")
        w.write(b"y", "a")


def test_pack_refuses_a_bad_magic_and_a_short_file(tmp_path):
    junk = tmp_path / "junk.pack"
    junk.write_bytes(b"not a pack at all, nope")
    with pytest.raises(ValueError, match="magic"):
        tpack.PackReader(str(junk))
    short = tmp_path / "short.pack"
    short.write_bytes(b"SLDR")
    with pytest.raises(ValueError, match="too small"):
        tpack.PackReader(str(short))


def test_async_writer_error_reaches_write_and_close(tmp_path):
    """A failure on the writer's thread (a duplicate name) surfaces as a
    RuntimeError from ``write`` and from ``close``, never a deadlock
    against the full queue."""
    w = tpack.AsyncPackWriter(str(tmp_path / "err.pack"), maxsize=2).start()
    w.write(b"x", "dup")
    with pytest.raises(RuntimeError, match="writer thread failed") as err:
        for _ in range(400):
            w.write(b"y", "dup")
            time.sleep(0.005)
    assert isinstance(err.value.__cause__, KeyError)
    with pytest.raises(RuntimeError, match="writer thread failed"):
        w.close()


def test_concurrent_reads(tmp_path):
    path = str(tmp_path / "c.pack")
    blobs = {f"k{i}": bytes([i]) * (1 + i) for i in range(64)}
    with tpack.PackWriter(path) as w:
        for name, data in blobs.items():
            w.write(data, name)
    r = tpack.PackReader(path)

    def read_all(seed):
        rs = np.random.RandomState(seed)
        for _ in range(200):
            k = f"k{rs.randint(64)}"
            assert r.get(k) == blobs[k]
        return True

    with ThreadPoolExecutor(8) as ex:
        assert all(ex.map(read_all, range(16)))


@pytest.mark.parametrize("writer", ["PackWriter", "AsyncPackWriter"])
def test_pack_bytes_equal_jax_and_each_reads_the_other(tmp_path, writer):
    blobs = _records(2)
    paths = {}
    for side, mod in (("jax", jpack), ("torch", tpack)):
        paths[side] = str(tmp_path / f"{side}.pack")
        with getattr(mod, writer)(paths[side]) as w:
            for name, data in blobs.items():
                w.write(data, name)
    assert Path(paths["jax"]).read_bytes() == Path(paths["torch"]).read_bytes()
    for reader, path in ((tpack.PackReader, paths["jax"]), (jpack.PackReader, paths["torch"])):
        r = reader(path)
        assert {k: r.get(k) for k in r.keys()} == blobs


# ------------------------------------------------------------------ paths, Objects365
def test_smart_path_gates_s3_as_jax(tmp_path):
    p = tsmart_path(str(tmp_path / "x.txt"))
    p.write_text("hi")
    assert type(p) is type(jsmart_path(str(tmp_path / "x.txt"))) and p.read_text() == "hi"
    try:
        import s3path  # noqa: F401
        pytest.skip("s3path installed; the gate is not reachable")
    except ImportError:
        pass
    with pytest.raises(ImportError) as want:
        jsmart_path("s3://bucket/key")
    with pytest.raises(ImportError) as got:
        tsmart_path("s3://bucket/key")
    assert str(got.value) == str(want.value) and "s3path" in str(got.value)


def test_objects365_name_map_and_registration_equal_jax():
    rs = np.random.RandomState(3)
    names = [*tcoco.COCO_THING_CLASSES, "Sports Car", "motorbike", "cellphone", " TV ",
             "hamburger", "Person", "wine glass", "zebra crossing"]
    names = [names[i] for i in rs.permutation(len(names))]
    got = tobj365.obj365_to_coco_name_map(names)
    assert got == jobj365.obj365_to_coco_name_map(names)
    assert len(got) == 80 + 5 and names.index("hamburger") not in got
    for name in ("objects365_train", "objects365_val"):
        assert name in tcatalog.DatasetCatalog and name in jcatalog.DatasetCatalog
        assert tcatalog.MetadataCatalog.get(name).get("evaluator_type") == "coco"


def test_register_objects365_reads_a_coco_json(tmp_path):
    path, root = make_coco_json(tmp_path, num_images=2, seed=4)
    tcatalog.DatasetCatalog.remove("torch_obj365_synth")
    tobj365.register_objects365("torch_obj365_synth", path, root)
    dicts = tcatalog.DatasetCatalog.get("torch_obj365_synth")
    assert len(dicts) == 2 and dicts[0]["annotations"][0]["segmentation"]
    assert tcatalog.MetadataCatalog.get("torch_obj365_synth").json_file == path


# ------------------------------------------------------------------ the mapper
def _jax_coco_to_pack(argv):
    spec = importlib.util.spec_from_file_location("jax_coco_to_pack",
                                                  ROOT / "tools" / "coco_to_pack.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    old = sys.argv
    sys.argv = ["coco_to_pack.py"] + argv
    try:
        mod.main()
    finally:
        sys.argv = old


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    """A synthetic COCO set (slender and compact boxes, their polygons) packed
    by the port's tool into ``<SPLIT>.pack`` / ``<SPLIT>_sizes.pack`` and by
    the JAX tool beside it."""
    tmp = tmp_path_factory.mktemp("torch_pack")
    gt_json, image_root = make_coco_json(tmp, num_images=4, slender=True, seed=5)
    tcoco_to_pack.main(["--gt-json", gt_json, "--image-root", image_root,
                        "--out", str(tmp / f"{SPLIT}.pack"), "--sizes"])
    (tmp / "jax").mkdir()
    _jax_coco_to_pack(["--gt-json", gt_json, "--image-root", image_root,
                       "--out", str(tmp / "jax" / f"{SPLIT}.pack"), "--sizes"])
    for catalog, coco in ((jcatalog, jcoco), (tcatalog, tcoco)):
        catalog.DatasetCatalog.remove(SPLIT)
        coco.register_coco_instances(SPLIT, gt_json, image_root)
    return tmp, gt_json, image_root


def test_coco_to_pack_writes_the_jax_tools_packs(packed):
    tmp, gt_json, image_root = packed
    for name in (f"{SPLIT}.pack", f"{SPLIT}_sizes.pack"):
        assert (tmp / name).read_bytes() == (tmp / "jax" / name).read_bytes(), name
    r = tpack.PackReader(str(tmp / f"{SPLIT}.pack"))
    with open(gt_json) as f:
        files = [i["file_name"] for i in json.load(f)["images"]]
    assert sorted(r.keys()) == sorted(files)
    assert r.get(files[0]) == (Path(image_root) / files[0]).read_bytes()


def test_coco_to_pack_runs_as_a_module(packed, tmp_path):
    _, gt_json, image_root = packed
    out = tmp_path / "m.pack"
    proc = subprocess.run([sys.executable, "-m", "slenderobjdet_torch.tools.coco_to_pack",
                           "--gt-json", gt_json, "--image-root", image_root, "--out", str(out),
                           "--max-images", "2"],
                          capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "packed 2 images" in proc.stdout and len(tpack.PackReader(str(out))) == 2
    assert not (tmp_path / "m_sizes.pack").exists()


def cfg_pair(tmp, arch="ProposalNetworkWithMasks", **overrides):
    base = {"MODEL.META_ARCHITECTURE": arch, "NEED_MASKS": True,
            "USE_NORI": True, "NORI_PATH": str(tmp),
            "DATASETS.TRAIN": (SPLIT,), "DATASETS.TEST": (SPLIT,),
            "INPUT.MIN_SIZE_TRAIN": (64, 96), "INPUT.MAX_SIZE_TRAIN": 200,
            "INPUT.MIN_SIZE_TEST": 120, "INPUT.MAX_SIZE_TEST": 160,
            "TPU.MAX_GT_PER_IMAGE": 6, **overrides}
    out = []
    for get_cfg in (jax_get_cfg, torch_get_cfg):
        cfg = get_cfg()
        cfg.merge_from_list([x for kv in base.items() for x in kv])
        cfg.freeze()
        out.append(cfg)
    return out


def _assert_examples_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if k == "image_id":
            assert got[k] == w
            continue
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.parametrize("arch", ["FCOSV3", "ProposalNetworkWithMasks"])
@pytest.mark.parametrize("is_train", [True, False])
def test_mapper_from_packs_equals_jax(packed, arch, is_train):
    """Images from ``<SPLIT>.pack`` and maps from ``<SPLIT>_sizes.pack``
    (the file names point nowhere: the packs alone suffice), resized by
    cv2 and, at train, flipped, against the JAX mapper on the same packs."""
    tmp, _, _ = packed
    jcfg, tcfg = cfg_pair(tmp, arch)
    jm, tm = jmapper.DatasetMapper(jcfg, is_train), tmapper.DatasetMapper(tcfg, is_train)
    assert tm.image_pack is not None and tm.sizes_pack is not None
    dicts = [dict(d, file_name=os.path.join("/nonexistent-root",
                                            os.path.basename(d["file_name"])))
             for d in tcatalog.DatasetCatalog.get(SPLIT)]
    flips = set()
    for seed, d in enumerate(dicts * 2):
        want = jm(d, rng=np.random.default_rng(seed))
        got = tm(d, rng=np.random.default_rng(seed))
        _assert_examples_equal(got, want)
        assert ("size_map" in got) == (arch == "ProposalNetworkWithMasks")
        assert got["center_mask"].max() > 0.5
        r = np.random.default_rng(seed)
        tT.choose_train_size(r, tm.min_sizes, tm.sampling)
        flips.add(is_train and r.random() < 0.5)
    assert flips == ({True, False} if is_train else {False})


def test_mapper_oss_root_equals_jax(packed):
    """OssMapper semantics: file names relative to DATALOADER.OSS_ROOT."""
    tmp, _, image_root = packed
    jcfg, tcfg = cfg_pair(tmp, "FCOS", **{"USE_NORI": False, "NEED_MASKS": False,
                                          "DATALOADER.OSS_ROOT": image_root})
    jm, tm = jmapper.DatasetMapper(jcfg, True), tmapper.DatasetMapper(tcfg, True)
    plain = tmapper.DatasetMapper(cfg_pair(tmp, "FCOS", USE_NORI=False, NEED_MASKS=False)[1],
                                  True)
    for seed, d in enumerate(tcatalog.DatasetCatalog.get(SPLIT)):
        rel = dict(d, file_name=os.path.basename(d["file_name"]))
        got = tm(rel, rng=np.random.default_rng(seed))
        _assert_examples_equal(got, jm(rel, rng=np.random.default_rng(seed)))
        _assert_examples_equal(got, plain(d, rng=np.random.default_rng(seed)))


def test_mapper_without_cv2_resizes_maps_on_torch_and_refuses_packed_images(packed,
                                                                           monkeypatch):
    """The sizes pack's maps resized by ``transforms.bilinear_resize``
    within FLOAT_RESIZE_RATIO of cv2's; an image from the pack raises a
    RuntimeError naming cv2."""
    tmp, _, _ = packed
    jcfg, tcfg = cfg_pair(tmp)
    jm, tm = jmapper.DatasetMapper(jcfg, True), tmapper.DatasetMapper(tcfg, True)
    dicts = tcatalog.DatasetCatalog.get(SPLIT)
    inlined = [dict(d, image=tmapper.read_image(d)) for d in dicts]
    want = [jm(d, rng=np.random.default_rng(i)) for i, d in enumerate(inlined)]
    monkeypatch.setattr(tT, "cv2", None)
    monkeypatch.setattr(tmapper, "cv2", None)
    for i, d in enumerate(inlined):
        got = tm(d, rng=np.random.default_rng(i))
        assert float(got["scale"]) != 1.0
        for k in ("center_mask", "border_mask", "size_map"):
            assert got[k].shape == want[i][k].shape
            assert ratio(got[k], want[i][k]) <= FLOAT_RESIZE_RATIO, k
        np.testing.assert_array_equal(got["gt_boxes"], want[i]["gt_boxes"])
    with pytest.raises(RuntimeError, match="cv2"):
        tm(dicts[0], rng=np.random.default_rng(0))


def test_float_bilinear_resize_matches_cv2():
    """``bilinear_resize`` on float32 maps, down and up, 1 and 2 channels."""
    import cv2

    rs = np.random.RandomState(6)
    for shape, size in (((120, 160), (96, 72)), ((120, 160, 2), (200, 150)),
                        ((75, 33), (41, 90)), ((64, 64, 2), (64, 64))):
        m = (rs.rand(*shape) * rs.choice([1.0, 300.0])).astype(np.float32)
        want = cv2.resize(m, size, interpolation=cv2.INTER_LINEAR)
        got = tT.bilinear_resize(m, size)
        assert got.dtype == np.float32 and got.shape == want.shape
        assert ratio(got, want) <= FLOAT_RESIZE_RATIO

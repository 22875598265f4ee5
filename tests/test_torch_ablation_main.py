"""The PyTorch port's ablation chassis beside its grid parity tests
(``tests/test_torch_ablation.py``, whose helpers it uses), on the CPU at the
same tiny size:

- ``predict`` slot for slot against the JAX package, one cell a head;
- the point grid and anchors exactly, the deformable convs in float32
  whatever the compute dtype, the three ablation YAMLs at full width, the
  registry's 26 names and what still raises;
- ``train_net_torch.main --device cpu`` on ``pointset_sup.yaml``: train,
  resume bit-equal to an uninterrupted run, evaluate.

Every input comes from a numpy seed inside its test.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from synthetic import make_coco_json  # noqa: E402

import train_net_torch  # noqa: E402
from slenderobjdet_torch.config import get_cfg as torch_get_cfg  # noqa: E402
from slenderobjdet_torch.data import catalog as tcatalog  # noqa: E402
from slenderobjdet_torch.data.datasets import coco as tcoco  # noqa: E402
from slenderobjdet_torch.engine import trainer as ttrainer  # noqa: E402
from slenderobjdet_torch.evaluation.coco_evaluation import STATS_NAMES  # noqa: E402
from slenderobjdet_torch.models import META_ARCHS  # noqa: E402
from slenderobjdet_torch.models import build_model as torch_build_model  # noqa: E402
from slenderobjdet_torch.models.meta_arch import ablation as tabl  # noqa: E402
from slenderobjdet_tpu.config import get_cfg as jax_get_cfg  # noqa: E402
from slenderobjdet_tpu.models import build_model as jax_build_model  # noqa: E402
from test_torch_ablation import (YAMLS, cell_id, cell_seed, draw_variables,  # noqa: E402
                                 jnp_batch, one_torch_thread, port_model,  # noqa: F401
                                 tiny_cfg)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def predict_batch(seed):
    rs = np.random.RandomState(seed)
    return {"image": rs.randint(0, 256, (2, 64, 96, 3)).astype(np.uint8),
            "scale": np.array([1.0, 0.8], np.float32),
            "orig_size": np.array([[64, 96], [51, 76]], np.float32)}


def assert_detections_equal(got, want):
    valid = want["valid"]
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    np.testing.assert_array_equal(got["classes"].numpy()[valid], want["classes"][valid])
    assert got["classes"].dtype == torch.int32 and got["valid"].dtype == torch.bool
    np.testing.assert_allclose(got["scores"].numpy()[valid], want["scores"][valid],
                               rtol=0, atol=1e-5)
    assert tuple(got["boxes"].shape) == want["boxes"].shape == (2, 100, 4)
    np.testing.assert_allclose(got["boxes"].numpy()[valid], want["boxes"][valid], rtol=0,
                               atol=1e-3)


@pytest.mark.parametrize("cell,cls_bias", [
    (("LRTBHead", "Supervised Offset"), -4.3),
    (("PointSetHead", "Unsupervised Offset"), -4.5),
    (("AnchorHead", "Empty"), -5.1)], ids=lambda v: cell_id(v) if isinstance(v, tuple) else "")
def test_predict_matches_jax(cell, cls_bias):
    """A classifier whose scores fall on both sides of the 0.05 threshold:
    a few dozen detections an image, slot for slot."""
    det = jax_build_model(tiny_cfg(jax_get_cfg, *cell))
    variables = draw_variables(det, cell_seed(cell), cls_out=(0.15, cls_bias))
    batch = predict_batch(53)
    want = jax.jit(det.predict)(jax.tree_util.tree_map(jnp.asarray, variables),
                                jnp_batch(batch))
    want = {k: np.asarray(v) for k, v in want.items()}
    got = port_model(cell, variables).predict(batch)
    per_image = want["valid"].sum(1)
    assert (per_image >= 5).all() and (per_image < 100).all(), per_image
    assert_detections_equal(got, want)


# ------------------------------------------------------------- geometry
@pytest.mark.parametrize("hw", [(64, 96), (896, 1408)])
def test_point_grid_and_anchors_equal_jax_exactly(hw):
    """PointSet's grid (no half stride) and AnchorHead's 9 anchors a cell."""
    for head in ("PointSetHead", "AnchorHead"):
        det = jax_build_model(tiny_cfg(jax_get_cfg, head))
        model = torch_build_model(tiny_cfg(torch_get_cfg, head), device="cpu")
        if head == "PointSetHead":
            for got, want in zip(model._centers(hw), det._centers(hw)):
                np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
            assert model.point_strides == det.point_strides == [1.0, 2.0, 4.0, 8.0, 16.0]
        else:
            got, want = model.anchor_spec.anchors(hw), det.anchor_spec.anchors(hw)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1] == want[1] and model.num_anchors == det.num_anchors == 9
    if hw == (896, 1408):
        assert sum(want[1]) == 236313


def test_deform_convs_run_in_float32_whatever_the_compute_dtype(monkeypatch):
    """In a bfloat16 model the adapted convs sample and multiply float32
    features and cast their output back."""
    seen = []
    real = tabl.deform_sample_batched

    def watched(x, offsets, *args):
        seen.append((x.dtype, offsets.dtype))
        return real(x, offsets, *args)

    monkeypatch.setattr(tabl, "deform_sample_batched", watched)
    cfg = tiny_cfg(torch_get_cfg, "LRTBHead", "Split Unsup Offset",
                   **{"TPU.COMPUTE_DTYPE": "bfloat16"})
    model = torch_build_model(cfg, device="cpu")
    assert model.dtype == torch.bfloat16
    x = torch.randn(1, 256, 5, 7).to(torch.bfloat16)
    off = torch.randn(1, 5, 7, 18)
    with torch.no_grad():
        out = model.head.cls_conv(x, off)
        want = tabl.deform_apply(real(x.permute(0, 2, 3, 1).float(), off.reshape(1, 5, 7, 9, 2)
                                      + torch.as_tensor(tabl.kernel_base_offsets(3))),
                                 model.head.cls_conv.weight, model.head.cls_conv.bias)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (1, 256, 5, 7)
    torch.testing.assert_close(out, want.to(torch.bfloat16).permute(0, 3, 1, 2), rtol=0,
                               atol=0)
    seen.clear()
    with torch.no_grad():
        model(torch.zeros(1, 64, 96, 3, dtype=torch.uint8))
    assert len(seen) == 10 and set(seen) == {(torch.float32, torch.float32)}


# ------------------------------------------------------- registry, build
def test_registry_holds_twenty_three_names():
    assert {"AblationMetaArch", "FCOSTopK", "FCOSAnchor"} <= set(META_ARCHS)
    assert len(META_ARCHS) == 28


@pytest.mark.parametrize("yaml_name,head,adaption,anchors", [
    ("anchor_empty.yaml", "AnchorHead", "Empty", 9),
    ("lrtb_unsup.yaml", "LRTBHead", "Unsupervised Offset", 1),
    ("pointset_sup.yaml", "PointSetHead", "Supervised Offset", 1),
])
def test_ablation_yamls_build_at_full_width_on_the_cpu(yaml_name, head, adaption, anchors):
    """The yamls as written (anchor_empty's sizes come through a
    ``!!python/object/apply:eval`` tag), R-18 for speed: bf16, 80 classes,
    256-wide towers, 3 convs a tower."""
    cfg = torch_get_cfg()
    cfg.merge_from_file(str(YAMLS / yaml_name))
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(str(YAMLS / yaml_name))
    assert cfg.MODEL.ANCHOR_GENERATOR.SIZES == jcfg.MODEL.ANCHOR_GENERATOR.SIZES
    assert cfg.MODEL.META_ARCHITECTURE == "AblationMetaArch"
    cfg.MODEL.RESNETS.DEPTH = 18
    model = torch_build_model(cfg, device="cpu")
    assert (model.head_name, model.head.feat_adaption) == (head, adaption)
    assert model.dtype == torch.bfloat16 and model.num_anchors == anchors
    assert model.head.cls_out.out_channels == 80 * anchors
    assert model.head.cls_conv2.weight.shape == (256, 256, 3, 3)
    assert isinstance(model.head.cls_conv, tabl.MetaConv if adaption == "Empty"
                      else tabl.MetaDeformConv)
    assert float(model.head.cls_out.bias[0].detach()) == pytest.approx(-np.log(99.0))


@pytest.mark.parametrize("key", ["TPU.PACK_HEAD_LEVELS"])
def test_unported_options_raise(key):
    with pytest.raises(NotImplementedError, match=key.split(".")[-1]):
        torch_build_model(tiny_cfg(torch_get_cfg, **{key: True}), device="cpu")


# ---------------------------------------------------------- the entry point
NAME = "torch_ablation_synth"
TINY_MAIN = {
    "MODEL.RESNETS.DEPTH": 18, "TPU.COMPUTE_DTYPE": "float32",
    "MODEL.META_ARCH.NUM_CLASSES": 3, "TPU.MAX_GT_PER_IMAGE": 10,
    "INPUT.MIN_SIZE_TRAIN": (64,), "INPUT.MAX_SIZE_TRAIN": 128,
    "INPUT.MIN_SIZE_TEST": 64, "INPUT.MAX_SIZE_TEST": 128,
    "DATASETS.TRAIN": (NAME,), "DATASETS.TEST": (NAME,), "DATALOADER.NUM_WORKERS": 0,
    "SOLVER.IMS_PER_BATCH": 2, "SEED": 1, "SOLVER.BASE_LR": 0.01,
    "SOLVER.WARMUP_ITERS": 3, "SOLVER.CHECKPOINT_PERIOD": 100,
}


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_ablation")
    path, root = make_coco_json(tmp, num_images=6, img_hw=(64, 80))
    tcatalog.DatasetCatalog.remove(NAME)
    tcoco.register_coco_instances(NAME, path, root)
    return tmp


def cli_args(out, *flags, **overrides):
    opts = {**TINY_MAIN, "OUTPUT_DIR": str(out), **overrides}
    return train_net_torch.default_argument_parser().parse_args(
        ["--config-file", str(YAMLS / "pointset_sup.yaml"), *flags]
        + [str(x) for kv in opts.items() for x in kv])


def test_main_trains_resumes_bit_equal_and_evaluates(synth, monkeypatch):
    """PointSetHead x Supervised Offset through ``main``: 1 iteration and a
    checkpoint, ``--resume`` to 2, against a run that went 0 -> 2 on the
    same batches (the loader restarts from its seed on resume): model,
    momentum and iteration equal bit for bit; then ``--eval-only``."""
    k, n = 1, 2
    trainers = []
    real_train = ttrainer.BaseTrainer.train

    def recording_train(self):
        trainers.append(self)
        return real_train(self)

    monkeypatch.setattr(ttrainer.BaseTrainer, "train", recording_train)
    out = synth / "resumed"
    train_net_torch.main(cli_args(out, "--device", "cpu", **{"SOLVER.MAX_ITER": k,
                                                             "DATASETS.TEST": ()}))
    assert (out / f"model_{k:07d}.pth").exists()
    train_net_torch.main(cli_args(out, "--device", "cpu", "--resume",
                                  **{"SOLVER.MAX_ITER": n, "DATASETS.TEST": ()}))
    assert trainers[1].start_iter == k

    real_loader = ttrainer.build_detection_train_loader

    def restarting_loader(cfg, seed=0):
        def stream():
            head = iter(real_loader(cfg, seed=seed))
            for _ in range(k):
                yield next(head)
            yield from real_loader(cfg, seed=seed)
        return stream()

    monkeypatch.setattr(ttrainer, "build_detection_train_loader", restarting_loader)
    train_net_torch.main(cli_args(synth / "straight", "--device", "cpu",
                                  **{"SOLVER.MAX_ITER": n, "DATASETS.TEST": ()}))
    got, want = trainers[1].state(), trainers[2].state()
    assert got["iteration"] == want["iteration"] == n
    assert sorted(got["model"]) == sorted(want["model"])
    for key in got["model"]:
        assert torch.equal(got["model"][key], want["model"][key]), key
    for s_got, s_want in zip(got["optimizer"]["state"].values(),
                             want["optimizer"]["state"].values()):
        assert torch.equal(s_got["momentum_buffer"], s_want["momentum_buffer"])
    with open(out / "metrics.json") as f:
        logged = [json.loads(line) for line in f]
    assert "loss_loc_refine" in logged[0] and "loss_loc_init" in logged[0]

    monkeypatch.setattr(ttrainer, "build_detection_train_loader", real_loader)
    results = train_net_torch.main(cli_args(out, "--device", "cpu", "--resume", "--eval-only",
                                            **{"SOLVER.MAX_ITER": n}))
    assert set(STATS_NAMES) <= set(results[NAME]["bbox"]) and "AR@100" in results[NAME]["ar"]

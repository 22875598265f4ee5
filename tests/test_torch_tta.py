"""The port's test-time augmentation (``slenderobjdet_torch/engine/tta.py``)
held against the JAX package's ``tta_predict`` on the tiny FCOS of
``tests/conftest.py`` (R-18, float32, weights through the bridge):
``TEST.AUG.MIN_SIZES`` (48, 64) with ``FLIP``, four views an image, merged
by the host NMS. ``train_net_torch.main --eval-only`` with TTA is in
``tests/test_torch_trainer.py``."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slenderobjdet_torch.checkpoint.bridge import load_flax_variables
from slenderobjdet_torch.config import get_cfg as torch_get_cfg
from slenderobjdet_torch.engine import tta as ttta
from slenderobjdet_torch.models import build_model as torch_build_model
from slenderobjdet_tpu.config import get_cfg as jax_get_cfg
from slenderobjdet_tpu.engine import tta as jtta
from slenderobjdet_tpu.models import build_model as jax_build_model

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_serving import draw_variables  # noqa: E402

BOX_TOL = 1e-4      # merged boxes, original coordinates
SCORE_TOL = 1e-5    # merged scores: fp32 sums of different order
# the classifier's bias: ~20 candidates an image pass INFERENCE_TH (0.05)
# on the random R-18, so that the merge has work and scores are not tied
CLS_BIAS = -2.9


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread: the tier runs six workers on one CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cfg(get_cfg):
    cfg = get_cfg()
    cfg.MODEL.BACKBONE.NAME = "build_retinanet_resnet_fpn_backbone_use_p5"
    cfg.MODEL.RESNETS.DEPTH = 18
    cfg.MODEL.RESNETS.OUT_FEATURES = ["res3", "res4", "res5"]
    cfg.MODEL.FPN.IN_FEATURES = ["res3", "res4", "res5"]
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.APPROX_TOPK = False
    cfg.INPUT.MIN_SIZE_TEST = 64
    cfg.INPUT.MAX_SIZE_TEST = 64
    cfg.TEST.AUG.ENABLED = True
    cfg.TEST.AUG.MIN_SIZES = (48, 64)
    cfg.TEST.AUG.MAX_SIZE = 64
    cfg.TEST.AUG.FLIP = True
    cfg.freeze()
    return cfg


def dataset_dicts():
    """Inline uint8 images (no decoder), landscape, portrait and square."""
    rs = np.random.RandomState(5)
    return [{"image": rs.randint(0, 256, (h, w, 3)).astype(np.uint8), "image_id": i + 1,
             "height": h, "width": w, "annotations": []}
            for i, (h, w) in enumerate([(64, 64), (52, 64), (64, 44)])]


@pytest.fixture(scope="module")
def pair():
    det = jax_build_model(tiny_cfg(jax_get_cfg))
    variables = draw_variables(det)
    variables["params"]["head"]["cls_logits"]["bias"][:] = CLS_BIAS
    model = torch_build_model(tiny_cfg(torch_get_cfg), device="cpu")
    load_flax_variables(model, variables)
    return det, jax.tree_util.tree_map(jnp.asarray, variables), model


def assert_same_detections(got, want):
    """The same kept detections, each paired with one of the other's by
    class, score (SCORE_TOL) and box (BOX_TOL): the merge's order among
    scores within fp32 rounding of each other is either side's."""
    free = list(range(len(want["boxes"])))
    for c, s, b in zip(got["classes"], got["scores"], got["boxes"]):
        hit = [j for j in free if want["classes"][j] == c
               and abs(want["scores"][j] - s) <= SCORE_TOL
               and np.abs(want["boxes"][j] - b).max() <= BOX_TOL]
        assert hit, (c, s, b)
        free.remove(hit[0])


def test_tta_predict_matches_jax(pair):
    det, jv, model = pair
    jcfg, tcfg = tiny_cfg(jax_get_cfg), tiny_cfg(torch_get_cfg)
    jfns, tfns = {}, {}
    merged = 0
    for d in dataset_dicts():
        want = jtta.tta_predict(det, jv, dict(d), jcfg, predict_fns=jfns)
        got = ttta.tta_predict(model, dict(d), tcfg, predict_fns=tfns)
        assert len(got["boxes"]) == len(want["boxes"]) > 0
        assert_same_detections(got, want)
        merged += len(got["boxes"])
    # one predict a view key (short side, padded shape, flip), as JAX caches
    assert sorted(tfns) == sorted(jfns) and len(tfns) >= 4
    assert merged > 10


def test_nms_numpy_is_the_jax_merge():
    rs = np.random.RandomState(6)
    xy = rs.randint(0, 50, (60, 2))
    boxes = np.concatenate([xy, xy + rs.randint(4, 30, (60, 2))], 1).astype(np.float32)
    scores = rs.rand(60).astype(np.float32)
    classes = rs.randint(0, 3, 60)
    for thr, max_out in ((0.5, 100), (0.3, 7)):
        assert ttta._nms_numpy(boxes, scores, classes, thr, max_out) == \
            jtta._nms_numpy(boxes, scores, classes, thr, max_out)

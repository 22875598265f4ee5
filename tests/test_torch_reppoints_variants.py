"""The PyTorch port's point-set and DCN names beside ``RepPointsDetector``,
held against the JAX package on the CPU at the tiny size of
``tests/test_torch_reppoints.py``, whose helpers and shared parameter tree
(``rp_variables``) it uses:

- ``RepPointsCenterness`` (slender centerness off and on), ``RepPointsV2``,
  ``FCOSRepPoints`` and ``ReppointsRetinaNet``: each loss term within 1e-4
  and ``predict`` slot for slot; the slender centerness targets within
  1e-6;
- the registry's six names of deformable convolution and the point-set
  family: each builds on the CPU (and raises without a card unless asked
  for it), and the RepPoints YAMLs build at full width.

Every input comes from a numpy seed inside its test.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from slenderobjdet_torch.config import get_cfg as torch_get_cfg  # noqa: E402
from slenderobjdet_torch.models import META_ARCHS  # noqa: E402
from slenderobjdet_torch.models import build_model as torch_build_model  # noqa: E402
from slenderobjdet_torch.models.meta_arch import hybrids as thyb  # noqa: E402
from slenderobjdet_tpu.config import get_cfg as jax_get_cfg  # noqa: E402
from slenderobjdet_tpu.models import build_model as jax_build_model  # noqa: E402
from slenderobjdet_tpu.models.meta_arch import ablation as jabl  # noqa: E402
from test_torch_reppoints import (MODEL_LOSS_RTOL, RP_CONFIG, _predict_pair,  # noqa: E402,F401
                                  _randomize, assert_detections_equal, jnp_batch,
                                  port_model, rp_variables, tiny_cfg, train_batch,
                                  variables_for)
from torch_threads import default_torch_threads, one_torch_thread_module  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread_module")

NEW_NAMES = ["RepPointsDetector", "RepPointsCenterness", "RepPointsV2", "FCOSRepPoints",
             "ReppointsRetinaNet", "DeformableConvRetinaNet"]


@pytest.mark.parametrize("arch,over", [
    ("RepPointsCenterness", {}),
    ("RepPointsCenterness", {"MODEL.META_ARCH.SLENDER_CENTERNESS": True}),
    ("RepPointsV2", {}),
    ("FCOSRepPoints", {}),
], ids=["centerness", "slender_centerness", "v2", "fcos_reppoints"])
def test_variant_loss_matches_jax(arch, over, rp_variables):
    variables = variables_for(arch, rp_variables)
    det = jax_build_model(tiny_cfg(jax_get_cfg, arch, **over))
    batch = train_batch(39)
    total, metrics = jax.jit(det.loss)(jax.tree_util.tree_map(jnp.asarray, variables),
                                       jnp_batch(batch))
    want = {k: float(v) for k, v in metrics.items() if not k.startswith("_")}
    model = port_model(arch, variables, **over)
    got, got_metrics = model.loss(batch)
    assert sorted(got_metrics) == sorted(want)
    assert float(got.detach()) == pytest.approx(float(total), rel=MODEL_LOSS_RTOL)
    for k, v in want.items():
        assert float(got_metrics[k].detach()) == pytest.approx(v, rel=MODEL_LOSS_RTOL), k
    assert hasattr(model, "loss_normalizer") == (arch != "RepPointsV2")
    if arch == "RepPointsCenterness":
        assert model.slender_centerness == bool(over)
        assert want["centerness_loss"] > 0


@pytest.mark.parametrize("arch,cls_bias", [
    ("RepPointsCenterness", -4.0), ("RepPointsV2", -4.5), ("FCOSRepPoints", -4.5)])
def test_variant_predict_matches_jax(arch, cls_bias, rp_variables):
    """The centerness gate, log_sigmoid(ctr) near log(1/2), takes its
    classifier's bias half a unit higher for a few dozen detections."""
    variables = variables_for(arch, _randomize(rp_variables, seed=40, cls_std=0.15,
                                               cls_bias=cls_bias))
    got, want = _predict_pair(arch, variables, 41)
    assert 5 <= want["valid"].sum() < 200
    assert_detections_equal(got, want)


@pytest.fixture(scope="module")
def rpr_variables():
    det = jax_build_model(tiny_cfg(jax_get_cfg, "ReppointsRetinaNet"))
    return _randomize(det.init_variables(jax.random.PRNGKey(1)), seed=42)


def test_reppoints_retinanet_matches_jax(rpr_variables):
    """The RetinaNet-keyed point-set detector: its hard-wired 256-wide head,
    loss and predict."""
    det = jax_build_model(tiny_cfg(jax_get_cfg, "ReppointsRetinaNet"))
    batch = train_batch(43)
    jvars = jax.tree_util.tree_map(jnp.asarray, rpr_variables)
    total, metrics = jax.jit(det.loss)(jvars, jnp_batch(batch))
    model = port_model("ReppointsRetinaNet", rpr_variables)
    assert model.head.deform_cls_conv.weight.shape == (9, 256, 256)
    assert model.sample_mode == "points" and model.transform_method == "minmax"
    got, got_metrics = model.loss(batch)
    assert float(got.detach()) == pytest.approx(float(total), rel=MODEL_LOSS_RTOL)
    for k in ("loss_cls", "loss_localization_init", "loss_localization_refine", "num_pos"):
        assert float(got_metrics[k].detach()) == pytest.approx(float(metrics[k]),
                                                               rel=MODEL_LOSS_RTOL), k
    variables = _randomize(rpr_variables, seed=44, cls_std=0.15, cls_bias=-4.6)
    got, want = _predict_pair("ReppointsRetinaNet", variables, 45)
    assert want["valid"].sum() >= 5
    assert_detections_equal(got, want)


def test_slender_centerness_targets_match_jax():
    rs = np.random.RandomState(46)
    reg = rs.uniform(0.5, 60, (50, 4)).astype(np.float32)
    want = jabl.compute_slender_centerness_targets(jnp.asarray(reg))
    got = thyb.compute_slender_centerness_targets(torch.from_numpy(reg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


# ------------------------------------------------------- registry and build
def test_registry_holds_the_six_new_names():
    assert set(NEW_NAMES) <= set(META_ARCHS) and len(META_ARCHS) == 28


@pytest.mark.parametrize("arch", NEW_NAMES)
def test_each_new_name_builds_on_the_cpu(arch, monkeypatch):
    cfg = tiny_cfg(torch_get_cfg, arch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_build_model(cfg)
    model = torch_build_model(cfg, device="cpu")
    assert type(model).__name__ == arch
    assert all(p.device.type == "cpu" for p in model.parameters())
    if arch == "DeformableConvRetinaNet":
        assert float(model.head.cls_subnet0.offset_conv.weight.abs().max()) == 0.0
        assert float(model.head.cls_subnet0.weight.std()) == pytest.approx(0.01, rel=0.05)
        return
    assert float(model.head.logits_out.bias[0].detach()) == pytest.approx(-np.log(99.0))
    assert float(model.head.deform_cls_conv.weight.std()) == pytest.approx(0.01, rel=0.05)
    assert model.point_strides == ([8.0, 16.0, 32.0, 64.0, 128.0] if arch == "RepPointsV2"
                                   else [1.0, 2.0, 4.0, 8.0, 16.0])
    assert model.init_pos_num == (3 if arch == "FCOSRepPoints" else 1)


@pytest.mark.parametrize("yaml_name,arch", [
    ("rep_points_detector_R_50_FPN_1x.yaml", "RepPointsDetector"),
    ("rep_points_centerness_R_50_FPN_1x.yaml", "RepPointsCenterness"),
    ("reppointsv2_R_50_FPN_1x.yaml", "RepPointsV2"),
])
def test_reppoints_yamls_build_at_full_width_on_the_cpu(yaml_name, arch):
    cfg = torch_get_cfg()
    cfg.merge_from_file(str(RP_CONFIG.parent / yaml_name))
    assert cfg.MODEL.META_ARCHITECTURE == arch
    cfg.MODEL.RESNETS.DEPTH = 18
    model = torch_build_model(cfg, device="cpu")
    assert model.dtype == torch.bfloat16 and model.head.logits_out.out_channels == 80
    assert model.head.deform_reg_conv.weight.shape == (9, 256, 256)
    assert model.num_points == 9 and model.transform_method == "minmax"

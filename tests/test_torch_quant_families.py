"""The port's ``TPU.INT8_PREDICT`` on every family, port side only, on the
CPU: the eleven families of the JAX package's ``test_family_int8_predict``
predict at R-18 (the tiny Hourglass for CornerNet) with it, their outputs
differing from float where an R-18 conv is eligible and equal where none is;
all 28 names construct with it on. The parity with the JAX package is
``tests/test_torch_quant.py``."""

from pathlib import Path

import numpy as np
import pytest
import torch

from slenderobjdet_torch.config import get_cfg as torch_get_cfg
from slenderobjdet_torch.models import META_ARCHS
from slenderobjdet_torch.models import build_model as torch_build_model
from slenderobjdet_torch.models.layers import Conv2d
from slenderobjdet_torch.ops import quant as tq

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread: the tier runs six workers on one CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def predict_batch(seed=3, hw=(64, 64)):
    rs = np.random.RandomState(seed)
    return {"image": rs.randint(0, 256, (1, *hw, 3)).astype(np.uint8),
            "scale": np.ones(1, np.float32), "orig_size": np.array([hw], np.float32)}


FAMILIES = {
    "RetinaNet": ("retina/retinanet_R_50_FPN_1x.yaml", {}),
    "RepPointsDetector": ("rep-points/rep_points_detector_R_50_FPN_1x.yaml", {}),
    "RepPointsCenterness": ("rep-points/rep_points_centerness_R_50_FPN_1x.yaml", {}),
    "FCOSAnchor": ("fcos_anchor/fcos_anchor_R_50_FPN_1x.yaml",
                   {"MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS": [[0.5, 1.0, 2.0]]}),
    "RotatedRetinaNet": ("rotated/rotated_retinanet_R_50_FPN_1x.yaml",
                         {"MODEL.ANCHOR_GENERATOR.SIZES": [[32], [64], [128], [256], [512]],
                          "MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS": [[0.5, 1.0]],
                          "MODEL.ANCHOR_GENERATOR.ANGLES": [[-45, 0, 45]]}),
    "ProposalVisibleRCNN": ("faster/faster_rcnn_R_50_FPN_1x.yaml", {}),
    "ProposalNetworkWithMasks": ("fcos/fcos_R_50_FPN_1x.yaml",
                                 {"MODEL.RPN.IN_FEATURES": ["p3", "p4", "p5", "p6", "p7"]}),
    "CornerNet": ("corner/corner_net_hourglass.yaml", {}),
    "Ablation:LRTBHead": ("ablation_studies/lrtb_unsup.yaml", {}),
    "Ablation:PointSetHead": ("ablation_studies/pointset_sup.yaml", {}),
    "Ablation:AnchorHead": ("ablation_studies/anchor_empty.yaml", {}),
}
TINY_CORNER = {"MODEL.HOURGLASS.STACKS": 1, "MODEL.HOURGLASS.DEPTH_BLOCK": 3,
               "MODEL.HOURGLASS.CHANNELS_BLOCK": [64, 64, 96, 96],
               "MODEL.HOURGLASS.NUM_CONV_BLOCK": [1, 1, 1, 2],
               "MODEL.HOURGLASS.STEM_OUT_CHANNELS": 32,
               "MODEL.HOURGLASS.OUT_FEATURES": ["hourglass2"],
               "MODEL.CORNER_NET.IN_FEATURES": ["hourglass2"],
               "MODEL.CORNER_NET.NUM_CLASSES": 8, "TPU.COMPUTE_DTYPE": "float32"}


def family_cfg(arch, int8):
    yaml, overrides = FAMILIES[arch]
    cfg = torch_get_cfg()
    cfg.merge_from_file(str(CONFIGS / yaml))
    if arch == "CornerNet":
        opts = dict(TINY_CORNER)
    else:
        opts = {"MODEL.RESNETS.DEPTH": 18, "TPU.COMPUTE_DTYPE": "float32", **overrides}
        if arch.startswith("Ablation:"):
            opts.update({"MODEL.META_ARCH.NAME": arch.split(":")[1],
                         "MODEL.META_ARCH.FEAT_ADAPTION": "Empty",
                         "MODEL.META_ARCH.SCORE_THRESH_TEST": 0.0,
                         "MODEL.META_ARCH.PRE_NMS_THRESH": 0.0})
        else:
            opts["MODEL.META_ARCHITECTURE"] = arch
        if arch == "ProposalNetworkWithMasks":
            opts["NEED_MASKS"] = True
    opts["TPU.INT8_PREDICT"] = int8
    opts["TEST.DETECTIONS_PER_IMAGE"] = 20      # the plain NMS loops: a step a slot
    cfg.merge_from_list([x for kv in opts.items() for x in kv])
    cfg.freeze()
    return cfg


def _first_output(out):
    for key in ("scores", "proposal_scores", "boxes"):
        if key in out:
            return key, out[key].float()
    raise AssertionError(f"no comparable output in {sorted(out)}")


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_family_int8_predict(arch):
    """As JAX's test of the same name: predict runs under INT8_PREDICT with
    finite outputs, differing from fp where an R-18 conv is eligible and
    equal where none is (the tiny Hourglass)."""
    model_q = torch_build_model(family_cfg(arch, True), device="cpu")
    model_fp = torch_build_model(family_cfg(arch, False), device="cpu")
    model_fp.load_state_dict(model_q.state_dict())
    batch = predict_batch()
    out_q = model_q.predict(batch)
    for k, v in out_q.items():
        assert torch.isfinite(v.float()).all(), (arch, k)
    key, q = _first_output(out_q)
    fp = model_fp.predict(batch)[key].float()
    assert q.shape == fp.shape
    if arch == "CornerNet":
        assert torch.equal(q, fp)
    else:
        assert not torch.equal(q, fp)


NAME_YAMLS = {
    "FCOSAnchor": "fcos_anchor/fcos_anchor_R_50_FPN_1x.yaml",
    "RotatedRetinaNet": "rotated/rotated_retinanet_R_50_FPN_1x.yaml",
    "ReppointsRetinaNet": "group_exp_for_backbone/rep-points/base.yaml",
    "RepPointsCenterness": "rep-points/rep_points_centerness_R_50_FPN_1x.yaml",
    "RepPointsV2": "rep-points/reppointsv2_R_50_FPN_1x.yaml",
    "AblationMetaArch": "ablation_studies/lrtb_unsup.yaml",
}


def name_cfg(name):
    """Each registered name on its family's yaml at R-18, fp32,
    ``TPU.INT8_PREDICT`` on."""
    if name == "CornerNet":
        return family_cfg("CornerNet", True)
    yaml = NAME_YAMLS.get(name) or (
        "faster/faster_rcnn_R_50_FPN_1x.yaml" if "RCNN" in name
        else "rep-points/rep_points_detector_R_50_FPN_1x.yaml" if "RepPoints" in name
        else "retina/retinanet_R_50_FPN_1x.yaml" if "Retina" in name
        else "fcos/fcos_R_50_FPN_1x.yaml")
    opts = {"MODEL.META_ARCHITECTURE": name, "MODEL.RESNETS.DEPTH": 18,
            "TPU.COMPUTE_DTYPE": "float32", "TPU.INT8_PREDICT": True}
    if name.startswith("ProposalNetwork"):
        opts["MODEL.RPN.IN_FEATURES"] = ["p3", "p4", "p5", "p6", "p7"]
    cfg = torch_get_cfg()
    cfg.merge_from_file(str(CONFIGS / yaml))
    cfg.merge_from_list([x for kv in opts.items() for x in kv])
    cfg.freeze()
    return cfg


def test_every_name_builds_with_int8_predict():
    """All 28 names construct with ``TPU.INT8_PREDICT`` on (none raises; on
    the meta device, no weight drawn) and the detectors whose JAX predict
    opens the int8 scope carry it; the ``TPU.PACK_HEAD_LEVELS`` guard stays."""
    assert len(META_ARCHS) == 28
    scoped = 0
    for name in META_ARCHS:
        with torch.device("meta"):
            model = META_ARCHS[name](name_cfg(name))
        tq.name_sites(model)
        assert all(m.site for m in model.modules() if isinstance(m, Conv2d))
        scoped += getattr(model, "int8_predict", False) is True
    # ProposalNetwork's point-based generators (RepPointsGenerator,
    # PointsProposalGenerator) take no scope, as in JAX; with its default
    # generator name ProposalNetwork builds ProposalNetworkWithMasks
    assert scoped == 28
    cfg = name_cfg("FCOS").clone()
    cfg.defrost()
    cfg.TPU.PACK_HEAD_LEVELS = True
    with pytest.raises(NotImplementedError, match="PACK_HEAD_LEVELS"):
        torch_build_model(cfg, device="cpu")

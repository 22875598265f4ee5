"""RetinaNet on the port's PVTv2 trunk (``build_retinanet_pvtv2_fpn_backbone``,
PVT "tiny" depths) held against the JAX package on the CPU, in float32, by
the harness of ``tests/test_torch_pvt.py``: the narrow trunk's outputs and
gradients at 64 x 64 and 64 x 96, then the detector's head outputs, losses,
gradients (the depthwise ``dwconv`` included), predict slot for slot, one
``TrainStep`` at two weight decays, ``param_labels`` leaf for leaf and the
int8 sites."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_pvt import (PVT_CHECKED, PVT_FAMILIES, PVT_OVERRIDES, PVT_SITES,  # noqa: E402
                            WEIGHT_DECAYS, check_heads, check_int8_sites, check_labels,
                            check_loss_and_gradients, check_predict, check_train_step,
                            check_trunk, detector_case, one_torch_thread)  # noqa: F401


@pytest.mark.parametrize("hw", [(64, 64), (64, 96)])
def test_pvtv2_trunk_and_gradients_match_jax(hw):
    check_trunk(True, hw)


@pytest.fixture(scope="module")
def case():
    return detector_case({**PVT_FAMILIES["pvtv2"], **PVT_OVERRIDES}, seed=30)


def test_pvtv2_retinanet_heads_match_jax(case):
    check_heads(case)


def test_pvtv2_retinanet_loss_and_gradients_match_jax(case):
    check_loss_and_gradients(case, PVT_CHECKED + ["backbone.bottom_up.stage1_block0.dwconv.weight"])


def test_pvtv2_retinanet_predict_matches_jax(case):
    check_predict(case)


@pytest.mark.parametrize("wd", WEIGHT_DECAYS)
def test_pvtv2_retinanet_train_step_matches_jax(case, wd):
    check_train_step(case, wd)


def test_pvtv2_param_labels_equal_jax_leaf_for_leaf(case):
    check_labels(case)


def test_pvtv2_int8_sites_match_jax_site_by_site(case):
    check_int8_sites(case, PVT_SITES + ["bottom_up/stage1_block0/dwconv"])

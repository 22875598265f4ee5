"""The port's FCOS R-50-FPN at the loader's full size, held to the JAX
package's outputs on the CPU: ``configs/fcos/fcos_R_50_FPN_1x.yaml`` in fp32
with exact top-k, B = 1, the landscape bucket 896 x 1408 (an 800 x 1333
seeded image zero-padded), weights drawn in numpy from the manifest of
``tests/data/fcos_r50_full_size.npz``, which
``tools/make_torch_full_size_reference.py`` wrote from the JAX package's
``predict`` (the portrait bucket is in the file too; ``chip_smoke.py`` runs
both on the card). The rule and its tolerances, each beside the measured
port-to-JAX distance, are in ``slenderobjdet_torch/tools/full_size_check.py``.
This file imports no JAX: the JAX side is the committed file.
"""

import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from slenderobjdet_torch.checkpoint.bridge import (flax_to_state_dict,
                                                   variables_checksum)
from slenderobjdet_torch.tools import full_size_check as F

BUCKET = "landscape"
REFERENCE = Path(F.REFERENCE).resolve()


@pytest.fixture(scope="module")
def ref():
    return F.load_reference()


@pytest.fixture(scope="module")
def variables(ref):
    return F.reference_variables(ref)


@pytest.fixture(scope="module", params=[True, False], ids=["fused", "unfused"])
def outputs(request, ref, variables):
    """One predict call; fused: the stem's and the bottlenecks' plain
    versions, which the card's kernels are held to."""
    model = F.build_reference_model(ref, variables, device="cpu", fused=request.param)
    return F.run_bucket(model, F.bucket_batch(ref, BUCKET))


def test_reference_file_is_tracked_and_small():
    assert REFERENCE.stat().st_size <= 2 * 1024 * 1024
    root = REFERENCE.parents[2]
    listed = subprocess.run(["git", "ls-files", "--error-unmatch", str(REFERENCE)], cwd=root,
                            capture_output=True, text=True)
    if listed.returncode and "not a git repository" in listed.stderr:
        pytest.skip("no git checkout around the tests")
    assert listed.returncode == 0, listed.stderr


def test_manifest_weights_bridge_onto_every_port_tensor(ref, variables):
    model = F.build_reference_model(ref, variables, device="cpu")
    sd, own = flax_to_state_dict(variables), model.state_dict()
    assert sorted(sd) == sorted(own)
    assert all(tuple(sd[k].shape) == tuple(own[k].shape) for k in sd)
    assert all(torch.equal(sd[k], own[k]) for k in sd)
    assert sum(v.numel() for v in sd.values()) > 30_000_000     # R-50 + FPN + towers


def test_redraw_equals_the_file_checksum(ref, variables):
    assert variables_checksum(variables) == str(ref["checksum"])
    assert variables_checksum(F.reference_variables(ref)) == str(ref["checksum"])


def test_head_sample_matches_jax(ref, outputs):
    errs = F.head_errors(outputs["heads"], ref, BUCKET)
    assert len(errs) == 15
    assert max(errs.values()) <= F.HEAD_RTOL, sorted(errs.items(), key=lambda kv: -kv[1])[:3]


def test_detections_match_jax(ref, outputs):
    want = F.reference_dets(ref, BUCKET)
    m = F.match_detections(outputs["dets"], want)
    assert m["ok"], m
    assert m["valid"] == 100 and m["paired"] + m["cut_ties"] == 100, m
    np.testing.assert_array_equal(outputs["dets"]["valid"], want["valid"])

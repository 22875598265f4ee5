"""The port's rotated-box ops (``slenderobjdet_torch/ops/rotated.py``) held
against the JAX package's (``slenderobjdet_tpu/ops/rotated.py``) on the CPU:

- corners and the delta transform within 1e-6 (relative), the angle
  floor-modded as JAX's ``%`` does, negative angles included;
- the intersection area bit for bit on the same corners, and the IoU matrix
  within 1e-6, against the JAX functions compiled at XLA's backend
  optimisation level 0 (``jax_exact``), where every operation is rounded
  as the port and the CUDA kernel (``csrc/rotated.cu``) round it. At the
  default level XLA's CPU compiler contracts the shoelace's products into
  FMAs (measured: 125.0 against 124.99695 on one pair), which moves an IoU
  by up to ~2e-5 at coordinates below 100 (held to 3e-5 here) and by up to
  0.03 at the class offsets' coordinates (4096 x class: measured 0.5228
  against 0.4935). The plain IoU is the same bits whatever its chunking;
- ``rotated_nms`` keep lists exactly, on integer-pixel boxes with angles
  from a small set and tied scores, with the class and level offsets of
  the models; and the CUDA kernel's
  algorithm (sort the selectable candidates once by (score descending,
  index ascending), then walk them, each kept box clearing the live ones
  behind it) against the plain version.

Angles come from a set on which XLA's and torch's float32 ``sin`` and
``cos`` agree (they differ by an ulp at 25, 60, 85, 95 and 145 degrees).
Every input is made from a numpy seed inside its test; the kernels
themselves are held against these plain versions on the card
(``tests/test_torch_package.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slenderobjdet_torch.models.proposal_generator import rrpn as trrpn
from slenderobjdet_torch.ops import rotated as trot
from slenderobjdet_tpu.models.proposal_generator import rrpn as jrrpn
from slenderobjdet_tpu.ops import rotated as jrot

ANGLES = np.array([-135, -90, -45, -30, 0, 15, 30, 45, 90, 120, 135, 180], np.float32)
EAGER_TOL = 1e-6
JIT_TOL = 3e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for the module: under the tier's six
    workers on one shared CPU, eight threads a process make the port's many
    small operations (the plain clip, the NMS loop) wait on each other
    (``tests/test_torch_proposal.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_exact(fn, *args):
    """``fn`` jitted and compiled at XLA's backend optimisation level 0, on
    numpy arguments or trees of them (module docstring)."""
    args = jax.tree_util.tree_map(jnp.asarray, args)
    compiled = jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    return jax.tree_util.tree_map(np.asarray, compiled(*args))


def int_rboxes(rs, shape, span=100, lo=2, hi=40, angles=ANGLES):
    """Integer-pixel XYWHA boxes with angles from ``angles``."""
    return np.stack([rs.randint(0, span, shape), rs.randint(0, span, shape),
                     rs.randint(lo, hi, shape), rs.randint(lo, hi, shape),
                     rs.choice(angles, shape)], -1).astype(np.float32)


def test_corners_match_jax():
    rs = np.random.RandomState(0)
    boxes = np.concatenate([int_rboxes(rs, (200,), 900),
                            (rs.rand(200, 5) * [900, 900, 300, 300, 720] - [0, 0, 0, 0, 360])
                            .astype(np.float32)])
    want = np.asarray(jax.jit(jrot.rotated_to_corners)(jnp.asarray(boxes)))
    got = trot.rotated_to_corners(torch.from_numpy(boxes)).numpy()
    assert got.shape == want.shape == (400, 4, 2)
    np.testing.assert_allclose(got, want, rtol=EAGER_TOL, atol=EAGER_TOL * np.abs(want).max())


def test_intersection_area_bit_equal_to_jax():
    rs = np.random.RandomState(1)
    c1 = np.asarray(jrot.rotated_to_corners(jnp.asarray(int_rboxes(rs, (12,)))))
    c2 = np.asarray(jrot.rotated_to_corners(jnp.asarray(int_rboxes(rs, (40,)))))
    want = jax_exact(lambda a1, a2: jax.vmap(lambda a: jax.vmap(
        lambda b: jrot._pair_intersection_area(a, b))(a2))(a1), c1, c2)
    got = trot._pair_intersection_area(torch.from_numpy(c1.copy())[:, None],
                                       torch.from_numpy(c2.copy())[None]).numpy()
    assert (want > 0).sum() > 20
    np.testing.assert_array_equal(got, want)


def test_pairwise_iou_matches_jax():
    rs = np.random.RandomState(2)
    b1, b2 = int_rboxes(rs, (20,)), int_rboxes(rs, (60,))
    b1[:3] = b2[:3]                                     # identical pairs
    b1[3, 2:4] = 0                                      # a zero-area box
    got = trot.pairwise_rotated_iou(torch.from_numpy(b1), torch.from_numpy(b2)).numpy()
    eager = jax_exact(jrot.pairwise_rotated_iou, b1, b2)
    jitted = np.asarray(jax.jit(jrot.pairwise_rotated_iou)(jnp.asarray(b1), jnp.asarray(b2)))
    assert got.shape == (20, 60) and got.dtype == np.float32
    assert (eager > 0).sum() > 60 and (eager == 0).sum() > 100
    np.testing.assert_allclose(got, eager, rtol=0, atol=EAGER_TOL)
    np.testing.assert_allclose(got, jitted, rtol=0, atol=JIT_TOL)
    np.testing.assert_allclose(np.diag(got[:3, :3]), 1.0, atol=1e-6)
    assert (got[3] == 0).all()


def test_plain_iou_is_the_same_bits_in_any_chunking():
    rs = np.random.RandomState(3)
    b1 = torch.from_numpy(int_rboxes(rs, (30,)))
    b2 = torch.from_numpy(int_rboxes(rs, (70,)))
    whole = trot.plain_pairwise_rotated_iou(b1, b2)
    for chunk in (1, 69, 500):
        assert torch.equal(trot.plain_pairwise_rotated_iou(b1, b2, chunk=chunk), whole)
    assert torch.equal(trot.plain_pairwise_rotated_iou(b1, b2[:0]), torch.zeros(30, 0))


@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0, 1.0, 1.0), (10.0, 5.0, 5.0, 5.0, 1.0)])
def test_rotated_deltas_match_jax(weights):
    rs = np.random.RandomState(4)
    src = (rs.rand(300, 5) * [200, 200, 80, 80, 720] + [0, 0, 1, 1, -360]).astype(np.float32)
    tgt = (rs.rand(300, 5) * [200, 200, 80, 80, 720] + [0, 0, 1, 1, -360]).astype(np.float32)
    src[:3, 2:4] = 0                                    # the 1e-7 floor
    want = np.asarray(jrot.get_rotated_deltas(jnp.asarray(src), jnp.asarray(tgt), weights))
    got = trot.get_rotated_deltas(torch.from_numpy(src), torch.from_numpy(tgt), weights).numpy()
    np.testing.assert_allclose(got, want, rtol=EAGER_TOL, atol=EAGER_TOL * 10)
    assert (np.abs(got[:, 4]) <= np.pi * weights[4] + 1e-6).all()
    deltas = (rs.randn(300, 5) * [1, 1, 3, 3, 4]).astype(np.float32)   # dw, dh past the clamp
    want = np.asarray(jrot.apply_rotated_deltas(jnp.asarray(deltas), jnp.asarray(src), weights))
    got = trot.apply_rotated_deltas(torch.from_numpy(deltas), torch.from_numpy(src),
                                    weights).numpy()
    np.testing.assert_allclose(got, want, rtol=EAGER_TOL, atol=EAGER_TOL * 10)
    assert (got[:, 4] >= -180).all() and (got[:, 4] < 180).all()


def test_clip_and_offsets_match_jax():
    """detectron2's rotated clip (only boxes within 1 degree of horizontal,
    angles from -400 to 400) and the class offset ``c * 4096`` of the
    models, bit for bit."""
    rs = np.random.RandomState(5)
    boxes = int_rboxes(rs, (2, 300), span=140, hi=90,
                       angles=np.array([-360.5, -180, -1, -0.5, 0, 0.5, 1, 1.5, 30, 359.5,
                                        400], np.float32))
    hw = np.array([[100.0, 120.0], [90.0, 64.0]], np.float32)
    want = np.asarray(jax.vmap(lambda b, s: jrrpn.clip_rotated_boxes(b, s[0], s[1]))(
        jnp.asarray(boxes), jnp.asarray(hw)))
    got = trrpn.clip_rotated_boxes(torch.from_numpy(boxes), torch.from_numpy(hw[:, 0:1]),
                                   torch.from_numpy(hw[:, 1:2])).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[..., 2] != boxes[..., 2]).any()
    classes = rs.randint(0, 80, (2, 300)).astype(np.int32)
    off = classes.astype(np.float32) * np.float32(4096.0)
    want = boxes.copy()
    want[..., 0] += off
    want[..., 1] += off
    got = trot.offset_boxes(torch.from_numpy(boxes), torch.from_numpy(classes)).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------- NMS
def nms_case(seed, batch, n, span, steps, classes=0):
    rs = np.random.RandomState(seed)
    boxes = int_rboxes(rs, (batch, n), span=span, lo=4, hi=60)
    scores = (np.floor(rs.rand(batch, n) * steps) / steps).astype(np.float32)
    valid = rs.rand(batch, n) < 0.9
    if classes:
        groups = rs.randint(0, classes, (batch, n)).astype(np.int32)
        boxes = trot.offset_boxes(torch.from_numpy(boxes), torch.from_numpy(groups)).numpy()
    return boxes, scores, valid


def jax_nms(boxes, scores, valid, thr, max_out):
    out = jax_exact(jax.vmap(lambda b, s, v: jnp.stack(jrot.rotated_nms(
        b, s, thr, max_out, valid=v))), boxes, scores, valid)
    return out[:, 0], out[:, 1].astype(bool)


@pytest.mark.parametrize("n,max_out,thr,span,steps,classes", [
    (120, 40, 0.3, 60, 8, 0),         # dense, ties, the slots run out
    (600, 100, 0.5, 100, 16, 80),     # RotatedRetinaNet: 80 classes 4096 apart
    (500, 200, 0.7, 140, 64, 5),      # RRPN: levels 4096 apart, more slots than kept
])
def test_rotated_nms_equals_jax_exactly(n, max_out, thr, span, steps, classes):
    boxes, scores, valid = nms_case(n + max_out, 2, n, span, steps, classes)
    want_idx, want_valid = jax_nms(boxes, scores, valid, thr, max_out)
    got_idx, got_valid = trot.rotated_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                                          thr, max_out, valid=torch.from_numpy(valid))
    assert got_idx.dtype == torch.int32 and got_valid.dtype == torch.bool
    np.testing.assert_array_equal(got_valid.numpy(), want_valid)
    np.testing.assert_array_equal(got_idx.numpy(), want_idx)
    kept = want_valid.sum(1)
    assert (kept > 10).all() and (kept < n * 0.9).all()


def sorted_sweep_model(boxes, scores, thr, max_out, valid):
    """The CUDA kernel's algorithm on CPU tensors: the selectable candidates
    (valid, score > NEG_INF / 2) sorted once by (score descending, index
    ascending); walking them, each live one is kept and clears the live
    ones behind it whose IoU with it exceeds the threshold (its polygon
    clipped by theirs)."""
    bsz, n = scores.shape
    keep_idx = torch.zeros((bsz, max_out), dtype=torch.int32)
    keep_valid = torch.zeros((bsz, max_out), dtype=torch.bool)
    corners = trot.rotated_to_corners(boxes)
    areas = boxes[..., 2] * boxes[..., 3]
    for b in range(bsz):
        sel = (valid[b] & (scores[b] > trot.NEG_INF / 2)).nonzero()[:, 0]
        order = sorted(sel.tolist(), key=lambda i: (-float(scores[b, i]), i))
        order = torch.tensor(order, dtype=torch.long)
        live = torch.ones(len(order), dtype=torch.bool)
        cnt = 0
        for p in range(len(order)):
            if not live[p]:
                continue
            i = order[p]
            keep_idx[b, cnt], keep_valid[b, cnt] = int(i), True
            cnt += 1
            if cnt == max_out:
                break
            rest = order[p + 1:]
            inter = trot._pair_intersection_area(corners[b, i][None], corners[b, rest])
            iou = inter / torch.clamp(areas[b, i] + areas[b, rest] - inter, min=1e-12)
            live[p + 1:] &= ~(iou > thr)
    return keep_idx, keep_valid


@pytest.mark.parametrize("seed,max_out", [(30, 25), (31, 150)])
def test_kernel_algorithm_equals_the_plain_nms(seed, max_out):
    boxes, scores, valid = nms_case(seed, 2, 160, 70, 12, classes=2)
    args = (torch.from_numpy(boxes), torch.from_numpy(scores))
    want = trot.plain_rotated_nms(*args, 0.4, max_out, valid=torch.from_numpy(valid))
    got = sorted_sweep_model(*args, 0.4, max_out, torch.from_numpy(valid))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(want[1].sum()) > 20


def test_kernel_wrappers_refuse_cpu_tensors():
    boxes = torch.zeros(1, 4, 5)
    with pytest.raises(ValueError, match="CUDA"):
        trot.launch_rotated_iou(boxes[0], boxes[0])
    with pytest.raises(ValueError, match="CUDA"):
        trot.launch_rotated_nms(boxes, torch.zeros(1, 4), 0.5, 2)

"""The CUDA NMS kernel's algorithm, in its plain PyTorch model
(``slenderobjdet_torch/ops/nms.py``: ``ordered_key``, ``iou_exceeds``,
``grouped_nms_model``), held against the JAX package on the CPU. Tolerance:
none. Indices and validity are equal, the three-way IoU test equals the
rounded division for every input tried, and the key's order is the order of
(score descending, index ascending)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from slenderobjdet_torch.ops import nms as t_nms
from slenderobjdet_tpu.ops import nms as j_nms
from slenderobjdet_tpu.ops.pallas_nms import pallas_batched_nms, pallas_nms

# name: (N, max_out, boxes' span, score kind, share of valid or None)
CASES = {
    "ties": (300, 100, 60, "sixteenths", 0.8),
    "ties_no_valid": (300, 100, 60, "sixteenths", None),
    "all_invalid": (37, 10, 40, "uniform", 0.0),
    "one_valid": (37, 10, 40, "uniform", "one"),
    "n1": (1, 5, 40, "uniform", None),
    "n37": (37, 100, 40, "uniform", 0.7),
    "n300": (300, 100, 120, "uniform", 0.9),
    "n300_crowded": (300, 100, 24, "uniform", None),
    "ends_inside_a_group": (300, 7, 200, "uniform", None),
    "max_out_above_n": (37, 64, 300, "uniform", None),
    "negative_and_zero": (300, 100, 60, "signed", 0.8),
    "all_one_score": (70, 40, 50, "constant", None),
}


def _case(name, seed=0):
    n, max_out, span, kind, share = CASES[name]
    rs = np.random.RandomState(seed + n + max_out)
    bsz = 2
    xy = rs.randint(0, span, (bsz, n, 2))
    wh = rs.randint(4, 40, (bsz, n, 2))
    boxes = np.concatenate([xy, xy + wh], 2).astype(np.float32)   # integer pixels
    if kind == "sixteenths":
        scores = rs.randint(0, 17, (bsz, n)).astype(np.float32) / 16
    elif kind == "signed":
        scores = (rs.randint(-8, 9, (bsz, n)).astype(np.float32) / 8
                  * rs.choice([1.0, 0.0, -0.0, 2.0 ** -100], (bsz, n)).astype(np.float32))
    elif kind == "constant":
        scores = np.full((bsz, n), 0.25, np.float32)
    else:
        scores = rs.permutation(bsz * n).reshape(bsz, n).astype(np.float32) / (bsz * n)
    if share is None:
        valid = None
    elif share == "one":
        valid = np.zeros((bsz, n), bool)
        valid[np.arange(bsz), rs.randint(0, n, bsz)] = True
    else:
        valid = rs.rand(bsz, n) < share
    classes = rs.randint(0, 3, (bsz, n)).astype(np.int32)
    return boxes, scores, classes, valid, max_out


@pytest.mark.parametrize("with_classes", [False, True], ids=["plain", "classes"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_grouped_model_matches_jax(name, with_classes):
    """The grouped resolution over sorted candidates gives the JAX scan's and
    the Pallas kernel's (interpret mode) indices and validity, and the port's
    wrappers on CPU tensors give the same."""
    boxes, scores, classes, valid, max_out = _case(name)
    thr = 0.5
    tb, ts, tc = (torch.from_numpy(a) for a in (boxes, scores, classes))
    tv = None if valid is None else torch.from_numpy(valid)
    gi, gv, rounds = t_nms.grouped_nms_model(tb, ts, thr, max_out, valid=tv,
                                             idxs=tc if with_classes else None)
    assert gi.dtype == torch.int32 and gv.dtype == torch.bool
    for b in range(boxes.shape[0]):
        jv = None if valid is None else jnp.asarray(valid[b])
        jb, js, jc = (jnp.asarray(a[b]) for a in (boxes, scores, classes))
        jvb = None if valid is None else jnp.asarray(valid[b:b + 1])
        if with_classes:
            ri, rv = j_nms.batched_nms(jb, js, jc, thr, max_out, valid=jv)
            pi, pv = pallas_batched_nms(jb[None], js[None], jc[None], thr, max_out,
                                        valid=jvb, interpret=True)
        else:
            ri, rv = j_nms.nms_select(jb, js, thr, max_out, valid=jv)
            pi, pv = pallas_nms(jb[None], js[None], thr, max_out, valid=jvb,
                                interpret=True)
        np.testing.assert_array_equal(gi[b].numpy(), np.asarray(ri))
        np.testing.assert_array_equal(gv[b].numpy(), np.asarray(rv))
        np.testing.assert_array_equal(gi[b].numpy(), np.asarray(pi[0]))
        np.testing.assert_array_equal(gv[b].numpy(), np.asarray(pv[0]))
        kept = int(gv[b].sum())
        # a round resolves up to 32 candidates and keeps at least one
        assert -(-kept // t_nms.GROUP) <= int(rounds[b]) <= max(kept, 1)
    if with_classes:
        wi, wv = t_nms.cuda_batched_nms(tb, ts, tc, thr, max_out, valid=tv)
    else:
        wi, wv = t_nms.cuda_nms(tb, ts, thr, max_out, valid=tv)
    assert torch.equal(wi, gi) and torch.equal(wv, gv)
    if name == "all_invalid":
        assert not gv.any() and not gi.any() and not rounds.any()
    if name == "one_valid":
        assert gv.sum(1).tolist() == [1, 1]
    if name in ("ends_inside_a_group", "n1"):
        assert bool(gv.all()) == (name == "ends_inside_a_group")


def test_grouped_model_takes_few_rounds():
    """Sparse boxes: a hundred detections take about four rounds, not a
    hundred."""
    rs = np.random.RandomState(3)
    xy = rs.randint(0, 2000, (1, 600, 2))
    boxes = torch.from_numpy(np.concatenate([xy, xy + 10], 2).astype(np.float32))
    scores = torch.from_numpy(rs.permutation(600).astype(np.float32)[None] / 600)
    gi, gv, rounds = t_nms.grouped_nms_model(boxes, scores, 0.6, 100)
    ri, rv = t_nms.nms_select(boxes, scores, 0.6, 100)
    assert torch.equal(gi, ri) and torch.equal(gv, rv) and bool(gv.all())
    assert int(rounds[0]) <= 5


@pytest.mark.parametrize("window,ahead", [(32, 8), (64, 64), (96, 1), (1024, 256)])
@pytest.mark.parametrize("name", ["n300_crowded", "ties", "n300"])
def test_grouped_model_window_sizes(name, window, ahead):
    """The swept window reopened many times (small windows), with boxes kept
    before a candidate's window opened: still the plain version's result."""
    boxes, scores, classes, valid, max_out = _case(name, seed=1)
    tb, ts, tc = (torch.from_numpy(a) for a in (boxes, scores, classes))
    tv = None if valid is None else torch.from_numpy(valid)
    gi, gv, _ = t_nms.grouped_nms_model(tb, ts, 0.5, max_out, valid=tv, idxs=tc,
                                        window=window, ahead=ahead)
    ri, rv = t_nms.batched_nms(tb, ts, tc, 0.5, max_out, valid=tv)
    assert torch.equal(gi, ri) and torch.equal(gv, rv)


def _ulp_neighbours(centre, ulps):
    """float32 values `ulps` steps either side of `centre` (positive)."""
    bits = centre.view(np.int32)[:, None] + np.arange(-ulps, ulps + 1, dtype=np.int32)
    return bits.view(np.float32)


@pytest.mark.parametrize("thr", [0.5, 0.6])
@pytest.mark.parametrize("scale", [1.0, 1e4, 1e-6], ids=["unit", "areas", "tiny"])
def test_three_way_test_equals_division_near_threshold(thr, scale):
    """Every float32 inter within 64 ulps either side of thr * uni: the
    three-way decision equals the rounded division's, and outside 40 ulps
    no division is needed."""
    rs = np.random.RandomState(int(thr * 10))
    uni = (rs.uniform(1.0, 4.0, 3000) * scale).astype(np.float32)
    centre = (np.float32(thr) * uni).astype(np.float32)
    inter = _ulp_neighbours(centre, 64)
    uni2 = np.broadcast_to(uni[:, None], inter.shape)
    got, divided = t_nms.iou_exceeds(torch.from_numpy(inter.copy()),
                                     torch.from_numpy(uni2.copy()), thr,
                                     return_divided=True)
    want = (inter / uni2) > np.float32(thr)
    assert want.dtype == bool and (inter / uni2).dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()
    steps = np.abs(np.arange(-64, 65))[None, :]
    assert not divided.numpy()[np.broadcast_to(steps > 40, inter.shape)].any()
    assert divided.numpy()[:, 64].all()


@pytest.mark.parametrize("thr", [0.5, 0.6, 0.0, -1.0, 1.0])
def test_three_way_test_on_integer_pixel_ious(thr):
    """Intersections and unions of integer-pixel boxes, where exact ties with
    the threshold occur (inter 3, uni 6 at thr 0.5), zero intersections, the
    1e-12 floor, and values outside the band's range."""
    inter = np.arange(0, 60, dtype=np.float32)[:, None]
    uni = np.arange(1, 121, dtype=np.float32)[None, :]
    inter, uni = (np.ascontiguousarray(np.broadcast_to(a, (60, 120))) for a in (inter, uni))
    extra_i = np.array([0.0, 0.0, 1e-38, 1e35, 3e-13, 1e-40], np.float32)
    extra_u = np.array([1e-12, 1e38, 1e-12, 1e36, 5e-13, 1e-12], np.float32)
    for i, u in ((inter, uni), (extra_i, extra_u)):
        got = t_nms.iou_exceeds(torch.from_numpy(i), torch.from_numpy(u), thr)
        np.testing.assert_array_equal(got.numpy(), (i / u) > np.float32(thr))


@settings(max_examples=300, deadline=None, database=None)
@given(st.floats(min_value=2.0 ** -10, max_value=2.0 ** 23, width=32),
       st.floats(min_value=0.0, max_value=1.5, width=32),
       st.sampled_from([0.5, 0.6, 0.05, 0.95]),
       st.integers(min_value=-40, max_value=40))
def test_three_way_test_equals_division_on_drawn_pairs(uni, share, thr, ulps):
    """hypothesis-drawn (inter, uni) pairs, and for each the float32 value
    `ulps` steps from thr * uni."""
    uni = np.array([uni, uni], np.float32)
    near = (np.float32(thr) * uni[:1]).view(np.int32) + np.int32(ulps)
    inter = np.array([np.float32(share) * uni[0], near.view(np.float32)[0]], np.float32)
    got = t_nms.iou_exceeds(torch.from_numpy(inter), torch.from_numpy(uni), thr)
    np.testing.assert_array_equal(got.numpy(), (inter / uni) > np.float32(thr))


@pytest.mark.parametrize("with_valid", [False, True])
def test_ordered_key_sorts_as_score_then_index(with_valid):
    """Negative, zero (both signs), subnormal, tied and -1e10 scores:
    descending key order is (score descending, index ascending) over the
    selectable candidates; the others share the least key."""
    rs = np.random.RandomState(5)
    special = np.array([0.0, -0.0, 1e-40, -1e-40, 1e-45, -1e-45, 1.0, -1.0, 0.5, 0.5,
                        -1e10, -5e9, -4.9e9, 3e38, -3e38, 1.17549435e-38], np.float32)
    scores = np.concatenate([special, rs.randn(200).astype(np.float32),
                             rs.randint(-3, 4, 200).astype(np.float32) / 4, special])
    valid = rs.rand(scores.size) > 0.3 if with_valid else np.ones(scores.size, bool)
    key = t_nms.ordered_key(torch.from_numpy(scores),
                            torch.from_numpy(valid) if with_valid else None).numpy()
    selectable = valid & (scores > np.float32(-5e9))
    assert (key[~selectable] == np.iinfo(np.int64).min).all()
    assert (key[selectable] > np.iinfo(np.int64).min).all()
    assert len(set(key[selectable].tolist())) == int(selectable.sum())
    got = np.array(sorted(np.flatnonzero(selectable), key=lambda i: -int(key[i])))
    index = np.flatnonzero(selectable)
    # (-score, index) lexicographic; -0.0 == 0.0 to numpy's comparison too
    want = index[np.lexsort((index, -scores[index].astype(np.float64)))]
    np.testing.assert_array_equal(got, want)
    # and it is the order in which a repeated argmax (first maximal index)
    # visits them; numpy's, because XLA on the CPU flushes subnormals to zero
    live = np.where(selectable, scores, np.float32(-1e10))
    for i in want[:40]:
        assert int(np.argmax(live)) == i
        live[i] = np.float32(-1e10)


def test_model_matches_jax_vmapped_batch():
    """Class-aware, the offset per image (images of different extents), the
    whole batch against the vmapped JAX ``batched_nms``."""
    rs = np.random.RandomState(11)
    bsz, n, max_out = 3, 200, 50
    xy = rs.randint(0, 50, (bsz, n, 2))
    boxes = np.concatenate([xy, xy + rs.randint(5, 40, (bsz, n, 2))], 2).astype(np.float32)
    boxes[1] *= 4
    scores = rs.randint(0, 33, (bsz, n)).astype(np.float32) / 32
    classes = rs.randint(0, 4, (bsz, n)).astype(np.int64)
    valid = rs.rand(bsz, n) > 0.2
    gi, gv, _ = t_nms.grouped_nms_model(
        torch.from_numpy(boxes), torch.from_numpy(scores), 0.6, max_out,
        valid=torch.from_numpy(valid), idxs=torch.from_numpy(classes))
    want_i, want_v = jax.vmap(
        lambda bx, sc, cl, vl: j_nms.batched_nms(bx, sc, cl, 0.6, max_out, valid=vl)
    )(*(jnp.asarray(a) for a in (boxes, scores, classes.astype(np.int32), valid)))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(want_v))

"""The rules the rotated kernels (``slenderobjdet_torch/ops/csrc/rotated.cu``)
follow, held on the CPU against the plain versions of
``slenderobjdet_torch/ops/rotated.py``:

- ``extents_apart`` (and ``is_point``, a padded row's rule): on 2e5 pairs placed within a few margins of touching
  (one box moved along a random direction until the gap between the two
  extents is -4 to 4 margins), at the models' angles and at regressed ones,
  at coordinates 0-1408 plus the class and level offsets (4096 x group, up
  to 80), every pair the rule calls apart has a plain intersection of
  exactly +0, and pairs it does not call apart do overlap;
- the NMS kernels' algorithm (the selectable candidates sorted once by
  (score descending, index ascending), a suppression bit for each later
  candidate with the plain roles, the earlier box's polygon clipped by the
  later one's box, computed only where ``extents_apart`` does not hold, and
  a walk of the sorted order one 64-position word at a time) against
  ``plain_rotated_nms``, keep list for keep list.

Every input comes from a numpy generator seeded in its test; no JAX here.
The kernels themselves are held against the plain versions on the card
(``tests/test_torch_package.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from slenderobjdet_torch.ops import rotated as rot

MODEL_ANGLES = np.array([-90, -60, -45, -30, -15, 0, 15, 30, 45, 60, 90, 120], np.float32)
WORD = 64


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread: the tier runs six workers on one CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def corners_of(boxes):
    return rot.rotated_to_corners(torch.from_numpy(boxes))


def near_pairs(rs, n):
    """``n`` pairs of boxes whose extents are within -4 to 4 margins of
    touching: box 2 moved from box 1's centre along a random direction. Half
    the angles are the models' (anchors and ground truth), half regressed
    ones; both boxes of a pair share a group offset 4096 x (0..80)."""
    def draw():
        angles = np.where(rs.rand(n) < 0.5, rs.choice(MODEL_ANGLES, n),
                          rs.uniform(-180, 180, n))
        return rs.uniform(2, 600, n), rs.uniform(2, 600, n), angles

    group = rs.randint(0, 81, n).astype(np.float32) * 4096.0
    cx, cy = group + rs.uniform(0, 1408, n), group + rs.uniform(0, 1408, n)
    w1, h1, a1 = draw()
    w2, h2, a2 = draw()
    b1 = np.stack([cx, cy, w1, h1, a1], -1).astype(np.float32)
    b2 = np.stack([cx, cy, w2, h2, a2], -1).astype(np.float32)
    e1, e2 = (rot.box_extents(corners_of(b))[0].double().numpy() for b in (b1, b2))
    half = lambda e: np.stack([(e[:, 1] - e[:, 0]) / 2, (e[:, 3] - e[:, 2]) / 2], -1)
    span = half(e1) + half(e2)                                          # (n, 2)
    margin = rot.MARGIN_SCALE * np.maximum(np.abs(e1).max(1), np.abs(e2).max(1))
    gap = rs.uniform(-4, 4, n) * margin
    theta = rs.uniform(0, 2 * np.pi, n)
    u = np.stack([np.cos(theta), np.sin(theta)], -1)
    with np.errstate(divide="ignore"):
        dist = np.min((span + gap[:, None]) / np.abs(u), axis=1)
    b2[:, 0] = (cx + dist * u[:, 0]).astype(np.float32)
    b2[:, 1] = (cy + dist * u[:, 1]).astype(np.float32)
    return b1, b2, gap / margin


@pytest.mark.parametrize("seed", [0, 1])
def test_extents_apart_implies_zero_plain_intersection(seed):
    rs = np.random.RandomState(1600 + seed)
    b1, b2, gaps = near_pairs(rs, 100_000)
    c1, c2 = corners_of(b1), corners_of(b2)
    apart = rot.extents_apart(c1, c2)
    assert apart.shape == (100_000,)
    # the rule fires on about half the pairs, close calls included, and,
    # for regular boxes, exactly where the largest gap between the extents
    # exceeds 2^-17 of the largest |coordinate| (in float64, 1% away)
    assert 0.3 < float(apart.float().mean()) < 0.7
    assert int((apart & torch.from_numpy(gaps < 1.5)).sum()) > 1000
    (e1, s1), (e2, s2) = rot.box_extents(c1), rot.box_extents(c2)
    e1, e2 = e1.double(), e2.double()
    gap = torch.stack([e2[:, 0] - e1[:, 1], e1[:, 0] - e2[:, 1], e2[:, 2] - e1[:, 3],
                       e1[:, 2] - e2[:, 3]], -1).amax(-1)
    ratio = gap / (2.0 ** -17 * torch.maximum(e1.abs().amax(-1), e2.abs().amax(-1)))
    clear = torch.isfinite(torch.maximum(s1, s2)) & ((ratio - 1).abs() > 0.01)
    assert int(clear.sum()) > 90_000
    assert torch.equal(apart[clear], (ratio > 1)[clear])
    area = rot._pair_intersection_area(c1[apart], c2[apart])
    assert bool(torch.all(area == 0)) and not bool(torch.signbit(area).any())
    # not apart, and near: the boxes of many such pairs overlap
    near = ~apart & torch.from_numpy(gaps > -4)
    area = rot._pair_intersection_area(c1[near], c2[near])
    assert int((area > 0).sum()) > 1000


def test_extents_apart_never_skips_irregular_boxes():
    """Zero, degenerate, clockwise and non-finite boxes have scale +inf, so
    no pair with one of them is apart, however far; regular ones far apart
    are."""
    far = np.array([[5000.0, 5000.0, 10.0, 10.0, 30.0]], np.float32)
    odd = np.array([[0.0, 0.0, 0.0, 0.0, 0.0],         # padded ground truth
                    [9.0, 9.0, 1e-4, 20.0, 0.0],      # a side below 2^-16 M
                    [9.0, 9.0, -10.0, 20.0, 0.0],     # clockwise
                    [9.0, np.nan, 10.0, 20.0, 0.0],
                    [9.0, np.inf, 10.0, 20.0, 0.0]], np.float32)
    c_far, c_odd = corners_of(far), corners_of(odd)
    assert not bool(rot.extents_apart(c_odd, c_far).any())
    assert not bool(rot.extents_apart(c_far, c_odd).any())
    assert bool(rot.extents_apart(corners_of(odd[1:2] * [1, 1, 1e5, 1, 1]), c_far).all())


def test_point_polygons_clip_to_zero():
    """A polygon whose four corners are one point (``is_point``: a padded
    row of zeros, or a box of zero sides) clipped by any box, around it or
    not, has an intersection of exactly +0; a box of one zero side is no
    point."""
    rs = np.random.RandomState(1602)
    boxes = np.stack([rs.uniform(-50, 50, 2000), rs.uniform(-50, 50, 2000),
                      rs.uniform(1, 200, 2000), rs.uniform(1, 200, 2000),
                      rs.uniform(-180, 180, 2000)], -1).astype(np.float32)
    points = np.zeros((2000, 5), np.float32)
    points[1000:, :2] = rs.uniform(-50, 50, (1000, 2))
    points[1000:, 4] = rs.choice(MODEL_ANGLES, 1000)
    c_pts, c_box = corners_of(points), corners_of(boxes)
    assert bool(rot.is_point(c_pts).all()) and not bool(rot.is_point(c_box).any())
    line = points.copy()
    line[:, 2] = 5.0
    assert not bool(rot.is_point(corners_of(line)).any())
    area = rot._pair_intersection_area(c_pts, c_box)
    assert bool((area == 0).all()) and not bool(torch.signbit(area).any())


def bits_walk_nms(boxes, scores, thr, max_out, valid):
    """The NMS kernels' algorithm on CPU tensors (module docstring): sort,
    suppression words from the plain clip where the extents are not apart,
    and the word-by-word walk with its removed mask."""
    bsz, n = scores.shape
    keep_idx = torch.zeros((bsz, max_out), dtype=torch.int32)
    keep_valid = torch.zeros((bsz, max_out), dtype=torch.bool)
    corners = rot.rotated_to_corners(boxes)
    areas = boxes[..., 2] * boxes[..., 3]
    for b in range(bsz):
        sel = (valid[b] & (scores[b] > rot.NEG_INF / 2)).nonzero()[:, 0].tolist()
        order = torch.tensor(sorted(sel, key=lambda i: (-float(scores[b, i]), i)),
                             dtype=torch.long)
        m = len(order)
        words = (m + WORD - 1) // WORD
        sup = torch.zeros((m, words * WORD), dtype=torch.bool)
        rows, cols = torch.triu_indices(m, m, 1)
        c, a = corners[b, order], areas[b, order]
        near = ~rot.extents_apart(c[rows], c[cols]) & ~rot.is_point(c[rows])
        r, q = rows[near], cols[near]
        inter = rot._pair_intersection_area(c[r], c[q])
        sup[r, q] = inter / torch.clamp(a[r] + a[q] - inter, min=1e-12) > thr
        packed = np.packbits(sup.numpy().reshape(m, words, WORD), axis=-1, bitorder="little")
        mask = [[int(v) for v in row] for row in packed.view("<u8")[..., 0]]
        removed = [0 if (t + 1) * WORD <= m else (~0 << (m - t * WORD)) & (2 ** WORD - 1)
                   for t in range(words)]
        cnt = 0
        for t in range(words):
            live, kept = ~removed[t] & (2 ** WORD - 1), []
            while live and cnt < max_out:
                i = (live & -live).bit_length() - 1
                keep_idx[b, cnt], keep_valid[b, cnt] = int(order[t * WORD + i]), True
                cnt += 1
                kept.append(t * WORD + i)
                live &= ~(1 << i) & ~mask[t * WORD + i][t]
            if cnt == max_out:
                break
            for u in range(t + 1, words):
                for p in kept:
                    removed[u] |= mask[p][u]
    return keep_idx, keep_valid


def nms_case(seed, bsz, n, span, steps, groups, valid_share=0.9):
    """Integer-pixel boxes at the models' angles, scores on ``steps`` levels
    (ties), a share valid, centres offset 4096 x group as the models do."""
    rs = np.random.RandomState(seed)
    boxes = np.stack([rs.randint(0, span, (bsz, n)), rs.randint(0, span, (bsz, n)),
                      rs.randint(2, 40, (bsz, n)), rs.randint(2, 40, (bsz, n)),
                      rs.choice(MODEL_ANGLES, (bsz, n))], -1).astype(np.float32)
    scores = (np.floor(rs.rand(bsz, n) * steps) / steps).astype(np.float32)
    valid = rs.rand(bsz, n) < valid_share
    boxes = torch.from_numpy(boxes)
    if groups:
        boxes = rot.offset_boxes(boxes, torch.from_numpy(rs.randint(0, groups, (bsz, n))))
    return boxes, torch.from_numpy(scores), torch.from_numpy(valid)


@pytest.mark.parametrize("seed,n,span,steps,groups,thr,max_out,valid_share", [
    (40, 300, 60, 8, 0, 0.3, 40, 0.9),       # dense, ties: max_out below the kept
    (41, 300, 80, 6, 80, 0.5, 250, 0.9),     # classes 4096 apart: max_out above the kept
    (42, 260, 70, 16, 5, 0.7, 240, 0.9),     # five levels, the RRPN's threshold
    (43, 200, 50, 4, 3, 0.4, 150, 0.25),     # fewer selectable than slots
])
def test_bits_walk_equals_the_plain_nms(seed, n, span, steps, groups, thr, max_out,
                                        valid_share):
    boxes, scores, valid = nms_case(seed, 2, n, span, steps, groups, valid_share)
    want = rot.plain_rotated_nms(boxes, scores, thr, max_out, valid=valid)
    got = bits_walk_nms(boxes, scores, thr, max_out, valid)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    kept = want[1].sum(1)
    selectable = valid.sum(1)
    assert int(kept.min()) > 10
    if seed == 40:
        assert bool((kept == max_out).all())
    else:
        assert bool((kept < max_out).all())
    if seed == 43:
        assert bool((selectable < max_out).all())

"""Point assignment of the RepPoints family (counterpart of
``slenderobjdet_tpu/models/meta_arch/reppoints.py``).

Only ``rep_points_assign_with_idx`` is here: the nearest-point assignment that
``NearestRetinaNet`` and ``PointRetinaNet`` use. The RepPoints head, detector
and the other assigners come with deformable convolution.
"""

from __future__ import annotations

import torch


def rep_points_assign_with_idx(centers, point_lvls, gt_boxes, gt_valid,
                               lvl_min, lvl_max, scale=4.0, pos_num=1):
    """Each valid gt claims the ``pos_num`` points nearest to its centre on its
    own pyramid level; a point claimed by several gt goes to the nearest.

    centers (L, 2) xy, point_lvls (L,) int (log2 of the stride), gt_boxes
    (G, 4) XYXY, gt_valid (G,) bool. The gt's level is the mean of
    ``log2(w / scale)`` and ``log2(h / scale)`` truncated toward zero and
    clipped to [lvl_min, lvl_max]; distances are in units of the gt's size.
    Returns objectness (L,) bool and the matched gt index (L,) (0 where
    nothing matched). Ties in distance go to the lowest point index, as
    ``jax.lax.top_k`` takes them; a padded gt has every distance at inf and
    picks nothing."""
    gt_xy = (gt_boxes[:, :2] + gt_boxes[:, 2:]) / 2
    gt_wh = torch.clamp(gt_boxes[:, 2:] - gt_boxes[:, :2], min=1e-6)
    gt_lvl = ((torch.log2(gt_wh[:, 0] / scale) + torch.log2(gt_wh[:, 1] / scale))
              / 2).to(torch.int32)
    gt_lvl = torch.clamp(gt_lvl, lvl_min, lvl_max)
    delta = (centers[None, :, :] - gt_xy[:, None, :]) / gt_wh[:, None, :]
    d = torch.sqrt((delta * delta).sum(dim=-1))                     # (G, L)
    on_lvl = point_lvls[None, :] == gt_lvl[:, None]
    inf = torch.full_like(d, float("inf"))
    d = torch.where(on_lvl & gt_valid[:, None], d, inf)
    if pos_num == 1:
        top_idx = torch.argmin(d, dim=1, keepdim=True)              # first minimum
    else:
        top_idx = torch.sort(d, dim=1, stable=True)[1][:, :pos_num]
    vals = torch.gather(d, 1, top_idx)      # inf where the gt picked nothing
    cand = inf.scatter_reduce(1, top_idx, vals, "amin")
    best = cand.amin(dim=0)
    best_gt = torch.argmin(cand, dim=0)
    return torch.isfinite(best), best_gt

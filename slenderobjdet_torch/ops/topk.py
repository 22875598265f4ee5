"""Pair top-k over (location, class) scores (counterpart of
``slenderobjdet_tpu/ops/topk.py:pair_top_k``), exact through ``torch.topk``."""

from __future__ import annotations

import torch


def pair_top_k(rank: torch.Tensor, k: int, approx: bool = False):
    """Top-k over the flattened pair axis of a (B, L, C) ranking tensor,
    returning (values (B, K), loc_idx (B, K), cls_idx (B, K) int32) with
    K = min(k, L*C).

    Two-stage location-first selection when L > k: every location holding a
    top-K pair ranks in the top K locations by class-max of the same rank
    tensor, so stage 1 keeps K locations and stage 2 ranks their pairs. The
    caller bakes every ranking factor into ``rank`` first. ``approx`` is
    accepted for signature parity with the JAX version (its TPU approximate
    top-k) and ignored: selection is exact. Order among equal values is
    unspecified (``torch.topk``)."""
    del approx
    bsz, L, C = rank.shape
    kloc = min(k, L)
    loc_sel = None
    if L > kloc:
        _, loc_sel = torch.topk(rank.amax(dim=-1), kloc, dim=1)     # (B, kloc)
        rank = torch.gather(rank, 1, loc_sel[..., None].expand(-1, -1, C))

    kk = min(k, kloc * C)
    values, idx = torch.topk(rank.reshape(bsz, kloc * C), kk, dim=1)
    loc_idx = idx // C
    cls_idx = (idx % C).to(torch.int32)
    if loc_sel is not None:
        loc_idx = torch.gather(loc_sel, 1, loc_idx)
    return values, loc_idx, cls_idx

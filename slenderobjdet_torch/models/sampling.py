"""Fixed-shape random subsampling with detectron2's ``subsample_labels``
semantics (counterpart of ``slenderobjdet_tpu/models/sampling.py``).

Each candidate gets a random priority; its rank among its group's priorities
(a stable argsort, as ``jnp.argsort``) decides selection, so the result is a
boolean mask with at most ``num_samples`` entries set, uniform without
replacement. The JAX version draws the priorities with ``jax.random``, whose
bits PyTorch cannot reproduce: here they come from an explicit
``torch.Generator``, or from the caller (``priorities``), so that a test can
feed the JAX package's own draws.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _rank_in_group(priority: torch.Tensor, member: torch.Tensor) -> torch.Tensor:
    """Rank (from 0) of each element among its group's ascending priorities;
    non-members get rank N + 1."""
    n = priority.shape[0]
    p = torch.where(member, priority, torch.inf)
    order = torch.argsort(p, stable=True)
    ranks = torch.empty_like(order)
    ranks[order] = torch.arange(n, device=p.device)
    return torch.where(member, ranks, n + 1)


def draw_priorities(n: int, generator: torch.Generator,
                    device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two (n,) uniform priority vectors ``subsample_labels`` needs, from
    ``generator`` (which lives on ``device``)."""
    return tuple(torch.rand(n, generator=generator, device=device)
                 for _ in range(2))


def subsample_labels(
    positive: torch.Tensor,      # (N,) bool
    negative: torch.Tensor,      # (N,) bool
    num_samples: int,
    positive_fraction: float,
    generator: Optional[torch.Generator] = None,
    priorities: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (pos_mask, neg_mask), the selected positives and negatives:
    num_pos = min(#pos, int(num_samples * positive_fraction)),
    num_neg = min(#neg, num_samples - num_pos). The priorities are
    ``priorities`` (two (N,) float tensors) or drawn from ``generator``."""
    if priorities is None:
        priorities = draw_priorities(positive.shape[0], generator, positive.device)
    target_pos = int(num_samples * positive_fraction)

    pos_rank = _rank_in_group(priorities[0], positive)
    sel_pos = positive & (pos_rank < target_pos)
    num_pos = sel_pos.sum()

    neg_rank = _rank_in_group(priorities[1], negative)
    sel_neg = negative & (neg_rank < (num_samples - num_pos))
    return sel_pos, sel_neg

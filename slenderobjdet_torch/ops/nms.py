"""Fixed-shape greedy NMS (counterpart of ``slenderobjdet_tpu/ops/nms.py`` and
``slenderobjdet_tpu/ops/pallas_nms.py``).

- ``nms_select`` / ``batched_nms``: the plain PyTorch version, a loop of
  ``max_out`` steps over batched tensors. Each step takes the argmax live
  score (ties to the lowest index), emits it, and suppresses every box whose
  IoU with it exceeds the threshold; the result is the first ``max_out``
  survivors of classic greedy NMS, in fixed shape with a validity mask.
- ``cuda_nms`` / ``cuda_batched_nms``: the wrapper of the CUDA kernel
  ``csrc/nms.cu`` (one block per image, candidates in shared memory), which
  gives exactly the plain version's results. On CPU tensors it runs the plain
  version.

Class awareness uses the coordinate-offset trick with the offset taken per
image, as ``FCOS.predict`` computes it by vmapping ``batched_nms``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

NEG_INF = -1e10


def nms_select(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    max_out: int,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS over a batch: boxes (B, N, 4) XYXY, scores (B, N), valid
    (B, N) bool or None. Returns keep_idx (B, max_out) int32, 0 where
    invalid, and keep_valid (B, max_out) bool."""
    live = (torch.where(valid, scores, NEG_INF) if valid is not None
            else scores.clone())
    x1, y1, x2, y2 = boxes.unbind(-1)
    areas = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    rows = torch.arange(boxes.shape[0], device=boxes.device)

    keep_idx, keep_valid = [], []
    for _ in range(max_out):
        i = torch.argmax(live, dim=1)  # first maximal index, as jnp.argmax
        is_valid = live[rows, i] > NEG_INF / 2

        def pick(v):
            return v[rows, i][:, None]

        iw = (torch.minimum(x2, pick(x2)) - torch.maximum(x1, pick(x1))).clamp(min=0)
        ih = (torch.minimum(y2, pick(y2)) - torch.maximum(y1, pick(y1))).clamp(min=0)
        inter = iw * ih
        iou = inter / torch.clamp(areas + pick(areas) - inter, min=1e-12)

        suppress = iou > iou_threshold  # includes the selected box itself
        live = torch.where(is_valid[:, None] & suppress, NEG_INF, live)
        live[rows, i] = NEG_INF
        keep_idx.append(i)
        keep_valid.append(is_valid)
    keep_idx = torch.stack(keep_idx, dim=1).to(torch.int32)
    keep_valid = torch.stack(keep_valid, dim=1)
    return torch.where(keep_valid, keep_idx, 0), keep_valid


def _class_offset(boxes: torch.Tensor, idxs: torch.Tensor) -> torch.Tensor:
    """boxes shifted by class * (per-image max finite coordinate + 1)."""
    finite = torch.where(torch.isfinite(boxes), boxes, 0.0)
    max_coord = finite.amax(dim=(1, 2)) + 1.0                    # (B,)
    offsets = idxs.to(boxes.dtype) * max_coord[:, None]          # (B, N)
    return boxes + offsets[..., None]


def batched_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    idxs: torch.Tensor,
    iou_threshold: float,
    max_out: int,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Class-aware ``nms_select``: boxes with different ``idxs`` (B, N) never
    suppress each other."""
    return nms_select(_class_offset(boxes, idxs), scores, iou_threshold,
                      max_out, valid=valid)


def cuda_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    max_out: int,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``nms_select`` through the CUDA kernel for CUDA tensors; CPU tensors
    take the plain version."""
    if boxes.device.type == "cpu":
        return nms_select(boxes, scores, iou_threshold, max_out, valid=valid)
    _build.require_cuda("cuda_nms", boxes, scores)
    bsz, n, four = boxes.shape
    if four != 4 or scores.shape != (bsz, n) or n < 1 or max_out < 1:
        raise ValueError(f"cuda_nms: bad shapes boxes {tuple(boxes.shape)}, "
                         f"scores {tuple(scores.shape)}, max_out {max_out}")
    lib = _build.library()
    if lib.nms_smem_bytes(n) > torch.cuda.get_device_properties(
            boxes.device).shared_memory_per_block_optin:
        raise ValueError(f"cuda_nms: N={n} candidates do not fit in shared memory")
    boxes = boxes.to(torch.float32).contiguous()
    live = scores.to(torch.float32)
    if valid is not None:
        live = torch.where(valid, live, NEG_INF)
    live = live.contiguous()
    keep_idx = torch.empty((bsz, max_out), dtype=torch.int32, device=boxes.device)
    keep_valid = torch.empty((bsz, max_out), dtype=torch.bool, device=boxes.device)
    rc = lib.nms_launch(boxes.data_ptr(), live.data_ptr(), bsz, n,
                        float(iou_threshold), max_out, keep_idx.data_ptr(),
                        keep_valid.data_ptr(), _build.stream_ptr(boxes))
    _build.check(rc, "nms_launch")
    _build.LAUNCHES["nms"] += 1
    return keep_idx, keep_valid


def cuda_batched_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    idxs: torch.Tensor,
    iou_threshold: float,
    max_out: int,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Class-aware ``cuda_nms`` (the offset is an elementwise op outside the
    kernel, per image)."""
    return cuda_nms(_class_offset(boxes, idxs), scores, iou_threshold,
                    max_out, valid=valid)

"""Fixed-shape greedy NMS (counterpart of ``slenderobjdet_tpu/ops/nms.py`` and
``slenderobjdet_tpu/ops/pallas_nms.py``).

- ``nms_select`` / ``batched_nms``: the plain PyTorch version, a loop of
  ``max_out`` steps over batched tensors. Each step takes the argmax live
  score (ties to the lowest index), emits it, and suppresses every box whose
  IoU with it exceeds the threshold; the result is the first ``max_out``
  survivors of classic greedy NMS, in fixed shape with a validity mask.
- ``cuda_nms`` / ``cuda_batched_nms``: the wrapper of the CUDA kernel
  ``csrc/nms.cu`` (one block per image: the selectable candidates sorted once
  in shared memory, then resolved 32 a round; the class offset is formed in
  the kernel), which gives exactly the plain version's results in one launch.
  On CPU tensors it runs the plain version. Both go through the registered
  operator ``slenderobjdet::nms`` (``nms_op``), so that ``torch.export``
  records the NMS as one node and a reloaded program launches the kernel.
- ``level_batched_nms``: the RPN's level-aware NMS, ``batched_nms`` with the
  candidates' pyramid level as the class, as one kernel launch over rows of
  (image, level) (``level_rows``) and a merge of the rows' kept lists (the
  plain version row by row on CPU tensors).
- ``ordered_key``, ``iou_exceeds`` and ``grouped_nms_model``: the kernel's
  three ideas in plain PyTorch, so that the CPU tests can hold them against
  the reference. Nothing else uses them.

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


def launch_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    idxs: Optional[torch.Tensor],
    valid: Optional[torch.Tensor],
    iou_threshold: float,
    max_out: int,
    rounds: Optional[torch.Tensor] = None,
    row_offset: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the CUDA kernel on CUDA tensors: boxes (B, N, 4) and
    scores (B, N) float32, ``idxs`` (B, N) int32/int64 or None (class-free),
    ``valid`` (B, N) bool or None. ``rounds`` (B,) int32, if given, receives
    the block-wide rounds each row took. ``row_offset`` (B,) float32, only
    without ``idxs``, is added to every box of its row."""
    given = [t for t in (boxes, scores, idxs, valid, rounds, row_offset)
             if t is not None]
    _build.require_cuda("cuda_nms", *given)
    bsz, n, four = boxes.shape
    if four != 4 or scores.shape != (bsz, n) or n < 1 or max_out < 1:
        raise ValueError(f"cuda_nms: bad shapes boxes {tuple(boxes.shape)}, "
                         f"scores {tuple(scores.shape)}, max_out {max_out}")
    for name, t, shape, dtypes in (
            ("idxs", idxs, (bsz, n), (torch.int32, torch.int64)),
            ("valid", valid, (bsz, n), (torch.bool,)),
            ("rounds", rounds, (bsz,), (torch.int32,)),
            ("row_offset", row_offset, (bsz,), (torch.float32,))):
        if t is not None and (t.shape != shape or t.dtype not in dtypes):
            raise ValueError(f"cuda_nms: {name} {tuple(t.shape)} {t.dtype}, "
                             f"expected {shape} of {dtypes}")
    if idxs is not None and row_offset is not None:
        raise ValueError("cuda_nms: classes and row offsets exclude each other")
    lib = _build.library()
    if lib.nms_smem_bytes(n, max_out) > torch.cuda.get_device_properties(
            boxes.device).shared_memory_per_block_optin:
        raise ValueError(f"cuda_nms: N={n} candidates and {max_out} slots do not fit in "
                         f"shared memory (at most 8192 candidates a row, fewer with "
                         f"more slots)")
    boxes = boxes.to(torch.float32).contiguous()
    scores = scores.to(torch.float32).contiguous()
    idxs = None if idxs is None else idxs.contiguous()
    valid = None if valid is None else valid.contiguous()
    row_offset = None if row_offset is None else row_offset.contiguous()
    if rounds is not None and not rounds.is_contiguous():
        raise ValueError("cuda_nms: rounds must be contiguous")
    keep_idx = torch.empty((bsz, max_out), dtype=torch.int32, device=boxes.device)
    keep_valid = torch.empty((bsz, max_out), dtype=torch.bool, device=boxes.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = lib.nms_launch(boxes.data_ptr(), scores.data_ptr(), ptr(idxs),
                        int(idxs is not None and idxs.dtype == torch.int64),
                        ptr(row_offset), ptr(valid), bsz, n, float(iou_threshold), max_out,
                        keep_idx.data_ptr(), keep_valid.data_ptr(), ptr(rounds),
                        _build.stream_ptr(boxes))
    _build.check(rc, "nms_launch")
    _build.LAUNCHES["nms"] += 1
    return keep_idx, keep_valid


def cuda_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    max_out: int,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``nms_select`` through the CUDA kernel for CUDA tensors; CPU tensors
    take the plain version (both through the ``slenderobjdet::nms`` op)."""
    return nms_op(boxes, scores, None, valid, None, iou_threshold, max_out)


def cuda_batched_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    idxs: torch.Tensor,
    iou_threshold: float,
    max_out: int,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``batched_nms`` through the CUDA kernel (which forms the per-image
    class offset itself) for CUDA tensors; CPU tensors take the plain
    version (both through the ``slenderobjdet::nms`` op)."""
    return nms_op(boxes, scores, idxs, valid, None, iou_threshold, max_out)


# The NMS as a registered operator, which ``torch.export`` records as one
# node: the plain version on CPU tensors, the kernel on CUDA tensors (which
# raises where the build or the launch fails). ``idxs`` (classes) and
# ``row_offset`` (a shift a row) exclude each other.
@torch.library.custom_op(
    "slenderobjdet::nms", mutates_args=(), device_types="cpu",
    schema="(Tensor boxes, Tensor scores, Tensor? idxs, Tensor? valid, "
           "Tensor? row_offset, float iou_threshold, int max_out) -> (Tensor, Tensor)")
def _nms_plain(boxes, scores, idxs, valid, row_offset, iou_threshold, max_out):
    if idxs is not None:
        return batched_nms(boxes, scores, idxs, iou_threshold, max_out, valid=valid)
    if row_offset is not None:
        boxes = boxes + row_offset[:, None, None]
    return nms_select(boxes, scores, iou_threshold, max_out, valid=valid)


@_nms_plain.register_kernel("cuda")
def _nms_kernel(boxes, scores, idxs, valid, row_offset, iou_threshold, max_out):
    return launch_nms(boxes, scores, idxs, valid, iou_threshold, max_out,
                      row_offset=row_offset)


@_nms_plain.register_fake
def _nms_fake(boxes, scores, idxs, valid, row_offset, iou_threshold, max_out):
    shape = (scores.shape[0], max_out)
    return (scores.new_empty(shape, dtype=torch.int32),
            scores.new_empty(shape, dtype=torch.bool))


def nms_op(boxes, scores, idxs, valid, row_offset, iou_threshold, max_out):
    """One call of the ``slenderobjdet::nms`` operator."""
    return torch.ops.slenderobjdet.nms(boxes, scores, idxs, valid, row_offset,
                                       float(iou_threshold), int(max_out))


def _order_key(scores: torch.Tensor, index: torch.Tensor,
               selectable: torch.Tensor) -> torch.Tensor:
    """int64 keys whose descending order is (score descending, index
    ascending) over the selectable entries, -0 being +0; the others share
    the least key. Any shape; ``index`` below 2^32."""
    scores = torch.where(scores == 0, 0.0, scores.to(torch.float32))
    bits = scores.view(torch.int32).to(torch.int64)
    high = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)
    low = ~index.to(torch.int64) & 0xFFFFFFFF
    return torch.where(selectable, high * 2 ** 32 + low, -2 ** 63)


_LEVEL_INDEX: dict = {}


def _level_index(counts: Tuple[int, ...], device: torch.device):
    """For levels of ``counts`` candidates: which of the (L, K) row
    positions hold one, K the largest count, and its candidate index (0 in
    the padding). Kept per shape, so that a call copies nothing from the
    host (except while ``torch.export`` traces, whose tensors must not
    outlive the trace)."""
    key = (counts, device)
    if key in _LEVEL_INDEX:
        return _LEVEL_INDEX[key]
    starts = torch.tensor([sum(counts[:i]) for i in range(len(counts))], device=device)
    pos = torch.arange(max(counts), device=device)
    filled = pos[None] < torch.tensor(counts, device=device)[:, None]
    entry = filled, torch.where(filled, starts[:, None] + pos[None], 0)
    if not torch.compiler.is_compiling():
        _LEVEL_INDEX[key] = entry
    return entry


def level_rows(boxes: torch.Tensor, scores: torch.Tensor, counts,
               valid: Optional[torch.Tensor] = None):
    """The rows ``level_batched_nms`` gives the kernel: (B, N) candidates in
    ``len(counts)`` consecutive levels of ``counts[l]`` each -> boxes (B * L,
    K, 4), scores (B * L, K) and validity (B * L, K), K the largest count
    (the padding invalid), each row's offset (B * L,) float32, float(level)
    * (the image's largest finite coordinate + 1), and each row position's
    candidate index (L, K)."""
    bsz, n = scores.shape
    dev = boxes.device
    counts = tuple(int(c) for c in counts)
    if sum(counts) != n or boxes.shape != (bsz, n, 4):
        raise ValueError(f"level_batched_nms: counts {list(counts)} for boxes "
                         f"{tuple(boxes.shape)}, scores {tuple(scores.shape)}")
    filled, index = _level_index(counts, dev)
    levels, width = index.shape

    def rows(t):
        return t[:, index].reshape(bsz * levels, width, *t.shape[2:])

    row_valid = filled[None].expand(bsz, -1, -1).reshape(bsz * levels, width)
    if valid is not None:
        row_valid = row_valid & rows(valid)
    finite = torch.where(torch.isfinite(boxes), boxes, 0.0)
    max_coord = finite.amax(dim=(1, 2)) + 1.0                         # (B,)
    offset = (torch.arange(levels, dtype=boxes.dtype, device=dev)[None]
              * max_coord[:, None]).reshape(-1)                       # (B * L,)
    return rows(boxes), rows(scores), row_valid, offset.to(torch.float32), index


def level_batched_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    counts,
    iou_threshold: float,
    max_out: int,
    valid: Optional[torch.Tensor] = None,
    rounds: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``batched_nms(boxes, scores, levels, ...)`` where the (B, N)
    candidates are ``len(counts)`` consecutive levels of ``counts[l]`` each
    and ``levels`` is each one's level, exactly, as the RPN calls it.

    The candidates go in rows of (image, level) (``level_rows``), each
    shifted by the offset the single call gives its level. Shifted so,
    levels lie apart and never suppress each other (boxes with finite
    coordinates; the RPN's are clipped to the image), so each row's greedy
    NMS keeps what the single call keeps of that level, in order; the rows'
    kept lists merged by (score descending, index ascending) are the single
    call's selection order, of which the first ``max_out`` are kept. On
    CUDA tensors the rows are one launch of the kernel (``rounds``, (B * L,)
    int32, receives each row's rounds), which raises where a row does not
    fit; on CPU tensors they go through ``nms_select``. Returns keep_idx
    (B, max_out) int32 into the N candidates (0 where invalid) and
    keep_valid (B, max_out) bool."""
    bsz = scores.shape[0]
    row_boxes, row_scores, row_valid, offset, index = level_rows(boxes, scores, counts,
                                                                 valid)
    if rounds is not None and boxes.device.type == "cuda":
        kept, kept_valid = launch_nms(row_boxes, row_scores, None, row_valid,
                                      iou_threshold, max_out, rounds=rounds,
                                      row_offset=offset)
    else:
        kept, kept_valid = nms_op(row_boxes, row_scores, None, row_valid, offset,
                                  iou_threshold, max_out)
    # rows' kept lists -> candidate indices, merged per image
    levels, width = index.shape
    gidx = torch.gather(index[None].expand(bsz, -1, -1).reshape(bsz * levels, width),
                        1, kept.long()).reshape(bsz, levels * max_out)
    kept_valid = kept_valid.reshape(bsz, levels * max_out)
    key = _order_key(torch.gather(scores, 1, gidx), gidx, kept_valid)
    order = torch.sort(key, dim=1, descending=True).indices[:, :max_out]
    keep_valid = torch.gather(kept_valid, 1, order)
    keep_idx = torch.where(keep_valid, torch.gather(gidx, 1, order), 0)
    return keep_idx.to(torch.int32), keep_valid


# --- the kernel's algorithm in plain PyTorch (used by the CPU tests only) ---

GROUP = 32              # candidates the kernel resolves a round
BAND = 2.0 ** -21       # relative half-width of the band in which it divides
WINDOW = 1024           # sorted positions it keeps swept from the cursor on
AHEAD = 256             # it opens the window again below this many


def ordered_key(scores: torch.Tensor, valid: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """The kernel's sort key, (N,) int64 from float32 scores: descending key
    order is (score descending, index ascending) over the selectable
    candidates (valid and score > NEG_INF / 2); the others share the least
    key. The kernel's key is unsigned; this one is the same bits with the
    top one flipped, so that signed order equals the kernel's."""
    selectable = scores > NEG_INF / 2
    if valid is not None:
        selectable = selectable & valid
    return _order_key(scores, torch.arange(scores.shape[0]), selectable)


def iou_exceeds(inter: torch.Tensor, uni: torch.Tensor, iou_threshold: float,
                return_divided: bool = False):
    """``inter / uni > iou_threshold`` on float32 tensors as the kernel
    decides it: surely true above ``thr * uni * (1 + 2^-21)``, surely false
    below ``thr * uni * (1 - 2^-21)``, and by the division only in between
    (or where ``thr * uni`` leaves [1e-30, 1e30]). ``return_divided`` also
    returns where the division decided."""
    thr = torch.tensor(iou_threshold, dtype=torch.float32)
    t = thr * uni
    in_range = (t >= 1e-30) & (t <= 1e30)
    sure = in_range & (inter > t * (1.0 + BAND))
    never = in_range & ~sure & (inter < t * (1.0 - BAND))
    divided = ~sure & ~never
    out = sure | (divided & (inter / uni > thr))
    return (out, divided) if return_divided else out


def _suppresses(cand, cand_area, sel, sel_area, iou_threshold):
    """(..., 4) candidates against (..., 4) selected boxes, broadcast: the
    reference's IoU operations in its order, decided by ``iou_exceeds``."""
    iw = (torch.minimum(cand[..., 2], sel[..., 2])
          - torch.maximum(cand[..., 0], sel[..., 0])).clamp(min=0)
    ih = (torch.minimum(cand[..., 3], sel[..., 3])
          - torch.maximum(cand[..., 1], sel[..., 1])).clamp(min=0)
    inter = iw * ih
    uni = torch.clamp(cand_area + sel_area - inter, min=1e-12)
    return iou_exceeds(inter, uni, iou_threshold)


def grouped_nms_model(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    max_out: int,
    valid: Optional[torch.Tensor] = None,
    idxs: Optional[torch.Tensor] = None,
    window: int = WINDOW,
    ahead: int = AHEAD,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's algorithm on CPU tensors: sort the selectable candidates
    once by ``ordered_key``; a round takes the next ``GROUP`` live ones in
    sorted order, resolves them among themselves in order, then kills the
    live candidates behind the group that a kept box suppresses. Only a
    window of sorted positions is swept: when fewer than ``ahead`` positions
    lie open ahead of the cursor it is opened to ``window`` positions, whose
    candidates first meet every box kept so far. Returns keep_idx (B,
    max_out) int32, keep_valid (B, max_out) bool and the rounds each image
    took (B,) int32."""
    if idxs is not None:
        boxes = _class_offset(boxes, idxs)
    bsz = boxes.shape[0]
    keep_idx = torch.zeros((bsz, max_out), dtype=torch.int32)
    keep_valid = torch.zeros((bsz, max_out), dtype=torch.bool)
    rounds = torch.zeros((bsz,), dtype=torch.int32)
    for b in range(bsz):
        key = ordered_key(scores[b], None if valid is None else valid[b])
        n_live = int((key > -2 ** 63).sum())
        order = torch.sort(key, descending=True).indices[:n_live]
        sbox = boxes[b, order].to(torch.float32)
        area = ((sbox[:, 2] - sbox[:, 0]).clamp(min=0)
                * (sbox[:, 3] - sbox[:, 1]).clamp(min=0))
        live = torch.ones(n_live, dtype=torch.bool)
        kept_pos = []
        cursor = opened = 0
        while len(kept_pos) < max_out:
            if opened < n_live and opened - cursor < ahead:
                target = min(n_live, cursor + window)
                if kept_pos:
                    live[opened:target] &= ~_suppresses(
                        sbox[opened:target, None], area[opened:target, None],
                        sbox[kept_pos][None], area[kept_pos][None],
                        iou_threshold).any(dim=1)
                opened = target
            group = cursor + torch.nonzero(live[cursor:opened])[:GROUP, 0]
            if group.numel() == 0:
                if opened >= n_live:
                    break
                cursor = opened
                continue
            rounds[b] += 1
            gbox, garea = sbox[group], area[group]
            # hits[j, l]: the group's j-th box suppresses its l-th
            hits = _suppresses(gbox[None, :], garea[None, :], gbox[:, None],
                               garea[:, None], iou_threshold)
            kept, dead = [], torch.zeros(group.numel(), dtype=torch.bool)
            for j in range(group.numel()):
                if not dead[j] and len(kept_pos) + len(kept) < max_out:
                    kept.append(j)
                    dead[j + 1:] |= hits[j, j + 1:]
            for j in kept:
                keep_idx[b, len(kept_pos)] = order[group[j]]
                keep_valid[b, len(kept_pos)] = True
                kept_pos.append(int(group[j]))
            cursor = int(group[-1]) + 1
            live[cursor:opened] &= ~_suppresses(
                sbox[cursor:opened, None], area[cursor:opened, None],
                gbox[kept][None], garea[kept][None], iou_threshold).any(dim=1)
    return keep_idx, keep_valid, rounds

"""Host-side image transforms (numpy/cv2) with deterministic RNG.

Counterpart of the reference's transform stack (d2 ResizeShortestEdge +
RandomFlip, `slender_det/data/utils.py:29-49`, plus ResizeLongestEdge from
`data/transforms/augmentation_impl.py`). Boxes are XYXY absolute and
transformed alongside the image. All randomness flows through an explicit
numpy Generator so the pipeline is reproducible per (seed, image index).

A copy of ``slenderobjdet_tpu/data/transforms.py``. Where cv2 imports, images
are resized by ``cv2.resize`` as there (the two loaders then yield the same
bytes); where it does not, by ``bilinear_resize`` below, written on torch and
held within one grey level of ``cv2.INTER_LINEAR`` by
``tests/test_torch_data.py``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

cv2 = LAZY = object()    # imported at first use: a loader that needs no decode and no
                         # resize never imports cv2 (tests set this to None to take it away)


def _cv2():
    """cv2 where it is installed, else None; imported when first needed."""
    global cv2
    if cv2 is LAZY:
        try:
            import cv2 as module
        except Exception:  # pragma: no cover
            module = None
        cv2 = module
    return cv2


def bilinear_resize(image: np.ndarray, size_wh: Tuple[int, int]) -> np.ndarray:
    """(H, W) or (H, W, C) array -> size_wh = (new W, new H), bilinear with
    half-pixel centres (``align_corners=False``) and no antialiasing: the
    sampling of ``cv2.INTER_LINEAR``. Runs on the CPU. uint8 in, uint8 out
    (rounded); other dtypes come back as float32."""
    nw, nh = size_wh
    x = torch.from_numpy(np.ascontiguousarray(image)).to(torch.float32)
    x = x[None, None] if x.dim() == 2 else x.permute(2, 0, 1)[None]
    y = torch.nn.functional.interpolate(
        x, size=(nh, nw), mode="bilinear", align_corners=False, antialias=False)
    y = y[0, 0] if image.ndim == 2 else y[0].permute(1, 2, 0)
    if image.dtype == np.uint8:
        y = y.round().clamp(0, 255).to(torch.uint8)
    return y.contiguous().numpy()


def resize(image: np.ndarray, size_wh: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize to (new W, new H): cv2 where it imports, else torch."""
    cv2 = _cv2()
    if cv2 is not None:
        return cv2.resize(image, size_wh, interpolation=cv2.INTER_LINEAR)
    return bilinear_resize(image, size_wh)


def resize_shortest_edge(
    image: np.ndarray,
    boxes: np.ndarray,
    short: int,
    max_size: int,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Scale so the shortest edge == short, capped so the longest <= max_size.
    Returns (image, boxes, scale)."""
    h, w = image.shape[:2]
    scale = short / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    if (nh, nw) != (h, w):
        image = resize(image, (nw, nh))
    # d2 transforms boxes by the exact ratio of the new/old sizes
    sx, sy = nw / w, nh / h
    boxes = boxes * np.array([sx, sy, sx, sy], np.float32)
    return image, boxes, scale


def resize_longest_edge(
    image: np.ndarray, boxes: np.ndarray, long: int
) -> Tuple[np.ndarray, np.ndarray, float]:
    h, w = image.shape[:2]
    scale = long / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    image = resize(image, (nw, nh))
    sx, sy = nw / w, nh / h
    boxes = boxes * np.array([sx, sy, sx, sy], np.float32)
    return image, boxes, scale


def horizontal_flip(
    image: np.ndarray, boxes: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    w = image.shape[1]
    image = image[:, ::-1]
    flipped = boxes.copy()
    flipped[:, 0] = w - boxes[:, 2]
    flipped[:, 2] = w - boxes[:, 0]
    return image, flipped


def pad_to(image: np.ndarray, pad_hw: Tuple[int, int]) -> np.ndarray:
    """Zero-pad bottom/right to a fixed shape (the fixed-shape replacement of
    detectron2's size-divisibility ImageList padding)."""
    h, w = image.shape[:2]
    ph, pw = pad_hw
    assert h <= ph and w <= pw, f"image {h}x{w} exceeds pad shape {ph}x{pw}"
    out = np.zeros((ph, pw) + image.shape[2:], dtype=image.dtype)
    out[:h, :w] = image
    return out


def choose_train_size(
    rng: np.random.Generator,
    min_sizes: Sequence[int],
    sampling: str = "choice",
) -> int:
    if sampling == "range" and len(min_sizes) == 2:
        return int(rng.integers(min_sizes[0], min_sizes[1] + 1))
    return int(min_sizes[rng.integers(len(min_sizes))])

"""Dataset mapper: dataset dict -> fixed-shape tensors.

A copy of ``slenderobjdet_tpu/data/mapper.py``, the fixed-shape redesign of the
reference's `DatasetMapper` (`slender_det/data/mappers/base.py:158-252`): the
same augmentation semantics (resize-shortest-edge + random horizontal flip at
train, resize at test), and the output is a *fixed-shape* example: the image
zero-padded to one of two orientation buckets (landscape/portrait; 896 x 1408
and 1408 x 896 for the flagship's 800 / 1333) and the gt arrays padded to
TPU.MAX_GT_PER_IMAGE with a validity mask, so every step sees one of two
shapes. With cv2 the two mappers yield the same bytes
(``tests/test_torch_data.py``).

Not ported yet, each raising NotImplementedError at construction: NEED_MASKS
(the center/border/size maps of ``structures/borders.py``, which come with
FCOSV3), USE_NORI (the packed-record image source of ``data/recordpack.py``)
and DATALOADER.OSS_ROOT (object-storage paths).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from . import transforms as T

try:
    import cv2
except Exception:  # pragma: no cover
    cv2 = None


def read_image(dataset_dict: Dict, fmt: str = "BGR") -> np.ndarray:
    """Return HWC uint8 image. Tests may inline an 'image' array in the dict."""
    if "image" in dataset_dict:
        img = dataset_dict["image"]
    else:
        if cv2 is None:
            raise RuntimeError(
                f"read_image: cannot read {dataset_dict.get('file_name')!r}: "
                "image files are decoded by cv2, which is not installed; "
                "inline the array under the dict's 'image' key instead")
        img = cv2.imread(dataset_dict["file_name"], cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(dataset_dict["file_name"])
    if fmt == "RGB":
        img = img[:, :, ::-1]
    return np.ascontiguousarray(img)


class DatasetMapper:
    def __init__(self, cfg, is_train: bool = True):
        self.is_train = is_train
        self.fmt = cfg.INPUT.FORMAT
        self.min_sizes = (
            tuple(cfg.INPUT.MIN_SIZE_TRAIN)
            if is_train
            else (cfg.INPUT.MIN_SIZE_TEST,)
        )
        self.sampling = cfg.INPUT.MIN_SIZE_TRAIN_SAMPLING
        self.max_size = cfg.INPUT.MAX_SIZE_TRAIN if is_train else cfg.INPUT.MAX_SIZE_TEST
        self.max_gt = cfg.TPU.MAX_GT_PER_IMAGE
        if cfg.NEED_MASKS:
            raise NotImplementedError(
                "NEED_MASKS is not ported: the center/border/size maps need "
                "structures/borders.py, which comes with FCOSV3 and the "
                "other FCOS-family detectors")
        if cfg.USE_NORI and cfg.NORI_PATH:
            raise NotImplementedError(
                "USE_NORI is not ported: the packed-record image source "
                "(data/recordpack.py) comes with the other FCOS-family "
                "detectors")
        if cfg.DATALOADER.OSS_ROOT:
            raise NotImplementedError(
                "DATALOADER.OSS_ROOT is not ported: object-storage paths "
                "(utils/smart_path.py) come with the packed-record source")
        # two orientation buckets; shapes chosen to fit shortest-edge resize
        short = max(self.min_sizes)
        # round the long side up to stride-128 multiple
        long = int(np.ceil(self.max_size / 128.0) * 128)
        short_pad = int(np.ceil(short / 128.0) * 128)
        self.pad_landscape = (short_pad, long)   # (H, W) for w >= h images
        self.pad_portrait = (long, short_pad)

    def __call__(self, dataset_dict: Dict, rng: Optional[np.random.Generator] = None
                 ) -> Dict[str, np.ndarray]:
        rng = rng or np.random.default_rng(0)
        image = read_image(dataset_dict, self.fmt)
        orig_h, orig_w = image.shape[:2]

        annos = [
            a for a in dataset_dict.get("annotations", [])
            if not a.get("iscrowd", 0)
        ]
        boxes = np.array([a["bbox"] for a in annos], np.float32).reshape(-1, 4)
        classes = np.array([a["category_id"] for a in annos], np.int64)
        rboxes = None
        if annos and "rbox" in annos[0]:
            rboxes = np.array([a["rbox"] for a in annos], np.float32).reshape(-1, 5)

        short = T.choose_train_size(rng, self.min_sizes, self.sampling)
        image, boxes, scale = T.resize_shortest_edge(image, boxes, short, self.max_size)
        if rboxes is not None:
            rboxes[:, :4] *= scale  # uniform scale; angle unchanged

        flipped = self.is_train and rng.random() < 0.5
        if flipped:
            image, boxes = T.horizontal_flip(image, boxes)
            if rboxes is not None:
                rboxes[:, 0] = image.shape[1] - rboxes[:, 0]
                rboxes[:, 4] = -rboxes[:, 4]

        rh, rw = image.shape[:2]
        pad_hw = self.pad_landscape if rw >= rh else self.pad_portrait
        image = T.pad_to(image, pad_hw)

        # clip boxes to the resized image and drop degenerate ones
        boxes[:, 0::2] = boxes[:, 0::2].clip(0, rw)
        boxes[:, 1::2] = boxes[:, 1::2].clip(0, rh)
        keep = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
        boxes, classes = boxes[keep], classes[keep]
        if rboxes is not None:
            rboxes = rboxes[keep]

        n = min(len(boxes), self.max_gt)
        gt_boxes = np.zeros((self.max_gt, 4), np.float32)
        gt_classes = np.zeros((self.max_gt,), np.int32)
        gt_valid = np.zeros((self.max_gt,), bool)
        gt_boxes[:n] = boxes[:n]
        gt_classes[:n] = classes[:n]
        gt_valid[:n] = True

        if rboxes is not None:
            gt_rboxes = np.zeros((self.max_gt, 5), np.float32)
            gt_rboxes[:n] = rboxes[:n]
            return {
                "image": image,
                "gt_boxes": gt_boxes,
                "gt_rboxes": gt_rboxes,
                "gt_classes": gt_classes,
                "gt_valid": gt_valid,
                "scale": np.float32(scale),
                "orig_size": np.array([orig_h, orig_w], np.float32),
                "image_size": np.array([rh, rw], np.int32),
                "image_id": dataset_dict.get("image_id", -1),
            }

        return {
            "image": image,
            "gt_boxes": gt_boxes,
            "gt_classes": gt_classes,
            "gt_valid": gt_valid,
            "scale": np.float32(scale),
            "orig_size": np.array([orig_h, orig_w], np.float32),
            "image_size": np.array([rh, rw], np.int32),
            "image_id": dataset_dict.get("image_id", -1),
        }

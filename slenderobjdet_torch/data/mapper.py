"""Dataset mapper: dataset dict -> fixed-shape tensors.

A copy of ``slenderobjdet_tpu/data/mapper.py``, the fixed-shape redesign of the
reference's `DatasetMapper` (`slender_det/data/mappers/base.py:158-252`): the
same augmentation semantics (resize-shortest-edge + random horizontal flip at
train, resize at test), and the output is a *fixed-shape* example: the image
zero-padded to one of two orientation buckets (landscape/portrait; 896 x 1408
and 1408 x 896 for the flagship's 800 / 1333) and the gt arrays padded to
TPU.MAX_GT_PER_IMAGE with a validity mask, so every step sees one of two
shapes. With cv2 the two mappers yield the same bytes
(``tests/test_torch_data.py``, ``tests/test_torch_borders.py``).

NEED_MASKS adds the polygon-rendered ``center_mask`` (H, W) (FCOSV3's centre
sampling, ProposalNetworkWithMasks' objectness) and, for
ProposalNetworkWithMasks only, ``border_mask`` (H, W) and ``size_map``
(H, W, 2), padded to the bucket (``structures/borders.py``), or the same maps
read from a ``<split>_sizes.pack`` and resized like the image. USE_NORI +
NORI_PATH read images from ``<split>.pack`` (``data/recordpack.py``);
DATALOADER.OSS_ROOT reads them from ``root/file_name``
(``utils/smart_path.py``). A packed or object-storage image is decoded by
``cv2.imdecode``: without cv2 it raises, as a file does.
"""

from __future__ import annotations

import io
import os
from typing import Dict, Optional

import numpy as np

from ..structures.borders import BorderMasks
from . import transforms as T

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


def read_image(dataset_dict: Dict, fmt: str = "BGR") -> np.ndarray:
    """Return HWC uint8 image. Tests may inline an 'image' array in the dict."""
    if "image" in dataset_dict:
        img = dataset_dict["image"]
    else:
        cv2 = _cv2()
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
        # NEED_MASKS: render the center-score map used by FCOSV3's
        # mask-based center sampling; ProposalNetworkWithMasks also takes
        # the size/border maps (the reference BorderMaskMapper's
        # mask_keys=["sizes"], bm_mapper.py:36 + pnwm.py:11)
        self.need_masks = cfg.NEED_MASKS
        # Packed-record / object-storage image sources. USE_NORI+NORI_PATH is
        # the reference's switch for fetching images (and precomputed size
        # maps) from its nori+redis store (`bm_mapper.py:45-57`); here the
        # same keys point at a directory of self-indexing RecordPacks named
        # `<split>.pack` / `<split>_sizes.pack`. DATALOADER.OSS_ROOT mirrors
        # OssMapper (`oss_mapper.py:33-50`): images read from
        # root/file_name via smart_path (local or s3).
        self.image_pack = None
        self.sizes_pack = None
        self.oss_root = cfg.DATALOADER.OSS_ROOT
        if cfg.USE_NORI and cfg.NORI_PATH:
            from ..utils.smart_path import smart_path
            from .recordpack import PackReader

            splits = cfg.DATASETS.TRAIN if is_train else cfg.DATASETS.TEST
            if splits:
                root = smart_path(cfg.NORI_PATH)
                self.image_pack = PackReader(str(root / (splits[0] + ".pack")))
                sizes_path = root / (splits[0] + "_sizes.pack")
                if sizes_path.exists():
                    self.sizes_pack = PackReader(str(sizes_path))
        self.mask_keys = ("center",)
        if self.need_masks and cfg.MODEL.META_ARCHITECTURE in (
                "ProposalNetworkWithMasks",):
            self.mask_keys = ("center", "sizes", "border")
        # two orientation buckets; shapes chosen to fit shortest-edge resize
        short = max(self.min_sizes)
        # round the long side up to stride-128 multiple
        long = int(np.ceil(self.max_size / 128.0) * 128)
        short_pad = int(np.ceil(short / 128.0) * 128)
        self.pad_landscape = (short_pad, long)   # (H, W) for w >= h images
        self.pad_portrait = (long, short_pad)

    def _load_image(self, dataset_dict: Dict) -> np.ndarray:
        if "image" in dataset_dict:
            return read_image(dataset_dict, self.fmt)
        name = os.path.basename(dataset_dict.get("file_name", ""))
        if self.image_pack is not None and name in self.image_pack:
            img = _decode(self.image_pack.get(name), name)
        elif self.oss_root:
            from ..utils.smart_path import smart_path

            raw = (smart_path(self.oss_root)
                   / dataset_dict["file_name"]).read_bytes()
            img = _decode(raw, dataset_dict["file_name"])
        else:
            return read_image(dataset_dict, self.fmt)
        if self.fmt == "RGB":
            img = img[:, :, ::-1]
        return np.ascontiguousarray(img)

    def _fetch_precomputed_maps(self, dataset_dict: Dict) -> Optional[Dict]:
        """center/border/sizes maps at original resolution, from the
        `<split>_sizes.pack` written by ``coco_to_pack --sizes`` (the
        reference fetched these from `<split>_sizes.nori`)."""
        if self.sizes_pack is None:
            return None
        name = os.path.basename(dataset_dict.get("file_name", ""))
        if name not in self.sizes_pack:
            return None
        with np.load(io.BytesIO(self.sizes_pack.get(name))) as z:
            return {k: z[k] for k in z.files}

    def __call__(self, dataset_dict: Dict, rng: Optional[np.random.Generator] = None
                 ) -> Dict[str, np.ndarray]:
        rng = rng or np.random.default_rng(0)
        image = self._load_image(dataset_dict)
        orig_h, orig_w = image.shape[:2]

        annos = [
            a for a in dataset_dict.get("annotations", [])
            if not a.get("iscrowd", 0)
        ]
        boxes = np.array([a["bbox"] for a in annos], np.float32).reshape(-1, 4)
        classes = np.array([a["category_id"] for a in annos], np.int64)
        polygons = [
            [np.asarray(p, np.float64) for p in a["segmentation"]]
            if isinstance(a.get("segmentation"), list) else []
            for a in annos
        ] if self.need_masks else None
        rboxes = None
        if annos and "rbox" in annos[0]:
            rboxes = np.array([a["rbox"] for a in annos], np.float32).reshape(-1, 5)

        short = T.choose_train_size(rng, self.min_sizes, self.sampling)
        image, boxes, scale = T.resize_shortest_edge(image, boxes, short, self.max_size)
        if rboxes is not None:
            rboxes[:, :4] *= scale  # uniform scale; angle unchanged
        if polygons is not None:
            polygons = [[p * scale for p in inst] for inst in polygons]

        flipped = self.is_train and rng.random() < 0.5
        if flipped:
            image, boxes = T.horizontal_flip(image, boxes)
            if rboxes is not None:
                rboxes[:, 0] = image.shape[1] - rboxes[:, 0]
                rboxes[:, 4] = -rboxes[:, 4]
            if polygons is not None:
                w_img = image.shape[1]
                mirrored = []
                for inst in polygons:
                    new_inst = []
                    for p in inst:
                        q = p.copy()
                        q[0::2] = w_img - q[0::2]
                        new_inst.append(q)
                    mirrored.append(new_inst)
                polygons = mirrored
                # as in the JAX mapper, which rebinds `flipped` to this
                # list: an example without instances keeps its precomputed
                # maps unflipped
                flipped = bool(mirrored)

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

        extra = {}
        if polygons is not None:
            extra = self._masks(dataset_dict, polygons, keep, scale, flipped,
                                (rh, rw), image.shape[:2])

        if rboxes is not None:
            gt_rboxes = np.zeros((self.max_gt, 5), np.float32)
            gt_rboxes[:n] = rboxes[:n]
            return {
                **extra,
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
            **extra,
            "image": image,
            "gt_boxes": gt_boxes,
            "gt_classes": gt_classes,
            "gt_valid": gt_valid,
            "scale": np.float32(scale),
            "orig_size": np.array([orig_h, orig_w], np.float32),
            "image_size": np.array([rh, rw], np.int32),
            "image_id": dataset_dict.get("image_id", -1),
        }

    def _masks(self, dataset_dict, polygons, keep, scale, flipped, hw, pad_hw):
        """The NEED_MASKS maps of one example, padded to ``pad_hw``: read
        from the sizes pack and transformed like the image where it holds the
        image, else rendered from the kept instances' polygons at ``hw``, the
        resized image's size."""
        rh, rw = hw
        border = size = None
        pre = self._fetch_precomputed_maps(dataset_dict)
        if pre is not None:
            # transform the original-resolution maps like the image: resize
            # (values of `sizes` scale with the image), flip, pad; the
            # reference applied its transform list to the fetched maps the
            # same way (`bm_mapper.py:99-147`)
            def _tx(m, scale_values=False):
                m = T.resize(m.astype(np.float32), (rw, rh))
                if scale_values:
                    m = m * np.float32(scale)
                if flipped:
                    m = np.ascontiguousarray(m[:, ::-1])
                return m

            center = _tx(pre["center"])
            if "sizes" in self.mask_keys:
                border, size = _tx(pre["border"]), _tx(pre["sizes"], scale_values=True)
        else:
            # kept instances with polygons; not cut to MAX_GT_PER_IMAGE, as
            # in the JAX mapper
            masks = BorderMasks([p for p, k in zip(polygons, keep) if k and p])
            center = masks.center_masks((rh, rw), standard="gaussian", sigma=0.5)
            if "sizes" in self.mask_keys:
                border, _, size = masks.masks((rh, rw))
        extra = {"center_mask": T.pad_to(center, pad_hw)}
        if border is not None:
            extra["border_mask"] = T.pad_to(border, pad_hw)
            extra["size_map"] = np.stack(
                [T.pad_to(size[..., 0], pad_hw), T.pad_to(size[..., 1], pad_hw)], axis=-1)
        return extra


def _decode(raw: bytes, name: str) -> np.ndarray:
    """A packed or object-storage image record -> HWC uint8 BGR, by
    ``cv2.imdecode``; without cv2 a RuntimeError, never another decoder."""
    cv2 = _cv2()
    if cv2 is None:
        raise RuntimeError(
            f"cannot decode the image record {name!r}: packed and "
            "object-storage images are decoded by cv2, which is not "
            "installed; inline the array under the dict's 'image' key instead")
    img = cv2.imdecode(np.frombuffer(raw, np.uint8), cv2.IMREAD_COLOR)
    if img is None:
        raise ValueError(f"undecodable image record: {name!r}")
    return img

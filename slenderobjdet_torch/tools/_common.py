"""What the port's model-driving and drawing tools share: the config and
model from the command line, images read without cv2 where they are PNG,
and images written as PNG."""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from ..data.mapper import DatasetMapper, read_image
from ..utils import png


def add_model_args(ap, weights_help: str = "a checkpoint of this package (.pth) "
                                          "or a detectron2 .pkl") -> None:
    ap.add_argument("--weights", default="", help=weights_help)
    ap.add_argument("--device", default=None,
                    help="cuda (the default: the card, or an error without one) or cpu")
    ap.add_argument("opts", nargs="*", default=[],
                    help="KEY VALUE pairs that override the config")


def load_cfg(config_file: str, opts: Optional[List[str]] = None):
    from ..config import get_cfg

    cfg = get_cfg()
    if config_file:
        cfg.merge_from_file(config_file)
    if opts:
        cfg.merge_from_list(list(opts))
    cfg.freeze()
    return cfg


def build_and_load(cfg, weights: str = "", device: Optional[str] = None, seed: int = 0):
    """The detector on ``device`` (the card unless ``cpu``), weights from
    ``weights`` where given, else drawn from ``seed``."""
    from ..checkpoint.checkpointer import load_model_weights
    from ..models import build_model

    model = build_model(cfg, device=device, generator=torch.Generator().manual_seed(seed))
    if weights:
        load_model_weights(weights, model)
    return model


def read_bgr(path: str) -> Optional[np.ndarray]:
    """An image file as uint8 BGR (H, W, 3): a PNG by ``utils/png.py`` (no
    codec needed), anything else by ``data/mapper.py:read_image`` (cv2 where
    it is installed). None where the file is missing, as ``cv2.imread``."""
    if not os.path.exists(path):
        return None
    if path.lower().endswith(".png"):
        with open(path, "rb") as f:
            return png_bgr(f.read())
    return read_image({"file_name": path})


def png_bgr(buf: bytes) -> np.ndarray:
    """PNG bytes as uint8 BGR (H, W, 3)."""
    img = png.decode(buf)
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    return np.ascontiguousarray(img[:, :, :3])


class PNGReadingMapper(DatasetMapper):
    """The mapper, with PNG images decoded by ``utils/png.py`` before
    ``read_image`` or a pack's ``cv2.imdecode`` would reach cv2: the tools'
    loaders run on a machine without an image codec. The pixels are the
    same (PNG is lossless). A PNG is read from the config's image pack
    (``USE_NORI``, ``NORI_PATH``) where the pack holds it, else from its
    file."""

    def __call__(self, dataset_dict, rng=None):
        name = dataset_dict.get("file_name", "")
        if "image" not in dataset_dict and name.lower().endswith(".png"):
            base = os.path.basename(name)
            if self.image_pack is not None and base in self.image_pack:
                img = png_bgr(self.image_pack.get(base))
            else:
                img = read_bgr(name)
            dataset_dict = dict(dataset_dict, image=img)
        return super().__call__(dataset_dict, rng=rng)


def write_png(path: str, img: np.ndarray) -> str:
    """``img`` as a PNG at ``path`` with its extension replaced by .png."""
    path = os.path.splitext(path)[0] + ".png"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    png.imwrite(path, img)
    return path


def to_numpy(out) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in out.items()}

"""The data loader's rate, and each mapper stage's host cost (counterpart of
``tools/data_time.py``: the same flags, rows and printed lines).

    python -m slenderobjdet_torch.tools.data_time \\
        --config-file configs/fcos/fcos_R_50_FPN_1x.yaml [--iters 50] \\
        [--workers N] [--batch N] [--decoder auto|cv2|png]
    # generated data, no dataset needed: image files against a RecordPack
    python -m slenderobjdet_torch.tools.data_time --config-file ... \\
        --synthetic 64 [--pack] [--image-hw 480 640] [--decoder png]
    # the mapper's stages an image and the workers a train rate needs
    python -m slenderobjdet_torch.tools.data_time --config-file ... \\
        --stage-budget [--need-masks] [--train-rate 83]

``--decoder`` names the host's image path, and every printed line says which
one ran: ``cv2`` writes and decodes JPEG and resizes with cv2, as the JAX
script does; ``png`` writes PNG with ``utils/png.py``, decodes it there
(``tools/_common.py:PNGReadingMapper``) and resizes with torch
(``data/transforms.py:bilinear_resize``), importing no cv2, as on a machine
without it. ``auto`` (the default) is ``cv2`` where cv2 is installed, else
``png``. A PNG rate is not a JPEG rate: PNG holds these noise images
uncompressed, and its decoder is numpy's.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import os
import tempfile
import time
from typing import List, Optional

import numpy as np

DECODERS = ("auto", "cv2", "png")
DECODER_NAMES = {"cv2": "cv2 JPEG decode, cv2 resize",
                 "png": "utils/png.py PNG decode, torch resize (no cv2)"}


def resolve_decoder(decoder: str) -> str:
    if decoder == "auto":
        return "cv2" if importlib.util.find_spec("cv2") is not None else "png"
    return decoder


@contextlib.contextmanager
def host_path(decoder: str):
    """Under ``png``, the mapper and transforms run with cv2 taken away (the
    modules' ``cv2`` set to None, as on a machine without it), restored on
    exit."""
    from ..data import mapper, transforms

    if decoder != "png":
        yield
        return
    saved = mapper.cv2, transforms.cv2
    mapper.cv2 = transforms.cv2 = None
    try:
        yield
    finally:
        mapper.cv2, transforms.cv2 = saved


def _encode(img: np.ndarray, decoder: str) -> bytes:
    if decoder == "png":
        from ..utils import png

        return png.encode(img, level=1)
    import cv2

    ok, buf = cv2.imencode(".jpg", img)
    assert ok
    return buf.tobytes()


def _decode(buf: bytes, decoder: str) -> np.ndarray:
    if decoder == "png":
        from ._common import png_bgr

        return png_bgr(buf)
    import cv2

    return cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)


def _make_synthetic(root: str, n: int, hw, pack: bool, decoder: str = "cv2"):
    """Random images (JPEG, or PNG under ``png``) and minimal dataset dicts;
    optionally packed into ``root/synth_train.pack``."""
    from ..data.recordpack import AsyncPackWriter

    h, w = hw
    rng = np.random.RandomState(0)
    ext = "png" if decoder == "png" else "jpg"
    dicts = []
    writer = AsyncPackWriter(os.path.join(root, "synth_train.pack")).start() if pack else None
    for i in range(n):
        img = rng.randint(0, 255, (h, w, 3), np.uint8)
        name = f"{i:06d}.{ext}"
        path = os.path.join(root, name)
        buf = _encode(img, decoder)
        if pack:
            writer.write(buf, name)
        else:
            with open(path, "wb") as f:
                f.write(buf)
        dicts.append({
            "file_name": path, "image_id": i, "height": h, "width": w,
            "annotations": [{
                "bbox": [w * 0.2, h * 0.2, w * 0.4, h * 0.4],
                "bbox_mode": 0, "category_id": 0, "iscrowd": 0,
            }],
        })
    if writer is not None:
        writer.close()
    return dicts


def stage_budget(hw, iters, train_rate=83.0, need_masks=False, decoder="cv2"):
    """Host ms an image of each mapper stage (decode, resize-shortest-edge
    to 800, flip, pad-to-bucket, gt assembly, and with ``need_masks`` the
    centre-mask render), measured on this host's CPU, and the mapper cores
    that feed ``train_rate`` img/s. Returns the rows as (name, ms)."""
    from ..data import transforms as T

    h, w = hw
    rng = np.random.RandomState(0)
    img = rng.randint(0, 255, (h, w, 3), np.uint8)
    encoded = _encode(img, decoder)
    boxes0 = np.stack([rng.rand(30) * w * 0.5, rng.rand(30) * h * 0.5,
                       rng.rand(30) * w * 0.5 + w * 0.5,
                       rng.rand(30) * h * 0.5 + h * 0.5], 1).astype(np.float32)

    def timeit(fn):
        fn()  # warm
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3  # ms

    t_decode = timeit(lambda: _decode(encoded, decoder))
    decoded = _decode(encoded, decoder)
    t_resize = timeit(lambda: T.resize_shortest_edge(decoded, boxes0.copy(), 800, 1333))
    resized, boxes1, _ = T.resize_shortest_edge(decoded, boxes0.copy(), 800, 1333)
    t_flip = timeit(lambda: T.horizontal_flip(resized.copy(), boxes1.copy()))
    rh, rw = resized.shape[:2]
    pad_hw = (896, 1333) if rw >= rh else (1333, 896)
    t_pad = timeit(lambda: T.pad_to(resized, pad_hw))

    def gt():
        g = np.zeros((100, 4), np.float32)
        g[:30] = boxes1
        return g

    t_gt = timeit(gt)
    total = t_decode + t_resize + t_flip + t_pad + t_gt
    rows = [("png decode" if decoder == "png" else "jpeg decode", t_decode),
            ("resize-shortest-edge", t_resize), ("hflip", t_flip),
            ("pad-to-bucket", t_pad), ("gt assembly", t_gt)]
    if need_masks:
        from ..structures.borders import BorderMasks

        poly = [np.array([60, 60, 300, 60, 300, 260, 60, 260], np.float64)]
        bm = BorderMasks([poly] * 8)
        t_render = timeit(lambda: bm.center_masks((rh, rw)))
        rows.append(("center-mask render (8 inst)", t_render))
        total += t_render
    per_core = 1000.0 / total
    print(f"host mapper budget at {w}x{h} input -> 800-short-side "
          f"[{DECODER_NAMES[decoder]}]:")
    for name, ms in rows:
        print(f"  {name:26s} {ms:7.2f} ms/img")
    print(f"  {'TOTAL':26s} {total:7.2f} ms/img "
          f"({per_core:.1f} img/s/core)")
    print(f"  -> feeding {train_rate:.0f} img/s needs "
          f"{train_rate / per_core:.1f} mapper cores "
          f"(NUM_WORKERS >= {int(np.ceil(train_rate / per_core))})")
    return rows


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config-file", required=True)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--workers", type=int, default=-1)
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--synthetic", type=int, default=0,
                    help="generate N images instead of using the dataset")
    ap.add_argument("--pack", action="store_true",
                    help="with --synthetic: read from a RecordPack")
    ap.add_argument("--image-hw", type=int, nargs=2, default=(480, 640))
    ap.add_argument("--stage-budget", action="store_true",
                    help="per-image host cost of each mapper stage + the "
                         "NUM_WORKERS requirement (no dataset needed)")
    ap.add_argument("--train-rate", type=float, default=83.0,
                    help="device train img/s the host must feed")
    ap.add_argument("--need-masks", action="store_true",
                    help="with --stage-budget: include center-mask render")
    ap.add_argument("--decoder", default="auto", choices=DECODERS,
                    help="cv2 (JPEG, cv2 resize), png (utils/png.py, torch "
                         "resize, no cv2), or auto: cv2 where it is installed")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    """Returns what it printed: the stage rows, or the loader's rate with
    the first timed batch's shapes."""
    from ..config import get_cfg
    from ..data import DatasetCatalog, build_detection_train_loader
    from ._common import PNGReadingMapper

    args = parse_args(argv)
    decoder = resolve_decoder(args.decoder)
    with host_path(decoder):
        if args.stage_budget:
            rows = stage_budget(tuple(args.image_hw), max(args.iters, 10),
                                args.train_rate, args.need_masks, decoder)
            return {"decoder": decoder, "rows": rows}

        cfg = get_cfg()
        cfg.merge_from_file(args.config_file)
        with tempfile.TemporaryDirectory(prefix="data_time_") as tmpdir:
            if args.synthetic:
                dicts = _make_synthetic(tmpdir, args.synthetic, tuple(args.image_hw),
                                        args.pack, decoder)
                if "synth_train" in DatasetCatalog:
                    DatasetCatalog.remove("synth_train")
                DatasetCatalog.register("synth_train", lambda: dicts)
                cfg.DATASETS.TRAIN = ("synth_train",)
                if args.pack:
                    cfg.USE_NORI = True
                    cfg.NORI_PATH = tmpdir
            if args.workers >= 0:
                cfg.DATALOADER.NUM_WORKERS = args.workers
            if args.batch:
                cfg.SOLVER.IMS_PER_BATCH = args.batch
            cfg.freeze()

            mapper = PNGReadingMapper(cfg, is_train=True) if decoder == "png" else None
            it = build_detection_train_loader(cfg, mapper=mapper)
            next(it)  # warm the pipeline
            t0 = time.perf_counter()
            n_images = 0
            shapes = None
            for _ in range(args.iters):
                b = next(it)
                n_images += b["image"].shape[0]
                shapes = shapes or {k: tuple(np.shape(v)) for k, v in b.items()}
            dt = time.perf_counter() - t0
            it.close()
    print(f"{args.iters} batches / {n_images} images in {dt:.2f}s "
          f"-> {n_images / dt:.1f} img/s, {dt / args.iters * 1000:.1f} ms/batch "
          f"[{DECODER_NAMES[decoder]}]")
    return {"decoder": decoder, "batches": args.iters, "images": n_images,
            "seconds": dt, "img_s": n_images / dt, "shapes": shapes}


if __name__ == "__main__":
    main()

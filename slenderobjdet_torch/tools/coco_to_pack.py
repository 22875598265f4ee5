"""Pack a COCO-format dataset into self-indexing RecordPacks for fast
host-side loading.

Counterpart of the reference's dataset-packing pair `tools/coco_to_nori.py`
(images -> nori pack) + `tools/nori_to_redis.py` (filename -> data-id hash
into redis): a RecordPack carries its index in the file footer, so the
second step, and the redis service, disappear. With `--sizes`, also
pre-renders the BorderMasks supervision maps (center/border/sizes) into
`<out stem>_sizes.pack`, the analog of the reference's `<split>_sizes.nori`
consumed by `BorderMaskMapper` (`bm_mapper.py:55-57`). The port's
counterpart of the JAX package's `tools/coco_to_pack.py`: the same packs,
rendered by the port's `structures/borders.py`; it needs no card.

Usage:
  python -m slenderobjdet_torch.tools.coco_to_pack \\
      --gt-json instances_train.json --image-root images/ \\
      --out packs/coco_2017_train.pack [--sizes] [--max-images N]

Then point the loader at it:
  USE_NORI: True
  NORI_PATH: packs/            # <split>.pack per DATASETS.{TRAIN,TEST} name
"""

from __future__ import annotations

import argparse
import io
import os

import numpy as np

from ..data.recordpack import AsyncPackWriter
from ..evaluation.coco_api import COCO
from ..structures.borders import BorderMasks


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gt-json", required=True)
    ap.add_argument("--image-root", required=True)
    ap.add_argument("--out", required=True, help="output .pack path")
    ap.add_argument("--sizes", action="store_true",
                    help="also render center/border/sizes maps into "
                         "<out stem>_sizes.pack")
    ap.add_argument("--max-images", type=int, default=0)
    args = ap.parse_args(argv)

    coco = COCO(args.gt_json)
    img_ids = sorted(coco.imgs)
    if args.max_images:
        img_ids = img_ids[: args.max_images]

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    sizes_out = None
    if args.sizes:
        stem, ext = os.path.splitext(args.out)
        sizes_out = stem + "_sizes" + ext

    n_img = n_sizes = 0
    with AsyncPackWriter(args.out) as images:
        sizes_writer = AsyncPackWriter(sizes_out).start() if sizes_out else None
        try:
            for img_id in img_ids:
                info = coco.imgs[img_id]
                name = os.path.basename(info["file_name"])
                path = os.path.join(args.image_root, info["file_name"])
                with open(path, "rb") as f:
                    images.write(f.read(), name)
                n_img += 1

                if sizes_writer is None:
                    continue
                anns = [a for a in coco.imgToAnns.get(img_id, [])
                        if not a.get("iscrowd", 0)]
                polys = [
                    [np.asarray(p, np.float64) for p in a["segmentation"]
                     if len(p) >= 6]
                    for a in anns
                    if isinstance(a.get("segmentation"), list)
                ]
                polys = [p for p in polys if p]
                if not polys:
                    continue
                masks = BorderMasks(polys)
                hw = (info["height"], info["width"])
                center = masks.center_masks(hw, standard="gaussian",
                                            sigma=0.5)
                border, _, sizes = masks.masks(hw)
                buf = io.BytesIO()
                np.savez_compressed(buf, center=center, border=border,
                                    sizes=sizes)
                sizes_writer.write(buf.getvalue(), name)
                n_sizes += 1
        finally:
            if sizes_writer is not None:
                sizes_writer.close()

    print(f"packed {n_img} images -> {args.out}"
          + (f"; {n_sizes} size-map records -> {sizes_out}"
             if sizes_out else ""),
          flush=True)


if __name__ == "__main__":
    main()

"""Self-contained COCO annotation API (numpy/stdlib only — pycocotools is not
a dependency of this framework). A copy of
``slenderobjdet_tpu/evaluation/coco_api.py``, held equal to it by
``tests/test_torch_eval.py``.

Implements the subset of the pycocotools `COCO` interface the evaluator needs
(createIndex / getAnnIds / getCatIds / getImgIds / loadAnns / loadRes), plus
the reference fork's extension (`slender_det/evaluation/coco.py:14-106`):
every annotation gets a `ratio` — the slenderness min(w,h)/max(w,h) of the
oriented min-area rect of its segmentation (bbox fallback) — computed at
index time.
"""

from __future__ import annotations

import copy
import json
import time
from collections import defaultdict
from typing import Dict, List, Optional, Union


from ..structures.masks import compute_ann_ratio


class COCO:
    def __init__(self, annotation_file: Optional[Union[str, dict]] = None,
                 oriented: bool = True):
        self.oriented = oriented
        self.dataset: dict = {}
        self.anns: Dict[int, dict] = {}
        self.cats: Dict[int, dict] = {}
        self.imgs: Dict[int, dict] = {}
        self.imgToAnns: Dict[int, List[dict]] = defaultdict(list)
        self.catToImgs: Dict[int, List[int]] = defaultdict(list)
        if annotation_file is not None:
            if isinstance(annotation_file, dict):
                self.dataset = annotation_file
            else:
                tic = time.time()
                with open(annotation_file, "r") as f:
                    self.dataset = json.load(f)
                print(f"loading annotations took {time.time() - tic:.2f}s")
            assert isinstance(self.dataset, dict)
            self.createIndex()

    def createIndex(self):
        anns, cats, imgs = {}, {}, {}
        imgToAnns, catToImgs = defaultdict(list), defaultdict(list)
        for ann in self.dataset.get("annotations", []):
            imgToAnns[ann["image_id"]].append(ann)
            if "ratio" not in ann:
                ann["ratio"] = compute_ann_ratio(ann, oriented=self.oriented)
            anns[ann["id"]] = ann
        for img in self.dataset.get("images", []):
            imgs[img["id"]] = img
        for cat in self.dataset.get("categories", []):
            cats[cat["id"]] = cat
        for ann in self.dataset.get("annotations", []):
            catToImgs[ann["category_id"]].append(ann["image_id"])

        self.anns, self.cats, self.imgs = anns, cats, imgs
        self.imgToAnns, self.catToImgs = imgToAnns, catToImgs

    # ------------------------------------------------------------- queries
    def getAnnIds(self, imgIds=[], catIds=[], areaRng=[], iscrowd=None):
        imgIds = imgIds if isinstance(imgIds, (list, tuple)) else [imgIds]
        catIds = catIds if isinstance(catIds, (list, tuple)) else [catIds]

        if len(imgIds) == 0 and len(catIds) == 0 and len(areaRng) == 0:
            anns = self.dataset.get("annotations", [])
        else:
            if len(imgIds) > 0:
                lists = [self.imgToAnns[i] for i in imgIds if i in self.imgToAnns]
                anns = [a for sub in lists for a in sub]
            else:
                anns = self.dataset.get("annotations", [])
            if len(catIds) > 0:
                catset = set(catIds)
                anns = [a for a in anns if a["category_id"] in catset]
            if len(areaRng) > 0:
                anns = [a for a in anns if areaRng[0] < a["area"] < areaRng[1]]
        if iscrowd is not None:
            return [a["id"] for a in anns if a.get("iscrowd", 0) == iscrowd]
        return [a["id"] for a in anns]

    def getCatIds(self, catNms=[], supNms=[], catIds=[]):
        cats = list(self.dataset.get("categories", []))
        if catNms:
            cats = [c for c in cats if c["name"] in catNms]
        if supNms:
            cats = [c for c in cats if c.get("supercategory") in supNms]
        if catIds:
            cats = [c for c in cats if c["id"] in catIds]
        return [c["id"] for c in cats]

    def getImgIds(self, imgIds=[], catIds=[]):
        imgIds = set(imgIds if isinstance(imgIds, (list, tuple)) else [imgIds])
        catIds = catIds if isinstance(catIds, (list, tuple)) else [catIds]
        if not imgIds and not catIds:
            return list(self.imgs.keys())
        ids = imgIds if imgIds else set()
        for i, catId in enumerate(catIds):
            s = set(self.catToImgs[catId])
            ids = s if (i == 0 and not ids) else (ids & s if catIds else ids)
        return list(ids if ids else self.imgs.keys())

    def loadAnns(self, ids=[]):
        if isinstance(ids, (list, tuple)):
            return [self.anns[i] for i in ids]
        return [self.anns[ids]]

    def loadCats(self, ids=[]):
        if isinstance(ids, (list, tuple)):
            return [self.cats[i] for i in ids]
        return [self.cats[ids]]

    def loadImgs(self, ids=[]):
        if isinstance(ids, (list, tuple)):
            return [self.imgs[i] for i in ids]
        return [self.imgs[ids]]

    # ------------------------------------------------------------- results
    def loadRes(self, resFile) -> "COCO":
        """Load detection results (list of dicts or a json path) as a COCO
        object sharing this one's images/categories."""
        res = COCO(oriented=self.oriented)
        res.dataset["images"] = [img for img in self.dataset.get("images", [])]

        if isinstance(resFile, str):
            with open(resFile) as f:
                anns = json.load(f)
        else:
            anns = resFile
        assert isinstance(anns, list), "results must be a list"
        if len(anns) == 0:
            res.dataset["annotations"] = []
            res.dataset["categories"] = copy.deepcopy(
                self.dataset.get("categories", [])
            )
            res.createIndex()
            return res

        annsImgIds = [ann["image_id"] for ann in anns]
        assert set(annsImgIds) == (set(annsImgIds) & set(self.getImgIds())), (
            "Results do not correspond to current coco set"
        )
        res.dataset["categories"] = copy.deepcopy(self.dataset.get("categories", []))
        if "bbox" in anns[0] and anns[0]["bbox"] != []:
            for idx, ann in enumerate(anns):
                bb = ann["bbox"]
                if "segmentation" not in ann:
                    ann["segmentation"] = [
                        [bb[0], bb[1], bb[0], bb[1] + bb[3],
                         bb[0] + bb[2], bb[1] + bb[3], bb[0] + bb[2], bb[1]]
                    ]
                ann["area"] = bb[2] * bb[3]
                ann["id"] = idx + 1
                ann["iscrowd"] = 0
        res.dataset["annotations"] = anns
        res.createIndex()
        return res

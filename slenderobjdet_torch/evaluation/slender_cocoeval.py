"""Slender (aspect-ratio-bucketed) COCO detection evaluation.

Ground-up numpy implementation of the COCO evaluation protocol with the
reference fork's modification (`slender_det/evaluation/cocoeval.py:11-566`):
the area-range ignore dimension is replaced by ASPECT-RATIO ranges

    all, 0-1/5, 1/5-1/3, 1/3-3, 3-5, 5-INF   (cocoeval.py:539-541)

with gt bucketed by its oriented-rect slenderness `ratio` (cocoeval.py:257)
and unmatched dt bucketed by bbox w/h (cocoeval.py:306-310). Everything else
follows the standard protocol exactly: greedy per-(img,cat) matching in score
order (mergesort ties), crowd gts matchable many times, 101-point
interpolated precision, stats[0:3] therefore equal the standard COCO
AP/AP50/AP75.

No pycocotools dependency; bbox IoU (with the crowd intersection-over-dt-area
rule) is implemented here in numpy. A copy of
``slenderobjdet_tpu/evaluation/slender_cocoeval.py``, held equal to it by
``tests/test_torch_eval.py``.
"""

from __future__ import annotations

import copy
import time
from collections import defaultdict
from typing import Dict, List

import numpy as np


def bbox_iou_xywh(dt: np.ndarray, gt: np.ndarray, iscrowd: List[int]) -> np.ndarray:
    """IoU between dt (D,4) and gt (G,4) boxes in XYWH; for crowd gt the
    denominator is the dt area (pycocotools maskUtils.iou semantics)."""
    dt = np.asarray(dt, np.float64).reshape(-1, 4)
    gt = np.asarray(gt, np.float64).reshape(-1, 4)
    D, G = len(dt), len(gt)
    ious = np.zeros((D, G), np.float64)
    if D == 0 or G == 0:
        return ious
    dx1, dy1 = dt[:, 0], dt[:, 1]
    dx2, dy2 = dt[:, 0] + dt[:, 2], dt[:, 1] + dt[:, 3]
    gx1, gy1 = gt[:, 0], gt[:, 1]
    gx2, gy2 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]
    darea = dt[:, 2] * dt[:, 3]
    garea = gt[:, 2] * gt[:, 3]
    iw = np.minimum(dx2[:, None], gx2[None, :]) - np.maximum(dx1[:, None], gx1[None, :])
    ih = np.minimum(dy2[:, None], gy2[None, :]) - np.maximum(dy1[:, None], gy1[None, :])
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    crowd = np.asarray(iscrowd, bool)
    union = darea[:, None] + np.where(crowd[None, :], 0.0, garea[None, :]) - np.where(
        crowd[None, :], 0.0, inter
    )
    # crowd: union := dt area
    with np.errstate(divide="ignore", invalid="ignore"):
        ious = np.where(union > 0, inter / union, 0.0)
    return ious


class SlenderParams:
    def __init__(self):
        self.imgIds: List = []
        self.catIds: List = []
        self.iouThrs = np.linspace(0.5, 0.95, int(np.round((0.95 - 0.5) / 0.05)) + 1,
                                   endpoint=True)
        self.recThrs = np.linspace(0.0, 1.00, int(np.round((1.00 - 0.0) / 0.01)) + 1,
                                   endpoint=True)
        self.maxDets = [1, 10, 100]
        self.aptrtoRng = [
            [0.0, 1e5], [0.0, 1 / 5], [1 / 5, 1 / 3], [1 / 3, 3.0], [3.0, 5.0],
            [5.0, 1e5],
        ]
        self.aptrtoRngLbl = ["all", " 0  - 1/5", "1/5 - 1/3", "1/3 - 3",
                             "3/1 - 5/1", "5/1 - INF"]
        self.useCats = 1
        self.iouType = "bbox"


class SlenderCOCOeval:
    """Drop-in counterpart of the reference's forked COCOeval (bbox only)."""

    def __init__(self, cocoGt=None, cocoDt=None, iouType: str = "bbox"):
        assert iouType == "bbox", "only bbox AP is evaluated"
        self.cocoGt = cocoGt
        self.cocoDt = cocoDt
        self.params = SlenderParams()
        self.evalImgs = []
        self.eval: Dict = {}
        self.stats: np.ndarray = np.array([])
        self.ious: Dict = {}
        self._gts = defaultdict(list)
        self._dts = defaultdict(list)
        if cocoGt is not None:
            self.params.imgIds = sorted(cocoGt.getImgIds())
            self.params.catIds = sorted(cocoGt.getCatIds())

    # ------------------------------------------------------------ evaluate
    def _prepare(self):
        p = self.params
        gts = self.cocoGt.loadAnns(
            self.cocoGt.getAnnIds(imgIds=p.imgIds, catIds=p.catIds)
        )
        dts = self.cocoDt.loadAnns(
            self.cocoDt.getAnnIds(imgIds=p.imgIds, catIds=p.catIds)
        )
        gts = copy.deepcopy(gts)
        for gt in gts:
            gt["ignore"] = 1 if gt.get("iscrowd", 0) else 0
        self._gts = defaultdict(list)
        self._dts = defaultdict(list)
        for gt in gts:
            self._gts[gt["image_id"], gt["category_id"]].append(gt)
        for dt in dts:
            self._dts[dt["image_id"], dt["category_id"]].append(dt)
        self.evalImgs = []

    def computeIoU(self, imgId, catId):
        gt = self._gts[imgId, catId]
        dt = self._dts[imgId, catId]
        if len(gt) == 0 and len(dt) == 0:
            return []
        inds = np.argsort([-d["score"] for d in dt], kind="mergesort")
        dt = [dt[i] for i in inds]
        maxDet = self.params.maxDets[-1]
        if len(dt) > maxDet:
            dt = dt[:maxDet]
        g = np.array([x["bbox"] for x in gt], np.float64).reshape(-1, 4)
        d = np.array([x["bbox"] for x in dt], np.float64).reshape(-1, 4)
        iscrowd = [int(x.get("iscrowd", 0)) for x in gt]
        return bbox_iou_xywh(d, g, iscrowd)

    def evaluate(self):
        tic = time.time()
        p = self.params
        p.imgIds = list(np.unique(p.imgIds))
        if p.useCats:
            p.catIds = list(np.unique(p.catIds))
        self._prepare()
        catIds = p.catIds if p.useCats else [-1]
        self.ious = {
            (imgId, catId): self.computeIoU(imgId, catId)
            for imgId in p.imgIds
            for catId in catIds
        }
        maxDet = p.maxDets[-1]

        use_native = getattr(self, "use_native", None)
        if use_native is None:
            from . import native

            use_native = native.available()
        if use_native:
            self._evaluate_native(catIds, maxDet)
        else:
            self.evalImgs = [
                self.evaluateImg(imgId, catId, aRng, maxDet)
                for catId in catIds
                for aRng in p.aptrtoRng
                for imgId in p.imgIds
            ]
        self._paramsEval = copy.deepcopy(self.params)
        print(f"COCOeval evaluate done (t={time.time() - tic:0.2f}s)")

    def _evaluate_native(self, catIds, maxDet):
        """Same evalImgs as the numpy path, computed by the C matching
        kernel (evaluation/csrc/slender_eval.c): one call per non-empty
        (image, category) pair covers every ratio range and IoU threshold;
        bit-parity is enforced by tests/test_native_eval.py."""
        from . import native

        p = self.params
        A = len(p.aptrtoRng)
        rng_lo = np.array([r[0] for r in p.aptrtoRng], np.float64)
        rng_hi = np.array([r[1] for r in p.aptrtoRng], np.float64)

        per_pair: Dict = {}
        for catId in catIds:
            for imgId in p.imgIds:
                gt = self._gts[imgId, catId]
                dt = self._dts[imgId, catId]
                if len(gt) == 0 and len(dt) == 0:
                    per_pair[imgId, catId] = [None] * A
                    continue
                dtind = np.argsort([-d["score"] for d in dt], kind="mergesort")
                dts = [dt[i] for i in dtind[:maxDet]]
                ious = self.ious[imgId, catId]
                D, G = len(dts), len(gt)
                dtm, gtm, dt_ig, gt_ig, gt_order = native.match_pair(
                    p.iouThrs, rng_lo, rng_hi,
                    np.asarray(ious, np.float64).reshape(D, G),
                    np.array([g["ratio"] for g in gt], np.float64),
                    np.array([int(g.get("iscrowd", 0)) for g in gt], np.uint8),
                    np.array([g["ignore"] for g in gt], np.uint8),
                    np.array([g["id"] for g in gt], np.int64),
                    np.array([d["id"] for d in dts], np.int64),
                    np.array(
                        [d["bbox"][2] / d["bbox"][3] if d["bbox"][3] > 0
                         else 0.0 for d in dts], np.float64),
                )
                gt_ids = np.array([g["id"] for g in gt], np.int64)
                dt_scores = [d["score"] for d in dts]
                dt_ids = [d["id"] for d in dts]
                per_pair[imgId, catId] = [
                    {
                        "image_id": imgId,
                        "category_id": catId,
                        "aRng": p.aptrtoRng[a],
                        "maxDet": maxDet,
                        "dtIds": dt_ids,
                        "gtIds": gt_ids[gt_order[a]].tolist(),
                        "dtMatches": dtm[a],
                        "gtMatches": gtm[a],
                        "dtScores": dt_scores,
                        "gtIgnore": gt_ig[a].astype(np.int64),
                        "dtIgnore": dt_ig[a].astype(bool),
                    }
                    for a in range(A)
                ]

        self.evalImgs = [
            per_pair[imgId, catId][a]
            for catId in catIds
            for a in range(A)
            for imgId in p.imgIds
        ]

    def evaluateImg(self, imgId, catId, aRng, maxDet):
        gt = self._gts[imgId, catId]
        dt = self._dts[imgId, catId]
        if len(gt) == 0 and len(dt) == 0:
            return None

        p = self.params
        for g in gt:
            ratio = g["ratio"]
            g["_ignore"] = 1 if (g["ignore"] or ratio < aRng[0] or ratio > aRng[1]) else 0

        gtind = np.argsort([g["_ignore"] for g in gt], kind="mergesort")
        gt = [gt[i] for i in gtind]
        dtind = np.argsort([-d["score"] for d in dt], kind="mergesort")
        dt = [dt[i] for i in dtind[:maxDet]]
        iscrowd = [int(o.get("iscrowd", 0)) for o in gt]
        ious = (
            self.ious[imgId, catId][:, gtind]
            if len(self.ious[imgId, catId]) > 0
            else self.ious[imgId, catId]
        )

        T = len(p.iouThrs)
        G = len(gt)
        D = len(dt)
        gtm = np.zeros((T, G))
        dtm = np.zeros((T, D))
        gtIg = np.array([g["_ignore"] for g in gt])
        dtIg = np.zeros((T, D))
        if len(ious) > 0:
            for tind, t in enumerate(p.iouThrs):
                for dind, d in enumerate(dt):
                    iou = min(t, 1 - 1e-10)
                    m = -1
                    for gind in range(G):
                        if gtm[tind, gind] > 0 and not iscrowd[gind]:
                            continue
                        if m > -1 and gtIg[m] == 0 and gtIg[gind] == 1:
                            break
                        if ious[dind, gind] < iou:
                            continue
                        iou = ious[dind, gind]
                        m = gind
                    if m == -1:
                        continue
                    dtIg[tind, dind] = gtIg[m]
                    dtm[tind, dind] = gt[m]["id"]
                    gtm[tind, m] = d["id"]
        # unmatched dts outside the ratio range are ignored; dt bucketing uses
        # raw bbox w/h (reference cocoeval.py:306-310)
        ratios = [d["bbox"][2] / d["bbox"][3] if d["bbox"][3] > 0 else 0.0 for d in dt]
        out = np.array(
            [r < aRng[0] or r > aRng[1] for r in ratios]
        ).reshape(1, D)
        dtIg = np.logical_or(dtIg, np.logical_and(dtm == 0, np.repeat(out, T, 0)))
        return {
            "image_id": imgId,
            "category_id": catId,
            "aRng": aRng,
            "maxDet": maxDet,
            "dtIds": [d["id"] for d in dt],
            "gtIds": [g["id"] for g in gt],
            "dtMatches": dtm,
            "gtMatches": gtm,
            "dtScores": [d["score"] for d in dt],
            "gtIgnore": gtIg,
            "dtIgnore": dtIg,
        }

    # ---------------------------------------------------------- accumulate
    def accumulate(self, p=None):
        tic = time.time()
        assert self.evalImgs, "run evaluate() first"
        if p is None:
            p = self.params
        p.catIds = p.catIds if p.useCats == 1 else [-1]
        T, R = len(p.iouThrs), len(p.recThrs)
        K = len(p.catIds) if p.useCats else 1
        A, M = len(p.aptrtoRng), len(p.maxDets)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        scores = -np.ones((T, R, K, A, M))

        _pe = self._paramsEval
        setK = set(_pe.catIds if _pe.useCats else [-1])
        setA = set(map(tuple, _pe.aptrtoRng))
        setM = set(_pe.maxDets)
        setI = set(_pe.imgIds)
        k_list = [n for n, k in enumerate(p.catIds) if k in setK]
        m_list = [m for m in p.maxDets if m in setM]
        a_list = [n for n, a in enumerate(map(tuple, p.aptrtoRng)) if a in setA]
        i_list = [n for n, i in enumerate(p.imgIds) if i in setI]
        I0 = len(_pe.imgIds)
        A0 = len(_pe.aptrtoRng)

        for k, k0 in enumerate(k_list):
            Nk = k0 * A0 * I0
            for a, a0 in enumerate(a_list):
                Na = a0 * I0
                for m, maxDet in enumerate(m_list):
                    E = [self.evalImgs[Nk + Na + i] for i in i_list]
                    E = [e for e in E if e is not None]
                    if len(E) == 0:
                        continue
                    dtScores = np.concatenate([e["dtScores"][:maxDet] for e in E])
                    inds = np.argsort(-dtScores, kind="mergesort")
                    dtScoresSorted = dtScores[inds]

                    dtm = np.concatenate(
                        [e["dtMatches"][:, :maxDet] for e in E], axis=1
                    )[:, inds]
                    dtIg = np.concatenate(
                        [e["dtIgnore"][:, :maxDet] for e in E], axis=1
                    )[:, inds]
                    gtIg = np.concatenate([e["gtIgnore"] for e in E])
                    npig = np.count_nonzero(gtIg == 0)
                    if npig == 0:
                        continue
                    tps = np.logical_and(dtm, np.logical_not(dtIg))
                    fps = np.logical_and(
                        np.logical_not(dtm), np.logical_not(dtIg)
                    )
                    tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
                    fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
                    for t, (tp, fp) in enumerate(zip(tp_sum, fp_sum)):
                        nd = len(tp)
                        rc = tp / npig
                        pr = tp / (fp + tp + np.spacing(1))
                        q = np.zeros((R,))
                        ss = np.zeros((R,))
                        recall[t, k, a, m] = rc[-1] if nd else 0
                        # precision envelope: pr[i-1] = max(pr[i-1], pr[i])
                        # backward == reversed cumulative max (bit-identical
                        # to pycocotools' python loop)
                        pr = np.maximum.accumulate(pr[::-1])[::-1]
                        inds_r = np.searchsorted(rc, p.recThrs, side="left")
                        # pycocotools stops filling at the first
                        # out-of-range index (try/except IndexError)
                        valid_n = int(np.searchsorted(inds_r, nd, side="left"))
                        pi = inds_r[:valid_n]
                        q[:valid_n] = pr[pi]
                        ss[:valid_n] = dtScoresSorted[pi]
                        precision[t, :, k, a, m] = q
                        scores[t, :, k, a, m] = ss
        self.eval = {
            "params": p,
            "counts": [T, R, K, A, M],
            "precision": precision,
            "recall": recall,
            "scores": scores,
        }
        print(f"COCOeval accumulate done (t={time.time() - tic:0.2f}s)")

    # ----------------------------------------------------------- summarize
    def _summarize(self, ap=1, iouThr=None, aptrtoRng="all", maxDets=100):
        p = self.params
        iStr = " {:<18} {} @[ IoU={:<9} | w/h={:>9s} | maxDets={:>3d} ] = {:0.3f}"
        titleStr = "Average Precision" if ap == 1 else "Average Recall"
        typeStr = "(AP)" if ap == 1 else "(AR)"
        iouStr = (
            f"{p.iouThrs[0]:0.2f}:{p.iouThrs[-1]:0.2f}"
            if iouThr is None
            else f"{iouThr:0.2f}"
        )
        aind = [i for i, a in enumerate(p.aptrtoRngLbl) if a == aptrtoRng]
        mind = [i for i, m in enumerate(p.maxDets) if m == maxDets]
        if ap == 1:
            s = self.eval["precision"]
            if iouThr is not None:
                s = s[np.where(iouThr == p.iouThrs)[0]]
            s = s[:, :, :, aind, mind]
        else:
            s = self.eval["recall"]
            if iouThr is not None:
                s = s[np.where(iouThr == p.iouThrs)[0]]
            s = s[:, :, aind, mind]
        mean_s = -1 if len(s[s > -1]) == 0 else np.mean(s[s > -1])
        print(iStr.format(titleStr, typeStr, iouStr, aptrtoRng, maxDets, mean_s))
        return mean_s

    def summarize(self):
        assert self.eval, "run accumulate() first"
        p = self.params
        stats = [
            self._summarize(1),
            self._summarize(1, iouThr=0.5, maxDets=p.maxDets[2]),
            self._summarize(1, iouThr=0.75, maxDets=p.maxDets[2]),
            self._summarize(1, aptrtoRng=" 0  - 1/5", maxDets=p.maxDets[2]),
            self._summarize(1, aptrtoRng="1/5 - 1/3", maxDets=p.maxDets[2]),
            self._summarize(1, aptrtoRng="1/3 - 3", maxDets=p.maxDets[2]),
            self._summarize(1, aptrtoRng="3/1 - 5/1", maxDets=p.maxDets[2]),
            self._summarize(1, aptrtoRng="5/1 - INF", maxDets=p.maxDets[2]),
            self._summarize(0, maxDets=p.maxDets[0]),
            self._summarize(0, maxDets=p.maxDets[1]),
            self._summarize(0, maxDets=p.maxDets[2]),
            self._summarize(0, aptrtoRng=" 0  - 1/5", maxDets=p.maxDets[2]),
            self._summarize(0, aptrtoRng="1/5 - 1/3", maxDets=p.maxDets[2]),
            self._summarize(0, aptrtoRng="1/3 - 3", maxDets=p.maxDets[2]),
            self._summarize(0, aptrtoRng="3/1 - 5/1", maxDets=p.maxDets[2]),
            self._summarize(0, aptrtoRng="5/1 - INF", maxDets=p.maxDets[2]),
        ]
        self.stats = np.array(stats)
        return self.stats

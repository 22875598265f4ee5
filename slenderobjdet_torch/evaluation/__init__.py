from .coco_api import COCO
from .coco_evaluation import COCOEvaluator, COCOEvaluatorWithAnchors
from .evaluator import inference_on_dataset
from .slender_cocoeval import SlenderCOCOeval

__all__ = ["COCO", "COCOEvaluator",
    "COCOEvaluatorWithAnchors", "inference_on_dataset", "SlenderCOCOeval"]

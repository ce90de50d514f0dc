from pod_compare_tpu_torch.inference.core import Candidates, Detections
from pod_compare_tpu_torch.inference.postprocess import detections_to_json
from pod_compare_tpu_torch.inference.predictor import (
    ProbabilisticPredictor,
    build_predictor,
)

__all__ = [
    "Candidates",
    "Detections",
    "ProbabilisticPredictor",
    "build_predictor",
    "detections_to_json",
]

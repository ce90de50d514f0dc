from pod_compare_tpu_torch.inference.core import (
    Candidates,
    Detections,
    classification_probs,
    pick_chunk,
    probabilistic_inference_core,
    sampled_box_moments,
)
from pod_compare_tpu_torch.inference.modes import (
    anchor_statistics,
    bayes_od,
    black_box_merge,
    concatenate_detections,
    standard_nms,
)
from pod_compare_tpu_torch.inference.postprocess import detections_to_json
from pod_compare_tpu_torch.inference.predictor import (
    MODES,
    ProbabilisticPredictor,
    build_predictor,
)

__all__ = [
    "Candidates",
    "Detections",
    "MODES",
    "ProbabilisticPredictor",
    "anchor_statistics",
    "bayes_od",
    "black_box_merge",
    "build_predictor",
    "classification_probs",
    "concatenate_detections",
    "detections_to_json",
    "pick_chunk",
    "probabilistic_inference_core",
    "sampled_box_moments",
    "standard_nms",
]

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
from pod_compare_tpu_torch.inference.export import load_artifact, save_artifact
from pod_compare_tpu_torch.inference.postprocess import detections_to_json

# The predictor imports the model code, which a serving host that loads an
# artifact (inference/export.py) goes without: it is imported at first use.
_PREDICTOR_NAMES = ("MODES", "ProbabilisticPredictor", "build_predictor")


def __getattr__(name):
    if name in _PREDICTOR_NAMES:
        from pod_compare_tpu_torch.inference import predictor

        return getattr(predictor, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


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
    "load_artifact",
    "pick_chunk",
    "probabilistic_inference_core",
    "sampled_box_moments",
    "save_artifact",
    "standard_nms",
]

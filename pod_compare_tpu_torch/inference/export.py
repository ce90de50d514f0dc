"""Serving export: one predictor's whole pipeline as a saved ``ExportedProgram``.

Counterpart of ``pod_compare_tpu/inference/export.py``. ``torch.export``
captures the predictor's forward (``predictor.PipelineModule``: uint8
canvas -> normalize -> R50-FPN -> the head bank -> the candidate core -> the
mode or the post-NMS merge -> rescale) once, at export time, and
``torch.export.save`` writes it with its weights. The serving host needs
torch and this package's operators, ``pod_compare_tpu_torch::dropout_levels``
(the dropout kernel of ``csrc/dropout.cu`` on CUDA, one node and one launch
per (run, tower, layer) over the FPN levels; ``::dropout``, its one-tensor
form, which programs saved before it call),
``pod_compare_tpu_torch::normal`` (the normals of the Monte-Carlo sampling
impls, ``csrc/normal.cu`` on CUDA) and
``pod_compare_tpu_torch::greedy_sequential_clusters`` (the post-NMS merge's
loop), which importing this module registers; the kernels are built at
their first launch. It needs no config, no model code, no predictor and no
retrace.

Artifact layout (a directory):
    pipeline.pt2    the ExportedProgram: graph and weights
    manifest.json   metadata: mode, geometry, batch, device, torch version,
                    the operators it calls, config provenance

The program takes (images (B, H, W, 3) uint8 on the device, input_sizes and
output_sizes (B, 2) float32 on the device, dropout_seeds (M, 2, num_convs)
int64 on the CPU) and, when CLS_SAMPLING or BOX_SAMPLING is a Monte-Carlo
impl, a fifth input, sampling_seeds (B,) or, on the post-NMS paths, (B, M)
int64 on the CPU (`manifest["sampling_seeds_shape"]`; null for an analytic
program, which keeps four inputs). It returns the `Detections` fields that
are not None, as a plain tuple, in the order of
`manifest["detections_fields"]`. The seeds are inputs, so every served call
draws fresh masks and normals: `ServingPredictor` draws them from its
generator as the live predictor does (``seeds.draw_call_seeds``), and the
two agree bit for bit.

An ExportedProgram is made for one device, where the JAX artifact may carry
the lowerings of several platforms: a program exported for CUDA is served
on CUDA, and nowhere else. Members placed on more than one device are
refused: export the single-device pipeline and serve several cards by
copying the artifact.

Use ``pod_compare_tpu_torch.cli.export_model`` to write one from a trained
checkpoint, and `load_artifact` to serve from it.
"""

import json
import os
import time
from typing import Optional

import torch
from torch import nn

# The operators the program calls: importing their modules registers them.
from pod_compare_tpu_torch.ops import fusion as _fusion  # noqa: F401
from pod_compare_tpu_torch.ops.kernels import dropout as _dropout  # noqa: F401
from pod_compare_tpu_torch.ops.kernels import normal as _normal  # noqa: F401
from pod_compare_tpu_torch.inference.core import Detections
from pod_compare_tpu_torch.inference.seeds import draw_call_seeds

FORMAT = "pod_compare_tpu_torch.serving/1"
REQUIRED_OPS = ("pod_compare_tpu_torch::dropout",
                "pod_compare_tpu_torch::dropout_levels",
                "pod_compare_tpu_torch::greedy_sequential_clusters",
                "pod_compare_tpu_torch::normal")
_PIPELINE_FILE = "pipeline.pt2"
_MANIFEST_FILE = "manifest.json"


class _Serving(nn.Module):
    """The pipeline with its Detections as a plain tuple of the fields that
    are not None; the trace appends their names to the list `fields`."""

    def __init__(self, pipeline: nn.Module, fields: list):
        super().__init__()
        self.pipeline = pipeline
        self.fields = fields

    def forward(self, images, input_sizes, output_sizes, dropout_seeds, sampling_seeds=None):
        dets = self.pipeline(images, input_sizes, output_sizes, dropout_seeds, sampling_seeds)
        self.fields[:] = [name for name, f in zip(Detections._fields, dets) if f is not None]
        return tuple(f for f in dets if f is not None)


def _example_inputs(pipeline, batch_size: int):
    """The program's inputs: four, and sampling_seeds where the pipeline
    samples."""
    h, w = pipeline.image_size
    device = pipeline.device
    sizes = lambda: torch.tensor([[h, w]] * batch_size, dtype=torch.float32, device=device)
    inputs = (
        torch.zeros((batch_size, h, w, 3), dtype=torch.uint8, device=device),
        sizes(),
        sizes(),
        torch.zeros((pipeline.num_runs, 2, pipeline.num_convs), dtype=torch.int64),
    )
    if pipeline.sampled:
        inputs += (torch.zeros(pipeline.sampling_seeds_shape(batch_size), dtype=torch.int64),)
    return inputs


def _export(predictor, batch_size: int, device=None):
    """(ExportedProgram, names of the Detections fields it returns)."""
    pipeline = predictor.pipeline
    if len(set(pipeline.member_devices)) > 1:
        raise ValueError(
            f"export_predictor captures one device's pipeline, and these members are placed "
            f"on {sorted(set(map(str, pipeline.member_devices)))}: export the single-device "
            f"pipeline; serve several cards by copying the artifact"
        )
    if device is not None and torch.device(device) != pipeline.device:
        raise ValueError(f"the predictor runs on {pipeline.device}, not on {device}: "
                         f"build it on the device the artifact is for")
    fields = []
    with torch.no_grad():
        exported = torch.export.export(_Serving(pipeline, fields).eval(),
                                       _example_inputs(pipeline, batch_size), strict=False)
    return exported, fields


def export_predictor(predictor, batch_size: int, device=None) -> torch.export.ExportedProgram:
    """Capture one predictor's pipeline at `batch_size` as an ExportedProgram
    for its device (`device`, when given, must be that device)."""
    return _export(predictor, batch_size, device)[0]


def save_artifact(predictor, out_dir: str, batch_size: int, device=None,
                  extra_manifest: Optional[dict] = None) -> str:
    """Export `predictor` and write the serving artifact directory."""
    t0 = time.perf_counter()
    exported, fields = _export(predictor, batch_size, device)
    export_seconds = time.perf_counter() - t0
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    torch.export.save(exported, os.path.join(out_dir, _PIPELINE_FILE))
    save_seconds = time.perf_counter() - t0

    pipeline, cfg = predictor.pipeline, predictor.cfg
    manifest = {
        "format": FORMAT,
        "inference_mode": pipeline.mode,
        "image_size": list(pipeline.image_size),
        "batch_size": int(batch_size),
        "device": str(pipeline.device),
        "num_members": len(pipeline.models),
        "mc_runs": pipeline.num_runs if pipeline.mc_enabled else 0,
        "num_convs": pipeline.num_convs,
        "detections_fields": fields,
        "sampling_seeds_shape": (list(pipeline.sampling_seeds_shape(batch_size))
                                 if pipeline.sampled else None),
        "required_ops": list(REQUIRED_OPS),
        "torch_version": torch.__version__,
        "num_params": sum(p.numel() for p in pipeline.parameters()),
        "graph_nodes": len(exported.graph.nodes),
        "export_seconds": export_seconds,
        "save_seconds": save_seconds,
        "config": {
            "META_ARCHITECTURE": cfg.MODEL.META_ARCHITECTURE,
            "NUM_CLASSES": int(cfg.MODEL.RETINANET.NUM_CLASSES),
            "CLS_SAMPLING": cfg.PROBABILISTIC_INFERENCE.CLS_SAMPLING,
            "BOX_SAMPLING": cfg.PROBABILISTIC_INFERENCE.BOX_SAMPLING,
            "COVARIANCE_TYPE": cfg.MODEL.PROBABILISTIC_MODELING.BBOX_COV_LOSS.COVARIANCE_TYPE,
        },
    }
    if extra_manifest:
        manifest.update(extra_manifest)
    with open(os.path.join(out_dir, _MANIFEST_FILE), "w") as f:
        json.dump(manifest, f, indent=2)
    return out_dir


class ServingPredictor:
    """Runs inference from a saved artifact: no model code, no configs.

    Called as the live predictor is, with a CPU `generator` (default: seeded
    with 0) from which it draws the call's dropout seeds and, for a program
    that samples, its sampling seeds. An artifact
    exported for CUDA raises on a machine without CUDA; on CUDA the
    constructor turns TF32 off process-wide, as the live predictor's does."""

    def __init__(self, artifact_dir: str):
        with open(os.path.join(artifact_dir, _MANIFEST_FILE)) as f:
            self.manifest = json.load(f)
        if not str(self.manifest.get("format", "")).startswith("pod_compare_tpu_torch.serving/"):
            raise ValueError(f"{artifact_dir} is not a serving artifact of this package")
        self.device = torch.device(self.manifest["device"])
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"{artifact_dir} holds a program for {self.device}, and CUDA "
                                   f"is not available: an exported program runs on its own "
                                   f"device only")
            # As the live predictor sets them: float32 convolutions and
            # products in full float32 (a program does not carry the flags).
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.program = torch.export.load(os.path.join(artifact_dir, _PIPELINE_FILE))
        self._call = self.program.module()
        self.batch_size = int(self.manifest["batch_size"])
        self.image_size = tuple(self.manifest["image_size"])
        self.fields = list(self.manifest["detections_fields"])
        self._seed_shape = (self.manifest["mc_runs"] or 1, self.manifest["num_convs"])
        # Absent from artifacts written before the sampled impls exported:
        # those programs take four inputs.
        sampling = self.manifest.get("sampling_seeds_shape")
        self._samples = sampling is not None
        self._unit_runs = sampling[1] if self._samples and len(sampling) > 1 else 0

    def __call__(self, images, input_sizes, output_sizes,
                 generator: Optional[torch.Generator] = None) -> Detections:
        """Run the exported pipeline on one padded batch (the arguments of
        `ProbabilisticPredictor.__call__`)."""
        dropout_seeds, sampling_seeds = draw_call_seeds(generator, *self._seed_shape,
                                                        self.batch_size, self._unit_runs)
        seeds = (dropout_seeds, sampling_seeds) if self._samples else (dropout_seeds,)
        images = torch.as_tensor(images).to(self.device, non_blocking=True)
        sizes = lambda s: torch.as_tensor(s, dtype=torch.float32, device=self.device)
        with torch.no_grad():
            out = self._call(images, sizes(input_sizes), sizes(output_sizes), *seeds)
        return Detections(**dict(zip(self.fields, out)))


def load_artifact(artifact_dir: str) -> ServingPredictor:
    """Load a serving artifact written by `save_artifact`."""
    return ServingPredictor(artifact_dir)

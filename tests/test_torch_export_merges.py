"""The port's serving export of the merges, and an artifact served where
the model code cannot be imported.

Beside ``tests/test_torch_export.py`` (its geometry and helpers: 32x32,
batch 2, 5 classes, TOPK 32, 10 detections, float32, full R50 depth), so
that each file runs in under a minute on one core:

* ``mc_dropout_ensembles`` with the post-NMS merge and 2 MC-dropout runs:
  the greedy clustering operator inside the program; the loaded artifact
  equals the live predictor bit for bit;
* that post-NMS artifact loaded and served by a fresh process in which
  ``models``, ``config`` and ``inference.predictor`` of the port, ``jax``
  and ``pod_compare_tpu`` cannot be imported: the same outputs.
"""

import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from pod_compare_tpu_torch.inference import Detections, build_predictor
from test_torch_export import (
    BATCH,
    IMAGE_SIZE,
    INPUT_SIZES,
    OUTPUT_SIZES,
    assert_equal_detections,
    example_batch,
    generator,
    make_cfg,
    reference_state,
    round_trip,
)
from test_torch_modes import few_threads  # noqa: F401  (autouse: two torch threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def post_nms(tmp_path_factory):
    cfg = make_cfg("mc_dropout_ensembles", mc=True)
    cfg.PROBABILISTIC_INFERENCE.ENSEMBLES_DROPOUT.BOX_MERGE_MODE = "post_nms"
    predictor = build_predictor(cfg, IMAGE_SIZE, reference_state(cfg), device="cpu")
    root, served = round_trip(tmp_path_factory, "post_nms", predictor)
    yield predictor, served, str(root / "artifact")
    shutil.rmtree(root, ignore_errors=True)


def test_mc_dropout_post_nms_round_trip_exact(post_nms):
    """The greedy merge runs inside the served program, as one operator."""
    live, served, _ = post_nms
    assert live.post_nms and live.num_runs == 2
    ops = [str(n.target) for n in served.program.graph.nodes]
    assert ops.count("pod_compare_tpu_torch.greedy_sequential_clusters.default") == BATCH
    images = example_batch()
    want = live(images, INPUT_SIZES, OUTPUT_SIZES, generator(7))
    assert_equal_detections(want, served(images, INPUT_SIZES, OUTPUT_SIZES, generator(7)))
    assert bool((want.cluster_size[want.valid] >= 2).any())


def test_artifact_serves_without_the_model_code_or_jax(post_nms, tmp_path):
    """A fresh process loads and serves the artifact with the port's models,
    config and predictor, and JAX and its package, unimportable; its outputs
    equal the live predictor's."""
    live, _, artifact = post_nms
    images = example_batch()
    np.save(tmp_path / "images.npy", images)
    script = textwrap.dedent(f"""
        import importlib.abc, sys

        BLOCKED = ("pod_compare_tpu_torch.models", "pod_compare_tpu_torch.config",
                   "pod_compare_tpu_torch.inference.predictor", "jax", "jaxlib",
                   "pod_compare_tpu")

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                    raise ImportError(f"blocked: {{name}}")
                return None

        sys.meta_path.insert(0, Block())
        import numpy as np
        import torch
        from pod_compare_tpu_torch.inference.export import load_artifact

        torch.set_num_threads(1)  # the CPU's sums in one order, whatever else runs

        served = load_artifact({artifact!r})
        dets = served(np.load({str(tmp_path / "images.npy")!r}), {INPUT_SIZES.tolist()!r},
                      {OUTPUT_SIZES.tolist()!r}, torch.Generator().manual_seed(7))
        torch.save(tuple(dets), {str(tmp_path / "dets.pt")!r})
        leaked = [m for m in sys.modules if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
        assert not leaked, leaked
        print("OK")
    """)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("OK"), proc.stderr
    there = Detections(*torch.load(tmp_path / "dets.pt"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        here = live(images, INPUT_SIZES, OUTPUT_SIZES, generator(7))
    finally:
        torch.set_num_threads(threads)
    assert_equal_detections(here, there)



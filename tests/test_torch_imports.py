"""The port stands alone: with jax, flax, optax, yaml, PIL and the JAX
package made unimportable, every module of pod_compare_tpu_torch and
chip_smoke.py imports, the data path writes, reads and resizes images (with
OpenCV, as the JAX package does) and the evaluation path scores them, and
the entry points refuse to run without CUDA unless they are given a
device."""

import ast
import os
import pkgutil
import subprocess
import sys
import textwrap

import pod_compare_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "optax", "yaml", "PIL", "pod_compare_tpu")


def _port_sources():
    root = os.path.join(REPO, "pod_compare_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_no_source_of_the_port_imports_jax_or_the_jax_package():
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in BLOCKED, f"{path} imports {name}"


def test_every_module_imports_with_jax_and_its_package_blocked():
    modules = ["pod_compare_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(
            pod_compare_tpu_torch.__path__, prefix="pod_compare_tpu_torch."
        )
    ]
    assert len(modules) >= 20
    for name in ("cli.apply_net", "cli.convert_torch_checkpoint", "cli.train_net",
                 "cli.visualize_predictions", "evaluation.pdq", "ops.quant",
                 "utils.memory_guard", "visualization", "visualization.visualizer",
                 "config.setup", "data.converters", "data.converters.common",
                 "data.converters.convert_bdd_to_coco", "data.converters.convert_kitti_to_coco",
                 "data.converters.convert_lyft_to_coco", "data.datasets", "data.loader",
                 "data.metadata", "data.synthetic", "evaluation.average_precision",
                 "evaluation.calibration", "evaluation.calibration_errors",
                 "evaluation.category_mapping", "evaluation.coco_eval", "evaluation.matching",
                 "evaluation.probabilistic_metrics", "evaluation.scoring", "native",
                 "train.trainer", "utils.profiling", "utils.table", "parallel",
                 "parallel.mesh", "ops.preprocess"):
        assert f"pod_compare_tpu_torch.{name}" in modules, name
    script = textwrap.dedent(f"""
        import importlib, importlib.abc, sys

        BLOCKED = {BLOCKED!r}

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"blocked: {{name}}")
                return None

        for name in list(sys.modules):
            if name.split(".")[0] in BLOCKED:
                del sys.modules[name]
        sys.meta_path.insert(0, Block())
        for name in {modules!r} + ["chip_smoke"]:
            importlib.import_module(name)
        leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        assert not leaked, leaked

        from pod_compare_tpu_torch.config import merge_configs
        from pod_compare_tpu_torch.inference import build_predictor
        import torch
        assert not torch.cuda.is_available()
        cfg = merge_configs(
            "BDD-Detection/retinanet/retinanet_R_50_FPN_1x_reg_cls_var_dropout.yaml",
            "Inference/bayes_od_mc_dropout.yaml",
        )
        try:
            build_predictor(cfg, (64, 64), {{}})
        except RuntimeError as e:
            assert "CUDA" in str(e)
        else:
            raise AssertionError("build_predictor ran without CUDA and without a device")

        from pod_compare_tpu_torch.cli.apply_net import run_inference
        try:
            run_inference(cfg, "synth", "bayes_od_mc_dropout", params={{}})
        except RuntimeError as e:
            assert "CUDA" in str(e)
        else:
            raise AssertionError("run_inference ran without CUDA and without a device")

        import os, tempfile
        from pod_compare_tpu_torch.cli import train_net
        from pod_compare_tpu_torch.config import setup_arg_parser
        from pod_compare_tpu_torch.train import Trainer
        with tempfile.TemporaryDirectory() as out:
            os.environ["POD_COMPARE_DATA_DIR"] = out
            train_cfg = merge_configs(
                "BDD-Detection/retinanet/retinanet_R_50_FPN_1x_reg_cls_var_dropout.yaml", "",
                ["OUTPUT_DIR", out])
            for name, call in (
                ("Trainer(cfg)", lambda: Trainer(train_cfg)),
                ("train_net.main", lambda: train_net.main(setup_arg_parser().parse_args(
                    ["--config-file", "BDD-Detection/retinanet/"
                     "retinanet_R_50_FPN_1x_reg_cls_var_dropout.yaml"]))),
            ):
                try:
                    call()
                except RuntimeError as e:
                    assert "CUDA" in str(e), e
                else:
                    raise AssertionError(f"{name} ran without CUDA and without a device")
            assert not os.listdir(out), os.listdir(out)  # nothing was set up first

        import tempfile
        from pod_compare_tpu_torch.data import TestLoader, get_dataset
        from pod_compare_tpu_torch.data.synthetic import register_synthetic, synthetic_detections
        from pod_compare_tpu_torch.evaluation.coco_eval import COCOEvaluator
        import json
        with tempfile.TemporaryDirectory() as root:
            name = register_synthetic(root, "synth", num_images=3, image_size=(40, 56))
            loader = TestLoader(get_dataset(name), batch_size=2, min_size=48, max_size=1333)
            batches = list(loader)
            loader.close()
            assert [b["images"].shape for b in batches] == [(2, 64, 96, 3)] * 2
            with open(get_dataset(name).json_file) as f:
                gt = json.load(f)
            stats = COCOEvaluator(gt, synthetic_detections(gt, 3)).run(verbose=False)
            assert stats[0] > 0
        print("OK")
    """)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0 and proc.stdout.strip().endswith("OK"), proc.stderr


def test_chip_smoke_refuses_to_run_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout

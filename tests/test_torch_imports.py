"""The port stands alone: with jax, flax, optax, yaml, cv2 and the JAX
package made unimportable, every module of pod_compare_tpu_torch and
chip_smoke.py imports, and the entry point refuses to run without CUDA
unless it is given a device."""

import ast
import os
import pkgutil
import subprocess
import sys
import textwrap

import pod_compare_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "optax", "yaml", "cv2", "pod_compare_tpu")


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

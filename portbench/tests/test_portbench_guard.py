"""The guard against JAX in a run: modules compared by their whole
top-level name, so that the port (`pod_compare_tpu_torch`) never trips it
and the JAX package (`pod_compare_tpu`) always does."""

import ast
import os
import subprocess
import sys

from portbench.harness import bench


def test_top_level_names_compared_whole():
    loaded = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "pod_compare_tpu",
              "pod_compare_tpu.ops.nms", "pod_compare_tpu_torch", "pod_compare_tpu_torch.ops",
              "jaxtyping", "flaxen", "pod_compare_tpu_tools", "torch"]
    assert bench.forbidden_modules(loaded) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client", "pod_compare_tpu",
        "pod_compare_tpu.ops.nms"]
    assert bench.forbidden_modules(["pod_compare_tpu_torch.inference"]) == []


def test_harness_and_port_import_no_jax():
    """Everything a run imports, in a fresh process."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import portbench.run, portbench.calibrate\n"
        "from portbench.harness import bench, gen, readers, trace\n"
        "from portbench.reference import bits, detect, model, train\n"
        "for kind in ('drivers', 'metrics'):\n"
        "    import os\n"
        "    for f in sorted(os.listdir(os.path.join(bench.PORTBENCH_DIR, kind))):\n"
        "        if f.endswith('.py'): bench.load_module(kind, f[:-3])\n"
        "import pod_compare_tpu_torch.inference.predictor, pod_compare_tpu_torch.train.trainer\n"
        "print(bench.forbidden_modules())\n" % bench.CHECKOUT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ), timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_reference_imports_nothing_of_the_program():
    """The plain reference's imports: torch, numpy, the standard library and
    itself; neither JAX, nor the JAX package, nor the port."""
    ref_dir = os.path.join(bench.PORTBENCH_DIR, "reference")
    for name in os.listdir(ref_dir):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(ref_dir, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                top = mod.split(".")[0]
                assert top in {"torch", "numpy", "math", "typing", "dataclasses",
                               "portbench"}, (name, mod)
                assert not mod.startswith("portbench.") or mod.startswith(
                    "portbench.reference"), (name, mod)

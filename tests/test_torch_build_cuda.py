"""What ptxas reports of every CUDA source of ``csrc/``, on a card.

These tests skip where there is no CUDA device. The file imports neither
JAX nor the JAX package, so on a machine with a card it runs without the
suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_build_cuda.py

``_build`` keeps ptxas's report beside each library it builds. Every
kernel instance of a source must be in it with its registers, no stack
frame and no spill stores or loads: a spill puts a kernel's working set in
local memory, which goes through the L1 and L2 to HBM. The instances that
the main paths launch must be there, and the NMS kernel and the FrozenBN
epilogue must have every instance their launchers can pick.
"""

import re

import pytest
import torch

from pod_compare_tpu_torch.ops.kernels import _build

# Mangled-name fragments of the instances each source must hold.
REQUIRED = {
    "dropout.cu": (),
    "focal.cu": ("focal_kernelILi10ELb1ELb1E",),  # focal_kernel<10, true, true>: training's
    "normal.cu": ("normal_kernelIfLb1EE",),  # normal_kernel<float, true>: the class bank's
    "nms.cu": ("nms_kernelILi256ELi4EE", "nms_kernelILi1024ELi5EE", "nms_kernelILi1024ELi0EE",
               "chain_kernelILi256EE", "chain_kernelILi1024EE"),
    "frozen_bn.cu": (),
}
# Instances a source must have in all: K3's forward and backward, each over
# three (activation, buffer) dtype pairs and two layouts.
COUNTS = {"nms.cu": 5, "frozen_bn.cu": 12}


def ptxas_instances(report: str):
    """{mangled name: {registers, stack_bytes, spill_stores, spill_loads}}
    of each entry function in a ptxas report."""
    found, name = {}, None
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name = entry.group(1)
            found[name] = {}
            continue
        used = re.search(r"Used (\d+) registers", line)
        stack = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
        if name and used:
            found[name]["registers"] = int(used.group(1))
        if name and stack:
            found[name].update(zip(("stack_bytes", "spill_stores", "spill_loads"),
                                   map(int, stack.groups())))
    return found


@pytest.mark.parametrize("source", _build.SOURCES)
def test_ptxas_reports_no_stack_and_no_spills(source):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    instances = ptxas_instances(_build.ptxas_report(source))
    assert instances, f"ptxas reported no entry function of {source}"
    for name, info in sorted(instances.items()):
        print(f"{source} {name}: {info}")
        assert set(info) == {"registers", "stack_bytes", "spill_stores", "spill_loads"}, name
        assert info["stack_bytes"] == info["spill_stores"] == info["spill_loads"] == 0, name
    for fragment in REQUIRED[source]:
        assert any(fragment in name for name in instances), f"{source}: no {fragment}"
    if source in COUNTS:
        assert len(instances) == COUNTS[source]

"""The benchmark's own tests: run from the checkout's root with

    python -m pytest -q -p no:cacheprovider portbench/tests

They import the benchmark as ``portbench`` and the port; none imports JAX
or the JAX package. Tests that need a CUDA card skip without one.
"""

import os
import sys

import pytest
import torch

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if CHECKOUT not in sys.path:
    sys.path.insert(0, CHECKOUT)


def small(cell):
    """A cell cut to a size a CPU test holds: a 64x96 canvas, batch 2, two
    MC runs, rings of a few images; every width as the cell has it."""
    cell.config["canvas"] = [64, 96]
    cell.config["image"] = [60, 96]
    t = cell.traffic
    if t["driver"] == "predictor_loop":
        t.update(batch=2, ring_images=4, check_within=2, check_batches=2,
                 profile_batches=1, stage_batches=2)
        t["opts"] = list(t["opts"]) + ["PROBABILISTIC_INFERENCE.MC_DROPOUT.NUM_RUNS", 2]
    else:
        t.update(batch=2, ring_batches=3, warmup_steps=1, profile_steps=1)
        t["opts"] = list(t["opts"]) + ["SOLVER.IMS_PER_BATCH", 2]


@pytest.fixture(autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 4))
    yield
    torch.set_num_threads(threads)

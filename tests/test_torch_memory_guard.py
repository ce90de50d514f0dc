"""The peak-memory guard (``utils/memory_guard.py``) on the CPU.

``pick_max_batch`` against the JAX package's ``pick_max_batch_programs``:
both given the same peak per batch (the JAX side through stand-in programs
whose ``memory_analysis`` reports it), both must choose the same batch,
None included. ``auto_batch_size``'s probe, linear fit and check with the
card's measurement replaced by a given function of the batch; and its
refusal off CUDA. The measuring itself needs the card (``chip_smoke.py``).
"""

import types

import pytest
import torch

from pod_compare_tpu.utils.hbm_guard import pick_max_batch_programs
from pod_compare_tpu_torch.utils import memory_guard
from pod_compare_tpu_torch.utils.memory_guard import (
    BATCH_CANDIDATES,
    auto_batch_size,
    pick_max_batch,
)
from test_torch_modes import few_threads  # noqa: F401  (autouse: two torch threads)

GB = 1e9


class _Program:
    """Stands in for a jitted function: lower().compile() reports `peak`."""

    def __init__(self, peak):
        self.peak = peak

    def lower(self, *args):
        return self

    def compile(self):
        return self

    def cost_analysis(self):
        return {}

    def memory_analysis(self):
        return types.SimpleNamespace(temp_size_in_bytes=self.peak, argument_size_in_bytes=0,
                                     output_size_in_bytes=0)


PEAKS = {
    "linear": lambda b: 0.5 * GB + 0.4 * GB * b,
    "flat": lambda b: 3.0 * GB,
    "not monotone": lambda b: {32: 5.0 * GB, 24: 9.0 * GB}.get(b, 7.0 * GB),
    "exactly the budget at 16": lambda b: 6.0 * GB if b == 16 else 6.0 * GB + b,
}


@pytest.mark.parametrize("candidates", [BATCH_CANDIDATES, (4, 2, 1), (1,)])
@pytest.mark.parametrize("budget", [0.1 * GB, 0.9 * GB, 6.0 * GB, 13.5 * GB, 80 * GB])
@pytest.mark.parametrize("peaks", list(PEAKS))
def test_pick_max_batch_matches_jax(peaks, budget, candidates):
    peak = PEAKS[peaks]
    theirs, info = pick_max_batch_programs(
        lambda b: [("pipeline", _Program(peak(b)), ())], candidates, budget_bytes=budget,
        log=lambda m: None)
    ours, tried = pick_max_batch(peak, candidates, budget)
    assert ours == theirs
    assert list(tried) == list(info)  # the same candidates tried, in the same order


def _fake_cuda_predictor():
    return types.SimpleNamespace(device=torch.device("cuda"))


def test_auto_batch_size_fits_a_line_through_two_probes(monkeypatch):
    calls = []

    def peak(predictor, batch, canvas):
        calls.append(batch)
        return int(1.0 * GB + 0.5 * GB * batch)

    monkeypatch.setattr(memory_guard, "predictor_peak", peak)
    chosen, info = auto_batch_size(_fake_cuda_predictor(), (64, 64), budget=9.0 * GB,
                                   log=lambda m: None)
    # 1 + 0.5·16 = 9 GB fits; 24 and 32 are predicted over and never run.
    assert chosen == 16
    assert calls == [1, 2, 16]
    assert info["slope"] == int(0.5 * GB)
    assert set(info["predicted"]) == {32, 24, 16} and set(info["measured"]) == {16}


def test_auto_batch_size_takes_the_next_batch_down_when_the_measurement_misses(monkeypatch):
    """A batch predicted to fit whose measured peak does not is passed over."""
    monkeypatch.setattr(memory_guard, "predictor_peak",
                        lambda p, b, c: int(GB * b + (5 * GB if b == 8 else 0)))
    chosen, info = auto_batch_size(_fake_cuda_predictor(), (64, 64), budget=9.5 * GB,
                                   log=lambda m: None)
    assert chosen == 4
    assert info["measured"] == {8: 13 * GB, 4: 4 * GB}


def test_auto_batch_size_raises_when_nothing_fits(monkeypatch):
    monkeypatch.setattr(memory_guard, "predictor_peak", lambda p, b, c: int(GB * (b + 10)))
    with pytest.raises(RuntimeError, match="no batch"):
        auto_batch_size(_fake_cuda_predictor(), (64, 64), budget=5 * GB, log=lambda m: None)


def test_auto_batch_size_refuses_the_cpu():
    with pytest.raises(ValueError, match="CUDA"):
        auto_batch_size(types.SimpleNamespace(device=torch.device("cpu")), (64, 64))

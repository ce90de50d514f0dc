"""Peak-memory guard: the largest batch a predictor can run on the card.

Counterpart of ``pod_compare_tpu/utils/hbm_guard.py``. The JAX package
compiles each candidate batch and reads XLA's ``memory_analysis``; PyTorch
runs eagerly and has no such analysis, so the port measures instead:

  1. one predictor call on a zero canvas at batch 1 and at batch 2, each
     after ``torch.cuda.reset_peak_memory_stats``, read with
     ``max_memory_allocated`` (weights and everything else resident count);
  2. a linear fit ``peak(b) = a + k·b`` through the two;
  3. the candidates ``(32, 24, 16, 8, 4, 2, 1)`` in descending order: one
     whose predicted peak is over the budget is skipped without running;
     the first whose prediction fits is run once, and taken if its
     measured peak fits too, else the next candidate down is tried.

``pick_max_batch`` is that selection alone (first fit in the given
descending order, as the JAX ``pick_max_batch_programs`` picks), with the
measure injected; ``auto_batch_size`` does the measuring on CUDA.
"""

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

BATCH_CANDIDATES = (32, 24, 16, 8, 4, 2, 1)
# The share of the card's memory a chosen batch may peak at. The rest is
# headroom for what `max_memory_allocated` does not see: the CUDA context,
# cuDNN and cuBLAS workspaces, the caching allocator's fragmentation
# (reserved above allocated), the prefetcher's next batch on the card, and
# images whose detections make the host-side stages allocate more than the
# zero canvas of the probe.
BUDGET_FRACTION = 0.8


def pick_max_batch(
    measure: Callable[[int], float],
    candidates: Sequence[int],
    budget: float,
) -> Tuple[Optional[int], Dict[int, float]]:
    """First candidate, in the given (descending) order, whose
    ``measure(batch)`` fits the budget; (batch, {batch: measure}) of the
    candidates tried, or (None, ...) when none fits."""
    tried = {}
    for batch in candidates:
        tried[batch] = float(measure(batch))
        if tried[batch] <= budget:
            return batch, tried
    return None, tried


def device_budget(device, fraction: float = BUDGET_FRACTION) -> float:
    """`fraction` of the card's total memory, in bytes."""
    return fraction * torch.cuda.mem_get_info(device)[1]


def predictor_peak(predictor, batch: int, canvas: Sequence[int]) -> int:
    """Peak allocated bytes of one predictor call on a zero canvas."""
    device = predictor.device
    images = torch.zeros((batch, *canvas, 3), dtype=torch.uint8, device=device)
    sizes = np.tile(np.asarray(canvas, np.float32), (batch, 1))
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    predictor(images, sizes, sizes, generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize(device)
    return torch.cuda.max_memory_allocated(device)


def auto_batch_size(
    predictor,
    canvas: Sequence[int],
    candidates: Sequence[int] = BATCH_CANDIDATES,
    budget: Optional[float] = None,
    log: Callable[[str], None] = print,
) -> Tuple[int, dict]:
    """The largest candidate batch whose peak fits `budget` (default
    `device_budget`), by the probe, fit and check of the module's docstring.
    Returns (batch, info): info holds the probes' peaks, the fit, the budget,
    and per candidate tried its predicted and measured peak. Raises
    ValueError off CUDA (nothing to measure) and RuntimeError when no
    candidate fits."""
    device = predictor.device
    if device.type != "cuda":
        raise ValueError(f"batch_size='auto' measures peak memory on CUDA; the predictor "
                         f"runs on {device}")
    if budget is None:
        budget = device_budget(device)
    probes = {b: predictor_peak(predictor, b, canvas) for b in (1, 2)}
    slope = probes[2] - probes[1]
    predict = lambda b: probes[1] + slope * (b - 1)
    info = {"probes": probes, "slope": slope, "budget": budget, "predicted": {},
            "measured": {}}

    def measure(batch):
        info["predicted"][batch] = predict(batch)
        if info["predicted"][batch] > budget:
            return info["predicted"][batch]
        info["measured"][batch] = probes.get(batch) or predictor_peak(predictor, batch, canvas)
        return info["measured"][batch]

    chosen, _ = pick_max_batch(measure, candidates, budget)
    log(f"auto batch: probes {probes} bytes, {slope} bytes per image, budget "
        f"{budget:.0f} bytes; predicted {info['predicted']}, measured {info['measured']} "
        f"-> {chosen}")
    if chosen is None:
        raise RuntimeError(f"no batch of {tuple(candidates)} fits the peak-memory budget "
                           f"({budget:.0f} bytes): reduce the canvas or the model")
    return chosen, info

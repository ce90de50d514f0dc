"""The seeds one inference call draws on the host, shared by the live
predictor (``inference/predictor.py``) and the served artifact
(``inference/export.py``), so that both draw the same masks and the same
normals from the same generator. It imports no model code: a serving host
loads it without them.
"""

from typing import Optional, Tuple

import torch

SEED_HIGH = 2 ** 63 - 1


def draw_seeds(generator: Optional[torch.Generator], shape) -> torch.Tensor:
    """int64 seeds in [0, 2^63 - 1) of `shape`, on the CPU."""
    return torch.randint(0, SEED_HIGH, shape, generator=generator, dtype=torch.int64)


def draw_call_seeds(generator: Optional[torch.Generator], num_runs: int, num_convs: int,
                    batch: int = 1, unit_runs: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dropout_seeds, sampling_seeds) of one call from the CPU `generator`
    (default: seeded with 0). Two seeds come first, one for the dropout
    stream and one for the sampling stream, so that they never share
    numbers. The (num_runs, 2, num_convs) int64 seeds of the MC bank's masks
    (run, tower, layer) come from the first; a call that runs no MC bank
    ignores them. The second gives one seed per image, (batch,), and with
    `unit_runs` each image's seed gives one per (image, run) unit, (batch,
    unit_runs), as the JAX package splits each image's key into M on the
    post-NMS paths: image b's seeds do not depend on the batch. The
    Monte-Carlo sampling impls draw their normals from these
    (``inference/core.py``); an analytic call ignores them."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    dropout_seed, sampling_seed = draw_seeds(generator, (2,)).tolist()
    dropout_seeds = draw_seeds(torch.Generator().manual_seed(dropout_seed),
                               (num_runs, 2, num_convs))
    sampling_seeds = draw_seeds(torch.Generator().manual_seed(sampling_seed), (batch,))
    if unit_runs:
        sampling_seeds = torch.stack([draw_seeds(torch.Generator().manual_seed(s), (unit_runs,))
                                      for s in sampling_seeds.tolist()])
    return dropout_seeds, sampling_seeds

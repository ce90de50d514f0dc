"""The seeds one inference call draws on the host, shared by the live
predictor (``inference/predictor.py``) and the served artifact
(``inference/export.py``), so that both draw the same masks from the same
generator. It imports no model code: a serving host loads it without them.
"""

from typing import Optional, Tuple

import torch

SEED_HIGH = 2 ** 63 - 1


def draw_seeds(generator: Optional[torch.Generator], shape) -> torch.Tensor:
    """int64 seeds in [0, 2^63 - 1) of `shape`, on the CPU."""
    return torch.randint(0, SEED_HIGH, shape, generator=generator, dtype=torch.int64)


def draw_call_seeds(generator: Optional[torch.Generator], num_runs: int,
                    num_convs: int) -> Tuple[torch.Tensor, int]:
    """(dropout_seeds, sampling_seed) of one call from the CPU `generator`
    (default: seeded with 0): two seeds, one for the dropout stream and one
    for the sampling stream, so that they never share numbers, then the
    (num_runs, 2, num_convs) int64 seeds of the MC bank's masks (run, tower,
    layer) from the first. A call that runs no MC bank ignores them."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    dropout_seed, sampling_seed = draw_seeds(generator, (2,)).tolist()
    dropout_seeds = draw_seeds(torch.Generator().manual_seed(dropout_seed),
                               (num_runs, 2, num_convs))
    return dropout_seeds, sampling_seed

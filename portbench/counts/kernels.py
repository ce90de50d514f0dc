"""The least time of the port's hand-written kernels, from shapes.

Frozen from ``chip_smoke.py`` at commit b304412 of this repository
(``HBM_BYTES_PER_S``, ``FOCAL_OPS``, K1's byte bound):
  - K1, the dropout kernel (csrc/dropout.cu), one launch over the five FPN
    levels of a (run, tower, layer): the forward reads x and writes its
    output, 2 x the bytes of x; the backward reads the cotangent and the
    forward's output and writes the input gradient, 3 x.
  - K2, the stochastic focal kernel (csrc/focal.cu), per element of the
    (B, R, K) logits: 24 bytes (three float32 inputs, three outputs), and
    the least operations of the function, each add, multiply, FMA,
    compare, select, shift, logical op, conversion or transcendental one
    instruction, each transcendental also one MUFU operation: per element
    24 (1 MUFU), per pair of draws 32 (4 MUFU), per draw 22 (3 MUFU); at
    S = 10, 404 instructions and 51 MUFU an element.
The bound is the largest of the bytes over HBM's bandwidth, the
instructions over the issue rate and the MUFU work over its rate.
"""

from portbench.counts import peaks

FOCAL_OPS = {"element": (24, 1), "pair": (32, 4), "draw": (22, 3)}
FOCAL_BYTES_PER_ELEMENT = 24


def k1_bytes(batch_rows: int, positions: int, channels: int = 256, itemsize: int = 2) -> int:
    """Bytes of x in one grouped launch: every level's (rows, C, H, W)."""
    return batch_rows * channels * positions * itemsize


def k1_forward_bound_s(x_bytes: int) -> float:
    return 2 * x_bytes / peaks.HBM_BYTES_PER_S


def k1_backward_bound_s(x_bytes: int) -> float:
    return 3 * x_bytes / peaks.HBM_BYTES_PER_S


def focal_ops(num_samples: int):
    """(instructions, MUFU operations) an element at S = num_samples."""
    pairs = (num_samples + 1) // 2
    instr = FOCAL_OPS["element"][0] + pairs * FOCAL_OPS["pair"][0] + \
        num_samples * FOCAL_OPS["draw"][0]
    mufu = FOCAL_OPS["element"][1] + pairs * FOCAL_OPS["pair"][1] + \
        num_samples * FOCAL_OPS["draw"][1]
    return instr, mufu


def k2_bound_s(elements: int, num_samples: int) -> float:
    instr, mufu = focal_ops(num_samples)
    return max(elements * FOCAL_BYTES_PER_ELEMENT / peaks.HBM_BYTES_PER_S,
               elements * instr / peaks.INSTRUCTIONS_PER_S,
               elements * mufu / peaks.MUFU_PER_S)

"""K3, the FrozenBN epilogue, in the traced sub-window: its least bytes a
step (counts/epilogues.py, forward and backward, bf16, at 3.35 TB/s) times
the steps profiled, over the device time of the kernels named
``pod_frozen_bn*``; None for a program without them."""

import re

from portbench.counts import epilogues, peaks, resnets
from portbench.harness import readers

K3 = re.compile(r"pod_frozen_bn")


def read(run):
    if run["kind"] != "train":
        return None
    n, t = readers.kernel_time_s(run, lambda k: bool(K3.search(k)))
    if not n:
        return None
    cs = resnets.model_convs(run["cell"].config["canvas"], run["cell"].config["model"])
    steps = int(run["cell"].traffic["profile_steps"])
    least = sum(epilogues.step_bytes(cs, run["batch"])) / peaks.HBM_BYTES_PER_S
    return readers.roofline_pct(steps * least, t)

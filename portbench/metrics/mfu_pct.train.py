"""FLOPs of the convolutions the window's steps need, forward and
backward (counts/convs.py), over the window's wall time, against the
card's bf16 peak."""

from portbench.harness.readers import mfu_pct


def read(run):
    return mfu_pct(run, "train")

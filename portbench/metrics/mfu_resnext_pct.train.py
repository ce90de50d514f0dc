"""FLOPs of the convolutions the window's steps need, forward and
backward, on the configuration's own backbone (counts/resnets.py: any
depth, groups and width), over the window's wall time, against the card's
bf16 peak."""

from portbench.counts import convs, peaks, resnets


def read(run):
    if run["kind"] != "train" or not run["images"] or run["window_s"] <= 0:
        return None
    cs = resnets.model_convs(run["cell"].config["canvas"], run["cell"].config["model"])
    flops = 2.0 * convs.train_macs_per_image(cs) * run["images"]
    return 100.0 * flops / run["window_s"] / peaks.BF16_FLOPS

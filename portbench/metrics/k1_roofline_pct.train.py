"""K1's grouped forward and backward launches in the traced
sub-window: their byte bounds (2 x and 3 x the bytes of x over HBM's
bandwidth) over their device time."""

from portbench.counts import kernels
from portbench.harness import readers


def read(run):
    if run["kind"] != "train":
        return None
    x = readers.k1_bytes(run)
    nf, tf = readers.kernel_time_s(run, lambda k: readers.k1_direction(k) == "forward")
    nb, tb = readers.kernel_time_s(run, lambda k: readers.k1_direction(k) == "backward")
    if not nf + nb:
        return None
    bound = nf * kernels.k1_forward_bound_s(x) + nb * kernels.k1_backward_bound_s(x)
    return readers.roofline_pct(bound, tf + tb)

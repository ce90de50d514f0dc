"""K1's grouped forward in the traced sub-window: its byte bound (2 x
the bytes of x over HBM's bandwidth) times its launches, over its device
time."""

from portbench.counts import kernels
from portbench.harness import readers


def read(run):
    if run["kind"] != "infer":
        return None
    n, t = readers.kernel_time_s(run, lambda k: readers.k1_direction(k) == "forward")
    if not n:
        return None
    return readers.roofline_pct(n * kernels.k1_forward_bound_s(readers.k1_bytes(run)), t)

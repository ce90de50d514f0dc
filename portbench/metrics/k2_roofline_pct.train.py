"""K2, the focal kernel, in the traced sub-window: the largest of its
bytes, instruction and MUFU bounds (counts/kernels.py) at the step's (B, R,
K) logits and S draws, times its launches, over its device time."""

from portbench.counts import kernels
from portbench.harness import readers


def read(run):
    if run["kind"] != "train":
        return None
    n, t = readers.kernel_time_s(run, lambda k: bool(readers.K2.search(k)))
    if not n:
        return None
    m = run["cell"].config["model"]
    from portbench.reference import detect
    anchors = detect.anchors(run["cell"].config["canvas"])[0].shape[0]
    elements = run["batch"] * anchors * m["num_classes"]
    return readers.roofline_pct(n * kernels.k2_bound_s(elements, m["cls_var_samples"]), t)

"""The grouped 3x3s in a traced run: their least time a step (the larger
of the least bytes of forward, dgrad and wgrad over HBM's bandwidth and
their operations over the bf16 peak, counts/resnets.py) times the steps
profiled, over the device time of the kernels their operators launched
(``drivers/train_steps_resnet.py::grouped_kernels``, `profile_steps` steps
profiled with shapes)."""

from portbench.counts import peaks, resnets
from portbench.harness import readers


def read(run):
    kernels = run.get("gconv_kernels")
    if run["kind"] != "train" or not kernels:
        return None
    cs = resnets.grouped(resnets.model_convs(run["cell"].config["canvas"],
                                             run["cell"].config["model"]))
    batch, steps = run["batch"], int(run["cell"].traffic["profile_steps"])
    flops = 2.0 * batch * sum(c.macs * (1 + c.trainable + c.input_grad) for c in cs)
    least = max(resnets.grouped_train_bytes(cs, batch) / peaks.HBM_BYTES_PER_S,
                flops / peaks.BF16_FLOPS)
    return readers.roofline_pct(steps * least, sum(kernels.values()))

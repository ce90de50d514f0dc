"""95th percentile of the device time between consecutive step ends (CUDA
events recorded after each step, no sync a step; statistics.quantiles,
n=20)."""

from portbench.harness.readers import quantile


def read(run):
    if run["kind"] != "train":
        return None
    return quantile(run["step_ms"], 19, 20)

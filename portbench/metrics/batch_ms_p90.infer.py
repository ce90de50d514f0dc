"""90th percentile of a batch's host time from enqueue to its json
records, over the window's batches (statistics.quantiles, n=10)."""

from portbench.harness.readers import quantile


def read(run):
    if run["kind"] != "infer":
        return None
    return quantile(run["batch_ms"], 9, 10)

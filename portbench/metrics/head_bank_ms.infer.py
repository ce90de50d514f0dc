"""Mean host milliseconds of the pipeline's head outputs (backbone, FPN
and every run's head), between syncs, a batch."""

from portbench.harness.readers import mean


def read(run):
    if run["kind"] != "infer":
        return None
    return mean(run["stage_ms"].get("head_outputs", []))

"""Mean host milliseconds of the pipeline's detect (per-image candidate
core, mode and rescale), between syncs, a batch."""

from portbench.harness.readers import mean


def read(run):
    if run["kind"] != "infer":
        return None
    return mean(run["stage_ms"].get("detect", []))

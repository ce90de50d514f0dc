"""Images of every step completed in the window, over the window's wall
time, which ends in a sync (host clock)."""


def read(run):
    if run["kind"] != "train" or run["window_s"] <= 0:
        return None
    return run["images"] / run["window_s"]

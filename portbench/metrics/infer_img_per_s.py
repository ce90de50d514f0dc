"""Images whose json records reached the host in the window, over the
window's wall time (host clock)."""


def read(run):
    if run["kind"] != "infer" or run["window_s"] <= 0:
        return None
    return run["images"] / run["window_s"]

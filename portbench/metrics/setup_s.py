"""Seconds from the process's start to the window's first batch or step:
imports, CUDA, weights, inputs, the program's set-up and the warm-up (and a
checkout's first build)."""


def read(run):
    return run["setup_s"]

"""Seconds from the process's start to the window: imports, the graph,
the reusable object, the kernel build where it is not cached, warm-up."""


def read(run):
    return run.setup_s

"""Useful GFLOP/s: 2 P (SpGEMM) or 2 nnz (SpMV) for every call completed
in the window, over the whole window by the host clock."""


def read(run):
    return run.ops / run.window_s / 1e9

"""Host ms from a call's start to its return, before the harness's
synchronise: the mean over the calls of the window run without the
profiler (a traced run makes one before its traced window)."""


def read(run):
    return 1e3 * sum(enq for _, enq in run.untraced) / len(run.untraced)

"""The calls' least time (yardstick.py: least bytes at the memory
bandwidth or least operations at the float rate, from the CSR inputs)
over the seconds the card was busy in the traced window, in %."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * run.least_s / run.trace.busy_s

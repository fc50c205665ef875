"""Host reads a call, from the program's own recorder: its counter
``sync`` over the calls that the entry recorded, each inside the span
``bench.call``.  An entry records them in set-up, before warm-up and
outside the timed window (``entries/rap.py``: a reset, then one call
under ``profiling.recording()``), so the value is of those calls alone.
None where the recorder holds no such call."""


def read(run):
    from nsparse_tpu_torch.utils import profiling

    snap = profiling.snapshot()
    calls = snap["spans"].get("bench.call", {}).get("count", 0)
    if not calls:
        return None
    return snap["counters"].get("sync", 0) / calls

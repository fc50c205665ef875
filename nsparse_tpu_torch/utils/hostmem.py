"""Host memory tuning for plan-build-heavy workloads (counterpart of
``nsparse_tpu/utils/hostmem.py``).

The symbolic phase allocates GBs of short-lived numpy temporaries.  On
virtualized hosts, transparent hugepages make every first touch a
synchronous 2 MB zeroing; turning them off for the process switches to
4 KB faults.  The package calls :func:`tune_host_memory` when it is
imported.  Opt out with ``NSPARSE_THP=keep``.
"""

from __future__ import annotations

import ctypes
import os

_PR_SET_THP_DISABLE = 41
_done = False


def tune_host_memory() -> bool:
    """Disable transparent hugepages for this process (idempotent).

    Returns True when the prctl succeeded (or already ran), False when
    opted out or unsupported.  It changes only the page size of future
    anonymous mappings.
    """
    global _done
    if _done:
        return True
    if os.environ.get("NSPARSE_THP", "").lower() == "keep":
        return False
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        if libc.prctl(_PR_SET_THP_DISABLE, 1, 0, 0, 0) == 0:
            _done = True
    except OSError:
        return False
    return _done

"""The benchmark's modules import each other by name, as ``run.py`` runs
them; the program is imported from the repository's root."""

import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (BENCH_DIR, os.path.dirname(BENCH_DIR)):
    if p not in sys.path:
        sys.path.insert(0, p)

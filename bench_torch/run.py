"""Run one cell of the port's benchmark and print its result line.

    python3 bench_torch/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the repository's root.  The cell, its configuration and its traffic
are looked up by name in BENCHMARK.json; the configuration's file, the
traffic's file (``traffic/<name>.json``) and each metric's reader
(``metrics/<name>.py``) are read from this directory.  With ``--trace 0``
the line carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics.  Without a card, or with fewer cards than the cell
asks for, it exits non-zero and prints no result.  The numbers compared
for ``correct`` come last on standard error and last in the line.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def finite(x):
    """JSON has no infinity: a number past every limit stands for one."""
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return 1e300
    return x


def cell_files(bench: dict, workload: str):
    """(cell, configuration, traffic, end-to-end and per-layer metric
    entries) of ``workload``."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; "
                         f"known: {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(ROOT, conf["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(BENCH_DIR, "traffic",
                           f"{cell['traffic']}.json")) as f:
        traffic = json.load(f)

    def mine(ms):
        return [m for m in ms if workload in m.get("workloads", [workload])]

    return cell, cfg, traffic, mine(bench["end_to_end"]), mine(
        bench["per_layer"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell, cfg, traffic, e2e, per_layer = cell_files(bench, args.workload)

    sys.path.insert(0, ROOT)  # the program under test
    import torch

    import harness

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run_cell(
        cfg, traffic, args.seed, args.seconds, bool(args.trace), "cuda:0",
        per_layer if args.trace else e2e, T_START)
    result = finite(result)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

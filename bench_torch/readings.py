"""The readings a cell's limits are set from: the numbers compared for
``correct``, for the program on many seeds and for the control (the
reference one precision below, in the program's place) on a few, in one
process, each run with a short window at the cell's own load.

    python3 bench_torch/readings.py --workload <name> \
        --seeds 11,12,... --control-seeds 21,22,23 [--seconds 2] \
        [--out readings.jsonl]

One JSON line per run: workload, seed, side ("program" or "control"),
each number compared and ``correct``.  No run of the benchmark runs the
control.  Off the card it runs only with ``--device cpu``.
"""

import argparse
import gc
import json
import os
import sys
import time

import run


def read_files(config: str, traffic: str):
    """The configuration (``configs/<config>.json``) and the traffic mix
    (``traffic/<traffic>.json``) as dicts."""
    with open(os.path.join(run.BENCH_DIR, "configs", f"{config}.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(run.BENCH_DIR, "traffic", f"{traffic}.json")) as f:
        return cfg, json.load(f)


def readings(cfg, traffic, seeds, control_seeds, seconds, device):
    """Yield the numbers compared, one dict per run: the program on
    ``seeds``, then the control on ``control_seeds``."""
    sys.path.insert(0, run.ROOT)
    import torch

    import harness

    for side, ss in (("program", seeds), ("control", control_seeds)):
        for seed in ss:
            t0 = time.perf_counter()
            r = harness.run_cell(cfg, traffic, seed, seconds, False, device,
                                 [], t0, control=side == "control")
            yield {"seed": seed, "side": side, "correct": r["correct"],
                   **{n: c["value"] for n, c in r["checks"].items()}}
            del r
            gc.unfreeze()
            gc.collect()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    if args.device != "cpu" and not torch.cuda.is_available():
        print("no card; pass --device cpu for a host run", file=sys.stderr)
        return 2

    def ints(s):
        return [int(x) for x in s.split(",") if x]

    with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
        _, cfg, traffic, _, _ = run.cell_files(json.load(f), args.workload)
    for line in readings(cfg, traffic, ints(args.seeds),
                         ints(args.control_seeds), args.seconds, args.device):
        line = json.dumps(run.finite({"workload": args.workload, **line}))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                print(line, file=f)
    return 0


if __name__ == "__main__":
    sys.exit(main())

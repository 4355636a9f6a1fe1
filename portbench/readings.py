"""The readings that a cell's limits are set from: the program's widest
logit gaps on many seeds and the control's on a few, in one process.

    python3 portbench/readings.py --workload <cell> --seeds 1,2,... \\
        --seconds 15 --control 3

For each seed the fleet takes that seed's weights, serves the cell's own
traffic for a short window, and the check's sample is compared with the
float32 reference (the program's reading); for the first ``--control``
seeds the reference computed in fp8 is read at the same positions (the
control's reading). Both readings go through the run's own comparison
(``check.numbers`` with the cell's limits, ``check.correct``): a seed's
line gives ``correct`` for the program and ``control_correct`` for the
control in its place, which has to come out false. Prints a JSON line a
seed. Not run by the benchmark.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--control", type=int, default=3)
    args = ap.parse_args()
    from portbench.harness import check, loader
    from portbench.harness.cell import serve
    from portbench.harness.fleet import Fleet
    from portbench.harness.stats import Run, percentile
    cell = loader.load_cell(args.workload, False)
    seeds = [int(s) for s in args.seeds.split(",")]
    fleet = None
    for i, seed in enumerate(seeds):
        t = time.monotonic()
        if fleet is None:
            fleet = Fleet(cell.config, seed, "cuda")
            fleet.build()
        else:
            fleet.reseed(seed)
        drive = serve(fleet, cell, seed, args.seconds)
        run = Run(args.seconds, fleet.fns, drive.records, [], 0.0)
        for ep in fleet.endpoints.values():
            ep.evict()
        window = run.window
        picks = check.sample(window, fleet.fns,
                             cell.config["check"]["sample"], seed)
        t_ref = time.monotonic()
        out = check.model_gaps(picks, fleet.fns, "cuda",
                               control=i < args.control)
        prog, ctrl = out if i < args.control else (out, {})
        nums = check.numbers(window, fleet.fns, picks, cell.config, "cuda",
                             gaps=prog)
        line = {"seed": seed, "program": prog, "control": ctrl,
                "correct": check.correct(nums), "checks": nums}
        if ctrl:
            cnums = check.numbers(window, fleet.fns, picks, cell.config,
                                  "cuda", gaps=ctrl)
            line.update(control_correct=check.correct(cnums),
                        control_checks=cnums)
        print(json.dumps({
            **line,
            "sampled": len(picks), "due": len(window),
            "p50": percentile(run.latencies(), 50),
            "p95": percentile(run.latencies(), 95),
            "reference_s": time.monotonic() - t_ref,
            "seed_s": time.monotonic() - t}), flush=True)


if __name__ == "__main__":
    main()

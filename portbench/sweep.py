"""Find a cell's knee: the same fleet served at several offered rates (or
client counts), one short window each, in one process.

    python3 portbench/sweep.py --workload <cell> --seed <n> --seconds <s> \\
        --rates 2,3,4          # open-loop mixes
        --clients 4,8          # closed-loop mixes

Prints a JSON line a rate: invocations due and answered, the completion
rate inside the window, latency quantiles from due time, and the mean
latency of the window's first and last thirds (a backlog that grows
shows as a last third far above the first). Not run by the benchmark.
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
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rates", default="")
    ap.add_argument("--clients", default="")
    args = ap.parse_args()
    from portbench.harness import loader
    from portbench.harness.cell import serve
    from portbench.harness.fleet import Fleet
    from portbench.harness.stats import Run, mean, percentile
    cell = loader.load_cell(args.workload, False)
    t = time.monotonic()
    fleet = Fleet(cell.config, args.seed, "cuda")
    fleet.build()
    print(json.dumps({"setup": fleet.parts,
                      "s": time.monotonic() - t}), flush=True)
    key = "rate_per_s" if args.rates else "clients"
    for v in (args.rates or args.clients).split(","):
        mix = dict(cell.mix, **{key: float(v) if args.rates else int(v)})
        for ep in fleet.endpoints.values():
            ep.evict()
        drive = serve(fleet, cell, args.seed, args.seconds, mix=mix)
        run = Run(args.seconds, fleet.fns, drive.records, [], 0.0)
        win = sorted(run.window, key=lambda r: r.due)
        third = len(win) // 3
        lat = run.latencies()
        print(json.dumps({
            key: mix[key], "due": len(win),
            "answered": sum(r.ok for r in win),
            "completed_per_s": len(run.completed_in_window) / args.seconds,
            "tokens_per_s": sum(fleet.fns[r.fn].tokens
                                for r in run.completed_in_window)
            / args.seconds,
            "p50": percentile(lat, 50), "p95": percentile(lat, 95),
            "first_third": mean(r.latency for r in win[:third] if r.ok),
            "last_third": mean(r.latency for r in win[-third:] if r.ok),
            "service_s": mean(r.service_s for r in win if r.ok),
            "start_types": {s: sum(r.start_type == s for r in win)
                            for s in sorted({r.start_type for r in win})},
        }), flush=True)


if __name__ == "__main__":
    main()

"""One run of a benchmark cell with the program's own spans switched on
(``repro_torch.runtime.trace``), read as per-layer quantities that the
benchmark does not read yet, on one NVIDIA GPU.

    python3 scripts/program_spans.py --workload <cell> --seed <n> \\
        --seconds <s> [--tracer 0|1] [--profiler 0|1]

The cell runs as ``portbench/run.py`` runs it: the same fleet, traffic,
window and drain, without the check against the reference. ``--tracer 1``
switches the tracer on from the window's opening to its close.
``--profiler 1`` adds the benchmark's traced slice: ``torch.profiler`` over
the window's last 12 s, with the harness's own wrappers, as in a
``--trace 1`` run. The readings are taken over the slice, or over the
whole window without the profiler. With ``--tracer 0 --profiler 0`` it is
an untraced run; beside ``--tracer 1 --profiler 0`` on the same seed, it
gives the tracer's cost. Prints the card and its power limit, then one
JSON line:

  metrics            the cell's own metrics that its data allows
                     (end-to-end; per-layer with the profiler)
  lock_wait_s        ``lock`` span seconds over the ``prefill`` spans
                     started: the wait for a busy endpoint, an execution
  decode_step_ms     mean wall time of the ``decode`` spans
  host_run_share     thread CPU time over wall time of the ``prefill`` and
                     ``decode`` spans, %: below 100 the worker waited
  idle_queued_share  share of the slice with the card idle while some
                     invocation had arrived and was not yet dispatched, %
                     (profiler)
  clock_share        share of the ``flash_fwd`` and ``decode_sm90`` device
                     time in the slice that lies inside some execution's
                     ``prefill``-start-to-``sync``-end, % (profiler)
  counts             in the slice: executions, uploads, bytes uploaded,
                     ``evict`` instants, ``compile`` spans, and the
                     invocations dispatched there that did not start warm
  spans              each span name's count, mean wall ms and CPU share,
                     an execution's first decode step apart from the rest

``--root`` and ``--device cpu`` run a benchmark root of tiny sizes on the
CPU (the tests do).
"""
from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(ROOT / "build" / "torch_extensions"))
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

KERNELS = ("flash_fwd", "decode_sm90")


# -- the view the readers read ------------------------------------------------
def to_window(snap: Dict, origin: float):
    """Wall-clock ns -> seconds from the window's opening, through the
    snapshot's anchors (``origin``: the opening on the monotonic clock)."""
    (m0, w0), (m1, w1) = snap["anchors"]
    d0, skew, span = w0 - m0, snap["skew_ns"], max(w1 - w0, 1)
    return lambda w: (w - d0 - skew * (w - w0) / span) / 1e9 - origin


def view(snap: Dict, origin: float, records: List, offset: float,
         t0: float, t1: float, idle: Optional[List[tuple]] = None) -> Dict:
    """The slice [t0, t1), the tracer's spans and each invocation's
    arrival and dispatch (None if never), all in seconds from the window's
    opening; ``idle``, the card's idle intervals, where it was traced."""
    return {"t0": t0, "t1": t1,
            "spans": [{"name": s["name"], "thread": s["thread"],
                       "fn": s["fn"], "bytes": s["bytes"],
                       "start": s["start_ns"] / 1e9 - origin,
                       "end": s["end_ns"] / 1e9 - origin,
                       "cpu": s["cpu_ns"] / 1e9}
                      for s in snap["spans"]],
            "invocations": [(r.inv.arrival + offset, r.t_dispatch)
                            for r in records],
            "idle": idle}


def started(v: Dict, *names: str) -> List[Dict]:
    return [s for s in v["spans"]
            if s["name"] in names and v["t0"] <= s["start"] < v["t1"]]


def overlap(a: List[tuple], b: List[tuple]) -> float:
    """Length of the intersection of two lists of disjoint intervals."""
    a, b, i, j, out = sorted(a), sorted(b), 0, 0, 0.0
    while i < len(a) and j < len(b):
        out += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def union(iv: List[tuple]) -> List[tuple]:
    out: List[list] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return [tuple(x) for x in out]


def lock_wait_s(v: Dict) -> Optional[float]:
    n = len(started(v, "prefill"))
    if not n:
        return None
    clip = [(max(s["start"], v["t0"]), min(s["end"], v["t1"]))
            for s in v["spans"] if s["name"] == "lock"]
    return sum(max(0.0, e - s) for s, e in clip) / n


def decode_step_ms(v: Dict) -> Optional[float]:
    d = started(v, "decode")
    return 1e3 * statistics.fmean(s["end"] - s["start"] for s in d) \
        if d else None


def host_run_share(v: Dict) -> Optional[float]:
    sp = started(v, "prefill", "decode")
    wall = sum(s["end"] - s["start"] for s in sp)
    return 100.0 * sum(s["cpu"] for s in sp) / wall if wall > 0 else None


def idle_queued_share(v: Dict) -> Optional[float]:
    if v["idle"] is None:
        return None
    t0, t1 = v["t0"], v["t1"]
    held = union([(max(a, t0), min(t1 if d is None else d, t1))
                  for a, d in v["invocations"]])
    return 100.0 * overlap(held, union(v["idle"])) / (t1 - t0)


def executions(spans: List[Dict], start="start", end="end") -> List[tuple]:
    """(prefill start, end of the next sync on its thread) of every
    execution among ``spans``; one still running when the record closed
    ends at infinity."""
    out = []
    for p in spans:
        if p["name"] == "prefill":
            ends = [s[end] for s in spans if s["name"] == "sync"
                    and s["thread"] == p["thread"] and s[start] >= p[start]]
            out.append((p[start], min(ends, default=float("inf"))))
    return out


def by_name(v: Dict) -> Dict:
    """For each span name: [spans started, mean wall ms, thread CPU over
    wall %]; ``decode`` split into each execution's first step
    (``decode.first``) and the rest (``decode.rest``)."""
    groups: Dict[str, List[Dict]] = {}
    last: Dict[int, str] = {}
    for s in sorted(v["spans"], key=lambda s: s["start"]):
        if s["name"] == "decode":
            first = last.get(s["thread"]) == "prefill"
            groups.setdefault("decode." + ("first" if first else "rest"),
                              []).append(s)
        if s["name"] in ("prefill", "decode"):
            last[s["thread"]] = s["name"]
    for s in v["spans"]:
        groups.setdefault(s["name"], []).append(s)
    out = {}
    for name, sp in sorted(groups.items()):
        sp = [s for s in sp if v["t0"] <= s["start"] < v["t1"]]
        wall = sum(s["end"] - s["start"] for s in sp)
        if sp:
            out[name] = [len(sp), 1e3 * wall / len(sp),
                         100.0 * sum(s["cpu"] for s in sp) / wall
                         if wall > 0 else None]
    return out


def counts(v: Dict, records: List) -> Dict:
    compiles = [(s["thread"], s["start"], s["end"])
                for s in v["spans"] if s["name"] == "compile"]
    warmups = [p for p in started(v, "prefill")
               if any(p["thread"] == th and a <= p["start"] <= b
                      for th, a, b in compiles)]
    ups = started(v, "upload")
    return {"executions": len(started(v, "prefill")) - len(warmups),
            "uploads": len(ups), "bytes_uploaded": sum(s["bytes"]
                                                       for s in ups),
            "evictions": len(started(v, "evict")),
            "compiles": len(started(v, "compile")),
            "dispatched_not_warm": sum(
                r.t_dispatch is not None and r.start_type != "warm"
                and v["t0"] <= r.t_dispatch < v["t1"] for r in records)}


def clock_share(snap: Dict, dev: List[tuple], w0: int, w1: int
                ) -> Optional[float]:
    """% of the named kernels' device time in [w0, w1) (wall ns) that lies
    inside some execution of the snapshot's spans."""
    ker = [(max(s, w0), min(e, w1)) for n, s, e in dev
           if any(k in n for k in KERNELS) and min(e, w1) > max(s, w0)]
    total = sum(e - s for s, e in ker)
    if not total:
        return None
    runs = union(executions(snap["spans"], "start_wall_ns", "end_wall_ns"))
    return 100.0 * sum(overlap([k], runs) for k in ker) / total


def idle_gaps(dev: List[tuple], w0: int, w1: int) -> List[tuple]:
    """The intervals of [w0, w1) with no device operation."""
    gaps, end = [], w0
    for s, e in union([(max(s, w0), min(e, w1)) for _, s, e in dev]):
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if w1 > end:
        gaps.append((end, w1))
    return gaps


# -- the run ------------------------------------------------------------------
def run(workload: str, seed: int, seconds: float, tracer: bool,
        profiler: bool, device: str = "cuda", root: Path = ROOT) -> Dict:
    import torch

    from portbench.harness import loader
    from portbench.harness.cell import serve
    from portbench.harness.fleet import Fleet, Spans
    from portbench.harness.stats import Run
    from portbench.harness.trace import TRACE_S, Slice
    from repro_torch.runtime import trace

    cell = loader.load_cell(workload, profiler, root)
    bench = loader.read_json(root / "BENCHMARK.json")
    metrics = loader.reported(bench, workload, False) + cell.metrics
    dev = torch.device(device)
    spans = Spans() if profiler else None
    fleet = Fleet(cell.config, seed, dev, spans)
    fleet.build()
    timers, sl = [], None
    if profiler:
        sl = Slice(spans)
        timers += [(max(seconds - TRACE_S, 0.0), sl.start),
                   (seconds, sl.stop)]
    if tracer:       # on before the slice opens, off after it closes
        timers += [(0.0, trace.enable), (seconds, trace.disable)]
    drive = serve(fleet, cell, seed, seconds, timers)
    snap = trace.snapshot() if tracer else None
    res = Run(seconds, fleet.fns, drive.records,
              [(t0 - drive.origin, s, n) for t0, s, n in fleet.uploads],
              drive.origin - T_START, sl.summarize() if sl else None,
              dict(spans.bound_s) if spans else {})
    out: Dict = {"workload": workload, "seed": seed, "tracer": tracer,
                 "profiler": profiler, "metrics": {}}
    for m in metrics:
        val = loader.reader(m["name"], root).read(res)
        if val is not None:
            out["metrics"][m["name"]] = val
    out["service_s"] = loader.reader("service_s", root).read(res)
    if snap is not None:
        if "warning" in snap:
            out["clock_warning"] = snap["warning"]
        t0, t1, idle = 0.0, seconds, None
        if sl is not None:
            wall = to_window(snap, drive.origin)
            t0, t1 = wall(sl.t0), wall(sl.t1)
            ops = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in sl.prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation()]
            idle = [(wall(s), wall(e))
                    for s, e in idle_gaps(ops, sl.t0, sl.t1)]
            out["clock_share"] = clock_share(snap, ops, sl.t0, sl.t1)
        v = view(snap, drive.origin, drive.records, drive.offset, t0, t1,
                 idle)
        for f in (lock_wait_s, decode_step_ms, host_run_share,
                  idle_queued_share):
            out[f.__name__] = f(v)
        out["counts"] = counts(v, drive.records)
        out["spans"] = by_name(v)
    fleet.free()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--tracer", type=int, choices=(0, 1), default=1)
    ap.add_argument("--profiler", type=int, choices=(0, 1), default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", type=Path, default=ROOT)
    args = ap.parse_args(argv)
    import torch
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("needs a CUDA device", file=sys.stderr)
            return 2
        from portbench.harness.cell import power_limit_w
        print(json.dumps({"card": torch.cuda.get_device_name(0),
                          "power_limit_w": power_limit_w()}), flush=True)
    out = run(args.workload, args.seed, args.seconds, bool(args.tracer),
              bool(args.profiler), args.device, args.root)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

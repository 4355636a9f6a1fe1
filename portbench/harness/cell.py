"""One run of a cell: set-up, warm traffic, the window, the drain, the
metrics, then the check against the reference."""
from __future__ import annotations

import gc
import subprocess
import time
from typing import Dict, List, Optional, Tuple

import torch

from portbench.harness import check, loader
from portbench.harness.drive import Drive
from portbench.harness.fleet import Fleet, Spans
from portbench.harness.stats import Run, percentile
from portbench.harness.trace import TRACE_S, Slice

def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20).stdout
        return float(out.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def serve(fleet: Fleet, cell: loader.Cell, seed: int, seconds: float,
          timers=(), mix: Optional[Dict] = None) -> Drive:
    """The cell's traffic (``mix`` in place of the cell's, if given) through
    a new wall-clock server over the fleet: the warm-up, the window and the
    drain. Returns the finished ``Drive``."""
    from repro_torch.server import ServerConfig, make_server
    mix = mix or cell.mix
    server = make_server(ServerConfig(executor="wallclock",
                                      **cell.config["server"]),
                         endpoints=fleet.endpoints)
    server.start()
    drive = Drive(server, seed, mix["warm_s"], seconds, list(timers))
    names = [f["name"] for f in cell.config["functions"]]
    cell.generator.drive(drive, mix, names,
                         {n: fleet.fns[n].arch_id for n in names}, seed)
    drive.finish()
    return drive


def run_cell(cell: loader.Cell, seed: int, seconds: float, device,
             t_start: float, root=loader.ROOT) -> Tuple[Dict, List[Dict]]:
    """(the result line, earlier info lines). ``t_start`` is the process's
    start on the monotonic clock."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    info: List[Dict] = []
    spans = Spans() if cell.trace else None
    fleet = Fleet(cell.config, seed, dev, spans)
    fleet.build()
    sl, timers = None, []
    if cell.trace:
        sl = Slice(spans)
        timers = [(max(seconds - TRACE_S, 0.0), sl.start),
                  (seconds, sl.stop)]
    drive = serve(fleet, cell, seed, seconds, timers)
    setup_s = drive.origin - t_start
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    # uploads on the window's clock
    uploads = [(t0 - drive.origin, s, n) for t0, s, n in fleet.uploads]
    run = Run(seconds, fleet.fns, drive.records, uploads, setup_s,
              sl.summarize() if sl else None,
              dict(spans.bound_s) if spans else {})
    metrics = {}
    for m in cell.metrics:
        v = loader.reader(m["name"], root).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    window = run.window
    late = [r.sent - r.due for r in window]
    info.append({"setup_parts": dict(fleet.parts,
                                     warm_traffic_s=cell.mix["warm_s"],
                                     setup_s=setup_s)})
    info.append({"window": {
        "due": len(window), "answered": sum(r.ok for r in window),
        "completed_in_window": len(run.completed_in_window),
        "sent_in_warmup": sum(r.due < 0 for r in run.records),
        "lateness_p50_s": percentile(late, 50),
        "lateness_p99_s": percentile(late, 99),
        "lateness_max_s": max(late, default=None),
        "start_types": {t: sum(r.start_type == t for r in window)
                        for t in sorted({r.start_type for r in window})},
        "uploads_in_window": sum(0 <= u[0] < seconds for u in uploads)}})
    if cuda:
        info.append({"card": torch.cuda.get_device_name(dev),
                     "power_limit_w": power_limit_w()})
    picks = check.sample(window, fleet.fns,
                         cell.config["check"]["sample"], seed)
    fleet.free()
    del drive, fleet
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    nums = check.numbers(window, run.fns, picks, cell.config, dev)
    result = {
        "correct": check.correct(nums),
        "attempted": len(window),
        "failed": sum(not r.ok for r in window),
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda
                   else "cpu", "count": 1, "memory_peak_bytes": peak}}
    if run.trace:
        result["device"]["busy_s"] = run.trace["busy_s"]
        result["device"]["window_s"] = run.trace["window_s"]
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["checks"] = nums
    return result, info

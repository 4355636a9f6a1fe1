"""Config-axis sweeps: grid builders, the batched runner, and the serial
scalar reference.

The port of ``repro.batchsim.sweep``. ``run_batch(pa, points)`` stacks
the config points into one leading lane axis, builds a fresh state per
lane on the device and runs the event step over every lane at once in
chunks of ``_CHUNK`` steps, checking between chunks whether any lane
still has work; then it pulls the final state to the host once and
reduces the per-invocation outputs to per-config aggregates (latency
mean/p50/p99, cold-start %, fairness gap/bound, utilization) in numpy.

``run_scalar_reference(pa, **point)`` replays the *same* padded trace
through the port's scalar ``SimExecutor`` with an equivalent
``ServerConfig`` and returns the same aggregate dict (plus the recorded
per-invocation dispatch order).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.batchsim import step
from repro_torch.batchsim.state import (FAM_FCFS, FAM_MQFQ,
                                        START_TYPE_NAMES, build_consts,
                                        init_state, make_params)
from repro_torch.batchsim.step import _work_left, lanes_any, simulate_chunk
from repro_torch.runtime.device import resolve_device
from repro_torch.server.metrics import nearest_rank
from repro_torch.workloads.traces import PaddedArrivals, TraceEvent

# events per chunk between liveness checks, the reference's: one host
# sync per chunk, and at most _CHUNK - 1 no-op steps after the last
# lane finishes
_CHUNK = 128


def stack_params(points: Sequence[Dict], device="cuda") -> Dict:
    """Stack per-config param dicts (``state.make_params``) into one
    leading lane axis on ``device``. The uint64 seed rides as the int64
    of the same bits."""
    if not points:
        raise ValueError("empty config grid")
    dev = resolve_device(device)
    out = {}
    for k in points[0]:
        a = np.stack([np.asarray(pt[k]) for pt in points])
        if a.dtype == np.uint64:
            a = a.view(np.int64)
        out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return out


def run_batch(pa: PaddedArrivals, points: Sequence[Dict], *,
              max_steps: Optional[int] = None,
              consts: Optional[Dict] = None,
              init: Optional[Dict] = None,
              device="cuda") -> Dict:
    """Run every config point over ``pa`` as one lane each, on
    ``device`` (CUDA unless ``device="cpu"`` is asked for).

    Returns ``{"raw": <final states as host numpy, leading lane axis>,
    "summary": [per-config aggregate dicts], "syncs": <host syncs>,
    "steps": <event steps run>, "device": <device name>}``. Slot
    capacities are sized to the grid (max D, max pool size). Pass ``consts=build_consts(pa, device=...)``
    / ``init=init_state(..., G=len(points), device=...)`` to skip
    rebuilding them across repeated calls; ``init`` is not modified.
    """
    dev = resolve_device(device)
    G = len(points)
    p = stack_params(points, dev)
    if consts is None:
        consts = build_consts(pa, max_steps=max_steps, device=dev)
    F = len(pa.fn_ids)
    NE = pa.times.shape[0]
    S = int(max(int(pt["d"]) for pt in points))
    C = int(max(int(pt["pool_size"]) for pt in points)) + S + 1
    A = 2 * F + 8
    if init is None:
        out = init_state(F, NE, S, C, A, G=G, device=dev)
    else:
        # the output record is written in place: work on a copy
        out = {k: v.clone() for k, v in init.items()}
    syncs0 = step.lanes_any.syncs
    steps = 0
    while True:
        out = simulate_chunk(p, consts, out, _CHUNK)
        steps += _CHUNK
        if not lanes_any(_work_left(consts, out)
                         & (out["steps"] < consts["max_steps"])):
            break
    out = dict(out)
    out["step_overflow"] = _work_left(consts, out)
    syncs = step.lanes_any.syncs - syncs0
    # one device pull; the aggregates are host numpy, as the reference's
    host = {k: v.cpu().numpy() for k, v in out.items()}
    if bool(host["step_overflow"].any()):
        raise RuntimeError(
            "batchsim step cap hit with work remaining — raise max_steps")
    if bool(host["armed_ovf"].any()):
        raise RuntimeError("batchsim armed-timer stack overflow")
    n = int(pa.n_events)
    arr = np.asarray(pa.times[:n])
    # unpack the packed output record into the per-field "o_*" views
    # callers index
    rec = host["o_rec"]
    host["o_dispatch"] = rec[:, :, 0]
    host["o_completion"] = rec[:, :, 1]
    host["o_service"] = rec[:, :, 2]
    host["o_overhead"] = rec[:, :, 3]
    host["o_start"] = rec[:, :, 4].astype(np.int64)
    host["o_order"] = rec[:, :, 5].astype(np.int64)
    lat = np.sort(rec[:, :n, 1] - arr[None, :], axis=1)
    cold, warm, hwarm = host["cold"], host["warm"], host["host_warm"]
    wtot = np.maximum(cold + warm + hwarm, 1)
    nw = host["n_windows"]
    dur = host["now"]
    summary = []
    for g in range(G):
        row = lat[g]
        summary.append({
            "invocations": n,
            "mean_latency": float(row.mean()) if n else 0.0,
            "p50_latency": float(nearest_rank(row, 0.50)),
            "p99_latency": float(nearest_rank(row, 0.99)),
            "cold_pct": 100.0 * float(cold[g]) / float(wtot[g]),
            "cold": int(cold[g]),
            "warm": int(warm[g]),
            "host_warm": int(hwarm[g]),
            "pool_evictions": int(host["pool_evictions"][g]),
            "decisions": int(host["decisions"][g]),
            "events": int(host["events"][g]),
            "n_windows": int(nw[g]),
            "gap_max": float(host["gap_max"][g]),
            "gap_mean": float(host["gap_sum"][g]) / nw[g] if nw[g] else 0.0,
            "bound_mean": (float(host["bound_sum"][g]) / nw[g]
                           if nw[g] else 0.0),
            "mean_utilization": (float(host["util_integral"][g])
                                 / max(float(dur[g]), 1e-9)),
            "duration": float(dur[g]),
        })
    return {"raw": host, "summary": summary, "syncs": syncs,
            "steps": steps, "device": str(dev)}


# -- serial scalar reference -------------------------------------------------
def _trace_from(pa: PaddedArrivals) -> List[TraceEvent]:
    n = int(pa.n_events)
    return [TraceEvent(float(pa.times[k]), pa.fn_ids[int(pa.fn_idx[k])])
            for k in range(n)]


def make_scalar_policy(point: Dict):
    """The scalar Policy instance equivalent to a ``make_params``
    point."""
    from repro_torch.core.mqfq import MQFQSticky
    from repro_torch.core.policies import make_policy
    fam = int(point["family"])
    if fam == FAM_MQFQ:
        return MQFQSticky(T=float(point["T"]),
                          alpha=float(point["alpha"]),
                          sticky=bool(point["sticky"]),
                          vt_by_service=bool(point["vt_by_service"]),
                          deficit_vt=bool(point["deficit"]))
    return make_policy("fcfs" if fam == FAM_FCFS else "sjf")


def run_scalar_reference(pa: PaddedArrivals, point: Dict,
                         trace: Optional[List[TraceEvent]] = None) -> Dict:
    """One config point through the port's scalar ``SimExecutor`` — the
    differential reference, on the host. Returns the batch plane's
    aggregate dict plus per-invocation arrays and the observed dispatch
    order."""
    from repro_torch.server.config import ServerConfig, make_server

    policy = make_scalar_policy(point)
    cfg = ServerConfig(
        d=int(point["d"]), n_devices=1,
        pool_size=int(point["pool_size"]),
        capacity_bytes=int(point["capacity"]),
        h2d_bw=float(point["h2d_bw"]), beta=float(point["beta"]),
        fairness_window=float(point["window"]),
        strict_reclaim=False, metrics="full")
    server = make_server(cfg, fns=dict(pa.fns), policy=policy)

    order: List[int] = []
    orig = policy.on_dispatch

    def record(q, inv, now):
        order.append(inv.inv_id)
        orig(q, inv, now)

    policy.on_dispatch = record
    res = server.run_trace(trace if trace is not None
                           else _trace_from(pa))

    n = int(pa.n_events)
    stype = np.full(n, -1, dtype=np.int64)
    dispatch = np.full(n, -1.0)
    completion = np.full(n, -1.0)
    service = np.zeros(n)
    overhead = np.zeros(n)
    code = {name: i for i, name in enumerate(START_TYPE_NAMES)}
    for inv in res.invocations:
        k = inv.inv_id
        dispatch[k] = inv.dispatch_time
        completion[k] = inv.completion
        service[k] = inv.service_time
        overhead[k] = inv.overhead
        stype[k] = code[inv.start_type]
    pool = res.pool
    wins = res.fairness.windows
    cp = server.control
    lat = np.sort(completion - np.asarray(pa.times[:n]))
    wtot = pool.cold_starts + pool.warm_starts + pool.host_warm_starts
    return {
        "order": order,
        "dispatch": dispatch, "completion": completion,
        "service": service, "overhead": overhead, "start": stype,
        "invocations": n,
        "mean_latency": float(lat.mean()) if n else 0.0,
        "p50_latency": float(nearest_rank(lat, 0.50)),
        "p99_latency": float(nearest_rank(lat, 0.99)),
        "cold": pool.cold_starts, "warm": pool.warm_starts,
        "host_warm": pool.host_warm_starts,
        "cold_pct": (100.0 * pool.cold_starts / wtot) if wtot else 0.0,
        "pool_evictions": pool.evictions,
        "decisions": policy.decisions,
        "n_windows": len(wins),
        "gap_max": max((w.max_gap for w in wins), default=0.0),
        "gap_mean": (sum(w.max_gap for w in wins) / len(wins)
                     if wins else 0.0),
        "bound_mean": (sum(w.bound for w in wins) / len(wins)
                       if wins else 0.0),
        "mean_utilization": cp.util_integral / max(res.duration, 1e-9),
        "duration": res.duration,
    }


# -- fig8-style grids --------------------------------------------------------
FIG8_T_VALUES = (0.0, 1.0, 5.0, 10.0, 20.0, 50.0)
FIG8_ALPHAS = (0.0, 0.5, 1.0, 2.0, 4.0, 6.0)


def fig8_grid(F: int, *, d: int = 2, h2d_bw: float = 12 * 2**30,
              pool_size: int = 32) -> List[Tuple[str, Dict]]:
    """The fig8 panels (a)/(b) + sticky ablation as labelled config
    points: T x vt_by_service, the alpha sweep, sticky on/off."""
    pts: List[Tuple[str, Dict]] = []
    common = dict(d=d, h2d_bw=h2d_bw, pool_size=pool_size)
    for T in FIG8_T_VALUES:
        for vt in (True, False):
            pts.append((f"8a:T={T:g}:vt={'service' if vt else 'unit'}",
                        make_params(F, T=T, vt_by_service=vt, **common)))
    for a in FIG8_ALPHAS:
        pts.append((f"8b:alpha={a:g}",
                    make_params(F, alpha=a, **common)))
    for sticky in (True, False):
        pts.append((f"sticky={sticky}",
                    make_params(F, sticky=sticky, **common)))
    return pts


def sensitivity_grid(F: int, *, d: int = 2, h2d_bw: float = 12 * 2**30,
                     pool_size: int = 32) -> List[Tuple[str, Dict]]:
    """The full T x alpha x vt_by_service x sticky cross product — the
    "whole sensitivity sweep in one launch" grid the throughput gate
    measures (the fig8 panels are 1-D slices of this)."""
    pts = []
    for T in FIG8_T_VALUES:
        for a in FIG8_ALPHAS:
            for vt in (True, False):
                for sticky in (True, False):
                    pts.append((
                        f"T={T:g}:a={a:g}:vt={int(vt)}:s={int(sticky)}",
                        make_params(F, T=T, alpha=a, vt_by_service=vt,
                                    sticky=sticky, d=d, h2d_bw=h2d_bw,
                                    pool_size=pool_size)))
    return pts

"""Struct-of-arrays state for the batch simulator, as torch tensors.

The port of ``repro.batchsim.state``. Three dicts flow through
``step.simulate_one(p, c, st)``:

  - ``c`` (consts, shared by every lane): the padded trace
    (``workloads.traces.padded_arrivals``) plus per-function spec arrays
    and the creation-order ranks the scalar plane tie-breaks on.
  - ``p`` (per-config params, leading lane axis ``G``): policy family,
    T, alpha, sticky, vt_by_service, deficit_vt, D, pool size, memory
    capacity, H2D bandwidth, beta, fairness window, per-flow weights and
    the RNG seed.
  - ``st`` (mutable state, leading lane axis ``G``): flow queues, the
    device memory manager, the warm pool, in-flight completion slots,
    the fairness tracker, the executor bookkeeping and the per-
    invocation output records.

The layout is the reference's: times are float64, counts and indices
int32. The one change of dtype is the seed, a uint64 in the reference,
which rides here as the int64 of the same bits (``step._splitmix``
computes on it with wrap-around arithmetic). Every tensor lives on an
explicit device, which defaults to CUDA: without a card these functions
raise unless ``device="cpu"`` is passed.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.flow import FlowQueue
from repro_torch.runtime.device import resolve_device
from repro_torch.workloads.traces import PaddedArrivals

# QueueState encoding (FlowQueue.state is an enum in the scalar plane)
INACTIVE, ACTIVE, THROTTLED = 0, 1, 2
# start types (scalar plane: WarmPool returns "cold"/"warm"/"host_warm")
COLD, WARM, HOST_WARM = 0, 1, 2
START_TYPE_NAMES = ("cold", "warm", "host_warm")
# policy families
FAM_MQFQ, FAM_FCFS, FAM_SJF = 0, 1, 2
# columns of the per-invocation output record st["o_rec"] (all f64;
# start type and order are small integers, exact in f64)
REC_COLS = ("dispatch", "completion", "service", "overhead", "start",
            "order")

# FlowQueue's moving-estimate constants, read off the scalar dataclass
# so the mirror can never drift from it silently
EMA = FlowQueue.EMA
TAU0 = FlowQueue.__dataclass_fields__["tau"].default
IAT0 = FlowQueue.__dataclass_fields__["iat"].default

F64, I32, I64 = torch.float64, torch.int32, torch.int64


def build_consts(pa: PaddedArrivals, max_steps: Optional[int] = None,
                 device="cuda") -> Dict:
    """Trace + spec consts for ``simulate_one``, on ``device``. The
    event count and the step cap ride as python ints: the host loop
    reads them, no kernel does."""
    dev = resolve_device(device)
    F = len(pa.fn_ids)
    n = int(pa.n_events)
    specs = [pa.fns[fid] for fid in pa.fn_ids]

    # creation-order rank: the scalar plane creates one FlowQueue (and
    # one memory Region) per function at its FIRST arrival, and every
    # tie-break uses that creation index ``ins``
    first = np.full(F, np.inf)
    for k in range(n):
        f = int(pa.fn_idx[k])
        if not np.isfinite(first[f]):
            first[f] = k
    # never-arriving flows rank last, stably by index
    ins = np.argsort(np.argsort(first, kind="stable"), kind="stable")

    # per-flow invocation ids in arrival order: inv_id == merged trace
    # index (the SimExecutor numbers arrivals in pop order)
    PF = pa.per_fn_times.shape[1]
    per_fn_inv = np.zeros((F, PF), dtype=np.int64)
    fill = np.zeros(F, dtype=np.int64)
    for k in range(n):
        f = int(pa.fn_idx[k])
        per_fn_inv[f, fill[f]] = k
        fill[f] += 1

    if max_steps is None:
        # arrivals + completions + drains + timers, with slack; the
        # step flags ``step_overflow`` if work remains at the cap
        max_steps = 4 * max(n, 1) + 64 * F + 1024

    def t(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype).to(dev)

    return {
        "times": t(pa.times, F64),
        # index arrays that only ever index are int64 (torch's index
        # dtype); the padding's -1 is clamped where it is read
        "fn_idx": t(pa.fn_idx, I64),
        "per_fn_times": t(pa.per_fn_times, F64),
        "per_fn_inv": t(per_fn_inv, I32),
        "n_events": n,
        "ins": t(ins, I32),
        "order": t(np.argsort(ins, kind="stable"), I64),
        "warm_time": t([s.warm_time for s in specs], F64),
        "cold_init": t([s.cold_init for s in specs], F64),
        "mem_bytes": t([float(s.mem_bytes) for s in specs], F64),
        "demand": t([s.demand for s in specs], F64),
        "max_steps": int(max_steps),
    }


def make_params(F: int, *, family: int = FAM_MQFQ, T: float = 10.0,
                alpha: float = 2.0, sticky: bool = True,
                vt_by_service: bool = True, deficit_vt: bool = False,
                d: int = 2, pool_size: int = 32,
                capacity_bytes: float = 16 * 2**30,
                h2d_bw: float = 100 * 2**30, beta: float = 0.7,
                fairness_window: float = 30.0, seed: int = 0,
                weights=None) -> Dict[str, np.ndarray]:
    """One config point (defaults mirror ``ServerConfig`` +
    ``MQFQSticky``), host numpy values exactly as the reference's. Stack
    several with ``sweep.stack_params`` to build the lane axis."""
    if weights is None:
        weights = np.ones(F)
    return {
        "family": np.asarray(family, dtype=np.int32),
        "T": np.asarray(T, dtype=np.float64),
        "alpha": np.asarray(alpha, dtype=np.float64),
        "sticky": np.asarray(bool(sticky)),
        "vt_by_service": np.asarray(bool(vt_by_service)),
        "deficit": np.asarray(bool(deficit_vt)),
        "d": np.asarray(int(d), dtype=np.int32),
        "pool_size": np.asarray(int(pool_size), dtype=np.int32),
        "capacity": np.asarray(float(capacity_bytes), dtype=np.float64),
        "h2d_bw": np.asarray(float(h2d_bw), dtype=np.float64),
        "beta": np.asarray(beta, dtype=np.float64),
        "window": np.asarray(fairness_window, dtype=np.float64),
        "weights": np.asarray(weights, dtype=np.float64),
        # plain-MQFQ candidate draw: a splitmix64 counter stream
        "seed": np.asarray(int(seed), dtype=np.uint64),
    }


def init_state(F: int, NE: int, S: int, C: int, A: int, G: int = 1,
               device="cuda") -> Dict[str, torch.Tensor]:
    """Fresh simulator state for ``G`` lanes on ``device``. ``S`` bounds
    in-flight completion slots (>= max D in the sweep), ``C`` bounds
    warm-pool container slots (>= max pool_size + max D + 1: the scalar
    pool only evicts *idle* containers, so totals can exceed pool_size
    by the in-flight count), ``A`` bounds the armed-timer stack
    (strictly decreasing, <= one live timer per flow)."""
    dev = resolve_device(device)

    def full(shape, val, dtype):
        return torch.full((G,) + tuple(shape), val, dtype=dtype, device=dev)

    zf = full((F,), 0.0, F64)
    zi = full((F,), 0, I32)
    zb = full((F,), False, torch.bool)

    def f64(v=0.0):
        return full((), v, F64)

    def i32(v=0):
        return full((), v, I32)

    def b(v=False):
        return full((), v, torch.bool)

    return {
        # flow queues
        "vt": zf, "tau": full((F,), TAU0, F64), "tau_n": zi,
        "iat": full((F,), IAT0, F64), "has_arr": zb,
        "last_arrival": zf, "last_exec": zf,
        "qstate": full((F,), INACTIVE, I32), "created": zb,
        "n_arr": zi, "n_disp": zi, "in_flight": zi,
        "gvt": f64(),
        # device memory manager (one device)
        "region_exists": zb, "resident": zb,
        "upload_eta": full((F,), -1.0, F64), "evictable": zb,
        "r_last_use": zf,
        "mem_used": f64(), "bytes_uploaded": f64(), "bytes_evicted": f64(),
        "prefetch_count": i32(),
        # warm pool
        "c_exists": full((C,), False, torch.bool),
        "c_fn": full((C,), -1, I32),
        "c_idle_seq": full((C,), -1, I32),
        "c_last_use": full((C,), 0.0, F64),
        "fn_stamp": full((F,), -1, I32),
        "stamp_ctr": i32(), "rel_seq": i32(), "pool_total": i32(),
        "cold": i32(), "warm": i32(), "host_warm": i32(),
        "pool_evictions": i32(),
        # device tokens / interference
        "outstanding": i32(), "running_bytes": f64(), "run_cnt": zi,
        "demand_sum": f64(), "busy_time": f64(),
        # in-flight completion slots
        "s_active": full((S,), False, torch.bool),
        "s_time": full((S,), float("inf"), F64),
        "s_seq": full((S,), 0, I32),
        "s_flow": full((S,), 0, I32),
        "s_inv": full((S,), 0, I32),
        "s_service": full((S,), 0.0, F64),
        "s_charged": full((S,), 0.0, F64),
        "s_container": full((S,), 0, I32),
        # per-invocation output fields staged in the slot until the
        # completion event writes the (NE, 6) record
        "s_disp_t": full((S,), 0.0, F64),
        "s_overhead": full((S,), 0.0, F64),
        "s_stype": full((S,), 0, I32),
        # fairness tracker
        "fsvc": zf, "ftau": zf, "ftau_set": zb,
        "disq": zb, "backlogged": zb,
        "f_t0": f64(), "n_windows": i32(),
        "gap_max": f64(), "gap_sum": f64(), "bound_sum": f64(),
        # executor bookkeeping
        "arr_ptr": i32(),
        "armed": full((A,), float("inf"), F64),
        "n_armed": i32(), "armed_ovf": b(),
        "now": f64(), "events": i32(), "steps": i32(),
        "step_overflow": b(),
        "util_integral": f64(), "last_t": f64(), "last_u": f64(),
        "dp_synced": b(), "decisions": i32(), "dispatch_seq": i32(),
        # per-invocation outputs (indexed by merged trace position), one
        # packed (NE, 6) record written per completion: columns are
        # REC_COLS
        "o_rec": torch.tensor([-1.0, -1.0, 0.0, 0.0, -1.0, -1.0],
                              dtype=F64, device=dev).repeat(G, NE, 1),
    }

"""Fault plans: seeded, fully-expanded fault schedules.

A plan is expanded to explicit records AT CONSTRUCTION (``generate``
draws every fault time/target from one ``random.Random(seed)``), so the
same ``FaultPlan`` object handed to a ``SimExecutor`` and a
``WallClockExecutor`` injects the identical fault sequence — the
executors never roll dice at run time.

Times are in scenario seconds: virtual seconds for the simulator, wall
seconds since ``start()`` for the wall-clock executors (trace seconds
for feeder outages, which the replay harness paces). Endpoint faults
are *count*-triggered — "the nth execution attempt of fn" — which is
the only trigger that lands on the same logical attempt under both
clocks, so parity tests use endpoint faults.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Optional, Tuple

INF = float("inf")


@dataclass(frozen=True)
class DeviceFault:
    """Device ``dev_id`` fails at ``t`` for ``duration`` seconds
    (``inf`` = permanent). In-flight work is killed (sim) or doomed at
    worker return (wallclock); resident regions are invalid after."""
    t: float
    dev_id: int
    duration: float = INF


@dataclass(frozen=True)
class EndpointFault:
    """The ``nth`` execution attempt (0-based, per-fn, counted across
    retries) of ``fn_id`` fails. ``mode="error"`` raises immediately;
    ``mode="hang"`` stalls the attempt for ``latency`` seconds before
    the watchdog kills the container."""
    fn_id: str
    nth: int
    mode: str = "error"          # "error" | "hang"
    latency: float = 0.0


@dataclass(frozen=True)
class TransferFault:
    """Abort the in-flight H2D transfer for ``fn_id`` on ``dev_id`` at
    ``t`` (``fn_id=None`` aborts every transfer on the device).
    Requires ``datapath="pipeline"`` (sim only)."""
    t: float
    dev_id: int
    fn_id: Optional[str] = None


@dataclass(frozen=True)
class FeederFault:
    """Kill replay feeder ``shard`` at trace-time ``t``; it restarts
    ``down_s`` trace-seconds later and releases the backlog late (the
    lateness is recorded by the replay harness)."""
    t: float
    shard: int = 0
    down_s: float = 1.0


@dataclass(frozen=True)
class FaultPlan:
    device_faults: Tuple[DeviceFault, ...] = ()
    endpoint_faults: Tuple[EndpointFault, ...] = ()
    transfer_faults: Tuple[TransferFault, ...] = ()
    feeder_faults: Tuple[FeederFault, ...] = ()
    seed: int = 0

    def __bool__(self) -> bool:
        return bool(self.device_faults or self.endpoint_faults
                    or self.transfer_faults or self.feeder_faults)

    @classmethod
    def generate(cls, *, seed: int, horizon_s: float, n_devices: int,
                 fn_ids, device_faults: int = 0, device_down_s: float = 5.0,
                 permanent_devices: int = 0,
                 endpoint_fault_frac: float = 0.0,
                 endpoint_faults_per_fn: int = 1,
                 endpoint_hang_frac: float = 0.25, hang_s: float = 0.05,
                 max_nth: int = 20,
                 transfer_faults: int = 0,
                 feeder_faults: int = 0, n_feeders: int = 1,
                 feeder_down_s: float = 1.0) -> "FaultPlan":
        """Expand probabilistic fault rates into an explicit schedule.

        Fault times land in [0.1, 0.8] x horizon so transient faults
        clear (and quarantined devices re-admit) before the trace ends.
        """
        rng = random.Random(seed)
        fn_list = sorted(fn_ids)
        devs = []
        for i in range(device_faults):
            t = rng.uniform(0.1 * horizon_s, 0.8 * horizon_s)
            dur = (INF if i < permanent_devices
                   else device_down_s * rng.uniform(0.5, 1.5))
            devs.append(DeviceFault(t, rng.randrange(n_devices), dur))
        eps = []
        for fn in fn_list:
            if rng.random() >= endpoint_fault_frac:
                continue
            nths = rng.sample(range(max_nth),
                              min(endpoint_faults_per_fn, max_nth))
            for nth in sorted(nths):
                hang = rng.random() < endpoint_hang_frac
                eps.append(EndpointFault(
                    fn, nth, "hang" if hang else "error",
                    hang_s if hang else 0.0))
        xfers = []
        for _ in range(transfer_faults):
            t = rng.uniform(0.1 * horizon_s, 0.8 * horizon_s)
            xfers.append(TransferFault(t, rng.randrange(n_devices), None))
        feeds = []
        for _ in range(feeder_faults):
            t = rng.uniform(0.1 * horizon_s, 0.6 * horizon_s)
            feeds.append(FeederFault(t, rng.randrange(n_feeders),
                                     feeder_down_s))
        return cls(tuple(devs), tuple(eps), tuple(xfers), tuple(feeds),
                   seed=seed)

"""Deterministic fault injection and recovery (ISSUE 9).

``FaultPlan`` is a frozen, fully-expanded schedule of faults — device
failures, endpoint errors/hangs, H2D transfer aborts, feeder outages —
delivered via ``ServerConfig(faults=...)``. Both executor families
replay the identical plan: the simulator injects at event time, the
wall-clock executors via a wrapper endpoint (``FaultyEndpoint``) plus a
device watchdog thread.

The recovery side (retry with exponential backoff, re-queue with VT
un-charge, quarantine + health-check re-admission, SLO-aware shedding)
lives in ``repro.server.control`` / ``repro.server.executors``; this
package owns the *what fails when* and the shared counters
(``FaultInjector`` / ``FaultStats``).
"""
from repro_torch.faults.plan import (DeviceFault, EndpointFault, FaultPlan,
                               FeederFault, TransferFault)
from repro_torch.faults.inject import (FaultError, FaultInjector, FaultStats,
                                 FaultyEndpoint)

__all__ = [
    "FaultPlan", "DeviceFault", "EndpointFault", "TransferFault",
    "FeederFault",
    "FaultInjector", "FaultStats", "FaultError", "FaultyEndpoint",
]

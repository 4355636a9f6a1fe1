"""Batched MQFQ-Sticky simulator: whole sensitivity sweeps as lanes of
one set of tensors on the card.

The port of ``repro.batchsim``. All flow/queue/device/warm-pool state
lives in fixed-shape tensors with a leading lane (config) axis
(``state.py``); one event step advances every lane at once through an
exact array-program mirror of the scalar plane's semantics (``step.py``)
— Eq.-1 eligibility + throttle, sticky tie-break, VT advance, D-token
accounting, anticipatory TTL lapse, warm-pool hit/miss with the scalar
cold-cost model — and ``sweep.run_batch`` runs a (T, alpha, D, policy,
weights) grid as the lanes of one run.

The scalar ``SimExecutor`` stays the reference: the port's tests hold
it per invocation to the reference's ``run_batch`` and to the scalar
plane. There is no global switch to flip: every time is float64 by
dtype, as the scalar plane's python floats are. The entry points run on
CUDA unless ``device="cpu"`` is passed.
"""
from __future__ import annotations

from repro_torch.batchsim.state import (ACTIVE, COLD, FAM_FCFS, FAM_MQFQ,
                                        FAM_SJF, HOST_WARM, INACTIVE,
                                        THROTTLED, WARM, build_consts,
                                        init_state, make_params)
from repro_torch.batchsim.step import simulate_one
from repro_torch.batchsim.sweep import (fig8_grid, run_batch,
                                        run_scalar_reference)

__all__ = [
    "ACTIVE", "COLD", "FAM_FCFS", "FAM_MQFQ", "FAM_SJF", "HOST_WARM",
    "INACTIVE", "THROTTLED", "WARM", "build_consts", "init_state",
    "make_params", "simulate_one", "fig8_grid", "run_batch",
    "run_scalar_reference",
]

"""Device-concurrency (D) token controller with utilization feedback.

Paper §4.4: D is either fixed or adjusted dynamically under a utilization
threshold, with a hard max. On GPU the feedback signal is NVML polling; in
this TPU adaptation the signal is model-based occupancy (each in-flight
program's compute-demand fraction from the roofline cost model) smoothed
with the same moving average — see DESIGN.md §2.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(slots=True)
class ConcurrencyController:
    max_d: int = 2
    dynamic: bool = False
    util_threshold: float = 0.9
    ema: float = 0.3

    current_d: int = 0
    outstanding: int = 0
    util: float = 0.0          # instantaneous occupancy
    util_avg: float = 0.0      # moving average

    def __post_init__(self):
        self.current_d = self.max_d

    def acquire(self) -> bool:
        if self.outstanding >= self.current_d:
            return False
        self.outstanding += 1
        return True

    def release(self) -> None:
        assert self.outstanding > 0
        self.outstanding -= 1

    def report_utilization(self, util: float) -> bool:
        """Feed an occupancy sample; adjust D if dynamic (paper §4.4).
        Returns True iff ``current_d`` changed, so the control plane can
        run its ``policy.device_parallelism`` min-sync only on actual
        budget transitions instead of once per event.

        The EMA depends on the *number* of samples, not elapsed time, so
        under dynamic D the control plane must keep feeding one sample
        per event (the transition-driven sampler does; with ``dynamic``
        off it skips this call entirely — the EMA is pure telemetry
        then and ``current_d`` never moves)."""
        self.util = util
        self.util_avg = (1 - self.ema) * self.util_avg + self.ema * util
        if not self.dynamic:
            return False
        if self.util_avg > self.util_threshold and self.current_d > 1:
            self.current_d -= 1
            return True
        elif self.util_avg < 0.8 * self.util_threshold \
                and self.current_d < self.max_d:
            self.current_d += 1
            return True
        return False

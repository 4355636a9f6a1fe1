"""Service-time fairness accounting and the Eq. 1 bound (paper §4.2).

For backlogged flows i, j over an interval:
    | S_i/w_i - S_j/w_j | <= (D - 1) (2T + tau_i/w_i - tau_j/w_j)

``FairnessTracker`` accumulates per-flow device service time in fixed
windows (30 s in the paper's Fig. 5) restricted to flows backlogged for
the whole window, and evaluates the observed max gap vs the bound.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class WindowRecord:
    t0: float
    t1: float
    service: Dict[str, float]
    backlogged: Dict[str, bool]
    max_gap: float
    bound: float


class FairnessTracker:
    """Event-driven: callers report backlog *transitions* (O(1) per
    event) instead of re-observing every flow after every event (the
    seed's O(F)-per-event scan, which dominated at thousands of flows).
    A flow qualifies for a window's bound iff it was never seen
    non-backlogged between the window's start and its roll.

    Per-event hot paths gate ``maybe_roll`` behind the roll deadline
    instead of paying the call every event. The gate MUST use the exact
    expression of maybe_roll's own guard — ``now - _t0 >= window`` —
    never a precomputed ``now >= _t0 + window``: float(t0 + w) can round
    one ulp away from the subtraction form, silently skipping (or
    double-testing) a roll. See ``ControlPlane._sample_transition``."""

    def __init__(self, window: float = 30.0, T: float = 10.0, D: int = 2,
                 record_service: bool = True):
        self.window = window
        self.T = T
        self.D = D
        # False (lean runs): keep each window's gap/bound verdict but not
        # its per-flow service dict — constant memory per window instead
        # of O(F), which dominated RSS on million-event replays
        self.record_service = record_service
        self._t0 = 0.0
        self._service: Dict[str, float] = defaultdict(float)
        self._tau: Dict[str, float] = {}
        self._disqualified: set = set()
        self.windows: List[WindowRecord] = []

    def on_backlog_change(self, fn_id: str, backlogged: bool) -> None:
        """Call when a flow's backlog status flips: going idle at any
        point disqualifies it from the current window's bound."""
        if not backlogged:
            self._disqualified.add(fn_id)

    def add_service(self, fn_id: str, amount: float, tau: float,
                    weight: float = 1.0) -> None:
        self._service[fn_id] += amount / weight
        self._tau[fn_id] = tau / weight

    def maybe_roll(self, now: float, backlogged=None,
                   all_flows=None) -> Optional[WindowRecord]:
        """Roll the window if due. ``backlogged`` is the set of currently
        backlogged flows; ``all_flows`` every known flow (both only
        iterated here, once per window, so rolls stay O(F) while events
        stay O(1))."""
        if now - self._t0 < self.window:
            return None
        if backlogged is None:          # legacy call: qualify by service
            backlogged = set(self._service)
        flows = [f for f in backlogged if f not in self._disqualified]
        rec = None
        if len(flows) >= 2:
            s = [self._service[f] for f in flows]
            taus = [self._tau.get(f, 0.0) for f in flows]
            max_gap = max(s) - min(s)
            bound = (self.D - 1) * (2 * self.T + max(taus) - min(taus))
            rec = WindowRecord(
                self._t0, now,
                dict(self._service) if self.record_service else {},
                {f: True for f in flows} if self.record_service else {},
                max_gap, bound)
            self.windows.append(rec)
        self._t0 = now
        self._service.clear()
        # flows idle at the window boundary cannot be "backlogged for the
        # whole window" that just started
        self._disqualified = (set(all_flows) - set(backlogged)
                              if all_flows is not None else set())
        return rec

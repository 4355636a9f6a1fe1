"""What the metric readers read: a finished run's records, and the
statistics they take over them."""
from __future__ import annotations

import statistics
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The q-th percentile (0-100), interpolated between closest ranks as
    numpy's default does; None for no values."""
    v = sorted(values)
    if not v:
        return None
    x = (len(v) - 1) * q / 100.0
    lo = int(x)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (x - lo)


def mean(values: Sequence[float]) -> Optional[float]:
    values = list(values)
    return statistics.fmean(values) if values else None


@dataclass
class Run:
    """A run as its readers see it. ``records`` holds every invocation
    sent, warm-up included; ``window`` those due in [0, seconds). Times
    are seconds from the window's opening."""
    seconds: float
    fns: Dict
    records: List
    uploads: List[tuple]          # (start s, seconds, bytes)
    setup_s: float
    trace: Optional[Dict] = None  # trace.summarize's, in a traced run
    bound_s: Dict = field(default_factory=dict)

    @property
    def window(self) -> List:
        return [r for r in self.records if 0 <= r.due < self.seconds]

    @property
    def completed_in_window(self) -> List:
        return [r for r in self.records
                if r.ok and 0 <= r.t_done < self.seconds]

    def latencies(self) -> List[float]:
        return [r.latency for r in self.window if r.ok]

    def kernel_s(self, *names: str) -> float:
        """Device seconds of the traced operations whose name holds any of
        ``names``."""
        return sum(s for n, s in (self.trace or {}).get("op_s", {}).items()
                   if any(k in n for k in names))

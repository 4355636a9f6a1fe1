"""In-memory endpoint stub implementing the JaxEndpoint protocol.

Used by the sim-vs-wallclock parity tests and anywhere the wall-clock
executor should run without JAX: ``execute`` returns immediately but
*reports* the spec's warm time as its execution time, so policy state
(tau EMAs, virtual time, fairness service) evolves exactly as in the
virtual-clock simulation of the same trace.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from repro_torch.workloads.spec import FunctionSpec


class StubEndpoint:
    def __init__(self, fn_id: str, spec: FunctionSpec,
                 delay: Optional[float] = 0.0,
                 cold_delay: Optional[float] = 0.0,
                 upload_delay: float = 0.0):
        """``delay``: real seconds to hold the endpoint busy per request;
        ``None`` sleeps the spec's warm time, making wall-clock event
        ordering (dispatch -> follow-up choose -> ... -> completion)
        mirror the virtual clock's.

        ``cold_delay`` / ``upload_delay``: real seconds slept inside
        ``compile`` / ``upload`` (``cold_delay=None`` sleeps the spec's
        ``cold_init``). Defaults keep the historical instant-cold
        behavior; the replay benchmarks set them so locality differences
        between policies (warm-set thrash vs sticky reuse) cost real
        wall time instead of being invisible to the stub."""
        self.fn_id = fn_id
        self.spec = spec
        self.delay = spec.warm_time if delay is None else delay
        self.cold_delay = spec.cold_init if cold_delay is None else cold_delay
        self.upload_delay = upload_delay
        self.weight_bytes = spec.mem_bytes
        self.lock = threading.Lock()
        self.last_use = 0.0
        self._compiled = False
        self._resident = False
        # op counters (asserted by tests)
        self.compile_count = 0
        self.upload_count = 0
        self.evict_count = 0
        self.execute_count = 0

    @property
    def compiled(self) -> bool:
        return self._compiled

    @property
    def resident(self) -> bool:
        return self._resident

    def compile(self) -> float:
        if self.cold_delay:
            time.sleep(self.cold_delay)
        self._compiled = True
        self._resident = True
        self.compile_count += 1
        return self.cold_delay

    def upload(self) -> float:
        if self.upload_delay:
            time.sleep(self.upload_delay)
        self._resident = True
        self.upload_count += 1
        return self.upload_delay

    def evict(self) -> None:
        self._resident = False
        self.evict_count += 1

    def execute(self, request: Optional[dict] = None) -> Dict[str, float]:
        assert self._compiled and self._resident
        self.execute_count += 1
        if self.delay:
            time.sleep(self.delay)
        return {"exec_s": self.spec.warm_time}

"""The wall clock that drives the shared ControlPlane.

``WallClockExecutor`` — dedicated dispatcher thread (paper §5) + bounded
                        worker pool over real ``TorchEndpoint`` execution;
                        service times are measured, not modeled.

It calls the ControlPlane methods in the same order per event as
``repro.server.executors``: on_arrival / drain / on_complete / sample.
Dispatch is batched (paper §5: the dispatcher thread services every
freed token / newly-eligible queue in one pass). The ``Server`` facade
fronts the executor. The port's copy carries the wall-clock executor
only: the simulator (``SimExecutor``) and the sharded executor wait on
the port queue in ROADMAP.md.
"""
from __future__ import annotations

import heapq
import itertools
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

from repro_torch.core.flow import QueueState
from repro_torch.faults import FaultError
from repro_torch.runtime.invocation import Invocation
from repro_torch.server.control import ControlPlane, DispatchDecision
from repro_torch.server.events import EventBus
from repro_torch.server.metrics import RunResult


class WallClockExecutor:
    """Threaded executor over real endpoints (replaces the old
    ``ServingEngine``), now with the full control plane: multi-device
    placement, warm-pool container accounting, memory admission control
    and fairness tracking.

    ``id_counter`` / ``subscribe_state`` / ``t0`` exist for the sharded
    coordinator (``ShardedWallClockExecutor``), which runs one of these
    per shard: a shared invocation-id counter keeps ids globally unique,
    the shared clock origin keeps per-shard timestamps comparable, and
    the coordinator subscribes to the (shared) bus once instead of once
    per shard."""

    def __init__(self, control: ControlPlane, endpoints: Dict, config,
                 id_counter=None, subscribe_state: bool = True,
                 t0: Optional[float] = None):
        self.control = control
        self.endpoints = endpoints
        self.config = config
        # resolved once: this used to be re-read via getattr on every
        # dispatcher pass
        self._batch = getattr(config, "batch_dispatch", True)
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._lock = threading.RLock()
        # signaled (under _lock) after every completion: drain() waits on
        # this instead of burning CPU in a sleep/poll loop — the drained
        # condition (no pending, no inflight) can only become true at a
        # completion
        self._idle = threading.Condition(self._lock)
        workers = max(config.d * config.n_devices, 1)
        self._pool = ThreadPoolExecutor(max_workers=workers + 1)
        self._dispatcher: Optional[threading.Thread] = None
        self._t0 = time.monotonic() if t0 is None else t0
        self.completed: List[Invocation] = []
        self._inflight = 0
        self._ids = itertools.count() if id_counter is None else id_counter
        # fault plane: a device-fault watchdog mirrors the sim's
        # DEV_FAULT/HEALTH events onto the wall clock; failed attempts
        # park on a retry heap the dispatcher drains when due
        self._injector = getattr(control, "injector", None)
        self._recovery = bool(getattr(config, "recovery", True))
        self._retry_heap: List = []        # (due, inv_id, inv)
        self._pending_retries = 0
        self._doomed: set = set()          # inv_ids doomed by device fault
        self._watchdog: Optional[threading.Thread] = None
        # control-plane events -> real data movement
        if subscribe_state:
            control.bus.on_state_change(self._on_state_change)
        for dev in control.devices:
            dev.mem.evict_listeners.append(self._on_region_evicted)

    # -- time ---------------------------------------------------------------
    def now(self) -> float:
        return time.monotonic() - self._t0

    # -- memory integration ----------------------------------------------------
    def _on_state_change(self, ev) -> None:
        """Anticipatory prefetch: queue turned Active -> upload weights
        asynchronously, off the critical path (§4.3)."""
        ep = self.endpoints.get(ev.fn_id)
        if ep is None or ev.new is not QueueState.ACTIVE:
            return
        try:
            self._pool.submit(self._prefetch, ep)
        except RuntimeError:
            pass  # pool shutting down: prefetch is best-effort anyway

    @staticmethod
    def _prefetch(ep) -> None:
        with ep.lock:
            if ep.compiled and not ep.resident:
                ep.upload()

    def _on_region_evicted(self, fn_id: str) -> None:
        """The memory manager swapped a region out: mirror it on the real
        endpoint (skip if the function is mid-execution; accounting and
        reality reconcile at its next dispatch)."""
        ep = self.endpoints.get(fn_id)
        if ep is None:
            return
        q = self.control.policy.queues.get(fn_id)
        if q is not None and q.in_flight > 0:
            return
        ep.evict()

    # -- API ------------------------------------------------------------------
    def submit(self, fn_id: str, request: Optional[dict] = None
               ) -> Invocation:
        with self._lock:
            inv = Invocation(fn_id, self.now(), inv_id=next(self._ids))
            inv.request = request  # type: ignore[attr-defined]
            self.control.on_arrival(inv, inv.arrival)
            if inv.shed:        # degraded mode rejected it at the door
                self.completed.append(inv)
            self.control.sample(inv.arrival)
        self._wake.set()
        return inv

    def start(self) -> None:
        self._dispatcher = threading.Thread(target=self._run, daemon=True)
        self._dispatcher.start()
        inj = self._injector
        if inj is not None and inj.plan.device_faults and self._recovery:
            self._watchdog = threading.Thread(target=self._watchdog_loop,
                                              daemon=True)
            self._watchdog.start()

    def drain(self, timeout: float = 300.0) -> None:
        """Block until no work is pending, in flight, or parked for
        retry. Waits on the completion condition variable (the old
        implementation polled at 10 ms, burning a core for the length of
        any long real run). On timeout the executor is torn down — stop
        event set, dispatcher joined, worker pool released — *before*
        ``TimeoutError`` propagates, so a wedged run does not leak
        threads that keep dispatching behind the caller's back."""
        deadline = time.monotonic() + timeout
        timed_out = False
        with self._idle:
            while (self.control.total_pending != 0 or self._inflight != 0
                   or self._pending_retries != 0):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    timed_out = True
                    break
                self._idle.wait(remaining)
        if timed_out:
            self._stop.set()
            self._wake.set()
            if self._dispatcher is not None:
                self._dispatcher.join(timeout=5)
            if self._watchdog is not None:
                self._watchdog.join(timeout=5)
            self._pool.shutdown(wait=False, cancel_futures=True)
            raise TimeoutError("engine did not drain")

    def stop(self) -> RunResult:
        self._stop.set()
        self._wake.set()
        if self._dispatcher:
            self._dispatcher.join(timeout=10)
        if self._watchdog is not None:
            self._watchdog.join(timeout=10)
        self._pool.shutdown(wait=True)
        cp = self.control
        inj = self._injector
        return RunResult(cp.policy.name, list(self.completed), cp.fairness,
                         cp.pool, cp.util_samples, cp.devices, self.now(),
                         util_integral=cp.util_integral,
                         faults=inj.snapshot() if inj is not None else None)

    # -- dispatcher ---------------------------------------------------------------
    def _run(self) -> None:
        while not self._stop.is_set():
            if self._retry_heap:        # unlocked peek: worst case the
                self._drain_retries()   # retry waits one 50 ms pass
            dispatched = self._dispatch_batch()
            if not dispatched:
                self._wake.wait(timeout=0.05)
                self._wake.clear()

    def _drain_retries(self) -> None:
        with self._lock:
            now = self.now()
            while self._retry_heap and self._retry_heap[0][0] <= now:
                _, _, inv = heapq.heappop(self._retry_heap)
                self.control.requeue(inv, now)
                self._pending_retries -= 1

    # -- fault plane --------------------------------------------------------
    def _watchdog_loop(self) -> None:
        """Mirror of the sim's DEV_FAULT/HEALTH events: apply device
        faults from the shared plan when due, doom their in-flight
        attempts (threads cannot be cancelled — the worker routes to the
        failure path when it returns), and re-admit quarantined devices
        once healthy."""
        cp = self.control
        faults = sorted(self._injector.plan.device_faults,
                        key=lambda f: f.t)
        i = 0
        health: List = []               # (due, dev_id) min-heap
        while not self._stop.is_set():
            now = self.now()
            while i < len(faults) and faults[i].t <= now:
                f = faults[i]
                i += 1
                with self._lock:
                    doomed = cp.fail_device(f.dev_id, now)
                    self._doomed.update(inv.inv_id for inv in doomed)
                if f.duration != float("inf"):
                    heapq.heappush(health,
                                   (max(now + cp.quarantine_s,
                                        f.t + f.duration), f.dev_id))
                self._wake.set()
            while health and health[0][0] <= now:
                due, dev_id = heapq.heappop(health)
                with self._lock:
                    t = cp.readmit_device(dev_id, now)
                if t is not None:
                    heapq.heappush(health, (t, dev_id))
                    break               # not due yet: wait it out
                self._wake.set()
            if i >= len(faults) and not health:
                return
            self._stop.wait(0.02)

    def _fail_attempt(self, inv: Invocation, mode: str) -> None:
        with self._lock:
            now = self.now()
            rt = self.control.on_attempt_failed(inv, now, mode)
            if rt is not None:
                heapq.heappush(self._retry_heap, (rt, inv.inv_id, inv))
                self._pending_retries += 1
            else:                       # retry budget exhausted: dropped
                self.completed.append(inv)
            self.control.sample(now)
            self._inflight -= 1
            self._idle.notify_all()
        self._wake.set()

    def _realize_decision(self, decision) -> None:
        """Hand one decision to the worker pool (hoisted out of
        ``_dispatch_batch`` so the dispatcher loop does not allocate a
        closure per pass). Callers hold ``_lock``."""
        self._inflight += 1
        self._pool.submit(self._execute, decision)

    def _dispatch_batch(self) -> bool:
        """One dispatcher-thread pass (paper §5): drain every dispatchable
        invocation under a single lock acquisition instead of re-taking
        the lock (and re-entering the control plane) once per token."""
        with self._lock:
            if self._batch:
                return bool(self.control.drain(
                    self.now(), realize=self._realize_decision))
            decision = self.control.try_dispatch(self.now())
            if decision is None:
                return False
            self._realize_decision(decision)
            return True

    def _execute(self, d: DispatchDecision) -> None:
        inv = d.inv
        ep = self.endpoints[inv.fn_id]
        inj = self._injector
        fault: Optional[str] = None
        try:
            try:
                if inj is not None and not self._recovery \
                        and inj.device_down(d.device.dev_id, self.now()):
                    # naive reference platform: the down device stays in
                    # rotation and fail-fasts everything sent to it
                    inv.exec_start = self.now()
                    inv.overhead = 0.0
                    inv.service_time = 0.0
                    raise FaultError(inv.fn_id, "device")
                overhead0 = self.now()
                with ep.lock:  # one container instance: run-to-completion
                    # reconcile reality with the control plane's decision:
                    # cold -> compile (+upload), host_warm/warm -> ensure
                    # weights are on device (prefetch may still be in flight)
                    if not ep.compiled:
                        ep.compile()
                    elif not ep.resident:
                        ep.upload()
                    ep.last_use = self.now()
                    inv.exec_start = self.now()
                    inv.overhead = inv.exec_start - overhead0
                    out = ep.execute(getattr(inv, "request", None))
                    inv.service_time = out["exec_s"]
            except FaultError as e:
                fault = e.mode
                if inv.service_time is None:
                    inv.service_time = 0.0
        finally:
            if inj is not None:
                with self._lock:
                    if inv.inv_id in self._doomed:
                        self._doomed.discard(inv.inv_id)
                        if fault is None:
                            fault = "device"
            if fault is not None and self._recovery:
                self._fail_attempt(inv, fault)
            else:
                if fault is not None:
                    inv.failed = True
                with self._lock:
                    now = self.now()
                    inv.completion = now
                    self.completed.append(inv)
                    self.control.on_complete(inv, now)
                    self.control.sample(now)
                    self._inflight -= 1
                    self._idle.notify_all()
                self._wake.set()


class Server:
    """Facade over (config, control plane, executor): drive it with
    ``start/submit/drain/stop``."""

    def __init__(self, config, control: ControlPlane, executor, bus: EventBus):
        self.config = config
        self.control = control
        self.executor = executor
        self.bus = bus
        self.scenario = None       # set by make_server when config.scenario

    # -- wallclock -----------------------------------------------------------
    def _wallclock(self):
        if not isinstance(self.executor, WallClockExecutor):
            raise TypeError("this method requires executor='wallclock'")
        return self.executor

    def start(self) -> None:
        self._wallclock().start()

    def submit(self, fn_id: str, request: Optional[dict] = None
               ) -> Invocation:
        return self._wallclock().submit(fn_id, request)

    def drain(self, timeout: float = 300.0) -> None:
        self._wallclock().drain(timeout)

    def stop(self) -> RunResult:
        return self._wallclock().stop()

    @property
    def completed(self) -> List[Invocation]:
        return self._wallclock().completed

"""The two clocks that drive the shared ControlPlane.

``SimExecutor``       — discrete-event heap over a virtual clock; models
                        service times (warm time x memory multiplier x
                        oversubscription stretch, paper Fig. 6a).
``WallClockExecutor`` — dedicated dispatcher thread (paper §5) + bounded
                        worker pool over real ``TorchEndpoint`` execution;
                        service times are measured, not modeled.

Both call the ControlPlane methods in the same order per event as
``repro.server.executors``: on_arrival / drain / on_complete / sample.
Dispatch is batched (paper §5: the dispatcher thread services every
freed token / newly-eligible queue in one pass). ``SimExecutor`` is the
reference's class as it is; the ``Server`` facade fronts whichever
executor the config selects. The port's copy cuts the sharded executor
(``ShardedWallClockExecutor``, ROADMAP.md section 1, item 15), and
``make_server`` refuses the configs that would reach the sim's data
plane (item 16) or a scenario (item 17).
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
from repro_torch.server.metrics import RunResult, StreamingStats


class SimExecutor:
    """Virtual-clock discrete-event executor (replaces the loop that
    lived in ``repro.runtime.simulate.Simulation``).

    Scales to million-invocation traces: arrivals are pulled lazily from
    the trace iterable (one in the heap at a time, so streaming
    generators run in constant memory), anticipatory-TTL expiries are
    scheduled as first-class TIMER events from the policy's expiry index
    (``Policy.next_expiry``) instead of being discovered at whichever
    arrival/completion happens to rescan next, and ``metrics="lean"``
    aggregates completions into ``StreamingStats`` rather than keeping
    every ``Invocation``.

    Event ordering key is (time, kind, seq): at equal timestamps arrivals
    precede completions precede timers — the same tie-break the seed's
    materialize-all-arrivals-first heap produced."""

    ARRIVAL, COMPLETE, TIMER, TRANSFER = 0, 1, 2, 3
    # fault plane (repro.faults): injected fault deliveries and the
    # recovery events they spawn, ordered after the regular kinds so at
    # equal timestamps real work settles before faults land
    DEV_FAULT, XFER_FAULT, ATTEMPT_FAIL, RETRY, HEALTH = 4, 5, 6, 7, 8

    def __init__(self, control: ControlPlane, config):
        self.control = control
        self.config = config
        self.lean = getattr(config, "metrics", "full") == "lean"
        self.invocations: List[Invocation] = []
        self.stats: Optional[StreamingStats] = \
            StreamingStats() if self.lean else None
        self.events = 0
        self.batch = getattr(config, "batch_dispatch", True)
        self._transition = \
            getattr(config, "sampling", "transition") != "per_event"
        # cold-start data plane (datapath="pipeline"): transfer
        # completions become first-class TRANSFER events and dispatches
        # whose weights are mid-flight wait on the link's re-planned
        # completion instead of the acquire-time estimate
        self._pipeline = getattr(config, "datapath", "scalar") == "pipeline"
        self._xfer_armed: Optional[float] = None   # earliest armed TRANSFER
        if self._pipeline:
            self._stage_fixed: Dict[str, float] = {}  # fn -> setup+compile
            # chunked layer streaming: execution starts when the first
            # chunk_bytes land; None waits for the full transfer (PR-6)
            self._chunk_bytes = getattr(config, "chunk_bytes", None)
            # instance attr shadows the method: the fast loop binds
            # ``self._realize`` once, so scalar mode pays no branch
            self._realize = self._realize_pipeline
        # fault plane: wrap whatever realize is bound (scalar or
        # pipeline) so the fault-free path keeps its exact callable and
        # runs bit-identical when no injector is configured
        self._injector = getattr(control, "injector", None)
        self._recovery = bool(getattr(config, "recovery", True))
        # inv_id -> count of COMPLETE events in the heap that belong to
        # attempts doomed by a device fault; popped as pure no-ops
        self._stale: Dict[int, int] = {}
        if self._injector is not None:
            self._realize_inner = self._realize
            self._realize = self._realize_faulty
        self._heap: List = []
        self._seq = itertools.count()
        self._n_arrived = 0
        self._last_arrival_t = float("-inf")
        # TTL timer times already in the heap. ``_arm_timer`` only arms a
        # time strictly below every armed one, so in insertion order the
        # list is strictly decreasing, and timers fire smallest-first —
        # i.e. it is a stack: append on arm, pop on fire, peek the
        # current minimum at [-1]. The seed kept a set and ran
        # ``min(self._armed)`` per event — O(|armed|) every event and
        # quadratic when many TTL timers were in flight.
        self._armed: List[float] = []
        # per-event cost breakdown (ns), filled by run_profiled only
        self.event_ns: Dict[str, int] = {}

    def _push(self, t: float, kind: int, payload) -> None:
        heapq.heappush(self._heap, (t, kind, next(self._seq), payload))

    def _pull_arrival(self, it) -> None:
        """Admit the next trace event (arrivals stay sorted, so one
        pending arrival in the heap keeps global event order)."""
        ev = next(it, None)
        if ev is None:
            return
        t, fn_id = ev          # TraceEvent tuple-unpack: no attr protocol
        if t < self._last_arrival_t:
            raise ValueError(
                f"trace must be time-sorted: got arrival at {t} "
                f"after {self._last_arrival_t} (the streaming executor "
                f"admits one pending arrival at a time)")
        self._last_arrival_t = t
        inv = Invocation(fn_id, t, inv_id=self._n_arrived)
        self._n_arrived += 1
        if not self.lean:
            self.invocations.append(inv)
        heapq.heappush(self._heap, (t, self.ARRIVAL, next(self._seq), inv))

    def run(self, trace) -> RunResult:
        cp = self.control
        if self._pipeline and not (self.batch and self._transition):
            raise ValueError(
                "datapath='pipeline' requires the fast event loop "
                "(batch_dispatch=True, sampling='transition'): the "
                "reference loops carry no TRANSFER events")
        inj = self._injector
        if inj is not None:
            if not (self.batch and self._transition):
                raise ValueError(
                    "fault injection requires the fast event loop "
                    "(batch_dispatch=True, sampling='transition'); the "
                    "reference loops carry no fault events")
            for f in inj.plan.device_faults:
                self._push(f.t, self.DEV_FAULT, f)
            for tf in inj.plan.transfer_faults:
                self._push(tf.t, self.XFER_FAULT, tf)
        it = iter(trace)
        self._pull_arrival(it)
        now = 0.0
        if self.batch and self._transition:
            now = self._run_fast(it, now)
        else:
            now = self._run_reference(it, now)
        return RunResult(cp.policy.name, self.invocations, cp.fairness,
                         cp.pool, cp.util_samples, cp.devices, now,
                         stats=self.stats, util_integral=cp.util_integral,
                         faults=inj.snapshot() if inj is not None else None)

    def _run_fast(self, it, now: float) -> float:
        """Allocation-light event loop: the batched drain is inlined as a
        direct ``dispatch_once`` loop (no per-event list, no per-event
        ``realize`` closure), hot callables are bound once, and the event
        counter lives in a local. Event semantics — handler order,
        dispatch order, sample-after-drain, timer re-arm — are identical
        to ``_run_reference``; tests/test_event_loop_equivalence.py holds
        the two bit-identical."""
        cp = self.control
        heap = self._heap
        pop = heapq.heappop
        push = heapq.heappush
        seq = self._seq
        on_arrival = cp.on_arrival
        on_complete = cp.on_complete
        sample = cp.sample
        dispatch_once = cp.dispatch_once
        realize = self._realize
        pull = self._pull_arrival
        next_expiry = cp.policy.next_expiry
        armed = self._armed
        record = self.stats.record if self.lean else None
        ARRIVAL, COMPLETE, TIMER = self.ARRIVAL, self.COMPLETE, self.TIMER
        TRANSFER = self.TRANSFER
        pipeline = self._pipeline
        stale = self._stale
        events = 0
        while heap:
            now, kind, _, payload = pop(heap)
            events += 1
            if pipeline:
                cp.datapath_tick(now)
            if kind == ARRIVAL:
                on_arrival(payload, now)
                pull(it)
            elif kind == COMPLETE:
                if stale:       # device fault doomed this attempt: the
                    n = stale.get(payload.inv_id)   # event is a no-op
                    if n is not None:
                        if n == 1:
                            del stale[payload.inv_id]
                        else:
                            stale[payload.inv_id] = n - 1
                        continue
                on_complete(payload, now)
                if record is not None and not payload.failed:
                    record(payload)
            elif kind == TIMER:         # queue-state housekeeping
                armed.pop()             # fired timers pop in LIFO order
            elif kind == TRANSFER:      # link completions
                self._xfer_armed = None
                cp.advance_transfers(now)
            else:                       # fault plane
                self._handle_fault(kind, payload, now)
            while True:
                d = dispatch_once(now)
                if d is None:
                    break
                realize(d, now)
            if pipeline:
                # anticipatory prefetch for flows the drain left queued,
                # then (re-)arm the earliest transfer completion. Spurious
                # wakes after a replan are harmless: advance is idempotent
                # and the handler re-arms from the live link state.
                cp.prefetch_pass(now)
                eta = cp.next_transfer_eta()
                if eta is not None and (self._xfer_armed is None
                                        or eta < self._xfer_armed):
                    self._xfer_armed = eta
                    push(heap, (eta, TRANSFER, next(seq), None))
            sample(now)
            due = next_expiry(now, armed[-1] if armed else None)
            if due is not None and (not armed or due < armed[-1]):
                armed.append(due)
                push(heap, (due, TIMER, next(seq), None))
        self.events += events
        return now

    def _run_reference(self, it, now: float) -> float:
        """Pre-PR event loop (``sampling="per_event"`` and/or
        ``batch_dispatch=False``): per-event ``drain`` call with a fresh
        ``realize`` closure and decision list, or the seed's
        one-``try_dispatch``-per-call loop. The differential-testing and
        perf reference for the fast loop above."""
        cp = self.control
        while self._heap:
            now, kind, _, payload = heapq.heappop(self._heap)
            self.events += 1
            if kind == self.ARRIVAL:
                cp.on_arrival(payload, now)
                self._pull_arrival(it)
            elif kind == self.COMPLETE:
                cp.on_complete(payload, now)
                if self.lean:
                    self.stats.record(payload)
            else:                       # TIMER: queue-state housekeeping
                self._armed.pop()
            if self.batch:
                cp.drain(now, realize=lambda d: self._realize(d, now))
            else:               # legacy per-token loop (differential tests)
                while True:
                    decision = cp.try_dispatch(now)
                    if decision is None:
                        break
                    self._realize(decision, now)
            cp.sample(now)
            self._arm_timer(now)
        return now

    def _arm_timer(self, now: float) -> None:
        """Schedule the next anticipatory-TTL lapse as an event so the
        policy's Active->Inactive transitions (and the memory swap-outs
        they trigger) happen on time. One pending timer suffices — the
        earliest — since its handler re-arms; ``_armed`` keeps revived
        queues from re-queueing a time that is already scheduled. Armed
        times are tracked as a strictly-decreasing stack, so the
        currently-earliest is ``[-1]`` in O(1) (the seed's set +
        ``min()`` scan was O(|armed|) per event). The ``bound`` hint (an
        O(1) early-out inside the policy's expiry index) is withheld in
        per_event mode so the reference keeps the pre-PR full-peek
        cost."""
        armed = self._armed
        due = self.control.policy.next_expiry(
            now, armed[-1] if armed and self._transition else None)
        if due is not None and (not armed or due < armed[-1]):
            armed.append(due)
            self._push(due, self.TIMER, None)

    def _realize(self, d: DispatchDecision, now: float) -> None:
        """Model execution: overhead from data readiness + cold init,
        service stretched by memory policy and oversubscription (paper
        D=3 contention, Fig. 6a); completions do not retroactively speed
        up peers."""
        inv, spec, dev = d.inv, d.spec, d.device
        overhead = d.ready - now
        if d.start_type == "cold":
            overhead += spec.cold_init
        if self._transition:            # cached (recomputed on change)
            demand_sum = dev.demand_total()     # includes this invocation
        else:                           # pre-PR reference: fresh dict sum
            demand_sum = sum(dev.demands.values())
        stretch = 1.0 + self.config.beta * max(0.0, demand_sum - 1.0)
        service = spec.warm_time * d.mem_mult * stretch

        start = now + overhead
        completion = start + service
        inv.overhead = overhead
        inv.exec_start = start
        inv.service_time = service
        inv.completion = completion
        dev.busy_time += service
        heapq.heappush(self._heap,
                       (completion, self.COMPLETE, next(self._seq), inv))

    def _realize_pipeline(self, d: DispatchDecision, now: float) -> None:
        """Pipeline-datapath realize (``datapath="pipeline"``): cold
        fixed stages (container setup + XLA compile) overlap the weight
        transfer — Zhao et al.'s fast-setup pipeline — so a cold start
        costs max(setup + compile, transfer wait), not their sum. A
        dispatch whose weights are mid-flight upgrades the transfer to
        the demand class and waits on the link's *actual* completion
        callback (re-planned under contention), not the acquire-time
        estimate."""
        from repro_torch.datapath.stages import stages_for
        inv, spec, dev = d.inv, d.spec, d.device
        demand_sum = dev.demand_total()     # includes this invocation
        stretch = 1.0 + self.config.beta * max(0.0, demand_sum - 1.0)
        service = spec.warm_time * d.mem_mult * stretch
        fixed = 0.0
        if d.start_type == "cold":
            fixed = self._stage_fixed.get(inv.fn_id)
            if fixed is None:
                fixed = stages_for(spec, self.config.h2d_bw).fixed_s
                self._stage_fixed[inv.fn_id] = fixed
        dp = dev.datapath
        t = dp.transfers.get(inv.fn_id)
        if t is not None:
            # weights still in flight: prioritize the transfer and
            # finish realization when the bytes actually land
            dp.mark_demand(inv.fn_id, now)
            floor = now + fixed

            def finish(t_done, inv=inv, now=now, floor=floor,
                       service=service, dev=dev, dp=dp):
                if t_done is None:      # transfer aborted (fault plane,
                    self._finish_failed(inv, dp.now, dp.now, dev)
                    return              # recovery off): attempt fails
                self._finish_realize(
                    inv, now, t_done if t_done > floor else floor,
                    service, dev)

            cb = self._chunk_bytes
            if cb is not None:
                # chunked layer streaming: execution starts at the
                # first-chunk milestone; the residual keeps streaming
                # demand-class on the same link, overlapped with the run
                if dp.await_first_chunk(inv.fn_id, cb, finish, now):
                    return
                # first chunk already on device: start at the floor
                self._finish_realize(inv, now,
                                     floor if floor > now else now,
                                     service, dev)
                return
            t.waiters.append(finish)
            return
        ready = d.ready
        start = ready if ready > now else now
        floor = now + fixed
        if floor > start:
            start = floor
        self._finish_realize(inv, now, start, service, dev)

    def _finish_realize(self, inv: Invocation, now: float, start: float,
                        service: float, dev) -> None:
        inv.overhead = start - now
        inv.exec_start = start
        inv.service_time = service
        inv.completion = start + service
        dev.busy_time += service
        heapq.heappush(self._heap,
                       (inv.completion, self.COMPLETE, next(self._seq),
                        inv))

    # -- fault plane --------------------------------------------------------
    def _realize_faulty(self, d: DispatchDecision, now: float) -> None:
        """Realize wrapper installed when a ``FaultInjector`` is
        configured: consults the endpoint-fault schedule (nth execution
        attempt per fn, counted across retries — the one trigger that is
        deterministic under both clocks) before handing off to the real
        realize. With recovery on, a faulty attempt becomes an
        ATTEMPT_FAIL event at the fault's manifestation time; with
        recovery off it "completes" as a failure through the normal
        COMPLETE path — the naive reference platform."""
        inj = self._injector
        inv = d.inv
        if not self._recovery and inj.device_down(d.device.dev_id, now):
            # naive platform: the down device stays in rotation and
            # fail-fasts everything dispatched to it
            self._finish_failed(inv, now, now, d.device)
            return
        f = inj.next_endpoint_fault(inv.fn_id)
        if f is not None:
            t_fail = now + (f.latency if f.latency > 0.0 else 0.0)
            if self._recovery:
                self._push(t_fail, self.ATTEMPT_FAIL, (inv, f.mode))
            else:
                self._finish_failed(inv, now, t_fail, d.device)
            return
        self._realize_inner(d, now)

    def _finish_failed(self, inv: Invocation, now: float, t_fail: float,
                       dev) -> None:
        """Recovery-off reference: the attempt terminates as a failed
        completion through the ordinary COMPLETE machinery, so every
        resource/fairness hook runs exactly as for a success (including
        the tau-EMA pollution a naive platform suffers)."""
        inv.failed = True
        inv.overhead = 0.0
        inv.exec_start = now
        inv.service_time = t_fail - now
        inv.completion = t_fail
        dev.busy_time += t_fail - now
        heapq.heappush(self._heap,
                       (t_fail, self.COMPLETE, next(self._seq), inv))

    def _handle_fault(self, kind: int, payload, now: float) -> None:
        cp = self.control
        if kind == self.DEV_FAULT:
            f = payload
            doomed = cp.fail_device(f.dev_id, now)
            if self._recovery:
                if doomed:
                    # only attempts with a COMPLETE already in the heap
                    # are stale-marked: a transfer-waiting attempt has
                    # none, and wrongly marking it would swallow its
                    # retry's completion
                    ids = {inv.inv_id for inv in doomed}
                    pending = set()
                    for _, k, _, p in self._heap:
                        if k == self.COMPLETE and p.inv_id in ids:
                            pending.add(p.inv_id)
                    for iid in pending:
                        self._stale[iid] = self._stale.get(iid, 0) + 1
                    for inv in doomed:
                        rt = cp.on_attempt_failed(inv, now, "device")
                        if rt is not None:
                            self._push(rt, self.RETRY, inv)
                if f.duration != float("inf"):
                    self._push(max(now + cp.quarantine_s,
                                   f.t + f.duration), self.HEALTH, f.dev_id)
        elif kind == self.XFER_FAULT:
            cp.abort_transfers(payload.dev_id, payload.fn_id, now)
        elif kind == self.ATTEMPT_FAIL:
            inv, mode = payload
            rt = cp.on_attempt_failed(inv, now, mode)
            if rt is not None:
                self._push(rt, self.RETRY, inv)
        elif kind == self.RETRY:
            cp.requeue(payload, now)
        else:                           # HEALTH: quarantine re-admission
            t = cp.readmit_device(payload, now)
            if t is not None:
                self._push(t, self.HEALTH, payload)

    def run_profiled(self, trace) -> RunResult:
        """``run`` with a per-event cost breakdown (benchmarks.scale
        --event-profile): wall time per loop segment accumulates into
        ``self.event_ns``:

          heap      event pop + next-arrival pull/push
          arrival   ControlPlane.on_arrival
          complete  ControlPlane.on_complete (+ lean stats record)
          dispatch  the drain loop: choose/place/admit/pool/mem/realize,
                    including DispatchEvent construction when emitted
          sample    ControlPlane.sample
          timer     next_expiry peek + timer arming
          bus       time inside EventBus.emit_* (subset of the above;
                    ~0 under sampling="transition" with no subscribers —
                    the fast path never constructs or emits)

        Instrumented and therefore slower than ``run``; results are
        bit-identical (the clock reads do not feed the model)."""
        cp = self.control
        if self._pipeline:
            raise ValueError(
                "run_profiled does not support datapath='pipeline' "
                "(its loop carries no TRANSFER events); profile the "
                "scalar datapath instead")
        if self._injector is not None:
            raise ValueError(
                "run_profiled does not support fault injection (its "
                "loop carries no fault events); profile fault-free")
        clock = time.perf_counter_ns
        ns = self.event_ns = {k: 0 for k in (
            "heap", "arrival", "complete", "dispatch", "sample", "timer",
            "bus")}
        it = iter(trace)        # may raise: must precede the bus wrapping
        bus = cp.bus
        wrapped = ("emit_state_change", "emit_dispatch", "emit_complete")
        for name in wrapped:
            def timed(ev, _orig=getattr(bus, name)):
                t0 = clock()
                _orig(ev)
                ns["bus"] += clock() - t0
            setattr(bus, name, timed)
        now = 0.0
        armed = self._armed
        heap = self._heap
        use_drain = not (self.batch and self._transition)
        try:
            self._pull_arrival(it)
            while heap:
                t0 = clock()
                now, kind, _, payload = heapq.heappop(heap)
                ns["heap"] += clock() - t0
                self.events += 1
                if kind == self.ARRIVAL:
                    t0 = clock()
                    cp.on_arrival(payload, now)
                    t1 = clock()
                    self._pull_arrival(it)
                    t2 = clock()
                    ns["arrival"] += t1 - t0
                    ns["heap"] += t2 - t1
                elif kind == self.COMPLETE:
                    t0 = clock()
                    cp.on_complete(payload, now)
                    if self.lean:
                        self.stats.record(payload)
                    ns["complete"] += clock() - t0
                else:
                    armed.pop()
                t0 = clock()
                if use_drain and self.batch:
                    cp.drain(now, realize=lambda d: self._realize(d, now))
                elif use_drain:
                    while True:
                        decision = cp.try_dispatch(now)
                        if decision is None:
                            break
                        self._realize(decision, now)
                else:
                    while True:
                        d = cp.dispatch_once(now)
                        if d is None:
                            break
                        self._realize(d, now)
                t1 = clock()
                cp.sample(now)
                t2 = clock()
                self._arm_timer(now)
                t3 = clock()
                ns["dispatch"] += t1 - t0
                ns["sample"] += t2 - t1
                ns["timer"] += t3 - t2
        finally:
            for name in wrapped:
                delattr(bus, name)  # restore the class methods
        return RunResult(cp.policy.name, self.invocations, cp.fairness,
                         cp.pool, cp.util_samples, cp.devices, now,
                         stats=self.stats, util_integral=cp.util_integral)


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
    """Facade over (config, control plane, executor). Use ``run_trace``
    with the sim executor; ``start/submit/drain/stop`` with wallclock."""

    def __init__(self, config, control: ControlPlane, executor, bus: EventBus):
        self.config = config
        self.control = control
        self.executor = executor
        self.bus = bus
        self.scenario = None       # set by make_server when config.scenario

    # -- sim ---------------------------------------------------------------
    def run_trace(self, trace) -> RunResult:
        if not isinstance(self.executor, SimExecutor):
            raise TypeError("run_trace() requires executor='sim'")
        return self.executor.run(trace)

    def run_scenario(self) -> RunResult:
        """Replay the configured named scenario's (streaming) arrival
        process through the sim executor."""
        if self.scenario is None:
            raise ValueError("ServerConfig.scenario was not set")
        return self.run_trace(self.scenario.stream())

    def replay_open_loop(self, scenario=None, **kw):
        """Open-loop wall-clock replay (``repro.replay``) is not ported
        yet."""
        raise ValueError("replay_open_loop is not ported to repro_torch "
                         "yet: scenarios and open-loop replay, item 17 "
                         "in ROADMAP.md")

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

"""Clock-agnostic serving control plane (paper Alg. 1 + §4.3-§4.4, §5).

``ControlPlane`` owns every control-plane object — Policy, per-device
memory manager + D-token ``ConcurrencyController``, the shared warm pool
and ``FairnessTracker`` — and implements the full dispatch pipeline:

    choose -> pick_device -> admit -> acquire(tokens, container, memory)
           -> classify start_type

It never reads a clock and never models service time: executors feed it
``now`` floats (virtual or wall) and decide what execution means. This is
the single implementation behind both the discrete-event simulator and
the wall-clock JAX engine, so every experiment exercises exactly the
code the real serving path runs.

Dispatch is batched (paper §5 dispatcher thread): ``drain(now)`` runs
the pipeline repeatedly in one pass, amortizing the per-call setup
across every freed token / newly-eligible queue, and hands each
``DispatchDecision`` to the executor's ``realize`` callback *before* the
next choose so modeled state (device demands) evolves exactly as under
the seed's one-decision-per-call loop. ``try_dispatch`` remains as the
single-step shim (``drain(budget=1)``).

The device layer behind the pipeline is selected by
``ServerConfig.device_layer``: "indexed" (heap-indexed hot paths) or
"reference" (the seed's linear scans, kept for differential testing and
perf baselines).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, TYPE_CHECKING

from repro_torch.core.fairness import FairnessTracker
from repro_torch.core.policy_base import Policy
from repro_torch.core.tokens import ConcurrencyController
from repro_torch.core.flow import QueueState
from repro_torch.memory import make_device_layer
from repro_torch.runtime.invocation import Invocation
from repro_torch.server.events import (CompleteEvent, DispatchEvent, EventBus,
                                 StateChangeEvent)
from repro_torch.workloads.spec import FunctionSpec

if TYPE_CHECKING:
    from repro_torch.server.config import ServerConfig


@dataclass(slots=True)
class DeviceState:
    """One accelerator slice: memory manager + D-token controller +
    in-flight bookkeeping. ``dev_id`` is globally unique across the
    whole server (shards of a sharded plane number their devices from a
    base offset); ``slot`` is the device's index within its own control
    plane's ``devices`` list — equal to ``dev_id`` when unsharded."""
    dev_id: int
    mem: object                # DeviceMemoryManager (indexed or reference)
    tokens: ConcurrencyController
    slot: int = 0
    running: Dict[int, str] = field(default_factory=dict)  # inv_id -> fn
    demands: Dict[int, float] = field(default_factory=dict)
    busy_time: float = 0.0
    # running working set: total mem_bytes over *distinct* running fns
    # (the admission rule the seed computed by rebuilding a fn -> bytes
    # dict per dispatch), kept incrementally for O(1) admit
    running_bytes: int = 0
    running_fn_count: Dict[str, int] = field(default_factory=dict)
    # cold-start data plane (repro.datapath.DeviceDataPath); None under
    # datapath="scalar"
    datapath: object = None
    # fault plane: a failed device takes no new dispatches; it is
    # re-admitted by a health check no earlier than ``quarantined_until``
    # (and only once its fault window has actually cleared)
    failed: bool = False
    quarantined_until: float = 0.0
    # demand-sum cache: recomputed (with the exact dict-sum arithmetic,
    # so results stay bit-identical to a fresh scan) only after a
    # dispatch/completion changed ``demands`` — utilization() and the
    # executor's oversubscription stretch stop paying O(|demands|) on
    # events that moved nothing
    _demand_sum: float = field(default=0.0, init=False, repr=False)
    _demand_dirty: bool = field(default=False, init=False, repr=False)

    def demand_total(self) -> float:
        if self._demand_dirty:
            self._demand_sum = sum(self.demands.values())
            self._demand_dirty = False
        return self._demand_sum

    def utilization(self) -> float:
        return min(1.0, self.demand_total())

    def utilization_scan(self) -> float:
        """Pre-PR body: a fresh dict sum per call. Kept as the
        ``sampling="per_event"`` reference so the perf comparison
        measures the cost this cache removed."""
        return min(1.0, sum(self.demands.values()))

    def note_dispatch(self, inv_id: int, fn_id: str, spec: FunctionSpec
                      ) -> None:
        self.running[inv_id] = fn_id
        self.demands[inv_id] = spec.demand
        self._demand_dirty = True
        n = self.running_fn_count.get(fn_id, 0)
        if n == 0:
            self.running_bytes += spec.mem_bytes
        self.running_fn_count[fn_id] = n + 1

    def note_complete(self, inv_id: int, fn_id: str, spec: FunctionSpec
                      ) -> None:
        self.running.pop(inv_id, None)
        self.demands.pop(inv_id, None)
        self._demand_dirty = True
        n = self.running_fn_count.get(fn_id, 0) - 1
        if n <= 0:
            self.running_fn_count.pop(fn_id, None)
            self.running_bytes -= spec.mem_bytes
        else:
            self.running_fn_count[fn_id] = n


@dataclass(slots=True)
class DispatchDecision:
    """Everything an executor needs to realize one dispatched invocation."""
    inv: Invocation
    device: DeviceState
    spec: FunctionSpec
    start_type: str           # warm | host_warm | cold
    ready: float              # when the function's data is on device
    mem_mult: float           # execution stretch from the memory policy


class ControlPlane:
    def __init__(self, policy: Policy, fns: Dict[str, FunctionSpec],
                 config: "ServerConfig", bus: Optional[EventBus] = None,
                 dev_base: int = 0, injector=None):
        self.policy = policy
        self.fns = fns
        self.config = config
        self.bus = bus or EventBus()
        layer = getattr(config, "device_layer", "indexed")
        mem_cls, pool_cls = make_device_layer(layer)
        # second-pass reclaim semantics (ServerConfig.strict_reclaim):
        # the reference layer IS the seed's strict behavior — its
        # constructor takes no flag and the config one is ignored there;
        # the retired-quirk mode only exists on the indexed manager
        mem_kw = {}
        if layer != "reference":
            mem_kw["strict_reclaim"] = bool(
                getattr(config, "strict_reclaim", True))
        self.pool = pool_cls(config.pool_size)
        # dev_base: first global device id of this plane's group (shards
        # of a ShardedControlPlane own disjoint id ranges; 0 unsharded)
        self._dev_base = dev_base
        self.devices = [
            DeviceState(dev_base + i,
                        mem_cls(config.capacity_bytes,
                                config.h2d_bw,
                                config.mem_policy, **mem_kw),
                        ConcurrencyController(max_d=config.d,
                                              dynamic=config.dynamic_d),
                        slot=i)
            for i in range(config.n_devices)]
        # cold-start data plane (repro.datapath): one contended link +
        # staging pool per device, wired into the memory manager's
        # upload/evict paths. "scalar" leaves every seed code path
        # untouched (uploader stays None -> point-estimate etas).
        self.datapath_mode = getattr(config, "datapath", "scalar")
        self._pipeline = self.datapath_mode == "pipeline"
        self._prefetch_on = False
        self._prefetch_depth = getattr(config, "prefetch_depth", 4)
        # data plane v2: peer-to-peer fabric + chunked layer streaming
        # (both off by default — p2p_bw=0 / chunk_bytes=None keep the
        # PR-6 host-only plane bit-identical)
        self.fabric = None
        self._p2p_bw = float(getattr(config, "p2p_bw", 0.0) or 0.0)
        self.chunk_bytes = getattr(config, "chunk_bytes", None)
        if self._pipeline:
            if layer != "indexed":
                raise ValueError(
                    "datapath='pipeline' requires device_layer='indexed'"
                    ": the reference manager has no datapath hooks")
            from repro_torch.datapath.device import DeviceDataPath
            self._prefetch_on = bool(getattr(config, "prefetch", False))
            staging = getattr(config, "staging_bytes", 64 * (1 << 30))
            if self._p2p_bw > 0.0 and config.n_devices > 1:
                from repro_torch.datapath.fabric import Fabric
                self.fabric = Fabric(self._p2p_bw)
            for dev in self.devices:
                dp = DeviceDataPath(dev.dev_id, config.h2d_bw, staging,
                                    dev.mem, fabric=self.fabric)
                dev.datapath = dp
                dev.mem.uploader = self._make_uploader(dp)
                # keep-alive-only baseline: no activation-time uploads,
                # every transfer starts at dispatch on the critical path
                dev.mem.anticipatory_upload = self._prefetch_on
                dev.mem.evict_listeners.append(dp.on_region_evicted)
                if self.fabric is not None:
                    # migrations source through the normal residency
                    # surface: when a source region leaves this HBM,
                    # every migration reading it falls back to host
                    dev.mem.evict_listeners.append(
                        self._peer_evict_listener(dev.dev_id))
        T = getattr(policy, "T", 0.0)
        lean = getattr(config, "metrics", "full") == "lean"
        self.fairness = FairnessTracker(window=config.fairness_window, T=T,
                                        D=config.d * config.n_devices,
                                        record_service=not lean)
        # utilization: full sample trace for figures, or just the running
        # time-integral when config.metrics == "lean" (constant memory on
        # million-event runs)
        self.util_samples: List = []
        self.util_integral = 0.0
        self._last_util: tuple = (0.0, 0.0)           # (t, util) [per_event]
        self._last_t = 0.0                            # [transition]
        self._last_u = 0.0
        self._record_util = getattr(config, "metrics", "full") != "lean"
        self._backlogged: set = set()                 # fns with queued/in-flight work
        # queued (not yet dispatched) invocations, maintained O(1) —
        # the shard router's backlog signal (total_pending is O(F))
        self.pending_count = 0
        self._sticky_dev: Dict[str, int] = {}         # fn -> device *slot*
        self._containers: Dict[int, object] = {}
        # optional per-stage wall-time breakdown of the dispatch pipeline
        # (benchmarks/scale.py --stages); off the hot path unless enabled
        self._profile = getattr(config, "profile_stages", False)
        self.stage_ns: Dict[str, int] = {
            "choose": 0, "place": 0, "admit": 0, "pool": 0, "mem": 0}

        # transition-driven vs per-event control-plane bookkeeping (see
        # ServerConfig.sampling). ``sample`` is bound per instance so the
        # executors' per-event call costs no mode branch.
        self.sampling = getattr(config, "sampling", "transition")
        if self.sampling not in ("transition", "per_event"):
            raise ValueError(f"unknown sampling mode {self.sampling!r}")
        self._emit_all = self.sampling == "per_event"
        # cached subscriber-list references (never rebound by EventBus;
        # append-only) — the emit sites below skip event-record
        # construction entirely while these are empty
        self._dispatch_subs = self.bus._dispatch
        self._complete_subs = self.bus._complete
        self._state_subs = self.bus._state_change
        self._dynamic_d = getattr(config, "dynamic_d", False)
        self._n_dev = len(self.devices)
        self._agg_util = 0.0      # cached mean utilization over devices
        self._agg_dirty = True    # some device's demands changed
        self._dp_synced = False   # policy.device_parallelism seeded yet?
        # per-device cached min(1, demand) as plain floats: refreshed at
        # the dispatch/completion that changed the device, summed (in
        # device order, bit-identical to the reference's scan) at the
        # next sample instead of 2 method calls per device per event
        self._dev_util = [0.0] * self._n_dev
        if self.sampling == "per_event":
            self.sample = self._sample_per_event
            self._pick = self._pick_device_scan
            # restore the pre-guard deferred-transition scan too, so the
            # reference mode reproduces the full pre-PR per-event cost
            policy.defer_guard = False
        else:
            self.sample = self._sample_transition
            self._pick = self.pick_device
        if self._profile:
            # bind the profiled body once instead of branching per call
            self.dispatch_once = self._dispatch_once_profiled

        # queue-state -> memory hooks (MQFQ family); baselines prefetch at
        # arrival and mark evictable at completion-of-last (paper applies
        # its memory optimizations to every compared policy).
        if policy.anticipatory:
            policy.state_listeners.append(self._on_state_change)

        # -- fault plane (repro.faults, ISSUE 9) ---------------------------
        # One injector per server; shards of a sharded plane receive the
        # shared instance via ``injector=``. With faults=None every hook
        # below is behind an ``is not None`` check and no float path
        # changes — the fault-free plane stays bit-identical.
        plan = getattr(config, "faults", None)
        if injector is None and plan is not None:
            from repro_torch.faults import FaultInjector
            injector = FaultInjector(plan)
        self.injector = injector
        self._injector = injector
        self._recovery = bool(getattr(config, "recovery", True))
        self._retry_max = int(getattr(config, "retry_max", 3))
        self._retry_backoff = float(getattr(config, "retry_backoff_s", 0.05))
        self._retry_deadline = float(
            getattr(config, "retry_deadline_s", 120.0))
        self.quarantine_s = float(getattr(config, "quarantine_s", 2.0))
        self._shed_threshold = getattr(config, "shed_threshold_s", None)
        # in-flight Invocation objects, kept only under faults: a device
        # failure must find the records to kill/requeue (the executors
        # hold them in heap payloads / worker frames, not by device)
        self._inflight_inv: Dict[int, Invocation] = {}
        self._degraded = False           # shed-mode hysteresis latch
        self._shed_checked = -1.0        # last predictor refresh time
        self._pred_delay = 0.0
        if injector is not None and self._recovery:
            # fault-aware placement: skip quarantined devices, and keep
            # the memory hooks off dead devices. Bound as overrides so
            # the fault-free bodies above stay byte-identical.
            if self.sampling != "transition":
                raise ValueError("faults= requires sampling='transition'")
            self._pick = self._pick_device_healthy
            self._fn_device = self._fn_device_healthy
        # transfer-aware placement (data plane v2): bid every free-token
        # device by its predicted weights-ready time. Bound last — it
        # subsumes the fault-aware pick (failed devices never bid).
        if getattr(config, "placement", "sticky") == "time-to-resident":
            self._pick = self._pick_device_ttr

    # -- queue-state hooks -----------------------------------------------------
    def _on_state_change(self, q, old, new, now) -> None:
        spec = self.fns[q.fn_id]
        dev = self._fn_device(q.fn_id)
        if new is QueueState.ACTIVE:
            dev.mem.on_queue_active(q.fn_id, spec.mem_bytes, now)
        else:
            dev.mem.on_queue_idle(q.fn_id, now)
            if self._pipeline and new is QueueState.INACTIVE:
                # the anticipation was wrong: abort the flow's in-flight
                # background prefetch and release its region (demand
                # transfers / dispatched regions refuse the cancel)
                if dev.datapath.cancel(q.fn_id, now):
                    dev.mem.drop_region(q.fn_id)
        if self._state_subs or self._emit_all:
            self.bus.emit_state_change(
                StateChangeEvent(q.fn_id, old, new, now))

    def _fn_device(self, fn_id: str) -> DeviceState:
        return self.devices[self._sticky_dev.get(fn_id, 0)]

    def _fn_device_healthy(self, fn_id: str) -> DeviceState:
        """Fault-aware override of ``_fn_device`` (bound in __init__):
        never route memory hooks at a quarantined device."""
        dev = self.devices[self._sticky_dev.get(fn_id, 0)]
        if not dev.failed:
            return dev
        for d in self.devices:
            if not d.failed:
                return d
        return dev                       # whole fleet down: degenerate

    # -- pipeline: arrival -----------------------------------------------------
    def on_arrival(self, inv: Invocation, now: float) -> None:
        inj = self._injector
        if inj is not None:
            inj.arrivals += 1
            if self._shed_threshold is not None and self._recovery \
                    and self._maybe_shed(inv, now):
                return
        self.policy.on_arrival(inv, now)
        self.pending_count += 1
        self._backlogged.add(inv.fn_id)
        if not self.policy.anticipatory:
            dev = self._fn_device(inv.fn_id)
            dev.mem.on_queue_active(inv.fn_id,
                                    self.fns[inv.fn_id].mem_bytes, now)

    # -- pipeline: device placement --------------------------------------------
    def pick_device(self, fn_id: str) -> Optional[DeviceState]:
        """Sticky late binding: prefer the device where the function is
        resident (avoids cross-device cold starts, paper §5 multi-GPU),
        else the least-loaded device with a free token.

        Single pass, no intermediate lists: the first free device with
        the function resident wins (device order — the reference's
        ``resident[0]``); otherwise the lowest-load free device,
        first-wins on ties (the reference's stable ``min``)."""
        best: Optional[DeviceState] = None
        best_load = 0
        for d in self.devices:
            t = d.tokens
            if t.outstanding >= t.current_d:
                continue
            if d.mem.is_resident(fn_id, 1e18):
                return d
            load = len(d.running)
            if best is None or load < best_load:
                best, best_load = d, load
        return best

    def _pick_device_scan(self, fn_id: str) -> Optional[DeviceState]:
        """Pre-PR body (``sampling="per_event"`` reference): materializes
        the free/resident lists per dispatch."""
        free = [d for d in self.devices
                if d.tokens.outstanding < d.tokens.current_d]
        if not free:
            return None
        resident = [d for d in free if d.mem.is_resident(fn_id, 1e18)]
        if resident:
            return resident[0]
        return min(free, key=lambda d: len(d.running))

    def _pick_device_healthy(self, fn_id: str) -> Optional[DeviceState]:
        """Fault-aware override of ``pick_device`` (bound in __init__
        when a fault plan is active under recovery): identical placement,
        but quarantined devices are invisible."""
        best: Optional[DeviceState] = None
        best_load = 0
        for d in self.devices:
            if d.failed:
                continue
            t = d.tokens
            if t.outstanding >= t.current_d:
                continue
            if d.mem.is_resident(fn_id, 1e18):
                return d
            load = len(d.running)
            if best is None or load < best_load:
                best, best_load = d, load
        return best

    def _pick_device_ttr(self, fn_id: str) -> Optional[DeviceState]:
        """Time-to-resident placement (``placement="time-to-resident"``,
        pipeline only): bid every healthy free-token device by when this
        function's weights could be usable there —

            resident            -> 0
            upload in flight    -> its planned eta
            absent              -> min(best peer migration estimate,
                                       host link estimate)

        with the peer estimate (queue + bytes)/p2p_bw over resident
        non-failed sources and the host estimate (demand backlog +
        bytes)/h2d_bw from the staged link model. Least-load breaks
        ties (first device wins, matching the sticky pick's stable
        min), so a near-idle device mid-transfer stops beating a peer
        that can serve from HBM."""
        spec = self.fns[fn_id]
        nbytes = spec.mem_bytes
        fabric = self.fabric
        p2p = self._p2p_bw
        best: Optional[DeviceState] = None
        best_key = None
        for d in self.devices:
            if d.failed:
                continue
            t = d.tokens
            if t.outstanding >= t.current_d:
                continue
            dp = d.datapath
            now = dp.now
            ready = d.mem.time_to_resident(fn_id, now)
            if ready is None:
                # absent (or paused with no planned eta): estimate the
                # cheapest way to get the bytes there
                link = dp.link
                ready = (link.backlog_bytes() + nbytes) / link.bw
                if fabric is not None:
                    for s in self.devices:
                        if s is d or s.failed:
                            continue
                        if s.mem.is_resident(fn_id, now):
                            est = (fabric.backlog_bytes(s.dev_id, d.dev_id)
                                   + nbytes) / p2p
                            if est < ready:
                                ready = est
            key = (ready, len(d.running))
            if best is None or key < best_key:
                best, best_key = d, key
        return best

    # -- pipeline: dispatch -----------------------------------------------------
    def drain(self, now: float, budget: Optional[int] = None,
              realize: Optional[Callable[[DispatchDecision], None]] = None
              ) -> List[DispatchDecision]:
        """Batched dispatch (paper §5): run Algorithm 1 DISPATCH until no
        queue is eligible, no D token is free, or memory admission
        refuses — one pass over all freed tokens / newly-eligible queues
        instead of one control-plane call per token.

        ``realize`` is invoked on each decision before the next choose(),
        so executor-side effects (modeled demands, submitted work) are
        visible to subsequent decisions exactly as under the seed's
        per-call loop. ``budget`` caps the number of dispatches (None =
        drain fully)."""
        out: List[DispatchDecision] = []
        while budget is None or len(out) < budget:
            d = self.dispatch_once(now)
            if d is None:
                break
            out.append(d)
            if realize is not None:
                realize(d)
        return out

    def try_dispatch(self, now: float) -> Optional[DispatchDecision]:
        """Single-step shim over ``drain`` (API compatibility). Returns
        None when nothing is eligible (no candidate queue, no D token, or
        memory admission refused)."""
        out = self.drain(now, budget=1)
        return out[0] if out else None

    def dispatch_once(self, now: float) -> Optional[DispatchDecision]:
        """One pass of Algorithm 1 DISPATCH. Public so the sim executor's
        hot loop can drive the pipeline directly without ``drain``'s
        per-event list/callback scaffolding. With ``profile_stages`` the
        instance attribute is rebound to ``_dispatch_once_profiled`` in
        ``__init__`` — no per-call branch either way."""
        q = self.policy.choose(now)
        if q is None:
            return None
        fn_id = q.fn_id
        spec = self.fns[fn_id]
        dev = self._pick(fn_id)
        if dev is None:
            return None  # no D token anywhere (Alg. 1 line 12-13)
        if not dev.mem.admit(fn_id, spec.mem_bytes, dev.running_bytes, now):
            return None  # memory admission control (§4.4)
        inv = q.pop()
        self.pending_count -= 1
        self.policy.on_dispatch(q, inv, now)
        dev.tokens.acquire()
        self._sticky_dev[fn_id] = dev.slot

        resident = dev.mem.is_resident(fn_id, now)
        container, start_type = self.pool.acquire(fn_id, now, resident)
        self._containers[inv.inv_id] = container
        ready, mem_mult = dev.mem.acquire(fn_id, spec.mem_bytes, now)

        inv.dispatch_time = now
        inv.start_type = start_type
        inv.device_id = dev.dev_id
        dev.note_dispatch(inv.inv_id, fn_id, spec)
        self._agg_dirty = True
        self._dev_util[dev.slot] = dev.utilization()
        if self._injector is not None:
            self._inflight_inv[inv.inv_id] = inv
        decision = DispatchDecision(inv, dev, spec, start_type, ready,
                                    mem_mult)
        if self._dispatch_subs or self._emit_all:
            self.bus.emit_dispatch(
                DispatchEvent(inv, fn_id, dev.dev_id, start_type, now))
        return decision

    def _dispatch_once_profiled(self, now: float
                                ) -> Optional[DispatchDecision]:
        """dispatch_once with per-stage timing (kept as a separate body
        so the unprofiled hot path pays nothing)."""
        ns = self.stage_ns
        t = time.perf_counter_ns()
        q = self.policy.choose(now)
        ns["choose"] += time.perf_counter_ns() - t
        if q is None:
            return None
        fn_id = q.fn_id
        spec = self.fns[fn_id]
        t = time.perf_counter_ns()
        dev = self._pick(fn_id)
        ns["place"] += time.perf_counter_ns() - t
        if dev is None:
            return None
        t = time.perf_counter_ns()
        ok = dev.mem.admit(fn_id, spec.mem_bytes, dev.running_bytes, now)
        ns["admit"] += time.perf_counter_ns() - t
        if not ok:
            return None
        inv = q.pop()
        self.pending_count -= 1
        self.policy.on_dispatch(q, inv, now)
        dev.tokens.acquire()
        self._sticky_dev[fn_id] = dev.slot

        resident = dev.mem.is_resident(fn_id, now)
        t = time.perf_counter_ns()
        container, start_type = self.pool.acquire(fn_id, now, resident)
        ns["pool"] += time.perf_counter_ns() - t
        self._containers[inv.inv_id] = container
        t = time.perf_counter_ns()
        ready, mem_mult = dev.mem.acquire(fn_id, spec.mem_bytes, now)
        ns["mem"] += time.perf_counter_ns() - t

        inv.dispatch_time = now
        inv.start_type = start_type
        inv.device_id = dev.dev_id
        dev.note_dispatch(inv.inv_id, fn_id, spec)
        self._agg_dirty = True
        self._dev_util[dev.slot] = dev.utilization()
        if self._injector is not None:
            self._inflight_inv[inv.inv_id] = inv
        decision = DispatchDecision(inv, dev, spec, start_type, ready,
                                    mem_mult)
        if self._dispatch_subs or self._emit_all:
            self.bus.emit_dispatch(
                DispatchEvent(inv, fn_id, dev.dev_id, start_type, now))
        return decision

    # -- pipeline: completion ----------------------------------------------------
    def on_complete(self, inv: Invocation, now: float) -> None:
        fn_id = inv.fn_id
        policy = self.policy
        dev = self.devices[inv.device_id - self._dev_base]
        dev.note_complete(inv.inv_id, fn_id, self.fns[fn_id])
        self._agg_dirty = True
        self._dev_util[dev.slot] = dev.utilization()
        dev.tokens.release()
        container = self._containers.pop(inv.inv_id)
        self.pool.release(container, now)
        q = policy.get_queue(fn_id)
        policy.on_complete(q, inv, now)
        # FairnessTracker.add_service inlined (weight == 1.0 on this
        # path, and x / 1.0 == x bitwise): one frame per completion
        f = self.fairness
        f._service[fn_id] += inv.service_time
        f._tau[fn_id] = q.tau
        if not q.backlogged:
            self._backlogged.discard(fn_id)
            self.fairness.on_backlog_change(fn_id, False)
            if not policy.anticipatory:
                dev.mem.on_queue_idle(fn_id, now)
        inj = self._injector
        if inj is not None:
            self._inflight_inv.pop(inv.inv_id, None)
            if inv.failed:
                inj.completed_failed += 1
            else:
                inj.completed_ok += 1
        if self._complete_subs or self._emit_all:
            self.bus.emit_complete(
                CompleteEvent(inv, fn_id, inv.device_id, now))

    # -- fault recovery (repro.faults, ISSUE 9) -----------------------------------
    # The executor owns fault *timing* (sim: fault events; wallclock:
    # watchdog thread + wrapper endpoint); the control plane owns the
    # *accounting*: a failed attempt must leave every ledger — VT,
    # fairness service, D tokens, warm pool, memory, device demand — as
    # if the dispatch had been charged exactly once per completing
    # attempt. ``on_attempt_failed`` reverts one attempt; ``requeue``
    # re-inserts the invocation at the front of its flow queue.

    def device_state(self, dev_id: int) -> DeviceState:
        return self.devices[dev_id - self._dev_base]

    def inflight_on(self, dev_id: int) -> List[Invocation]:
        """In-flight invocation records on a device (faults only — the
        tracking dict is populated only when an injector is active)."""
        dev = self.devices[dev_id - self._dev_base]
        inflight = self._inflight_inv
        return [inflight[i] for i in dev.running if i in inflight]

    def fail_device(self, dev_id: int, now: float) -> List[Invocation]:
        """Take a device out of rotation: quarantine it, purge sticky
        placements, drop its in-flight transfers and invalidate every
        resident region (weights on a dead device are gone; the warm
        containers are host-side processes and survive). Returns the
        doomed in-flight invocations — the *executor* fails each one
        (sim: immediately, cancelling their completion events; wallclock:
        lazily when the worker thread returns)."""
        dev = self.devices[dev_id - self._dev_base]
        inj = self._injector
        inj.device_faults += 1
        if dev.failed:
            return []
        doomed = self.inflight_on(dev_id)
        if not self._recovery:
            return doomed        # naive platform: no reaction at all
        dev.failed = True
        dev.quarantined_until = now + self.quarantine_s
        inj.quarantined += 1
        slot = dev.slot
        stale = [fn for fn, s in self._sticky_dev.items() if s == slot]
        for fn in stale:
            del self._sticky_dev[fn]
        if dev.datapath is not None:
            dev.datapath.abort_all(now)
        dev.mem.invalidate_device()
        return doomed

    def readmit_device(self, dev_id: int, now: float) -> Optional[float]:
        """Health check: re-admit a quarantined device once its fault
        window cleared AND ``quarantine_s`` has passed since failure.
        Returns the next re-check time when the device is still down
        (None when re-admitted, or down permanently)."""
        dev = self.devices[dev_id - self._dev_base]
        if not dev.failed:
            return None
        inj = self._injector
        end = inj.device_fault_end(dev.dev_id, now)
        if end == float("inf"):
            return None                       # permanent: never re-admit
        due = max(end, dev.quarantined_until)
        if due > now:
            return due
        dev.failed = False
        inj.readmitted += 1
        return None

    def on_attempt_failed(self, inv: Invocation, now: float,
                          reason: str) -> Optional[float]:
        """Undo one failed attempt's dispatch accounting and decide its
        fate: returns the retry time (schedule a ``requeue`` then), or
        None — the invocation is dropped (budget/deadline exhausted) and
        ``inv.failed`` is set.

        ``reason``: "error" (endpoint raised — container process is
        fine, released back to the pool), "hang" (watchdog killed the
        container — destroyed), "device" (device died — the host-side
        container survives, but its device state is gone)."""
        inj = self._injector
        inj.attempts_failed += 1
        fn_id = inv.fn_id
        dev = self.devices[inv.device_id - self._dev_base]
        dev.note_complete(inv.inv_id, fn_id, self.fns[fn_id])
        self._agg_dirty = True
        self._dev_util[dev.slot] = dev.utilization()
        dev.tokens.release()
        self._inflight_inv.pop(inv.inv_id, None)
        container = self._containers.pop(inv.inv_id, None)
        if container is not None:
            if reason == "hang":
                self.pool.destroy(container)
            else:
                self.pool.release(container, now)
        policy = self.policy
        q = policy.get_queue(fn_id)
        policy.on_failure(q, inv, now)
        if not q.backlogged:
            self._backlogged.discard(fn_id)
            self.fairness.on_backlog_change(fn_id, False)
            if not policy.anticipatory:
                dev.mem.on_queue_idle(fn_id, now)
        if inv.retries < self._retry_max:
            backoff = self._retry_backoff * (2.0 ** inv.retries)
            retry_at = now + backoff
            if retry_at - inv.arrival <= self._retry_deadline:
                inv.retries += 1
                inj.retries += 1
                return retry_at
        inv.failed = True
        inv.completion = now        # terminal: dropped, not stranded
        inj.dropped += 1
        return None

    def requeue(self, inv: Invocation, now: float) -> None:
        """Re-insert a retried invocation at the FRONT of its flow queue
        (seniority preserved — its VT charge was reverted, so the flow
        is not double-charged when the retry dispatches)."""
        fn_id = inv.fn_id
        q = self.policy.get_queue(fn_id)
        q.pending.appendleft(inv)
        self.pending_count += 1
        self._backlogged.add(fn_id)
        self._injector.requeued += 1
        self.policy.on_requeue(q, now)
        if not self.policy.anticipatory:
            dev = self._fn_device(fn_id)
            dev.mem.on_queue_active(fn_id, self.fns[fn_id].mem_bytes, now)

    def abort_transfers(self, dev_id: int, fn_id: Optional[str],
                        now: float) -> int:
        """Injected transfer fault: abort the in-flight H2D transfer(s).
        Under recovery the transfer restarts from zero progress (its
        dispatch waiters stay attached and simply see a later
        completion); without recovery the bytes are lost — waiters are
        failed (``t_done=None``) and the region is dropped."""
        dev = self.devices[dev_id - self._dev_base]
        dp = dev.datapath
        if dp is None:
            return 0
        targets = [fn_id] if fn_id is not None else list(dp.transfers)
        n = 0
        for fn in targets:
            if dp.abort(fn, now, retry=self._recovery):
                n += 1
        self._injector.transfer_aborts += n
        return n

    # -- SLO-aware degraded mode --------------------------------------------------
    def _predict_delay(self, now: float) -> float:
        """Predicted queueing delay: total expected queued work over the
        healthy fleet's parallel capacity. O(F), refreshed at most every
        50 ms of driver time."""
        if now - self._shed_checked < 0.05:
            return self._pred_delay
        self._shed_checked = now
        work = 0.0
        for q in self.policy.queues.values():
            if q.pending:
                work += len(q.pending) * q.tau
        cap = 0
        for d in self.devices:
            if not d.failed:
                cap += d.tokens.current_d
        self._pred_delay = work / cap if cap else float("inf")
        return self._pred_delay

    def _maybe_shed(self, inv: Invocation, now: float) -> bool:
        """Degraded-mode load shedding, per-tenant-fair: once predicted
        delay crosses the threshold (hysteresis: exits at half of it),
        reject newest arrivals of flows already at-or-over their fair
        share of the backlog; flows under their share keep getting in.
        Retries never pass through here — only fresh arrivals shed."""
        delay = self._predict_delay(now)
        thr = self._shed_threshold
        if self._degraded:
            if delay < 0.5 * thr:
                self._degraded = False
        elif delay >= thr:
            self._degraded = True
        if not self._degraded:
            return False
        q = self.policy.queues.get(inv.fn_id)
        qlen = len(q.pending) if q is not None else 0
        n_backlogged = len(self._backlogged)
        fair = max(1, -(-self.pending_count // max(n_backlogged, 1)))
        if qlen < fair:
            return False
        inv.shed = True
        self._injector.shed += 1
        return True

    # -- cold-start data plane (datapath="pipeline") ------------------------------
    def datapath_tick(self, now: float) -> None:
        """Refresh every device link's clock at the top of an event, so
        mid-event mutations without a timestamp (evict-listener
        cancellations) integrate link progress at the right instant."""
        for dev in self.devices:
            dev.datapath.now = now

    def _make_uploader(self, dp):
        """Memory-manager upload hook bound to one device's data path,
        tagging each transfer with the flow's dispatch priority. The
        link serves background prefetches one at a time in this order,
        so uploads complete in the order the policy will drain the
        flows; queue creation order (``q.ins``) is the policy's stable
        candidate tie-break and survives across Inactive/Active cycles.

        With a fabric wired, the hook routes through ``_peer_source``
        first: weights already resident in a peer's HBM stream over the
        interconnect instead of host DRAM — for demand uploads *and*
        anticipatory prefetches alike (anticipatory migration)."""
        queues = self.policy.queues
        if self.fabric is None:
            def upload(fn_id, nbytes, now, kind):
                q = queues.get(fn_id)
                return dp.request(fn_id, nbytes, now, kind,
                                  prio=q.ins if q is not None else 0)
            return upload

        def upload(fn_id, nbytes, now, kind):
            q = queues.get(fn_id)
            return dp.request(fn_id, nbytes, now, kind,
                              prio=q.ins if q is not None else 0,
                              src=self._peer_source(dp, fn_id, now))
        return upload

    def _peer_source(self, dp, fn_id: str, now: float) -> Optional[int]:
        """Pick a migration source for fn's weights: a healthy peer
        device with the region resident *and usable* (a mid-upload copy
        cannot be read), least outstanding bytes on the directed
        src->dst link breaking ties in device order. None -> host."""
        fabric = self.fabric
        dst = dp.dev_id
        best = None
        best_backlog = 0.0
        for s in self.devices:
            if s.dev_id == dst or s.failed:
                continue
            if not s.mem.is_resident(fn_id, now):
                continue
            backlog = fabric.backlog_bytes(s.dev_id, dst)
            if best is None or backlog < best_backlog:
                best, best_backlog = s.dev_id, backlog
        return best

    def _peer_evict_listener(self, src: int):
        """Evict listener bound to one device's memory manager: when a
        region leaves that HBM, every migration streaming *from* it
        falls back to the destination's host link (restart from byte
        zero, waiters preserved). Uses the destination datapath's
        event-refreshed clock — evictions arrive without a timestamp."""
        fabric = self.fabric

        def on_evict(fn_id):
            for dst_dp in fabric.on_source_evicted(src, fn_id):
                dst_dp.peer_source_lost(fn_id, dst_dp.now)
        return on_evict

    def prefetch_pass(self, now: float) -> None:
        """Anticipatory weight prefetch (the drain-side trigger): for
        every flow with queued work that did not dispatch this pass —
        throttled, out of D tokens, or blocked on admission — start
        uploading its weights in the background, overlapping the
        transfer with the running invocations. Prefetch goes through
        ``begin_prefetch`` (normal admit/charge accounting, region stays
        evictable), targets only the flow's sticky device (no placement
        guessing), and is bounded per device by ``prefetch_depth``."""
        if not self._prefetch_on:
            return
        fns = self.fns
        queues = self.policy.queues
        sticky = self._sticky_dev
        devices = self.devices
        depth = self._prefetch_depth
        inactive = QueueState.INACTIVE
        for fn_id in self._backlogged:
            slot = sticky.get(fn_id)
            if slot is None:
                continue        # no placement history yet
            q = queues.get(fn_id)
            if q is None or not q.pending or q.state is inactive:
                continue
            dev = devices[slot]
            dp = dev.datapath
            if dp.n_prefetch >= depth or fn_id in dp.transfers:
                continue
            mem = dev.mem
            r = mem.regions.get(fn_id)
            if r is not None and r.resident:
                continue        # resident, or an upload already in flight
            spec = fns[fn_id]
            if not mem.admit(fn_id, spec.mem_bytes, dev.running_bytes, now):
                continue        # never violate admission for a prefetch
            mem.begin_prefetch(fn_id, spec.mem_bytes, now)

    def next_transfer_eta(self) -> Optional[float]:
        """Earliest planned transfer completion across devices (the sim
        executor's TRANSFER-event arming signal)."""
        best: Optional[float] = None
        for dev in self.devices:
            e = dev.datapath.next_eta()
            if e is not None and (best is None or e < best):
                best = e
        return best

    def advance_transfers(self, now: float) -> None:
        """A TRANSFER event fired: realize completed transfers (staging
        release, region finalization, dispatch-waiter callbacks)."""
        for dev in self.devices:
            dev.datapath.advance(now)

    # -- per-event sampling -------------------------------------------------------
    # Executors call ``sample`` (bound in __init__ to one of the two
    # bodies below) after every event (arrival/dispatch/complete/timer).

    def _sample_transition(self, now: float) -> None:
        """Transition-driven bookkeeping: everything the per-event
        reference recomputed from scratch is either cached behind a dirty
        flag (mean utilization — invalidated by dispatch/complete, the
        only demand mutations) or gated on an actual transition (the
        ``device_parallelism`` min-sync fires only when some device's
        ``current_d`` moved; the fairness window rolls behind its
        deadline). The float arithmetic on every path is identical to the
        reference's, so RunResults stay bit-identical — proven across the
        policy × dynamic-D × memory-pressure matrix by
        tests/test_event_loop_equivalence.py.

        Under dynamic D the per-device EMA *is* the control signal and
        depends on sample count, so it still steps every event (but
        allocation-free, over cached demand sums). With static D the EMA
        is telemetry with no reader and is skipped entirely."""
        if self._dynamic_d:
            util = 0.0
            mn = None
            vals = self._dev_util
            for i, d in enumerate(self.devices):
                u = vals[i]     # cached min(1, demand), fresh by note_*
                util += u
                t = d.tokens
                t.report_utilization(u)
                cd = t.current_d
                if mn is None or cd < mn:
                    mn = cd
            util /= self._n_dev
            pol = self.policy
            if pol.device_parallelism != mn:
                pol.device_parallelism = mn
        else:
            if not self._dp_synced:
                self.policy.device_parallelism = min(
                    d.tokens.current_d for d in self.devices)
                self._dp_synced = True
            if self._agg_dirty:
                # sum(list) accumulates in device order — the identical
                # float arithmetic to the reference's per-event scan
                util = sum(self._dev_util) / self._n_dev
                self._agg_util = util
                self._agg_dirty = False
            else:
                util = self._agg_util
        self.util_integral += self._last_u * (now - self._last_t)
        self._last_t = now
        self._last_u = util
        if self._record_util:
            self.util_samples.append((now, util))
        f = self.fairness
        # the due-check must be the exact expression maybe_roll guards
        # with (``now - _t0 >= window``), not ``now >= f.next_roll``:
        # float(t0 + w) can round one ulp away from the subtraction form
        if now - f._t0 >= f.window:
            f.maybe_roll(now, self._backlogged, self.policy.queues.keys())

    def _sample_per_event(self, now: float) -> None:
        """Pre-PR reference (``sampling="per_event"``): per-event device
        scans with fresh list/dict traffic, unconditional dynamic-D
        feedback + min-sync, and an unconditional ``maybe_roll`` call.
        Kept verbatim as the differential-testing and perf baseline."""
        utils = [d.utilization_scan() for d in self.devices]
        util = sum(utils) / len(utils)
        last_t, last_u = self._last_util
        self.util_integral += last_u * (now - last_t)
        self._last_util = (now, util)
        if self._record_util:
            self.util_samples.append((now, util))
        for d, u in zip(self.devices, utils):
            d.tokens.report_utilization(u)
        # the policy's D-dependent tie-breaks must see the tightest
        # per-device budget: under dynamic D the devices drift apart, and
        # syncing from devices[0] alone fed the policy a stale/wrong D
        self.policy.device_parallelism = min(
            d.tokens.current_d for d in self.devices)
        self.fairness.maybe_roll(now, self._backlogged,
                                 self.policy.queues.keys())

    # -- introspection ------------------------------------------------------------
    @property
    def total_pending(self) -> int:
        return self.policy.total_pending

    @property
    def total_inflight(self) -> int:
        return sum(d.tokens.outstanding for d in self.devices)

"""Sharded control plane: per-device-group shards + cross-shard fairness.

The paper's §5 dispatcher is a single thread, and one monolithic
``ControlPlane`` serializes every decision behind one lock in real
serving. MQFQ's own lineage (multi-queue fair queueing for multicore
I/O) scales by giving each CPU its own dispatch queue under a
loosely-synchronized global clock — this module does the same for
device groups:

    router (hash | sticky) ── fn_id ──► shard k
        shard k = ControlPlane over devices [k*G, (k+1)*G)
                  (own policy + scheduler index + memory managers +
                   warm pool + D-tokens + fairness tracker)

    cross-shard fairness: every ``vt_epoch`` each shard publishes its
    min pending VT into a slot of a VT bus; the max of the published
    minima is re-injected into every shard as a Global_VT floor
    (``Policy.raise_vt_floor``). Writes and reads are plain float
    slot assignments — a lock-free snapshot; a shard's local VT can lag
    the cross-shard floor by at most one epoch's advance, mirroring
    MQFQ's relaxed global virtual clock.

``ShardedControlPlane`` preserves the ``ControlPlane`` driver API
(``on_arrival`` / ``drain`` / ``dispatch_once`` / ``sample`` /
``on_complete``), so the unchanged ``SimExecutor`` drives sharded runs:
dispatch steps the shards round-robin from a rotating cursor
(deterministic, so sharded simulations are reproducible and
differentially testable), and with one shard the facade is bit-identical
to the monolithic plane (the VT sync is skipped — with a single local
shard and no external bus it is exactly the shard's own
``_refresh_global_vt``). ``sharding="none"`` never constructs this class
at all: the monolithic path stays verbatim as the differential
reference.

For wall-clock serving, ``ShardedWallClockExecutor`` (executors.py)
runs one dispatcher thread + lock per shard over these planes. For
process-per-shard deployments (the pure-Python control plane is
GIL-bound, so scale-out means processes), pass a ``vt_bus`` backed by
shared memory — ``benchmarks/scale.py --shard-compare`` does exactly
that with a ``multiprocessing`` double array.
"""
from __future__ import annotations

import zlib
from dataclasses import replace
from typing import Callable, Dict, List, Optional, Sequence, TYPE_CHECKING

from repro_torch.core.policy_base import Policy
from repro_torch.runtime.invocation import Invocation
from repro_torch.server.control import ControlPlane, DispatchDecision
from repro_torch.server.events import EventBus
from repro_torch.server.metrics import MergedFairness, MergedPools
from repro_torch.workloads.spec import FunctionSpec

if TYPE_CHECKING:
    from repro_torch.server.config import ServerConfig

_NEG_INF = float("-inf")


def hash_shard(fn_id: str, n_shards: int) -> int:
    """Deterministic, process-stable flow->shard map (crc32, not the
    salted builtin ``hash``)."""
    return zlib.crc32(fn_id.encode()) % n_shards


class ShardRouter:
    """Flow -> shard assignment.

    ``hash``    — stateless crc32 partition (stable across runs and
                  processes; what the fan-out benchmark uses to split a
                  scenario among shard processes).
    ``sticky``  — locality-aware: a flow is pinned to the least-backlogged
                  shard at first arrival (warm pool + residency build up
                  there; backlog ties break on fewest assigned flows, so
                  a quiet system still spreads placement) and only moves
                  when its shard's backlog exceeds ``imbalance``x the
                  lightest shard's *and* the flow has no queued or
                  in-flight work on its current shard (so a move never
                  strands state mid-flight — completions still route by
                  device id).
    """

    def __init__(self, mode: str, n_shards: int, imbalance: float = 2.0):
        if mode not in ("hash", "sticky"):
            raise ValueError(f"unknown sharding mode {mode!r}; "
                             f"expected 'hash' or 'sticky'")
        self.mode = mode
        self.n = n_shards
        self.imbalance = imbalance
        self.assign: Dict[str, int] = {}
        self.load = [0] * n_shards      # flows currently assigned
        self.rebalances = 0

    def _lightest(self, backlogs: Sequence[int]) -> int:
        load = self.load
        return min(range(self.n), key=lambda i: (backlogs[i], load[i], i))

    def route(self, fn_id: str,
              backlogs: Optional[Sequence[int]] = None,
              flow_idle: Optional[Callable[[str, int], bool]] = None
              ) -> int:
        cur = self.assign.get(fn_id)
        if self.mode == "hash":
            if cur is None:
                cur = self.assign[fn_id] = hash_shard(fn_id, self.n)
            return cur
        # sticky
        if backlogs is None:
            return cur if cur is not None else 0
        if cur is None:
            k = self._lightest(backlogs)
            self.assign[fn_id] = k
            self.load[k] += 1
            return k
        lightest = self._lightest(backlogs)
        if (lightest != cur
                and backlogs[cur] > self.imbalance * (backlogs[lightest] + 1)
                and (flow_idle is None or flow_idle(fn_id, cur))):
            self.assign[fn_id] = lightest
            self.load[cur] -= 1
            self.load[lightest] += 1
            self.rebalances += 1
            return lightest
        return cur


class LocalVTBus:
    """In-process VT snapshot: one float slot per shard. Slot writes and
    the max-read are plain list operations — atomic under the GIL, no
    lock, and the same ``publish`` / ``floor`` duck type as a
    shared-memory array bus for process-per-shard deployments."""

    def __init__(self, n_slots: int):
        self.slots = [_NEG_INF] * n_slots

    def publish(self, slot: int, vt: float) -> None:
        self.slots[slot] = vt

    def floor(self) -> float:
        return max(self.slots)


class ArrayVTBus:
    """VT bus over any shared indexable of doubles (e.g. a
    ``multiprocessing.Array('d', n, lock=False)``): each shard process
    owns one slot; ``floor`` is a lock-free snapshot max. Torn reads are
    impossible (aligned 8-byte stores) and staleness is bounded by one
    epoch — exactly the relaxed global clock the design wants.

    ``init=True`` resets every slot to the nothing-published sentinel —
    only the *owner* of the array should do that (attaching shard
    processes must not wipe slots their peers already published)."""

    def __init__(self, arr, init: bool = False):
        self.arr = arr
        if init:
            for i in range(len(arr)):
                arr[i] = _NEG_INF

    def publish(self, slot: int, vt: float) -> None:
        self.arr[slot] = vt

    def floor(self) -> float:
        return max(self.arr)


class _ShardedPolicyView:
    """Read-only facade the executors/benchmarks see as ``cp.policy``:
    aggregate counters plus the cross-shard timer min."""

    def __init__(self, shards: List[ControlPlane]):
        self._shards = shards
        self.name = shards[0].policy.name

    @property
    def decisions(self) -> int:
        return sum(s.policy.decisions for s in self._shards)

    @property
    def total_pending(self) -> int:
        return sum(s.policy.total_pending for s in self._shards)

    @property
    def queues(self) -> Dict:
        out: Dict = {}
        for s in self._shards:
            out.update(s.policy.queues)
        return out

    def next_expiry(self, now: float,
                    bound: Optional[float] = None) -> Optional[float]:
        """Earliest TTL lapse across shards. Each shard is bounded by
        the best already found (and the executor's armed timer), so the
        common nothing-due case stays O(1) per shard."""
        best: Optional[float] = None
        for s in self._shards:
            b = bound
            if best is not None and (b is None or best < b):
                b = best
            t = s.policy.next_expiry(now, b)
            if t is not None and (best is None or t < best):
                best = t
        return best


class ShardedControlPlane:
    """N ``ControlPlane`` shards behind the monolithic driver API.

    Requires ``sampling="transition"`` (the per_event mode exists as the
    pre-PR-4 differential reference; shards read the transition
    sampler's cached per-shard utilization) and ``n_devices`` divisible
    by ``n_shards``. The warm-pool budget is split evenly (remainder to
    the first shards).

    ``vt_slots`` maps local shards to slots of an external ``vt_bus``
    when this plane hosts a subset of a larger deployment (one process
    per shard); by default slot k is local shard k and the bus is
    in-process. VT sync runs when there is anything to synchronize with
    (more than one local shard, or an external bus).
    """

    def __init__(self, fns: Dict[str, FunctionSpec], config: "ServerConfig",
                 bus: Optional[EventBus] = None,
                 policy_factory: Optional[Callable[[], Policy]] = None,
                 vt_bus=None, vt_slots: Optional[Sequence[int]] = None):
        S = getattr(config, "n_shards", 1)
        if S < 1:
            raise ValueError(f"n_shards must be >= 1, got {S}")
        if config.n_devices % S:
            raise ValueError(
                f"n_devices ({config.n_devices}) must be divisible by "
                f"n_shards ({S}) — shards own whole device groups")
        if getattr(config, "sampling", "transition") != "transition":
            raise ValueError(
                "sharding requires sampling='transition' (per_event is "
                "the retained pre-sharding differential reference)")
        if policy_factory is None:
            from repro_torch.core.policies import make_policy
            policy_factory = lambda: make_policy(
                config.policy, **dict(config.policy_kwargs))
        if config.pool_size < S:
            raise ValueError(
                f"pool_size ({config.pool_size}) must be >= n_shards "
                f"({S}): every shard needs at least one warm-pool slot, "
                f"and silently inflating the budget would skew "
                f"sharded-vs-monolithic comparisons")
        self.config = config
        self.fns = fns
        self.bus = bus or EventBus()
        group = config.n_devices // S
        self._group = group
        # fault plane: ONE injector shared by every shard, so the
        # fault schedule and its counters are global (a per-shard
        # injector would replay the same endpoint faults S times)
        plan = getattr(config, "faults", None)
        injector = None
        if plan is not None:
            from repro_torch.faults import FaultInjector
            injector = FaultInjector(plan)
        self.injector = injector
        base_pool, extra = divmod(config.pool_size, S)
        self.shards: List[ControlPlane] = []
        for k in range(S):
            sub = replace(config, n_devices=group,
                          pool_size=base_pool + (1 if k < extra else 0))
            shard = ControlPlane(policy_factory(), fns, sub, self.bus,
                                 dev_base=k * group, injector=injector)
            # the merged plane records the utilization trace; the
            # per-shard lists would be dead weight nobody reads
            # (O(events) tuples per shard on full-metrics runs) —
            # util_integral, which the wall-clock merge does read, is
            # maintained regardless
            shard._record_util = False
            self.shards.append(shard)
        self._n = S
        self._n_dev = config.n_devices
        self._cursor = 0
        #: public shard count (``_n`` predates it; external consumers —
        #: the replay feeders, benchmarks — should read this, not the
        #: private field)
        self.n_shards = S
        self.router = ShardRouter(config.sharding, S,
                                  getattr(config, "shard_imbalance", 2.0))
        self._route_fast = (self._route_hash
                            if config.sharding == "hash"
                            else self._route_sticky)
        self.policy = _ShardedPolicyView(self.shards)

        # cross-shard VT sync (relaxed global clock)
        self.vt_epoch = getattr(config, "vt_epoch", 0.25)
        if vt_slots is not None:
            if vt_bus is None:
                raise ValueError(
                    "vt_slots without vt_bus: custom slot indices only "
                    "make sense against an external (shared) VT bus")
            vt_slots = list(vt_slots)
            if len(vt_slots) != S or len(set(vt_slots)) != S \
                    or any(s < 0 for s in vt_slots):
                raise ValueError(
                    f"vt_slots must be {S} distinct non-negative slot "
                    f"indices (one per local shard), got {vt_slots}")
        self.vt_slots = vt_slots if vt_slots is not None else \
            list(range(S))
        self.vt_bus = vt_bus if vt_bus is not None else LocalVTBus(S)
        if vt_bus is not None:
            # a too-small external bus would IndexError inside the sync
            # (killing the wallclock epoch thread silently): fail loud
            # at construction instead, for explicit and default slots
            arr = getattr(vt_bus, "arr", getattr(vt_bus, "slots", None))
            if arr is not None and max(self.vt_slots) >= len(arr):
                raise ValueError(
                    f"vt_slots {self.vt_slots} out of range for a "
                    f"{len(arr)}-slot VT bus")
        self._sync_enabled = vt_bus is not None or S > 1
        self._last_sync = 0.0
        self.vt_syncs = 0
        self.vt_sync_errors = 0           # epoch-thread failures survived
        self.vt_floor = _NEG_INF          # last injected floor
        self._prev_floor = _NEG_INF
        # max over syncs of (previous epoch's floor - a shard's pre-raise
        # GVT). <= 0 proves every floor *injection took effect* (a
        # broken/no-op raise_vt_floor reads positive here). It does NOT
        # prove the sync keeps running — the one-epoch drift bound is
        # (injection works) AND (syncs fire every epoch), so tests and
        # the benchmark gate pair this with a sync-cadence liveness
        # check on ``vt_syncs`` vs elapsed time / epoch.
        self.vt_max_lag = _NEG_INF

        # merged utilization trace (transition-sampler arithmetic)
        self.util_samples: List = []
        self.util_integral = 0.0
        self._last_t = 0.0
        self._last_u = 0.0
        self._record_util = getattr(config, "metrics", "full") != "lean"

    # -- routing ---------------------------------------------------------------
    def _route_hash(self, fn_id: str) -> int:
        r = self.router
        k = r.assign.get(fn_id)
        if k is None:
            k = r.assign[fn_id] = hash_shard(fn_id, self._n)
        return k

    def _flow_idle(self, fn_id: str, k: int) -> bool:
        q = self.shards[k].policy.queues.get(fn_id)
        return q is None or (not q.pending and q.in_flight == 0)

    def _route_sticky(self, fn_id: str) -> int:
        return self.router.route(
            fn_id, [s.pending_count for s in self.shards], self._flow_idle)

    def route(self, fn_id: str) -> int:
        """Public routing entry (the wall-clock executor serializes
        calls with its own router lock)."""
        return self._route_fast(fn_id)

    def shard_of_device(self, dev_id: int) -> ControlPlane:
        return self.shards[dev_id // self._group]

    # -- ControlPlane driver API ------------------------------------------------
    def on_arrival(self, inv: Invocation, now: float) -> None:
        self.shards[self._route_fast(inv.fn_id)].on_arrival(inv, now)

    def dispatch_once(self, now: float) -> Optional[DispatchDecision]:
        """Round-robin shard stepper: try each shard once starting at a
        rotating cursor; the first decision wins and advances the
        cursor. Returns None only when every shard refuses — exactly the
        monolithic contract, so the executors' drain loops terminate the
        same way. Deterministic: the cursor depends only on the decision
        sequence."""
        shards = self.shards
        n = self._n
        start = self._cursor
        for i in range(n):
            k = start + i
            if k >= n:
                k -= n
            d = shards[k].dispatch_once(now)
            if d is not None:
                k += 1
                self._cursor = k if k < n else 0
                return d
        return None

    def drain(self, now: float, budget: Optional[int] = None,
              realize: Optional[Callable[[DispatchDecision], None]] = None
              ) -> List[DispatchDecision]:
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
        out = self.drain(now, budget=1)
        return out[0] if out else None

    def on_complete(self, inv: Invocation, now: float) -> None:
        self.shards[inv.device_id // self._group].on_complete(inv, now)

    # -- cold-start data plane (datapath="pipeline") -----------------------------
    # Shards inherit the datapath config through the replace() above;
    # each owns its devices' links/staging, so delegation is a flat
    # fan-out with a bounded-min merge for the TRANSFER arming signal
    # (the _ShardedPolicyView.next_expiry pattern).
    def datapath_tick(self, now: float) -> None:
        for s in self.shards:
            s.datapath_tick(now)

    def prefetch_pass(self, now: float) -> None:
        for s in self.shards:
            s.prefetch_pass(now)

    def next_transfer_eta(self) -> Optional[float]:
        best: Optional[float] = None
        for s in self.shards:
            e = s.next_transfer_eta()
            if e is not None and (best is None or e < best):
                best = e
        return best

    def advance_transfers(self, now: float) -> None:
        for s in self.shards:
            s.advance_transfers(now)

    def sample(self, now: float) -> None:
        shards = self.shards
        for s in shards:
            s.sample(now)
        if self._n == 1:
            util = shards[0]._last_u      # exact: no re-scaling
        else:
            tot = 0.0
            for s in shards:
                tot += s._last_u * s._n_dev
            util = tot / self._n_dev
        self.util_integral += self._last_u * (now - self._last_t)
        self._last_t = now
        self._last_u = util
        if self._record_util:
            self.util_samples.append((now, util))
        if self._sync_enabled and now - self._last_sync >= self.vt_epoch:
            self.sync_vt(now)

    # -- cross-shard VT sync -----------------------------------------------------
    def sync_vt(self, now: float) -> None:
        """One epoch: publish every local shard's min pending VT, read
        the cross-shard max-of-mins, inject it as each shard's Global_VT
        floor. With an external bus the read may race other processes'
        writes — by design: the snapshot is allowed to be one epoch
        stale, which is exactly the drift bound."""
        bus = self.vt_bus
        prev = self._prev_floor
        for s, slot in zip(self.shards, self.vt_slots):
            vt = s.policy.min_pending_vt()
            if prev > _NEG_INF:
                gvt = getattr(s.policy, "global_vt", None)
                if gvt is not None and prev - gvt > self.vt_max_lag:
                    self.vt_max_lag = prev - gvt
            if vt is not None:
                bus.publish(slot, vt)
        floor = bus.floor()
        if floor > _NEG_INF:
            for s in self.shards:
                s.policy.raise_vt_floor(floor)
            self.vt_floor = floor
            self._prev_floor = floor
        self.vt_syncs += 1
        self._last_sync = now

    # -- fault plane --------------------------------------------------------------
    # Thin routing over the owning shard: device-scoped calls go by
    # device id, requeue by the flow's routed shard (the same map
    # arrivals use, so a retry rejoins its own queue).
    def device_state(self, dev_id: int):
        return self.shard_of_device(dev_id).device_state(dev_id)

    def inflight_on(self, dev_id: int) -> List[Invocation]:
        return self.shard_of_device(dev_id).inflight_on(dev_id)

    def fail_device(self, dev_id: int, now: float) -> List[Invocation]:
        return self.shard_of_device(dev_id).fail_device(dev_id, now)

    def readmit_device(self, dev_id: int, now: float) -> Optional[float]:
        return self.shard_of_device(dev_id).readmit_device(dev_id, now)

    def on_attempt_failed(self, inv: Invocation, now: float,
                          reason: str) -> Optional[float]:
        return self.shards[inv.device_id // self._group] \
            .on_attempt_failed(inv, now, reason)

    def requeue(self, inv: Invocation, now: float) -> None:
        self.shards[self._route_fast(inv.fn_id)].requeue(inv, now)

    def abort_transfers(self, dev_id: int, fn_id: Optional[str],
                        now: float) -> int:
        return self.shard_of_device(dev_id) \
            .abort_transfers(dev_id, fn_id, now)

    @property
    def quarantine_s(self) -> float:
        return self.shards[0].quarantine_s

    # -- aggregate views ---------------------------------------------------------
    @property
    def devices(self) -> List:
        return [d for s in self.shards for d in s.devices]

    @property
    def pool(self) -> MergedPools:
        return MergedPools([s.pool for s in self.shards])

    @property
    def fairness(self) -> MergedFairness:
        return MergedFairness([s.fairness for s in self.shards])

    @property
    def stage_ns(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for s in self.shards:
            for k, v in s.stage_ns.items():
                out[k] = out.get(k, 0) + v
        return out

    @property
    def pending_count(self) -> int:
        return sum(s.pending_count for s in self.shards)

    @property
    def total_pending(self) -> int:
        return sum(s.total_pending for s in self.shards)

    @property
    def total_inflight(self) -> int:
        return sum(s.total_inflight for s in self.shards)

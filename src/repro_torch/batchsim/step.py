"""The batch simulator's event step, as eager torch over a lane axis.

The port of ``repro.batchsim.step``. ``simulate_one(p, c, st)`` replays
the padded trace for every lane (config) at once through the same
array-program mirror of the scalar fast path (``SimExecutor._run_fast``
over ``ControlPlane`` with ``sampling="transition"``,
``batch_dispatch=True``, ``datapath="scalar"``, static D, one device,
``mem_policy="prefetch_swap"`` with the clean resident sweep): the same
event ordering (arrival < completion < timer at equal times, completion
ties by dispatch sequence), the same dispatch pipeline, the same
deferred-transition pass at the top of ``choose``, the same fairness
windows and utilization integral.

Where the reference writes one lane and lets ``vmap`` add the config
axis, every function here takes tensors with a leading lane axis ``G``
(``st``, ``p``) beside lane-free consts (``c``), and every per-lane
scalar is a ``(G,)`` tensor.

- Branchless style, as the reference's: every conditional update is a
  masked write whose ``en`` is a ``(G,)`` lane mask.
- The reference's nested ``lax.while_loop``s (the eviction sweeps, the
  deferred transitions, the dispatch drain) are host loops over a lane
  mask that run until no lane's condition holds. A lane whose condition
  went false is a no-op in the body, as JAX's batching rule makes it:
  each body composes its writes' ``en`` with the lane mask. Each test of
  a loop's condition reads ``mask.any()`` on the host, which waits for
  the device; ``lanes_any.syncs`` counts them.
- Eager PyTorch rounds every op on its own, so the reference's
  ``_round1`` FMA barrier is not needed. Ops that fuse a multiply into
  an add and may round once (``torch.add(..., alpha=)``, ``addcmul``,
  ``addcdiv``, ``lerp``, ``torch.compile``) are used nowhere in this
  module; the sites the reference guards carry a comment.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.batchsim.state import (ACTIVE, COLD, EMA, F64, FAM_FCFS,
                                        FAM_MQFQ, HOST_WARM, I32, I64,
                                        INACTIVE, THROTTLED, WARM)

_INF = float("inf")
# int64 sentinel for masked argmin/min over integer keys derived from
# the float bit view; int32 keys (counts, sequence numbers) use _I32MAX
_IMAX = (1 << 63) - 1
_I32MAX = (1 << 31) - 1


def lanes_any(mask: torch.Tensor) -> bool:
    """``mask.any()`` read on the host: the test of a lane-masked loop.
    It waits for the device, so each call is counted in
    ``lanes_any.syncs``."""
    lanes_any.syncs += 1
    return bool(mask.any())


lanes_any.syncs = 0


@functools.lru_cache(maxsize=64)
def _arange(n: int, device: torch.device) -> torch.Tensor:
    return torch.arange(n, device=device)


def _bits(x):
    """Order-preserving int64 view of a NON-NEGATIVE float64 tensor (the
    IEEE-754 bit pattern of x >= 0 is monotone in x, +inf included)."""
    return x.view(I64)


def _srl(x, k: int):
    """Logical right shift of the uint64 bits held in an int64 tensor
    (torch's ``>>`` on int64 is arithmetic)."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _u64(v: int) -> int:
    """A uint64 constant as the int64 of the same bits."""
    return v - (1 << 64) if v >= 1 << 63 else v


_GOLDEN = _u64(0x9E3779B97F4A7C15)
_MIX1 = _u64(0xBF58476D1CE4E5B9)
_MIX2 = _u64(0x94D049BB133111EB)


def _splitmix(seed, n):
    """splitmix64 of (seed, n): the plain-MQFQ candidate draw, bit for
    bit the reference's uint64 stream. ``seed`` is the int64 of the
    uint64 seed's bits; int64 multiply and add wrap modulo 2^64 exactly
    as uint64 does, and the right shifts are logical."""
    x = seed * _GOLDEN + n.to(I64)
    x = x + _GOLDEN
    x = (x ^ _srl(x, 30)) * _MIX1
    x = (x ^ _srl(x, 27)) * _MIX2
    return x ^ _srl(x, 31)


def _umod(x, m):
    """``x % m`` of the uint64 bits held in int64 ``x``, for
    0 < m < 2^31, from the high and low 32-bit halves (a signed ``%`` of
    a negative int64 is another draw)."""
    hi = _srl(x, 32)
    lo = x & 0xFFFFFFFF
    return ((hi % m) * (1 << 32) + lo) % m


def _i(b):
    """bool -> 0/1 (int32) for counter arithmetic."""
    return b.to(I32)


def _full(like, val, dtype):
    return torch.full(like.shape, val, dtype=dtype, device=like.device)


def _take(arr, i):
    """``arr[g, i[g]]`` for every lane ``g``: arr (G, N), i (G,)."""
    return arr.gather(1, i.to(I64).unsqueeze(1)).squeeze(1)


def _hot(arr, i, en=None):
    hot = _arange(arr.shape[1], arr.device) == i.unsqueeze(1)
    if en is not None:
        hot = hot & en.unsqueeze(1)
    return hot


def _col(val, arr):
    if isinstance(val, torch.Tensor):
        return val.to(arr.dtype).unsqueeze(1)
    return val


def _set(arr, i, val, en=None):
    """``arr[g, i[g]] = val[g]`` where ``en[g]``, as a one-hot masked
    write."""
    return torch.where(_hot(arr, i, en), _col(val, arr), arr)


def _add(arr, i, val, en=None):
    """``arr[g, i[g]] += val[g]`` where ``en[g]``, as a one-hot masked
    add."""
    return torch.where(_hot(arr, i, en), arr + _col(val, arr), arr)


def _lex_argmin(mask, *keys):
    """Per lane, the index of the lexicographic minimum of ``keys``
    restricted to ``mask`` (G, N) — the array mirror of the scalar
    plane's stable sorts / heap orders. Keys are (G, N) or lane-free
    (N,). Returns 0 for a lane whose mask is empty. ``argmax`` of the
    cast mask gives the first maximal index, as ``jnp.argmax`` does."""
    m = mask
    for k in keys:
        if k.dtype.is_floating_point:
            big = _INF
        else:
            big = torch.iinfo(k.dtype).max
        kk = torch.where(m, k, big)
        m = m & (kk == kk.amin(dim=1, keepdim=True))
    return m.to(torch.uint8).argmax(dim=1)


def _upd(st, **kw):
    st = dict(st)
    st.update(kw)
    return st


def _b(x):
    """(G,) -> (G, 1), to broadcast a per-lane value over a lane's row."""
    return x.unsqueeze(1)


# -- memory manager (prefetch_swap, clean resident sweep) -------------------
def _evict_lru(p, c, st, need, now, protect, en):
    """``MemoryManager._evict_lru``: evict least-recently-used regions
    (evictable pool first, then clean still-resident victims) until
    ``need`` bytes fit; ``protect`` is never a victim."""
    F = c["ins"].shape[0]
    notp = _arange(F, need.device) != _b(protect)
    resident, upload_eta = st["resident"], st["upload_eta"]
    evictable, mem_used = st["evictable"], st["mem_used"]
    bytes_evicted = st["bytes_evicted"]
    while True:
        act = (en & ((p["capacity"] - mem_used) < need)
               & (resident & notp).any(dim=1))
        if not lanes_any(act):
            break
        ev = resident & evictable & notp
        res = resident & notp
        mask = torch.where(ev.any(dim=1, keepdim=True), ev, res)
        v = _lex_argmin(mask, st["r_last_use"], c["ins"])
        sz = c["mem_bytes"][v]
        resident = _set(resident, v, False, act)
        upload_eta = _set(upload_eta, v, -1.0, act)
        evictable = _set(evictable, v, False, act)
        mem_used = torch.where(act, mem_used - sz, mem_used)
        bytes_evicted = torch.where(act, bytes_evicted + sz, bytes_evicted)
    st = _upd(st, resident=resident, upload_eta=upload_eta,
              evictable=evictable, mem_used=mem_used,
              bytes_evicted=bytes_evicted)
    ok = (p["capacity"] - st["mem_used"]) >= need
    return st, ok


def _mem_on_queue_active(p, c, st, f, now, en):
    """Anticipatory prefetch on Active entry: start the H2D upload now
    unless the region is already resident or mid-upload."""
    sz = c["mem_bytes"][f]
    st = _upd(
        st,
        region_exists=_set(st["region_exists"], f, True, en),
        evictable=_set(st["evictable"], f, False, en))
    skip = _take(st["resident"], f) | (_take(st["upload_eta"], f) > now)
    do = en & ~skip
    st, ok = _evict_lru(p, c, st, sz, now, f, do)
    did = do & ok
    return _upd(
        st,
        upload_eta=_set(st["upload_eta"], f, now + sz / p["h2d_bw"], did),
        resident=_set(st["resident"], f, True, did),
        mem_used=st["mem_used"] + torch.where(did, sz, 0.0),
        prefetch_count=st["prefetch_count"] + _i(did),
        bytes_uploaded=st["bytes_uploaded"] + torch.where(did, sz, 0.0))


def _mem_on_queue_idle(p, c, st, f, now, en):
    """Idle exit: mark evictable; prefetch_swap frees completed uploads
    immediately."""
    en = en & _take(st["region_exists"], f)
    sz = c["mem_bytes"][f]
    st = _upd(st, evictable=_set(st["evictable"], f, True, en))
    do = en & _take(st["resident"], f) & (_take(st["upload_eta"], f) <= now)
    return _upd(
        st,
        resident=_set(st["resident"], f, False, do),
        upload_eta=_set(st["upload_eta"], f, -1.0, do),
        mem_used=st["mem_used"] - torch.where(do, sz, 0.0),
        bytes_evicted=st["bytes_evicted"] + torch.where(do, sz, 0.0))


def _mem_acquire(p, c, st, f, now, en):
    """``MemoryManager.acquire`` at dispatch: returns (st, ready) where
    ready is when the weights are on-device (upload ETA on a miss)."""
    sz = c["mem_bytes"][f]
    st = _upd(
        st,
        region_exists=_set(st["region_exists"], f, True, en),
        evictable=_set(st["evictable"], f, False, en),
        r_last_use=_set(st["r_last_use"], f, now, en))
    hit = _take(st["resident"], f)
    # scalar plane starts the upload even when reclaim cannot fit it
    # (result ignored); mirror that by not gating on ok
    st, _ok = _evict_lru(p, c, st, sz, now, f, en & ~hit)
    miss = en & ~hit
    eta_new = now + sz / p["h2d_bw"]
    ready = torch.where(hit, torch.maximum(_take(st["upload_eta"], f), now),
                        eta_new)
    st = _upd(
        st,
        resident=_set(st["resident"], f, True, miss),
        upload_eta=_set(st["upload_eta"], f, eta_new, miss),
        mem_used=st["mem_used"] + torch.where(miss, sz, 0.0),
        bytes_uploaded=st["bytes_uploaded"] + torch.where(miss, sz, 0.0))
    return st, ready


# -- warm pool ---------------------------------------------------------------
def _pool_acquire(p, c, st, f, now, dev_res, en):
    """``WarmPool.acquire``: most-recently-released idle container of
    this fn (warm / host_warm by device residency), else evict global
    LRU idle containers while at capacity and create cold."""
    idle = st["c_exists"] & (st["c_fn"] == _b(f)) & (st["c_idle_seq"] >= 0)
    # most-recently-released first, release order on ties: max last_use
    # via the order-preserving bit view (sentinel -1 < any bit pattern
    # of a time >= 0, so a finite max doubles as the has-idle test)
    bt = _bits(st["c_last_use"])
    mbt = torch.where(idle, bt, -1).amax(dim=1)
    has_idle = mbt >= 0
    ci = torch.where(idle & (bt == _b(mbt)), st["c_idle_seq"],
                     _I32MAX).argmin(dim=1)
    take = en & has_idle
    st = _upd(
        st,
        c_idle_seq=_set(st["c_idle_seq"], ci, -1, take),
        c_last_use=_set(st["c_last_use"], ci, now, take),
        warm=st["warm"] + _i(take & dev_res),
        host_warm=st["host_warm"] + _i(take & ~dev_res))

    mk = en & ~has_idle
    c_exists, c_idle_seq = st["c_exists"], st["c_idle_seq"]
    pool_total, evc = st["pool_total"], st["pool_evictions"]
    # a container that does not exist holds c_fn -1; its stamp is masked
    # out below, so the gather reads flow 0 in its place
    stamps = st["fn_stamp"].gather(1, st["c_fn"].clamp(min=0).to(I64))
    while True:
        gi = c_exists & (c_idle_seq >= 0)
        act = mk & (pool_total >= p["pool_size"]) & gi.any(dim=1)
        if not lanes_any(act):
            break
        v = _lex_argmin(gi, st["c_last_use"], stamps, c_idle_seq)
        c_exists = _set(c_exists, v, False, act)
        c_idle_seq = _set(c_idle_seq, v, -1, act)
        pool_total = pool_total - _i(act)
        evc = evc + _i(act)
    st = _upd(st, c_exists=c_exists, c_idle_seq=c_idle_seq,
              pool_total=pool_total, pool_evictions=evc)
    free = (~st["c_exists"]).to(torch.uint8).argmax(dim=1)
    st = _upd(
        st,
        c_exists=_set(st["c_exists"], free, True, mk),
        c_fn=_set(st["c_fn"], free, f, mk),
        c_idle_seq=_set(st["c_idle_seq"], free, -1, mk),
        c_last_use=_set(st["c_last_use"], free, now, mk),
        pool_total=st["pool_total"] + _i(mk),
        cold=st["cold"] + _i(mk))
    ctr = torch.where(has_idle, ci, free)
    stype = torch.where(has_idle,
                        torch.where(dev_res, WARM, _full(dev_res, HOST_WARM,
                                                         I32)),
                        COLD)
    return st, ctr, stype


def _pool_release(p, c, st, ci, now, en):
    """``WarmPool.release``: back to idle; a fn's eviction stamp is
    assigned at its FIRST release (monotone counter), idle order by the
    global release sequence."""
    # a disabled lane's slot may name a container with c_fn -1; every
    # write below is gated on en, so it reads flow 0 in its place
    f = _take(st["c_fn"], ci).clamp(min=0).to(I64)
    need_stamp = en & (_take(st["fn_stamp"], f) < 0)
    return _upd(
        st,
        c_last_use=_set(st["c_last_use"], ci, now, en),
        fn_stamp=_set(st["fn_stamp"], f, st["stamp_ctr"], need_stamp),
        stamp_ctr=st["stamp_ctr"] + _i(need_stamp),
        c_idle_seq=_set(st["c_idle_seq"], ci, st["rel_seq"], en),
        rel_seq=st["rel_seq"] + _i(en))


# -- MQFQ state machine ------------------------------------------------------
def _update_state(p, c, st, f, now, en):
    """``MQFQSticky._update_state`` + the anticipatory memory hooks the
    control plane registers (fired only on actual state changes)."""
    pending = (_take(st["n_arr"], f) - _take(st["n_disp"], f)) > 0
    idle = ~pending & (_take(st["in_flight"], f) == 0)
    vt = _take(st["vt"], f)
    g = st["gvt"]
    thr = (vt >= g + p["T"]) & (vt > g)       # core.mqfq.throttled
    old = _take(st["qstate"], f)
    expired = (old != INACTIVE) & (
        now - _take(st["last_exec"], f) >= p["alpha"] * _take(st["iat"], f))
    busy_new = torch.where(thr, THROTTLED, _full(thr, ACTIVE, I32))
    idle_new = torch.where(expired | (old == INACTIVE), INACTIVE, busy_new)
    new = torch.where(idle, idle_new, busy_new)
    st = _upd(st, qstate=_set(st["qstate"], f, new, en))
    changed = en & (old != new)
    st = _mem_on_queue_active(p, c, st, f, now, changed & (new == ACTIVE))
    st = _mem_on_queue_idle(p, c, st, f, now, changed & (new != ACTIVE))
    return st


def _refresh_gvt(p, st, en):
    """Global_VT floor: monotone max with the min VT over queues with
    pending work (a finite min implies a pending queue exists)."""
    pend = (st["n_arr"] - st["n_disp"]) > 0
    mp = torch.where(pend, st["vt"], _INF).amin(dim=1)
    lift = en & (mp < _INF) & (mp > st["gvt"])
    return _upd(st, gvt=torch.where(lift, mp, st["gvt"]))


# -- choose / dispatch -------------------------------------------------------
def _choose(p, c, st, now, en):
    """``MQFQSticky.choose`` (and the FCFS/SJF baselines): deferred
    transitions, Global_VT refresh, then the policy's argmin. Returns
    (st, found, flow). ``en`` gates the whole call (a disabled lane
    must not advance the decisions counter or run transitions)."""
    F = c["ins"].shape[0]
    is_mqfq = p["family"] == FAM_MQFQ
    st = _upd(st, decisions=st["decisions"] + _i(is_mqfq & en))
    st = _refresh_gvt(p, st, is_mqfq & en)

    # deferred pass: TTL expiries + throttle releases, creation order
    pend = (st["n_arr"] - st["n_disp"]) > 0
    idle = ~pend & (st["in_flight"] == 0)
    # alpha*iat rounds before the add (the reference's _round1 site):
    # eager torch runs the product and the sum as two kernels, each
    # rounded, never as one fused multiply-add
    expiry = idle & (st["qstate"] != INACTIVE) & (
        st["last_exec"] + _b(p["alpha"]) * st["iat"] <= _b(now))
    g = _b(st["gvt"])
    elig = (st["vt"] < g + _b(p["T"])) | (st["vt"] <= g)  # index.eligible
    unthr = (st["qstate"] == THROTTLED) & elig
    rem = (expiry | unthr) & _b(is_mqfq & en)

    # one trip per due flow, in creation order; everything the pass
    # reads but _update_state does not write is frozen for its duration
    while True:
        act = rem.any(dim=1)
        if not lanes_any(act):
            break
        f = _lex_argmin(rem, c["ins"])
        st = _update_state(p, c, st, f, now, act)
        rem = _set(rem, f, False, act)

    qlen = st["n_arr"] - st["n_disp"]
    pend = qlen > 0
    cand = torch.where(_b(is_mqfq), (st["qstate"] == ACTIVE) & pend,
                       pend) & _b(en)

    # One two-phase argmin serves every family — a per-family int64
    # primary key, then an exact integer tie-break (distinct per flow,
    # so the pick is deterministic):
    #   sticky:  core.index.candidate_key — (-len, ins) at D==1,
    #            (in_flight, -len, ins) at D!=1; device_parallelism
    #            syncs to D at the first utilization sample (scalar
    #            ``_dp_synced``), 1 before
    #   FCFS:    earliest head arrival (bit view), dict-order ties
    #   SJF:     smallest tau (bit view), dict-order ties
    eff_dp = torch.where(st["dp_synced"], p["d"], 1)
    infl = torch.where(_b(eff_dp == 1), 0, st["in_flight"])
    PF = c["per_fn_times"].shape[1]
    head = c["per_fn_times"][_arange(F, now.device),
                             st["n_disp"].clamp(0, PF - 1).to(I64)]
    k1 = torch.where(
        _b(is_mqfq), infl.to(I64),
        _bits(torch.where(_b(p["family"] == FAM_FCFS), head, st["tau"])))
    m1 = torch.where(cand, k1, _IMAX).amin(dim=1)
    found = m1 < _IMAX
    NE = c["times"].shape[0]
    k2 = torch.where(_b(is_mqfq), (NE + 1 - qlen) * F + c["ins"], c["ins"])
    f_det = torch.where(cand & (k1 == _b(m1)), k2, _I32MAX).argmin(dim=1)
    # plain MQFQ: a uniform choice over candidates in creation order —
    # statistically equivalent stream, not the scalar Mersenne stream
    cs = torch.cumsum(cand[:, c["order"]].to(I32), dim=1, dtype=I32)
    cnt = cs[:, F - 1]
    rnd = _splitmix(p["seed"], st["decisions"])
    r = _umod(rnd, cnt.clamp(min=1).to(I64)).to(I32)
    pos = (cs == _b(r + 1)).to(torch.uint8).argmax(dim=1)
    f_rand = c["order"][pos]
    f = torch.where(is_mqfq & ~p["sticky"], f_rand, f_det)
    return st, found, f


def _try_choose(p, c, st, now, en):
    """The cheap half of ``ControlPlane.dispatch_once``: run the
    policy's choose (which mutates state — deferred transitions,
    Global_VT, the decisions counter — even on a failing attempt), then
    the D-token + admission check. Returns (st, ok, flow)."""
    st, found, f = _choose(p, c, st, now, en)
    ok = (found & (st["outstanding"] < p["d"])
          & (st["running_bytes"] + c["mem_bytes"][f] <= p["capacity"]))
    return st, ok, f


def _commit_dispatch(p, c, st, now, f, en):
    """The expensive half: pop, VT advance, state hooks, warm-pool +
    memory acquire, cold-cost realization, completion slot fill, for the
    lanes of ``en`` (a checked ``ok`` attempt). The reference's writes
    here are unconditional (its lane masking rides on the drain while's
    carry select); the port gates each one on ``en``."""
    is_mqfq = p["family"] == FAM_MQFQ
    sz = c["mem_bytes"][f]
    PF = c["per_fn_times"].shape[1]
    j = _take(st["n_disp"], f).clamp(0, PF - 1)
    inv = c["per_fn_inv"][f, j.to(I64)]

    # pop + policy.on_dispatch (VT advance by tau/weight; the
    # vt_by_service=False ablation charges a unit tau)
    tau_eff = torch.where(is_mqfq & ~p["vt_by_service"], 1.0,
                          _take(st["tau"], f))
    st = _upd(
        st,
        n_disp=_add(st["n_disp"], f, 1, en),
        vt=_add(st["vt"], f, tau_eff / _take(p["weights"], f), en),
        in_flight=_add(st["in_flight"], f, 1, en),
        last_exec=_set(st["last_exec"], f, now, en))
    st = _refresh_gvt(p, st, is_mqfq & en)
    st = _update_state(p, c, st, f, now, is_mqfq & en)

    # D-token, then residency snapshot *after* the state hooks (a
    # dispatch that throttles its own flow can evict its region first)
    st = _upd(st, outstanding=st["outstanding"] + _i(en))
    dev_res = (_take(st["region_exists"], f) & _take(st["resident"], f)
               & (_take(st["upload_eta"], f) <= now))
    st, ci, stype = _pool_acquire(p, c, st, f, now, dev_res, en)
    st, ready = _mem_acquire(p, c, st, f, now, en)

    # device accounting (demand includes this invocation)
    first = _take(st["run_cnt"], f) == 0
    demand = c["demand"][f]
    st = _upd(
        st,
        running_bytes=st["running_bytes"] + torch.where(first & en, sz, 0.0),
        run_cnt=_add(st["run_cnt"], f, 1, en),
        demand_sum=st["demand_sum"] + torch.where(en, demand, 0.0))

    # realization: cold-cost model + oversubscription stretch. The
    # stretch's demand sum must be BITWISE the scalar plane's, which
    # sums per-invocation demands in dispatch order on every read: so
    # re-sum the active slots in dispatch-seq order, one add at a time
    # over the slot axis (never ``sum`` over an axis, whose order is the
    # library's), with this invocation's demand appended last as the
    # scalar plane inserts it. Inactive slots add 0.0 wherever they sort.
    overhead = (ready - now
                + torch.where(stype == COLD, c["cold_init"][f], 0.0))
    dvals = torch.where(st["s_active"], c["demand"][st["s_flow"].to(I64)],
                        0.0)
    order = torch.sort(torch.where(st["s_active"], st["s_seq"], _I32MAX),
                       dim=1, stable=True).indices
    dvals = dvals.gather(1, order)
    dsum = torch.zeros_like(demand)
    for k in range(dvals.shape[1]):
        dsum = dsum + dvals[:, k]
    dsum = dsum + demand
    # beta * excess rounds BEFORE the ``1.0 +`` add (the reference's
    # _round1 site): two eager kernels, never one fused multiply-add
    stretch = 1.0 + p["beta"] * torch.clamp(dsum - 1.0, min=0.0)
    service = c["warm_time"][f] * stretch
    completion = now + overhead + service

    # the per-invocation output fields ride in the slot until the
    # completion event writes the (NE, 6) record in one scatter
    si = (~st["s_active"]).to(torch.uint8).argmax(dim=1)
    seq = st["dispatch_seq"]
    return _upd(
        st,
        busy_time=st["busy_time"] + torch.where(en, service, 0.0),
        s_active=_set(st["s_active"], si, True, en),
        s_time=_set(st["s_time"], si, completion, en),
        s_seq=_set(st["s_seq"], si, seq, en),
        s_flow=_set(st["s_flow"], si, f, en),
        s_inv=_set(st["s_inv"], si, inv, en),
        s_service=_set(st["s_service"], si, service, en),
        s_charged=_set(st["s_charged"], si, tau_eff, en),
        s_container=_set(st["s_container"], si, ci, en),
        s_disp_t=_set(st["s_disp_t"], si, now, en),
        s_overhead=_set(st["s_overhead"], si, overhead, en),
        s_stype=_set(st["s_stype"], si, stype, en),
        dispatch_seq=seq + _i(en))


# -- event handlers ----------------------------------------------------------
def _arrival_flow(c, st):
    """The flow of the next trace event. Past the trace the padding's -1
    reads as flow 0; every write it feeds is gated off there."""
    NE = c["times"].shape[0]
    return c["fn_idx"][st["arr_ptr"].clamp(0, NE - 1).to(I64)].clamp(min=0)


def _handle_arrival(p, c, st, now, en):
    is_mqfq = p["family"] == FAM_MQFQ
    f = _arrival_flow(c, st)
    # FlowQueue.arrive: IAT estimate (EMA only once service observed),
    # SFQ start-tag lift for non-backlogged queues
    gap = torch.clamp(now - _take(st["last_arrival"], f), min=1e-9)
    # both products round before the add (the reference's _round1
    # site): each product and the sum are separate eager kernels, so a
    # fused (1-EMA)*iat + EMA*gap cannot drift iat an ulp off the
    # scalar plane (iat feeds the anticipatory TTL deadline)
    new_iat = torch.where(_take(st["tau_n"], f) > 0,
                          (1 - EMA) * _take(st["iat"], f) + EMA * gap, gap)
    upd_iat = en & _take(st["has_arr"], f)
    not_backlogged = (((_take(st["n_arr"], f) - _take(st["n_disp"], f)) == 0)
                      & (_take(st["in_flight"], f) == 0))
    g_eff = torch.where(is_mqfq, st["gvt"], 0.0)
    st = _upd(
        st,
        iat=_set(st["iat"], f, new_iat, upd_iat),
        has_arr=_set(st["has_arr"], f, True, en),
        last_arrival=_set(st["last_arrival"], f, now, en),
        vt=_set(st["vt"], f, torch.maximum(_take(st["vt"], f), g_eff),
                en & not_backlogged),
        n_arr=_add(st["n_arr"], f, 1, en),
        created=_set(st["created"], f, True, en))
    # the MQFQ state-machine update runs once per event, merged with the
    # completion handler's, in _event_step
    st = _upd(
        st,
        backlogged=_set(st["backlogged"], f, True, en),
        arr_ptr=st["arr_ptr"] + _i(en))
    # non-anticipatory baselines: residency driven by queue occupancy
    return _mem_on_queue_active(p, c, st, f, now, en & ~is_mqfq)


def _handle_complete(p, c, st, now, en, si):
    """``si`` — the completing slot (earliest s_time, dispatch order on
    ties) — is picked once in ``_event_step``."""
    is_mqfq = p["family"] == FAM_MQFQ
    f = _take(st["s_flow"], si).to(I64)
    service = _take(st["s_service"], si)
    charged = _take(st["s_charged"], si)
    ci = _take(st["s_container"], si).to(I64)
    sz = c["mem_bytes"][f]
    # note_complete + token release
    new_cnt = _take(st["run_cnt"], f) - 1
    lastc = en & (new_cnt <= 0)
    st = _upd(
        st,
        run_cnt=_add(st["run_cnt"], f, -1, en),
        running_bytes=st["running_bytes"] - torch.where(lastc, sz, 0.0),
        demand_sum=st["demand_sum"]
        - torch.where(en, c["demand"][f], 0.0),
        outstanding=st["outstanding"] - _i(en))
    st = _pool_release(p, c, st, ci, now, en)
    # FlowQueue.on_complete: deficit settle + tau EMA; both products
    # round before the add (the reference's _round1 site): separate
    # eager kernels, never a fused multiply-add
    new_tau_n = _take(st["tau_n"], f) + 1
    new_tau = torch.where(new_tau_n == 1, service,
                          (1 - EMA) * _take(st["tau"], f) + EMA * service)
    st = _upd(
        st,
        in_flight=_add(st["in_flight"], f, -1, en),
        last_exec=_set(st["last_exec"], f, now, en),
        vt=_add(st["vt"], f, (service - charged) / _take(p["weights"], f),
                en & p["deficit"]),
        tau_n=_add(st["tau_n"], f, 1, en),
        tau=_set(st["tau"], f, new_tau, en))
    # MQFQ state-machine update deferred to _event_step's merged call
    # fairness accounting (tau recorded post-EMA), backlog transition
    nb = (((_take(st["n_arr"], f) - _take(st["n_disp"], f)) == 0)
          & (_take(st["in_flight"], f) == 0))
    gone = en & nb
    st = _upd(
        st,
        fsvc=_add(st["fsvc"], f, service, en),
        ftau=_set(st["ftau"], f, _take(st["tau"], f), en),
        ftau_set=_set(st["ftau_set"], f, True, en),
        backlogged=_set(st["backlogged"], f, False, gone),
        disq=_set(st["disq"], f, True, gone))
    st = _mem_on_queue_idle(p, c, st, f, now, gone & ~is_mqfq)
    # flush the invocation's output record: one row written in place
    # into (G, NE, 6); a disabled lane writes its row 0 back unchanged
    G = now.shape[0]
    lanes = _arange(G, now.device)
    inv = torch.where(en, _take(st["s_inv"], si), 0).to(I64)
    row = torch.stack([_take(st["s_disp_t"], si), now, service,
                       _take(st["s_overhead"], si),
                       _take(st["s_stype"], si).to(F64),
                       _take(st["s_seq"], si).to(F64)], dim=1)
    o_rec = st["o_rec"]
    o_rec[lanes, inv] = torch.where(_b(en), row, o_rec[lanes, inv])
    return _upd(
        st,
        s_active=_set(st["s_active"], si, False, en),
        s_time=_set(st["s_time"], si, _INF, en))


def _sample(p, c, st, now, live):
    """``ControlPlane._sample_transition``: device_parallelism sync,
    utilization time-integral, fairness window roll. ``live`` gates the
    window roll so finished lanes (idling at a frozen ``now`` inside a
    chunk) cannot re-roll a zero-length window."""
    util = torch.clamp(st["demand_sum"], max=1.0)
    st = _upd(
        st,
        dp_synced=st["dp_synced"] | live,
        util_integral=st["util_integral"]
        + st["last_u"] * (now - st["last_t"]),
        last_t=now, last_u=torch.where(live, util, st["last_u"]))
    due = live & ((now - st["f_t0"]) >= p["window"])
    flows = st["backlogged"] & ~st["disq"]
    rec = due & (flows.sum(dim=1) >= 2)
    taus = torch.where(st["ftau_set"], st["ftau"], 0.0)
    s_lo = torch.where(flows, st["fsvc"], _INF).amin(dim=1)
    s_hi = -torch.where(flows, -st["fsvc"], _INF).amin(dim=1)
    t_lo = torch.where(flows, taus, _INF).amin(dim=1)
    t_hi = -torch.where(flows, -taus, _INF).amin(dim=1)
    T_pol = torch.where(p["family"] == FAM_MQFQ, p["T"], 0.0)
    gap = s_hi - s_lo
    bound = (p["d"] - 1) * (2.0 * T_pol + (t_hi - t_lo))
    return _upd(
        st,
        n_windows=st["n_windows"] + _i(rec),
        gap_sum=st["gap_sum"] + torch.where(rec, gap, 0.0),
        gap_max=torch.where(rec, torch.maximum(st["gap_max"], gap),
                            st["gap_max"]),
        bound_sum=st["bound_sum"] + torch.where(rec, bound, 0.0),
        f_t0=torch.where(due, now, st["f_t0"]),
        fsvc=torch.where(_b(due), 0.0, st["fsvc"]),
        disq=torch.where(_b(due), st["created"] & ~st["backlogged"],
                         st["disq"]))


def _arm_timer(p, c, st, now, live):
    """Arm the next anticipatory-TTL lapse iff strictly earlier than the
    current stack top (the executor's strictly-decreasing timer
    stack)."""
    A = st["armed"].shape[1]
    pend = (st["n_arr"] - st["n_disp"]) > 0
    idle = ~pend & (st["in_flight"] == 0) & (st["qstate"] != INACTIVE)
    # alpha*iat rounds before the add (the reference's _round1 site):
    # two eager kernels, never one fused multiply-add
    due_f = st["last_exec"] + _b(p["alpha"]) * st["iat"]
    due = torch.where(idle & (due_f > _b(now)), due_f, _INF).amin(dim=1)
    top = torch.where(st["n_armed"] > 0,
                      _take(st["armed"], (st["n_armed"] - 1).clamp(0, A - 1)),
                      _INF)
    arm = (live & (p["family"] == FAM_MQFQ) & torch.isfinite(due)
           & (due < top))
    can = st["n_armed"] < A
    slot = st["n_armed"].clamp(0, A - 1)
    return _upd(
        st,
        armed=_set(st["armed"], slot, due, arm & can),
        n_armed=st["n_armed"] + _i(arm & can),
        armed_ovf=st["armed_ovf"] | (arm & ~can))


# -- the event loop ----------------------------------------------------------
def _work_left(c, st):
    """Per-lane liveness: trace unread, completions in flight, or
    timers armed."""
    return ((st["arr_ptr"] < c["n_events"])
            | st["s_active"].any(dim=1) | (st["n_armed"] > 0))


def _event_step(p, c, st):
    """One event (arrival | completion | timer) + the dispatch drain.
    Every write is gated on ``live`` so the step is an exact no-op for
    a lane whose trace has finished — finished lanes simply coast."""
    NE = c["times"].shape[0]
    A = st["armed"].shape[1]
    live = _work_left(c, st) & (st["steps"] < c["max_steps"])
    t_arr = torch.where(
        st["arr_ptr"] < c["n_events"],
        c["times"][st["arr_ptr"].clamp(0, NE - 1).to(I64)], _INF)
    # completing slot: earliest s_time (bit view; inactive slots hold
    # +inf), dispatch order on ties — picked here once, shared with
    # _handle_complete (the arrival handler does not touch slots)
    sbt = _bits(st["s_time"])
    mbt = torch.where(st["s_active"], sbt, _IMAX).amin(dim=1)
    si = torch.where(st["s_active"] & (sbt == _b(mbt)), st["s_seq"],
                     _I32MAX).argmin(dim=1)
    t_cmp = torch.where(mbt < _IMAX, _take(st["s_time"], si), _INF)
    t_tmr = torch.where(
        st["n_armed"] > 0,
        _take(st["armed"], (st["n_armed"] - 1).clamp(0, A - 1)), _INF)
    # a finished lane freezes its clock (all three times are +inf)
    now = torch.where(live, torch.minimum(torch.minimum(t_arr, t_cmp),
                                          t_tmr), st["now"])
    # heap order at equal times: ARRIVAL < COMPLETE < TIMER
    en_arr = live & (t_arr == now)
    en_cmp = live & ~en_arr & (t_cmp == now)
    en_tmr = live & ~en_arr & ~en_cmp
    st = _upd(st, now=now, events=st["events"] + _i(live),
              n_armed=st["n_armed"] - _i(en_tmr & (st["n_armed"] > 0)))
    # the event's flow, read before the handlers advance arr_ptr /
    # recycle the slot (arrival and completion are mutually exclusive,
    # so one merged MQFQ state-machine update serves both)
    f_ev = torch.where(en_cmp, _take(st["s_flow"], si).to(I64),
                       _arrival_flow(c, st))
    st = _handle_arrival(p, c, st, now, en_arr)
    st = _handle_complete(p, c, st, now, en_cmp, si)
    st = _update_state(p, c, st, f_ev, now,
                       (en_arr | en_cmp) & (p["family"] == FAM_MQFQ))

    # dispatch drain: the mandatory first attempt (scalar plane calls
    # choose after every event) gates on ``live``; each trip commits the
    # lanes whose last attempt passed and re-attempts on them
    st, ok, f = _try_choose(p, c, st, now, live)
    while lanes_any(ok):
        st = _commit_dispatch(p, c, st, now, f, ok)
        st, ok2, f = _try_choose(p, c, st, now, ok)
        ok = ok & ok2
    st = _sample(p, c, st, now, live)
    st = _arm_timer(p, c, st, now, live)
    return _upd(st, steps=st["steps"] + _i(live))


def simulate_chunk(p, c, st, n_steps: int):
    """``n_steps`` event steps: the unit ``sweep.run_batch`` runs between
    liveness checks."""
    for _ in range(n_steps):
        st = _event_step(p, c, st)
    return st


def simulate_one(p, c, st):
    """Run every lane's whole trace; returns the final state (including
    the per-invocation output arrays). ``sweep.run_batch`` instead
    drives ``simulate_chunk`` blocks (fewer liveness syncs, same
    trajectory)."""
    while lanes_any(_work_left(c, st) & (st["steps"] < c["max_steps"])):
        st = _event_step(p, c, st)
    return _upd(st, step_overflow=_work_left(c, st))

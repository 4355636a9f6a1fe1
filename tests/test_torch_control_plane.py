"""The port's copy of the MQFQ-Sticky control plane against the reference.

(d) The same seeded arrival/completion sequence drives ``repro``'s and
``repro_torch``'s ControlPlane (MQFQ-Sticky policy + DeviceMemoryManager +
warm pool) and must give identical dispatch order, start types, queue
state transitions and evictions. (e) A wall-clock ``make_server`` over
two reduced-qwen3 ``TorchEndpoint(device="cpu")`` drains every request
with cold and warm starts, and so do two reduced xlstm-350m, two reduced
hymba-1.5b (on its ring cache), two reduced granite-moe-3b-a800m (MoE)
and two reduced llava-next-mistral-7b (VLM) endpoints.
"""
import heapq
import importlib
import random

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

GB = 1024 ** 3


def _drive(pkg: str, *, policy: str, T: float, n_devices: int, d: int,
           mem_policy: str, cap_gb: float, seed: int, n_arrivals: int = 300):
    """A small discrete-event loop over one package's ControlPlane;
    returns the trace of everything it decided."""
    ctl = importlib.import_module(f"{pkg}.server.control")
    cfg_mod = importlib.import_module(f"{pkg}.server.config")
    events = importlib.import_module(f"{pkg}.server.events")
    pol = importlib.import_module(f"{pkg}.core.policies")
    inv_mod = importlib.import_module(f"{pkg}.runtime.invocation")
    spec = importlib.import_module(f"{pkg}.workloads.spec")

    rng = random.Random(seed)
    fns = {f"f{i}": spec.FunctionSpec(
        f"f{i}", warm_time=rng.uniform(0.05, 0.6),
        cold_init=rng.uniform(0.2, 1.5),
        mem_bytes=int(rng.uniform(0.5, 2.5) * GB),
        demand=rng.uniform(0.2, 0.8)) for i in range(8)}
    config = cfg_mod.ServerConfig(policy=policy, policy_kwargs={"T": T},
                                  n_devices=n_devices, d=d,
                                  mem_policy=mem_policy,
                                  capacity_bytes=int(cap_gb * GB),
                                  pool_size=6)
    bus = events.EventBus()
    cp = ctl.ControlPlane(pol.make_policy(policy, T=T), fns, config, bus)
    trace = []
    bus.on_state_change(lambda ev: trace.append(
        ("state", ev.fn_id, ev.old.name, ev.new.name, round(ev.time, 9))))
    for dev in cp.devices:
        dev.mem.evict_listeners.append(
            lambda fn, dev_id=dev.dev_id: trace.append(("evict", dev_id, fn)))

    # arrivals: zipf-ish over the functions
    t, heap = 0.0, []
    weights = [1.0 / (i + 1) for i in range(len(fns))]
    names = list(fns)
    for i in range(n_arrivals):
        t += rng.expovariate(6.0)
        heapq.heappush(heap, (t, 1, i, rng.choices(names, weights)[0]))
    seq = n_arrivals

    def realize(dec, now):
        nonlocal seq
        inv = dec.inv
        inv.exec_start = max(now, dec.ready)
        inv.overhead = inv.exec_start - now
        inv.service_time = dec.spec.warm_time * dec.mem_mult
        done = inv.exec_start + inv.service_time
        trace.append(("dispatch", inv.fn_id, inv.inv_id, dec.device.dev_id,
                      dec.start_type, round(now, 9)))
        heapq.heappush(heap, (done, 0, seq, inv))
        seq += 1

    while heap:
        now, kind, idx, item = heapq.heappop(heap)
        if kind == 1:
            inv = inv_mod.Invocation(item, now, inv_id=idx)
            cp.on_arrival(inv, now)
        else:
            item.completion = now
            cp.on_complete(item, now)
        cp.sample(now)
        for dec in cp.drain(now):
            realize(dec, now)
    return trace, cp.total_pending


@pytest.mark.parametrize("policy,T,n_devices,d,mem_policy,cap_gb,seed", [
    ("mqfq-sticky", 10.0, 1, 2, "prefetch_swap", 4.0, 0),
    ("mqfq-sticky", 0.0, 2, 2, "prefetch_swap", 3.0, 1),
    ("mqfq-sticky", 5.0, 2, 1, "ondemand", 3.5, 2),
    ("mqfq-sticky", 10.0, 2, 2, "madvise", 3.0, 4),
    ("mqfq", 10.0, 1, 3, "prefetch_swap", 5.0, 3),
])
def test_control_plane_decisions_match_reference(policy, T, n_devices, d,
                                                 mem_policy, cap_gb, seed):
    kw = dict(policy=policy, T=T, n_devices=n_devices, d=d,
              mem_policy=mem_policy, cap_gb=cap_gb, seed=seed)
    ref, ref_pending = _drive("repro", **kw)
    port, port_pending = _drive("repro_torch", **kw)
    assert ref_pending == port_pending == 0
    kinds = {e[0] for e in ref}
    assert {"dispatch", "state", "evict"} <= kinds, kinds
    assert {e[4] for e in ref if e[0] == "dispatch"} >= {"cold", "warm"}
    assert port == ref


def test_make_policy_builds_the_reference_policy():
    from repro_torch.core.policies import make_policy
    from repro_torch.core.reference import ReferenceMQFQSticky
    assert isinstance(make_policy("ref-mqfq-sticky"), ReferenceMQFQSticky)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "xlstm-350m",
                                  "hymba-1.5b", "granite-moe-3b-a800m",
                                  "llava-next-mistral-7b"])
def test_wallclock_server_drains_torch_endpoints_on_cpu(arch):
    from repro_torch.configs import get_config
    from repro_torch.runtime.device import TorchEndpoint
    from repro_torch.server import ServerConfig, make_server

    cfg = get_config(arch).reduced()
    eps = {f"fn-{i}": TorchEndpoint(f"fn-{i}", cfg, seed=i, serve_seq=16,
                                    serve_batch=1, decode_steps=2,
                                    device="cpu")
           for i in range(2)}
    wb = max(ep.weight_bytes for ep in eps.values())
    server = make_server(ServerConfig(executor="wallclock",
                                      policy="mqfq-sticky", d=1,
                                      capacity_bytes=wb), endpoints=eps)
    server.start()
    try:
        for i, fn in enumerate(["fn-0", "fn-0", "fn-1", "fn-0"]):
            server.submit(fn, {"seed": i})
            server.drain(timeout=120)
    finally:
        res = server.stop()
    assert len(res.invocations) == 4
    assert all(inv.completion is not None for inv in res.invocations)
    starts = res.start_type_counts()
    assert starts.get("cold", 0) == 2 and starts.get("warm", 0) >= 1, starts
    assert starts.get("host_warm", 0) >= 1, starts

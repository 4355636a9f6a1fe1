"""The serving path's spans (``repro_torch.runtime.trace``).

Off, a served fleet leaves no span and reads no clock. On, each
invocation leaves its ``lock``, ``inputs``, ``prefill``, one ``decode`` a
step and its ``sync`` on its worker's thread, inside its own interval of
the executor's clock once mapped through the anchor; a second execution
of one endpoint waits out the first inside its ``lock`` span; and the
anchor puts a span where ``torch.profiler`` puts a range opened inside
it. On a CUDA card (the test marked ``cuda``), an execution's device work
lies inside its spans on the profiler's clock:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_trace.py
"""
import threading
import time

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.runtime import trace  # noqa: E402
from repro_torch.runtime.device import TorchEndpoint  # noqa: E402
from repro_torch.server import ServerConfig, make_server  # noqa: E402

STEPS = 2


@pytest.fixture(autouse=True)
def tracer_off():
    trace.disable()
    yield
    trace.disable()


def endpoints(n=2):
    cfg = get_config("qwen3-1.7b").reduced()
    eps = {f"f{i}": TorchEndpoint(f"f{i}", cfg, seed=i, serve_seq=16,
                                  serve_batch=1, decode_steps=STEPS,
                                  device="cpu")
           for i in range(n)}
    for ep in eps.values():
        ep.compile()
    return eps


def serve(eps, per_fn=3):
    srv = make_server(ServerConfig(executor="wallclock", d=2),
                      endpoints=eps)
    srv.start()
    invs = [srv.submit(f, {"seed": i}) for i in range(per_fn)
            for f in sorted(eps)]
    srv.drain(timeout=120)
    srv.stop()
    assert all(inv.completion is not None for inv in invs)
    return srv, invs


class CountingClock:
    """``time`` as the tracer sees it, counting each clock read."""

    def __init__(self):
        self.calls = 0
        for name in ("monotonic_ns", "thread_time_ns", "time_ns"):
            setattr(self, name, self._counted(getattr(time, name)))

    def _counted(self, fn):
        def call():
            self.calls += 1
            return fn()
        return call


def test_off_a_served_fleet_leaves_no_span_and_reads_no_clock(monkeypatch):
    eps = endpoints()
    trace.enable()
    trace.disable()
    clock = CountingClock()
    monkeypatch.setattr(trace, "time", clock)
    assert trace.begin() is None
    _, invs = serve(eps)
    eps["f0"].evict()
    eps["f0"].upload()
    assert len(invs) == 6
    assert clock.calls == 0
    assert trace.snapshot()["spans"] == []


def by_thread(spans):
    out = {}
    for s in spans:
        out.setdefault(s["thread"], []).append(s)
    return out


def test_on_each_invocation_leaves_its_spans_inside_its_interval():
    eps = endpoints()
    trace.enable()
    srv, invs = serve(eps)
    trace.disable()
    snap = trace.snapshot()
    t0 = srv.executor._t0
    sec = lambda ns: ns / 1e9 - t0          # noqa: E731  executor's clock
    threads = by_thread(snap["spans"])
    assert threading.get_ident() not in threads
    # a worker's spans, cut at each lock: one execution (or prefetch) each;
    # an eviction the control plane makes on completing is no part of it
    runs = []
    for spans in threads.values():
        for s in sorted(spans, key=lambda s: s["start_ns"]):
            if s["name"] == "lock":
                runs.append([s])
            elif s["name"] != "evict":
                runs[-1].append(s)
    for inv in invs:
        # the executor stamps exec_start between getting the lock (and
        # uploading, if the weights were evicted) and executing
        mine = [r for r in runs if r[0]["fn"] == inv.fn_id and any(
            s["name"] == "inputs" and sec(r[0]["end_ns"]) - 1e-6
            <= inv.exec_start <= sec(s["start_ns"]) + 1e-6 for s in r)]
        assert len(mine) == 1, inv.inv_id      # one worker ran it
        names = [s["name"] for s in mine[0]]
        if names[1:3] == ["sync", "upload"]:
            del names[1:3]
        assert names == [
            "lock", "inputs", "prefill"] + ["decode"] * STEPS + ["sync"]
        for s in mine[0]:
            assert inv.exec_start - inv.overhead - 1e-6 <= sec(s["start_ns"])
            assert s["start_ns"] <= s["end_ns"]
            assert sec(s["end_ns"]) <= inv.completion + 1e-6
            assert s["cpu_ns"] >= 0
    # the wall clock is the monotonic one moved by the anchor's offset
    (m0, w0) = snap["anchors"][0]
    for s in snap["spans"]:
        assert abs(s["start_wall_ns"] - (s["start_ns"] + w0 - m0)) \
            <= abs(snap["skew_ns"]) + 1


def interval(spans):
    """(prefill start, sync end) of the one execution in ``spans``."""
    start = min(s["start_ns"] for s in spans if s["name"] == "prefill")
    return start, max(s["end_ns"] for s in spans if s["name"] == "sync")


def test_a_second_execution_of_one_endpoint_waits_in_its_lock_span():
    """Two workers of one endpoint: the second asks for the lock while the
    first holds it (the first starts executing once the second is
    waiting), and waits out the first's whole execution."""
    ep = endpoints(1)["f0"]
    asking = threading.Event()

    def holder():
        with ep.lock:
            asking.wait(timeout=60)
            time.sleep(0.05)           # the second is inside acquire()
            ep.execute({"seed": 0})

    def waiter():
        asking.set()
        with ep.lock:
            ep.execute({"seed": 1})

    trace.enable()
    threads = [threading.Thread(target=holder)]
    threads[0].start()
    while not ep.lock.locked():
        time.sleep(0.001)
    threads.append(threading.Thread(target=waiter))
    threads[1].start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    trace.disable()
    spans = by_thread(trace.snapshot()["spans"])
    first, second = (spans[t.ident] for t in threads)

    def lock(spans):
        (s,) = [s for s in spans if s["name"] == "lock"]
        return s
    a, b = interval(first)
    w = lock(second)
    covered = min(b, w["end_ns"]) - max(a, w["start_ns"])
    assert covered >= 0.9 * (b - a)
    # the wait is no work: the waiting thread spent little CPU in it
    assert w["cpu_ns"] < 0.5 * (w["end_ns"] - w["start_ns"])


def test_upload_holds_its_own_sync_and_evict_is_recorded_once():
    ep = endpoints(1)["f0"]
    trace.enable()
    ep.evict()
    ep.evict()                 # nothing on the device: no instant
    ep.upload()
    trace.disable()
    spans = trace.snapshot()["spans"]
    assert [s["name"] for s in spans] == ["evict", "sync", "upload"]
    evict, sync, upload = spans
    assert evict["start_ns"] == evict["end_ns"]
    assert evict["bytes"] == upload["bytes"] == ep.weight_bytes
    assert upload["start_ns"] <= sync["start_ns"] <= sync["end_ns"] \
        <= upload["end_ns"]


def test_compile_is_one_span_around_its_warm_up():
    cfg = get_config("qwen3-1.7b").reduced()
    ep = TorchEndpoint("c", cfg, serve_seq=16, serve_batch=1,
                       decode_steps=STEPS, device="cpu")
    trace.enable()
    ep.compile()
    trace.disable()
    spans = trace.snapshot()["spans"]
    (c,) = [s for s in spans if s["name"] == "compile"]
    assert [s["name"] for s in spans] == [
        "sync", "upload", "inputs", "prefill", "decode", "sync", "compile"]
    assert all(c["start_ns"] <= s["start_ns"] and s["end_ns"] <= c["end_ns"]
               for s in spans)


def test_enable_starts_an_empty_record_of_the_spans_begun_while_on():
    trace.enable()
    t = trace.begin()
    trace.end(t, "a")
    old = trace.begin()
    trace.enable()             # a new record: "a" is gone
    t = trace.begin()
    trace.disable()
    trace.end(t, "b")          # begun while on, ended after: kept whole
    trace.end(old, "c")        # begun before this record: left out
    trace.end(trace.begin(), "d")   # begun while off: not recorded
    snap = trace.snapshot()
    assert [s["name"] for s in snap["spans"]] == ["b"]
    assert snap["spans"][0]["end_ns"] > snap["anchors"][1][0]
    assert len(snap["anchors"]) == 2 and "warning" not in snap


def test_snapshot_says_when_the_clocks_drift_apart(monkeypatch):
    trace.enable()
    trace.instant("x", "f", 3)
    trace.disable()
    base = trace.snapshot()["skew_ns"]     # the anchors' own reading error
    assert abs(base) < 1_000_000
    (m0, w0), (m1, w1) = trace._anchors
    monkeypatch.setattr(trace, "_anchors", [(m0, w0), (m1, w1 + 2_000_000)])
    snap = trace.snapshot()
    assert snap["skew_ns"] == base + 2_000_000
    assert "warning" in snap
    (x,) = snap["spans"]
    assert (x["fn"], x["bytes"], x["cpu_ns"]) == ("f", 3, 0)
    # interpolated between the anchors
    assert w0 - m0 <= x["start_wall_ns"] - x["start_ns"] \
        <= w1 + 2_000_000 - m1


def test_the_anchor_puts_a_span_where_the_profiler_puts_a_range_in_it():
    from torch.profiler import ProfilerActivity, profile, record_function
    with record_function("warm"):
        pass
    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(5):
            t = trace.begin()
            with record_function(f"probe{i}"):
                torch.ones(4).add_(1)
            trace.end(t, f"probe{i}")
    trace.disable()
    spans = {s["name"]: s for s in trace.snapshot()["spans"]}
    diffs = [abs(e.start_ns() - spans[e.name()]["start_wall_ns"])
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith("probe")]
    assert len(diffs) == 5
    assert min(diffs) < 1_000_000


@pytest.mark.cuda
def test_on_the_card_an_executions_kernels_lie_inside_its_spans():
    """The device trace and the spans on one axis: every kernel and copy
    of an execution falls inside its prefill-start-to-sync-end, on the
    wall clock the snapshot gives."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile
    ep = TorchEndpoint("g", get_config("qwen3-1.7b").reduced(),
                       serve_seq=256, serve_batch=2, decode_steps=STEPS,
                       device="cuda")
    ep.compile()
    trace.enable()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ep.execute({"seed": 1})
    trace.disable()
    a, b = interval([
        {"name": s["name"], "start_ns": s["start_wall_ns"],
         "end_ns": s["end_wall_ns"]} for s in trace.snapshot()["spans"]])
    dev = [(e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == torch.autograd.DeviceType.CUDA
           and not e.is_user_annotation()]
    assert dev
    total = sum(e - s for s, e in dev)
    inside = sum(max(0, min(e, b) - max(s, a)) for s, e in dev)
    assert inside >= 0.99 * total

"""``scripts/program_spans.py``: its readers of the program's spans on
views built by hand, each with a known answer and a case with nothing to
read, and one whole run of a tiny benchmark cell on the CPU with the
tracer on."""
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "program_spans", ROOT / "scripts" / "program_spans.py")
ps = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ps)


def span(name, start, end, cpu=None, thread=1, nbytes=0):
    return {"name": name, "thread": thread, "fn": "f", "bytes": nbytes,
            "start": start, "end": end,
            "cpu": end - start if cpu is None else cpu}


def view(spans, t0=0.0, t1=10.0, invocations=(), idle=None):
    return {"t0": t0, "t1": t1, "spans": spans,
            "invocations": list(invocations), "idle": idle}


def test_lock_wait_is_clipped_lock_time_over_prefills_started():
    v = view([span("lock", -1.0, 1.0), span("prefill", 1.0, 2.0),
              span("lock", 3.0, 3.5, thread=2),
              span("prefill", 3.5, 4.0, thread=2),
              span("lock", 9.5, 11.0), span("prefill", 11.0, 12.0)])
    # locks inside the slice: 1.0 + 0.5 + 0.5; prefills started: 2
    assert ps.lock_wait_s(v) == pytest.approx(2.0 / 2)
    assert ps.lock_wait_s(view([span("lock", 1.0, 2.0)])) is None


def test_decode_step_and_host_run_share():
    v = view([span("prefill", 1.0, 2.0, cpu=0.5),
              span("decode", 2.0, 2.01, cpu=0.01),
              span("decode", 2.01, 2.04, cpu=0.005),
              span("decode", 10.5, 10.6),          # after the slice
              span("sync", 2.04, 3.0, cpu=0.0)])
    assert ps.decode_step_ms(v) == pytest.approx(20.0)
    assert ps.host_run_share(v) == pytest.approx(
        100 * (0.5 + 0.01 + 0.005) / (1.0 + 0.01 + 0.03))
    empty = view([span("sync", 1.0, 2.0)])
    assert ps.decode_step_ms(empty) is None
    assert ps.host_run_share(empty) is None


def test_idle_queued_share_is_idle_while_an_arrival_waits():
    # held: [1, 3) and [2, 4) -> [1, 4); [8, never dispatched) -> [8, 10)
    inv = [(1.0, 3.0), (2.0, 4.0), (-2.0, -1.0), (8.0, None), (12.0, 13.0)]
    idle = [(0.0, 2.0), (3.5, 5.0), (9.0, 10.0)]
    v = view([], invocations=inv, idle=idle)
    # (1, 2) + (3.5, 4) + (9, 10) = 2.5 of 10
    assert ps.idle_queued_share(v) == pytest.approx(25.0)
    assert ps.idle_queued_share(view([], invocations=inv)) is None


def test_idle_gaps_and_the_clock_share_on_the_wall_clock():
    dev = [("k", 10, 20), ("k", 15, 30), ("k", 40, 50), ("k", 95, 120)]
    assert ps.idle_gaps(dev, 0, 100) == [(0, 10), (30, 40), (50, 95)]
    assert ps.idle_gaps([], 0, 100) == [(0, 100)]
    snap = {"spans": [
        {"name": "prefill", "thread": 1, "start_wall_ns": 100,
         "end_wall_ns": 150},
        {"name": "sync", "thread": 1, "start_wall_ns": 180,
         "end_wall_ns": 200},
        {"name": "prefill", "thread": 2, "start_wall_ns": 290,
         "end_wall_ns": 300}]}                     # no sync: still running
    dev = [("flash_fwd_bf16_sm90", 110, 130), ("decode_sm90", 190, 210),
           ("nvjet_gemm", 220, 230), ("decode_sm90", 295, 400)]
    # 20 + 10 of 20 + 20 + 5 (clipped at 300) of the named kernels
    assert ps.clock_share(snap, dev, 0, 300) == pytest.approx(
        100 * 35 / 45)
    assert ps.clock_share(snap, [("nvjet_gemm", 0, 10)], 0, 300) is None


def test_to_window_maps_the_wall_clock_through_the_anchors():
    snap = {"anchors": [[1_000_000_000, 5_000_000_000],
                        [3_000_000_000, 7_000_000_100]], "skew_ns": 100}
    f = ps.to_window(snap, origin=0.5)
    assert f(5_000_000_000) == pytest.approx(0.5)
    assert f(7_000_000_100) == pytest.approx(2.5)


def test_counts_leave_out_the_cold_starts_warm_up():
    class R:
        def __init__(self, t, start):
            self.t_dispatch, self.start_type = t, start
    v = view([span("compile", 1.0, 3.0), span("upload", 1.0, 1.5,
                                                   nbytes=7),
              span("prefill", 2.0, 2.5), span("prefill", 4.0, 4.5),
              span("prefill", 4.0, 4.5, thread=2), span("evict", 5.0, 5.0)])
    assert ps.counts(v, [R(0.9, "cold"), R(4.0, "warm"), R(None, "")]) == {
        "executions": 2, "uploads": 1, "bytes_uploaded": 7,
        "evictions": 1, "compiles": 1, "dispatched_not_warm": 1}


def test_a_tiny_cell_with_the_tracer_on_reads_every_span_reader(tmp_path):
    from portbench.tests.tiny import make_root
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        out = ps.run("tiny.closed", 2 ** 31 + 5, 1.5, tracer=True,
                     profiler=False, device="cpu", root=make_root(tmp_path))
    finally:
        torch.set_num_threads(n)
    assert set(out["spans"]) >= {"lock", "inputs", "prefill", "decode",
                                 "decode.first", "decode.rest", "sync"}
    assert out["metrics"]["tokens_per_s"] > 0
    assert out["counts"]["executions"] > 3
    assert out["lock_wait_s"] >= 0
    assert out["decode_step_ms"] > 0
    assert 0 < out["host_run_share"] <= 101
    assert out["idle_queued_share"] is None        # no device trace
    assert "clock_share" not in out


def test_by_name_splits_each_executions_first_decode_step():
    v = view([span("prefill", 1.0, 2.0, cpu=1.0),
              span("decode", 2.0, 2.5, cpu=0.1),
              span("decode", 2.5, 2.6, cpu=0.1),
              span("prefill", 2.2, 2.3, thread=2),
              span("decode", 2.3, 2.4, thread=2),
              span("decode", 11.0, 12.0)])
    out = ps.by_name(v)
    assert out["decode.first"] == pytest.approx([2, 300.0, 100 * 0.2 / 0.6])
    assert out["decode.rest"] == pytest.approx([1, 100.0, 100.0])
    assert out["decode"][0] == 3 and out["prefill"][0] == 2

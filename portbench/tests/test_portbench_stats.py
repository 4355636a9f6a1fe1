"""Percentiles over every invocation due in the window, timed from its due
time; tokens per second over the invocations completed inside it; the
metric readers over a run built by hand."""
import pytest

from portbench.harness import loader
from portbench.harness.drive import Rec
from portbench.harness.fleet import Fn
from portbench.harness.stats import Run, percentile
from portbench.harness.trace import summarize

FNS = {"a": Fn("a", "x", {}, 2, 10, 4, 0, 1e12, 28),
       "b": Fn("b", "y", {}, 1, 100, 4, 0, 4e12, 104)}


class Inv:
    failed = False


def rec(i, fn, due, sent, disp, done, start="warm", service=0.1, ok=True):
    r = Rec(i, fn, due, sent, Inv(), {"seed": i, "served": 1} if ok else {},
            disp, done, start, service)
    return r


def run():
    recs = [
        rec(0, "a", -1.0, -1.0, -0.9, 0.5),              # warm-up
        rec(1, "a", 0.0, 0.3, 0.4, 1.0),                 # sent late
        rec(2, "b", 1.0, 1.0, 1.5, 3.0, "host_warm", 0.5),
        rec(3, "a", 2.0, 2.0, 2.0, 2.5),
        rec(4, "b", 9.5, 9.5, 9.6, 10.5),                # done after window
        rec(5, "a", 10.0, 10.0, 10.0, 10.2),             # due after window
        rec(6, "a", 3.0, 3.0, None, None, ok=False)]     # never answered
    return Run(10.0, FNS, recs, [(2.0, 0.5, 5e9), (12.0, 1.0, 1e9)], 33.0)


def value(name, r):
    return loader.reader(name).read(r)


def test_percentile_interpolates_between_ranks():
    assert percentile([4, 1, 3, 2], 50) == 2.5
    assert percentile(list(range(101)), 95) == 95
    assert percentile([7.0], 95) == 7.0
    assert percentile([], 50) is None


def test_latency_from_due_time_over_the_window():
    r = run()
    assert sorted(x.idx for x in r.window) == [1, 2, 3, 4, 6]
    # due 0.0 and sent 0.3 late: its latency counts the lateness
    assert sorted(r.latencies()) == pytest.approx([0.5, 1.0, 1.0, 2.0])
    assert value("latency_p50_s", r) == pytest.approx(1.0)


def test_tokens_per_s_counts_completions_inside_the_window():
    r = run()
    # done inside [0, 10): 0 (a, from the warm-up), 1 (a), 2 (b), 3 (a)
    assert value("tokens_per_s", r) == pytest.approx((3 * 28 + 104) / 10)
    assert value("mfu", r) == pytest.approx(
        100 * (3e12 + 4e12) / (10 * 989e12))


def test_layer_readers():
    r = run()
    assert value("queue_wait_s", r) == pytest.approx(
        (0.4 + 0.5 + 0.0 + 0.1) / 4)
    assert value("swap_share", r) == pytest.approx(25.0)
    assert value("service_s.open", r) == pytest.approx(
        (0.1 + 0.5 + 0.1 + 0.1) / 4)
    assert value("upload_gb_per_s", r) == pytest.approx(10.0)
    means = {"a": (1.0 + 0.5) / 2, "b": (2.0 + 1.0) / 2}
    m = sum(means.values()) / 2
    assert value("fn_latency_var_s2", r) == pytest.approx(
        sum((v - m) ** 2 for v in means.values()) / 2)
    assert value("setup_s", r) == 33.0
    # nothing traced: the trace readers find nothing and say nothing
    for name in ("k1_roofline", "k2_roofline", "idle_share.open"):
        assert value(name, r) is None


def test_trace_summary_busy_gaps_and_rooflines():
    s = 10 ** 9
    dev = [("flash_fwd_bf16_sm90<128>", 0, s // 10),
           ("gemm", s // 20, s // 5),                     # overlaps
           ("decode_sm90<bf16>", s // 2, s // 2 + s // 10)]
    ranges = [("prefill", 0, s // 4), ("decode", s // 4, s),
              ("execute", 0, s)]
    t = summarize(dev, ranges, 0, s)
    assert t["window_s"] == 1.0
    assert t["busy_s"] == pytest.approx(0.3)
    gaps = dict(t["idle_gaps"])
    assert gaps["decode"] == pytest.approx(0.7)
    r = run()
    r.trace, r.bound_s = t, {"k1": 0.05, "k2": 0.025}
    assert value("k1_roofline", r) == pytest.approx(50.0)
    assert value("k2_roofline", r) == pytest.approx(25.0)
    assert value("idle_share.closed", r) == pytest.approx(70.0)

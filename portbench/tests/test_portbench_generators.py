"""The traffic generators: seeded, at the offered rate, in their shares."""
from collections import Counter

import pytest

from portbench.harness import loader
from portbench.harness.mixes import deal, shares

OPEN = loader.load_module(loader.BENCH_DIR / "generators" / "open.py")
CLOSED = loader.load_module(loader.BENCH_DIR / "generators" / "closed.py")
FNS = [f"f{i}" for i in range(8)]
ARCH = {f: "a" for f in FNS}


def test_open_schedule_repeats_for_a_schedule_seed_and_differs_across():
    mix = {"rate_per_s": 3.0, "zipf_s": 1.5, "schedule_seed": 2 ** 31 + 11}
    a = OPEN.schedule(mix, FNS, ARCH, 5.0, 40.0)
    assert a == OPEN.schedule(mix, FNS, ARCH, 5.0, 40.0)
    assert a != OPEN.schedule(dict(mix, schedule_seed=12), FNS, ARCH, 5.0,
                              40.0)


@pytest.mark.parametrize("rate", [0.5, 3.0, 7.25])
def test_open_schedule_offers_its_rate_in_warmup_and_window(rate):
    mix = {"rate_per_s": rate, "schedule_seed": 7}
    s = OPEN.schedule(mix, FNS, ARCH, 4.0, 40.0)
    win = [t for t, _ in s if 0 <= t < 40.0]
    warm = [t for t, _ in s if t < 0]
    assert len(win) == round(rate * 40.0)
    assert len(warm) == round(rate * 4.0)
    assert all(-4.0 <= t < 40.0 for t, _ in s)
    assert [t for t, _ in s] == sorted(t for t, _ in s)


def test_every_schedule_seed_offers_the_same_gaps_and_counts():
    mix = {"rate_per_s": 3.0, "zipf_s": 1.5}
    runs = [OPEN.schedule(dict(mix, schedule_seed=seed), FNS, ARCH, 0.0,
                          40.0) for seed in (1, 2, 3)]
    gaps = [Counter(round(b[0] - a[0], 9) for a, b in zip(s, s[1:]))
            for s in runs]
    # the seed orders one multiset of gaps: only the unseen last differs
    assert sum((gaps[0] & gaps[1]).values()) >= len(runs[0]) - 2
    counts = [sorted(f for _, f in s) for s in runs]
    assert counts[0] == counts[1] == counts[2]


def test_zipf_shares_follow_rank():
    sh = shares({"zipf_s": 1.5}, FNS, ARCH)
    w = [1 / (i + 1) ** 1.5 for i in range(8)]
    for i, f in enumerate(FNS):
        assert sh[f] == pytest.approx(w[i] / sum(w))
    # about a fifth of the invocations go beyond the three largest
    assert sum(sh[f] for f in FNS[3:]) == pytest.approx(0.197, abs=0.002)
    names = deal(sh, 1000)
    for f in FNS:
        assert abs(names.count(f) - 1000 * sh[f]) < 1


def test_arch_shares_split_evenly_within_an_arch():
    fns = ["llava", "q0", "q1", "q2"]
    arch = {"llava": "big", "q0": "small", "q1": "small", "q2": "small"}
    sh = shares({"arch_shares": {"big": 0.15, "small": 0.85}}, fns, arch)
    assert sh["llava"] == pytest.approx(0.15)
    assert sh["q0"] == sh["q1"] == sh["q2"] == pytest.approx(0.85 / 3)
    assert sorted(deal(sh, 60)).count("llava") == 9


class FakeCtx:
    """A clock that jumps to each wait's end, and invocations that
    complete 0.5 s after they are sent."""
    warm_s, seconds = 1.0, 10.0

    def __init__(self):
        self.t, self.sent, self.pending = -1.0, [], []

    def now(self):
        return self.t

    def wait_until(self, t):
        self.t = max(self.t, t)

    def submit(self, fn, due):
        self.sent.append((due, fn))
        self.pending.append(due + 0.5)

    def next_completion(self, until):
        self.pending.sort()
        if not self.pending or self.pending[0] >= until:
            self.t = until
            return None
        self.t = self.pending.pop(0)
        return object()


def test_open_drive_sends_each_at_its_due_time_whatever_the_run_seed():
    mix = {"rate_per_s": 2.0, "schedule_seed": 3}
    sent = []
    for seed in (5, 2 ** 33):
        ctx = FakeCtx()
        OPEN.drive(ctx, mix, FNS, ARCH, seed)
        sent.append(ctx.sent)
    assert sent[0] == sent[1] == OPEN.schedule(mix, FNS, ARCH, 1.0, 10.0)


def test_closed_drive_keeps_its_clients_busy_until_the_window_closes():
    ctx = FakeCtx()
    mix = {"clients": 4, "deck": 20, "arch_shares": {"a": 1.0},
           "schedule_seed": 1}
    CLOSED.drive(ctx, mix, FNS, ARCH, 9)
    # 4 clients, 0.5 s each, from -1 s to 10 s: 22 rounds of 4
    assert len(ctx.sent) == 4 * 22
    assert max(t for t, _ in ctx.sent) < 10.0
    assert {f for _, f in ctx.sent} <= set(FNS)

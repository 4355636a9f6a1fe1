"""A whole run of a tiny cell on the CPU, past the look for a card: sound,
it comes out correct; with the timed path broken underneath, or the
reference in fp8 in the program's place (the control), it does not.

The tiny configuration's limit, 0.06, sits between the program's widest
gap over 14 seeds (0.035) and the control's least (0.13) at these sizes.
"""
import pytest
import torch

from portbench.harness import check, loader
from portbench.harness.cell import run_cell, serve
from portbench.harness.fleet import Fleet
from portbench.harness.stats import Run
from portbench.reference import model as ref
from portbench.tests.tiny import make_root

SEED = 2 ** 31 + 77


@pytest.fixture(autouse=True)
def few_threads():
    """Tiny runs on two intra-op threads, so the server's threads and the
    other test workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def run(tmp_path, cell="tiny.open", seconds=1.5, capacity=10 ** 9):
    root = make_root(tmp_path, capacity)
    result, info = run_cell(loader.load_cell(cell, False, root), SEED,
                            seconds, "cpu", 0.0, root)
    return result, info


@pytest.mark.parametrize("cell", ["tiny.open", "tiny.closed"])
def test_a_sound_run_is_correct(tmp_path, cell):
    result, info = run(tmp_path, cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 5 and result["failed"] == 0
    assert set(result["metrics"]) >= {"setup_s"}
    assert list(result)[-1] == "checks"
    assert all(v["value"] <= v["limit"] for k, v in result["checks"].items()
               if k != "sampled")


def test_swapping_runs_are_correct_and_sample_an_upload(tmp_path):
    # room for one tiny function's weights: every switch uploads
    result, info = run(tmp_path, capacity=400_000)
    starts = info[1]["window"]["start_types"]
    assert starts.get("host_warm", 0) + starts.get("cold", 0) > 0
    assert result["correct"], result["checks"]


def plant(monkeypatch, fault):
    orig = Fleet._instrument

    def instrument(self, ep, fn):
        orig(self, ep, fn)
        fault(ep, fn)
    monkeypatch.setattr(Fleet, "_instrument", instrument)


def token_altered(ep, fn):
    """The second decode step puts its worst token first."""
    decode = ep.model.decode_fn

    def bad(params, cache, tokens, pos, ring=False):
        logits, cache = decode(params, cache, tokens, pos, ring=ring)
        return (-logits if pos == fn.seq + 1 else logits), cache
    ep.model.decode_fn = bad


def half_batch(ep, fn):
    """The prefill runs the first half of the batch and serves it twice."""
    prefill = ep.model.prefill_fn

    def bad(params, batch, **kw):
        h = batch["tokens"].shape[0] // 2
        return prefill(params, {k: torch.cat([v[:h], v[:h]])
                                for k, v in batch.items()}, **kw)
    ep.model.prefill_fn = bad


def state_unchanged(ep, fn):
    """The prefill hands decode the cache it started from (zeros)."""
    prefill = ep.model.prefill_fn

    def bad(params, batch, **kw):
        logits, cache = prefill(params, batch, **kw)
        return logits, {k: torch.zeros_like(v) for k, v in cache.items()}
    ep.model.prefill_fn = bad


def wrong_endpoint(ep, fn):
    """Every invocation also runs on the first function's endpoint."""
    run_ = ep.execute

    def bad(request=None):
        request.setdefault("ran_on", []).append("q0")
        return run_(request)
    ep.execute = bad


@pytest.mark.parametrize("fault,number", [
    (token_altered, "logit_gap"), (half_batch, "logit_gap"),
    (state_unchanged, "logit_gap"), (wrong_endpoint, "wrong_endpoint")])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault,
                                            number):
    plant(monkeypatch, fault)
    result, _ = run(tmp_path)
    assert not result["correct"]
    over = [k for k, v in result["checks"].items()
            if k != "sampled" and v["value"] > v["limit"]]
    assert any(k.startswith(number) for k in over), result["checks"]


def test_the_control_fails_where_the_program_passes(tmp_path):
    """The reference in fp8 read at the served positions of a sound run:
    its widest gap passes the limit that the program's stays under."""
    root = make_root(tmp_path)
    cell = loader.load_cell("tiny.open", False, root)
    fleet = Fleet(cell.config, SEED, "cpu")
    fleet.build()
    drive = serve(fleet, cell, SEED, 1.5)
    run_ = Run(1.5, fleet.fns, drive.records, [], 0.0)
    picks = check.sample(run_.window, fleet.fns, 4, SEED)
    prog, ctrl = check.model_gaps(picks, fleet.fns, "cpu", control=True)
    judged = {name: check.numbers(run_.window, fleet.fns, picks,
                                  cell.config, "cpu", gaps=gaps)
              for name, gaps in (("program", prog), ("control", ctrl))}
    assert check.correct(judged["program"]), judged
    assert not check.correct(judged["control"]), judged


def test_the_reference_follows_the_programs_clamped_decode(tmp_path,
                                                            monkeypatch):
    """``correct`` certifies the program's decode as it stands: its full
    cache is sized to the prompt, so every decoded key lands in the last
    slot (``reference.model.decode_keys``). A reference that decodes with
    every earlier key (plain causal decoding) fails a sound run. A change
    that sizes the program's cache to prompt + decode steps changes
    ``decode_keys`` with it, and this test with it."""
    root = make_root(tmp_path)
    cell = loader.load_cell("tiny.open", False, root)
    fleet = Fleet(cell.config, SEED, "cpu")
    fleet.build()
    run_ = Run(1.5, fleet.fns, serve(fleet, cell, SEED, 1.5).records, [],
               0.0)
    picks = [r for r in check.sample(run_.window, fleet.fns, 4, SEED)
             if ref.cache_of(fleet.fns[r.fn].arch, fleet.fns[r.fn].seq)[0]
             == "full"]
    assert picks
    clamped = check.numbers(run_.window, fleet.fns, picks, cell.config,
                            "cpu")
    assert check.correct(clamped), clamped
    monkeypatch.setattr(ref, "decode_keys",
                        lambda cache, S, p, window: list(range(p + 1)))
    causal = check.numbers(run_.window, fleet.fns, picks, cell.config,
                           "cpu")
    assert not check.correct(causal), causal

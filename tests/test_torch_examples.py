"""The port's examples (``repro_torch.examples``) against the reference's
(``examples/``), on the CPU: ``memory_policies``' table byte for byte,
``quickstart``'s simulated comparison line for line and its endpoint's
greedy tokens against ``JaxEndpoint``'s on the reference's weights,
``serve_trace.make_trace`` against the trace the reference's ``main``
builds, and ``serve_trace.run_policy`` over reduced endpoints under both
policies (every request completes, the same tokens in both arms, LRU
swapping at a capacity of the two largest endpoints).

The reference's examples are loaded from their files with ``importlib``;
none is edited.
"""
import contextlib
import importlib.util
import io
import re
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.examples import (memory_policies, quickstart,  # noqa: E402
                                  serve_trace)
from repro_torch.runtime.device import TorchEndpoint  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch" / "examples"


def _reference(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(fn, *args) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args)
    return out.getvalue()


def test_memory_policies_is_the_reference_with_its_imports_renamed():
    """The port's file is the reference's with ``repro.`` imports renamed
    and its ``Run:`` line naming the module."""
    ref = (ROOT / "examples" / "memory_policies.py").read_text()
    ref = re.sub(r"^from repro\.", "from repro_torch.", ref, flags=re.M)
    ref = ref.replace("Run:  PYTHONPATH=src python examples/memory_policies.py",
                      "Run:  PYTHONPATH=src python -m "
                      "repro_torch.examples.memory_policies")
    assert (PORT / "memory_policies.py").read_text() == ref


def test_memory_policies_prints_the_reference_table():
    """The four placement policies over 16 oversubscribing copies of fft:
    the port's printed table, asserts passed, is the reference's."""
    want = _printed(_reference("memory_policies").main)
    got = _printed(memory_policies.main)
    assert got == want
    assert "memory_policies: OK" in got


def test_quickstart_part1_prints_the_reference_lines():
    """MQFQ-Sticky against FCFS on the simulated zipf workload: the same
    lines (mean, p99, cold %, inter-function variance)."""
    want = _printed(_reference("quickstart").part1_policy_comparison)
    got = _printed(quickstart.part1_policy_comparison)
    assert got.splitlines() == want.splitlines()
    assert len(got.splitlines()) == 5


def test_quickstart_part2_tokens_match_jax_endpoint():
    """Part 2's lifecycle (compile, warm request, evict, upload, request)
    on a reduced qwen3-1.7b ``TorchEndpoint`` on the CPU, on the
    reference's weights and batches: the greedy tokens of seeds 1 and 2
    are ``JaxEndpoint``'s, and the second request found the weights
    uploaded again without a recompilation."""
    import jax

    from repro.configs import get_config as ref_config
    from repro.runtime.device import JaxEndpoint
    from repro_torch.bridge import params_from_jax
    jep = JaxEndpoint("qwen3-1.7b", ref_config("qwen3-1.7b").reduced())
    tep = TorchEndpoint("qwen3-1.7b", get_config("qwen3-1.7b").reduced(),
                        device="cpu")
    tep.host_params = params_from_jax(jep.host_params, device="cpu")

    def jax_batch(shape, generator, device):
        rb = jep.model.make_batch(
            shape, rng=jax.random.PRNGKey(generator.initial_seed()))
        return {k: torch.from_numpy(np.array(v)) for k, v in rb.items()}
    tep.model.make_batch = jax_batch
    jep.compile()
    out = {}
    text = _printed(lambda: out.update(quickstart.part2_real_endpoint(
        "cpu", tep)))
    assert "no recompilation" in text
    assert tep.uploads == 2 and tep.compiled and tep.resident
    for key, seed in (("warm", 1), ("host_warm", 2)):
        want = jep.execute({"seed": seed})["tokens"]
        got = out[key]["tokens"]
        assert got.shape == want.shape == (2, 4)
        assert np.array_equal(got, want), (seed, got, want)


class _StubEndpoint:
    weight_bytes = 1

    def compile(self):
        return 0.0

    def evict(self):
        pass


@pytest.mark.parametrize("argv", [[], ["--requests", "12", "--rps", "6"],
                                  ["--seed", "3"]])
def test_make_trace_is_the_reference_trace(monkeypatch, argv):
    """The reference's ``main`` with its endpoints and ``run_policy``
    replaced by stand-ins in the loaded module's namespace: the trace it
    hands both policies is ``make_trace``'s for the same arguments."""
    ref = _reference("serve_trace")
    seen = []
    monkeypatch.setattr(ref, "JaxEndpoint", lambda *a, **k: _StubEndpoint())
    monkeypatch.setattr(ref, "run_policy", lambda policy, eps, trace: (
        seen.append((policy, trace)) or {"completed": 0, "mean_s": 0.0,
                                         "max_s": 0.0, "starts": {}}))
    monkeypatch.setattr(sys, "argv", ["serve_trace.py"] + argv)
    _printed(ref.main)
    args = dict(zip(argv[::2], argv[1::2]))
    trace = serve_trace.make_trace(int(args.get("--requests", 30)),
                                   float(args.get("--rps", 4.0)),
                                   int(args.get("--seed", 0)))
    assert [p for p, _ in seen] == ["fcfs", "mqfq-sticky"]
    assert all(t == trace for _, t in seen)
    assert serve_trace.ARCHS == ref.ARCHS


RUN_ARCHS = ["qwen3-1.7b", "xlstm-350m", "hymba-1.5b"]


@pytest.fixture(scope="module")
def reduced_endpoints():
    eps = {a: TorchEndpoint(a, get_config(a).reduced(), seed=i, device="cpu")
           for i, a in enumerate(RUN_ARCHS)}
    for ep in eps.values():
        ep.compile()
        ep.evict()
    serve_trace.keep_tokens(eps)
    return eps


def test_run_policy_serves_both_arms_with_the_same_tokens(reduced_endpoints):
    """8 zipf requests over reduced qwen3, xlstm and hymba endpoints on
    the CPU, under fcfs then mqfq-sticky (d=2), at a capacity of the two
    largest endpoints' weights: every request completes in both arms,
    each arm swaps at least one endpoint out, and every request's greedy
    tokens are the same in both arms (the same (function, seed) gives
    the same tokens whatever the order of dispatch)."""
    eps = reduced_endpoints
    trace = serve_trace.make_trace(8, 8.0, 2, archs=RUN_ARCHS)
    assert {f for _, f, _ in trace} == set(RUN_ARCHS)
    two = sum(sorted(ep.weight_bytes for ep in eps.values())[-2:])
    tokens = {}
    for policy in ("fcfs", "mqfq-sticky"):
        for ep in eps.values():
            ep.evict()
        summary, res = serve_trace.run_policy(policy, eps, trace,
                                              capacity_bytes=two)
        assert summary["completed"] == len(res.invocations) == len(trace)
        assert not any(inv.failed or not inv.done
                       for inv in res.invocations)
        assert summary["evictions"] >= 1
        assert set(summary) >= {"completed", "mean_s", "max_s", "starts"}
        tokens[policy] = serve_trace.tokens_of(res)
        assert len(tokens[policy]) == len(trace)
    assert tokens["fcfs"].keys() == tokens["mqfq-sticky"].keys()
    for key, want in tokens["fcfs"].items():
        assert np.array_equal(tokens["mqfq-sticky"][key], want), key


def test_run_policy_default_capacity_is_the_reference_rule(
        reduced_endpoints, monkeypatch):
    """Without ``capacity_bytes`` the device holds three of the largest
    endpoint's weights, the reference's rule."""
    seen = {}
    real = serve_trace.make_server

    def spy(cfg, **kw):
        seen["cap"] = cfg.capacity_bytes
        return real(cfg, **kw)
    monkeypatch.setattr(serve_trace, "make_server", spy)
    eps = reduced_endpoints
    summary, _ = serve_trace.run_policy(
        "fcfs", eps, serve_trace.make_trace(2, 50.0, 0, archs=RUN_ARCHS))
    assert seen["cap"] == 3 * max(ep.weight_bytes for ep in eps.values())
    assert summary["completed"] == 2

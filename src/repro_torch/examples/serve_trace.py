"""End-to-end driver (port of ``examples/serve_trace.py``): serve a
heterogeneous mix of real model endpoints with the MQFQ-Sticky control
plane (wall-clock, real PyTorch execution).

Five reduced-config architectures (dense / MoE / SSM / hybrid / VLM) are
served as black-box "functions" behind the unified ``repro_torch.server``
control plane in wall-clock mode: a dedicated dispatcher thread, D-token
concurrency control, memory admission, warm-pool container accounting,
anticipatory prefetch of weights on queue activation and queue-state
driven LRU eviction of idle endpoints — the paper's architecture
(Fig. 2) end to end. The same open-loop trace runs under ``fcfs``, then
under ``mqfq-sticky``.

The parts are importable: ``make_trace`` (the reference's zipf trace),
``run_policy`` (one policy over the trace), ``keep_tokens`` /
``tokens_of`` (each request's greedy tokens, read off the run).

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_trace \\
          [--requests 30] [--device cpu]

Runs on ``cuda`` unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import random
import statistics
import time

from repro_torch.configs import get_config
from repro_torch.runtime.device import TorchEndpoint
from repro_torch.server import ServerConfig, make_server

# the order sets the zipf ranks of make_trace
ARCHS = ["qwen3-1.7b", "granite-moe-3b-a800m", "xlstm-350m",
         "hymba-1.5b", "llava-next-mistral-7b"]


def make_trace(requests: int, rps: float, seed: int, archs=ARCHS) -> list:
    """The reference's zipf-weighted open-loop trace: ``requests``
    arrivals (t, fn id, request seed) at a mean of ``rps`` a second, the
    i-th function of ``archs`` drawn with weight 1 / (i + 1)^1.5."""
    rng = random.Random(seed)
    weights = [1.0 / (i + 1) ** 1.5 for i in range(len(archs))]
    t, trace = 0.0, []
    for i in range(requests):
        t += rng.expovariate(rps)
        trace.append((t, rng.choices(archs, weights)[0], i))
    return trace


def run_policy(policy_name: str, endpoints, trace, capacity_bytes=None):
    """``trace`` open-loop through a wall-clock server over ``endpoints``
    under ``policy_name``, with ``d=2`` and a device capacity of
    ``capacity_bytes`` (default: three of the largest endpoint's weights,
    the reference's rule). Returns (the reference's summary plus
    ``evictions``, the regions the memory manager swapped out; the
    ``RunResult``)."""
    kw = dict(T=10.0, alpha=2.0) if "mqfq" in policy_name else {}
    # capacity for ~3 of the 5 endpoints resident at once (the old
    # engine's max_resident=3), so LRU swapping is actually exercised
    cap = capacity_bytes if capacity_bytes is not None else \
        3 * max(int(ep.weight_bytes) for ep in endpoints.values())
    cfg = ServerConfig(executor="wallclock", policy=policy_name,
                       policy_kwargs=kw, d=2, capacity_bytes=cap)
    server = make_server(cfg, endpoints=endpoints)
    evicted = []
    for dev in server.control.devices:
        dev.mem.evict_listeners.append(evicted.append)
    server.start()
    t0 = time.monotonic()
    for t_arr, fid, seed in trace:
        dt = t_arr - (time.monotonic() - t0)
        if dt > 0:
            time.sleep(dt)             # open-loop arrivals
        server.submit(fid, {"seed": seed})
    server.drain(timeout=600)
    res = server.stop()
    lats = [inv.latency for inv in res.invocations]
    return {"completed": len(lats),
            "mean_s": statistics.mean(lats) if lats else 0.0,
            "max_s": max(lats, default=0.0),
            "starts": res.start_type_counts(),
            "evictions": len(evicted)}, res


def keep_tokens(endpoints) -> None:
    """Make each endpoint's ``execute`` leave its greedy tokens in the
    request it was given, where ``tokens_of`` reads them after a run."""
    for ep in endpoints.values():
        def execute(request=None, _execute=ep.execute):
            out = _execute(request)
            if request is not None:
                request["tokens"] = out["tokens"]
            return out
        ep.execute = execute


def tokens_of(res) -> dict:
    """{(fn id, request seed): tokens} of a run over endpoints passed to
    ``keep_tokens``."""
    return {(inv.fn_id, inv.request["seed"]): inv.request["tokens"]
            for inv in res.invocations
            if inv.request is not None and "tokens" in inv.request}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=30)
    ap.add_argument("--rps", type=float, default=4.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' must be asked for")
    args = ap.parse_args(argv)

    print(f"building {len(ARCHS)} reduced endpoints "
          f"(dense/moe/ssm/hybrid/vlm) ...")
    endpoints = {a: TorchEndpoint(a, get_config(a).reduced(), seed=i,
                                  device=args.device)
                 for i, a in enumerate(ARCHS)}
    # pre-compile once so both policies face identical (host-warm) state —
    # cold-start *policy* effects are measured in benchmarks/, not here
    for a, ep in endpoints.items():
        s = ep.compile()
        ep.evict()
        print(f"  {a:24s} compiled in {s:5.2f}s "
              f"({ep.weight_bytes/1e6:.1f} MB)")

    # zipf-weighted open-loop trace shared across policies
    trace = make_trace(args.requests, args.rps, args.seed)

    for policy in ("fcfs", "mqfq-sticky"):
        print(f"\n--- policy={policy} ---")
        r, _ = run_policy(policy, endpoints, trace)
        print(f"  completed={r['completed']} mean={r['mean_s']:.3f}s "
              f"max={r['max_s']:.3f}s starts={r['starts']}")

    print("\nserve_trace: OK")


if __name__ == "__main__":
    main()

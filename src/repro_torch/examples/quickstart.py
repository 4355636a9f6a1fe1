"""Quickstart: MQFQ-Sticky in 60 seconds (port of ``examples/quickstart.py``).

1. Simulate the paper's core claim — MQFQ-Sticky vs FCFS on a Zipfian
   serverless workload (fair service + lower latency).
2. Run one real PyTorch endpoint (reduced qwen3-1.7b) through the
   scheduler's cold -> warm lifecycle, on ``cuda`` unless ``--device cpu``
   is given.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.server import ServerConfig, make_server
from repro_torch.workloads.traces import make_workload


def part1_policy_comparison() -> None:
    print("=" * 64)
    print("1. Scheduling: MQFQ-Sticky vs FCFS (Zipfian workload, sim)")
    print("=" * 64)
    fns, trace = make_workload("zipf", n_fns=12, duration=120.0,
                               total_rps=1.5, seed=0)
    for name in ("fcfs", "mqfq-sticky"):
        kw = dict(T=10.0, alpha=2.0) if name == "mqfq-sticky" else {}
        cfg = ServerConfig(policy=name, policy_kwargs=kw,
                           n_devices=1, d=2, pool_size=16)
        res = make_server(cfg, fns=fns).run_trace(trace)
        print(f"  {name:12s} mean={res.mean_latency():7.2f}s "
              f"p99={res.p99_latency():7.2f}s "
              f"cold%={res.pool.cold_hit_pct:5.1f} "
              f"inter-fn-var={res.inter_fn_variance():8.1f}")


def part2_real_endpoint(device="cuda", ep=None) -> dict:
    """The reference's steps on ``ep`` (default: a reduced qwen3-1.7b
    ``TorchEndpoint`` on ``device``): compile, a warm request (seed 1),
    evict, upload, a request (seed 2). Returns both requests' outputs."""
    print()
    print("=" * 64)
    print("2. Real PyTorch execution: one endpoint, cold -> warm lifecycle")
    print("=" * 64)
    from repro_torch.configs import get_config
    from repro_torch.runtime.device import TorchEndpoint

    if ep is None:
        ep = TorchEndpoint("qwen3-1.7b", get_config("qwen3-1.7b").reduced(),
                           device=device)
    print(f"  weights: {ep.weight_bytes / 1e6:.1f} MB host-resident")
    cold_s = ep.compile()                     # "container init" analogue
    print(f"  cold start (compile+upload): {cold_s:.2f}s")
    warm = ep.execute({"seed": 1})            # device-warm
    print(f"  warm exec: {warm['exec_s']:.3f}s "
          f"tokens={warm['tokens'][0].tolist()}")
    ep.evict()                                # host-warm (GPU-cold) state
    up_s = ep.upload()
    warm2 = ep.execute({"seed": 2})
    print(f"  host-warm restart: upload={up_s:.3f}s "
          f"exec={warm2['exec_s']:.3f}s  (no recompilation)")
    return {"warm": warm, "host_warm": warm2}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' must be asked for")
    args = ap.parse_args(argv)
    part1_policy_comparison()
    part2_real_endpoint(args.device)
    print("\nquickstart: OK")


if __name__ == "__main__":
    main()

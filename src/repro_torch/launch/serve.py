"""Serving launcher: run the port's MQFQ-Sticky control plane (port of
``repro.launch.serve``).

Two modes:
  --mode real  (the port's default): real PyTorch execution of
               reduced-config endpoints on the card (``--device cpu``
               must be asked for).
  --mode sim   : discrete-event simulation of a device pool with the
               paper's workloads, on the host (the reference's default).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --mode real \
      --archs qwen3-1.7b,xlstm-350m,hymba-1.5b --requests 20 \
      [--kv-quant] [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.serve --mode sim \
      --policy mqfq-sticky --workload azure --trace-id 4 --d 2

``--archs`` takes any arch of ``repro_torch.configs.ARCH_IDS``: the
reference's default set above, granite-moe-3b-a800m and qwen3-moe-30b-a3b
(MoE), llava-next-mistral-7b (VLM: each request's prompt is n_patches
random patch embeddings, then tokens), chatglm3-6b, qwen1.5-32b,
deepseek-coder-33b and whisper-large-v3 (encoder-decoder: each request
is encoder_len random frame embeddings, which the encoder reads, then
the decoder's prompt of tokens). ``--mode sim --workload endpoints``
serves the assigned archs as the cost model
(``repro_torch.workloads.costmodel``) prices them on an H100.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import random
import time


def run_sim_mode(args) -> dict:
    from repro_torch.server import ServerConfig, make_server
    from repro_torch.workloads.costmodel import endpoint_mix
    from repro_torch.workloads.traces import azure_trace, make_workload, zipf_trace

    if args.workload == "endpoints":
        fns = endpoint_mix(args.endpoint_shape)
        trace = zipf_trace(fns, args.duration, args.rps, seed=args.seed)
    else:
        fns, trace = make_workload(args.workload, n_fns=args.n_fns,
                                   duration=args.duration,
                                   total_rps=args.rps,
                                   trace_id=args.trace_id, seed=args.seed)
    kw = {}
    if args.policy in ("mqfq", "mqfq-sticky"):
        kw = dict(T=args.T, alpha=args.alpha)
    cfg = ServerConfig(policy=args.policy, policy_kwargs=kw,
                       n_devices=args.devices, d=args.d,
                       dynamic_d=args.dynamic_d, mem_policy=args.mem_policy,
                       pool_size=args.pool_size)
    res = make_server(cfg, fns=fns).run_trace(trace)
    out = {
        "policy": args.policy, "events": len(trace),
        "mean_latency_s": round(res.mean_latency(), 3),
        "p99_latency_s": round(res.p99_latency(), 3),
        "cold_pct": round(res.pool.cold_hit_pct, 2),
        "utilization": round(res.mean_utilization(), 3),
        "inter_fn_variance": round(res.inter_fn_variance(), 2),
    }
    print(json.dumps(out, indent=1))
    return out


def run_real_mode(args) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.runtime.device import TorchEndpoint
    from repro_torch.server import ServerConfig, make_server

    archs = args.archs.split(",")
    endpoints = {
        a: TorchEndpoint(
            a, dataclasses.replace(get_config(a).reduced(),
                                   kv_quant=args.kv_quant), seed=i,
            device=args.device)
        for i, a in enumerate(archs)}
    kw = dict(T=args.T, alpha=args.alpha) \
        if args.policy in ("mqfq", "mqfq-sticky") else {}
    # cap residency at roughly half the endpoints (the old engine's
    # max_resident default) so LRU swapping is actually exercised
    max_resident = max(2, len(endpoints) // 2)
    cap = max_resident * max(int(ep.weight_bytes)
                             for ep in endpoints.values())
    cfg = ServerConfig(executor="wallclock", policy=args.policy,
                       policy_kwargs=kw, d=args.d, capacity_bytes=cap)
    server = make_server(cfg, endpoints=endpoints)
    server.start()
    try:
        rng = random.Random(args.seed)
        for i in range(args.requests):
            server.submit(rng.choice(archs), {"seed": i})
            time.sleep(args.think_time)
        server.drain(timeout=600)
    finally:
        res = server.stop()
    lats = [inv.latency for inv in res.invocations]
    out = {
        "policy": args.policy, "device": str(endpoints[archs[0]].device),
        "completed": len(lats),
        "mean_latency_s": round(sum(lats) / max(len(lats), 1), 3),
        "max_latency_s": round(max(lats, default=0.0), 3),
        "start_types": res.start_type_counts(),
    }
    print(json.dumps(out, indent=1))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="real", choices=["sim", "real"])
    ap.add_argument("--policy", default="mqfq-sticky")
    ap.add_argument("--T", type=float, default=10.0)
    ap.add_argument("--alpha", type=float, default=2.0)
    ap.add_argument("--d", type=int, default=2)
    ap.add_argument("--dynamic-d", action="store_true")
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--mem-policy", default="prefetch_swap")
    ap.add_argument("--pool-size", type=int, default=32)
    ap.add_argument("--workload", default="azure",
                    choices=["azure", "zipf", "endpoints"])
    ap.add_argument("--endpoint-shape", default="decode_32k")
    ap.add_argument("--n-fns", type=int, default=24)
    ap.add_argument("--duration", type=float, default=300.0)
    ap.add_argument("--rps", type=float, default=1.0)
    ap.add_argument("--trace-id", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    # real mode
    ap.add_argument("--archs",
                    default="qwen3-1.7b,xlstm-350m,hymba-1.5b")
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--think-time", type=float, default=0.05)
    ap.add_argument("--kv-quant", action="store_true",
                    help="serve with int8 KV caches (§Perf H5)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of --mode real; 'cpu' must be "
                         "asked for (--mode sim runs on the host)")
    args = ap.parse_args(argv)
    if args.mode == "sim":
        return run_sim_mode(args)
    return run_real_mode(args)


if __name__ == "__main__":
    main()

"""Serving launcher: real PyTorch execution of reduced-config endpoints
behind the port's MQFQ-Sticky wall-clock control plane (port of
``repro.launch.serve --mode real``).

Example:
  PYTHONPATH=src python -m repro_torch.launch.serve --mode real \
      --archs qwen3-1.7b,xlstm-350m,hymba-1.5b --requests 20 \
      [--kv-quant] [--device cpu]

``--archs`` takes any arch of ``repro_torch.configs.ARCH_IDS``: the
reference's default set above, granite-moe-3b-a800m and qwen3-moe-30b-a3b
(MoE), llava-next-mistral-7b (VLM: each request's prompt is n_patches
random patch embeddings, then tokens), chatglm3-6b, qwen1.5-32b and
deepseek-coder-33b; whisper-large-v3 raises (ROADMAP.md item 9). The
simulator mode (``--mode sim``) is not ported yet (ROADMAP.md section 1,
item 14).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import random
import time


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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="real", choices=["sim", "real"])
    ap.add_argument("--policy", default="mqfq-sticky")
    ap.add_argument("--T", type=float, default=10.0)
    ap.add_argument("--alpha", type=float, default=2.0)
    ap.add_argument("--d", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--archs",
                    default="qwen3-1.7b,xlstm-350m,hymba-1.5b")
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--think-time", type=float, default=0.05)
    ap.add_argument("--kv-quant", action="store_true",
                    help="serve with int8 KV caches (§Perf H5)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' must be asked for")
    args = ap.parse_args(argv)
    if args.mode == "sim":
        raise SystemExit("--mode sim is not ported to repro_torch yet: "
                         "ROADMAP.md section 1, item 14")
    run_real_mode(args)


if __name__ == "__main__":
    main()

"""How full-width granite-moe-3b-a800m routes in bf16 with random weights,
and how far its bf16 prefill is from its float32 one, on one NVIDIA GPU.

    python3 scripts/moe_routing.py

The prefill of ``chip_smoke.py``'s model phase (B 4, S 1024, seed 0: the
same weights and tokens) runs through the kernels and through the plain
versions, with ``moe.moe_apply`` wrapped so that each layer's routing is
recorded. Prints the card's name and power limit, then one JSON line per
layer: the pairs over capacity (kernels' and plain), the largest count an
expert is sent, the capacity, the prompt tokens whose top-k experts differ
between the two paths, and the smallest gap between a token's k-th and
(k+1)-th router probability; then one JSON line of last-position logit
distances (max |difference| over max |logit|): kernels against plain with
the capacity bound and dropless, each bf16 path against the float32 plain
prefill, and float32 kernels against float32 plain (absolute). Needs CUDA
and nvcc; ~30 s after the build.
"""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    if not torch.cuda.is_available():
        print("moe_routing: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import build_model, decode_cache_plan, moe
    from repro_torch.models.common import tree_map
    from repro_torch.models.transformer import PLAIN_OPS

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.nvidia_smi_line(), flush=True)
    _build.build_all()
    dev = torch.device("cuda", 0)
    cfg = get_config("granite-moe-3b-a800m")
    B, S, k = cs.SERVE_BATCH, cs.SERVE_SEQ, cfg.top_k
    seen = []
    moe_apply = moe.moe_apply

    def recorded(c, p, x):
        T = x.shape[0] * x.shape[1]
        probs = torch.softmax(x.reshape(T, -1).float() @ p["router"], -1)
        top_p, top_i = torch.topk(probs, k + 1)
        counts = torch.bincount(top_i[:, :k].reshape(-1),
                                minlength=c.n_experts)
        C = moe.capacity(c, T)
        seen.append(dict(experts=top_i[:, :k].sort(-1).values,
                         over=int((counts - C).clamp(min=0).sum()),
                         most=int(counts.max()), C=C,
                         gap=float((top_p[:, k - 1] - top_p[:, k]).min())))
        return moe_apply(c, p, x)

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()
                     / b.float().abs().max())

    kern, plain = build_model(cfg), build_model(cfg, PLAIN_OPS)
    params = kern.init_params(torch.Generator(dev).manual_seed(0), dev)
    g = torch.Generator(dev).manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), device=dev,
                                     generator=g)}
    plan = decode_cache_plan(cfg, S)
    run = lambda m, p: m.prefill_fn(p, batch, plan.length, plan.ring)[0]
    moe.moe_apply = recorded
    try:
        with torch.inference_mode():
            lk = run(kern, params)
            rk, seen[:] = list(seen), []
            lp = run(plain, params)
            rp = list(seen)
    finally:
        moe.moe_apply = moe_apply
    for i, (a, b) in enumerate(zip(rk, rp)):
        print(json.dumps(dict(
            layer=i, over_capacity_kernels=a["over"],
            over_capacity_plain=b["over"], most_sent_to_one=a["most"],
            capacity=a["C"], tokens_routed_apart=int(
                (a["experts"] != b["experts"]).any(-1).sum()),
            min_topk_prob_gap=a["gap"])), flush=True)
    dropless = moe.DROPLESS_PAIRS
    moe.DROPLESS_PAIRS = B * S * k       # C = T * k: nothing dropped
    try:
        with torch.inference_mode():
            lk_all, lp_all = run(kern, params), run(plain, params)
    finally:
        moe.DROPLESS_PAIRS = dropless
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    del params
    with torch.inference_mode():
        tk = run(build_model(cfg32), p32)
        tp = run(build_model(cfg32, PLAIN_OPS), p32)
    print(json.dumps(dict(
        model="granite-moe-3b-a800m full width", B=B, S=S,
        kernels_vs_plain_bf16=rel(lk, lp),
        kernels_vs_plain_bf16_dropless=rel(lk_all, lp_all),
        plain_bf16_to_f32=rel(lp, tp), kernels_bf16_to_f32=rel(lk, tp),
        f32_kernels_vs_plain_abs=float((tk - tp).abs().max()))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Training launcher: train a reduced/custom config on synthetic data
(port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --steps 200 --seq 256 --batch 8 --d-model 512 --layers 8 \
        [--device cpu]

Runs on ``cuda`` unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import json


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--d-model", type=int, default=0,
                    help="override d_model (0 = reduced default)")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--vocab", type=int, default=0)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' must be asked for")
    args = ap.parse_args(argv)

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.training import AdamWConfig, DataConfig, Trainer, \
        batches
    from repro_torch.training.data import MarkovLM

    cfg = get_config(args.arch).reduced()
    over = {}
    if args.d_model:
        over.update(d_model=args.d_model,
                    head_dim=args.d_model // cfg.n_heads)
    if args.layers:
        over["n_layers"] = args.layers
    if args.vocab:
        over["vocab_size"] = args.vocab
    if over:
        cfg = dataclasses.replace(cfg, **over)

    model = build_model(cfg)
    print(f"arch={args.arch} params~{cfg.n_params()/1e6:.1f}M "
          f"(L={cfg.n_layers} d={cfg.d_model} V={cfg.vocab_size})")

    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                    batch_size=args.batch, seed=args.seed)
    print(f"data entropy floor: {MarkovLM(dc).entropy_floor():.3f} nats")

    extra = {}
    if cfg.family == "vlm":
        P = cfg.n_patches
        extra["patch_embeds"] = lambda: np.random.default_rng(0).normal(
            0, 0.02, (args.batch, P, cfg.d_model)).astype("float32")
    if cfg.family == "audio":
        extra["frames"] = lambda: np.random.default_rng(0).normal(
            0, 0.02, (args.batch, cfg.encoder_len, cfg.d_model)
        ).astype("float32")

    tr = Trainer(model,
                 AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 5),
                             total_steps=args.steps),
                 ckpt_path=args.ckpt or None, device=args.device)
    tr.init(seed=args.seed)
    last = tr.fit(batches(dc, extra=extra), steps=args.steps)
    print(json.dumps({k: round(v, 4) if isinstance(v, float) else v
                      for k, v in last.items()}))
    return last


if __name__ == "__main__":
    main()

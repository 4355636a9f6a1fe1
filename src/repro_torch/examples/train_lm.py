"""Train a language model end to end on synthetic data (port of
``examples/train_lm.py``).

Full substrate run: model definition -> AdamW -> Markov-chain LM data
pipeline (a learnable synthetic distribution with a known entropy floor)
-> checkpointing. Loss must drop from ~ln(V) toward the floor.

Presets:
  small (default) ~6M params, 200 steps.
  100m            ~100M params, 300 steps.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm \
          [--preset 100m] [--steps N] [--device cpu]

Runs on ``cuda`` unless ``--device cpu`` is given. The checkpoint goes to
``--ckpt`` (default: none).
"""
from __future__ import annotations

import argparse
import dataclasses
import math

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.training import AdamWConfig, DataConfig, Trainer, batches
from repro_torch.training.data import MarkovLM

PRESETS = {
    # overrides applied to the reduced qwen3-1.7b (dense GQA) config
    "small": dict(n_layers=4, d_model=256, n_heads=4, n_kv_heads=2,
                  head_dim=64, d_ff=1024, vocab_size=512),
    "100m": dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
                 head_dim=64, d_ff=3072, vocab_size=32768),
}
STEPS = {"small": 200, "100m": 300}
BATCH = {"small": 16, "100m": 8}
SEQ = {"small": 128, "100m": 512}
LR = {"small": 3e-3, "100m": 1e-3}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="small", choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' must be asked for")
    args = ap.parse_args(argv)

    steps = args.steps or STEPS[args.preset]
    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                              **PRESETS[args.preset])
    model = build_model(cfg)
    print(f"preset={args.preset}: {cfg.n_params()/1e6:.1f}M params "
          f"(L={cfg.n_layers} d={cfg.d_model} V={cfg.vocab_size}), "
          f"{steps} steps")

    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ[args.preset],
                    batch_size=BATCH[args.preset], seed=args.seed)
    floor = MarkovLM(dc).entropy_floor()
    print(f"uniform loss=ln(V)={math.log(cfg.vocab_size):.3f} nats, "
          f"data entropy floor={floor:.3f} nats")

    tr = Trainer(model,
                 AdamWConfig(lr=LR[args.preset],
                             warmup_steps=max(steps // 10, 5),
                             total_steps=steps),
                 ckpt_path=args.ckpt or None, log_every=max(steps // 10, 1),
                 device=args.device)
    tr.init(seed=args.seed)
    last = tr.fit(batches(dc), steps=steps)

    final = float(last["loss"])
    print(f"\nfinal loss {final:.3f} nats "
          f"(floor {floor:.3f}, started near {math.log(cfg.vocab_size):.3f})")
    if not final < 0.6 * math.log(cfg.vocab_size):
        raise AssertionError(f"training did not learn: final loss {final}")
    print("train_lm: OK")
    return dict(last, floor=floor, ln_v=math.log(cfg.vocab_size))


if __name__ == "__main__":
    main()

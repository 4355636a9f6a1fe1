"""A benchmark of tiny sizes for the CPU tests: a checkout root in a
temporary folder holding the benchmark's generators and metric readers,
with a tiny configuration, mixes and BENCHMARK.json of its own."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

from portbench.harness import loader

QWEN = {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
        "num_key_value_heads": 2, "head_dim": 16, "intermediate_size": 128,
        "vocab_size": 256, "rope_theta": 1000000.0, "rms_norm_eps": 1e-06,
        "qk_norm": True, "sliding_window": None,
        "tie_word_embeddings": False, "logit_gap_limit": 0.06}
LLAVA = {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
         "num_key_value_heads": 2, "head_dim": 16, "intermediate_size": 128,
         "vocab_size": 128, "rope_theta": 10000.0, "rms_norm_eps": 1e-06,
         "sliding_window": 16, "tie_word_embeddings": False,
         "n_patches": 8, "logit_gap_limit": 0.06}
CONFIG = {
    "name": "tiny",
    "archs": {"qwen3-1.7b": QWEN, "llava-next-mistral-7b": LLAVA},
    "functions": [
        {"name": "q0", "arch": "qwen3-1.7b", "seed_offset": 0,
         "serve_batch": 2, "serve_seq": 32, "decode_steps": 4},
        {"name": "q1", "arch": "qwen3-1.7b", "seed_offset": 1,
         "serve_batch": 2, "serve_seq": 32, "decode_steps": 4},
        {"name": "lv", "arch": "llava-next-mistral-7b", "seed_offset": 2,
         "serve_batch": 2, "serve_seq": 24, "decode_steps": 4}],
    "server": {"policy": "mqfq-sticky",
               "policy_kwargs": {"T": 10.0, "alpha": 2.0}, "d": 2,
               "capacity_bytes": 10 ** 9},
    "check": {"sample": 4}}
MIXES = {
    "open": {"kind": "open", "rate_per_s": 8.0, "zipf_s": 1.5,
             "warm_s": 0.5, "schedule_seed": 1},
    "closed": {"kind": "closed", "clients": 3, "deck": 20,
               "arch_shares": {"qwen3-1.7b": 0.7,
                               "llava-next-mistral-7b": 0.3},
               "warm_s": 0.5, "schedule_seed": 2}}


def make_root(tmp: Path, capacity: int = 10 ** 9) -> Path:
    """A checkout root at ``tmp`` with cells ``tiny.open`` and
    ``tiny.closed``."""
    bench = tmp / loader.BENCH_DIR.name
    for sub in ("generators", "metrics"):
        shutil.copytree(loader.BENCH_DIR / sub, bench / sub)
    (bench / "configs").mkdir()
    (bench / "traffic").mkdir()
    config = dict(CONFIG, server=dict(CONFIG["server"],
                                      capacity_bytes=capacity))
    (bench / "configs" / "tiny.json").write_text(json.dumps(config))
    for name, mix in MIXES.items():
        (bench / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    real = loader.read_json(loader.ROOT / "BENCHMARK.json")
    cells = [{"name": f"tiny.{m}", "config": "tiny", "traffic": m,
              "chips": 1, "why": "tiny"} for m in MIXES]
    names = [c["name"] for c in cells]
    e2e = [dict(m, workloads=names) if "workloads" in m else m
           for m in real["end_to_end"]]
    per = [dict(m, workloads=names) for m in real["per_layer"]]
    (tmp / "BENCHMARK.json").write_text(json.dumps(dict(
        real, configs=[{"name": "tiny", "source": "none",
                        "file": f"{bench.name}/configs/tiny.json",
                        "reduced": [], "why": "tiny"}],
        workloads=cells, end_to_end=e2e, per_layer=per)))
    return tmp

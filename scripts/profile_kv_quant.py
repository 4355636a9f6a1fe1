"""Profile one warm request of a full-width qwen3-1.7b endpoint with the
int8 KV cache (``kv_quant``) on one NVIDIA GPU, as ``chip_smoke.py``'s
"profile" phase does for ``qwen-q8-0``, through the port of the checkout
at ``--root`` (default: this one).

    python3 scripts/profile_kv_quant.py [--root DIR]

Prints the card's name and power limit and one JSON line: the request's
device busy time, idle share and top kernels (``chip_smoke.
profile_request``) and the K3 wrapper calls per request. Run on two
checkouts in one call (a parent unpacked into an ignored directory, and
this one), it gives the request-level effect of a change to K3. Needs
CUDA and nvcc.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="checkout whose src/repro_torch serves the request")
    root = ap.parse_args().root.resolve()
    if not torch.cuda.is_available():
        print("profile_kv_quant: needs a CUDA card", file=sys.stderr)
        return 1
    if not (root / "src" / "repro_torch").is_dir():
        print(f"profile_kv_quant: no src/repro_torch under {root}",
              file=sys.stderr)
        return 1
    sys.path[:0] = [str(root / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.runtime.device import TorchEndpoint

    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(get_config("qwen3-1.7b"), kv_quant=True)
    ep = cs.endpoints(TorchEndpoint, cfg, "qwen-q8", dev, [3])["qwen-q8-0"]
    ep.compile()                   # build, upload, one warm-up step
    dec.decode_attention_quant.launches = 0
    prof = cs.profile_request(ep)  # one unprofiled, one profiled request
    print(json.dumps(dict(root=str(root), endpoint="qwen-q8-0",
                          k3_calls_per_request=(
                              dec.decode_attention_quant.launches // 2),
                          nvidia_smi=smi, **prof)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

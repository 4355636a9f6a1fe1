"""Host µs a K2 / K3 wrapper call takes (``decode_attention``,
``decode_attention_quant``), through the port of the checkout at
``--root`` (default: this one), on one NVIDIA GPU.

    python3 scripts/decode_host_us.py [--root DIR]

The card is held in a spin kernel while the host queues ``n`` calls, so
the loop runs at the host's pace whatever the kernel's device time; the
shapes are those of ``chip_smoke.py``'s kernel phase (qwen3-1.7b,
chatglm3-6b's G 16, hymba-1.5b's ring). Where the checkout's wrapper has
``launch_plan`` (the Hopper kernel's), it also times the parts of a call:
the plan, the C entry alone (kernel codes "sm90" and "cluster" on the same
bf16 inputs; the Hopper kernel's entry first encodes two tensor maps) and
one ``cuTensorMapEncodeTiled`` of the driver, called through ctypes (its
12 arguments' conversion included). Each figure is [median, least] µs
over 9 rounds. Prints the card's name and power limit and one JSON
line. Run on two checkouts in one call (a parent unpacked into an
ignored directory, and this one) for a before / after. Needs CUDA and
nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
# (name, B, S, H, KV, dh, window, ring, pos)
SHAPES = [("qwen3-1.7b", 4, 1024, 16, 8, 128, 0, False, 1039),
          ("chatglm3-6b", 4, 1024, 32, 2, 128, 0, False, 1039),
          ("hymba-1.5b", 4, 1024, 25, 5, 64, 1024, True, 1039)]
SPIN_CYCLES = 2_000_000_000       # ~1 s at the H100's clock


def per_call_us(fn, n=400, rounds=9):
    """Host µs per call of ``fn()``, n calls queued behind a spin kernel
    (the device never drains the queue): [median, least] over
    ``rounds``. The host is shared, so the least is the steadier figure."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    got = []
    for _ in range(rounds):
        torch.cuda._sleep(SPIN_CYCLES // 4)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        got.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    got.sort()
    return [got[rounds // 2], got[0]]


def encode_us(ck, n=2000):
    """µs of one cuTensorMapEncodeTiled over ``ck`` (B, S, KV, dh) bf16,
    as the Hopper kernel's C entry encodes it (4-D, boxes of 128 bytes x 1
    head x 32 slots x 1 row, 128-byte swizzle), called from Python."""
    cuda = ctypes.CDLL("libcuda.so.1")
    enc = cuda.cuTensorMapEncodeTiled
    enc.restype = ctypes.c_int
    B, S, KV, dh = ck.shape
    dims = (ctypes.c_uint64 * 4)(dh, KV, S, B)
    strides = (ctypes.c_uint64 * 3)(dh * 2, KV * dh * 2, S * KV * dh * 2)
    box = (ctypes.c_uint32 * 4)(64, 1, 32, 1)
    unit = (ctypes.c_uint32 * 4)(1, 1, 1, 1)
    buf = ctypes.create_string_buffer(128 + 64)
    at = (ctypes.addressof(buf) + 63) // 64 * 64
    # CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 9, interleave none 0, swizzle 128B
    # 3, L2 promotion 256B 3, no OOB fill 0
    args = (ctypes.c_void_p(at), 9, 4, ctypes.c_void_p(ck.data_ptr()), dims,
            strides, box, unit, 0, 3, 3, 0)
    err = enc(*args)
    if err:
        return {"error": err}
    got = []
    for _ in range(9):
        t0 = time.perf_counter()
        for _ in range(n):
            enc(*args)
        got.append((time.perf_counter() - t0) / n * 1e6)
    got.sort()
    return [got[4], got[0]]


def parts(dec, _build, q, ck, cv, pos, window, ring):
    """The plan's and the C entry's µs of one K2 call, by kernel code."""
    B, _, H, dh = q.shape
    S, KV = ck.shape[1], ck.shape[2]
    out = {"launch_plan": per_call_us(lambda: dec.launch_plan(
        q.dtype, ck.dtype, B, S, H, KV, dh, q.device))}
    fn = _build.entry("decode_attention", "decode_attention_group_fwd", 4, 15)
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    for kernel in ("sm90", "cluster"):
        if kernel == "sm90":
            p = dec.launch_plan(q.dtype, ck.dtype, B, S, H, KV, dh, q.device)
            n, chunk, stages = p["n_ctas"], p["chunk"], p["stages"]
            g = H // KV
        else:
            (n, chunk), stages = dec.cluster_plan(B, S, KV, 132), 0
            g = min(H // KV, dec.MAX_GROUP)
            if (H // KV) % g:
                continue
        args = (q.data_ptr(), ck.data_ptr(), cv.data_ptr(), o.data_ptr(),
                dec.KERNELS[kernel], 1, B, S, KV * g, KV, H // KV, 0, dh, pos,
                window, int(ring), n, chunk, stages, dh ** -0.5, stream)
        _build.check(fn(*args), "decode_attention_group_fwd")
        out[f"c_entry_{kernel}"] = per_call_us(lambda: fn(*args))
    out["encode_tiled"] = encode_us(ck)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="checkout whose src/repro_torch runs the wrappers")
    root = ap.parse_args().root.resolve()
    if not torch.cuda.is_available():
        print("decode_host_us: needs a CUDA card", file=sys.stderr)
        return 1
    if not (root / "src" / "repro_torch").is_dir():
        print(f"decode_host_us: no src/repro_torch under {root}",
              file=sys.stderr)
        return 1
    sys.path[:0] = [str(root / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.models import attention as attn

    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    g = torch.Generator("cuda").manual_seed(3)
    res = {}
    for name, B, S, H, KV, dh, window, ring, pos in SHAPES:
        r = lambda *s: torch.randn(*s, generator=g, device="cuda",
                                   dtype=torch.bfloat16)
        q, ck, cv = r(B, 1, H, dh), r(B, S, KV, dh), r(B, S, KV, dh)
        k8, ks = attn.quantize_kv(ck)
        v8, vs = attn.quantize_kv(cv)
        kw = dict(window=window, ring=ring)
        row = {"K2": per_call_us(
                   lambda: dec.decode_attention(q, ck, cv, pos, **kw)),
               "K3": per_call_us(lambda: dec.decode_attention_quant(
                   q, k8, ks, v8, vs, pos, **kw))}
        if hasattr(dec, "launch_plan"):
            row["K2_parts"] = parts(dec, _build, q, ck, cv, pos, window,
                                    ring)
        res[name] = row
    print(json.dumps(dict(root=str(root), host_us_per_call=res,
                          nvidia_smi=smi)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

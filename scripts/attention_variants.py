"""Time K1 (flash attention) and K2 (decode attention) of the PyTorch/CUDA
port against variants of their own sources, on one NVIDIA GPU.

    python3 scripts/attention_variants.py

Each variant is the committed source (``src/repro_torch/csrc``) with one
textual change, built by nvcc beside it into ``build/variants`` and timed
on the same inputs in the same process as the committed kernel and as
``scaled_dot_product_attention``, at the serving shapes of qwen3-1.7b and
hymba-1.5b (``chip_smoke.py``'s kernel phase). It shows what each design
choice is worth; it also times empty kernel launches (plain, and in a
cluster of 8 CTAs), the floor under any one-launch kernel. Prints one JSON
line per shape and the card's name and power limit. Needs CUDA and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fl  # noqa: E402

OUT = ROOT / "build" / "variants"
TILE = """  static constexpr int NW = 4;
  static constexpr int MT = DH == 64 || DH == 128 ? 2 : 1;
  static constexpr int BK = DH >= 128 ? 32 : 64;"""
K1_VARIANTS = {
    # 64-key blocks at dh 128 (MT x 16 x 64 scores: the accumulators spill)
    "bk64": [(TILE, TILE.replace("DH >= 128 ? 32 : 64",
                                 "DH == 256 ? 32 : 64"))],
    # 16 query rows a warp: each K/V fragment feeds one mma, not two
    "rows16": [(TILE, TILE.replace("DH == 64 || DH == 128 ? 2 : 1", "1"))],
}
LAUNCH = "cfg.dynamicSmemBytes = smem_for(n_stages);"
TILE_PASS = "      pass.tile(kt, kt + TS * RB, mask, scale_log2, qsm, pw, lane);"
K2_VARIANTS = {
    # 8 KB more shared memory a CTA: 2 CTAs an SM at qwen's shapes, not 3
    "2_ctas_per_sm": [(LAUNCH, LAUNCH.replace(";", " + 8192;"))],
    # diagnostics (wrong results): without the tile pass, without loads
    "no_tile_pass": [(TILE_PASS, "      (void)kt;")],
    "no_loads": [("    if (mask == 0) return;  // no valid slot: nothing read",
                  "    return;")],
}
FLOOR = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
__global__ void empty(int* p) { if (p) p[threadIdx.x] = 0; }
__global__ void empty_cluster(int* p) {
  cooperative_groups::this_cluster().sync();
  if (p) p[threadIdx.x] = 0;
}
extern "C" int launch_empty(int gx, int gy, int smem, int cluster,
                            void* stream) {
  cudaFuncSetAttribute(empty, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  cudaFuncSetAttribute(empty_cluster,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(gx, gy);
  cfg.blockDim = dim3(128);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cluster > 1 ? cudaLaunchKernelEx(&cfg, empty_cluster, (int*)nullptr)
                     : cudaLaunchKernelEx(&cfg, empty, (int*)nullptr);
}
"""


def build(sources):
    """nvcc every {name: source text} in parallel; {name: CDLL}."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        src = OUT / f"{name}.cu"
        src.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(OUT / f"{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    return {name: ctypes.CDLL(str(OUT / f"{name}.so")) for name in sources}


def variants(path, table):
    text = (ROOT / path).read_text()
    out = {}
    for name, subs in table.items():
        t = text
        for old, new in subs:
            if old not in t:
                raise RuntimeError(f"{name}: source text not found: {old}")
            t = t.replace(old, new)
        out[name] = t
    return out


def stream():
    return torch.cuda.current_stream().cuda_stream


def flash_runner(lib):
    fn = lib.flash_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_void_p])

    def run(q, k, v, window):
        B, S, H, dh = q.shape
        o = torch.empty_like(q)
        _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr(), 1, B, S, S, H, k.shape[2], dh, 1,
                        window, dh ** -0.5, stream()), "flash variant")
        return o
    return run


def decode_runner(lib):
    fn = lib.decode_attention_group_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 13
                   + [ctypes.c_float, ctypes.c_void_p])

    def run(q, k, v, pos, window, ring):
        B, _, H, dh = q.shape
        S, KV = k.shape[1], k.shape[2]
        n, chunk = dec.cluster_plan(B, S, KV, dec._sm_count(q.device.index))
        o = torch.empty_like(q)
        _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr(), 1, B, S, H, KV, H // KV, 0, dh, pos,
                        window, int(ring), n, chunk, dh ** -0.5, stream()),
                     "decode variant")
        return o
    return run


def time_all(runs, sets, ref, library, lib_sets):
    """{name: [ms, max row-relative error]} in turns: library, every
    kernel, then every kernel and the library again in reverse."""
    out = {name: [] for name in runs}
    out["sdpa"] = [cs.device_ms(library, lib_sets)]
    for name, run in list(runs.items()) + list(runs.items())[::-1]:
        out[name].append(cs.device_ms(run, sets))
    out["sdpa"].append(cs.device_ms(library, lib_sets))
    for name, run in runs.items():
        out[name].append(cs.row_rel_err(run(*sets[0]), ref))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("attention_variants: needs a CUDA card", file=sys.stderr)
        return 1
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    libs = build({"k1": (ROOT / "src/repro_torch/csrc/flash_attention.cu")
                  .read_text(),
                  **{f"k1_{n}": t for n, t in variants(
                      "src/repro_torch/csrc/flash_attention.cu",
                      K1_VARIANTS).items()},
                  "k2": (ROOT / "src/repro_torch/csrc/decode_attention.cu")
                  .read_text(),
                  **{f"k2_{n}": t for n, t in variants(
                      "src/repro_torch/csrc/decode_attention.cu",
                      K2_VARIANTS).items()},
                  "floor": FLOOR})
    g = torch.Generator("cuda").manual_seed(1)
    bf = torch.bfloat16
    for model, H, KV, dh, window in [("qwen3-1.7b", 16, 8, 128, 0),
                                     ("hymba-1.5b", 25, 5, 64, 1024)]:
        B, S = cs.SERVE_BATCH, cs.SERVE_SEQ
        mk = lambda: tuple(torch.randn(B, S, n, dh, generator=g,
                                       device="cuda", dtype=bf)
                           for n in (H, KV, KV))
        sets = [mk() for _ in range(cs.n_sets(2 * cs.nbytes(*mk())))]
        ref = fl.flash_attention_plain(*sets[0], window=window)
        runs = {n: (lambda r: lambda q, k, v: r(q, k, v, window))(
            flash_runner(lib)) for n, lib in libs.items()
            if n.startswith("k1")}
        tsets = [tuple(t.transpose(1, 2).contiguous() for t in s)
                 for s in sets]
        res = time_all(runs, sets, ref, lambda q, k, v: F.
                       scaled_dot_product_attention(q, k, v, is_causal=True,
                                                    enable_gqa=True), tsets)
        print(json.dumps(dict(kernel="K1", model=model, B=B, S=S, H=H,
                              KV=KV, dh=dh, window=window,
                              ms_ms_err=res)), flush=True)

        pos, ring = S + cs.DECODE_STEPS - 1, window > 0
        r = lambda *s: torch.randn(*s, generator=g, device="cuda", dtype=bf)
        mk = lambda: (r(B, 1, H, dh), r(B, S, KV, dh), r(B, S, KV, dh))
        sets = [mk() for _ in range(cs.n_sets(cs.nbytes(*mk())))]
        ref = dec.decode_attention_plain(*sets[0], pos, window=window,
                                         ring=ring)
        runs = {n: (lambda r_: lambda q, k, v: r_(q, k, v, pos, window,
                                                   ring))(decode_runner(lib))
                for n, lib in libs.items() if n.startswith("k2")}
        tsets = [tuple(t.transpose(1, 2).contiguous() for t in s)
                 for s in sets]
        res = time_all(runs, sets, ref, lambda q, k, v: F.
                       scaled_dot_product_attention(q, k, v,
                                                    enable_gqa=True), tsets)
        print(json.dumps(dict(kernel="K2", model=model, B=B, S=S, H=H,
                              KV=KV, dh=dh, pos=pos, window=window,
                              ms_ms_err=res)), flush=True)

    fn = libs["floor"].launch_empty
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    for gx, gy, smem, cluster in [(8, 32, 0, 1), (8, 32, 74624, 1),
                                  (8, 32, 74624, 8), (8, 20, 48288, 8)]:
        ms = cs.device_ms(lambda: _build.check(
            fn(gx, gy, smem, cluster, stream()), "empty"), [()], iters=50)
        print(json.dumps(dict(kernel="empty", grid=[gx, gy], smem=smem,
                              cluster=cluster, ms=ms)), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

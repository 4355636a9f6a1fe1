"""Time K1 (flash attention), K2 (decode attention) and K3 (decode
attention over an int8 cache) of the PyTorch/CUDA port against variants
of their own sources, on one NVIDIA GPU.

    python3 scripts/attention_variants.py [--k1]

Each variant is the committed source (``src/repro_torch/csrc``) with one
textual change, built by nvcc beside it into ``build/variants`` and timed
on the same inputs in the same process as the committed kernel and (K1,
K2) as ``scaled_dot_product_attention``, at the serving shapes of
qwen3-1.7b and hymba-1.5b (``chip_smoke.py``'s kernel phase; K1 also at
llava-next-mistral-7b's S 4096 and whisper-large-v3's 1500 x 1500
encoder); K3 also at B 8 (B*KV = 64 rows) under K2's launch plan beside
its own. K2 and K3 are one source, so K2's variants are K3's too. K1's
variants are of its Hopper kernel (bf16 at dh 64 and 128), among them
diagnostics that drop its softmax, its products or its loads; the
committed K1 is also traced once by torch.profiler at each shape. It shows
what each design choice is worth; it also times empty kernel launches
(plain, and in a cluster of 8 CTAs), the floor under any one-launch
kernel. Prints the variants that spill, one JSON line per shape and the
card's name and power limit; ``--k1`` builds and times K1 alone. Needs
CUDA and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fl  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402

OUT = ROOT / "build" / "variants"
# K1's bf16 kernel at dh 64 and 128 (flash_fwd_bf16_sm90)
# the turns of the ping-pong, each made a no-op
NO_PINGPONG = [("named_bar_sync(1 + wg, 256);", "(void)0;"),
               ("named_bar_arrive(1 + (wg + 1) % NC, 256);", "(void)0;"),
               ("  if (wg == NC - 1) named_bar_arrive(1, 256);\n", "")]
CONSUMERS = "  static constexpr int CONSUMERS = DH == 64 ? 3 : 2;"
BK = "  static constexpr int BK = DH == 64 ? 112 : 128;"
STAGES = "  static constexpr int STAGES = DH == 64 ? 4 : 3;"
SOFTMAX = "    auto softmax = [&](int i) {\n"
SERIAL = """      for (int i = i_lo; i < i_hi; ++i) {
        acquire(i);
        fence_operands();
        issue_qk(i);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(sacc);
        softmax(i);
        rescale_and_pack();
        fence_operands();
        issue_pv(i);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(acc);
        release(i);
      }
"""
NO_SOFTMAX = (SOFTMAX, SOFTMAX + "      alpha[0] = alpha[1] = 1.f;\n"
              "      if (i >= 0) return;\n")
NO_LOADS = ("        mbar_expect_tx(full(s), 2 * TL::KV_BYTES);\n",
            "        mbar_arrive(full(s));\n        ++it;\n        continue;\n")
NO_PRODUCTS = [("        if constexpr (BK_ == 112)\n",
                "        if constexpr (BK_ < 0)\n"),
               ("        else\n          wgmma_ss_n128",
                "        else if constexpr (BK_ < 0)\n          wgmma_ss_n128"),
               ("        if constexpr (DH == 64)\n",
                "        if constexpr (DH < 0)\n"),
               ("        else\n          wgmma_rs_n128_tb",
                "        else if constexpr (DH < 0)\n"
                "          wgmma_rs_n128_tb")]
K1_VARIANTS = {
    # the consumers issue their products whenever they are ready
    "no_pingpong": NO_PINGPONG,
    # neither ping-pong nor Q K^T of block i beside P V of block i - 1:
    # each block's products and softmax one after the other
    "serial": NO_PINGPONG + [("PIPELINED", SERIAL)],
    # one query tile a CTA, a CTA for every tile
    "one_tile": [("<<<min(n_tiles, sms),", "<<<n_tiles,")],
    # a ring of 2 stages at both head dims
    "stages2": [(STAGES, "  static constexpr int STAGES = 2;")],
    # two consumer warpgroups (128 query rows) at dh 64 too
    "two_consumers": [(CONSUMERS, CONSUMERS.replace("DH == 64 ? 3 : 2",
                                                    "2"))],
    # 128-key blocks at dh 64 too (the consumers spill)
    "bk128": [(BK, "  static constexpr int BK = 128;")],
    # the register split at dh 64: the producer warpgroup keeps 24 or 40
    "p24": [("CONSUMERS == 3 ? 32 : 40", "CONSUMERS == 3 ? 24 : 40")],
    "p40": [("CONSUMERS == 3 ? 32 : 40", "CONSUMERS == 3 ? 40 : 40"),
            ("CONSUMERS == 3 ? 160 : 232", "CONSUMERS == 3 ? 152 : 232")],
    # diagnostics (wrong results): without the softmax (p = s), without
    # the products, without the loads (the producer only arrives)
    "no_softmax": [NO_SOFTMAX],
    "no_products": NO_PRODUCTS,
    "no_loads": [NO_LOADS],
    "products_only": [NO_SOFTMAX, NO_LOADS],
    "softmax_only": NO_PRODUCTS + [NO_LOADS],
    # the softmax with a saturating FMA in place of its exp2 (p in [0, 1]
    # as before, so the epilogue's divisions keep their fast path)
    "no_exp2": [("p = ex2(fmaf(sacc[4 * j + e], sc, neg_m[e / 2]));",
                 "p = __saturatef(fmaf(sacc[4 * j + e], sc, neg_m[e / 2])"
                 " + 1.f);")],
    # the epilogue multiplies by 1 / l in place of dividing by l
    "recip_epilogue": [("pack_bf16(acc[4 * j + 2 * r] / lr, "
                        "acc[4 * j + 2 * r + 1] / lr)",
                        "pack_bf16(acc[4 * j + 2 * r] * (1.f / lr), "
                        "acc[4 * j + 2 * r + 1] * (1.f / lr))")],
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
Q8_PV = """#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const unsigned char* r0 = vt + (16 * kk + 2 * t) * RB + 4 * g;
#pragma unroll
      for (int blk = 0; blk < DH / 32; ++blk) {
        const unsigned char* p = r0 + 32 * blk;
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(p) ^ I8_BIAS;
        const uint32_t w1 =
            *reinterpret_cast<const uint32_t*>(p + RB) ^ I8_BIAS;
        const uint32_t w8 =
            *reinterpret_cast<const uint32_t*>(p + 8 * RB) ^ I8_BIAS;
        const uint32_t w9 =
            *reinterpret_cast<const uint32_t*>(p + 9 * RB) ^ I8_BIAS;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16_upper(acc[4 * blk + j], pa[kk][0], pa[kk][1],
                         bf16x2_exact(i8_at(w0, j), i8_at(w1, j)),
                         bf16x2_exact(i8_at(w8, j), i8_at(w9, j)));
      }
    }
"""
# the V tile converted once into a bf16 tile behind the scales (K2's
# layout: dh >= 128 swizzled, else padded by 16 bytes), then P.V by
# ldmatrix as K2's MmaPass reads its own
Q8_PV_LDMATRIX = """    constexpr bool VSWZ = DH >= 128;
    constexpr int VRB = DH * 2 + (VSWZ ? 0 : 16);
    unsigned char* vb = const_cast<unsigned char*>(vt) + TS * RB +
                        2 * TS * (int)sizeof(float);
    auto vat = [](int r, int c) {
      return r * VRB + (VSWZ ? swz<DH / 8>(r, c) : c) * 16;
    };
    for (int c = lane; c < TS * (DH / 16); c += 32) {
      const int r = c / (DH / 16), cc = c % (DH / 16);
      const uint4 w = *reinterpret_cast<const uint4*>(vt + r * RB + cc * 16);
      const uint32_t ws[4] = {w.x ^ I8_BIAS, w.y ^ I8_BIAS, w.z ^ I8_BIAS,
                              w.w ^ I8_BIAS};
      uint32_t h[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        h[2 * i] = bf16x2_exact(i8_at(ws[i], 0), i8_at(ws[i], 1));
        h[2 * i + 1] = bf16x2_exact(i8_at(ws[i], 2), i8_at(ws[i], 3));
      }
      *reinterpret_cast<uint4*>(vb + vat(r, 2 * cc)) =
          make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(vb + vat(r, 2 * cc + 1)) =
          make_uint4(h[4], h[5], h[6], h[7]);
    }
    __syncwarp();
    const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int v_col = (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t bb[4];
        ldsm_x4_t(bb, smem_u32(vb + vat(kk * 16 + v_row, 2 * dp + v_col / 8)));
        mma_bf16_upper(acc[2 * dp], pa[kk][0], pa[kk][1], bb[0], bb[1]);
        mma_bf16_upper(acc[2 * dp + 1], pa[kk][0], pa[kk][1], bb[2], bb[3]);
      }
"""
K3_VARIANTS = {
    # P.V from a bf16 copy of the V tile, read by ldmatrix as K2 reads its
    # own, in place of fragments built from 32-bit loads of the int8 tile
    "v_ldmatrix": [
        ("      2 * TS * RB + (Q8 ? 2 * TS * (int)sizeof(float) : 0);",
         "      2 * TS * RB + (Q8 ? 2 * TS * (int)sizeof(float) : 0) +\n"
         "      (Q8 && MMA ? TS * (DH * 2 + (DH >= 128 ? 0 : 16)) : 0);"),
        (Q8_PV, Q8_PV_LDMATRIX),
        ("      const int d = 32 * (j / 4) + 8 * t + (j % 4);\n"
         "      wp[g * PS + d] = acc[j][0];\n"
         "      wp[g * PS + d + 4] = acc[j][1];",
         "      const int d = 8 * j + 2 * t;\n"
         "      wp[g * PS + d] = acc[j][0];\n"
         "      wp[g * PS + d + 1] = acc[j][1];")],
    # int8 rows unpadded: every fragment load meets bank conflicts
    "unpadded": [("RB = DH * (int)sizeof(C) + (SWZ ? 0 : 16);",
                  "RB = DH * (int)sizeof(C) + (SWZ || (Q8 && MMA) ? 0 : 16);")],
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
        (OUT / f"{name}.log").write_text(log)
    return {name: ctypes.CDLL(str(OUT / f"{name}.so")) for name in sources}


def spills(name):
    """{kernel: [registers, spilled bytes]} of a variant's build, for the
    kernels that spill."""
    log = (OUT / f"{name}.log").read_text()
    out = {}
    for part in log.split("Compiling entry function '")[1:]:
        used = re.search(r"Used (\d+) registers", part)
        spill = sum(int(n) for n in re.findall(r"(\d+) bytes spill", part))
        if spill:
            out[part.split("'", 1)[0]] = [int(used.group(1)), spill]
    return out


def pipelined_block(text):
    """The committed K1 consumer's pipelined products (from its first
    block's acquire to its last P V's release)."""
    a = text.index("      acquire(i_lo);\n      begin_turn();")
    end = "      release(i_hi - 1);\n"
    b = text.index(end, a) + len(end)
    return text[a:b]


def variants(path, table):
    text = (ROOT / path).read_text()
    out = {}
    for name, subs in table.items():
        t = text
        for old, new in subs:
            if old == "PIPELINED":
                old = pipelined_block(text)
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

    def run(q, k, v, causal, window):
        B, Sq, H, dh = q.shape
        o = torch.empty_like(q)
        _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr(), fl.KERNELS[fl.kernel_for(q.dtype, dh)],
                        B, Sq, k.shape[1], H, k.shape[2], dh, int(causal),
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


def quant_runner(lib, plan=dec.quant_plan):
    fn = lib.decode_attention_q8_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 13
                   + [ctypes.c_float, ctypes.c_void_p])

    def run(q, k8, ks, v8, vs, pos, window, ring):
        B, _, H, dh = q.shape
        S, KV = k8.shape[1], k8.shape[2]
        n, chunk = plan(B, S, KV, dec._sm_count(q.device.index))
        o = torch.empty_like(q)
        _build.check(fn(q.data_ptr(), k8.data_ptr(), ks.data_ptr(),
                        v8.data_ptr(), vs.data_ptr(), o.data_ptr(), 1, B, S,
                        H, KV, H // KV, 0, dh, pos, window, int(ring), n,
                        chunk, dh ** -0.5, stream()), "quant variant")
        return o
    return run


def time_all(runs, sets, ref, library=None, lib_sets=None):
    """{name: [ms, ms, max row-relative error]} in turns: library, every
    kernel, then every kernel and the library again in reverse."""
    out = {name: [] for name in runs}
    if library is not None:
        out["sdpa"] = [cs.device_ms(library, lib_sets)]
    for name, run in list(runs.items()) + list(runs.items())[::-1]:
        out[name].append(cs.device_ms(run, sets))
    if library is not None:
        out["sdpa"].append(cs.device_ms(library, lib_sets))
    for name, run in runs.items():
        out[name].append(cs.row_rel_err(run(*sets[0]), ref))
    return out


def quant_sets(g, B, S, H, KV, dh):
    """Input sets for K3 (q, int8 k, k scales, int8 v, v scales), more
    bytes in all than the L2 cache holds."""
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")

    def mk():
        k8, ks = attn.quantize_kv(r(B, S, KV, dh))
        v8, vs = attn.quantize_kv(r(B, S, KV, dh))
        return r(B, 1, H, dh).to(torch.bfloat16), k8, ks, v8, vs
    first = mk()
    return [first] + [mk() for _ in range(cs.n_sets(cs.nbytes(*first)) - 1)]


# K1's shapes: (model, B, Sq, Sk, H, KV, dh, causal, window), those of
# chip_smoke.py's kernel phase at each head dim and mask
K1_SHAPES = [
    ("qwen3-1.7b", cs.SERVE_BATCH, cs.SERVE_SEQ, cs.SERVE_SEQ, 16, 8, 128,
     True, 0),
    ("hymba-1.5b", cs.SERVE_BATCH, cs.SERVE_SEQ, cs.SERVE_SEQ, 25, 5, 64,
     True, 1024),
    ("llava-next-mistral-7b", cs.SERVE_BATCH, cs.LLAVA_SEQ, cs.LLAVA_SEQ, 32,
     8, 128, True, 0),
    ("whisper-large-v3", cs.SERVE_BATCH, 1500, 1500, 20, 20, 64, False, 0),
]


def time_k1(libs, g):
    for model, B, Sq, Sk, H, KV, dh, causal, window in K1_SHAPES:
        mk = lambda: tuple(torch.randn(B, S, n, dh, generator=g,
                                       device="cuda", dtype=torch.bfloat16)
                           for S, n in ((Sq, H), (Sk, KV), (Sk, KV)))
        sets = [mk() for _ in range(cs.n_sets(2 * cs.nbytes(*mk())))]
        ref = fl.flash_attention_plain(*sets[0], causal=causal,
                                       window=window)
        runs = {n: (lambda r: lambda q, k, v: r(q, k, v, causal, window))(
            flash_runner(lib)) for n, lib in libs.items()
            if n.startswith("k1")}
        tsets = [tuple(t.transpose(1, 2).contiguous() for t in s)
                 for s in sets]
        res = time_all(runs, sets, ref, lambda q, k, v: F.
                       scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                    enable_gqa=True), tsets)
        # the committed kernel's launch under torch.profiler: device µs
        # by kernel name; the card's clock and power while it repeats
        by_name, _ = cs.profiled(lambda: runs["k1"](*sets[0]))
        clocks = k1_clocks(runs["k1"], sets[0])
        print(json.dumps(dict(kernel="K1", model=model, B=B, Sq=Sq, Sk=Sk,
                              H=H, KV=KV, dh=dh, causal=causal,
                              window=window, ms_ms_err=res,
                              profile_us=by_name, clocks=clocks)),
              flush=True)


def k1_host_us(n=2000):
    """Host µs a K1 wrapper call takes at one query and one key (device
    work negligible, so the loop runs at the host's pace), by kernel: the
    mma.sync kernel at dh 32 launches as it is, the Hopper kernel at dh 64
    and 128 first encodes its three tensor maps."""
    out = {}
    for dh in (32, 64, 128):
        q = torch.randn(1, 1, 1, dh, device="cuda", dtype=torch.bfloat16)
        for _ in range(50):
            fl.flash_attention(q, q, q)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fl.flash_attention(q, q, q)
        torch.cuda.synchronize()
        out[f"{fl.kernel_for(q.dtype, dh)} dh {dh}"] = \
            (time.perf_counter() - t0) / n * 1e6
    return out


def k1_clocks(run, args, seconds=3.0):
    """The card's SM clock (MHz) and power draw (W), sampled by nvidia-smi
    every 100 ms while ``run(*args)`` repeats for ``seconds``: min,
    median, max of each."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            run(*args)
        torch.cuda.synchronize()
    smi.terminate()
    out, _ = smi.communicate(timeout=30)
    rows = [[float(x) for x in line.split(",")]
            for line in out.strip().splitlines()[2:-1]]
    stats = {}
    for i, key in enumerate(("sm_mhz", "power_w")):
        v = sorted(r[i] for r in rows)
        stats[key] = [v[0], v[len(v) // 2], v[-1]] if v else None
    return stats


def main() -> int:
    if not torch.cuda.is_available():
        print("attention_variants: needs a CUDA card", file=sys.stderr)
        return 1
    only_k1 = sys.argv[1:] == ["--k1"]
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    k1 = {"k1": (ROOT / "src/repro_torch/csrc/flash_attention.cu")
          .read_text(),
          **{f"k1_{n}": t for n, t in variants(
              "src/repro_torch/csrc/flash_attention.cu",
              K1_VARIANTS).items()}}
    libs = build(k1 if only_k1 else
                 {**k1,
                  "k2": (ROOT / "src/repro_torch/csrc/decode_attention.cu")
                  .read_text(),
                  **{f"k2_{n}": t for n, t in variants(
                      "src/repro_torch/csrc/decode_attention.cu",
                      K2_VARIANTS).items()},
                  **{f"k3_{n}": t for n, t in variants(
                      "src/repro_torch/csrc/decode_attention.cu",
                      K3_VARIANTS).items()},
                  "floor": FLOOR})
    print(json.dumps({"spilling": {n: spills(n) for n in libs
                                   if spills(n)}}), flush=True)
    g = torch.Generator("cuda").manual_seed(1)
    bf = torch.bfloat16
    time_k1(libs, g)
    print(json.dumps({"k1_host_us": k1_host_us()}), flush=True)
    if only_k1:
        print(smi, flush=True)
        return 0
    for model, H, KV, dh, window in [("qwen3-1.7b", 16, 8, 128, 0),
                                     ("hymba-1.5b", 25, 5, 64, 1024)]:
        B, S = cs.SERVE_BATCH, cs.SERVE_SEQ
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

        # K3: the committed kernel (lib "k2"), K2's variants and its own;
        # at B 8 also under K2's launch plan
        q8_libs = {n.replace("k2", "k3", 1): lib for n, lib in libs.items()
                   if n.startswith(("k2", "k3"))}
        for qB in (B, 8) if model == "qwen3-1.7b" else (B,):
            sets = quant_sets(g, qB, S, H, KV, dh)
            ref = dec.decode_attention_quant_plain(*sets[0], pos,
                                                   window=window, ring=ring)
            runs = {n: (lambda r_: lambda *a: r_(*a, pos, window, ring))(
                quant_runner(lib)) for n, lib in q8_libs.items()}
            if qB != B:
                runs = {"k3": runs["k3"], "k3_k2_plan": (
                    lambda r_: lambda *a: r_(*a, pos, window, ring))(
                        quant_runner(libs["k2"], dec.cluster_plan))}
            res = time_all(runs, sets, ref)
            print(json.dumps(dict(kernel="K3", model=model, B=qB, S=S, H=H,
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

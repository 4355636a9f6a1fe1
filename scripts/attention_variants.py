"""Time K1 (flash attention), K2 (decode attention) and K3 (decode
attention over an int8 cache) of the PyTorch/CUDA port against variants
of their own sources, on one NVIDIA GPU.

    python3 scripts/attention_variants.py [--k1 | --k23 | --sass]

Each variant is the committed source (``src/repro_torch/csrc``) with one
textual change, built by nvcc beside it into ``build/variants`` and timed
on the same inputs in the same process as the committed kernel, in turns.
K1's variants are of its Hopper kernel (bf16 at dh 64 and 128), among them
diagnostics that drop its softmax, its products or its loads, timed
against ``scaled_dot_product_attention`` at the serving shapes of
qwen3-1.7b, hymba-1.5b, llava-next-mistral-7b (S 4096) and
whisper-large-v3's encoder; the committed K1 is also traced once by
torch.profiler at each shape. K2 and K3 are one source: its Hopper kernel
(``decode_sm90``) is timed against its older ``decode_cluster`` (the same
library, through the C entry's kernel code) and SDPA at qwen3-1.7b's,
hymba-1.5b's, llava's 4096-slot ring and chatglm3-6b's decode shapes
(``chip_smoke.py``'s), with diagnostics that drop its loads, its tile
pass or its cluster merge, other cluster sizes, and a timeline variant
whose every CTA writes %globaltimer at its phases; K3 on both kernels at
qwen3-1.7b's. It also times empty launches (plain, and in clusters of 8
and 16 CTAs), the floor under any one-launch kernel. Prints the variants
that spill, one JSON line per shape and the card's name and power limit;
``--k1`` builds and times K1 alone, ``--k23`` K2 and K3 alone; ``--sass``
prints, for each ``decode_sm90`` instance of the committed library, its
static SASS instructions and those of its tile loop (``cuobjdump``).
Needs CUDA and nvcc.
"""
from __future__ import annotations

import ctypes
import functools
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
# K2/K3's Hopper kernel (decode_sm90), diagnostics (wrong results):
# without the cache loads (the producer arrives on each stage's barrier
# with no TMA), without the tile pass, without the cluster merge (no
# reduce-scatter through distributed shared memory, no rank merge, no
# store); K3's scale copies stay in all three
SM90_NO_LOADS = [("        mbar_expect_tx(full(st), 2 * SH::TILE);",
                  "        mbar_arrive(full(st));"),
                 ("        for (int x = 0; x < SH::ROW / SH::BOX_W; ++x) {",
                  "        for (int x = 0; x < 0; ++x) {")]
SM90_NO_PASS = [("    pass.tile(base + ly.q, kt, kt + SH::TILE, scales + st * 2 * TS,"
                 " mask,\n              scale_log2, lane);", "    (void)kt;")]
SM90_NO_MERGE = [
    ("    st_dsmem4(mapa(gat + 4 * (rank * share + i - dst * share), dst), a);",
     "    (void)dst;"),
    ("    st_dsmem2(mapa(gml + 8 * (rank * G + row), dst), M, L);",
     "    (void)dst;"),
    ("  const int i_end = min(G * DH, (rank + 1) * share);",
     "  const int i_end = 0;")]
# A timeline (wrong results): thread 0 of every CTA writes %globaltimer at
# its start (0), once q is in shared memory (1), when its first tile has
# landed (2), at the end of its pass (3), after the CTA merge (4), the
# first cluster barrier (5), the reduce-scatter's stores (6), the second
# cluster barrier (7) and its stores (8)
TL = ("if (threadIdx.x == 0) tl_[(blockIdx.y * gridDim.x + blockIdx.x) * 9 + "
      "{k}] = global_ns();")
SM90_TIMELINE = [
    ("  cluster_arrive_relaxed();\n  const int bkv",
     "  cluster_arrive_relaxed();\n  " + TL.format(k=0) + "\n  const int bkv"),
    ("    named_bar_sync(SM90_BAR, 32 * SM90_WARPS);\n  }\n\n  Pass pass;",
     "    named_bar_sync(SM90_BAR, 32 * SM90_WARPS);\n  }\n  " +
     TL.format(k=1) + "\n\n  Pass pass;"),
    ("    mbar_wait(full(st), (kk / n_stages) & 1);\n",
     "    mbar_wait(full(st), (kk / n_stages) & 1);\n    if (kk == 0) " +
     TL.format(k=2) + "\n"),
    ("  // the CTA's merge: each warp's",
     "  " + TL.format(k=3) + "\n  // the CTA's merge: each warp's"),
    ("  named_bar_sync(SM90_BAR, 32 * SM90_WARPS);\n\n  // the reduce-scatter",
     "  named_bar_sync(SM90_BAR, 32 * SM90_WARPS);\n  " + TL.format(k=4) +
     "\n\n  // the reduce-scatter"),
    ("  cluster_wait();\n  const int share = ly.share;",
     "  cluster_wait();\n  " + TL.format(k=5) +
     "\n  const int share = ly.share;"),
    ("  cluster_arrive();\n  cluster_wait();\n\n  // this rank's share",
     "  " + TL.format(k=6) + "\n  cluster_arrive();\n  cluster_wait();\n  " +
     TL.format(k=7) + "\n\n  // this rank's share"),
    ("                   pack_bf16(a.z * inv, a.w * inv));\n  }\n}\n",
     "                   pack_bf16(a.z * inv, a.w * inv));\n  }\n  " +
     TL.format(k=8) + "\n}\n"),
    ("namespace {\n\nusing namespace repro_sm90;",
     "namespace {\n\nusing namespace repro_sm90;\n"
     "__device__ unsigned long long tl_[65536 * 9];"),
    ("extern \"C\" long long decode_attention_device_launches(",
     "extern \"C\" int decode_timeline(void* dst, int n) {\n"
     "  return cudaMemcpyFromSymbol(dst, tl_, n * 9 * 8);\n}\n\n"
     "extern \"C\" long long decode_attention_device_launches(")]
K23_VARIANTS = {"no_loads": SM90_NO_LOADS, "no_pass": SM90_NO_PASS,
                "no_cluster_merge": SM90_NO_MERGE,
                "timeline": SM90_TIMELINE}
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
  cudaFuncSetAttribute(empty_cluster,
                       cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
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


def decode_runner(lib, kernel="sm90", plan=None):
    """K2 through a library's C entry on the kernel named (``ops.KERNELS``),
    under ``plan(B, S, KV, G, dh)`` -> (n_ctas, chunk, stages), by default
    the wrapper's; the same sub-groups as the wrapper."""
    fn = lib.decode_attention_group_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 15
                   + [ctypes.c_float, ctypes.c_void_p])
    code = dec.KERNELS[kernel]

    def run(q, k, v, pos, window, ring):
        B, _, H, dh = q.shape
        S, KV = k.shape[1], k.shape[2]
        G = H // KV
        g = G // dec.sub_groups(G, dec.SM90_MAX_GROUP if kernel == "sm90"
                                else dec.MAX_GROUP)
        if plan is not None:
            n, chunk, stages = plan(B, S, KV, g, dh)
        elif kernel == "sm90":
            n, chunk, stages = dec._sm90_plan_on(q.device.index, B, S, KV,
                                                 g, dh, 2)
        else:
            n, chunk = dec.cluster_plan(B, S, KV,
                                        dec._sm_count(q.device.index))
            stages = 0
        o = torch.empty_like(q)
        for q0 in range(0, G, g):
            _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            o.data_ptr(), code, 1, B, S, KV * g, KV, G, q0,
                            dh, pos, window, int(ring), n, chunk, stages,
                            dh ** -0.5, stream()), "decode variant")
        return o
    return run


def quant_runner(lib, kernel="sm90", plan=None):
    """K3 through a library's C entry on the kernel named, under
    ``plan(B, S, KV, G, dh)`` or the wrapper's plan for it."""
    fn = lib.decode_attention_q8_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 15
                   + [ctypes.c_float, ctypes.c_void_p])
    code = dec.KERNELS[kernel]

    def run(q, k8, ks, v8, vs, pos, window, ring):
        B, _, H, dh = q.shape
        S, KV = k8.shape[1], k8.shape[2]
        G = H // KV
        if kernel == "sm90":
            g = G // dec.sub_groups(G, dec.SM90_MAX_GROUP)
            n, chunk, stages = (plan or functools.partial(
                dec._sm90_plan_on, q.device.index))(B, S, KV, g, dh,
                                                    *(() if plan else (1,)))
        else:
            g = G // dec.sub_groups(G)
            n, chunk = dec.quant_plan(B, S, KV,
                                      dec._sm_count(q.device.index))
            stages = 0
        o = torch.empty_like(q)
        for q0 in range(0, G, g):
            _build.check(fn(q.data_ptr(), k8.data_ptr(), ks.data_ptr(),
                            v8.data_ptr(), vs.data_ptr(), o.data_ptr(), code,
                            1, B, S, KV * g, KV, G, q0, dh, pos, window,
                            int(ring), n, chunk, stages, dh ** -0.5,
                            stream()), "quant variant")
        return o
    return run


def forced_plan(n_ctas, itemsize=2, max_stages=None):
    """decode_sm90's plan with n_ctas CTAs a row (whole tiles a CTA, as
    deep a ring as its tiles need, up to max_stages or the kernel's
    deepest)."""
    def plan(B, S, KV, G, dh):
        tpc = -(-(-(-S // dec.SLOT_TILE)) // n_ctas)
        cap = max_stages or dec.sm90_max_stages(dh, itemsize)
        return (-(-S // (tpc * dec.SLOT_TILE)), tpc * dec.SLOT_TILE,
                min(tpc, cap))
    return plan


def timeline(lib, run, sets, n_ctas):
    """The timeline variant's phases over every CTA of one launch on
    sets[1] (after one on sets[0]: the library loaded, sets[1]'s cache out
    of L2), in µs from the launch's first CTA start: the median and the
    largest CTA's time at each phase."""
    run(*sets[0])
    run(*sets[1])
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (9 * n_ctas))()
    fn = lib.decode_timeline
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    _build.check(fn(ctypes.addressof(buf), n_ctas), "timeline")
    t = torch.tensor(list(buf), dtype=torch.float64).view(n_ctas, 9)
    t = (t - t[:, 0].min()) / 1e3
    return dict(median_us=[round(float(x), 3) for x in t.median(0).values],
                max_us=[round(float(x), 3) for x in t.max(0).values])


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


# K2/K3's shapes: (model, B, S, H, KV, dh, window, ring, pos), those of
# chip_smoke.py's kernel phase
DECODE_SHAPES = [
    ("qwen3-1.7b", 4, 1024, 16, 8, 128, 0, False, 1039),
    ("hymba-1.5b", 4, 1024, 25, 5, 64, 1024, True, 1039),
    ("llava-next-mistral-7b", 4, 4096, 32, 8, 128, 4096, True, 4111),
    ("chatglm3-6b", 4, 1024, 32, 2, 128, 0, False, 1039),
    ("deepseek-coder-33b", 4, 1024, 56, 8, 128, 0, False, 1039),
    ("qwen1.5-32b", 4, 1024, 40, 40, 128, 0, False, 1039),
]


def time_k23(libs, g):
    """K2 on decode_sm90 (committed, its diagnostics, other cluster sizes)
    against decode_cluster and SDPA, in turns, with the timeline; K3 on
    both kernels at qwen3-1.7b's shape."""
    bf = torch.bfloat16
    for model, B, S, H, KV, dh, window, ring, pos in DECODE_SHAPES:
        r = lambda *s: torch.randn(*s, generator=g, device="cuda", dtype=bf)
        mk = lambda: (r(B, 1, H, dh), r(B, S, KV, dh), r(B, S, KV, dh))
        sets = [mk() for _ in range(cs.n_sets(cs.nbytes(*mk())))]
        ref = dec.decode_attention_plain(*sets[0], pos, window=window,
                                         ring=ring)
        bind = lambda run: lambda q, k, v: run(q, k, v, pos, window, ring)
        runs = {"sm90": bind(decode_runner(libs["k2"])),
                "cluster": bind(decode_runner(libs["k2"], "cluster"))}
        for name in K23_VARIANTS:
            if name != "timeline":
                runs[f"sm90_{name}"] = bind(decode_runner(libs[f"k2_{name}"]))
        plan = dec.launch_plan(bf, bf, B, S, H, KV, dh, sets[0][0].device)
        for n in (1, 2, 4, 8, 16):
            if n != plan["n_ctas"]:
                runs[f"sm90_n{n}"] = bind(decode_runner(
                    libs["k2"], plan=forced_plan(n)))
        # every slot is attended at these shapes: SDPA over the slots
        lib_fn = lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, enable_gqa=True)
        tsets = [tuple(t.transpose(1, 2).contiguous() for t in s)
                 for s in sets]
        res = time_all(runs, sets, ref, lib_fn, tsets)
        tl = timeline(libs["k2_timeline"], bind(decode_runner(
            libs["k2_timeline"])), sets, B * KV * plan["n_ctas"])
        print(json.dumps(dict(kernel="K2", model=model, B=B, S=S, H=H,
                              KV=KV, dh=dh, pos=pos, window=window,
                              plan=plan, ms_ms_err=res, timeline=tl)),
              flush=True)
        if model != "qwen3-1.7b":
            continue
        sets = quant_sets(g, B, S, H, KV, dh)
        ref = dec.decode_attention_quant_plain(*sets[0], pos, window=window,
                                               ring=ring)
        qb = lambda run: lambda *a: run(*a, pos, window, ring)
        runs = {"sm90": qb(quant_runner(libs["k2"])),
                "cluster": qb(quant_runner(libs["k2"], "cluster"))}
        for name in K23_VARIANTS:
            if name != "timeline":
                runs[f"sm90_{name}"] = qb(quant_runner(libs[f"k2_{name}"]))
        plan = dec.launch_plan(bf, torch.int8, B, S, H, KV, dh,
                               sets[0][0].device)
        for n in (4, 8, 16):
            if n != plan["n_ctas"]:
                runs[f"sm90_n{n}"] = qb(quant_runner(
                    libs["k2"], plan=forced_plan(n, 1)))
        res = time_all(runs, sets, ref)
        tl = timeline(libs["k2_timeline"], qb(quant_runner(
            libs["k2_timeline"])), sets, B * KV * plan["n_ctas"])
        print(json.dumps(dict(kernel="K3", model=model, B=B, S=S, H=H,
                              KV=KV, dh=dh, pos=pos, window=window,
                              plan=plan, ms_ms_err=res, timeline=tl)),
              flush=True)


def time_floor(lib):
    """Empty launches of 256 CTAs: plain, and in clusters of 8 and 16."""
    fn = lib.launch_empty
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    for gx, gy, smem, cluster in [(8, 32, 0, 1), (8, 32, 74624, 1),
                                  (8, 32, 74624, 8), (16, 16, 49152, 16),
                                  (16, 8, 49152, 16)]:
        ms = cs.device_ms(lambda: _build.check(
            fn(gx, gy, smem, cluster, stream()), "empty"), [()], iters=50)
        print(json.dumps(dict(kernel="empty", grid=[gx, gy], smem=smem,
                              cluster=cluster, ms=ms)), flush=True)


def sass_tile_loops():
    """Static SASS of each decode_sm90 instance in the committed library
    (``cuobjdump -sass``): its instructions, and those of its tile loop,
    the longest loop (a backward branch and its target) that holds tensor
    core instructions (HMMA), with the loop's ten commonest opcodes. A
    loop's static count approximates what one tile issues: its body runs
    once a tile, branches aside."""
    so = _build.library("decode_attention")._name
    text = subprocess.run(["cuobjdump", "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for block in re.split(r"\n\s*Function : ", text)[1:]:
        name, body = block.split("\n", 1)
        if "decode_sm90" not in name:
            continue
        ins, labels = [], {}
        for line in body.splitlines():
            lab = re.match(r"\s*(\.L_x_\d+):", line)
            if lab:
                labels[lab.group(1)] = len(ins)
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
            if m:
                ins.append((int(m.group(1), 16), m.group(2)))
        at = {a: i for i, (a, _) in enumerate(ins)}
        loops = []
        for i, (_, op) in enumerate(ins):
            m = re.search(r"\bBRA\b.*?(?:`?\((\.L_x_\d+)\)`?|0x([0-9a-f]+))",
                          op)
            if not m:
                continue
            j = (labels.get(m.group(1)) if m.group(1)
                 else at.get(int(m.group(2), 16)))
            if j is not None and j <= i and any(
                    "HMMA" in o for _, o in ins[j:i + 1]):
                loops.append((i + 1 - j, j, i))
        opcode = lambda o: re.sub(r"^@!?U?P\w+\s+", "", o).split()[0]
        row = {"instructions": len(ins)}
        if loops:
            n, j, i = max(loops)
            ops = [opcode(o) for _, o in ins[j:i + 1]]
            common = sorted(set(ops), key=lambda o: -ops.count(o))[:10]
            row.update(tile_loop=n, tile_loop_hmma=sum(
                o.startswith("HMMA") for o in ops),
                tile_loop_opcodes={o: ops.count(o) for o in common})
        try:
            name = subprocess.run(["cu++filt", name.strip()],
                                  capture_output=True, text=True,
                                  check=True).stdout.strip()
        except (OSError, subprocess.CalledProcessError):
            name = name.strip()
        out[name] = row
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("attention_variants: needs a CUDA card", file=sys.stderr)
        return 1
    which = sys.argv[1] if len(sys.argv) > 1 else None
    if which not in (None, "--k1", "--k23", "--sass"):
        print("usage: attention_variants.py [--k1 | --k23 | --sass]",
              file=sys.stderr)
        return 2
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    if which == "--sass":
        for name, row in sass_tile_loops().items():
            print(json.dumps(dict(kernel=name, **row)), flush=True)
        return 0
    sources = {}
    if which != "--k23":
        sources.update(
            {"k1": (ROOT / "src/repro_torch/csrc/flash_attention.cu")
             .read_text(),
             **{f"k1_{n}": t for n, t in variants(
                 "src/repro_torch/csrc/flash_attention.cu",
                 K1_VARIANTS).items()}})
    if which != "--k1":
        sources.update(
            {"k2": (ROOT / "src/repro_torch/csrc/decode_attention.cu")
             .read_text(),
             **{f"k2_{n}": t for n, t in variants(
                 "src/repro_torch/csrc/decode_attention.cu",
                 K23_VARIANTS).items()},
             "floor": FLOOR})
    libs = build(sources)
    print(json.dumps({"spilling": {n: spills(n) for n in libs
                                   if spills(n)}}), flush=True)
    g = torch.Generator("cuda").manual_seed(1)
    if which != "--k23":
        time_k1(libs, g)
        print(json.dumps({"k1_host_us": k1_host_us()}), flush=True)
    if which != "--k1":
        time_k23(libs, g)
        time_floor(libs["floor"])
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Time K4 (the mLSTM scan) and K5 (the SSM scan) of the PyTorch/CUDA port
against variants of their own sources, on one NVIDIA GPU.

    python3 scripts/scan_variants.py --export-base   # in a git checkout
    python3 scripts/scan_variants.py [--k4 | --k5]   # on the card

Each variant is the committed source (``src/repro_torch/csrc``) with one
textual change, built by nvcc beside it into ``build/variants``, or the
committed library run with another kernel of its C entry; all are timed
on the same inputs in the same process as the committed kernel, in turns
(forward, then in reverse), at the prefill shapes of ``chip_smoke.py``'s
kernel phase: K4 at xlstm-350m's (B 4, S 1024, H 4, dh 512, f32, from a
state), K5 at hymba-1.5b's (B 4, S 1024, Hs 25, P 64, N 16, bf16 x, from
a state).

- Both: the Hopper kernel (``sm90``, the committed choice), the earlier
  chunked kernels on mma.sync (``mma_sync``) and the step kernel over all
  S (``steps``, kernel 0). K4's ``mma_sync`` is the same library's
  kernel 1 (it still runs K4 at dh 32 and 64). K5's three mma.sync
  launches are no longer in the library: ``--export-base`` writes their
  source, ``ssm_scan.cu`` and its header as they stood at ``BASE_REV``
  (``git show``), into ``build/variants/base``, and the timing run builds
  them from there. Export before copying the tree to a machine without
  the repository's history; the timing run exports by itself where git
  can.
- K4's diagnostics of the Hopper kernel, which give wrong results:
  without its products (``no_products``: no wgmma), without its q, k and
  v loads (``no_loads``: the barriers complete with no bytes), without
  the cluster's exchange of P (``no_exchange``: each CTA reads only its
  own partials and gathers no rows), without the Q K^T share
  (``no_share``), with the m recurrence's serial loop cut to one step
  (``no_gates``), and a timeline of one CTA's phases (``timeline``).
- K5's diagnostics of the Hopper kernel: without its products
  (``no_products``), without the x, B, C loads (``no_loads``), and
  without the composition through distributed shared memory
  (``no_exchange``), a timeline of one CTA's phases (``timeline``), and
  the kernel built for one CTA an SM (``one_cta_per_sm``: ptxas may take
  up to 224 registers, so the spills of the committed build go, at half
  the CTAs resident; right results).

Each variant's launches are also timed apart by torch.profiler, and the
committed kernels' registers and spills and, for K4, how many clusters
fit on the card at once are printed. Prints one JSON line per kernel and
variant, and the card's name and power limit. Needs CUDA and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "scripts")]

import chip_smoke as cs  # noqa: E402
from attention_variants import build, spills, variants  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.mlstm_scan import ops as k4  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as k5  # noqa: E402

K4_SRC = "src/repro_torch/csrc/mlstm_scan.cu"
K5_SRC = "src/repro_torch/csrc/ssm_scan.cu"
# the last commit whose ssm_scan.cu holds K5's three mma.sync launches
# (ssd_chunk_state, ssd_state_pass, ssd_chunk_out), the baseline variant
BASE_REV = "d63ef7f"
BASE = ROOT / "build" / "variants" / "base"
BASE_FILES = {"ssm_scan.cu": "k5_mma_sync.cu",
              "sm90_helpers.cuh": "sm90_helpers.cuh"}
K4_VARIANTS = {
    "no_products": [("wgmma_tf32_", "if (S < 0) wgmma_tf32_")],
    "no_loads": [
        ("    mbar_expect_tx(full(st), 16384);\n    if (rank == 0) {",
         "    mbar_arrive(full(st));\n    if (rank == 0 && L < 0) {"),
        ("    mbar_expect_tx(vfull(vb), 16384);\n"
         "    for (int hb = 0; hb < 2; ++hb)",
         "    mbar_arrive(vfull(vb));\n"
         "    for (int hb = 0; hb < 2 * (c < 0); ++hb)")],
    "no_exchange": [
        ("            sum += ld_dsmem(\n"
         "                mapa(smem_u32(part + wg * (CL * PT) + t * PT + s_), "
         "rr));",
         "            sum += part[wg * (CL * PT) + t * PT + s_];"),
        ("    for (int e = tid; e < (CS - 1) * RPC * 32; e += 256) {",
         "    for (int e = tid; e < 0; e += 256) {"),
        ("    for (int e = tid; e < (CS - 1) * RPC; e += 256) {",
         "    for (int e = tid; e < 0; e += 256) {")],
    "no_share": [("      const bool share = i / SPC == rank;",
                  "      const bool share = S < 0 && i / SPC == rank;")],
    "no_gates": [("          if (t < n) {\n            const float lf",
                  "          if (t < 1) {\n            const float lf")],
}
# A timeline of the Hopper kernel (wrong results): thread 0 of the first
# CTA of (batch 0, head 0) sums the time of each phase over the chunks,
# in µs, and writes the sums into n[0, 0, 1..8]: the gates, the wait for
# v, the slice loop, the wait for the other CTA's partial Q K^T, the wait
# for its rows of P, the gather, P V, and the epilogue.
TS4 = ("if (tid == 0) { const unsigned long long n_ = global_ns(); "
       "tacc_[{k}] += (n_ - tprev_) * 1e-3f; tprev_ = n_; }")
K4_VARIANTS["timeline"] = [
    ("  for (int c = 0; c < nc; ++c) {\n    // the indices afresh",
     "  unsigned long long tprev_ = global_ns();\n  float tacc_[8] = {};\n"
     "  for (int c = 0; c < nc; ++c) {\n    // the indices afresh"),
    ("    sync_all();\n    const float gd = scal[2];",
     "    sync_all();\n    " + TS4.replace("{k}", "0") + "\n    const float gd = scal[2];"),
    ("    mbar_wait(vfull(vb), (c >> 1) & 1);",
     "    mbar_wait(vfull(vb), (c >> 1) & 1);\n    " + TS4.replace("{k}", "1")),
    ("    // n0 . q_t: this warpgroup's part",
     "    " + TS4.replace("{k}", "2") + "\n    // n0 . q_t: this warpgroup's part"),
    ("    mbar_wait_cluster(pready, c & 1);",
     "    mbar_wait_cluster(pready, c & 1);\n    " + TS4.replace("{k}", "3")),
    ("    mbar_wait_cluster(prready, c & 1);",
     "    mbar_wait_cluster(prready, c & 1);\n    " + TS4.replace("{k}", "4")),
    ("    // P V on this warpgroup's half of t",
     "    " + TS4.replace("{k}", "5") + "\n    // P V on this warpgroup's half of t"),
    ("    // Q C0^T: each warpgroup's share of the j sum",
     "    " + TS4.replace("{k}", "6") + "\n    // Q C0^T: each warpgroup's share of the j sum"),
    ("    sync_all();   // v, the partial's buffer and the gates are free\n  }",
     "    sync_all();   // v, the partial's buffer and the gates are free\n"
     "    " + TS4.replace("{k}", "7") + "\n  }"),
    ("    if (tid == 0) m_out[bh] = scal[0];\n  }",
     "    if (tid == 0) m_out[bh] = scal[0];\n  }\n  named_bar_sync(1, 256);\n"
     "  if (bh == 0 && blockIdx.x == 0 && tid == 0)\n"
     "    for (int k = 0; k < 8; ++k) n_out[1 + k] = tacc_[k];"),
]

K5_VARIANTS = {
    "no_products": [
        ("      warp_mma<1, CL, X_EXACT, false>(",
         "      if (S < 0) warp_mma<1, CL, X_EXACT, false>("),
        ("      warp_mma<CL / 8, N>(", "      if (S < 0) warp_mma<CL / 8, N>("),
        ("      warp_mma<NTL, CL, false, X_EXACT>(",
         "      if (S < 0) warp_mma<NTL, CL, false, X_EXACT>("),
        ("      warp_mma<NTL, N>(", "      if (S < 0) warp_mma<NTL, N>(")],
    "no_loads": [
        ("        mbar_expect_tx(full(s), bytes);\n        tma_load_4d(xs,",
         "        mbar_arrive(full(s));\n        if (S < 0) tma_load_4d(xs,"),
        ("        tma_load_3d(xs + RS::X_BYTES, &tmb,",
         "        if (S < 0) tma_load_3d(xs + RS::X_BYTES, &tmb,"),
        ("        tma_load_3d(xs + RS::X_BYTES + RS::BC_BYTES, &tmc,",
         "        if (S < 0) tma_load_3d(xs + RS::X_BYTES + RS::BC_BYTES, "
         "&tmc,")],
    "no_exchange": [("      const int jr = j < rank ? j : rank;",
                     "      const int jr = rank;"),
                    ("      if (j < rank) {\n        v.x = fmaf",
                     "      if (j < rank && S < 0) {\n        v.x = fmaf")],
    "one_cta_per_sm": [("__launch_bounds__(C_THREADS + 32, 2)",
                        "__launch_bounds__(C_THREADS + 32, 1)")],
}


# A timeline of the Hopper kernel (wrong results): thread 0 of the last
# CTA of (head 0, batch 0) writes, in µs from its start, the end of the
# wait for its loads, of pass A, of the cluster barrier, of the
# composition, of the chunks' start states, of M and of y into
# state[0, 0, 0, 1..7].
TS5 = "if (tid == 0) ts_[{k}] = global_ns();"
K5_VARIANTS["timeline"] = [
    ("  const int rank = blockIdx.x, n_ctas = gridDim.x;\n"
     "  const int h = blockIdx.y, b = blockIdx.z;",
     "  __shared__ unsigned long long ts_[8];\n"
     "  if (threadIdx.x == 0) ts_[0] = repro_sm90::global_ns();\n"
     "  const int rank = blockIdx.x, n_ctas = gridDim.x;\n"
     "  const int h = blockIdx.y, b = blockIdx.z;"),
    ("    wait_group(nk, load0);\n    gates(nk, load0);",
     "    wait_group(nk, load0);\n    " + TS5.replace("{k}", "1") +
     "\n    gates(nk, load0);"),
    ("  if (tid == 0) *summ_a = aspan;",
     "  " + TS5.replace("{k}", "2") + "\n  if (tid == 0) *summ_a = aspan;"),
    ("  cluster_arrive();\n  cluster_wait();\n  const size_t bh",
     "  cluster_arrive();\n  cluster_wait();\n  " + TS5.replace("{k}", "3") +
     "\n  const size_t bh"),
    ("  cluster_arrive();   // done with the other CTAs' shared memory",
     "  cluster_arrive();   // done with the other CTAs' shared memory\n  " +
     TS5.replace("{k}", "4")),
    ("    sync();\n    // M_ts = ",
     "    sync();\n    " + TS5.replace("{k}", "5") + "\n    // M_ts = "),
    ("          mmg[k * RS::MM + t * MS + u] = v;\n        }\n    }\n    sync();",
     "          mmg[k * RS::MM + t * MS + u] = v;\n        }\n    }\n    sync();\n"
     "    " + TS5.replace("{k}", "6")),
    ("    sync();   // the group's stages and arrays are the next group's",
     "    sync();   // the group's stages and arrays are the next group's\n"
     "    " + TS5.replace("{k}", "7")),
    ("  cluster_wait();   // no CTA leaves while another may read its summary",
     "  sync();\n  if (tid == 0 && rank == n_ctas - 1 && h == 0 && b == 0)\n"
     "    for (int k = 1; k < 8; ++k)\n"
     "      state[k] = (ts_[k] - ts_[0]) * 1e-3f;\n"
     "  cluster_wait();   // no CTA leaves while another may read its summary"),
]


def stream():
    return torch.cuda.current_stream().cuda_stream


def k4_runner(lib, kernel):
    fn = lib.mlstm_scan_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6 + \
        [ctypes.c_void_p]
    L = lib.mlstm_scan_chunk()

    def run(q, k, v, ig, fg, state):
        B, S, H, dh = q.shape
        nc = -(-S // L)
        h = torch.empty_like(q)
        out = (torch.empty(B, H, dh, dh, device=q.device),
               torch.empty(B, H, dh, device=q.device),
               torch.empty(B, H, device=q.device))
        scratch = [None, None]
        if kernel == "mma_sync":
            scratch = [torch.empty(B * H * nc * L * L, device=q.device),
                       torch.empty(B * H * nc * 4 * L, device=q.device)]
        ptrs = [t.data_ptr() for t in (q, k, v, ig, fg, *state, h, *out)]
        ptrs += [t.data_ptr() if t is not None else None for t in scratch]
        _build.check(fn(*ptrs, k4.KERNELS[kernel], B, S, H, dh, 1,
                        stream()), f"K4 {kernel}")
        return (h,) + out
    return run


def k5_runner(lib, kernel):
    """K5's ``kernel`` from a library of the committed C entry, or, with
    ``kernel`` None, the chunked path of a ``BASE_REV`` library, whose C
    entry takes scratch dS (B Hs nc P N floats) and dA (B Hs nc floats)
    and no kernel code."""
    fn = lib.ssm_scan_fwd
    fn.restype = ctypes.c_int
    base = kernel is None
    fn.argtypes = [ctypes.c_void_p] * (11 if base else 9) + \
        [ctypes.c_int] * (8 if base else 9) + [ctypes.c_void_p]
    L = lib.ssm_scan_chunk()

    def run(x, dt, a_log, b, c, d_skip, state):
        B, S, Hs, P = x.shape
        N = b.shape[-1]
        nc = -(-S // L)
        y = torch.empty_like(x)
        fin = torch.empty(B, Hs, P, N, device=x.device)
        ptrs = [t.data_ptr() for t in (x, dt, a_log, b, c, d_skip, state,
                                        y, fin)]
        if base:
            ptrs += [torch.empty(n, device=x.device).data_ptr()
                     for n in (B * Hs * nc * P * N, B * Hs * nc)]
        else:
            ptrs.append(k5.KERNELS[kernel])
        _build.check(fn(*ptrs, _build.DTYPES[x.dtype],
                        _build.DTYPES[a_log.dtype], B, S, Hs, P, N, 1,
                        stream()), f"K5 {kernel or 'mma_sync'}")
        return y, fin
    return run


def export_base(rev):
    """``rev``'s K5 source and the header it includes, by ``git show``,
    into ``BASE`` (the K5 baseline is built from there; the header beside
    it, so that its own include finds ``rev``'s)."""
    BASE.mkdir(parents=True, exist_ok=True)
    for src, dst in BASE_FILES.items():
        text = subprocess.run(
            ["git", "-C", str(ROOT), "show",
             f"{rev}:src/repro_torch/csrc/{src}"],
            check=True, capture_output=True, text=True).stdout
        (BASE / dst).write_text(text)


def base_source():
    """The K5 baseline's source text, exported first where git can."""
    path = BASE / BASE_FILES["ssm_scan.cu"]
    if not path.exists() and (ROOT / ".git").exists():
        export_base(BASE_REV)
    if not path.exists():
        raise SystemExit("scan_variants: no K5 baseline source; run "
                         "scripts/scan_variants.py --export-base in a git "
                         "checkout first")
    return path.read_text()


def per_kernel(run, args, reps=5):
    """Device µs per call of each CUDA kernel ``run`` launches, by
    torch.profiler over ``reps`` calls."""
    by_name, _ = cs.profiled(lambda: [run(*args) for _ in range(reps)])
    short = lambda n: n.split("(anonymous namespace)::")[-1].split("(")[0]
    return {short(n): us / reps for n, us in by_name.items()}


def time_variants(kernel, runs, sets, ref, shape):
    """Each variant timed in turns (forward, then in reverse), its largest
    row-relative error against ``ref`` (the plain version's outputs on
    ``sets[0]``) and its kernels' device time by the profiler."""
    ms = {name: [] for name in runs}
    for name, run in list(runs.items()) + list(runs.items())[::-1]:
        ms[name].append(cs.device_ms(run, sets))
    for name, run in runs.items():
        out = run(*sets[0])
        err = max(cs.row_rel_err(o, r) for o, r in zip(out, ref))
        extra = {}
        if name == "timeline":   # the µs the timeline variants write
            at = out[2][0, 0, 1:9] if kernel == "K4" else out[1][0, 0, 0, 1:8]
            extra["timeline_us"] = [round(float(x), 3) for x in at]
        print(json.dumps(dict(kernel=kernel, variant=name, **shape,
                              ms=ms[name], max_row_rel_err=err,
                              kernels_us=per_kernel(run, sets[0]), **extra)),
              flush=True)


def build_info(libname, sources):
    """The registers and spills of each kernel that spills, and whether
    ptxas serialized the wgmma of any (warning C7518), per source."""
    info = {}
    for name in sources:
        log = (ROOT / "build" / "variants" / f"{name}.log").read_text()
        info[name] = dict(spills=spills(name), wgmma_serialized="C7518" in log)
    print(json.dumps(dict(build=libname, **info)), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--k4", action="store_true", help="K4 alone")
    ap.add_argument("--k5", action="store_true", help="K5 alone")
    ap.add_argument("--export-base", action="store_true",
                    help=f"write the K5 baseline's source as it stood at "
                    f"{BASE_REV} and exit")
    opts = ap.parse_args()
    if opts.export_base:
        export_base(BASE_REV)
        print(f"scan_variants: K5 baseline of {BASE_REV} in {BASE}")
        return 0
    if not torch.cuda.is_available():
        print("scan_variants: needs a CUDA card", file=sys.stderr)
        return 1
    do4, do5 = (opts.k4 or not opts.k5), (opts.k5 or not opts.k4)
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    sources = {}
    if do4:
        sources.update({"k4": (ROOT / K4_SRC).read_text(),
                        **{f"k4_{n}": t for n, t in variants(
                            K4_SRC, K4_VARIANTS).items()}})
    if do5:
        sources.update({"k5": (ROOT / K5_SRC).read_text(),
                        "base/k5_mma_sync": base_source(),
                        **{f"k5_{n}": t for n, t in variants(
                            K5_SRC, K5_VARIANTS).items()}})
    libs = build(sources)
    build_info("variants", sources)
    g = torch.Generator("cuda").manual_seed(4)
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")
    B, S = cs.SERVE_BATCH, cs.SERVE_SEQ

    if do4:
        H, dh = 4, 512
        lib = libs["k4"]
        lib.mlstm_scan_max_clusters.restype = ctypes.c_int
        print(json.dumps(dict(kernel="K4", dh=dh,
                              max_active_clusters=lib.mlstm_scan_max_clusters(
                                  dh),
                              clusters=B * H)), flush=True)
        mk = lambda S: (r(B, S, H, dh) * dh ** -0.5,
                        r(B, S, H, dh) * dh ** -0.5, r(B, S, H, dh),
                        r(B, S, H), r(B, S, H) + 2.0)
        _, state = k4.mlstm_scan_plain(*mk(64))
        sets = [mk(S) + (state,) for _ in range(3)]
        ph, pfin = k4.mlstm_scan_plain(*sets[0])
        runs = {"sm90": k4_runner(lib, "sm90"),
                "mma_sync": k4_runner(lib, "mma_sync"),
                "steps": k4_runner(lib, "steps")}
        runs.update({n[3:]: k4_runner(l, "sm90") for n, l in libs.items()
                     if n.startswith("k4_")})
        time_variants("K4", runs, sets, (ph,) + pfin,
                      dict(B=B, S=S, H=H, dh=dh))

    if do5:
        Hs, P, N = 25, 64, 16
        bf = torch.bfloat16
        mk = lambda S: (r(B, S, Hs, P).to(bf), F.softplus(r(B, S, Hs)),
                        (r(Hs) * 0.3).to(bf), r(B, S, N), r(B, S, N),
                        r(Hs).to(bf))
        _, state = k5.ssm_scan_plain(*mk(64))
        sets = [mk(S) + (state,) for _ in range(cs.n_sets(
            cs.nbytes(*mk(S), state)))]
        py, pfin = k5.ssm_scan_plain(*sets[0])
        lib = libs["k5"]
        runs = {"sm90": k5_runner(lib, "sm90"),
                "mma_sync": k5_runner(libs["base/k5_mma_sync"], None),
                "steps": k5_runner(lib, "steps")}
        runs.update({n[3:]: k5_runner(l, "sm90") for n, l in libs.items()
                     if n.startswith("k5_")})
        time_variants("K5", runs, sets, (py, pfin),
                      dict(B=B, S=S, Hs=Hs, P=P, N=N, x_dtype="bfloat16"))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Time K4 (the mLSTM scan) and K5 (the SSM scan) of the PyTorch/CUDA port
against variants of their own sources, on one NVIDIA GPU.

    python3 scripts/scan_variants.py

Each variant is the committed source (``src/repro_torch/csrc``) with one
textual change, built by nvcc beside it into ``build/variants`` and timed
on the same inputs in the same process as the committed kernel, in turns,
at the prefill shapes of ``chip_smoke.py``'s kernel phase: K4 at
xlstm-350m's (B 4, S 1024, H 4, dh 512, f32, from a state), K5 at
hymba-1.5b's (B 4, S 1024, Hs 25, P 64, N 16, bf16 x, from a state).

- K4: chunk length 32 (``chunk32``), 32 rows of C per CTA (``rows32``),
  the products as register-tiled f32 FMAs on the CUDA cores instead of
  3xTF32 on the tensor cores (``f32_cuda_cores``),
  P and the gate vectors formed dh / R times over, as a design that forms
  them in every CTA of a (batch, head) would (``p_per_cta``), and the
  step kernel over all S steps (``steps``, the kernel before the
  chunkwise path).
- K5: chunk length 16 (48 and 64 exceed the output pass's static shared
  memory), one head per CTA of the output pass
  (``heads1``), and the step kernel over all S (``steps``), which is
  broken down by diagnostics of it that give wrong results: without the
  exp of the decay (``steps_no_exp``), without y's shuffle reduction
  (``steps_no_shuffle``), without y's stores (``steps_no_store``), and a
  variant that splits each head's P rows over 4 CTAs (``steps_4ctas``).

Each variant's launches are also timed apart by torch.profiler. Prints
one JSON line per kernel and variant, and the card's name and power
limit. Needs CUDA and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "scripts")]

import chip_smoke as cs  # noqa: E402
from attention_variants import build, variants  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.mlstm_scan import ops as k4  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as k5  # noqa: E402

K4_SRC = "src/repro_torch/csrc/mlstm_scan.cu"
K5_SRC = "src/repro_torch/csrc/ssm_scan.cu"
K4_VARIANTS = {
    "chunk32": [("constexpr int CL = 64;", "constexpr int CL = 32;")],
    "rows32": [("constexpr int R = DH < 64 ? DH : 64;",
                "constexpr int R = 32;")],
    "p_per_cta": [("mlstm_chunk_prep<DH><<<dim3(nc, B * H), NT",
                   "mlstm_chunk_prep<DH><<<dim3(nc, B * H, DH / R), NT")],
    "f32_cuda_cores": [("constexpr bool TF32X3 = true;",
                        "constexpr bool TF32X3 = false;")],
    "steps": [("const bool chunks = S >= CL;", "const bool chunks = false;")],
    # diagnostics (wrong results): the state pass without its three
    # tensor-core products, and without its q and k slice loads
    "no_products": [("      warp_mma<NT1, CL>(", "      if (S < 0) warp_mma<NT1, CL>("),
                    ("        warp_mma<NT1, JW>(", "        if (S < 0) warp_mma<NT1, JW>("),
                    ("        warp_mma<NT2, CL>(", "        if (S < 0) warp_mma<NT2, CL>(")],
    "no_slice_loads": [("      cp_async16(qs + t * QS + 4 * jq, qb + off, ok);\n"
                        "      cp_async16(ks + t * KS + 4 * jq, kb + off, ok);",
                        "      (void)off;")],
}
K5_STEPS = [("if (a.S < CL) {", "if (true) {")]
K5_VARIANTS = {
    "chunk16": [("constexpr int CL = 32;", "constexpr int CL = 16;")],
    "heads1": [("constexpr int HG = 5;", "constexpr int HG = 1;")],
    "steps": K5_STEPS,
    # diagnostic (wrong results): the chunked output pass without its y
    # tiles
    "out_no_tiles": [("    for (int tile = warp; tile < (CL / 16) * nt8;",
                      "    for (int tile = warp; tile < 0 * nt8;")],
    "steps_no_exp": K5_STEPS + [("const float decay = expf(dtv * A);",
                                 "const float decay = 1.f + dtv * A;")],
    "steps_no_shuffle": K5_STEPS + [
        ("        acc += __shfl_xor_sync(0xffffffffu, acc, off);",
         "        (void)off;")],
    "steps_no_store": K5_STEPS + [
        ("      if (j == 0) yp[", "      if (j == 0 && acc == 12345.f) yp[")],
    "steps_4ctas": K5_STEPS + [
        ("  const int h = blockIdx.x;", "  const int h = blockIdx.x / 4;"),
        ("  const int p = tid / L;",
         "  const int p = (blockIdx.x % 4) * (P / 4) + tid / L;"),
        ("  const int j = tid - p * L;", "  const int j = tid % L;"),
        ("ssm_scan_kernel<TX, TW, N><<<dim3(a.Hs, a.B), threads,",
         "ssm_scan_kernel<TX, TW, N><<<dim3(a.Hs * 4, a.B), threads / 4,")],
}


def stream():
    return torch.cuda.current_stream().cuda_stream


def k4_runner(lib):
    fn = lib.mlstm_scan_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p]
    L = lib.mlstm_scan_chunk()

    def run(q, k, v, ig, fg, state):
        B, S, H, dh = q.shape
        nc = -(-S // L)
        h = torch.empty_like(q)
        out = (torch.empty(B, H, dh, dh, device=q.device),
               torch.empty(B, H, dh, device=q.device),
               torch.empty(B, H, device=q.device))
        scratch = (torch.empty(B * H * nc * L * L, device=q.device),
                   torch.empty(B * H * nc * 4 * L, device=q.device))
        _build.check(fn(*(t.data_ptr() for t in (q, k, v, ig, fg, *state,
                                                  h, *out, *scratch)),
                        B, S, H, dh, 1, stream()), "K4 variant")
        return (h,) + out
    return run


def k5_runner(lib):
    fn = lib.ssm_scan_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + \
        [ctypes.c_void_p]
    L = lib.ssm_scan_chunk()

    def run(x, dt, a_log, b, c, d_skip, state):
        B, S, Hs, P = x.shape
        N = b.shape[-1]
        nc = -(-S // L)
        y = torch.empty_like(x)
        fin = torch.empty(B, Hs, P, N, device=x.device)
        scratch = (torch.empty(B * Hs * nc * P * N, device=x.device),
                   torch.empty(B * Hs * nc, device=x.device))
        _build.check(fn(*(t.data_ptr() for t in (
            x, dt, a_log, b, c, d_skip, state, y, fin, *scratch)),
            _build.DTYPES[x.dtype], _build.DTYPES[a_log.dtype], B, S, Hs, P,
            N, 1, stream()), "K5 variant")
        return y, fin
    return run


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
        print(json.dumps(dict(kernel=kernel, variant=name, **shape,
                              ms=ms[name], max_row_rel_err=err,
                              kernels_us=per_kernel(run, sets[0]))),
              flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("scan_variants: needs a CUDA card", file=sys.stderr)
        return 1
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    libs = build({"k4": (ROOT / K4_SRC).read_text(),
                  **{f"k4_{n}": t for n, t in variants(
                      K4_SRC, K4_VARIANTS).items()},
                  "k5": (ROOT / K5_SRC).read_text(),
                  **{f"k5_{n}": t for n, t in variants(
                      K5_SRC, K5_VARIANTS).items()}})
    g = torch.Generator("cuda").manual_seed(4)
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")
    B, S = cs.SERVE_BATCH, cs.SERVE_SEQ

    H, dh = 4, 512
    mk = lambda S: (r(B, S, H, dh) * dh ** -0.5, r(B, S, H, dh) * dh ** -0.5,
                    r(B, S, H, dh), r(B, S, H), r(B, S, H) + 2.0)
    _, state = k4.mlstm_scan_plain(*mk(64))
    sets = [mk(S) + (state,) for _ in range(3)]
    ph, pfin = k4.mlstm_scan_plain(*sets[0])
    time_variants("K4", {n: k4_runner(lib) for n, lib in libs.items()
                         if n.startswith("k4")}, sets, (ph,) + pfin,
                  dict(B=B, S=S, H=H, dh=dh))

    Hs, P, N = 25, 64, 16
    bf = torch.bfloat16
    mk = lambda S: (r(B, S, Hs, P).to(bf), F.softplus(r(B, S, Hs)),
                    (r(Hs) * 0.3).to(bf), r(B, S, N), r(B, S, N),
                    r(Hs).to(bf))
    _, state = k5.ssm_scan_plain(*mk(64))
    sets = [mk(S) + (state,) for _ in range(cs.n_sets(
        cs.nbytes(*mk(S), state)))]
    py, pfin = k5.ssm_scan_plain(*sets[0])
    time_variants("K5", {n: k5_runner(lib) for n, lib in libs.items()
                         if n.startswith("k5")}, sets, (py, pfin),
                  dict(B=B, S=S, Hs=Hs, P=P, N=N, x_dtype="bfloat16"))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

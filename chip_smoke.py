"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits non-zero:
  1. device  — CUDA must be available; the card's name and power limit
               as nvidia-smi reports them.
  2. build   — compile the CUDA kernels from ``src/repro_torch/csrc``;
               each kernel's registers and spilled bytes (ptxas), and the
               kernels that spill.
  3. kernels — K1 (flash attention), K2 (decode attention) and K3 (int8
               decode attention) on the card at the serving shapes of
               full-width qwen3-1.7b, K4 (the mLSTM scan) at those of
               full-width xlstm-350m, and K5 (the SSM scan) at those of
               full-width hymba-1.5b, the scans from the empty state,
               from a nonzero state (at S 1024 and at S 1000, off the
               chunk) and for one decode step; K1, K2 and K3 also at
               hymba's heads (25 of dh 64 over 5 kv heads) with its
               window and ring cache, and K2 and K3 at chatglm3-6b's (32
               over 2 kv heads, G 16); K1 at the prefill shapes of
               full-width granite-moe-3b-a800m (24 heads over 8 of dh 64)
               and llava-next-mistral-7b (S 4096 under its 4096 window),
               K2 and K3 at granite's full cache (G 3), at llava's
               4096-slot ring and at deepseek-coder-33b's (G 7) and
               qwen1.5-32b's (G 1) heads; each held against its plain
               PyTorch version (K3 also against the transcription of its
               arithmetic); kernel, plain and library times, the
               card's bound for the same work, bound_frac (bound / kernel
               time) and vs_library (kernel / library time).
  4. model   — full-width qwen3-1.7b, xlstm-350m, hymba-1.5b,
               granite-moe-3b-a800m, llava-next-mistral-7b (B 4, S 4096:
               2880 patch embeddings, then 1216 tokens) and
               qwen3-moe-30b-a3b (8 of its 48 layers) (bf16, random
               weights from a seed): prefill + 4 decode steps through the
               kernels and through the plain versions; plus reduced f32
               configs (each attention model with kv_quant off and on,
               xlstm); granite's prefill run twice must give the same
               bits.
  5. serve   — three full-width qwen3-1.7b TorchEndpoints behind the
               port's MQFQ-Sticky wall-clock control plane answer 12
               requests with cold, warm and host_warm starts, then one
               kv_quant endpoint answers 3; then three full-width
               xlstm-350m endpoints, and three full-width hymba-1.5b
               endpoints, answer 12 requests each the same way. Each
               path's kernel launch counts are zeroed just before it and
               read just after; qwen's and hymba's must equal the counts
               computed from layers, requests and warm-ups. One warm
               request of each path, and one of the kv_quant endpoint,
               is profiled. Then three full-width granite-moe-3b-a800m
               endpoints and three full-width llava-next-mistral-7b
               endpoints (serve_seq 4096) answer 12 requests each, as
               qwen's do, with their launch counts checked and one warm
               request of each profiled; each model's endpoints are
               freed, host memory included, before the next's are built.
  6. the ``kernels`` line, the nvidia-smi line, and last
     ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import time
import types
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12                # H100 SXM f32 peak outside the tensor cores
# f32-accurate products on the tensor cores: 3xTF32 (each operand split
# into a TF32 high and low part, hi.hi + hi.lo + lo.hi) at a third of the
# 495 TFLOP/s TF32 peak; K4's bound, as the least time for its function at
# f32 accuracy whatever the design
TF32X3_FLOPS = 495e12 / 3
# kernel vs plain, bf16: the largest |difference| in a row of dh outputs
# over the largest |plain value| in that row, at most 2**-6 (two to four
# bf16 ulps of the row's largest value), so the check is as tight for the
# small outputs of long causal rows as for the large ones of short rows
BF16_ROW_REL_TOL = 2.0 ** -6
F32_MODEL_TOL = 1e-3             # reduced f32 model, kernels vs plain
BF16_MODEL_REL_TOL = 5e-2        # full bf16 model: max|dlogit| / max|logit|
# K4 vs plain, both f32 (only the summation order differs): the largest
# |difference| in a row over the row's largest |plain value|, for h and
# every leaf of the final state
SCAN_ROW_REL_TOL = 1e-4
# K5 vs plain: y and the float32 final state at SCAN_ROW_REL_TOL when x is
# float32; when x is bf16 (the model's case) y, rounded from float32 on
# both sides, at BF16_ROW_REL_TOL and the state still at SCAN_ROW_REL_TOL

# full-width qwen3-1.7b serving shapes (TorchEndpoint below)
SERVE_SEQ, SERVE_BATCH, DECODE_STEPS = 1024, 4, 16
# xlstm-350m at full width, cut to 4 of its 12 (mLSTM, sLSTM) pair
# blocks. With the reference's random initialisation the residual stream
# grows through each sLSTM block's gated FFN, which is quadratic in its
# un-normalised input: max |x| after pairs 1-11 at B=4, S=1024 was 3.6,
# 6.4, 9.4, 17, 54, 696, 1.2e5, 2.9e9, 2.1e18, 7.6e35, then inf (one H100
# run, seed 0), so the full stack's bf16 logits are NaN; at 4 pairs
# max |x| is 17.
XLSTM_LAYERS = 8
# hymba-1.5b runs at full width and all 32 layers: each block rms-normalises
# both branch outputs and the MLP input, and max |x| after each layer grows
# linearly, 4.6 after layer 1 to 28.5 after layer 32 (one H100 run, seed 0;
# the model phase prints it).
# HYBRID_MODEL_CHECK. At |x| of 16-28 a bf16 residual stream rounds to
# steps of 1/8, so a rounding flip anywhere spreads through the 32 layers:
# the bf16 plain model is itself 7.4% (max |dlogit| / max |logit|) from
# its float32 evaluation on the same weights and tokens (the model line's
# plain_bf16_to_f32; one H100 run, seed 0), more than BF16_MODEL_REL_TOL,
# so kernels vs plain in bf16 cannot be held to that limit. Full-width
# hymba is held instead (1) in float32, kernels vs plain under
# F32_MODEL_TOL (the kernels must compute the model's function at full
# size and depth), and (2) in bf16, the kernels' distance to the float32
# logits may exceed the plain versions' own by less than
# BF16_MODEL_REL_TOL.
# The MoE models are held the same way. Top-k routing is discontinuous,
# and with a random router the gap between a token's k-th and (k+1)-th
# router probability falls to 2e-8: at granite-moe-3b-a800m's full width in bf16,
# 118-870 of the 4096 prompt tokens a layer pick other experts in the
# kernels' prefill than in the plain one, and the capacity bound drops
# 1756-11201 of the 32768 pairs a layer (one expert is sent up to 3348
# for 1025 slots). Kernels vs plain were 5.4% over the prefill and 4
# decode steps; the plain bf16 prefill is itself 4.5% from its float32
# evaluation, the kernels' 6.8%, and in float32 kernels and plain agree
# to 5.4e-6 (one H100 run each, seed 0; ``scripts/moe_routing.py``).
POORLY_CONDITIONED = ("hybrid", "moe")


# chatglm3-6b's attention heads: G = 16 query heads per kv head, above
# the 8 a launch of K2 and K3
GLM_HEADS = types.SimpleNamespace(n_heads=32, n_kv_heads=2, head_dim=128)
# deepseek-coder-33b's (G 7) and qwen1.5-32b's (G 1, 40 kv heads) decode
# heads: at 66.7 and 70.4 GB of bf16 weights no serving run of either
# fits beside the others, so K2 and K3 are held at their heads alone
DEEPSEEK_HEADS = types.SimpleNamespace(n_heads=56, n_kv_heads=8,
                                       head_dim=128)
QWEN15_HEADS = types.SimpleNamespace(n_heads=40, n_kv_heads=40, head_dim=128)
# llava-next-mistral-7b serves prompts of 4096 positions: its 2880 patch
# embeddings (5 anyres tiles of 576), then 1216 tokens. Its ring cache is
# 4096 slots, its window's length, so the 16 decode steps overwrite
# exactly the positions the window drops.
LLAVA_SEQ = 4096
# qwen3-moe-30b-a3b at full width, cut to 8 of its 48 layers: its 60.2 GB
# of bf16 weights leave no room on the card for init_params' float32 draw
# of a stacked leaf (we1 at 48 layers is 38.7 GB in float32; at 8 layers
# 6.4 GB)
QWEN3_MOE_LAYERS = 8


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def host_ms(fn, arg_sets, iters: int = 20) -> float:
    """Mean ms per call between CUDA events around a loop of calls: the
    device time, or the host's launch time where that is longer; reported
    as ``host_ms`` beside the device time. Cycles through ``arg_sets`` so
    that consecutive calls read different inputs, more bytes in all than
    the 50 MB L2 cache holds."""
    for a in arg_sets:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profiled(fn, ranges=()):
    """Run ``fn()`` under torch.profiler; returns the device time (µs) of
    each GPU kernel or memory operation name it ran, and for each name in
    ``ranges`` (host µs, device µs, calls) summed over the ranges of that
    name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    spans = {r: [0.0, 0.0, 0] for r in ranges}
    for e in prof.events():
        if e.name in spans:
            if e.device_type != DeviceType.CPU:
                continue    # the range mirrored on the device timeline
            span = spans[e.name]
            span[0] += e.cpu_time_total
            span[1] += e.device_time_total
            span[2] += 1
        elif e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us()
    return by_name, {r: tuple(v) for r, v in spans.items()}


SPIN_CYCLES_PER_S = 2.0e9    # above the H100's top SM clock (1.98 GHz)
spin_retries = 0             # loops that needed a longer spin


def device_ms(fn, arg_sets, iters: int = 20) -> float:
    """Mean device time per call, over inputs cycled as in ``host_ms``.

    The device is held in a spin kernel while the host queues the whole
    loop between two CUDA events, so the events time the queued work run
    back to back, not the host's launch rate. The start event still
    pending once the loop is queued proves the device never waited for
    the host; otherwise the spin is lengthened and the loop run again, and
    after a few tries this raises."""
    global spin_retries
    for a in arg_sets:
        fn(*a)
    torch.cuda.synchronize()

    def loop():
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    t0 = time.perf_counter()
    loop()                       # the host's time to queue the loop
    queue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin_s = max(5e-3, 3 * queue_s)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(4):
        torch.cuda._sleep(int(spin_s * SPIN_CYCLES_PER_S))
        start.record()
        loop()
        end.record()
        ahead = not start.query()
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(end) / iters
        spin_s *= 4
        spin_retries += 1
    raise RuntimeError("device_ms: the host could not queue the loop "
                       "before the device reached it")


def n_sets(bytes_per_set: int) -> int:
    return max(2, math.ceil(128 * 2**20 / bytes_per_set))


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound_ms(n_bytes: float, n_flops: float, flops_per_s=BF16_FLOPS):
    tb = n_bytes / HBM_BYTES_PER_S * 1e3
    tf = n_flops / flops_per_s * 1e3
    return max(tb, tf), ("bytes" if tb >= tf else "operations")


def timing(ms, plain_ms, library_ms, b_ms, b_by) -> dict:
    """A kernel's times beside its bound: ``bound_frac`` = bound_ms / ms,
    ``vs_library`` = ms / library_ms (None without a library call)."""
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=b_ms, bound_by=b_by, bound_frac=b_ms / ms,
                vs_library=None if library_ms is None else ms / library_ms)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def row_rel_err(out, ref) -> float:
    """Largest, over rows of the last dim, of max|out - ref| in the row
    over max|ref| in the row."""
    d = (out.float() - ref.float()).abs().amax(-1)
    return float((d / ref.float().abs().amax(-1).clamp_min(1e-30)).max())


def check_kernel(name, out, ref, tol=BF16_ROW_REL_TOL, **case) -> dict:
    """Hold a kernel's output (a tensor, or a tuple of them) against its
    plain version's; raise past the tolerance."""
    outs, refs = (out, ref) if isinstance(out, tuple) else ((out,), (ref,))
    err = dict(max_abs_err=max(max_err(o, r) for o, r in zip(outs, refs)),
               max_row_rel_err=max(row_rel_err(o, r)
                                   for o, r in zip(outs, refs)),
               row_rel_tol=tol)
    if not err["max_row_rel_err"] <= tol:
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"{err} at {case}")
    return err


# --- phase 3: kernels against their plain versions ----------------------------

FLASH_CASES = [(SERVE_BATCH, SERVE_SEQ, 0), (SERVE_BATCH, SERVE_SEQ, 256),
               (2, 200, 0)]


def check_flash(fl, cfg, dev, cases=FLASH_CASES, model="qwen3-1.7b"):
    """K1 at the prefill shape (causal), with a window, and unaligned
    (``cases``: (B, S, window) each); returns the first case's numbers.
    The plain version is the model's plain prefill, which above 2048
    positions attends in query chunks (the reference's chunk rule)."""
    from repro_torch.models.transformer import prefill_attention_plain
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = torch.Generator(dev).manual_seed(1)
    mk = lambda B, S: tuple(
        torch.randn(B, S, n, dh, generator=g, device=dev,
                    dtype=torch.bfloat16) for n in (H, KV, KV))
    main = None
    for B, S, window in cases:
        q, k, v = mk(B, S)
        err = check_kernel("K1", fl.flash_attention(q, k, v, window=window),
                           prefill_attention_plain(q, k, v, window=window),
                           B=B, S=S, window=window)
        sets = [mk(B, S) for _ in range(n_sets(2 * nbytes(q, k, v)))]
        run = lambda q, k, v: fl.flash_attention(q, k, v, window=window)
        kern, kern_host = device_ms(run, sets), host_ms(run, sets)
        plain = device_ms(lambda q, k, v: prefill_attention_plain(
            q, k, v, window=window), sets, iters=4)
        qpos = torch.arange(S)
        kpos = torch.arange(S)
        valid = kpos[None, :] <= qpos[:, None]
        if window:
            valid &= kpos[None, :] > qpos[:, None] - window
        pairs = int(valid.sum())
        # q, k, v read once, the output (q's size) written once
        b_ms, b_by = bound_ms(nbytes(q, k, v) + nbytes(q),
                              4 * B * H * dh * pairs)
        lib = None
        if not window or window >= S:    # a window that masks nothing
            tsets = [tuple(t.transpose(1, 2).contiguous() for t in s)
                     for s in sets]
            lib = device_ms(lambda q, k, v: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), tsets)
        m = dict(**err, **timing(kern, plain, lib, b_ms, b_by))
        emit(phase="kernel", name="K1 flash_attention", model=model, B=B,
             S=S, H=H, KV=KV, dh=dh, window=window, host_ms=kern_host, **m)
        if main is None:
            main = m
    return main


DECODE_CASES = [("full", SERVE_SEQ + DECODE_STEPS - 1, False, 0),
                ("ring", 3 * SERVE_SEQ + 17, True, 256)]
# K3 at qwen3-1.7b's serving cache (a full cache, the query past its end)
QUANT_CASES = DECODE_CASES[:1]


def n_valid_slots(attn, pos, S, ring, window, dev) -> int:
    """The slots a query at ``pos`` attends to (the kernels' validity)."""
    sp = (attn.ring_slot_positions(pos + 1, S, dev) if ring
          else attn.full_slot_positions(pos, S, dev))
    valid = (sp >= 0) & (sp <= pos)
    if window:
        valid &= sp > pos - window
    return int(valid.sum())


def check_decode(dec, attn, cfg, dev, cases=DECODE_CASES,
                 quant_cases=QUANT_CASES, model="qwen3-1.7b", S=SERVE_SEQ):
    """K2 on a full cache (query past its end, as serving decodes) and on
    a ring cache with pos > S (``cases``: (label, pos, ring, window)
    each) of S slots; K3 on the int8 cache at ``quant_cases`` (the same
    form), held against its plain version and against the transcription
    of its arithmetic. Returns the first case's numbers of each."""
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    B = SERVE_BATCH
    g = torch.Generator(dev).manual_seed(2)
    r = lambda *s: torch.randn(*s, generator=g, device=dev,
                               dtype=torch.bfloat16)
    mk = lambda: (r(B, 1, H, dh), r(B, S, KV, dh), r(B, S, KV, dh))
    out = {}
    for label, pos, ring, window in cases:
        q, ck, cv = mk()
        err = check_kernel(
            "K2", dec.decode_attention(q, ck, cv, pos, window=window,
                                       ring=ring),
            dec.decode_attention_plain(q, ck, cv, pos, window=window,
                                       ring=ring), cache=label)
        sets = [mk() for _ in range(n_sets(nbytes(q, ck, cv)))]
        run = lambda q, k, v: dec.decode_attention(q, k, v, pos,
                                                   window=window, ring=ring)
        kern, kern_host = device_ms(run, sets), host_ms(run, sets)
        plain = device_ms(lambda q, k, v: dec.decode_attention_plain(
            q, k, v, pos, window=window, ring=ring), sets, iters=8)
        n_valid = n_valid_slots(attn, pos, S, ring, window, dev)
        # the valid slots' K/V read once, q read and the output written
        kv_bytes = 2 * B * n_valid * KV * dh * ck.element_size()
        b_ms, b_by = bound_ms(kv_bytes + 2 * nbytes(q),
                              4 * B * H * dh * n_valid)
        lib = None
        if n_valid == S:     # every slot attended: the order does not matter
            tsets = [(q.transpose(1, 2).contiguous(),
                      k.transpose(1, 2).contiguous(),
                      v.transpose(1, 2).contiguous()) for q, k, v in sets]
            lib = device_ms(lambda q, k, v: F.scaled_dot_product_attention(
                q, k, v, enable_gqa=True), tsets)
        m = dict(**err, **timing(kern, plain, lib, b_ms, b_by))
        emit(phase="kernel", name="K2 decode_attention", model=model,
             cache=label, B=B, S=S, H=H, KV=KV, dh=dh, pos=pos,
             window=window, valid_slots=n_valid, host_ms=kern_host, **m)
        out.setdefault("K2", m)

    def mk8():
        q, ck, cv = mk()
        k8, ks = attn.quantize_kv(ck)
        v8, vs = attn.quantize_kv(cv)
        return q, k8, ks, v8, vs
    for label, pos, ring, window in quant_cases:
        kw = dict(window=window, ring=ring)
        args = mk8()
        o = dec.decode_attention_quant(*args, pos, **kw)
        # the plain version dequantizes in f32 and keeps p in f32; the
        # kernel rounds p times the v scale to bf16, as the transcription
        # does
        err = check_kernel("K3", o, dec.decode_attention_quant_plain(
            *args, pos, **kw), cache=label)
        as_kernel = check_kernel("K3 vs as_kernel", o,
                                 dec.decode_attention_quant_as_kernel(
                                     *args, pos, **kw), cache=label)
        sets = [mk8() for _ in range(n_sets(nbytes(*args)))]
        run = lambda *a: dec.decode_attention_quant(*a, pos, **kw)
        kern, kern_host = device_ms(run, sets), host_ms(run, sets)
        plain = device_ms(lambda *a: dec.decode_attention_quant_plain(
            *a, pos, **kw), sets, iters=8)
        n_valid = n_valid_slots(attn, pos, S, ring, window, dev)
        # the valid slots' int8 K/V rows and their f32 scales read once, q
        # read and the output written
        kv_bytes = 2 * B * n_valid * KV * (dh + 4)
        b_ms, b_by = bound_ms(kv_bytes + 2 * nbytes(args[0]),
                              4 * B * H * dh * n_valid)
        m = dict(**err, **timing(kern, plain, None, b_ms, b_by))
        emit(phase="kernel", name="K3 decode_attention_quant", model=model,
             cache=f"{label} int8", B=B, S=S, H=H, KV=KV, dh=dh, pos=pos,
             window=window, valid_slots=n_valid,
             launches_per_call=dec.sub_groups(H // KV), host_ms=kern_host,
             row_rel_err_to_as_kernel=as_kernel["max_row_rel_err"], **m)
        out.setdefault("K3", m)
    return out


def check_mlstm(k4, cfg, dev):
    """K4 at the serving shapes of full-width xlstm-350m (f32, as the
    model casts): a prefill from the omitted state, one from a nonzero
    state (the first prefill's final state, as the model's prefill starts
    from a state), one from a state at S = 1000 (not a multiple of the
    chunk), and one decode step (S = 1) from that state; S >= k4.CHUNK
    takes the chunkwise kernels, S = 1 the step kernel. h and every leaf
    of the final state are held against the plain version. Returns the
    from-state prefill's numbers, the main path's shape."""
    H = cfg.n_heads
    dh = int(cfg.mlstm_proj_factor * cfg.d_model) // H
    B = SERVE_BATCH
    g = torch.Generator(dev).manual_seed(4)

    def mk(S):
        r = lambda *s: torch.randn(*s, generator=g, device=dev)
        # as tests/test_kernels.py::TestMlstmScan: q and k scaled by
        # dh^-0.5, forget gates shifted open by 2
        return (r(B, S, H, dh) * dh ** -0.5, r(B, S, H, dh) * dh ** -0.5,
                r(B, S, H, dh), r(B, S, H), r(B, S, H) + 2.0)
    first = mk(SERVE_SEQ)
    _, state = k4.mlstm_scan_plain(*first)
    main = None
    for label, S, st in [("prefill, no state", SERVE_SEQ, None),
                         ("prefill from state", SERVE_SEQ, state),
                         ("prefill from state, S 1000", 1000, state),
                         ("decode from state", 1, state)]:
        args = first if st is None else mk(S)
        h, fin = k4.mlstm_scan(*args, st)
        ph, pfin = k4.mlstm_scan_plain(*args, st)
        err = check_kernel("K4", (h,) + fin, (ph,) + pfin,
                           tol=SCAN_ROW_REL_TOL, case=label)
        in_bytes = nbytes(*args) + (nbytes(*st) if st is not None else 0)
        out_bytes = nbytes(h, *fin)
        sets = [mk(S) + (st,) for _ in range(n_sets(in_bytes + out_bytes))]
        kern = device_ms(k4.mlstm_scan, sets)
        kern_host = host_ms(k4.mlstm_scan, sets)
        # the plain prefill is ~15 launches per step: 15k per call
        # overflow the launch queue that device_ms fills behind its spin,
        # so it is timed by CUDA events around the calls without the spin
        # (the larger of its device and host time)
        plain = (device_ms(k4.mlstm_scan_plain, sets, iters=8) if S == 1
                 else host_ms(k4.mlstm_scan_plain, sets, iters=2))
        # per step and (batch, head) the chunkwise form's two dh x dh
        # products (4 dh^2 flops) at f32 accuracy on the tensor cores
        # (3xTF32); beside it the step form's f C, + i v k^T and C q
        # (5 dh^2) and n's update and n . q (5 dh) on the f32 CUDA cores,
        # the bound of PRs 13-15
        b_ms, b_by = bound_ms(in_bytes + out_bytes, 4 * B * H * S * dh * dh,
                              TF32X3_FLOPS)
        f32_ms, f32_by = bound_ms(in_bytes + out_bytes,
                                  B * H * S * (5 * dh * dh + 5 * dh),
                                  F32_FLOPS)
        m = dict(**err, **timing(kern, plain, None, b_ms, b_by))
        emit(phase="kernel", name="K4 mlstm_scan", case=label, B=B, S=S,
             H=H, dh=dh, path="chunks" if k4.uses_chunks(S) else "steps",
             host_ms=kern_host, plain_timing=(
                 "device_ms" if S == 1 else "host_ms"),
             bound_ms_f32_cuda_cores=f32_ms, bound_by_f32_cuda_cores=f32_by,
             **m)
        if label == "prefill from state":
            main = m
    return main


def check_ssm(k5, cfg, dev):
    """K5 at the serving shapes of full-width hymba-1.5b, with x, a_log and
    d_skip in the model's bf16: a prefill from the omitted state, one from
    a nonzero state (the first prefill's final state; the model's prefill
    starts from its cache's state), one from a state at S = 1000 (not a
    multiple of the chunk) and one decode step (S = 1) from that state;
    then the prefill from a state with x, a_log and d_skip in f32.
    S >= k5.CHUNK takes the chunked kernels, S = 1 the step kernel.
    y and the final state are held against the plain version. a_log,
    d_skip and dt are drawn from a seed, so every head has its own A and D.
    Returns the bf16 prefill from a state's numbers, the main path's
    shape."""
    Hs, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    B = SERVE_BATCH
    g = torch.Generator(dev).manual_seed(5)

    def mk(S, dtype):
        # as tests/test_kernels.py::TestSsmScan: normal x, b, c, d_skip,
        # dt = softplus(normal), a_log = 0.3 * normal
        r = lambda *s: torch.randn(*s, generator=g, device=dev)
        return (r(B, S, Hs, P).to(dtype), F.softplus(r(B, S, Hs)),
                (r(Hs) * 0.3).to(dtype), r(B, S, N), r(B, S, N),
                r(Hs).to(dtype))
    bf16 = torch.bfloat16
    first = mk(SERVE_SEQ, bf16)
    _, state = k5.ssm_scan_plain(*first)
    main = None
    for label, S, st, dtype in [
            ("prefill, no state", SERVE_SEQ, None, bf16),
            ("prefill from state", SERVE_SEQ, state, bf16),
            ("prefill from state, S 1000", 1000, state, bf16),
            ("decode from state", 1, state, bf16),
            ("prefill from state, f32", SERVE_SEQ, state, torch.float32)]:
        args = first if st is None else mk(S, dtype)
        y, fin = k5.ssm_scan(*args, st)
        py, pfin = k5.ssm_scan_plain(*args, st)
        y_tol = BF16_ROW_REL_TOL if dtype == bf16 else SCAN_ROW_REL_TOL
        err_y = check_kernel("K5 y", y, py, tol=y_tol, case=label)
        err_s = check_kernel("K5 state", fin, pfin, tol=SCAN_ROW_REL_TOL,
                             case=label)
        in_bytes = nbytes(*args) + (nbytes(st) if st is not None else 0)
        out_bytes = nbytes(y, fin)
        sets = [mk(S, dtype) + (st,)
                for _ in range(n_sets(in_bytes + out_bytes))]
        kern = device_ms(k5.ssm_scan, sets)
        kern_host = host_ms(k5.ssm_scan, sets)
        # the plain prefill is ~10 launches per step, as K4's plain scan:
        # CUDA events around the calls without the spin
        plain = (device_ms(k5.ssm_scan_plain, sets, iters=8) if S == 1
                 else host_ms(k5.ssm_scan_plain, sets, iters=2))
        # per step and state element: S * decay, + u b, S . c (5 flops);
        # per step and row: u = dt x and the D skip (3); f32 CUDA cores
        b_ms, b_by = bound_ms(in_bytes + out_bytes,
                              B * S * Hs * P * (5 * N + 3), F32_FLOPS)
        m = dict(max_abs_err=max(err_y["max_abs_err"], err_s["max_abs_err"]),
                 **timing(kern, plain, None, b_ms, b_by))
        emit(phase="kernel", name="K5 ssm_scan", case=label, B=B, S=S,
             Hs=Hs, P=P, N=N, x_dtype=str(dtype).split(".")[-1],
             path="chunks" if k5.uses_chunks(S) else "steps",
             y_row_rel_err=err_y["max_row_rel_err"], y_row_rel_tol=y_tol,
             state_row_rel_err=err_s["max_row_rel_err"],
             state_row_rel_tol=SCAN_ROW_REL_TOL, host_ms=kern_host,
             plain_timing="device_ms" if S == 1 else "host_ms", **m)
        if label == "prefill from state":
            main = m
    return main


# --- phase 4: the model through the kernels and the plain versions ------------

def perturb_ssm(params, seed):
    """a_log, d_skip and dt_bias of a hybrid model drawn from a seed, every
    layer and head apart: the reference's initialisation makes them 0, 1
    and 0, so every head would have A = -1 and D = 1."""
    layers = params["layers"]
    g = torch.Generator(layers["a_log"].device).manual_seed(seed)
    for name, scale, shift in [("a_log", 0.3, 0.0), ("d_skip", 1.0, 0.0),
                               ("dt_bias", 0.5, -0.5)]:
        t = layers[name]
        t.copy_(torch.randn(t.shape, generator=g, device=t.device) * scale
                + shift)


def layer_max_abs(transformer, run):
    """``run()`` with ``transformer.block_apply`` wrapped so that each
    call's output max |x| is recorded; returns them in call order."""
    block_apply = transformer.block_apply
    seen = []

    def recorded(*a, **kw):
        x = block_apply(*a, **kw)
        seen.append(x)
        return x
    transformer.block_apply = recorded
    try:
        run()
    finally:
        transformer.block_apply = block_apply
    return [float(x.float().abs().max()) for x in seen]


def trajectory(model, params, batch, plan, steps, feed=None):
    """Float32 logits (steps + 1, B, vocab) of a prefill of ``batch`` and
    ``steps`` decode steps, each fed ``feed[:, i]`` or, without ``feed``,
    the greedy token; returns them and the tokens fed."""
    S = model.decode_start(batch)
    logits, fed = [], []
    with torch.inference_mode():
        lg, cache = model.prefill_fn(params, batch, plan.length, plan.ring)
        for i in range(steps + 1):
            logits.append(lg.float())
            if i == steps:
                break
            tok = (feed[:, i:i + 1] if feed is not None
                   else torch.argmax(lg, -1)[:, None].to(torch.int32))
            fed.append(tok)
            lg, cache = model.decode_fn(params, cache, tok, S + i, plan.ring)
    return torch.stack(logits), torch.cat(fed, dim=1)


def run_model(cfg, dev, B, S, steps, seed, f32_truth=False,
              twice=False):
    """Prefill + ``steps`` greedy decode steps through the kernels, then
    the same tokens through the plain versions. Returns the largest logit
    difference, the largest |logit|, their ratio, and the fraction of
    greedy tokens that agree; for a hybrid model the max |x| after each
    layer of the kernels' prefill. A VLM's prompt of S positions is its
    n_patches patch embeddings (N(0, 1) * 0.02), then S - n_patches
    tokens. With ``f32_truth``, the same weights and tokens also go
    through the kernels and the plain versions in float32: their largest
    logit difference, and each bf16 path's largest logit difference to
    the float32 plain logits over their largest |logit|. With ``twice``,
    the kernels' prefill runs twice more on the same batch, and whether
    the two runs' logits and caches have the same bits."""
    from repro_torch.models import build_model, decode_cache_plan
    from repro_torch.models import transformer
    from repro_torch.models.common import tree_map
    from repro_torch.models.transformer import PLAIN_OPS
    from repro_torch.models.xlstm import PLAIN_SCAN_OPS
    kern_model = build_model(cfg)
    plain_model = build_model(cfg, PLAIN_OPS, PLAIN_SCAN_OPS)
    params = kern_model.init_params(torch.Generator(dev).manual_seed(seed),
                                    dev)
    if cfg.family == "hybrid":
        perturb_ssm(params, seed + 1)
    g = torch.Generator(dev).manual_seed(seed)
    n_p = cfg.n_patches if cfg.family == "vlm" else 0
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S - n_p),
                                     device=dev, generator=g)}
    if n_p:
        batch["patch_embeds"] = (torch.randn(B, n_p, cfg.d_model, device=dev,
                                             generator=g) * 0.02
                                 ).to(cfg.compute_dtype)
    plan = decode_cache_plan(cfg, S)
    out = {}
    if cfg.family == "hybrid":
        with torch.inference_mode():
            out["max_abs_x_per_layer"] = layer_max_abs(
                transformer, lambda: kern_model.prefill_fn(
                    params, batch, plan.length, plan.ring))
    if twice:
        with torch.inference_mode():
            runs = [kern_model.prefill_fn(params, batch, plan.length,
                                          plan.ring) for _ in range(2)]
        (l1, c1), (l2, c2) = runs
        out["prefill_twice_bitwise_equal"] = bool(
            torch.equal(l1.view(torch.int16), l2.view(torch.int16))
            and all(torch.equal(c1[n].view(torch.uint8),
                                c2[n].view(torch.uint8)) for n in c1))
        del runs, l1, c1, l2, c2
    lk, fed = trajectory(kern_model, params, batch, plan, steps)
    if not bool(torch.isfinite(lk).all()):
        raise AssertionError("non-finite logits")
    if lk.shape != (steps + 1, B, cfg.vocab_size):
        raise AssertionError(f"logits shape {tuple(lk.shape)}")
    lp, _ = trajectory(plain_model, params, batch, plan, steps, fed)
    top = float(lp.abs().max())
    out.update(max_logit_diff=max_err(lk, lp), max_abs_logit=top,
               rel=max_err(lk, lp) / max(top, 1e-30),
               greedy_agree=float((lk.argmax(-1) == lp.argmax(-1))
                                  .float().mean()))
    if f32_truth:
        cfg32 = dataclasses.replace(cfg, dtype="float32",
                                    param_dtype="float32")
        p32 = tree_map(lambda t: t.float(), params)
        del params
        tk, _ = trajectory(build_model(cfg32), p32, batch, plan, steps, fed)
        tp, _ = trajectory(build_model(cfg32, PLAIN_OPS, PLAIN_SCAN_OPS),
                           p32, batch, plan, steps, fed)
        ttop = max(float(tp.abs().max()), 1e-30)
        out.update(f32_max_logit_diff=max_err(tk, tp),
                   kernels_bf16_to_f32=max_err(lk, tp) / ttop,
                   plain_bf16_to_f32=max_err(lp, tp) / ttop)
    torch.cuda.synchronize()
    return out


# --- phase 5: serving -----------------------------------------------------------

def serve(endpoints, bursts, capacity_bytes):
    """Submit ``bursts`` (lists of endpoint ids) to a wall-clock
    MQFQ-Sticky server, draining after each burst; returns the RunResult."""
    from repro_torch.server import ServerConfig, make_server
    server = make_server(ServerConfig(executor="wallclock",
                                      policy="mqfq-sticky", d=2,
                                      capacity_bytes=capacity_bytes),
                         endpoints=endpoints)
    server.start()
    try:
        i = 0
        for burst in bursts:
            for fn in burst:
                server.submit(fn, {"seed": i})
                i += 1
            server.drain(timeout=600)
    finally:
        res = server.stop()
    return res


def bursts(prefix):
    """Requests of a serving run over three functions ``prefix-0..2``: a
    burst of three requests for one function on d=2 makes the third wait
    for a token and reuse a finished request's container while the flow
    is still active (a warm start); a third function past two weights'
    capacity evicts, and returning to an evicted function gives a
    host_warm start."""
    f = [f"{prefix}-{i}" for i in range(3)]
    return [[f[0]] * 3, [f[1]] * 3, [f[2]] * 3, [f[0]] * 2, [f[1]]]


BURSTS = bursts("qwen")
XLSTM_BURSTS = bursts("xlstm")
HYMBA_BURSTS = bursts("hymba")
GEMM_NAME = re.compile(r"gemm|nvjet|cutlass|xmma|cublas", re.I)


def profile_request(ep, ranges=None):
    """One warm request of ``ep`` under torch.profiler: wall time, the
    device's busy time (summed kernel and memory-operation durations; one
    stream, so they do not overlap), its idle share, and the kernels that
    took the most device time. ``ranges`` maps a label to (module, name)
    of a function that the request calls through its module: each call
    is then wrapped in a profiler range of that label, and the range's
    host time (wall time inside the calls) and device time (of the
    kernels launched inside) are reported. The same request runs once
    unprofiled first, so the profiler's own cost shows."""
    from torch.profiler import record_function
    ranges = ranges or {}
    saved = {label: getattr(mod, fn) for label, (mod, fn) in ranges.items()}

    def labelled(label, f):
        def wrapped(*a, **kw):
            with record_function(label):
                return f(*a, **kw)
        return wrapped
    with ep.lock:
        if not ep.resident:
            ep.upload()
        t0 = time.monotonic()
        ep.execute({"seed": 99})            # the same request, unprofiled
        wall_off = time.monotonic() - t0
        wall = []

        def request():
            t0 = time.monotonic()
            ep.execute({"seed": 99})        # ends in a synchronize
            wall.append(time.monotonic() - t0)
        for label, (mod, fn) in ranges.items():
            setattr(mod, fn, labelled(label, saved[label]))
        try:
            by_name, spans = profiled(request, tuple(ranges))
        finally:
            for label, (mod, fn) in ranges.items():
                setattr(mod, fn, saved[label])
    wall = wall[0]
    if not by_name:
        # the trace came back without the device's activity: say so
        # rather than report an idle device
        return dict(request_wall_s=wall, device_busy_s=None,
                    request_wall_unprofiled_s=wall_off,
                    idle_share=None, top_kernels_ms=None,
                    note="torch.profiler recorded no device time")
    busy = sum(by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = dict(request_wall_s=wall, request_wall_unprofiled_s=wall_off,
               device_busy_s=busy,
               idle_share=1.0 - busy / wall,
               top_kernels_ms=[[n[:90], us / 1e3] for n, us in top],
               gemm_device_ms=sum(us for n, us in by_name.items()
                                  if GEMM_NAME.search(n)) / 1e3)
    for label, (host_us, dev_us, calls) in spans.items():
        out[label] = dict(calls=calls, host_s=host_us / 1e6,
                          host_share=host_us / 1e6 / wall,
                          device_ms=dev_us / 1e3)
    return out


def ptxas_summary(name: str) -> dict:
    """Most registers any kernel of a source uses, its spilled bytes, and
    each kernel's [registers, spill bytes], from the build's ``-Xptxas -v``
    log."""
    from repro_torch.kernels import _build
    path = _build.BUILD / f"{name}.log"
    if not path.exists():       # built by an earlier run
        return {}
    log = path.read_text()
    regs = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill", log)]
    per = {}
    for part in re.split(r"Compiling entry function '", log)[1:]:
        mangled = part.split("'", 1)[0]
        used = re.search(r"Used (\d+) registers", part)
        spill = sum(int(n) for n in re.findall(r"(\d+) bytes spill", part))
        per[mangled] = [int(used.group(1)) if used else None, spill]
    names = demangle(list(per))
    return dict(max_registers=max(regs, default=None),
                spill_bytes=sum(spills),
                kernels={names[m]: v for m, v in per.items()})


def demangle(mangled):
    """Short readable kernel names ("flash_fwd_bf16<128>") by c++filt,
    the mangled names where it is missing."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(mangled),
                             capture_output=True, text=True, check=True,
                             timeout=60).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        return {m: m for m in mangled}
    short = [n.split("(anonymous namespace)::")[-1].split("(")[0]
             for n in out]
    return dict(zip(mangled, short)) if len(short) == len(mangled) else \
        {m: m for m in mangled}


def model_phase(cfg, dev, name, S=SERVE_SEQ, twice=False, **line):
    """The full-width bf16 model at S positions (kernels against plain,
    relative logit limit; a hybrid or MoE model as HYBRID_MODEL_CHECK
    says) and its reduced f32 configs (absolute limit, greedy tokens all
    equal).
    With ``twice``, the full-width kernels' prefill, run twice on the
    same batch, must give the same bits. ``line`` goes on the full-width
    model's line (a depth cut and its reason)."""
    t0 = time.monotonic()
    by_f32 = cfg.family in POORLY_CONDITIONED
    r = run_model(cfg, dev, SERVE_BATCH, S, 4, seed=0, f32_truth=by_f32,
                  twice=twice)
    emit(phase="model", config=f"{name} full width bf16",
         n_layers=cfg.n_layers, B=SERVE_BATCH, S=S, decode_steps=4,
         rel_tol=BF16_MODEL_REL_TOL, seconds=time.monotonic() - t0,
         **line, **r)
    if twice and not r["prefill_twice_bitwise_equal"]:
        raise AssertionError(f"full-width {name}: two prefills of one "
                             f"batch differ")
    if by_f32:
        excess = r["kernels_bf16_to_f32"] - r["plain_bf16_to_f32"]
        if r["f32_max_logit_diff"] >= F32_MODEL_TOL \
                or excess >= BF16_MODEL_REL_TOL:
            raise AssertionError(f"full-width {name}: {r}")
    elif r["rel"] >= BF16_MODEL_REL_TOL:
        raise AssertionError(f"full-width {name}: kernels vs plain logits "
                             f"differ by {r['max_logit_diff']} (max |logit| "
                             f"{r['max_abs_logit']})")
    kv_cache = cfg.family != "ssm"
    # hymba's and llava's reduced window is 64: at S = 96 their prefill
    # masks by the window and their decode wraps the ring
    S_small = 96 if cfg.sliding_window else 64
    for kv_quant in ([False, True] if kv_cache else [None]):
        small = cfg.reduced()
        label = f"{name} reduced f32"
        if kv_quant is not None:
            small = dataclasses.replace(small, kv_quant=kv_quant)
            label += f" kv_quant={kv_quant}"
        r = run_model(small, dev, 2, S_small, 4, seed=1)
        diff, agree = r["max_logit_diff"], r["greedy_agree"]
        emit(phase="model", config=label, S=S_small, max_logit_diff=diff,
             tol=F32_MODEL_TOL, greedy_agree=agree)
        if diff >= F32_MODEL_TOL or agree != 1.0:
            raise AssertionError(f"{label}: logit diff {diff}, agree "
                                 f"{agree}")


def endpoints(TorchEndpoint, cfg, prefix, dev, seeds, serve_seq=SERVE_SEQ):
    return {f"{prefix}-{i}": TorchEndpoint(
        f"{prefix}-{i}", cfg, seed=s, serve_seq=serve_seq,
        serve_batch=SERVE_BATCH, decode_steps=DECODE_STEPS, device=dev)
        for i, s in enumerate(seeds)}


def release_memory() -> None:
    """Return freed device memory and the pinned host blocks that the
    caching host allocator keeps after endpoints are freed (it rounds a
    block up to a power of two and holds it for reuse), so that the next
    model's endpoints find the host's memory free."""
    gc.collect()
    torch.cuda.empty_cache()
    torch._C._host_emptyCache()


def pinned_host_bytes() -> dict:
    """Pinned host bytes the caching host allocator holds now, in its
    rounded blocks (its ``allocated_bytes`` counters)."""
    return {k: v for k, v in torch.cuda.host_memory_stats().items()
            if k.startswith("allocated_bytes") and k.endswith("current")}


def serve_attention_model(TorchEndpoint, cfg, name, prefix, dev, wrappers,
                          ranges, serve_seq=SERVE_SEQ):
    """Three full-width endpoints of an attention model behind the
    MQFQ-Sticky wall-clock server, each kernel's count zeroed just
    before and read just after, as qwen's path is driven: K1 once a
    layer for each prefill, K2 once a layer for each decode step, K3
    never; each endpoint's compile() runs a prefill and one step. Then
    one warm request profiled with ``ranges``. Frees the endpoints and
    returns the launch counts."""
    t0 = time.monotonic()
    eps = endpoints(TorchEndpoint, cfg, prefix, dev, range(3), serve_seq)
    weight_bytes = eps[f"{prefix}-0"].weight_bytes
    emit(phase="endpoints", model=name, n=3, weight_bytes=weight_bytes,
         pinned_weight_bytes=3 * weight_bytes,
         host_allocator_pinned_bytes=pinned_host_bytes(),
         cache_plan=str(eps[f"{prefix}-0"].plan), serve_seq=serve_seq,
         seconds=time.monotonic() - t0)
    for w in wrappers.values():
        w.launches = 0
    t0 = time.monotonic()
    burst = bursts(prefix)
    res = serve(eps, burst, 2 * weight_bytes)
    seconds = time.monotonic() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    n_req = sum(len(b) for b in burst)
    L, n_warm = cfg.n_layers, len(eps)
    expected = {"K1": L * (n_req + n_warm),
                "K2": L * (DECODE_STEPS * n_req + n_warm), "K3": 0}
    emit(phase="serve", model=name, serve_seq=serve_seq,
         **serve_summary(res, eps, seconds, n_req), launches=launches,
         expected_launches=expected)
    check_served(res, n_req, {k: launches[k] for k in ("K1", "K2")})
    if launches != expected:
        raise AssertionError(f"{name} launches {launches}, expected "
                             f"{expected}")
    emit(phase="profile", endpoint=f"{prefix}-0", profiler_on=True,
         **profile_request(eps[f"{prefix}-0"], ranges))
    del eps, res
    release_memory()
    return launches


def check_served(res, n_req, launches,
                 start_types=("cold", "warm", "host_warm")):
    """Every request completed, without failure, with each of
    ``start_types``; every kernel of the path launched."""
    if len(res.invocations) != n_req:
        raise AssertionError("not every invocation completed")
    if any(inv.completion is None or inv.failed for inv in res.invocations):
        raise AssertionError("an invocation failed")
    starts = res.start_type_counts()
    for kind in start_types:
        if starts.get(kind, 0) < 1:
            raise AssertionError(f"no {kind} start: {starts}")
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"{name} was never launched while serving")


def serve_summary(res, eps, seconds, n_req):
    lats = sorted(inv.latency for inv in res.invocations)
    toks = DECODE_STEPS * SERVE_BATCH * n_req
    return dict(requests=n_req, completed=len(res.invocations),
                start_types=res.start_type_counts(),
                uploads={f: e.uploads for f, e in eps.items()},
                seconds=seconds, tokens_per_s=toks / seconds,
                p50_latency_s=lats[len(lats) // 2], max_latency_s=lats[-1])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script drives the "
              "port on an NVIDIA GPU", file=sys.stderr)
        return 1
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.flash_attention import ops as fl
    from repro_torch.kernels.mlstm_scan import ops as k4
    from repro_torch.kernels.ssm_scan import ops as k5
    from repro_torch.models import attention as attn
    from repro_torch.models import moe, ssm, transformer, xlstm
    from repro_torch.runtime.device import TorchEndpoint

    t_start = time.monotonic()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    print(smi, flush=True)
    emit(phase="device", kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.monotonic()
    secs = _build.build_all()
    ptxas = {n: ptxas_summary(n) for n in secs}
    emit(phase="build", seconds=time.monotonic() - t0, per_source=secs,
         ptxas=ptxas,
         # no kernel is expected to spill: any that does is named here
         spilling=[k for p in ptxas.values()
                   for k, (_, sp) in p.get("kernels", {}).items() if sp])

    cfg = get_config("qwen3-1.7b")   # bf16, full width
    xcfg = dataclasses.replace(get_config("xlstm-350m"),
                               n_layers=XLSTM_LAYERS)   # bf16, full width
    hcfg = get_config("hymba-1.5b")  # bf16, full width, all 32 layers
    k1 = check_flash(fl, cfg, dev)
    k23 = check_decode(dec, attn, cfg, dev)
    k4m = check_mlstm(k4, xcfg, dev)
    k5m = check_ssm(k5, hcfg, dev)
    # hymba's attention: prefill under its 1024 window, decode on its
    # 1024-slot ring after the 16 serving steps (pos 1024 + 15)
    window = hcfg.sliding_window
    check_flash(fl, hcfg, dev, [(SERVE_BATCH, SERVE_SEQ, window)],
                model="hymba-1.5b")
    ring_case = [("ring", SERVE_SEQ + DECODE_STEPS - 1, True, window)]
    check_decode(dec, attn, hcfg, dev, ring_case, ring_case,
                 model="hymba-1.5b")
    # K2 and K3 at chatglm3-6b's decode heads (src/repro/configs/
    # chatglm3_6b.py: 32 query heads over 2 kv heads of dh 128, G 16),
    # which the wrappers run as two launches of 8 query heads per kv head
    check_decode(dec, attn, GLM_HEADS, dev, QUANT_CASES, QUANT_CASES,
                 model="chatglm3-6b")
    # granite-moe-3b-a800m: prefill (24 heads over 8 of dh 64, causal) and
    # its full serving cache (G 3); llava-next-mistral-7b: prefill of 4096
    # positions under its 4096 window, decode on its 4096-slot ring after
    # the 16 serving steps (pos 4096 + 15); deepseek-coder-33b's (G 7) and
    # qwen1.5-32b's (G 1) heads on qwen's full cache
    gcfg = get_config("granite-moe-3b-a800m")    # bf16, full width
    lcfg = get_config("llava-next-mistral-7b")   # bf16, full width
    check_flash(fl, gcfg, dev, [(SERVE_BATCH, SERVE_SEQ, 0)],
                model="granite-moe-3b-a800m")
    check_flash(fl, lcfg, dev, [(SERVE_BATCH, LLAVA_SEQ, lcfg.sliding_window)],
                model="llava-next-mistral-7b")
    check_decode(dec, attn, gcfg, dev, QUANT_CASES, QUANT_CASES,
                 model="granite-moe-3b-a800m")
    llava_ring = [("ring", LLAVA_SEQ + DECODE_STEPS - 1, True,
                   lcfg.sliding_window)]
    check_decode(dec, attn, lcfg, dev, llava_ring, llava_ring,
                 model="llava-next-mistral-7b", S=LLAVA_SEQ)
    check_decode(dec, attn, DEEPSEEK_HEADS, dev, QUANT_CASES, QUANT_CASES,
                 model="deepseek-coder-33b")
    check_decode(dec, attn, QWEN15_HEADS, dev, QUANT_CASES, QUANT_CASES,
                 model="qwen1.5-32b")

    model_phase(cfg, dev, "qwen3-1.7b")
    model_phase(xcfg, dev, "xlstm-350m")
    model_phase(hcfg, dev, "hymba-1.5b")
    model_phase(gcfg, dev, "granite-moe-3b-a800m", twice=True)
    model_phase(lcfg, dev, "llava-next-mistral-7b", S=LLAVA_SEQ)
    model_phase(dataclasses.replace(get_config("qwen3-moe-30b-a3b"),
                                    n_layers=QWEN3_MOE_LAYERS),
                dev, "qwen3-moe-30b-a3b",
                cut=f"{QWEN3_MOE_LAYERS} of 48 layers: 60.2 GB of bf16 "
                    f"weights leave no room for the float32 draw of a "
                    f"stacked leaf")
    release_memory()

    # -- the main path: serving, through the kernels -------------------------
    t0 = time.monotonic()
    eps = endpoints(TorchEndpoint, cfg, "qwen", dev, range(3))
    qcfg = dataclasses.replace(cfg, kv_quant=True)
    qep = endpoints(TorchEndpoint, qcfg, "qwen-q8", dev, [3])
    weight_bytes = eps["qwen-0"].weight_bytes
    emit(phase="endpoints", n=4, weight_bytes=weight_bytes,
         seconds=time.monotonic() - t0)

    wrappers = {"K1": fl.flash_attention, "K2": dec.decode_attention,
                "K3": dec.decode_attention_quant}
    for w in wrappers.values():
        w.launches = 0
    t0 = time.monotonic()
    res = serve(eps, BURSTS, 2 * weight_bytes)
    t_main = time.monotonic() - t0
    qres = serve(qep, [["qwen-q8-0"], ["qwen-q8-0", "qwen-q8-0"]],
                 2 * weight_bytes)
    launches = {k: w.launches for k, w in wrappers.items()}

    n_req = sum(len(b) for b in BURSTS)
    n_q8 = len(qres.invocations)
    # per layer: one K1 launch for each prefill, one K2 (K3 on the int8
    # endpoint) for each decode step; each endpoint's compile() runs a
    # prefill and one step
    L = cfg.n_layers
    expected = {"K1": L * (n_req + n_q8 + len(eps) + len(qep)),
                "K2": L * (DECODE_STEPS * n_req + len(eps)),
                "K3": L * (DECODE_STEPS * n_q8 + len(qep))}
    emit(phase="serve", model="qwen3-1.7b",
         **serve_summary(res, eps, t_main, n_req),
         kv_quant_completed=n_q8,
         kv_quant_start_types=qres.start_type_counts(), launches=launches,
         expected_launches=expected)
    check_served(qres, 3, {}, start_types=())
    check_served(res, n_req, launches)
    if launches != expected:
        raise AssertionError(f"qwen launches {launches}, expected "
                             f"{expected}")

    emit(phase="profile", endpoint="qwen-0", profiler_on=True,
         **profile_request(eps["qwen-0"]))
    emit(phase="profile", endpoint="qwen-q8-0", profiler_on=True,
         **profile_request(qep["qwen-q8-0"]))
    del eps, qep, res, qres
    release_memory()

    # -- the xLSTM path: serving, through K4 ---------------------------------
    t0 = time.monotonic()
    xeps = endpoints(TorchEndpoint, xcfg, "xlstm", dev, range(3))
    x_weight_bytes = xeps["xlstm-0"].weight_bytes
    emit(phase="endpoints", model="xlstm-350m", n=3,
         weight_bytes=x_weight_bytes, seconds=time.monotonic() - t0)
    k4.mlstm_scan.launches = 0
    t0 = time.monotonic()
    xres = serve(xeps, XLSTM_BURSTS, 2 * x_weight_bytes)
    t_x = time.monotonic() - t0
    launches["K4"] = k4.mlstm_scan.launches
    n_xreq = sum(len(b) for b in XLSTM_BURSTS)
    P = xcfg.n_layers // 2
    emit(phase="serve", model="xlstm-350m",
         **serve_summary(xres, xeps, t_x, n_xreq),
         launches={"K4": launches["K4"]},
         # one wrapper call per pair block for the prefill and for each
         # decode step; each endpoint's compile() runs a prefill and one
         # step. A prefill call (S >= k4.CHUNK) is two kernel launches,
         # the chunkwise path's; a decode call one, the step kernel
         expected_k4_launches=f"{P} x (1 + {DECODE_STEPS}) per request + "
                              f"{P} x 2 per endpoint warm-up")
    check_served(xres, n_xreq, {"K4": launches["K4"]})

    emit(phase="profile", endpoint="xlstm-0", profiler_on=True,
         **profile_request(xeps["xlstm-0"], {
             "slstm": (xlstm, "slstm_apply"),
             "mlstm": (xlstm, "mlstm_apply")}))
    del xeps, xres
    release_memory()

    # -- the hymba path: serving, through K1 (window), K2 (ring) and K5 -------
    t0 = time.monotonic()
    heps = endpoints(TorchEndpoint, hcfg, "hymba", dev, range(3))
    h_weight_bytes = heps["hymba-0"].weight_bytes
    emit(phase="endpoints", model="hymba-1.5b", n=3,
         weight_bytes=h_weight_bytes, cache_plan=str(heps["hymba-0"].plan),
         seconds=time.monotonic() - t0)
    h_wrappers = {"K1": fl.flash_attention, "K2": dec.decode_attention,
                  "K3": dec.decode_attention_quant, "K5": k5.ssm_scan}
    for w in h_wrappers.values():
        w.launches = 0
    t0 = time.monotonic()
    hres = serve(heps, HYMBA_BURSTS, 2 * h_weight_bytes)
    t_h = time.monotonic() - t0
    h_launches = {k: w.launches for k, w in h_wrappers.items()}
    launches["K5"] = h_launches["K5"]
    n_hreq = sum(len(b) for b in HYMBA_BURSTS)
    # per layer: one K1 and one K5 call for the prefill, one K2 and one
    # K5 call for each decode step; each endpoint's compile() runs a
    # prefill and one step. A K5 prefill call (S >= k5.CHUNK) is three
    # kernel launches, the chunked path's; a decode call one
    L, n_warm = hcfg.n_layers, len(heps)
    expected = {"K1": L * (n_hreq + n_warm),
                "K2": L * (DECODE_STEPS * n_hreq + n_warm),
                "K3": 0,
                "K5": L * (1 + DECODE_STEPS) * n_hreq + L * 2 * n_warm}
    emit(phase="serve", model="hymba-1.5b",
         **serve_summary(hres, heps, t_h, n_hreq), launches=h_launches,
         expected_launches=expected)
    check_served(hres, n_hreq, {k: h_launches[k] for k in ("K1", "K2",
                                                           "K5")})
    if h_launches != expected:
        raise AssertionError(f"hymba launches {h_launches}, expected "
                             f"{expected}")

    emit(phase="profile", endpoint="hymba-0", profiler_on=True,
         **profile_request(heps["hymba-0"], {
             "ssm": (ssm, "ssm_apply_seq"),
             "attention": (transformer, "_attn_branch")}))
    del heps, hres
    release_memory()

    # -- the MoE and VLM paths: granite and llava, through K1 and K2 ----------
    attn_wrappers = {"K1": fl.flash_attention, "K2": dec.decode_attention,
                     "K3": dec.decode_attention_quant}
    g_launches = serve_attention_model(
        TorchEndpoint, gcfg, "granite-moe-3b-a800m", "granite", dev,
        attn_wrappers, {"moe": (moe, "moe_apply"),
                        "attention": (transformer, "_attn_branch")})
    l_launches = serve_attention_model(
        TorchEndpoint, lcfg, "llava-next-mistral-7b", "llava", dev,
        attn_wrappers, {"attention": (transformer, "_attn_branch")},
        serve_seq=LLAVA_SEQ)
    # each path's counts, zeroed just before it and read just after; the
    # kernels line carries their sums
    by_path = {"qwen3-1.7b": {k: launches[k] for k in ("K1", "K2", "K3")},
               "xlstm-350m": {"K4": launches["K4"]},
               "hymba-1.5b": h_launches,
               "granite-moe-3b-a800m": g_launches,
               "llava-next-mistral-7b": l_launches}
    launches = {k: sum(n.get(k, 0) for n in by_path.values())
                for k in ("K1", "K2", "K3", "K4", "K5")}

    rows = [("K1", "flash_attention", "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:95", k1),
            ("K2", "decode_attention",
             "src/repro_torch/csrc/decode_attention.cu",
             "src/repro/kernels/decode_attention/kernel.py:107", k23["K2"]),
            ("K3", "decode_attention_quant",
             "src/repro_torch/csrc/decode_attention.cu",
             "src/repro/kernels/decode_attention/kernel.py:207", k23["K3"]),
            ("K4", "mlstm_scan", "src/repro_torch/csrc/mlstm_scan.cu",
             "src/repro/kernels/mlstm_scan/kernel.py:87", k4m),
            ("K5", "ssm_scan", "src/repro_torch/csrc/ssm_scan.cu",
             "src/repro/kernels/ssm_scan/kernel.py:72", k5m)]
    print(json.dumps({"kernels": [
        dict(name=f"{k} {name}", route="cuda", source=src_,
             replaces=rep, launches=launches[k],
             launches_by_path={p: n[k] for p, n in by_path.items()
                               if k in n}, **m)
        for k, name, src_, rep, m in rows]}), flush=True)
    emit(phase="done", seconds=time.monotonic() - t_start,
         device_ms_spin_retries=spin_retries)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

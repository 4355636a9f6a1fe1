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
               qwen1.5-32b's (G 1) heads; K1 non-causal at the encoder
               (1500 x 1500) and cross-prefill (432 x 1500) shapes of
               full-width whisper-large-v3 and causal over its 432-token
               prompt, K2 and K3 over its 1500-frame cross cache and its
               432-slot self cache; each held against its plain
               PyTorch version (K3 also against the transcription of its
               arithmetic); kernel, plain and library times, the
               card's bound for the same work, bound_frac (bound / kernel
               time) and vs_library (kernel / library time); each K1 line
               names the kernel that ran (``kernel_for``: "sm90" at every
               served shape).
  4. model   — full-width qwen3-1.7b, xlstm-350m, hymba-1.5b,
               granite-moe-3b-a800m, llava-next-mistral-7b (B 4, S 4096:
               2880 patch embeddings, then 1216 tokens) and
               qwen3-moe-30b-a3b (8 of its 48 layers) and
               whisper-large-v3 (B 4: 1500 frame embeddings, then 432
               tokens; with its bf16 paths' distances to float32) (bf16,
               random weights from a seed): prefill + 4 decode steps
               through the kernels and through the plain versions; plus
               reduced f32 configs (each attention model with kv_quant off and on,
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
               request of each profiled; then three full-width
               whisper-large-v3 endpoints (serve_seq 432, 1500 frames a
               request) the same way, K1 96 times a prefill (32 encoder
               layers, 32 decoder self-, 32 cross-attention) and K2 64
               times a decode step, one warm request profiled with the
               encoder and the decoder blocks as ranges; each model's
               endpoints are freed, host memory included, before the
               next's are built.
  6. replay  — ``Server.replay_open_loop`` of an Azure-shaped stream (the
               Azure loader's seeded synthetic fallback: 6 functions, 2
               tenants, 20 arrivals in 5 minutes) through six full-width
               endpoints (qwen3-1.7b twice, one of them kv_quant;
               hymba-1.5b twice; xlstm-350m twice, at its depth cut)
               behind the wall-clock MQFQ-Sticky server with a capacity
               of two qwen endpoints' weights, open-loop at 0.7 times the
               warm request rate the qwen serve path measured (at most
               60 s of wall time); then 3 minutes of it (11 arrivals)
               hash-sharded over two logical devices on the card. Each run: every
               arrival released and completed without failure, cold and
               warm starts, K1-K5 each launched exactly as often as the
               completed requests and warm-ups imply; latency by start
               type, lateness, per-tenant p99, uploads, evictions, the
               per-shard split. Each endpoint's upload() and compile()
               seconds and upload rate, and per arch the cost model's
               warm_time and cold_init at the served shape beside the
               measured execute() and upload + compile seconds.
     examples — the port's examples: ``python -m
               repro_torch.examples.memory_policies`` and ``...quickstart``
               as subprocesses on the card, each of which must print its
               OK line; then ``serve_trace``'s comparison: its own trace
               (``make_trace(20, 4.0, 0)``, 20 requests in 6.0 s) under
               fcfs, then mqfq-sticky (d 2), over five full-width
               endpoints (qwen3-1.7b, granite-moe-3b-a800m, xlstm-350m at
               its depth cut, hymba-1.5b, llava-next-mistral-7b at
               serve_seq 4096), compiled and evicted before the trace,
               every endpoint evicted before each arm, at a capacity of
               the two largest endpoints' weights. Each arm: 20 of 20
               completed without failure, an eviction, K1, K2, K4 and K5
               launched exactly as the completed requests imply; start
               types, latency by start type, per-arch mean latency and
               the inter-function variance, uploads, evictions, wall
               seconds. Every request's greedy tokens must be equal in
               both arms.
  7. train   — the training path (``repro_torch.training``), which runs
               the plain versions under autograd and no kernel:
               full-width qwen3-1.7b in bf16 at train_4k's sequence
               length (S 4096; B 4 in 2 microbatches, cut from 256), 2
               Trainer steps on MarkovLM batches, each step's loss, grad
               norm, lr, seconds and tokens/s, the peak device memory,
               one profiled step's busy time and idle share, and every
               parameter's grad finite after one backward; the first
               step's loss, grad norm and per-leaf grads in bf16 against
               float32 at 4 of its 28 layers, with two controls (the last
               block dropped, bf16 scores) read beside them, and the
               float32 step in 2 microbatches against the whole batch's
               grads; 3 Trainer steps of reduced qwen3 and
               granite-moe in float32 on the card against the CPU; the
               ``small`` preset of ``repro_torch.examples.train_lm``,
               which must learn; a checkpoint saved and restored on the
               card bit for bit (bf16 and float32 leaves); every kernel
               wrapper's count unchanged across the phase, and each
               wrapper refusing an input that requires grad.
  8. sim      — ``python -m repro_torch.launch.serve --mode sim`` on the
               azure workload, in its own process and in this one: both
               must print the object the reference's launcher prints;
               ``--workload endpoints`` on the cost model's H100
               constants; ``run_scenario()`` of cold-start-storm through
               the pipeline data plane, without and with prefetch, its
               link at the upload rate phase "replay" measured (cold
               p99 of each). Host paths: they prove only that they run
               here.
     batchsim — the batch simulator (``repro_torch.batchsim``, torch
               tensor code, no kernel of the port) on the card at the
               sizes of the reference's own sweeps: (a) the differential
               matrix of tests/test_batchsim.py against the port's scalar
               SimExecutor, per invocation; (b) the fig8 trace (349
               events) over the 144 lanes of ``sensitivity_grid``, every
               lane bit for bit against the same run on the CPU and each
               sticky lane's integer aggregates against the scalar plane;
               (c) a zipf stream of 96 functions at 2.5 requests/s over
               the same lanes (its 2520 s cut, and the cut printed, where
               (b)'s rate predicts more than ``BATCH_C_BUDGET_S``): wall
               seconds, config-events/s, host syncs per event, the idle
               share of one profiled chunk, the serial scalar plane's
               seconds for the same lanes, and 4 sticky lanes held to it
               per invocation. No kernel wrapper's count moves.
  9. mesh    — the sharded paths (``repro_torch.utils.shardctx``,
               DTensor) on a 1x1 mesh over a world-size-1 NCCL group
               (an in-process HashStore, no TCP): one full-width
               qwen3-1.7b request (B 4, S 1024, 16 greedy steps) with its
               weights distributed by ``partition_specs`` under
               ``use_mesh``, whose tokens and K1/K2 launches must equal
               the unsharded endpoint's, both wall times printed;
               full-width granite-moe-3b-a800m through ``moe_apply_ep``
               against ``moe_apply`` (prefill and 4 decode steps, within
               the bf16 model limit); one full-width qwen3-1.7b float32
               AdamW step at S 1024, B 4 with ZeRO-1 and with ZeRO-2 (2
               microbatches) against the unsharded step, per leaf; and,
               in parallel on the host, ``python -m
               repro_torch.launch.dryrun`` for qwen3-1.7b and
               granite-moe-3b-a800m on the 16x16 mesh, which must exit
               0 (per-device GB, collective GiB by kind, seconds).
 10. the ``kernels`` line, the nvidia-smi line, and last
     ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
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
# whisper-large-v3 serves a decoder prompt of 432 tokens, so the prompt
# and the 16 decode steps fill 448 positions, the published decoder
# context (arXiv:2212.04356; src/repro/configs/whisper_large_v3.py), over
# its 1500 encoder frames
WHISPER_SEQ = 432
# qwen3-moe-30b-a3b at full width, cut to 8 of its 48 layers: its 60.2 GB
# of bf16 weights leave no room on the card for init_params' float32 draw
# of a stacked leaf (we1 at 48 layers is 38.7 GB in float32; at 8 layers
# 6.4 GB)
QWEN3_MOE_LAYERS = 8
# training: qwen3-1.7b at full width and depth in bf16 at train_4k's
# sequence length (src/repro_torch/shapes.py); its global batch of 256
# sequences is cut to 4, taken as 2 microbatches of 2
TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICROBATCH, TRAIN_STEPS = 4096, 4, 2, 2
# bf16 against float32 on the same weights and batch (full width, 4 of
# 28 layers, B 2): the first step's loss, its grad norm and each grad
# leaf's distance (|g_bf16 - g_f32| / |g_f32|, L2 over the leaf), each
# relative and within its limit. Each limit lies between the sound bf16
# path's reading and that of a control, the bf16 path with its last
# block's output dropped, which must exceed every limit. One H100 run,
# seed 1: sound 1.50e-5 / 1.84e-4 / 0.0199, dropped block 2.77e-4 /
# 0.0235 / 0.679 (PERF.md, PR 20)
TRAIN_F32_LAYERS = 4
TRAIN_LOSS_REL_TOL, TRAIN_GNORM_REL_TOL, TRAIN_LEAF_REL_TOL = \
    6e-5, 2e-3, 1e-1
# the same slice in float32 as 2 microbatches of 1 against one batch of
# 2, without a clip (the first step's m is then (1 - b1) times the
# accumulated grads): each leaf within 1e-4 of its largest |g|
TRAIN_MICROBATCH_TOL = 1e-4
# the card against the CPU, float32, 3 Trainer steps from the same
# weights on the same batches: losses at 1e-5 relative; the parameters
# at 1e-4 of each leaf's largest |p| but for at most max(1, 1e-4 n) of
# a leaf's n entries (where some step's grad lies near eps or near the
# two sides' grad error AdamW's update, m_hat / sqrt(v_hat), may move by
# its whole size), and those within 2 * (lr summed over the steps)
TRAIN_PARITY_LOSS_REL, TRAIN_PARITY_P_TOL, TRAIN_PARITY_LOOSE = \
    1e-5, 1e-4, 1e-4

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

FLASH_CASES = [(SERVE_BATCH, SERVE_SEQ, SERVE_SEQ, True, 0),
               (SERVE_BATCH, SERVE_SEQ, SERVE_SEQ, True, 256),
               (2, 200, 200, True, 0)]


def check_flash(fl, cfg, dev, cases=FLASH_CASES, model="qwen3-1.7b"):
    """K1 at the prefill shape (causal), with a window, and unaligned
    (``cases``: (B, Sq, Sk, causal, window) each; queries at 0..Sq-1,
    keys at 0..Sk-1); returns the first case's numbers. The plain version
    is the model's plain prefill, which above 2048 query positions
    attends in query chunks (the reference's chunk rule)."""
    from repro_torch.models.transformer import prefill_attention_plain
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = torch.Generator(dev).manual_seed(1)
    mk = lambda B, Sq, Sk: tuple(
        torch.randn(B, S, n, dh, generator=g, device=dev,
                    dtype=torch.bfloat16)
        for S, n in ((Sq, H), (Sk, KV), (Sk, KV)))
    main = None
    for B, Sq, Sk, causal, window in cases:
        kw = dict(causal=causal, window=window)
        q, k, v = mk(B, Sq, Sk)
        err = check_kernel("K1", fl.flash_attention(q, k, v, **kw),
                           prefill_attention_plain(q, k, v, **kw),
                           B=B, Sq=Sq, Sk=Sk, **kw)
        sets = [mk(B, Sq, Sk) for _ in range(n_sets(2 * nbytes(q, k, v)))]
        run = lambda q, k, v: fl.flash_attention(q, k, v, **kw)
        kern, kern_host = device_ms(run, sets), host_ms(run, sets)
        plain = device_ms(lambda q, k, v: prefill_attention_plain(
            q, k, v, **kw), sets, iters=4)
        qpos = torch.arange(Sq)
        kpos = torch.arange(Sk)
        valid = torch.ones(Sq, Sk, dtype=torch.bool)
        if causal:
            valid &= kpos[None, :] <= qpos[:, None]
        if window:
            valid &= kpos[None, :] > qpos[:, None] - window
        pairs = int(valid.sum())
        # q, k, v read once, the output (q's size) written once
        b_ms, b_by = bound_ms(nbytes(q, k, v) + nbytes(q),
                              4 * B * H * dh * pairs)
        lib = None
        if not window or window >= Sq:    # a window that masks nothing
            tsets = [tuple(t.transpose(1, 2).contiguous() for t in s)
                     for s in sets]
            lib = device_ms(lambda q, k, v: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True), tsets)
        m = dict(**err, **timing(kern, plain, lib, b_ms, b_by))
        emit(phase="kernel", name="K1 flash_attention", model=model, B=B,
             S=Sq, Sk=Sk, causal=causal, H=H, KV=KV, dh=dh, window=window,
             kernel=fl.kernel_for(q.dtype, dh), pairs=pairs,
             host_ms=kern_host, **m)
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
             window=window, valid_slots=n_valid,
             cluster_plan=dec.cluster_plan(B, S, KV,
                                           dec._sm_count(dev.index)),
             host_ms=kern_host, **m)
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
             launches_per_call=dec.sub_groups(H // KV),
             cluster_plan=dec.quant_plan(B, S, KV, dec._sm_count(dev.index)),
             host_ms=kern_host,
             row_rel_err_to_as_kernel=as_kernel["max_row_rel_err"], **m)
        out.setdefault("K3", m)
    return out


def check_mlstm(k4, cfg, dev):
    """K4 at the serving shapes of full-width xlstm-350m (f32, as the
    model casts): a prefill from the omitted state, one from a nonzero
    state (the first prefill's final state, as the model's prefill starts
    from a state), one from a state at S = 1000 (not a multiple of the
    chunk), and one decode step (S = 1) from that state; S >= k4.CHUNK
    takes the Hopper kernel (``kernel`` "sm90", one cluster launch; the
    phase fails on any other), S = 1 the step kernel. h and every leaf
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
        if k4.uses_chunks(S) and k4.kernel_for(S, dh) != "sm90":
            raise AssertionError(f"K4 prefill at dh {dh} is not on the "
                                 f"Hopper kernel")
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
             H=H, dh=dh, kernel=k4.kernel_for(S, dh),
             path="chunks" if k4.uses_chunks(S) else "steps",
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
    S >= k5.CHUNK takes the Hopper kernel (``kernel`` "sm90", one cluster
    launch; the phase fails on any other), S = 1 the step kernel.
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
        if k5.uses_chunks(S) and k5.kernel_for(S, dtype, P, N) != "sm90":
            raise AssertionError(f"K5 prefill ({dtype}, P {P}, N {N}) is "
                                 f"not on the Hopper kernel")
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
             kernel=k5.kernel_for(S, dtype, P, N),
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
        x, aux = block_apply(*a, **kw)
        seen.append(x)
        return x, aux
    transformer.block_apply = recorded
    try:
        run()
    finally:
        transformer.block_apply = block_apply
    return [float(x.float().abs().max()) for x in seen]


def trajectory(model, params, batch, plan, steps, feed=None,
               grad_mode=torch.inference_mode):
    """Float32 logits (steps + 1, B, vocab) of a prefill of ``batch`` and
    ``steps`` decode steps, each fed ``feed[:, i]`` or, without ``feed``,
    the greedy token; returns them and the tokens fed. DTensors take
    ``grad_mode=torch.no_grad``: their views cannot be inference
    tensors."""
    S = model.decode_start(batch)
    logits, fed = [], []
    with grad_mode():
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
    tokens; Whisper's prompt is S tokens after its encoder_len frame
    embeddings (N(0, 1) * 0.02). With ``f32_truth``, the same weights and tokens also go
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
    if cfg.family == "audio":
        batch["frames"] = (torch.randn(B, cfg.encoder_len, cfg.d_model,
                                       device=dev, generator=g) * 0.02
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


# --- phase 5: serving ---------------------------------------------------------

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


# the decode steps of a profiled request (the served requests take
# DECODE_STEPS): torch.profiler's trace of a whole request took 15-38 s a
# request to parse on the host, the script's largest cost
PROFILE_DECODE_STEPS = 4


def profile_request(ep, ranges=None):
    """One warm request of ``ep``, cut to ``PROFILE_DECODE_STEPS`` decode
    steps, under torch.profiler: wall time, the
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
        served_steps, ep.decode_steps = ep.decode_steps, PROFILE_DECODE_STEPS
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
            ep.decode_steps = served_steps
    wall = wall[0]
    if not by_name:
        # the trace came back without the device's activity: say so
        # rather than report an idle device
        return dict(decode_steps=PROFILE_DECODE_STEPS, request_wall_s=wall,
                    device_busy_s=None, request_wall_unprofiled_s=wall_off,
                    idle_share=None, top_kernels_ms=None,
                    note="torch.profiler recorded no device time")
    busy = sum(by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = dict(decode_steps=PROFILE_DECODE_STEPS, request_wall_s=wall,
               request_wall_unprofiled_s=wall_off,
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


# The kernels that spill in the committed build (ptxas -v): K4's
# mlstm_cluster<512> (255 registers) keeps its Q C0^T accumulator in local
# memory, where the epilogue indexes it by the warpgroup, and a dozen
# scalars set before the chunk loop; K5's ssd_cluster (96 registers, for
# two CTAs an SM) a few indices and floats. Any other kernel that spills
# is named in the build line's unexpected_spilling.
EXPECTED_SPILLERS = ("mlstm_cluster<512>", "ssd_cluster<")

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
    # Whisper is held by the plain rule; its line also carries its bf16
    # paths' distances to float32, the measure that would move it to
    # POORLY_CONDITIONED
    r = run_model(cfg, dev, SERVE_BATCH, S, 4, seed=0,
                  f32_truth=by_f32 or cfg.family == "audio", twice=twice)
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
                          ranges, serve_seq=SERVE_SEQ, k1_per_prefill=None,
                          k2_per_step=None):
    """Three full-width endpoints of an attention model behind the
    MQFQ-Sticky wall-clock server, each kernel's count zeroed just
    before and read just after, as qwen's path is driven: K1
    ``k1_per_prefill`` times for each prefill, K2 ``k2_per_step`` times
    for each decode step (both once a layer unless given), K3 never;
    each endpoint's compile() runs a prefill and one step. Then one warm
    request profiled with ``ranges``. Frees the endpoints and returns the
    launch counts."""
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
    n_warm = len(eps)
    k1 = k1_per_prefill or cfg.n_layers
    k2 = k2_per_step or cfg.n_layers
    expected = {"K1": k1 * (n_req + n_warm),
                "K2": k2 * (DECODE_STEPS * n_req + n_warm), "K3": 0}
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


# --- phase 6: open-loop replay ------------------------------------------------

# The replay's scenario: the Azure loader's seeded synthetic fallback
# (no trace CSV is in the repository), 5 minutes of trace at a mean of 3
# invocations a minute. Of its 7 rows 6 carry invocations (the loader
# drops the row with none): 20 arrivals over 2 tenants, one function
# per endpoint below, every kernel's endpoint among them. The sharded run
# replays 3 minutes (11 arrivals, every kernel's endpoint still among
# them). Both were 10 and 5 minutes (34 and 20 arrivals) until the script
# neared its time limit on a slow host.
REPLAY_SCENARIO = dict(n_fns=7, minutes=5, seed=24, mean_rpm=3.0)
REPLAY_SHARDED_MINUTES = 3
# the offered rate, as a share of the warm request rate that the qwen
# serve phase measured (requests / seconds), and the cap on its wall time
REPLAY_LOAD, REPLAY_MAX_WALL_S = 0.7, 60.0
# the endpoints, in the order of the scenario's sorted function ids:
# (model, kv_quant); xlstm at the model phase's depth cut
REPLAY_ENDPOINTS = [("qwen3-1.7b", False), ("qwen3-1.7b", True),
                    ("hymba-1.5b", False), ("hymba-1.5b", False),
                    ("xlstm-350m", False), ("xlstm-350m", False)]


def time_endpoint(ep, log) -> None:
    """Record each ``upload()`` and ``compile()`` of ``ep`` in ``log`` as
    (kind, seconds); a compile's seconds leave out the upload it makes
    itself (``TorchEndpoint.compile`` uploads if the weights are not on
    the card)."""
    upload, compile_ = ep.upload, ep.compile

    def timed_upload():
        s = upload()
        log.append(("upload", s))
        return s

    def timed_compile():
        n = len(log)
        s = compile_()
        log.append(("compile", s - sum(x for k, x in log[n:]
                                       if k == "upload")))
        return s

    ep.upload, ep.compile = timed_upload, timed_compile


def replay_expected_launches(eps, cfgs, served, compiles) -> dict:
    """Kernel launches that ``served`` requests and ``compiles`` warm-ups
    per endpoint imply, reckoned per arch as the serve phase does: per
    layer one K1 call a prefill and one K2 (K3 on a kv_quant endpoint)
    a decode step; hymba also one K5 call a prefill and one a step; xlstm
    one K4 call per pair block a prefill and a step; a warm-up is a
    prefill and one step."""
    out = {k: 0 for k in ("K1", "K2", "K3", "K4", "K5")}
    for f in eps:
        cfg, r, c = cfgs[f], served.get(f, 0), compiles.get(f, 0)
        steps = DECODE_STEPS * r + c
        if cfg.family == "ssm":
            out["K4"] += cfg.n_layers // 2 * (r + c + steps)
            continue
        L = cfg.n_layers
        out["K1"] += L * (r + c)
        out["K3" if cfg.kv_quant else "K2"] += L * steps
        if cfg.family == "hybrid":
            out["K5"] += L * (r + c + steps)
    return out


def replay_run(eps, cfgs, logs, sc, minutes, speedup, wrappers, **cfg_kw):
    """Replay ``sc`` open-loop through a wall-clock MQFQ-Sticky server
    over ``eps``, each kernel's count zeroed just before and read just
    after; checks every arrival released and completed without failure,
    cold and warm starts, and the launches the completed requests and
    warm-ups imply. Returns (summary, launches, the RunResult)."""
    from repro_torch.server import (ServerConfig, make_server, nearest_rank,
                                    specs_from_endpoints)
    cap = 2 * max(ep.weight_bytes for ep in eps.values())
    server = make_server(ServerConfig(executor="wallclock",
                                      policy="mqfq-sticky", d=2,
                                      capacity_bytes=cap, **cfg_kw),
                         fns=specs_from_endpoints(eps), endpoints=eps)
    evicted = []
    for d in server.control.devices:
        d.mem.evict_listeners.append(evicted.append)
    n_events = sum(1 for _ in sc.stream())
    marks = {f: len(logs[f]) for f in eps}
    for w in wrappers.values():
        w.launches = 0
    rr = server.replay_open_loop(sc, speedup=speedup)
    launches = {k: w.launches for k, w in wrappers.items()}
    res = rr.result
    new = {f: logs[f][marks[f]:] for f in eps}
    compiles = {f: sum(k == "compile" for k, _ in new[f]) for f in eps}
    served = {f: sum(i.fn_id == f for i in res.invocations) for f in eps}
    expected = replay_expected_launches(eps, cfgs, served, compiles)
    by_start = {}
    for inv in sorted(res.invocations, key=lambda i: i.latency):
        by_start.setdefault(inv.start_type, []).append(inv.latency)
    lat = {k: dict(n=len(v), p50_s=nearest_rank(v, 0.5),
                   p99_s=nearest_rank(v, 0.99), max_s=v[-1])
           for k, v in sorted(by_start.items())}
    summary = dict(
        events=n_events, released=rr.released, completed=res.completed_count,
        failed=res.failed_count, n_feeders=rr.n_feeders, speedup=speedup,
        offered_rps=n_events / (60.0 * minutes) * speedup,
        wall_s=rr.wall_s, start_types=res.start_type_counts(),
        latency_by_start=lat, lateness_p99_s=rr.lateness_quantile(0.99),
        lateness_max_s=rr.max_lateness,
        per_tenant_p99_s={t: r["p99"] for t, r in
                          rr.per_tenant_quantiles(sc).items()},
        served=served, compiles=compiles,
        uploads={f: sum(k == "upload" for k, _ in new[f]) for f in eps},
        evictions=len(evicted), launches=launches,
        expected_launches=expected)
    if cfg_kw.get("sharding") == "hash":
        from repro_torch.server import hash_shard
        n = cfg_kw["n_shards"]
        split = [collections.Counter(e.fn_id for e in s)
                 for s in sc.shard_streams(n, mode="filter")]
        got = [collections.Counter(i.fn_id for i in ex.completed)
               for ex in server.executor.execs]
        summary["per_shard_completed"] = [sum(c.values()) for c in got]
        if got != split or rr.n_feeders != n or any(
                hash_shard(f, n) != k for k, c in enumerate(got)
                for f in c):
            raise AssertionError(f"replay: shard split {got}, the "
                                 f"scenario's fan-out {split}")
    if not rr.released == n_events == res.completed_count == \
            len(res.invocations):
        raise AssertionError(f"replay: {n_events} events, released "
                             f"{rr.released}, completed "
                             f"{res.completed_count}")
    if any(inv.failed or not inv.done for inv in res.invocations):
        raise AssertionError("replay: an invocation failed")
    starts = res.start_type_counts()
    if starts.get("cold", 0) < 1 or starts.get("warm", 0) < 1:
        raise AssertionError(f"replay: no cold or no warm start: {starts}")
    if launches != expected or not all(launches.values()):
        raise AssertionError(f"replay launches {launches}, expected "
                             f"{expected}")
    return summary, launches, res


def replay_phase(TorchEndpoint, get_config, xcfg, dev, wrappers,
                 qwen_rate):
    """Six full-width endpoints (qwen3-1.7b twice, one kv_quant; hymba-1.5b
    twice; xlstm-350m twice) behind the wall-clock MQFQ-Sticky server
    replay the Azure-shaped scenario open-loop at ``REPLAY_LOAD`` times
    the qwen serve phase's warm request rate (``qwen_rate``), then half
    of it hash-sharded over two logical devices on the card; each
    endpoint's upload and compile seconds beside the cost model's terms.
    Frees the endpoints; returns (launches of each run, the measured
    upload rate in bytes/s)."""
    from repro_torch.shapes import InputShape
    from repro_torch.datapath.stages import ColdStartStages
    from repro_torch.workloads import costmodel as cm
    from repro_torch.workloads.scenarios import make_scenario
    t_phase = time.monotonic()
    sc = make_scenario("azure-replay", **REPLAY_SCENARIO)
    fns = sorted(sc.fns)
    models = {"qwen3-1.7b": get_config("qwen3-1.7b"),
              "hymba-1.5b": get_config("hymba-1.5b"), "xlstm-350m": xcfg}
    cfgs = {f: dataclasses.replace(models[m], kv_quant=q)
            for f, (m, q) in zip(fns, REPLAY_ENDPOINTS)}
    arch = {f: m + ("+kv_quant" if q else "")
            for f, (m, q) in zip(fns, REPLAY_ENDPOINTS)}
    t0 = time.monotonic()
    eps = {f: TorchEndpoint(f, cfgs[f], seed=i, serve_seq=SERVE_SEQ,
                            serve_batch=SERVE_BATCH,
                            decode_steps=DECODE_STEPS, device=dev)
           for i, f in enumerate(fns)}
    logs = {f: [] for f in fns}
    for f, ep in eps.items():
        time_endpoint(ep, logs[f])
    n_events = sum(1 for _ in sc.stream())
    span = 60.0 * REPLAY_SCENARIO["minutes"]
    # the offered rate n_events / span * speedup = REPLAY_LOAD * qwen_rate,
    # unless that would take longer than REPLAY_MAX_WALL_S
    speedup = max(REPLAY_LOAD * qwen_rate * span / n_events,
                  span / REPLAY_MAX_WALL_S)
    emit(phase="replay", step="endpoints", scenario=sc.description,
         endpoints=arch, weight_bytes={f: ep.weight_bytes
                                       for f, ep in eps.items()},
         pinned_weight_bytes=sum(ep.weight_bytes for ep in eps.values()),
         host_allocator_pinned_bytes=pinned_host_bytes(),
         qwen_warm_rps=qwen_rate, load=REPLAY_LOAD, speedup=speedup,
         seconds=time.monotonic() - t0)
    mono, mono_launches, res = replay_run(
        eps, cfgs, logs, sc, REPLAY_SCENARIO["minutes"], speedup, wrappers)
    emit(phase="replay", run="monolithic", **mono)

    # cold-start terms of each endpoint, and the cost model beside them
    uploads = {f: [s for k, s in logs[f] if k == "upload"] for f in fns}
    compiles = {f: [s for k, s in logs[f] if k == "compile"] for f in fns}
    rates = [eps[f].weight_bytes / s for f in fns for s in uploads[f]]
    upload_bw = float(np.median(rates))
    emit(phase="replay", step="cold_start",
         upload_s=uploads, compile_s=compiles,
         upload_gb_per_s={f: [eps[f].weight_bytes / s / 1e9
                              for s in uploads[f]] for f in fns},
         median_upload_gb_per_s=upload_bw / 1e9,
         cost_model_compile_s=cm.COMPILE_TIME, cost_model_h2d_bw=cm.H2D_BW)
    pre = InputShape("serve_prefill", SERVE_SEQ, SERVE_BATCH, "prefill")
    dec = InputShape("serve_decode", SERVE_SEQ, SERVE_BATCH, "decode")
    for m in dict.fromkeys(arch.values()):
        mine = [f for f in fns if arch[f] == m]
        cfg = cfgs[mine[0]]
        # endpoint_spec's terms at the served shape: the roofline service
        # time of the prefill and of DECODE_STEPS steps, and the cold
        # start of its uncontended stages (compile + weight upload)
        warm_pred = (cm.service_time(cfg, pre)
                     + DECODE_STEPS * cm.service_time(cfg, dec))
        wbytes = cfg.n_params() * (2 if "16" in cfg.param_dtype else 4)
        cold_pred = ColdStartStages(
            setup_s=0.0, compile_s=cm.COMPILE_TIME,
            weight_bytes=int(wbytes)).scalar_cold_init(cm.H2D_BW)
        # execute()'s seconds, which leave out upload and compile; every
        # endpoint served, uploaded and compiled in the run
        exec_s = float(np.median([i.service_time for i in res.invocations
                                  if i.fn_id in mine]))
        cold_s = (float(np.mean([s for f in mine for s in uploads[f]]))
                  + float(np.mean([s for f in mine for s in compiles[f]])))
        emit(phase="replay", step="cost_model", model=m,
             warm_time_s=warm_pred, cold_init_s=cold_pred,
             measured_exec_s=exec_s,
             measured_upload_plus_compile_s=cold_s,
             exec_over_warm_time=exec_s / warm_pred,
             upload_plus_compile_over_cold_init=cold_s / cold_pred)

    # half the scenario, hash-sharded over two logical devices on the
    # card, each with the monolithic run's capacity; from cold weights
    for ep in eps.values():
        ep.evict()
    half = make_scenario("azure-replay", **{
        **REPLAY_SCENARIO, "minutes": REPLAY_SHARDED_MINUTES})
    if set(half.fns) != set(fns):
        raise AssertionError("replay: the sharded half lacks a function")
    sharded, sh_launches, _ = replay_run(
        eps, cfgs, logs, half, REPLAY_SHARDED_MINUTES, speedup, wrappers,
        sharding="hash", n_shards=2, n_devices=2)
    emit(phase="replay", run="sharded", **sharded)
    emit(phase="replay", step="done", seconds=time.monotonic() - t_phase)
    del eps, res
    release_memory()
    return mono_launches, sh_launches, upload_bw


# --- phase 6b: the examples ---------------------------------------------------

# serve_trace's generator at 20 requests (make_trace(20, 4.0, 0): 6.0 s,
# qwen 8, granite 7, llava 2, xlstm 2, hymba 1; examples/serve_trace.py's
# own 30 were cut for the script's time limit) under fcfs, then
# mqfq-sticky (T 10, alpha 2), d 2, over five full-width endpoints in
# ARCHS' order; the capacity is the two largest endpoints' weights (llava
# and granite, 21.2 GB): the reference's rule, three of the largest, would
# hold all five at full width (28.4 GB) and never swap
EXAMPLES_TRACE = dict(requests=20, rps=4.0, seed=0)
EXAMPLE_MODULES = ("memory_policies", "quickstart")
EXAMPLE_TIMEOUT_S = 300


def start_example(module):
    """``python -m repro_torch.examples.<module>`` in a subprocess, from
    the checkout, on the card."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen(
        [sys.executable, "-m", f"repro_torch.examples.{module}"], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish_example(module, proc, t0) -> None:
    """The subprocess must exit 0 and print ``<module>: OK`` last."""
    try:
        out, err = proc.communicate(timeout=EXAMPLE_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    lines = out.strip().splitlines()
    last = lines[-1] if lines else ""
    emit(phase="examples", example=module, rc=proc.returncode,
         last_line=last, lines=len(lines), seconds=time.monotonic() - t0)
    if proc.returncode != 0 or not last.startswith(f"{module}: OK"):
        raise AssertionError(f"examples: {module} exited {proc.returncode}, "
                             f"last line {last!r}; stderr: {err[-2000:]}")


def examples_arm(st, policy, eps, cfgs, logs, trace, cap, wrappers):
    """One arm of serve_trace: every endpoint evicted, then ``trace``
    under ``policy``, each kernel's count zeroed just before and read
    just after. Checks every request completed without failure, an
    eviction, and the launches that the completed requests and any
    warm-ups imply. Returns (summary, launches, {(arch, seed): tokens})."""
    from repro_torch.server import nearest_rank
    for ep in eps.values():
        ep.evict()
    marks = {f: len(logs[f]) for f in eps}
    for w in wrappers.values():
        w.launches = 0
    t0 = time.monotonic()
    ref, res = st.run_policy(policy, eps, trace, capacity_bytes=cap)
    wall = time.monotonic() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    new = {f: logs[f][marks[f]:] for f in eps}
    compiles = {f: sum(k == "compile" for k, _ in new[f]) for f in eps}
    served = {f: sum(i.fn_id == f for i in res.invocations) for f in eps}
    expected = replay_expected_launches(eps, cfgs, served, compiles)
    by_start = {}
    for inv in sorted(res.invocations, key=lambda i: i.latency):
        by_start.setdefault(inv.start_type, []).append(inv.latency)
    summary = dict(
        policy=policy, requests=len(trace), completed=ref["completed"],
        mean_s=ref["mean_s"], max_s=ref["max_s"],
        start_types=res.start_type_counts(),
        latency_by_start={k: dict(n=len(v), p50_s=nearest_rank(v, 0.5),
                                  max_s=v[-1])
                          for k, v in sorted(by_start.items())},
        per_arch_mean_s=res.per_fn_mean(),
        inter_fn_variance=res.inter_fn_variance(),
        served=served, compiles=compiles,
        uploads={f: sum(k == "upload" for k, _ in new[f]) for f in eps},
        evictions=ref["evictions"], wall_s=wall, launches=launches,
        expected_launches=expected)
    emit(phase="examples", run="serve_trace", **summary)
    if not ref["completed"] == len(res.invocations) == len(trace):
        raise AssertionError(f"serve_trace {policy}: {ref['completed']} of "
                             f"{len(trace)} completed")
    if any(inv.failed or not inv.done for inv in res.invocations):
        raise AssertionError(f"serve_trace {policy}: an invocation failed")
    if ref["evictions"] < 1:
        raise AssertionError(f"serve_trace {policy}: no eviction at "
                             f"{cap} bytes")
    if launches != expected or not all(
            launches[k] for k in ("K1", "K2", "K4", "K5")):
        raise AssertionError(f"serve_trace {policy}: launches {launches}, "
                             f"expected {expected}")
    return summary, launches, st.tokens_of(res)


def examples_phase(TorchEndpoint, get_config, xcfg, dev, wrappers) -> dict:
    """The port's examples: ``memory_policies`` and ``quickstart`` as
    subprocesses (each must print its OK line), then ``serve_trace``'s
    fcfs against mqfq-sticky over five full-width endpoints, in this
    process. Frees the endpoints; returns each arm's launches."""
    from repro_torch.examples import serve_trace as st
    t_phase = time.monotonic()
    procs = {m: start_example(m) for m in EXAMPLE_MODULES}
    try:
        return examples_serve_trace(st, TorchEndpoint, get_config, xcfg,
                                    dev, wrappers, procs, t_phase)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


def examples_serve_trace(st, TorchEndpoint, get_config, xcfg, dev,
                         wrappers, procs, t_phase) -> dict:
    """serve_trace's two arms over five full-width endpoints, with the
    example subprocesses ``procs`` finished before the first arm."""
    t0 = time.monotonic()
    cfgs = {a: xcfg if a == "xlstm-350m" else get_config(a)
            for a in st.ARCHS}
    eps = {a: TorchEndpoint(
        a, cfgs[a], seed=i,
        serve_seq=LLAVA_SEQ if a == "llava-next-mistral-7b" else SERVE_SEQ,
        serve_batch=SERVE_BATCH, decode_steps=DECODE_STEPS, device=dev)
        for i, a in enumerate(st.ARCHS)}
    logs = {a: [] for a in eps}
    for a, ep in eps.items():
        time_endpoint(ep, logs[a])
    st.keep_tokens(eps)
    # serve_trace's main: compile every endpoint once, then evict it
    compile_s = {}
    for a, ep in eps.items():
        compile_s[a] = ep.compile()
        ep.evict()
    weights = {a: ep.weight_bytes for a, ep in eps.items()}
    cap = sum(sorted(weights.values())[-2:])
    trace = st.make_trace(**EXAMPLES_TRACE)
    emit(phase="examples", step="endpoints", weight_bytes=weights,
         pinned_weight_bytes=sum(weights.values()),
         host_allocator_pinned_bytes=pinned_host_bytes(),
         capacity_bytes=cap, compile_s=compile_s, trace=EXAMPLES_TRACE,
         trace_span_s=trace[-1][0],
         trace_arrivals=dict(collections.Counter(f for _, f, _ in trace)),
         seconds=time.monotonic() - t0)
    for m, proc in procs.items():
        finish_example(m, proc, t_phase)
    launches, tokens = {}, {}
    for policy in ("fcfs", "mqfq-sticky"):
        _, launches[policy], tokens[policy] = examples_arm(
            st, policy, eps, cfgs, logs, trace, cap, wrappers)
    a, b = tokens["fcfs"], tokens["mqfq-sticky"]
    differ = sorted(k for k in a if k not in b
                    or not np.array_equal(a[k], b[k]))
    emit(phase="examples", check="tokens equal across the arms",
         requests=len(a), differ=[list(k) for k in differ])
    if len(a) != len(trace) or a.keys() != b.keys() or differ:
        raise AssertionError(f"serve_trace: tokens differ between the arms "
                             f"for {differ} ({len(a)}, {len(b)} requests)")
    emit(phase="examples", step="done", seconds=time.monotonic() - t_phase)
    del eps
    release_memory()
    return launches


# --- phase 7: training --------------------------------------------------------

def train_steps(tr, data, steps):
    """``steps`` single-step ``Trainer.fit`` calls, each timed to a
    synchronize; one record of metrics and seconds per step."""
    out = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        tr.fit(data, 1, verbose=False)
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        h = tr.history[-1]
        out.append(dict(step=h["step"], loss=h["loss"],
                        grad_norm=h["grad_norm"], lr=h["lr"], seconds=dt))
    return out


def all_grads_finite(model, params, batch) -> int:
    """One backward of ``model.loss_fn``: every parameter leaf gets a
    finite grad; returns the number of leaves."""
    from repro_torch.models.common import tree_leaves
    leaves = list(tree_leaves(params))
    loss, _ = model.loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    bad = [i for i, g in enumerate(grads)
           if g is None or not bool(torch.isfinite(g).all())]
    if bad or not bool(torch.isfinite(loss)):
        raise AssertionError(f"loss {float(loss)}; leaves without a finite "
                             f"grad: {bad}")
    return len(leaves)


def train_full_width(cfg, dev):
    """Full-width bf16 training at S 4096: TRAIN_STEPS Trainer steps of
    TRAIN_BATCH sequences in TRAIN_MICROBATCH chunks, the peak memory,
    one profiled step."""
    from repro_torch.models import build_model
    from repro_torch.training import AdamWConfig, DataConfig, Trainer, \
        batches
    t0 = time.monotonic()
    model = build_model(cfg)
    tr = Trainer(model, AdamWConfig(), log_every=1,
                 microbatch=TRAIN_MICROBATCH, device=dev)
    tr.init(seed=0)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                    batch_size=TRAIN_BATCH, seed=0)
    data = batches(dc)
    try:
        first = {k: torch.from_numpy(v[:TRAIN_BATCH // TRAIN_MICROBATCH])
                 .to(dev) for k, v in next(data).items()}
        n_leaves = all_grads_finite(model, tr.params, first)
        del first
        init_s = time.monotonic() - t0
        torch.cuda.reset_peak_memory_stats(dev)
        steps = train_steps(tr, data, TRAIN_STEPS)
        peak = torch.cuda.max_memory_allocated(dev)
        wall = []

        def one_step():
            t1 = time.monotonic()
            tr.fit(data, 1, verbose=False)
            torch.cuda.synchronize()
            wall.append(time.monotonic() - t1)
        by_name, _ = profiled(one_step)
    finally:
        data.close()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    for st in steps:
        st["tokens_per_s"] = tokens / st["seconds"]
        if not (math.isfinite(st["loss"]) and math.isfinite(st["grad_norm"])):
            raise AssertionError(f"non-finite training step: {st}")
    busy = sum(by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    emit(phase="train", config="qwen3-1.7b full width bf16",
         n_layers=cfg.n_layers, S=TRAIN_SEQ, B=TRAIN_BATCH,
         microbatch=TRAIN_MICROBATCH,
         cut=f"batch {TRAIN_BATCH} of train_4k's 256 sequences",
         n_param_leaves=n_leaves, every_leaf_grad_finite=True,
         init_and_grad_check_s=init_s, steps=steps,
         peak_allocated_bytes=peak,
         profiled_step=dict(
             wall_s=wall[0], device_busy_s=busy if by_name else None,
             idle_share=1.0 - busy / wall[0] if by_name else None,
             top_kernels_ms=[[n[:90], us / 1e3] for n, us in top],
             gemm_device_ms=sum(us for n, us in by_name.items()
                                if GEMM_NAME.search(n)) / 1e3),
         seconds=time.monotonic() - t0)
    del tr, model
    release_memory()


def _bf16_scores(q, k, scale):
    """``attention._scores`` with the score GEMM in the inputs' dtype, not
    float32: a control for the bf16-vs-float32 check."""
    return torch.einsum("bqkgd,bskd->bkgqs", q, k).float() * scale


def train_bf16_vs_f32(cfg, dev):
    """At full width and TRAIN_F32_LAYERS layers, on the same weights and
    batch: the first step's loss, grad norm and per-leaf grads in bf16
    against float32, and against float32 two controls, the bf16 path
    with its last block's output dropped (wo and w2 zero) and with its
    attention scores in bf16; then the float32 train step in 2
    microbatches against the float32 grads of the whole batch."""
    from repro_torch.models import attention, build_model
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.training import AdamWConfig, DataConfig, MarkovLM
    from repro_torch.training.checkpoint import keyed_leaves
    from repro_torch.training.optimizer import adamw_init, global_norm
    from repro_torch.training.trainer import make_train_step, trainable
    t0 = time.monotonic()
    cfg = dataclasses.replace(cfg, n_layers=TRAIN_F32_LAYERS)
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    model, model32 = build_model(cfg), build_model(cfg32)
    base = model.init_params(torch.Generator(dev).manual_seed(1), dev)
    names = [k for k, _ in keyed_leaves(base)]
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                    batch_size=TRAIN_BATCH // TRAIN_MICROBATCH, seed=1)
    toks = torch.from_numpy(MarkovLM(dc).sample(
        np.random.default_rng(2), dc.batch_size, dc.seq_len)).to(dev)
    batch = {"tokens": toks, "labels": toks}

    def loss_grads(m, params):
        params = trainable(params)
        loss, _ = m.loss_fn(params, batch)
        grads = torch.autograd.grad(loss, list(tree_leaves(params)))
        return float(loss.detach()), [g.float() for g in grads]

    lf, gf = loss_grads(model32, tree_map(lambda t: t.float(), base))
    gnf = float(global_norm(gf))

    def distance(run):
        lb, gb = run()
        leaf = [float(torch.linalg.vector_norm(b - a)
                      / torch.linalg.vector_norm(a)) for a, b in zip(gf, gb)]
        i = max(range(len(leaf)), key=leaf.__getitem__)
        gnb = float(global_norm(gb))
        return dict(loss=lb, loss_rel=abs(lb - lf) / abs(lf), grad_norm=gnb,
                    grad_norm_rel=abs(gnb - gnf) / gnf,
                    max_leaf_rel=leaf[i], max_leaf=names[i])

    def dropped():
        p = tree_map(lambda t: t.clone(), base)
        p["layers"]["wo"][-1].zero_()
        p["layers"]["w2"][-1].zero_()
        return loss_grads(model, p)

    def scores_bf16():
        plain, attention._scores = attention._scores, _bf16_scores
        try:
            return loss_grads(model, base)
        finally:
            attention._scores = plain

    sound = distance(lambda: loss_grads(model, base))
    control = distance(dropped)
    scores = distance(scores_bf16)
    limits = dict(loss_rel=TRAIN_LOSS_REL_TOL,
                  grad_norm_rel=TRAIN_GNORM_REL_TOL,
                  max_leaf_rel=TRAIN_LEAF_REL_TOL)

    # float32, 2 microbatches of 1, unclipped: m / (1 - b1) is the
    # accumulated grads
    ocfg = AdamWConfig(grad_clip=math.inf)
    params = trainable(tree_map(lambda t: t.float(), base))
    _, state, met = make_train_step(model32, ocfg, microbatch=2)(
        params, adamw_init(params, ocfg), batch)
    b1 = ocfg.betas[0]
    mb = max(float((m / (1 - b1) - a).abs().max() / a.abs().max())
             for a, m in zip(gf, tree_leaves(state.m)))
    mb_loss_rel = abs(float(met["loss"]) - lf) / abs(lf)
    del params, state
    emit(phase="train",
         config=f"qwen3-1.7b full width, {TRAIN_F32_LAYERS} of 28 layers, "
                f"bf16 vs float32", S=TRAIN_SEQ, B=dc.batch_size,
         loss_f32=lf, grad_norm_f32=gnf, bf16=sound, limits=limits,
         control_last_block_dropped=control, control_bf16_scores=scores,
         microbatch2_vs_1_f32=dict(max_leaf_err_of_max=mb,
                                   loss_rel=mb_loss_rel,
                                   tol=TRAIN_MICROBATCH_TOL),
         seconds=time.monotonic() - t0)
    if not all(sound[k] <= v for k, v in limits.items()):
        raise AssertionError(f"bf16 training off its float32: {sound}")
    if any(control[k] <= v for k, v in limits.items()):
        raise AssertionError(f"a bf16-vs-float32 limit passes a dropped "
                             f"block: {control}")
    if not (mb <= TRAIN_MICROBATCH_TOL and mb_loss_rel <= 1e-5):
        raise AssertionError(f"microbatch=2 off the whole batch: {mb}, "
                             f"loss {mb_loss_rel}")
    del base, model, model32, gf
    release_memory()


def params_close_after_adamw(want_tree, got_tree, lr_sum) -> dict:
    """TRAIN_PARITY_P_TOL of each leaf's largest |p| for all but
    max(1, TRAIN_PARITY_LOOSE n) of a leaf's n entries, every entry
    within 2 * lr_sum (see TRAIN_PARITY_*)."""
    from repro_torch.models.common import tree_leaves
    n_loose = n_all = 0
    worst, leaf_ok, most = 0.0, True, (0, 0)
    for want, got in zip(tree_leaves(want_tree), tree_leaves(got_tree)):
        want, got = want.detach().float().cpu(), got.detach().float().cpu()
        diff = (got - want).abs()
        worst = max(worst, float(diff.max()))
        n = int((diff > TRAIN_PARITY_P_TOL * float(want.abs().max())).sum())
        leaf_ok &= n <= max(1, TRAIN_PARITY_LOOSE * diff.numel())
        most = max(most, (n, diff.numel()))
        n_loose += n
        n_all += diff.numel()
    ok = worst <= 2 * lr_sum and leaf_ok
    return dict(max_abs_param_diff=worst, n_loose=n_loose, n_entries=n_all,
                most_loose_in_a_leaf=list(most), params_ok=ok)


def train_card_vs_cpu(arch, dev):
    """3 float32 Trainer steps of a reduced config on the card and on the
    CPU from the same weights on the same batches; returns the card's
    Trainer."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.training import AdamWConfig, DataConfig, Trainer, \
        batches
    t0 = time.monotonic()
    cfg = get_config(arch).reduced()
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, batch_size=4,
                    seed=5)
    cpu = Trainer(build_model(cfg), opt_cfg, log_every=1, device="cpu")
    cpu.init(seed=0)
    card = Trainer(build_model(cfg), opt_cfg, log_every=1, device=dev)
    card.init(params=cpu.params)
    for tr in (cpu, card):
        data = batches(dc)
        tr.fit(data, 3, verbose=False)
        data.close()
    losses = [(h["loss"], c["loss"]) for h, c in zip(cpu.history,
                                                       card.history)]
    loss_rel = max(abs(b - a) / abs(a) for a, b in losses)
    close = params_close_after_adamw(cpu.params, card.params,
                                     sum(h["lr"] for h in cpu.history))
    emit(phase="train", config=f"{arch} reduced f32, card vs cpu", steps=3,
         losses_cpu=[a for a, _ in losses], losses_card=[b for _, b in losses],
         max_loss_rel=loss_rel, loss_rel_tol=TRAIN_PARITY_LOSS_REL,
         param_tol=TRAIN_PARITY_P_TOL, loose_share_tol=TRAIN_PARITY_LOOSE,
         **close, seconds=time.monotonic() - t0)
    if loss_rel > TRAIN_PARITY_LOSS_REL or not close["params_ok"]:
        raise AssertionError(f"{arch}: card and CPU training differ")
    return card


def checkpoint_round_trip(trainers, dev) -> None:
    """Save each Trainer's {"params", "opt"} from the card and restore it
    onto the card: the same bits, every leaf."""
    from repro_torch.training import checkpoint as ckpt
    path = str(ROOT / "build" / "train_ckpt.npz")
    n = {"bfloat16": 0, "float32": 0, "int32": 0}
    for tr in trainers:
        state = {"params": tr.params, "opt": tr.opt_state}
        ckpt.save(path, state, tr.step)
        back, step = ckpt.restore(path, state)
        for (k, a), (_, b) in zip(ckpt.keyed_leaves(state),
                                  ckpt.keyed_leaves(back)):
            if not (b.device == a.device and b.dtype == a.dtype
                    and torch.equal(a.detach().reshape(-1).view(torch.uint8),
                                    b.reshape(-1).view(torch.uint8))):
                raise AssertionError(f"checkpoint leaf {k} changed")
            n[str(a.dtype).split(".")[-1]] += 1
        if step != tr.step:
            raise AssertionError("checkpoint step changed")
    os.remove(path)
    emit(phase="train", check="checkpoint save/restore on the card",
         bitwise_equal=True, leaves_by_dtype=n)


def guard_refuses(dev, wrappers) -> list:
    """Every kernel wrapper, given a CUDA input that requires grad under
    grad mode, raises instead of returning a detached result."""
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.flash_attention import ops as fl
    from repro_torch.kernels.mlstm_scan import ops as k4
    from repro_torch.kernels.ssm_scan import ops as k5
    r = lambda *s: torch.randn(*s, device=dev)
    q, kv, q1 = r(1, 64, 2, 64), r(1, 64, 1, 64), r(1, 1, 2, 64)
    c8, sc, g = torch.zeros(1, 64, 1, 64, dtype=torch.int8, device=dev), \
        torch.ones(1, 64, 1, device=dev), r(1, 64, 2)
    x, bc = r(1, 64, 2, 16), r(1, 64, 8)
    calls = {"K1": lambda t: fl.flash_attention(t, kv, kv),
             "K2": lambda t: dec.decode_attention(t[:, :1], kv, kv, 3),
             "K3": lambda t: dec.decode_attention_quant(t[:, :1], c8, sc, c8,
                                                        sc, 3),
             "K4": lambda t: k4.mlstm_scan(t, t, t, g, g),
             "K5": lambda t: k5.ssm_scan(x, g.abs(), torch.zeros(
                 2, device=dev), bc, bc, torch.ones(2, device=dev), t)}
    args = {"K1": q, "K2": q1, "K3": q1, "K4": q,
            "K5": torch.zeros(1, 2, 16, 8, device=dev)}
    refused = []
    for name, call in calls.items():
        before = wrappers[name].launches
        try:
            call(args[name].clone().requires_grad_())
        except RuntimeError as e:
            if "requires grad" in str(e) and \
                    wrappers[name].launches == before:
                refused.append(name)
                continue
            raise
        raise AssertionError(f"{name} took an input that requires grad")
    return refused


def train_phase(cfg, dev, wrappers) -> None:
    """Phase 6 (see the module's docstring)."""
    from repro_torch.examples import train_lm
    t_phase = time.monotonic()
    before = {k: w.launches for k, w in wrappers.items()}
    release_memory()
    train_full_width(cfg, dev)
    train_bf16_vs_f32(cfg, dev)
    cards = [train_card_vs_cpu(a, dev)
             for a in ("qwen3-1.7b", "granite-moe-3b-a800m")]
    # a bf16 reduced run, so that the checkpoint holds bf16 leaves
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.training import AdamWConfig, DataConfig, Trainer, \
        batches
    bcfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                               dtype="bfloat16", param_dtype="bfloat16")
    btr = Trainer(build_model(bcfg), AdamWConfig(), log_every=1, device=dev)
    btr.init(seed=0)
    data = batches(DataConfig(vocab_size=bcfg.vocab_size, seq_len=64,
                              batch_size=4, seed=6))
    btr.fit(data, 1, verbose=False)
    data.close()
    checkpoint_round_trip(cards + [btr], dev)
    t0 = time.monotonic()
    last = train_lm.main(["--device", str(dev)])
    emit(phase="train", config="repro_torch.examples.train_lm small",
         final_loss=last["loss"], limit=0.6 * last["ln_v"],
         data_floor=last["floor"], steps=last["step"],
         seconds=time.monotonic() - t0)
    after = {k: w.launches for k, w in wrappers.items()}
    refused = guard_refuses(dev, wrappers)
    emit(phase="train", check="no kernel launched while training",
         launches_before=before, launches_after=after,
         refuse_autograd=refused, seconds=time.monotonic() - t_phase)
    if after != before:
        raise AssertionError(f"kernels launched while training: {before} "
                             f"-> {after}")
    del cards, btr
    release_memory()


# --- phase 8: the simulator and the batch simulator ---------------------------

# ``python -m repro.launch.serve --mode sim --workload azure`` (the JAX
# package's launcher, its default flags) prints this object
SIM_AZURE_REFERENCE = {"policy": "mqfq-sticky", "events": 210,
                       "mean_latency_s": 33.084, "p99_latency_s": 120.698,
                       "cold_pct": 12.38, "utilization": 0.904,
                       "inter_fn_variance": 543.11}
# tests/test_batchsim.py's trace and differential matrix (size a);
# family 0 is MQFQ, 1 FCFS, 2 SJF (repro_torch.batchsim.state)
BATCH_A_TRACE = dict(n_fns=8, duration=300.0, total_rps=1.0, seed=3)
BATCH_A_CASES = [
    ("sticky-mempress", dict(family=0, T=5.0, alpha=2.0, sticky=True,
                             pool_size=3, capacity_bytes=2.5 * 2**30,
                             h2d_bw=8 * 2**30, d=2)),
    ("sfq-d1", dict(family=0, T=0.0, alpha=2.0, sticky=True, d=1)),
    ("vt-unit", dict(family=0, T=10.0, alpha=1.0, sticky=True,
                     vt_by_service=False, d=2)),
    ("deficit-d3", dict(family=0, T=10.0, alpha=2.0, sticky=True,
                        deficit_vt=True, d=3)),
    ("fcfs", dict(family=1, d=2)),
    ("sjf", dict(family=2, d=2)),
    ("window10", dict(family=0, T=10.0, alpha=4.0, sticky=True,
                      fairness_window=10.0, d=2)),
]
# the fig8 trace (benchmarks/fig8_sensitivity.py:60), 349 events (size b)
BATCH_B_TRACE = dict(n_fns=19, duration=600.0, trace_id=4)
# a stream of realistic size (size c): 96 functions over 2520 s
# (benchmarks/scale.py:758) at 2.5 requests/s (:719), ~6300 invocations;
# its duration is cut, and the cut printed, where (b)'s rate on the card
# predicts more than BATCH_C_BUDGET_S
BATCH_C_TRACE = dict(n_fns=96, duration=2520.0, total_rps=2.5, seed=0)
BATCH_C_BUDGET_S = 30.0
# sticky lanes of sensitivity_grid held per invocation to the scalar
# plane at size c: (T, alpha, vt) = (0, 0, service), (5, 1, unit),
# (10, 2, service), (50, 6, unit)
BATCH_C_CHECKED = (0, 58, 84, 142)
BATCH_INT_KEYS = ("cold", "warm", "host_warm", "pool_evictions",
                  "decisions", "n_windows", "invocations")
BATCH_FLOAT_KEYS = ("mean_latency", "p50_latency", "p99_latency", "gap_max",
                    "gap_mean", "bound_mean", "mean_utilization", "duration")
BATCH_TOL = 1e-9


def device_busy_s(fn):
    """Run ``fn()`` under torch.profiler, recording the device only; the
    summed duration (s) of the kernels and memory operations it ran on the
    card (one stream, so they do not overlap), or None if the trace holds
    none. The sum reads the profiler's raw events: a chunk of the batch
    simulator launches ~10^5 kernels, and ``profiled``'s parse of them
    into function events is not needed for a sum."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ns = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA)
    return ns / 1e9 if ns else None


def sim_phase(upload_bw) -> None:
    """``--mode sim`` on the azure workload, as a user runs it (its own
    process) and in this one; both must print the reference's object.
    Then ``--workload endpoints`` on the cost model's H100 constants, and
    the pipeline data plane (``storm_phase``)."""
    import contextlib
    import io
    from repro_torch.launch import serve
    argv = ["--mode", "sim", "--workload", "azure"]
    t0 = time.monotonic()
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *argv],
        capture_output=True, text=True, check=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    got = json.loads(cli.stdout)
    with contextlib.redirect_stdout(io.StringIO()):
        here = serve.main(argv)
    emit(phase="sim", argv=argv, result=got, equals_in_process=got == here,
         equals_reference=got == SIM_AZURE_REFERENCE,
         seconds=time.monotonic() - t0)
    if not got == here == SIM_AZURE_REFERENCE:
        raise AssertionError(f"--mode sim: {got} / {here} != "
                             f"{SIM_AZURE_REFERENCE}")

    # the assigned archs priced by the cost model on the H100's constants
    argv = ["--mode", "sim", "--workload", "endpoints"]
    t0 = time.monotonic()
    with contextlib.redirect_stdout(io.StringIO()):
        out = serve.main(argv)
    emit(phase="sim", argv=argv, result=out, seconds=time.monotonic() - t0)
    if out["events"] < 1 or not all(math.isfinite(v) for k, v in
                                    out.items() if k != "policy"):
        raise AssertionError(f"--workload endpoints: {out}")
    storm_phase(upload_bw)


# cold-start-storm (spec_profile "llm": 4-14 GB of weights behind short
# fixed stages) on one device through the pipeline data plane, its link at
# the upload rate phase "replay" measured on the card
STORM_SCENARIO = dict(n_fns=24, duration=720.0, spec_profile="llm")


def storm_phase(upload_bw) -> None:
    """``run_scenario()`` of cold-start-storm with ``datapath="pipeline"``,
    without and with anticipatory prefetch: every arrival completes; cold
    p99 of each run."""
    from repro_torch.server import ServerConfig, make_server, nearest_rank
    from repro_torch.workloads.scenarios import make_scenario
    kw = {**STORM_SCENARIO, "llm_h2d_bw": upload_bw}
    n_events = sum(1 for _ in make_scenario("cold-start-storm",
                                            **kw).stream())
    for prefetch in (False, True):
        t0 = time.monotonic()
        srv = make_server(ServerConfig(
            policy="mqfq-sticky", d=1, n_devices=1, h2d_bw=upload_bw,
            datapath="pipeline", prefetch=prefetch,
            scenario="cold-start-storm", scenario_kwargs=kw))
        res = srv.run_scenario()
        cold = sorted(i.latency for i in res.invocations
                      if i.start_type == "cold")
        dp = srv.control.devices[0].datapath
        emit(phase="sim", scenario="cold-start-storm", datapath="pipeline",
             prefetch=prefetch, h2d_bw=upload_bw, events=n_events,
             completed=res.completed_count,
             start_types=res.start_type_counts(),
             cold_p99_s=nearest_rank(cold, 0.99) if cold else None,
             p99_s=res.p99_latency(),
             prefetches_started=dp.prefetches_started,
             seconds=time.monotonic() - t0)
        if res.completed_count != n_events or dp.transfers:
            raise AssertionError(f"cold-start-storm (prefetch={prefetch}): "
                                 f"{res.completed_count} of {n_events} "
                                 f"completed")


def lane_mismatches(pa, out, g, ref, per_invocation=True) -> list:
    """Where lane ``g`` of a batch run differs from the scalar plane's run
    ``ref``: dispatch order and start types exactly, dispatch and
    completion times to 1e-9, integer aggregates exactly, float
    aggregates to 1e-9."""
    bad = []
    n = int(pa.n_events)
    raw, s = out["raw"], out["summary"][g]
    if per_invocation:
        order = np.full(n, -1, dtype=np.int64)
        for rank, inv in enumerate(ref["order"]):
            order[inv] = rank
        if not (raw["o_order"][g, :n] == order).all():
            bad.append("order")
        if not (raw["o_start"][g, :n] == ref["start"]).all():
            bad.append("start")
        for k in ("dispatch", "completion"):
            if not np.abs(raw["o_" + k][g, :n] - ref[k]).max() <= BATCH_TOL:
                bad.append(k)
    bad += [k for k in BATCH_INT_KEYS if int(s[k]) != int(ref[k])]
    if per_invocation:
        bad += [k for k in BATCH_FLOAT_KEYS
                if not abs(float(s[k]) - float(ref[k])) <= BATCH_TOL]
    return bad


def batchsim_phase(dev, smi) -> None:
    """The batch simulator's lanes on the card at three sizes (see the
    module's docstring)."""
    from repro_torch.batchsim import build_consts, init_state, make_params
    from repro_torch.batchsim import step as bstep
    from repro_torch.batchsim.sweep import (_CHUNK, _trace_from, run_batch,
                                            run_scalar_reference,
                                            sensitivity_grid, stack_params)
    from repro_torch.workloads.traces import padded_arrivals

    # (a) the differential matrix on the card against the scalar plane
    pa = padded_arrivals("zipf", **BATCH_A_TRACE)
    F = len(pa.fn_ids)
    pts = [make_params(F, **kw) for _, kw in BATCH_A_CASES]
    t0 = time.monotonic()
    out = run_batch(pa, pts, device=dev)
    secs = time.monotonic() - t0
    bad = {name: lane_mismatches(pa, out, g, run_scalar_reference(pa, pts[g]))
           for g, (name, _) in enumerate(BATCH_A_CASES)}
    bad = {k: v for k, v in bad.items() if v}
    emit(phase="batchsim", size="a", trace="zipf", **BATCH_A_TRACE,
         invocations=int(pa.n_events), lanes=len(pts), device=out["device"],
         seconds=secs, steps=out["steps"], syncs=out["syncs"],
         vs_scalar_plane="per invocation exact, times to 1e-9",
         mismatches=bad)
    if bad:
        raise AssertionError(f"batchsim (a) differs from the scalar plane: "
                             f"{bad}")

    # (b) the fig8 trace over the 144-lane sensitivity grid: the card bit
    # for bit against the CPU, the sticky lanes' integer aggregates
    # against the scalar plane
    pa = padded_arrivals("azure", **BATCH_B_TRACE)
    F = len(pa.fn_ids)
    grid = sensitivity_grid(F)
    pts = [p for _, p in grid]
    t0 = time.monotonic()
    card = run_batch(pa, pts, device=dev)
    card_s = time.monotonic() - t0
    t0 = time.monotonic()
    cpu = run_batch(pa, pts, device="cpu")
    cpu_s = time.monotonic() - t0
    differ = sorted(k for k in card["raw"]
                    if card["raw"][k].tobytes() != cpu["raw"][k].tobytes())
    tr = _trace_from(pa)
    bad = {}
    for g, (label, p) in enumerate(grid):
        if p["sticky"]:
            m = lane_mismatches(pa, card, g,
                                run_scalar_reference(pa, p, trace=tr),
                                per_invocation=False)
            if m:
                bad[label] = m
    emit(phase="batchsim", size="b", trace="azure", **BATCH_B_TRACE,
         invocations=int(pa.n_events), lanes=len(pts),
         device=card["device"], card_seconds=card_s, cpu_seconds=cpu_s,
         steps=card["steps"], syncs=card["syncs"],
         card_vs_cpu_fields_differing=differ,
         sticky_lanes_vs_scalar_mismatches=bad)
    if differ or bad:
        raise AssertionError(f"batchsim (b): card vs cpu differ in {differ}; "
                             f"sticky lanes vs scalar: {bad}")
    s_per_step = card_s / card["steps"]
    steps_per_inv = card["steps"] / int(pa.n_events)

    # (c) a stream of realistic size over the same 144 lanes
    kw = dict(BATCH_C_TRACE)
    n_full = int(padded_arrivals("zipf", **kw).n_events)
    predicted_s = s_per_step * steps_per_inv * n_full
    cut = None
    if predicted_s > BATCH_C_BUDGET_S:
        kw["duration"] = math.floor(
            BATCH_C_TRACE["duration"] * BATCH_C_BUDGET_S / predicted_s / 10
        ) * 10.0
        cut = dict(duration_from=BATCH_C_TRACE["duration"],
                   duration_to=kw["duration"], predicted_full_s=predicted_s)
    pa = padded_arrivals("zipf", **kw)
    F = len(pa.fn_ids)
    pts = [p for _, p in sensitivity_grid(F)]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    out = run_batch(pa, pts, device=dev)
    wall = time.monotonic() - t0
    events = [s["events"] for s in out["summary"]]
    # one chunk of the same run under the profiler, from the state one
    # chunk in: the device's busy time over the chunk's wall time
    consts = build_consts(pa, device=dev)
    S = max(int(p["d"]) for p in pts)
    C = max(int(p["pool_size"]) for p in pts) + S + 1
    st = init_state(F, pa.times.shape[0], S, C, 2 * F + 8, G=len(pts),
                    device=dev)
    pp = stack_params(pts, dev)
    st = bstep.simulate_chunk(pp, consts, st, _CHUNK)
    torch.cuda.synchronize()
    chunk_wall = []

    def chunk():
        t0 = time.monotonic()
        bstep.simulate_chunk(pp, consts, st, _CHUNK)
        torch.cuda.synchronize()
        chunk_wall.append(time.monotonic() - t0)
    busy = device_busy_s(chunk)
    del st, consts, pp
    # the same lanes through the scalar SimExecutor, serially on the host
    tr = _trace_from(pa)
    t0 = time.monotonic()
    refs = [run_scalar_reference(pa, p, trace=tr) for p in pts]
    scalar_s = time.monotonic() - t0
    bad = {g: lane_mismatches(pa, out, g, refs[g])
           for g in BATCH_C_CHECKED}
    bad = {g: m for g, m in bad.items() if m}
    emit(phase="batchsim", size="c", trace="zipf", **kw, cut=cut,
         invocations=int(pa.n_events), lanes=len(pts),
         device=out["device"], nvidia_smi=smi, wall_s=wall,
         steps=out["steps"], lane_events=sum(events),
         config_events_per_s=sum(events) / wall,
         syncs=out["syncs"], syncs_per_event=out["syncs"] / max(events),
         profiled_chunk=dict(
             steps=_CHUNK, wall_s=chunk_wall[0], device_busy_s=busy,
             idle_share=None if busy is None else 1.0 - busy / chunk_wall[0]),
         scalar_plane_serial_s=scalar_s,
         scalar_plane_events_per_s=sum(events) / scalar_s,
         checked_sticky_lanes=list(BATCH_C_CHECKED), mismatches=bad)
    if bad:
        raise AssertionError(f"batchsim (c) differs from the scalar plane: "
                             f"{bad}")


# --- phase 9: the mesh --------------------------------------------------------

# the dry-run on the production mesh, in its own process on the host
# (fake process group of 256, fake tensors, the kernels' plain versions)
MESH_DRYRUN = ["--arch", "qwen3-1.7b,granite-moe-3b-a800m", "--shape", "all",
               "--mesh", "single"]
MESH_DRYRUN_TIMEOUT_S = 600
# the sharded training steps: full-width qwen3-1.7b in float32 (so that
# one AdamW step moves the parameters), S 1024, B 4, ZeRO-2 in 2
# microbatches
MESH_TRAIN_SEQ, MESH_TRAIN_BATCH, MESH_TRAIN_MICROBATCH = 1024, 4, 2


def full(x):
    """A DTensor's whole value (plain tensors as they are)."""
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def start_dryrun():
    """Start ``repro_torch.launch.dryrun`` on the host (no card visible)
    in its own process; returns (process, its output directory)."""
    import shutil
    out = ROOT / "build" / "dryrun"
    shutil.rmtree(out, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *MESH_DRYRUN,
         "--out", str(out)], env=env, cwd=str(ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, out


def finish_dryrun(proc, out) -> None:
    """Wait for the dry-run; it must exit 0. One line per record: the
    per-device GB, collective GiB by kind and seconds."""
    log, _ = proc.communicate(timeout=MESH_DRYRUN_TIMEOUT_S)
    (ROOT / "build" / "dryrun.log").write_text(log)
    if proc.returncode != 0:
        raise AssertionError(f"dry-run exited {proc.returncode}:\n"
                             f"{log[-3000:]}")
    recs = [json.loads(p.read_text()) for p in sorted(out.glob("*.json"))]
    for r in recs:
        emit(phase="mesh", dryrun=f"{r['mesh']} {r['arch']} x {r['shape']}",
             argument_gb=r["memory"]["argument_bytes"] / 2**30,
             peak_per_device_gb=r["memory"]["peak_per_device_gb"],
             collective_gib_by_kind={k: v / 2**30 for k, v in
                                     r["collectives"]["by_kind_bytes"]
                                     .items()},
             collective_counts=r["collectives"]["counts"],
             seconds=r["lower_compile_s"])
    if len(recs) != 8:
        raise AssertionError(f"dry-run wrote {len(recs)} records, not 8")


def mesh_greedy(model, params, batch, plan, steps, mesh=None):
    """The endpoint's request (``TorchEndpoint._run``): prefill, then
    ``steps`` greedy decode steps; under ``mesh`` the params are
    DTensors and each step's token goes back sharded over ``data``.
    Returns the decode tokens (B, steps) on the host. Under no_grad, not
    inference_mode as the endpoint: a DTensor's views cannot be inference
    tensors."""
    from repro_torch.utils.shardctx import P, distribute
    with torch.no_grad():
        logits, cache = model.prefill_fn(params, batch, cache_len=plan.length,
                                         ring=plan.ring)
        pos = model.decode_start(batch)
        toks = []
        for i in range(steps):
            tok = torch.argmax(full(logits), -1)[:, None].to(torch.int32)
            if mesh is not None:
                tok = distribute(tok, P("data"), mesh)
            logits, cache = model.decode_fn(params, cache, tok, pos + i,
                                            ring=plan.ring)
            toks.append(full(tok))
        toks.append(torch.argmax(full(logits), -1)[:, None]
                    .to(torch.int32))
        return torch.cat(toks[1:], dim=1).cpu()


def mesh_serve(TorchEndpoint, cfg, dev, mesh, wrappers, smi):
    """One full-width qwen3-1.7b request (prefill B 4 x S 1024, 16 greedy
    decode steps) through the unsharded endpoint and through the same
    weights and prompt distributed by ``partition_specs`` under
    ``use_mesh``: equal tokens, equal K1 and K2 launches. Returns the
    sharded run's launches."""
    from repro_torch.utils.shardctx import P, distribute, use_mesh
    ep = TorchEndpoint("mesh-qwen", cfg, seed=0, serve_seq=SERVE_SEQ,
                       serve_batch=SERVE_BATCH, decode_steps=DECODE_STEPS,
                       device=dev)
    ep.upload()
    ep.compile()
    model = ep.model
    seed = 7
    for w in wrappers.values():
        w.launches = 0
    t0 = time.monotonic()
    want = torch.from_numpy(ep.execute({"seed": seed})["tokens"])
    t_plain = time.monotonic() - t0
    plain = {k: w.launches for k, w in wrappers.items()}

    specs = model.partition_specs(mesh)
    params = distribute(ep.device_params, specs, mesh)
    batch = model.make_batch(ep.serve_shape,
                             torch.Generator(dev).manual_seed(seed), dev)
    dbatch = {k: distribute(v, P("data"), mesh) for k, v in batch.items()}
    with use_mesh(mesh):
        # warm-up: the first DTensor call of each op settles its sharding
        mesh_greedy(model, params, dbatch, ep.plan, 1, mesh)
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
        t0 = time.monotonic()
        got = mesh_greedy(model, params, dbatch, ep.plan, DECODE_STEPS,
                          mesh)
        torch.cuda.synchronize()
        t_mesh = time.monotonic() - t0
    sharded = {k: w.launches for k, w in wrappers.items()}
    emit(phase="mesh", model="qwen3-1.7b full width bf16", mesh="1x1 nccl",
         B=SERVE_BATCH, S=SERVE_SEQ, decode_steps=DECODE_STEPS,
         tokens_equal=bool(torch.equal(got, want)),
         launches_unsharded=plain, launches_sharded=sharded,
         wall_s_unsharded=t_plain, wall_s_sharded=t_mesh, nvidia_smi=smi)
    if not torch.equal(got, want):
        raise AssertionError("sharded tokens differ from the endpoint's")
    if sharded != plain or not sharded["K1"] or not sharded["K2"]:
        raise AssertionError(f"launches: sharded {sharded}, unsharded "
                             f"{plain}")
    del ep, params
    return sharded


def mesh_moe(gcfg, dev, mesh):
    """Full-width granite-moe-3b-a800m, prefill and 4 decode steps on fed
    tokens: ``moe_apply_ep`` under the mesh (its per-shard
    ``_local_moe`` must run in every block) against ``moe_apply``
    without, within BF16_MODEL_REL_TOL."""
    from repro_torch.models import build_model, decode_cache_plan, moe
    from repro_torch.utils.shardctx import P, distribute, use_mesh
    t0 = time.monotonic()
    model = build_model(gcfg)
    params = model.init_params(torch.Generator(dev).manual_seed(0), dev)
    plan = decode_cache_plan(gcfg, SERVE_SEQ)
    g = torch.Generator(dev).manual_seed(0)
    batch = {"tokens": torch.randint(0, gcfg.vocab_size,
                                     (SERVE_BATCH, SERVE_SEQ), device=dev,
                                     generator=g)}
    plain, fed = trajectory(model, params, batch, plan, 4)
    calls = []
    local_moe = moe._local_moe

    def counted(*a, **kw):
        calls.append(1)
        return local_moe(*a, **kw)
    dparams = distribute(params, model.partition_specs(mesh), mesh)
    dbatch = {k: distribute(v, P("data"), mesh) for k, v in batch.items()}
    moe._local_moe = counted
    try:
        with use_mesh(mesh):
            ep, _ = trajectory(model, dparams, dbatch, plan, 4,
                               distribute(fed, P("data"), mesh),
                               grad_mode=torch.no_grad)
    finally:
        moe._local_moe = local_moe
    ep = full(ep)
    top = float(plain.abs().max())
    rel = max_err(ep, plain) / max(top, 1e-30)
    emit(phase="mesh", model="granite-moe-3b-a800m full width bf16",
         path="moe_apply_ep vs moe_apply", B=SERVE_BATCH, S=SERVE_SEQ,
         decode_steps=4, local_moe_calls=len(calls),
         max_logit_diff=max_err(ep, plain), max_abs_logit=top, rel=rel,
         bitwise_equal=bool(torch.equal(ep, plain)),
         rel_tol=BF16_MODEL_REL_TOL, seconds=time.monotonic() - t0)
    if len(calls) != gcfg.n_layers * 5:
        raise AssertionError(f"moe_apply_ep ran _local_moe {len(calls)} "
                             f"times")
    if not rel < BF16_MODEL_REL_TOL:
        raise AssertionError(f"granite moe_apply_ep vs moe_apply: {rel}")


def mesh_train(cfg, dev, mesh):
    """Full-width qwen3-1.7b in float32, one AdamW step at S 1024, B 4:
    ZeRO-1 (m, v in the ZeRO layout) and ZeRO-2 (2 microbatches, grads
    and accumulator pinned too) under the mesh against the unsharded
    step, per leaf as ``params_close_after_adamw``."""
    from repro_torch.launch.specs import zero1_shardings
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    from repro_torch.training import optimizer as opt
    from repro_torch.training.trainer import make_train_step, trainable
    from repro_torch.utils.shardctx import (P, constrain, distribute,
                                            use_mesh)
    t0 = time.monotonic()
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    model = build_model(cfg32)
    init = model.init_params(torch.Generator(dev).manual_seed(3), dev)
    tokens = torch.randint(0, cfg.vocab_size,
                           (MESH_TRAIN_BATCH, MESH_TRAIN_SEQ), device=dev,
                           generator=torch.Generator(dev).manual_seed(4),
                           dtype=torch.int32)
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    p = trainable(init)
    p, _, met = make_train_step(model, ocfg)(p, opt.adamw_init(p, ocfg),
                                             {"tokens": tokens,
                                              "labels": tokens})
    want = tree_map(lambda t: t.detach(), p)
    lr = float(met["lr"])
    del p
    release_memory()
    z1 = zero1_shardings(mesh, model)
    dinit = distribute(init, model.partition_specs(mesh), mesh)
    del init
    batch = {k: distribute(tokens, P("data"), mesh)
             for k in ("tokens", "labels")}
    for name, K, grads in (("zero1", 1, None),
                           ("zero2", MESH_TRAIN_MICROBATCH, z1)):
        t1 = time.monotonic()
        with use_mesh(mesh):
            p = trainable(dinit)
            st = opt.adamw_init(p, ocfg)
            st = opt.AdamWState(st.step, constrain(st.m, z1),
                                constrain(st.v, z1))
            p, st, m = make_train_step(model, ocfg, microbatch=K,
                                       grad_sharding=grads)(p, st, batch)
            got = tree_map(full, p)
        close = params_close_after_adamw(want, got, lr)
        emit(phase="mesh", model="qwen3-1.7b full width f32",
             train=name, microbatch=K, S=MESH_TRAIN_SEQ, B=MESH_TRAIN_BATCH,
             loss=float(full(m["loss"])), loss_unsharded=float(met["loss"]),
             grad_norm=float(full(m["grad_norm"])),
             grad_norm_unsharded=float(met["grad_norm"]), **close,
             seconds=time.monotonic() - t1)
        if not close["params_ok"]:
            raise AssertionError(f"{name} step differs from the unsharded "
                                 f"step")
        del p, st, got
        release_memory()
    emit(phase="mesh", check="training", seconds=time.monotonic() - t0)


def mesh_phase(TorchEndpoint, cfg, gcfg, dev, wrappers, smi) -> dict:
    """The sharded paths on a 1x1 NCCL mesh (world size 1, an in-process
    HashStore: no TCP), with the dry-run on the host in parallel. Returns
    the sharded serving run's launches."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_test_mesh
    t_phase = time.monotonic()
    proc, out = start_dryrun()
    try:
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1, device_id=dev)
        mesh = make_test_mesh(model=1, data=1, device_type="cuda")
        launches = mesh_serve(TorchEndpoint, cfg, dev, mesh, wrappers, smi)
        release_memory()
        mesh_moe(gcfg, dev, mesh)
        release_memory()
        mesh_train(cfg, dev, mesh)
        release_memory()
        finish_dryrun(proc, out)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        if dist.is_initialized():
            dist.destroy_process_group()
    emit(phase="mesh", step="done", seconds=time.monotonic() - t_phase)
    return launches


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
    from repro_torch.models import moe, ssm, transformer, whisper, xlstm
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
    spilling = [k for p in ptxas.values()
                for k, (_, sp) in p.get("kernels", {}).items() if sp]
    emit(phase="build", seconds=time.monotonic() - t0, per_source=secs,
         ptxas=ptxas, spilling=spilling,
         unexpected_spilling=[k for k in spilling
                              if not k.startswith(EXPECTED_SPILLERS)])

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
    check_flash(fl, hcfg, dev, [(SERVE_BATCH, SERVE_SEQ, SERVE_SEQ, True,
                                 window)], model="hymba-1.5b")
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
    check_flash(fl, gcfg, dev, [(SERVE_BATCH, SERVE_SEQ, SERVE_SEQ, True, 0)],
                model="granite-moe-3b-a800m")
    check_flash(fl, lcfg, dev, [(SERVE_BATCH, LLAVA_SEQ, LLAVA_SEQ, True,
                                 lcfg.sliding_window)],
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
    # whisper-large-v3 (20 heads of dh 64 over 20 kv heads, G 1): K1
    # non-causal over its 1500 frames (the encoder, 1500 x 1500; 1500 keys
    # leave a 28-key tail block) and from the decoder prompt (the cross
    # prefill, 432 x 1500), causal over the prompt; K2 and K3 over its
    # 1500-frame cross cache (one query over every frame: pos 1499) and
    # its 432-slot self cache after the 16 serving steps (pos 447), whose
    # CTA chunks end mid-tile
    wcfg = get_config("whisper-large-v3")       # bf16, full width
    E = wcfg.encoder_len
    check_flash(fl, wcfg, dev, [(SERVE_BATCH, E, E, False, 0),
                                (SERVE_BATCH, WHISPER_SEQ, E, False, 0),
                                (SERVE_BATCH, WHISPER_SEQ, WHISPER_SEQ, True,
                                 0)], model="whisper-large-v3")
    cross = [("cross", E - 1, False, 0)]
    check_decode(dec, attn, wcfg, dev, cross, cross,
                 model="whisper-large-v3", S=E)
    self_cache = [("full", WHISPER_SEQ + DECODE_STEPS - 1, False, 0)]
    check_decode(dec, attn, wcfg, dev, self_cache, self_cache,
                 model="whisper-large-v3", S=WHISPER_SEQ)

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
    model_phase(wcfg, dev, "whisper-large-v3", S=WHISPER_SEQ)
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
    # warm requests a second, the replay phase's unit of load
    qwen_rate = n_req / t_main
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
         # step. A prefill call (S >= k4.CHUNK) is one kernel launch,
         # the Hopper kernel's; a decode call one, the step kernel's
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
    # prefill and one step. A K5 prefill call (S >= k5.CHUNK) is one
    # kernel launch, the Hopper kernel's; a decode call one
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
    # whisper: per prefill K1 for each encoder layer and for each decoder
    # layer's self- and cross-attention (96), per decode step K2 for each
    # decoder layer's self- and cross-attention (64)
    w_launches = serve_attention_model(
        TorchEndpoint, wcfg, "whisper-large-v3", "whisper", dev,
        attn_wrappers, {"encode": (whisper, "encode"),
                        "decoder_block": (whisper, "_dec_block")},
        serve_seq=WHISPER_SEQ,
        k1_per_prefill=wcfg.n_encoder_layers + 2 * wcfg.n_layers,
        k2_per_step=2 * wcfg.n_layers)
    # -- open-loop replay of an Azure-shaped stream: all five kernels ------
    replay_launches, replay_sh_launches, upload_bw = replay_phase(
        TorchEndpoint, get_config, xcfg, dev,
        {"K1": fl.flash_attention, "K2": dec.decode_attention,
         "K3": dec.decode_attention_quant, "K4": k4.mlstm_scan,
         "K5": k5.ssm_scan}, qwen_rate)
    # -- the examples: memory_policies and quickstart, then serve_trace's
    # fcfs against mqfq-sticky over five full-width endpoints ---------------
    ex_launches = examples_phase(
        TorchEndpoint, get_config, xcfg, dev,
        {"K1": fl.flash_attention, "K2": dec.decode_attention,
         "K3": dec.decode_attention_quant, "K4": k4.mlstm_scan,
         "K5": k5.ssm_scan})
    # -- the training path: plain versions under autograd, no kernel ---------
    train_phase(cfg, dev, {"K1": fl.flash_attention,
                           "K2": dec.decode_attention,
                           "K3": dec.decode_attention_quant,
                           "K4": k4.mlstm_scan, "K5": k5.ssm_scan})

    # -- the mesh: the sharded paths on a 1x1 NCCL mesh, the dry-run on the
    # host -------------------------------------------------------------------
    mesh_launches = mesh_phase(TorchEndpoint, cfg, gcfg, dev,
                               {"K1": fl.flash_attention,
                                "K2": dec.decode_attention,
                                "K3": dec.decode_attention_quant,
                                "K4": k4.mlstm_scan, "K5": k5.ssm_scan},
                               smi)

    # -- the simulator and the batch simulator: host and torch tensor
    # code, no kernel of the port --------------------------------------------
    sim_wrappers = {"K1": fl.flash_attention, "K2": dec.decode_attention,
                    "K3": dec.decode_attention_quant, "K4": k4.mlstm_scan,
                    "K5": k5.ssm_scan}
    for w in sim_wrappers.values():
        w.launches = 0
    t0 = time.monotonic()
    sim_phase(upload_bw)
    batchsim_phase(dev, smi)
    sim_launches = {k: w.launches for k, w in sim_wrappers.items()}
    emit(phase="batchsim", check="no kernel launched by the simulators",
         launches=sim_launches, seconds=time.monotonic() - t0)
    if any(sim_launches.values()):
        raise AssertionError(f"kernels launched by the simulators: "
                             f"{sim_launches}")

    # each path's counts, zeroed just before it and read just after; the
    # kernels line carries their sums
    by_path = {"qwen3-1.7b": {k: launches[k] for k in ("K1", "K2", "K3")},
               "xlstm-350m": {"K4": launches["K4"]},
               "hymba-1.5b": h_launches,
               "granite-moe-3b-a800m": g_launches,
               "llava-next-mistral-7b": l_launches,
               "whisper-large-v3": w_launches,
               "replay": replay_launches,
               "replay-sharded": replay_sh_launches,
               "examples-fcfs": ex_launches["fcfs"],
               "examples-mqfq-sticky": ex_launches["mqfq-sticky"],
               "mesh": mesh_launches}
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

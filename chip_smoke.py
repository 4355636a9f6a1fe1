"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits non-zero:
  1. device  — CUDA must be available; the card's name and power limit
               as nvidia-smi reports them.
  2. build   — compile the CUDA kernels from ``src/repro_torch/csrc``.
  3. kernels — K1 (flash attention), K2 (decode attention) and K3 (int8
               decode attention) on the card at the serving shapes of
               full-width qwen3-1.7b, each held against its plain PyTorch
               version; kernel, plain and library times, and the card's
               bound for the same work.
  4. model   — full-width qwen3-1.7b (bf16, random weights from a seed):
               prefill + 4 decode steps through the kernels and through
               the plain versions; plus reduced f32 configs, kv_quant off
               and on.
  5. serve   — three full-width qwen3-1.7b TorchEndpoints behind the
               port's MQFQ-Sticky wall-clock control plane answer 12
               requests with cold, warm and host_warm starts, then one
               kv_quant endpoint answers 3; the kernels' launch counts
               are zeroed just before and read just after.
  6. the ``kernels`` line, the nvidia-smi line, and last
     ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor-core peak
# kernel vs plain, bf16: the largest |difference| in a row of dh outputs
# over the largest |plain value| in that row, at most 2**-6 (two to four
# bf16 ulps of the row's largest value), so the check is as tight for the
# small outputs of long causal rows as for the large ones of short rows
BF16_ROW_REL_TOL = 2.0 ** -6
F32_MODEL_TOL = 1e-3             # reduced f32 model, kernels vs plain
BF16_MODEL_REL_TOL = 5e-2        # full bf16 model: max|dlogit| / max|logit|

# full-width qwen3-1.7b serving shapes (TorchEndpoint below)
SERVE_SEQ, SERVE_BATCH, DECODE_STEPS = 1024, 4, 16


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


def profiled(fn):
    """Run ``fn()`` under torch.profiler; returns the device time (µs) of
    each GPU kernel or memory operation name it ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us()
    return by_name


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


def bound_ms(n_bytes: float, n_flops: float):
    tb = n_bytes / HBM_BYTES_PER_S * 1e3
    tf = n_flops / BF16_FLOPS * 1e3
    return max(tb, tf), ("bytes" if tb >= tf else "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def row_rel_err(out, ref) -> float:
    """Largest, over rows of the last dim, of max|out - ref| in the row
    over max|ref| in the row."""
    d = (out.float() - ref.float()).abs().amax(-1)
    return float((d / ref.float().abs().amax(-1).clamp_min(1e-30)).max())


def check_kernel(name, out, ref, **case) -> dict:
    """Hold a kernel's output against its plain version's; raise past
    the tolerance."""
    err = dict(max_abs_err=max_err(out, ref),
               max_row_rel_err=row_rel_err(out, ref),
               row_rel_tol=BF16_ROW_REL_TOL)
    if not err["max_row_rel_err"] <= BF16_ROW_REL_TOL:
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"{err} at {case}")
    return err


# --- phase 3: kernels against their plain versions ----------------------------

def check_flash(fl, cfg, dev):
    """K1 at the prefill shape (causal), with a window, and unaligned."""
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = torch.Generator(dev).manual_seed(1)
    mk = lambda B, S: tuple(
        torch.randn(B, S, n, dh, generator=g, device=dev,
                    dtype=torch.bfloat16) for n in (H, KV, KV))
    main = None
    for B, S, window in [(SERVE_BATCH, SERVE_SEQ, 0),
                         (SERVE_BATCH, SERVE_SEQ, 256), (2, 200, 0)]:
        q, k, v = mk(B, S)
        err = check_kernel("K1", fl.flash_attention(q, k, v, window=window),
                           fl.flash_attention_plain(q, k, v, window=window),
                           B=B, S=S, window=window)
        sets = [mk(B, S) for _ in range(n_sets(2 * nbytes(q, k, v)))]
        run = lambda q, k, v: fl.flash_attention(q, k, v, window=window)
        kern, kern_host = device_ms(run, sets), host_ms(run, sets)
        plain = device_ms(lambda q, k, v: fl.flash_attention_plain(
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
        if not window:
            tsets = [tuple(t.transpose(1, 2).contiguous() for t in s)
                     for s in sets]
            lib = device_ms(lambda q, k, v: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), tsets)
        m = dict(**err, ms=kern, plain_ms=plain, library_ms=lib,
                 bound_ms=b_ms, bound_by=b_by)
        emit(phase="kernel", name="K1 flash_attention", B=B, S=S, H=H,
             KV=KV, dh=dh, window=window, host_ms=kern_host, **m)
        if main is None:
            main = m
    return main


def check_decode(dec, attn, cfg, dev):
    """K2 on a full cache (query past its end, as serving decodes) and on
    a ring cache with pos > S; K3 on the int8 full cache."""
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    B, S = SERVE_BATCH, SERVE_SEQ
    g = torch.Generator(dev).manual_seed(2)
    r = lambda *s: torch.randn(*s, generator=g, device=dev,
                               dtype=torch.bfloat16)
    mk = lambda: (r(B, 1, H, dh), r(B, S, KV, dh), r(B, S, KV, dh))
    out = {}
    for label, pos, ring, window in [("full", S + DECODE_STEPS - 1, False, 0),
                                     ("ring", 3 * S + 17, True, 256)]:
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
        sp = (attn.ring_slot_positions(pos + 1, S, dev) if ring
              else attn.full_slot_positions(pos, S, dev))
        valid = (sp >= 0) & (sp <= pos)
        if window:
            valid &= sp > pos - window
        n_valid = int(valid.sum())
        # the valid slots' K/V read once, q read and the output written
        kv_bytes = 2 * B * n_valid * KV * dh * ck.element_size()
        b_ms, b_by = bound_ms(kv_bytes + 2 * nbytes(q),
                              4 * B * H * dh * n_valid)
        lib = None
        if not ring:
            tsets = [(q.transpose(1, 2).contiguous(),
                      k.transpose(1, 2).contiguous(),
                      v.transpose(1, 2).contiguous()) for q, k, v in sets]
            lib = device_ms(lambda q, k, v: F.scaled_dot_product_attention(
                q, k, v, enable_gqa=True), tsets)
        m = dict(**err, ms=kern, plain_ms=plain, library_ms=lib,
                 bound_ms=b_ms, bound_by=b_by)
        emit(phase="kernel", name="K2 decode_attention", cache=label, B=B,
             S=S, H=H, KV=KV, dh=dh, pos=pos, window=window,
             valid_slots=n_valid, host_ms=kern_host, **m)
        out.setdefault("K2", m)

    def mk8():
        q, ck, cv = mk()
        k8, ks = attn.quantize_kv(ck)
        v8, vs = attn.quantize_kv(cv)
        return q, k8, ks, v8, vs
    pos = S + DECODE_STEPS - 1
    q, k8, ks, v8, vs = mk8()
    # K3 and its plain version both dequantize in f32 with q upcast; they
    # differ only in summation order before the bf16 output rounding
    err = check_kernel(
        "K3", dec.decode_attention_quant(q, k8, ks, v8, vs, pos),
        dec.decode_attention_quant_plain(q, k8, ks, v8, vs, pos),
        cache="full int8")
    sets = [mk8() for _ in range(n_sets(nbytes(q, k8, ks, v8, vs)))]
    run = lambda *a: dec.decode_attention_quant(*a, pos)
    kern, kern_host = device_ms(run, sets), host_ms(run, sets)
    plain = device_ms(lambda *a: dec.decode_attention_quant_plain(*a, pos),
                      sets, iters=8)
    # all S slots valid: the int8 K/V and their scales read once
    b_ms, b_by = bound_ms(nbytes(k8, ks, v8, vs) + 2 * nbytes(q),
                          4 * B * H * dh * S)
    out["K3"] = dict(**err, ms=kern, plain_ms=plain, library_ms=None,
                     bound_ms=b_ms, bound_by=b_by)
    emit(phase="kernel", name="K3 decode_attention_quant", cache="full int8",
         B=B, S=S, H=H, KV=KV, dh=dh, pos=pos, host_ms=kern_host,
         **out["K3"])
    return out


# --- phase 4: the model through the kernels and the plain versions ------------

def run_model(cfg, dev, B, S, steps, seed):
    """Prefill + ``steps`` decode steps through the kernels, then the same
    tokens through the plain versions. Returns the largest logit
    difference, the largest |logit|, and the fraction of greedy tokens
    that agree."""
    from repro_torch.models import build_model, decode_cache_plan
    from repro_torch.models.transformer import PLAIN_OPS
    kern_model, plain_model = build_model(cfg), build_model(cfg, PLAIN_OPS)
    params = kern_model.init_params(torch.Generator(dev).manual_seed(seed),
                                    dev)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), device=dev,
                           generator=torch.Generator(dev).manual_seed(seed))
    plan = decode_cache_plan(cfg, S)
    diff = top = 0.0
    agree = total = 0
    with torch.inference_mode():
        lk, ck = kern_model.prefill_fn(params, {"tokens": tokens},
                                       plan.length, plan.ring)
        lp, cp = plain_model.prefill_fn(params, {"tokens": tokens},
                                        plan.length, plan.ring)
        for i in range(steps + 1):
            if not bool(torch.isfinite(lk).all()):
                raise AssertionError(f"non-finite logits at step {i}")
            if lk.shape != (B, cfg.vocab_size):
                raise AssertionError(f"logits shape {tuple(lk.shape)}")
            diff = max(diff, max_err(lk, lp))
            top = max(top, float(lp.float().abs().max()))
            tk, tp = torch.argmax(lk, -1), torch.argmax(lp, -1)
            agree += int((tk == tp).sum())
            total += B
            if i == steps:
                break
            tok = tk[:, None].to(torch.int32)   # both fed the same token
            lk, ck = kern_model.decode_fn(params, ck, tok, S + i, plan.ring)
            lp, cp = plain_model.decode_fn(params, cp, tok, S + i, plan.ring)
    torch.cuda.synchronize()
    del params
    return diff, top, agree / total


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


# requests of the main serving run: a burst of three requests for one
# function on d=2 makes the third wait for a token and reuse a finished
# request's container while the flow is still active (a warm start); a
# third function past two weights' capacity evicts, and returning to an
# evicted function gives a host_warm start
BURSTS = [["qwen-0"] * 3, ["qwen-1"] * 3, ["qwen-2"] * 3, ["qwen-0"] * 2,
          ["qwen-1"]]


def profile_request(ep):
    """One warm request of ``ep`` under torch.profiler: wall time, the
    device's busy time (summed kernel and memory-operation durations; one
    stream, so they do not overlap), its idle share, and the kernels that
    took the most device time."""
    with ep.lock:
        if not ep.resident:
            ep.upload()
        wall = []

        def request():
            t0 = time.monotonic()
            ep.execute({"seed": 99})        # ends in a synchronize
            wall.append(time.monotonic() - t0)
        by_name = profiled(request)
    wall = wall[0]
    if not by_name:
        # the trace came back without the device's activity: say so
        # rather than report an idle device
        return dict(request_wall_s=wall, device_busy_s=None,
                    idle_share=None, top_kernels_ms=None,
                    note="torch.profiler recorded no device time")
    busy = sum(by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return dict(request_wall_s=wall, device_busy_s=busy,
                idle_share=1.0 - busy / wall,
                top_kernels_ms=[[n[:90], us / 1e3] for n, us in top])


def ptxas_summary(name: str) -> dict:
    """Most registers any kernel of a source uses, and its spilled bytes,
    from the build's ``-Xptxas -v`` log."""
    from repro_torch.kernels import _build
    path = _build.BUILD / f"{name}.log"
    if not path.exists():       # built by an earlier run
        return {}
    log = path.read_text()
    regs = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill", log)]
    return dict(max_registers=max(regs, default=None),
                spill_bytes=sum(spills))


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
    from repro_torch.models import attention as attn
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
    emit(phase="build", seconds=time.monotonic() - t0, per_source=secs,
         ptxas={n: ptxas_summary(n) for n in secs})

    cfg = get_config("qwen3-1.7b")   # bf16, full width
    k1 = check_flash(fl, cfg, dev)
    k23 = check_decode(dec, attn, cfg, dev)

    t0 = time.monotonic()
    diff, top, agree = run_model(cfg, dev, SERVE_BATCH, SERVE_SEQ, 4, seed=0)
    emit(phase="model", config="qwen3-1.7b full width bf16",
         B=SERVE_BATCH, S=SERVE_SEQ, decode_steps=4, max_logit_diff=diff,
         max_abs_logit=top, rel=diff / max(top, 1e-30),
         rel_tol=BF16_MODEL_REL_TOL, greedy_agree=agree,
         seconds=time.monotonic() - t0)
    if diff / max(top, 1e-30) >= BF16_MODEL_REL_TOL:
        raise AssertionError("full-width model: kernels vs plain logits "
                             f"differ by {diff} (max |logit| {top})")
    for kv_quant in (False, True):
        small = dataclasses.replace(cfg.reduced(), kv_quant=kv_quant)
        diff, top, agree = run_model(small, dev, 2, 64, 4, seed=1)
        emit(phase="model", config=f"qwen3-1.7b reduced f32 "
             f"kv_quant={kv_quant}", max_logit_diff=diff, tol=F32_MODEL_TOL,
             greedy_agree=agree)
        if diff >= F32_MODEL_TOL or agree != 1.0:
            raise AssertionError(f"reduced f32 model (kv_quant={kv_quant}):"
                                 f" logit diff {diff}, agree {agree}")

    # -- the main path: serving, through the kernels -------------------------
    t0 = time.monotonic()
    eps = {f"qwen-{i}": TorchEndpoint(
        f"qwen-{i}", cfg, seed=i, serve_seq=SERVE_SEQ,
        serve_batch=SERVE_BATCH, decode_steps=DECODE_STEPS, device=dev)
        for i in range(3)}
    qcfg = dataclasses.replace(cfg, kv_quant=True)
    qep = {"qwen-q8": TorchEndpoint("qwen-q8", qcfg, seed=3,
                                    serve_seq=SERVE_SEQ,
                                    serve_batch=SERVE_BATCH,
                                    decode_steps=DECODE_STEPS, device=dev)}
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
    qres = serve(qep, [["qwen-q8"], ["qwen-q8", "qwen-q8"]],
                 2 * weight_bytes)
    launches = {k: w.launches for k, w in wrappers.items()}

    n_req = sum(len(b) for b in BURSTS)
    starts = res.start_type_counts()
    lats = sorted(inv.latency for inv in res.invocations)
    toks = DECODE_STEPS * SERVE_BATCH * n_req
    emit(phase="serve", requests=n_req, completed=len(res.invocations),
         start_types=starts, uploads={f: e.uploads for f, e in eps.items()},
         seconds=t_main, tokens_per_s=toks / t_main,
         p50_latency_s=lats[len(lats) // 2], max_latency_s=lats[-1],
         kv_quant_completed=len(qres.invocations),
         kv_quant_start_types=qres.start_type_counts(), launches=launches)
    if len(res.invocations) != n_req or len(qres.invocations) != 3:
        raise AssertionError("not every invocation completed")
    if any(inv.completion is None or inv.failed
           for inv in res.invocations + qres.invocations):
        raise AssertionError("an invocation failed")
    for kind in ("cold", "warm", "host_warm"):
        if starts.get(kind, 0) < 1:
            raise AssertionError(f"no {kind} start: {starts}")
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"{name} was never launched while serving")

    emit(phase="profile", endpoint="qwen-0", profiler_on=True,
         **profile_request(eps["qwen-0"]))

    rows = [("K1", "flash_attention", "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:95", k1),
            ("K2", "decode_attention",
             "src/repro_torch/csrc/decode_attention.cu",
             "src/repro/kernels/decode_attention/kernel.py:107", k23["K2"]),
            ("K3", "decode_attention_quant",
             "src/repro_torch/csrc/decode_attention.cu",
             "src/repro/kernels/decode_attention/kernel.py:207", k23["K3"])]
    print(json.dumps({"kernels": [
        dict(name=f"{k} {name}", route="cuda", source=src_,
             replaces=rep, launches=launches[k], **m)
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

"""K2 and K3: single-token decode attention against a KV cache, in model
layout.

q (B, 1, H, dh); cache k/v (B, S, KV, dh), bf16/f32 (K2) or int8 with
f32 scales (B, S, KV) (K3). Slot validity follows the reference
(``repro.kernels.decode_attention``): slot i holds the position that
``models.attention.full_slot_positions(pos, S)`` (or, for a ring,
``ring_slot_positions(pos + 1, S)``) gives it, and is valid iff that is
in [0, pos] and, with a window, above ``pos - window``; the kernels work
the positions out themselves. On a CUDA tensor the wrappers launch the
kernel of ``csrc/decode_attention.cu`` that ``kernel_for`` names
(``decode_sm90``, the Hopper kernel, for bf16 q at dh 64 and 128, every
served arch; ``decode_cluster`` otherwise); on a CPU tensor they run the
plain versions.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.models.attention import (NEG_INF, decode_attention as
                                          _model_decode_attention,
                                          dequantize_kv, full_slot_positions,
                                          ring_slot_positions)

SLOT_TILE = 32           # K2, K3: cache slots per warp tile, one per lane
MAX_CLUSTER = 8          # decode_cluster: CTAs per cluster, the portable limit
_K2_CTAS_PER_SM = 2      # decode_cluster, K2: target CTAs per SM
# decode_cluster, K3: target CTAs per SM; its int8 tiles take half K2's
# shared memory, so twice as many fit
_K3_CTAS_PER_SM = 4
MAX_GROUP = 8            # decode_cluster: query heads per kv head a launch

# K2's and K3's kernels, by the code the C entry takes
KERNELS = {"cluster": 0, "sm90": 1}
SM90_MAX_CLUSTER = 16    # decode_sm90: CTAs per cluster (non-portable)
SM90_MAX_GROUP = 16      # decode_sm90: query heads per kv head, the m-tile
SM90_WARPS = 4           # decode_sm90: consumer warps (+ one producer warp)
SM90_RING_BYTES = 65536  # decode_sm90: the deepest ring a CTA holds
# an H100 SM: shared memory, of it reserved per CTA, threads
SM_SMEM_BYTES, CTA_RESERVED_SMEM, SM_THREADS = 233472, 1024, 2048
LOG2E = 1.4426950408889634


def decode_attention_plain(q, cache_k, cache_v, pos, *, window: int = 0,
                           ring: bool = False):
    """K2's function in plain PyTorch (``models.attention
    .decode_attention``): f32 scores, p cast to the cache type for p @ V."""
    return _model_decode_attention(q, cache_k, cache_v, pos, window=window,
                                   ring=ring)


def decode_attention_quant_plain(q, cache_k, k_scale, cache_v, v_scale, pos,
                                 *, window: int = 0, ring: bool = False):
    """K3's function in plain PyTorch: the int8 cache dequantized in f32,
    q upcast to f32, attention in f32, the output cast to q's type."""
    kf = dequantize_kv(cache_k, k_scale, torch.float32)
    vf = dequantize_kv(cache_v, v_scale, torch.float32)
    out = _model_decode_attention(q.float(), kf, vf, pos, window=window,
                                  ring=ring)
    return out.to(q.dtype)


def decode_attention_quant_as_kernel(q, cache_k, k_scale, cache_v, v_scale,
                                     pos, *, window: int = 0,
                                     ring: bool = False):
    """K3's arithmetic, in plain PyTorch (tests only): the int8 values
    exactly, scores q . k8 in f32 times the slot's k scale and dh^-0.5,
    the masked softmax's p in f32 summed into l, and p times the slot's v
    scale against v8 -- rounded to bf16 when q is bf16, as the tensor-core
    pass rounds it, in f32 otherwise; the output in q's type. The kernel
    takes p against its running max, this against the row's max: the
    rounding of p is the same to its relative error."""
    B, _, H, dh = q.shape
    S, KV = cache_k.shape[1], cache_k.shape[2]
    sp = (ring_slot_positions(pos + 1, S, q.device) if ring
          else full_slot_positions(pos, S, q.device))
    valid = (sp >= 0) & (sp <= pos)
    if window:
        valid &= sp > pos - window
    qg = q.float().reshape(B, KV, H // KV, dh)
    s = torch.einsum("bkgd,bskd->bkgs", qg, cache_k.float())
    s = s * (k_scale.permute(0, 2, 1)[:, :, None] * dh ** -0.5)
    s = torch.where(valid, s, torch.full((), NEG_INF, device=q.device))
    p = torch.exp(s - s.amax(-1, keepdim=True)) * valid
    pv = p * v_scale.permute(0, 2, 1)[:, :, None]
    if q.dtype == torch.bfloat16:
        pv = pv.to(torch.bfloat16).float()
    out = torch.einsum("bkgs,bskd->bkgd", pv, cache_v.float())
    out = out / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(B, 1, H, dh).to(q.dtype)


def sm90_warp_of(k: int, stages: int) -> int:
    """The consumer warp of ``decode_sm90`` that takes a CTA's k-th tile
    with a valid slot: stage k % ``stages`` belongs to warp stage %
    ``SM90_WARPS`` alone (``stages`` 0: a ring as deep as the CTA's
    tiles, so warp k % ``SM90_WARPS``)."""
    return (k % stages if stages else k) % SM90_WARPS


def decode_sm90_plain(q, cache_k, cache_v, pos, *, n_ctas: int, chunk: int,
                      stages: int = 0, window: int = 0, ring: bool = False,
                      k_scale=None, v_scale=None):
    """``decode_sm90``'s split and merge order, in plain PyTorch (tests
    only): K2 (``k_scale`` None) or K3 over the plan (n_ctas, chunk,
    stages). CTA r takes slots [r * chunk, min(S, (r + 1) * chunk)) in
    32-slot tiles from its first slot; a tile with no valid slot is
    skipped, and the k-th tile that has one goes to warp
    ``sm90_warp_of(k, stages)``, whose online
    softmax (scores scaled to log2 units, exp2) rescales once a tile. The
    warps merge to the CTA's max, then the ranks in rank order to the
    cluster's max (a warp or CTA with no valid slot as m = -1e30, l = 0,
    acc = 0), and the output is acc / max(l, 1e-30). K3's scores take the
    slot's k scale in f32, its P.V the slot's v scale. For a bf16 q, p (K3:
    p times the v scale) is rounded to bf16 for P.V and the f32 p summed
    into l, as the kernel's tensor-core pass does; for a float32 q the
    same order runs in f32 throughout."""
    B, _, H, dh = q.shape
    S, KV = cache_k.shape[1], cache_k.shape[2]
    G, R, dev = H // KV, B * KV, q.device
    sp = (ring_slot_positions(pos + 1, S, dev) if ring
          else full_slot_positions(pos, S, dev))
    valid = (sp >= 0) & (sp <= pos)
    if window:
        valid &= sp > pos - window
    fold = lambda t: t.float().permute(0, 2, 1, 3).reshape(R, S, dh)
    qf = q.float().reshape(R, G, dh)
    kf, vf = fold(cache_k), fold(cache_v)
    quant = k_scale is not None
    if quant:
        ks = k_scale.permute(0, 2, 1).reshape(R, S)
        vs = v_scale.permute(0, 2, 1).reshape(R, S)
    scale = torch.tensor(dh ** -0.5 * LOG2E, dtype=torch.float32)
    neg = torch.full((), NEG_INF, device=dev)
    init = lambda: [torch.full((R, G), NEG_INF, device=dev),
                    torch.zeros(R, G, device=dev),
                    torch.zeros(R, G, dh, device=dev)]
    ranks = []
    for r in range(n_ctas):
        s0, s1 = r * chunk, min(S, (r + 1) * chunk)
        warps = [init() for _ in range(SM90_WARPS)]
        k = 0
        for first in range(s0, s1, SLOT_TILE):
            idx = torch.arange(first, min(first + SLOT_TILE, s1), device=dev)
            ok = valid[idx]
            if not bool(ok.any()):
                continue
            w = warps[sm90_warp_of(k, stages)]
            k += 1
            s = torch.einsum("rgd,rsd->rgs", qf, kf[:, idx])
            s = s * (ks[:, None, idx] * scale if quant else scale)
            s = torch.where(ok, s, neg)
            m_new = torch.maximum(w[0], s.amax(-1))
            alpha = torch.exp2(w[0] - m_new)
            p = torch.where(ok, torch.exp2(s - m_new[..., None]),
                            torch.zeros((), device=dev))
            pv = p * vs[:, None, idx] if quant else p
            if q.dtype == torch.bfloat16:
                pv = pv.to(torch.bfloat16).float()
            w[2] = w[2] * alpha[..., None] + torch.einsum(
                "rgs,rsd->rgd", pv, vf[:, idx])
            w[1] = w[1] * alpha + p.sum(-1)
            w[0] = m_new
        M = torch.stack([w[0] for w in warps]).amax(0)
        f = [torch.exp2(w[0] - M) for w in warps]
        acc = sum(w[2] * fw[..., None] for w, fw in zip(warps, f))
        ranks.append((M, sum(w[1] * fw for w, fw in zip(warps, f)), acc))
    M = torch.stack([m for m, _, _ in ranks]).amax(0)
    f = [torch.exp2(m - M) for m, _, _ in ranks]
    acc = sum(a * fr[..., None] for (_, _, a), fr in zip(ranks, f))
    l = sum(lr * fr for (_, lr, _), fr in zip(ranks, f))
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, 1, H, dh).to(q.dtype)


def _check(q, cache_k, cache_v, kv_dtype, scales=()) -> None:
    tensors = (q, cache_k, cache_v) + tuple(scales)
    if not (q.is_cuda and all(t.device == q.device for t in tensors)):
        raise ValueError("decode_attention: inputs must be on one CUDA "
                         "device")
    if q.dtype not in _build.DTYPES:
        raise ValueError(f"decode_attention: q dtype {q.dtype}; the kernel "
                         f"takes float32 or bfloat16")
    want_kv = q.dtype if kv_dtype is None else kv_dtype
    if cache_k.dtype != want_kv or cache_v.dtype != want_kv:
        raise ValueError(f"decode_attention: cache dtype {cache_k.dtype}, "
                         f"expected {want_kv}")
    if any(s.dtype != torch.float32 for s in scales):
        raise ValueError("decode_attention: scales must be float32")
    if q.dim() != 4 or q.shape[1] != 1 or cache_k.dim() != 4 \
            or cache_k.shape != cache_v.shape:
        raise ValueError("decode_attention: q (B, 1, H, dh) and caches "
                         "(B, S, KV, dh) expected")
    B, _, H, dh = q.shape
    if cache_k.shape[0] != B or cache_k.shape[3] != dh or H % cache_k.shape[2]:
        raise ValueError(f"decode_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(cache_k.shape)} do not match")
    if any(s.shape != cache_k.shape[:3] for s in scales):
        raise ValueError("decode_attention: scales must be (B, S, KV)")
    if dh not in _build.HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {dh} not in "
                         f"{_build.HEAD_DIMS}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("decode_attention: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, cache_k, cache_v)):
        raise ValueError("decode_attention: q and the caches must be "
                         "16-byte aligned")


@functools.lru_cache(maxsize=None)
def _sm_count(index) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def kernel_for(dtype, dh: int) -> str:
    """The kernel that runs K2 and K3 for q of ``dtype`` at head dim
    ``dh``: ``"sm90"`` (``decode_sm90``: TMA into an mbarrier ring, a
    producer warp, up to 16 query heads a launch, clusters of up to 16
    CTAs reduce-scattering through distributed shared memory; bf16 at dh
    64 and 128, the head dims of every served arch with attention) or
    ``"cluster"`` (``decode_cluster``: float32, and bf16 at dh 32 and
    256). A fixed choice: the C entry runs exactly this kernel or fails."""
    if dh not in _build.HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {dh} not in "
                         f"{_build.HEAD_DIMS}")
    if dtype == torch.bfloat16 and dh in (64, 128):
        return "sm90"
    if dtype in _build.DTYPES:
        return "cluster"
    raise ValueError(f"decode_attention: dtype {dtype}; the kernels take "
                     f"float32 or bfloat16")


def cluster_plan(B: int, S: int, KV: int, sms: int,
                 ctas_per_sm: int = _K2_CTAS_PER_SM):
    """``decode_cluster``'s launch shape for K2 on a card of ``sms`` SMs:
    one cluster of ``n_ctas`` (1 to ``MAX_CLUSTER``) CTAs per (batch, kv
    head) row, about ``ctas_per_sm`` CTAs per SM in all, each CTA over
    ``chunk`` consecutive slots and at least one ``SLOT_TILE`` of them when
    S allows. Returns (n_ctas, chunk): CTA r takes slots [r * chunk,
    min(S, (r + 1) * chunk)), and every CTA's range is non-empty."""
    want = math.ceil(ctas_per_sm * sms / (B * KV))
    n = max(1, min(MAX_CLUSTER, want, S // SLOT_TILE))
    chunk = math.ceil(S / n)
    return math.ceil(S / chunk), chunk


def quant_plan(B: int, S: int, KV: int, sms: int):
    """``decode_cluster``'s launch shape for K3: ``cluster_plan`` at
    ``_K3_CTAS_PER_SM`` CTAs per SM."""
    return cluster_plan(B, S, KV, sms, _K3_CTAS_PER_SM)


def sub_groups(G: int, max_group: int = MAX_GROUP) -> int:
    """The fewest sub-groups, each of at most ``max_group`` query heads
    and all of one size, that a kv head's group of G query heads splits
    into: the wrapper launches once per sub-group (heads q0 .. q0 + G / n
    - 1 of every group), reading q and writing the output in place.
    ``MAX_GROUP`` is ``decode_cluster``'s, ``SM90_MAX_GROUP``
    ``decode_sm90``'s."""
    n = -(-G // max_group)
    while G % n:
        n += 1
    return n


def launches_per_call(dtype, dh: int, G: int) -> int:
    """Device launches a wrapper call makes for a group of G query heads
    per kv head: one for every G up to 16 on ``decode_sm90``, up to 8 on
    ``decode_cluster``."""
    return sub_groups(G, SM90_MAX_GROUP if kernel_for(dtype, dh) == "sm90"
                      else MAX_GROUP)


def sm90_max_stages(dh: int, itemsize: int) -> int:
    """The deepest ring ``decode_sm90`` takes: stages of one 32-slot tile
    of K and of V, ``SM90_RING_BYTES`` in all (4 bf16 stages at dh 128, 8
    at dh 64 and of int8 at dh 128, 16 of int8 at dh 64)."""
    return SM90_RING_BYTES // (2 * SLOT_TILE * dh * itemsize)


def sm90_smem(G: int, dh: int, itemsize: int, n: int, stages: int) -> int:
    """``decode_sm90``'s dynamic shared memory in bytes, as
    ``csrc/decode_attention.cu::sm90_smem`` computes it (its C entry
    ``decode_attention_sm90_smem`` gives the same on the card): the ring
    (or the warps' partials, if larger), q's 16 rows, the barriers, K3's
    scales, the warps' (m, l), the cluster's gather slots, and 1024 bytes
    of alignment slack."""
    q8 = itemsize == 1
    up = lambda x, a: -(-x // a) * a
    ring = stages * 2 * SLOT_TILE * dh * itemsize
    part = SM90_WARPS * G * dh * 4
    q = up(max(ring, part), 128)
    bars = q + SM90_MAX_GROUP * (dh * 2 + (32 if q8 else 0))
    scales = bars + 16 * stages
    ml = scales + (stages * 2 * SLOT_TILE * 4 if q8 else 0)
    share = up(-(-G * dh // n), 4)
    gather = up(ml + SM90_WARPS * G * 8, 16)
    return gather + n * share * 4 + n * G * 8 + 1024


def modelled_clusters(sms: int, G: int, dh: int, itemsize: int, n: int,
                      stages: int) -> int:
    """How many clusters of n ``decode_sm90`` CTAs a card of ``sms`` H100
    SMs holds at once, counting shared memory and threads only. On the
    card the plan asks ``cudaOccupancyMaxActiveClusters`` instead, which
    also counts registers and where a cluster may be placed."""
    smem = sm90_smem(G, dh, itemsize, n, stages) + CTA_RESERVED_SMEM
    per_sm = min(32, SM_THREADS // (32 * (SM90_WARPS + 1)),
                 SM_SMEM_BYTES // smem)
    return sms * per_sm // n


def sm90_plan(B: int, S: int, KV: int, G: int, dh: int, itemsize: int,
              sms: int, clusters=None):
    """``decode_sm90``'s launch shape for B * KV (batch, kv head) rows of S
    slots, G query heads a launch, on a card of ``sms`` SMs: one cluster
    of ``n_ctas`` CTAs (1 to ``SM90_MAX_CLUSTER``) a row, CTA r over slots
    [r * chunk, min(S, (r + 1) * chunk)) in whole 32-slot tiles, a ring of
    ``stages``. ``clusters(n, stages)`` says how many clusters of n CTAs
    fit on the card at once (default: ``modelled_clusters``).

    Each consumer warp takes the same number k of tiles (a CTA 4k), k as
    small as lets the grid run in one wave (B * KV clusters resident at
    once): on the H100 one tile a warp was fastest where it fits, and
    filling more SMs with fewer tiles a CTA slower (chatglm3-6b's 8 rows
    in clusters of 8 CTAs beat 16; ``scripts/attention_variants.py``).
    The ring holds a CTA's tiles up to its deepest. Only on a card too
    small for any one-wave plan at that depth does it take fewer stages:
    the kernel gives stage s to warp s % ``SM90_WARPS`` alone, so a ring
    of fewer than 4 stages leaves warps idle, but every depth is safe.
    Where B * KV rows exceed one wave at every depth, each row takes one
    CTA with the deepest ring, in several waves. Returns (n_ctas, chunk,
    stages)."""
    rows = B * KV
    tiles = -(-S // SLOT_TILE)
    max_st = sm90_max_stages(dh, itemsize)
    if clusters is None:
        clusters = functools.partial(modelled_clusters, sms, G, dh, itemsize)

    def shape(tpc):
        tpc = min(tpc, tiles)
        return -(-S // (tpc * SLOT_TILE)), tpc * SLOT_TILE, tpc

    first = -(-tiles // (SM90_WARPS * SM90_MAX_CLUSTER))  # tiles a warp
    for cap in range(max_st, 0, -1):
        for k in range(first, -(-tiles // SM90_WARPS) + 1):
            n_ctas, chunk, tpc = shape(SM90_WARPS * k)
            stages = min(cap, tpc)
            if rows <= clusters(n_ctas, stages):
                return n_ctas, chunk, stages
    return 1, tiles * SLOT_TILE, min(max_st, tiles)


def _c_function(name: str, restype, n_ints: int):
    """A C function of the library that takes ints only (no stream)."""
    import ctypes
    fn = getattr(_build.library("decode_attention"), name)
    fn.restype = restype
    fn.argtypes = [ctypes.c_int] * n_ints
    return fn


def device_launches() -> list:
    """The device launches the library has made so far, by kernel code
    (``KERNELS``), K2's and K3's together."""
    import ctypes
    fn = _c_function("decode_attention_device_launches", ctypes.c_longlong,
                     1)
    return [fn(code) for code in sorted(KERNELS.values())]


@functools.lru_cache(maxsize=None)
def _card_clusters(index, q8: int, dh: int, G: int, n: int,
                   stages: int) -> int:
    import ctypes
    fn = _c_function("decode_attention_sm90_clusters", ctypes.c_int, 5)
    with torch.cuda.device(index):
        got = fn(q8, dh, G, n, stages)
    if got < 0:
        raise RuntimeError(f"decode_attention: CUDA error {-got} asking how "
                           f"many clusters fit")
    return got


@functools.lru_cache(maxsize=None)
def _sm90_plan_on(index, B, S, KV, G, dh, itemsize):
    """``sm90_plan`` on card ``index``, its fit from
    ``cudaOccupancyMaxActiveClusters``."""
    q8 = int(itemsize == 1)
    return sm90_plan(B, S, KV, G, dh, itemsize, _sm_count(index),
                     lambda n, st: _card_clusters(index, q8, dh, G, n, st))


def launch_plan(q_dtype, kv_dtype, B: int, S: int, H: int, KV: int, dh: int,
                device) -> dict:
    """What a wrapper call at these shapes launches on ``device``: the
    kernel, its launches, and its plan (n_ctas, chunk and, for
    ``decode_sm90``, stages). A new dict each call."""
    index = torch.device(device).index
    return dict(_launch_plan(q_dtype, kv_dtype, B, S, H, KV, dh,
                             torch.cuda.current_device() if index is None
                             else index))


@functools.lru_cache(maxsize=None)
def _launch_plan(q_dtype, kv_dtype, B, S, H, KV, dh, index) -> tuple:
    """``launch_plan`` on card ``index``, decided once per shape (the
    wrapper reads it on every call)."""
    G = H // KV
    kernel = kernel_for(q_dtype, dh)
    n_sub = launches_per_call(q_dtype, dh, G)
    if kernel == "sm90":
        n, chunk, stages = _sm90_plan_on(index, B, S, KV, G // n_sub, dh,
                                         kv_dtype.itemsize)
    else:
        plan = quant_plan if kv_dtype == torch.int8 else cluster_plan
        (n, chunk), stages = plan(B, S, KV, _sm_count(index)), 0
    return tuple(dict(kernel=kernel, launches=n_sub, n_ctas=n, chunk=chunk,
                      stages=stages).items())


def _launch(name, q, caches, pos, window, ring):
    """K2 (``caches`` = k, v) or K3 (k, k_scale, v, v_scale) through the C
    entry ``name``, on the kernel ``kernel_for`` names: one launch per
    sub-group of g query heads of each kv head's group, reading q and
    writing the output in place."""
    B, _, H, dh = q.shape
    S, KV = caches[0].shape[1], caches[0].shape[2]
    plan = dict(_launch_plan(q.dtype, caches[0].dtype, B, S, H, KV, dh,
                             q.device.index))
    G = H // KV
    g = G // plan["launches"]
    o = torch.empty_like(q)
    fn = _build.entry("decode_attention", name, len(caches) + 2, 15)
    ptrs = [q.data_ptr()] + [t.data_ptr() for t in caches] + [o.data_ptr()]
    for q0 in range(0, G, g):
        err = fn(*ptrs, KERNELS[plan["kernel"]], _build.DTYPES[q.dtype], B,
                 S, KV * g, KV, G, q0, dh, int(pos), int(window), int(ring),
                 plan["n_ctas"], plan["chunk"], plan["stages"], dh ** -0.5,
                 torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(err, name)
    return o


def decode_attention(q, cache_k, cache_v, pos, *, window: int = 0,
                     ring: bool = False):
    """Decode attention over a bf16/f32 cache: K2 on a CUDA tensor, the
    plain version on a CPU tensor; raises if autograd would record an
    input."""
    _build.refuse_dtensor("decode_attention", q, cache_k, cache_v)
    _build.refuse_autograd("decode_attention", q, cache_k, cache_v)
    if q.device.type == "cpu":
        return decode_attention_plain(q, cache_k, cache_v, pos,
                                      window=window, ring=ring)
    _check(q, cache_k, cache_v, None)
    o = _launch("decode_attention_group_fwd", q, (cache_k, cache_v), pos,
                window, ring)
    _build.count_launch(decode_attention)
    return o


def decode_attention_quant(q, cache_k, k_scale, cache_v, v_scale, pos, *,
                           window: int = 0, ring: bool = False):
    """Decode attention over an int8 cache: K3 on a CUDA tensor, the plain
    version on a CPU tensor; raises if autograd would record an input."""
    _build.refuse_dtensor("decode_attention_quant", q, cache_k, k_scale,
                          cache_v, v_scale)
    _build.refuse_autograd("decode_attention_quant", q, cache_k, k_scale,
                           cache_v, v_scale)
    if q.device.type == "cpu":
        return decode_attention_quant_plain(q, cache_k, k_scale, cache_v,
                                            v_scale, pos, window=window,
                                            ring=ring)
    _check(q, cache_k, cache_v, torch.int8, (k_scale, v_scale))
    o = _launch("decode_attention_q8_fwd", q,
                (cache_k, k_scale, cache_v, v_scale), pos, window, ring)
    _build.count_launch(decode_attention_quant)
    return o


decode_attention.launches = 0
decode_attention_quant.launches = 0

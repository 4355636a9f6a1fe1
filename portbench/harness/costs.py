"""The yardstick's arithmetic: operations and bytes of the work a served
invocation needs, from the configuration's sizes, and the card's peaks.

Matrix products count 2 operations a multiply-add. A token's layer costs
2 x its layer's weights; attention costs 4 x heads x head dim for each
(query, key) pair it attends; the output head runs at the prompt's last
position and at each decode step only, as the endpoint computes it. The
embedding is a lookup and counts nothing; norms, rotary embeddings and the
activation function are not counted. Bytes count each input read once and
each output written once.
"""
from __future__ import annotations

import functools
from typing import Dict

from portbench.reference.model import cache_of, decode_keys
from portbench.reference.weights import head_dim

# NVIDIA H100 SXM, dense, from NVIDIA's data sheet (at 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: operations or bytes."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def layer_weights(arch: Dict) -> int:
    """Weights a token multiplies in one layer (projections and the
    SwiGLU feed-forward)."""
    d, ff = arch["hidden_size"], arch["intermediate_size"]
    H, KV, dh = arch["num_attention_heads"], arch["num_key_value_heads"], \
        head_dim(arch)
    return d * H * dh + 2 * d * KV * dh + H * dh * d + 3 * d * ff


@functools.lru_cache(maxsize=None)
def pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs attended with queries at 0..sq-1 and keys at
    0..sk-1: key j <= query i when causal, and j > i - window."""
    total = 0
    for i in range(sq):
        hi = min(i, sk - 1) if causal else sk - 1
        lo = max(0, i - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


def invocation_flops(arch: Dict, batch: int, seq: int, steps: int) -> float:
    """Operations of one invocation: a prefill of ``seq`` positions and
    ``steps`` decode steps, ``batch`` rows."""
    L, d, V = arch["num_hidden_layers"], arch["hidden_size"], \
        arch["vocab_size"]
    per_pair = 4 * arch["num_attention_heads"] * head_dim(arch)
    window = arch.get("sliding_window") or 0
    lw, head = 2 * layer_weights(arch), 2 * d * V
    flops = batch * (seq * L * lw + L * per_pair * pairs(seq, seq, True,
                                                         window) + head)
    cache = cache_of(arch, seq)
    for m in range(steps):
        keys = len(decode_keys(cache, seq, seq + m, window))
        flops += batch * (L * lw + L * per_pair * keys + head)
    return float(flops)


def invocation_tokens(batch: int, seq: int, steps: int) -> int:
    """Positions an invocation runs: its prompt and its decode steps."""
    return batch * (seq + steps)


def k1_cost(B, Sq, Sk, H, KV, dh, causal, window, itemsize=2):
    """(operations, bytes) of one prefill attention call (K1)."""
    flops = 4 * B * H * dh * pairs(Sq, Sk, causal, window)
    nbytes = itemsize * (2 * B * Sq * H * dh + 2 * B * Sk * KV * dh)
    return flops, nbytes


def valid_slots(slots: int, pos: int, window: int, ring: bool) -> int:
    """Cache slots a decode query at ``pos`` attends: the program's rule
    (a ring slot holds the latest position written to it; slot i of a full
    cache counts as position i)."""
    if ring:
        n = min(pos + 1, slots)
        return min(n, window) if window else n
    hi = min(pos, slots - 1)
    lo = max(0, pos - window + 1) if window else 0
    return max(0, hi - lo + 1)


def k2_cost(B, H, KV, dh, n_slots, itemsize=2, cache_itemsize=2):
    """(operations, bytes) of one decode attention call (K2) over
    ``n_slots`` valid slots."""
    flops = 4 * B * H * dh * n_slots
    nbytes = itemsize * 2 * B * H * dh + cache_itemsize * 2 * B * n_slots \
        * KV * dh
    return flops, nbytes

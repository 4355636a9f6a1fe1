"""The yardstick's operation and byte counts against counts by hand at
the cells' shapes."""
import json

import pytest

from portbench.harness import costs, loader
from portbench.reference.model import cache_of, decode_keys

CONF = loader.BENCH_DIR / "configs"
QWEN = json.loads((CONF / "qwen3x8-swap.json").read_text())[
    "archs"]["qwen3-1.7b"]
LLAVA = json.loads((CONF / "llava-qwen3x3.json").read_text())[
    "archs"]["llava-next-mistral-7b"]


def test_layer_weights_by_hand():
    # qwen3-1.7b: q 2048x2048, k and v 2048x1024, o 2048x2048, ff 3x2048x6144
    assert costs.layer_weights(QWEN) == 50_331_648
    # mistral-7b: q 4096x4096, k/v 4096x1024, o 4096x4096, ff 3x4096x14336
    assert costs.layer_weights(LLAVA) == 218_103_808


def test_pairs_by_hand():
    assert costs.pairs(2048, 2048, True, 0) == 2048 * 2049 // 2
    assert costs.pairs(4096, 4096, True, 4096) == 4096 * 4097 // 2
    # a window of 4: rows 0..3 see 1..4 keys, the other 6 rows 4 each
    assert costs.pairs(10, 10, True, 4) == 1 + 2 + 3 + 4 + 6 * 4
    assert costs.pairs(3, 5, False, 0) == 15


def test_decode_keys_follow_the_cache():
    # a full cache of the prompt's 8 slots: the decoded token's key goes to
    # the last slot, so it sees the prompt's first 7 keys and its own
    assert decode_keys(("full", 8), 8, 10, 0) == list(range(7)) + [10]
    # a ring of 4: the last 4 positions
    assert decode_keys(("ring", 4), 8, 10, 4) == [7, 8, 9, 10]
    assert cache_of(QWEN, 2048) == ("full", 2048)
    # Mistral-7B v0.2 attends to the whole context: a full cache, as qwen's
    assert cache_of(LLAVA, 4096) == ("full", 4096)
    assert cache_of({"sliding_window": 4096}, 8192) == ("ring", 4096)


def test_qwen_invocation_flops_by_hand():
    B, S, n = 8, 2048, 4
    per_token = 2 * 28 * 50_331_648
    attn = 4 * 16 * 128 * 28
    head = 2 * 2048 * 151_936
    prefill = B * (S * per_token + attn * S * (S + 1) // 2 + head)
    decode = n * B * (per_token + attn * 2048 + head)
    assert costs.invocation_flops(QWEN, B, S, n) == prefill + decode
    # about 50 TFLOP, two thirds of it the prompt's GEMMs
    assert 49e12 < prefill + decode < 51e12


def test_llava_invocation_flops_by_hand():
    B, S, n = 4, 4096, 4
    per_token = 2 * 32 * 218_103_808
    attn = 4 * 32 * 128 * 32
    head = 2 * 4096 * 32_064
    prefill = B * (S * per_token + attn * S * (S + 1) // 2 + head)
    decode = n * B * (per_token + attn * 4096 + head)
    assert costs.invocation_flops(LLAVA, B, S, n) == prefill + decode
    assert costs.invocation_tokens(B, S, n) == 16_400


def test_k1_cost_at_llava_matches_its_known_bound():
    flops, nbytes = costs.k1_cost(4, 4096, 4096, 32, 8, 128, True, 4096)
    assert flops == 4 * 4 * 32 * 128 * (4096 * 4097 // 2)
    assert nbytes == 2 * (2 * 4 * 4096 * 32 * 128 + 2 * 4 * 4096 * 8 * 128)
    # PERF.md's K1 row: bound 0.5560 ms at this shape, by operations
    assert costs.bound_s(flops, nbytes) == pytest.approx(0.5560e-3, rel=1e-3)


def test_k2_cost_at_qwen_by_hand():
    n = costs.valid_slots(2048, 2050, 0, False)
    assert n == 2048
    flops, nbytes = costs.k2_cost(8, 16, 8, 128, n)
    assert flops == 4 * 8 * 16 * 128 * 2048
    assert nbytes == 2 * 2 * 8 * 16 * 128 + 2 * 2 * 8 * 2048 * 8 * 128
    assert costs.bound_s(flops, nbytes) == nbytes / 3.35e12


@pytest.mark.parametrize("slots,pos,window,ring,want", [
    (4096, 4096, 4096, True, 4096), (16, 5, 0, True, 6),
    (16, 40, 8, True, 8), (8, 3, 0, False, 4), (8, 20, 0, False, 8),
    (8, 6, 3, False, 3)])
def test_valid_slots(slots, pos, window, ring, want):
    assert costs.valid_slots(slots, pos, window, ring) == want

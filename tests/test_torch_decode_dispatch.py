"""Which kernel runs K2 and K3 (decode attention), and the launch plan of
their Hopper kernel, on the CPU.

``kernel_for`` names the kernel the C entries run: ``decode_sm90`` (the
Hopper kernel: TMA into an mbarrier ring, up to 16 query heads a launch,
clusters of up to 16 CTAs) for bf16 q at dh 64 and 128, the head dims of
every served arch with attention (read off the configs of
``repro_torch.configs``), and ``decode_cluster`` for float32
q and for bf16 at dh 32 and 256. ``sm90_plan`` is held at every decode
shape of ``chip_smoke.py``'s kernel phase and over the plan shapes of
``tests/test_torch_kernels.py`` on cards of 132, 114 and 16 SMs: it
covers every slot once in whole tiles, takes one launch for a group of up
to 16 query heads, fits one wave (by shared memory and threads, the model
the CPU can compute; on the card the plan asks
``cudaOccupancyMaxActiveClusters``) in clusters of at most 16 CTAs.
Imports no JAX.
"""
from __future__ import annotations

import math
import re
from pathlib import Path

import pytest
import torch

from repro_torch.configs import all_configs
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import ops as dec

CSRC = Path(dec.__file__).resolve().parents[2] / "csrc"


def _attention_shapes():
    """(arch, H, KV, dh) of every config with attention (xLSTM has none)."""
    return [(a, c.n_heads, c.n_kv_heads, c.head_dim)
            for a, c in all_configs().items() if c.family != "ssm"]


def test_the_served_archs_are_found():
    assert sorted(a for a, *_ in _attention_shapes()) == sorted(
        ["qwen3-moe-30b-a3b", "chatglm3-6b", "qwen3-1.7b",
         "granite-moe-3b-a800m", "llava-next-mistral-7b", "qwen1.5-32b",
         "whisper-large-v3", "deepseek-coder-33b", "hymba-1.5b"])


@pytest.mark.parametrize("arch,H,KV,dh", _attention_shapes())
def test_served_archs_take_sm90_in_one_launch(arch, H, KV, dh):
    assert dec.kernel_for(torch.bfloat16, dh) == "sm90"
    assert H // KV <= dec.SM90_MAX_GROUP
    assert dec.launches_per_call(torch.bfloat16, dh, H // KV) == 1


@pytest.mark.parametrize("dh", _build.HEAD_DIMS)
def test_float32_and_other_head_dims_take_decode_cluster(dh):
    assert dec.kernel_for(torch.float32, dh) == "cluster"
    want = "sm90" if dh in (64, 128) else "cluster"
    assert dec.kernel_for(torch.bfloat16, dh) == want


@pytest.mark.parametrize("dtype,dh", [(torch.bfloat16, 16),
                                      (torch.bfloat16, 48),
                                      (torch.float32, 96),
                                      (torch.bfloat16, 512),
                                      (torch.float16, 64)])
def test_unsupported_dtypes_and_head_dims_raise(dtype, dh):
    with pytest.raises(ValueError):
        dec.kernel_for(dtype, dh)


@pytest.mark.parametrize("G,sm90,cluster", [(1, 1, 1), (8, 1, 1),
                                            (9, 1, 3), (16, 1, 2),
                                            (17, 17, 17), (24, 2, 3),
                                            (32, 2, 4)])
def test_launches_per_call_by_kernel(G, sm90, cluster):
    """Up to 16 query heads a launch on decode_sm90, 8 on decode_cluster;
    a larger group splits into the fewest equal sub-groups."""
    assert dec.launches_per_call(torch.bfloat16, 128, G) == sm90
    assert dec.launches_per_call(torch.float32, 128, G) == cluster
    assert dec.launches_per_call(torch.bfloat16, 256, G) == cluster


def test_kernel_codes_are_the_c_entries():
    """The codes the C entries take (``CLUSTER``, ``SM90`` in the source)
    and the Hopper kernel's limits."""
    src = (CSRC / "decode_attention.cu").read_text()
    assert dec.KERNELS == {"cluster": 0, "sm90": 1}
    assert "constexpr int CLUSTER = 0, SM90 = 1;" in src
    for name, value in [("SM90_WARPS", dec.SM90_WARPS),
                        ("SM90_MAX_CLUSTER", dec.SM90_MAX_CLUSTER),
                        ("SM90_MAX_GROUP", dec.SM90_MAX_GROUP),
                        ("TS", dec.SLOT_TILE)]:
        assert re.search(rf"constexpr int {name} = {value};", src), name


# (B, S, KV, G, dh): the decode shapes of chip_smoke.py's kernel phase
# (qwen3-1.7b, hymba-1.5b's ring, chatglm3-6b, granite-moe-3b-a800m,
# llava-next-mistral-7b's ring, deepseek-coder-33b, qwen1.5-32b, and
# whisper-large-v3's cross and self caches)
CHIP_SMOKE_SHAPES = [(4, 1024, 8, 2, 128), (4, 1024, 5, 5, 64),
                     (4, 1024, 2, 16, 128), (4, 1024, 8, 3, 64),
                     (4, 4096, 8, 4, 128), (4, 1024, 8, 7, 128),
                     (4, 1024, 40, 1, 128), (4, 1500, 20, 1, 64),
                     (4, 432, 20, 1, 64)]
PLAN_SHAPES = [(4, 1024, 8), (4, 1024, 5), (8, 1024, 8), (16, 1024, 4),
               (1, 1, 1), (1, 31, 2), (1, 32, 1), (2, 33, 4), (1, 65, 1),
               (1, 100, 2), (3, 257, 5), (3, 300, 5), (2, 4096, 8),
               (1, 1000, 1)]


def _check_plan(B, S, KV, G, dh, itemsize, sms):
    n, chunk, stages = dec.sm90_plan(B, S, KV, G, dh, itemsize, sms)
    # clusters of at most 16 CTAs
    assert 1 <= n <= dec.SM90_MAX_CLUSTER
    # every slot exactly once, every CTA's range non-empty, whole tiles
    ranges = [range(r * chunk, min(S, (r + 1) * chunk)) for r in range(n)]
    assert [s for r in ranges for s in r] == list(range(S))
    assert all(len(r) > 0 for r in ranges)
    assert chunk % dec.SLOT_TILE == 0
    tpc = chunk // dec.SLOT_TILE
    assert 1 <= stages <= min(tpc, dec.sm90_max_stages(dh, itemsize))
    # one launch for G <= 16
    assert dec.launches_per_call(torch.bfloat16, dh, G) == 1
    # one wave: B * KV clusters resident at once, by shared memory and
    # threads
    smem = dec.sm90_smem(G, dh, itemsize, n, stages)
    assert smem <= dec.SM_SMEM_BYTES - dec.CTA_RESERVED_SMEM
    per_sm = min(dec.SM_THREADS // (32 * (dec.SM90_WARPS + 1)),
                 dec.SM_SMEM_BYTES // (smem + dec.CTA_RESERVED_SMEM))
    assert B * KV <= dec.modelled_clusters(sms, G, dh, itemsize, n, stages)
    assert B * KV * n <= sms * per_sm
    return n, chunk, stages


@pytest.mark.parametrize("B,S,KV,G,dh", CHIP_SMOKE_SHAPES)
@pytest.mark.parametrize("itemsize", [2, 1])
def test_sm90_plan_at_the_chip_smoke_shapes(B, S, KV, G, dh, itemsize):
    """On the H100's 132 SMs: one wave, and each consumer warp as many
    tiles as every other (a CTA's tiles a multiple of the warps, or the
    whole row), all of a CTA's tiles in flight where its ring holds them."""
    n, chunk, stages = _check_plan(B, S, KV, G, dh, itemsize, 132)
    tpc = chunk // dec.SLOT_TILE
    assert tpc % dec.SM90_WARPS == 0 or n == 1
    assert stages == min(tpc, dec.sm90_max_stages(dh, itemsize))


@pytest.mark.parametrize("B,S,KV", PLAN_SHAPES)
@pytest.mark.parametrize("sms", [132, 114, 16])
@pytest.mark.parametrize("G,dh,itemsize", [(1, 64, 2), (7, 128, 2),
                                           (16, 128, 2), (5, 64, 1),
                                           (16, 128, 1)])
def test_sm90_plan_covers_every_slot_once_in_one_wave(B, S, KV, sms, G, dh,
                                                      itemsize):
    _check_plan(B, S, KV, G, dh, itemsize, sms)


def test_sm90_plan_takes_fewer_stages_only_on_a_small_card():
    """64 rows of dh 128 on 16 SMs: the deepest ring leaves two waves, so
    the plan takes a shallower one; the H100 keeps the deepest."""
    assert dec.sm90_plan(16, 1024, 4, 1, 128, 2, 16)[2] < 4
    assert dec.sm90_plan(16, 1024, 4, 1, 128, 2, 132)[2] == 4


def test_sm90_plan_beyond_one_wave_takes_one_cta_a_row_and_the_deepest_ring():
    """More rows than one wave holds at any depth (qwen1.5-32b's 40 kv
    heads at B 64): one CTA a row over the whole cache with the deepest
    ring, in several waves."""
    for sms in (132, 16):
        assert dec.sm90_plan(64, 1024, 40, 1, 128, 2, sms) == (1, 1024, 4)
    assert dec.sm90_plan(64, 1024, 40, 1, 64, 1, 132) == (1, 1024, 16)
    assert dec.sm90_plan(64, 40, 40, 1, 64, 1, 16) == (1, 64, 2)


@pytest.mark.parametrize("stages", range(1, 17))
def test_sm90_each_stage_has_one_consumer_warp(stages):
    """The kernel's consumers wait on a stage's full barrier by the parity
    of its phase, which is right only if the waiting warp has consumed the
    stage's earlier phase itself: each stage belongs to one warp, at every
    ring depth, and every warp takes tiles where the depth is a multiple of
    the warps or covers a CTA's tiles."""
    owner = {}
    for k in range(8 * stages):
        w = dec.sm90_warp_of(k, stages)
        assert owner.setdefault(k % stages, w) == w
    used = set(owner.values())
    assert len(used) == min(stages, dec.SM90_WARPS)
    if stages % dec.SM90_WARPS == 0:
        counts = [list(owner.values()).count(w) for w in used]
        assert len(set(counts)) == 1
    assert [dec.sm90_warp_of(k, 0) for k in range(8)] == [0, 1, 2, 3] * 2
    src = (CSRC / "decode_attention.cu").read_text()
    assert "const int st = kk % n_stages;\n    if (st % SM90_WARPS != warp)" \
        in src


def test_sm90_plan_asks_the_card_for_the_fit():
    """The plan reads how many clusters fit from ``clusters(n, stages)``:
    where the card holds fewer, it gives each warp more tiles."""
    B, S, KV, G, dh = 4, 1024, 8, 2, 128
    roomy = dec.sm90_plan(B, S, KV, G, dh, 2, 132, lambda n, st: 10 ** 6)
    assert roomy == (8, 128, 4)
    # room for 248 CTAs: 31 clusters of 8 (the 32 rows need 32)
    tight = dec.sm90_plan(B, S, KV, G, dh, 2, 132, lambda n, st: 248 // n)
    assert tight == (4, 256, 4)


def test_sm90_smem_counts_every_region():
    """The mirror of the C layout: the ring or the partials, whichever is
    larger, q's 16 rows, barriers, scales, (m, l) and the gather slots."""
    # qwen3-1.7b's plan: 4 stages of 16 KB; G 2 partials are smaller
    got = dec.sm90_smem(2, 128, 2, 8, 4)
    ring = 4 * 2 * 32 * 128 * 2
    share = math.ceil(2 * 128 / 8 / 4) * 4
    gather = ring + 16 * 256 + 16 * 4 + 4 * 2 * 8
    assert got == gather + 8 * share * 4 + 8 * 2 * 8 + 1024
    # chatglm3-6b's G 16 at 2 stages: the warps' partials (32 KB) set the
    # size of the first region
    assert dec.sm90_smem(16, 128, 2, 16, 2) > 4 * 16 * 128 * 4

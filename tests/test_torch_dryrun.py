"""The port's dry-run (``repro_torch.launch.dryrun``) on meshes of the
``fake`` process group, in this process: records with the reference's
keys for a reduced arch on a 2x2 mesh (every shape) and for full-width
qwen3-1.7b ``decode_32k`` on the 16x16 production mesh, and
``analysis.hlo.collective_bytes`` held to the reference's byte convention
on products whose collectives are known.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import (Partial, Replicate, Shard,  # noqa: E402
                                      distribute_tensor)

from repro_torch.analysis.hlo import (CollectiveRecorder,  # noqa: E402
                                      collective_bytes)
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.shapes import SHAPE_NAMES  # noqa: E402

# the reference's record (repro/launch/dryrun.py:run_one), key by key
REF_KEYS = {
    "arch", "shape", "mesh", "chips", "lower_compile_s", "memory",
    "hlo_cost", "analytic", "collectives", "roofline"}
REF_SUBKEYS = {
    "memory": {"argument_bytes", "output_bytes", "temp_bytes",
               "peak_per_device_gb"},
    "hlo_cost": {"flops_per_device", "bytes_per_device"},
    "analytic": {"flops", "weight_bytes", "kv_bytes", "act_bytes",
                 "model_flops_6nd"},
    "collectives": {"total_bytes", "by_kind_bytes", "counts", "scan_trips"},
    "roofline": {"compute_s", "memory_s", "collective_s", "dominant"}}


@pytest.fixture
def fake4():
    dryrun.fake_world(4)
    yield make_test_mesh(model=2, data=2)
    dist.destroy_process_group()


def _check_record(rec, arch, shape, mesh, chips):
    assert REF_KEYS <= set(rec)
    for k, sub in REF_SUBKEYS.items():
        assert sub <= set(rec[k]), k
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["chips"]) == \
        (arch, shape, mesh, chips)
    m = rec["memory"]
    assert m["argument_bytes"] > 0 and m["temp_bytes"] >= 0
    # the peak is the arguments and what the step makes, in GB to 3 places
    assert abs(m["peak_per_device_gb"] - (m["argument_bytes"]
                                          + m["temp_bytes"]) / 2**30) <= 1e-3
    assert rec["collectives"]["total_bytes"] == sum(
        rec["collectives"]["by_kind_bytes"].values())


@pytest.mark.parametrize("shape", SHAPE_NAMES)
def test_reduced_arch_records_on_the_2x2_mesh(fake4, monkeypatch, shape):
    """Reduced qwen3-1.7b (the registry's config cut by ``reduced()``)
    through every shape on a fake 2x2 mesh: the step runs, the argument
    bytes are the local shards' and every collective it issues is one the
    sharded path needs (an all-reduce at least: row-parallel products)."""
    real = specs.get_config
    monkeypatch.setattr(specs, "get_config", lambda a: real(a).reduced())
    rec = dryrun.record("qwen3-1.7b", shape, fake4, "test_2x2")
    _check_record(rec, "qwen3-1.7b", shape, "test_2x2", 4)
    assert rec["collectives"]["counts"].get("all-reduce", 0) > 0


def test_full_width_decode_records_on_the_production_mesh(tmp_path):
    """Full-width qwen3-1.7b ``decode_32k`` on the 16x16 mesh (256 fake
    ranks): the record file, its argument bytes the reference's sum, and
    the cache gathered from its slots-over-model input layout."""
    try:
        rec = dryrun.run_one("qwen3-1.7b", "decode_32k", False,
                             str(tmp_path), verbose=False)
    finally:
        dist.destroy_process_group()
    _check_record(rec, "qwen3-1.7b", "decode_32k", "pod_16x16", 256)
    assert (tmp_path / "pod_16x16__qwen3-1.7b__decode_32k.json").exists()
    sizes = {"data": 16, "model": 16}

    class StandIn:
        shape = sizes
    _, _, shapes, sp, _ = specs.lowering_specs("qwen3-1.7b", "decode_32k",
                                               StandIn())
    assert rec["memory"]["argument_bytes"] == specs.argument_bytes(
        shapes, sp, StandIn())
    assert rec["collectives"]["by_kind_bytes"]["all-gather"] > 0


def test_collective_bytes_convention(fake4):
    """A row-parallel product (x sharded on K over ``model``, w on its
    rows): its Partial result all-reduced counts twice the local (4, 6)
    float32 operand; reduce-scattered, the operand once; a (8, 6) float32
    table sharded over ``data`` all-gathered, the result once. Trip
    scaling multiplies counts and bytes."""
    mesh = fake4
    x = distribute_tensor(torch.ones(4, 8), mesh, [Replicate(), Shard(1)])
    w = distribute_tensor(torch.ones(8, 6), mesh, [Replicate(), Shard(0)])
    t = distribute_tensor(torch.ones(8, 6), mesh, [Shard(0), Replicate()])
    with CollectiveRecorder() as rec:
        y = x @ w
        assert y.placements == (Replicate(), Partial())
        y.redistribute(mesh, [Replicate(), Replicate()])
        y.redistribute(mesh, [Replicate(), Shard(0)])
        t.redistribute(mesh, [Replicate(), Replicate()])
    stats = collective_bytes(rec.record)
    f32 = 4
    assert dict(stats.counts) == {"all-reduce": 1, "reduce-scatter": 1,
                                  "all-gather": 1}
    assert dict(stats.bytes_by_kind) == {
        "all-reduce": 2 * 4 * 6 * f32, "reduce-scatter": 4 * 6 * f32,
        "all-gather": 8 * 6 * f32}
    assert stats.total_bytes == (2 * 24 + 24 + 48) * f32
    tripled = collective_bytes(rec.record, 3)
    assert tripled.counts["all-reduce"] == 3
    assert tripled.total_bytes == 3 * stats.total_bytes


def _wrappers():
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.flash_attention import ops as fl
    from repro_torch.kernels.mlstm_scan import ops as k4
    from repro_torch.kernels.ssm_scan import ops as k5
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)
    B, S, H, dh = 2, 8, 2, 32
    q, k = r(B, S, H, dh), r(B, S, H, dh)
    ck8, sc = torch.zeros(B, S, H, dh, dtype=torch.int8), torch.ones(B, S, H)
    gates, bc = r(B, S, H), r(B, S, 8)
    return {
        "flash_attention": lambda x: fl.flash_attention(x, k, k),
        "decode_attention": lambda x: dec.decode_attention(x[:, :1], k, k,
                                                           3),
        "decode_attention_quant": lambda x: dec.decode_attention_quant(
            x[:, :1], ck8, sc, ck8, sc, 3),
        "mlstm_scan": lambda x: k4.mlstm_scan(x, q, q, gates, gates),
        "ssm_scan": lambda x: k5.ssm_scan(x, gates.abs(), torch.zeros(H), bc,
                                          bc, torch.ones(H)),
    }, q


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention",
                                  "decode_attention_quant", "mlstm_scan",
                                  "ssm_scan"])
def test_kernel_wrappers_refuse_dtensors(fake4, name):
    """A wrapper passes raw pointers to its kernel, and a DTensor's is its
    shard's alone: given a DTensor it raises, on every device (the model
    hands the kernels local shards); a plain tensor still runs."""
    calls, q = _wrappers()
    dq = distribute_tensor(q, fake4, [Shard(0), Replicate()])
    with pytest.raises(TypeError, match="DTensor"):
        calls[name](dq)
    out = calls[name](q)
    out = out[0] if isinstance(out, tuple) else out
    assert torch.isfinite(out).all()

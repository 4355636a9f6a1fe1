"""The port's partition specs against the reference's, with no devices.

For every arch of the registry on the meshes 2x2, 2x3, 16x16 and
2x16x16: each parameter leaf's sanitized spec, the ZeRO-1, cache and
batch specs equal the reference's entry by entry (the reference's on a
jax ``AbstractMesh``, the port's on a stand-in that has only axis names
and sizes). On the two production meshes, one device's argument bytes
for every (arch x shape) equal the sum of the reference's
``NamedSharding.shard_shape`` over ``build_lowering``'s arguments. With
no mesh installed, reduced qwen3-1.7b and granite-moe-3b-a800m prefill
and decode give the same bits as the single-device code did before the
mesh hooks went in (``tests/golden/torch_no_mesh.npz``).
"""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import ARCH_IDS, get_config as ref_config  # noqa: E402
from repro.launch import specs as ref_specs  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.models import decode_cache_plan as ref_plan  # noqa: E402
from repro.shapes import SHAPE_NAMES, get_shape  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models import build_model, decode_cache_plan  # noqa: E402
from repro_torch.utils.shardctx import P, current_mesh, mesh_axes  # noqa: E402

MESHES = {"2x2": {"data": 2, "model": 2}, "2x3": {"data": 2, "model": 3},
          "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
GOLDEN = Path(__file__).parent / "golden" / "torch_no_mesh.npz"


class StandIn:
    """A mesh as the spec functions read it: axis names and sizes."""

    def __init__(self, sizes):
        self.shape = dict(sizes)


def _abstract(sizes):
    return AbstractMesh(tuple(sizes.values()), tuple(sizes))


def _spec_leaves(tree):
    """(path, entries) of a nested dict of specs, sorted by path."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += [((k,) + p, e) for p, e in _spec_leaves(v)]
        else:
            out.append(((k,), tuple(v.spec if hasattr(v, "spec") else v)))
    return out


def _same(port_tree, ref_tree):
    port, ref = _spec_leaves(port_tree), _spec_leaves(ref_tree)
    assert [p for p, _ in port] == [p for p, _ in ref]
    for (path, got), (_, want) in zip(port, ref):
        # jax drops trailing Nones only where the spec was built short
        n = max(len(got), len(want))
        got = got + (None,) * (n - len(got))
        want = want + (None,) * (n - len(want))
        assert got == want, (path, got, want)


CASES = [(a, m) for a in ARCH_IDS for m in MESHES]


def test_stand_in_reads_as_a_mesh():
    assert mesh_axes(StandIn(MESHES["2x16x16"])) == MESHES["2x16x16"]
    assert current_mesh() is None
    assert P(("data",), None) == ("data", None)


def test_installed_mesh_is_seen_from_other_threads():
    """Autograd runs a CUDA backward, and the recompute of each
    checkpointed block, on a thread of its own: the mesh ``use_mesh``
    installs must be current there too, or the recomputed block skips
    its sharding constraints."""
    import threading
    from repro_torch.utils.shardctx import use_mesh
    seen = []
    mesh = StandIn(MESHES["2x2"])
    with use_mesh(mesh):
        t = threading.Thread(target=lambda: seen.append(current_mesh()))
        t.start()
        t.join()
    assert seen == [mesh] and current_mesh() is None


@pytest.mark.parametrize("mesh", MESHES)
def test_batch_axes_and_pspec_match_reference(mesh):
    from repro.models import common as ref_common
    from repro_torch.models import common
    sizes = MESHES[mesh]
    port, ref = StandIn(sizes), _abstract(sizes)
    assert common.batch_axes(port) == ref_common.batch_axes(ref)
    for size in (1, 6, 32, 128, 512):
        got = common.batch_pspec(port, size, None, "model")
        assert got == tuple(ref_common.batch_pspec(ref, size, None,
                                                   "model")), size


@pytest.mark.parametrize("arch,mesh", CASES)
def test_partition_specs_match_reference(arch, mesh):
    sizes = MESHES[mesh]
    got = build_model(get_config(arch)).partition_specs(StandIn(sizes))
    want = ref_build(ref_config(arch)).partition_specs(_abstract(sizes))
    _same(got, want)


@pytest.mark.parametrize("arch,mesh", CASES)
def test_zero1_cache_and_batch_shardings_match_reference(arch, mesh):
    sizes = MESHES[mesh]
    port_mesh, ref_mesh = StandIn(sizes), _abstract(sizes)
    pmodel, rmodel = build_model(get_config(arch)), ref_build(
        ref_config(arch))
    _same(specs.zero1_shardings(port_mesh, pmodel),
          ref_specs.zero1_shardings(ref_mesh, rmodel))
    for name in SHAPE_NAMES:
        shape = get_shape(name)
        _same(specs.batch_shardings(port_mesh, pmodel.batch_shapes(shape)),
              ref_specs.batch_shardings(
                  ref_mesh, rmodel.make_batch(shape, abstract=True)))
        if shape.kind != "decode":
            continue
        plan = decode_cache_plan(get_config(arch), shape.seq_len)
        rplan = ref_plan(ref_config(arch), shape.seq_len)
        assert (plan.kind, plan.length) == (rplan.kind, rplan.length)
        _same(specs.cache_shardings(
                  port_mesh, pmodel.cache_shapes(shape.global_batch, plan)),
              ref_specs.cache_shardings(
                  ref_mesh, rmodel.zero_cache(shape.global_batch, rplan,
                                              abstract=True)))


def _ref_argument_bytes(arch, shape, mesh):
    _, args, shardings, _ = ref_specs.build_lowering(arch, shape, mesh)
    total = 0
    for a, s in zip(jax.tree.leaves(args), jax.tree.leaves(shardings)):
        total += int(np.prod(s.shard_shape(a.shape))) * a.dtype.itemsize
    return total


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_argument_bytes_match_reference(arch, mesh):
    sizes = MESHES[mesh]
    cfg = get_config(arch)
    n = 0
    for name in SHAPE_NAMES:
        if name == "long_500k" and not cfg.supports_long_context:
            with pytest.raises(ValueError, match="long_500k"):
                specs.lowering_specs(arch, name, StandIn(sizes))
            continue
        _, _, shapes, sp, _ = specs.lowering_specs(arch, name,
                                                   StandIn(sizes))
        got = specs.argument_bytes(shapes, sp, StandIn(sizes))
        want = _ref_argument_bytes(arch, name, _abstract(sizes))
        assert got == want, (name, got, want)
        n += 1
    assert n >= 3


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-3b-a800m"])
def test_no_mesh_outputs_keep_their_bits(arch):
    """Prefill (B 2, S 6, a 9-slot cache) and 3 greedy decode steps from
    seeded weights, with no mesh installed: the logits and the cache
    leaves equal the recorded single-device outputs bit for bit."""
    assert current_mesh() is None
    cfg = get_config(arch).reduced()
    m = build_model(cfg)
    params = m.init_params(torch.Generator().manual_seed(0), "cpu")
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 6)).astype(np.int32))
    with np.load(GOLDEN) as g:
        want = {k[len(arch) + 1:]: g[k] for k in g.files
                if k.startswith(arch + "/")}
    got = {}
    lg, cache = m.prefill_fn(params, {"tokens": tok}, cache_len=9)
    got["prefill"] = lg.numpy()
    t = torch.argmax(lg, -1)[:, None].to(torch.int32)
    for i in range(3):
        lg, cache = m.decode_fn(params, cache, t, 6 + i)
        got[f"decode{i}"] = lg.numpy()
        t = torch.argmax(lg, -1)[:, None].to(torch.int32)
    for k in cache:
        got[f"cache/{k}"] = cache[k].numpy()
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k

"""Multi-pod dry-run (port of ``repro.launch.dryrun``): run every
(architecture x input shape) step on the production meshes with fake
tensors, and persist memory, the collectives by kind and the roofline
inputs.

The meshes (16x16 = 256 and 2x16x16 = 512 devices) exist only under
torch's ``fake`` process-group backend: one host process plays rank 0 of
the world, every collective returns at once, and the arguments are
DTensors of fake tensors (``launch.specs.build_lowering``), so no device
memory is touched and the kernels' plain versions run on the host. The
steps run eagerly, a prefill or decode step without autograd: a
``StepTracker`` keeps each collective a step issues (``analysis.hlo``)
and the per-device peak. The time loops of the recurrent archs run
their first and last steps only (``utils.time_loops``), which leaves the
record as the full loops make it. MUST be the process entry (it starts
the process group itself):

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all
"""
import argparse
import contextlib
import functools
import json
import os
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.distributed.tensor import _sharding_prop
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.analysis.flops import roofline_terms, step_cost
from repro_torch.analysis.hlo import (collective_bytes, collective_entry,
                                      is_collective)
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import build_lowering, scan_trip_counts
from repro_torch.shapes import SHAPE_NAMES, get_shape
from repro_torch.utils.shardctx import use_mesh
from repro_torch.utils.time_loops import stand_in_time_loops

try:
    from torch._guards import active_fake_mode
except ImportError:     # an older torch: the innermost fake mode
    from torch._guards import detect_fake_mode as active_fake_mode


def fake_world(size: int) -> None:
    """Start (or restart at another size) the fake process group."""
    if dist.is_initialized():
        if dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def _flat(x):
    if isinstance(x, dict):
        for v in x.values():
            yield from _flat(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _flat(v)
    elif isinstance(x, torch.Tensor):
        yield x


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _bytes(tensors) -> int:
    return sum(_local(t).numel() * t.element_size() for t in tensors)


def run_one(arch: str, shape_name: str, multi_pod: bool, outdir: str,
            verbose: bool = True, **build_kw) -> dict:
    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "multipod_2x16x16" if multi_pod else "pod_16x16"
    rec = record(arch, shape_name, mesh, mesh_name, **build_kw)
    if verbose:
        by_kind = {k: round(v / 2**30, 3) for k, v in
                   rec["collectives"]["by_kind_bytes"].items()}
        print(f"[{mesh_name}] {arch} x {shape_name}: "
              f"run={rec['lower_compile_s']}s "
              f"peak/dev={rec['memory']['peak_per_device_gb']}GB "
              f"coll={rec['collectives']['total_bytes']/2**30:.2f}GiB "
              f"by_kind={by_kind} "
              f"dominant={rec['roofline']['dominant']}", flush=True)
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        path = os.path.join(outdir, f"{mesh_name}__{arch}__{shape_name}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


class StepTracker(TorchDispatchMode):
    """What the dry-run keeps of a step, from one dispatch mode over
    every op on a local tensor: the collectives it issues (``record``, as
    ``analysis.hlo.CollectiveRecorder`` keeps them) and, per device, the
    most bytes that live storages held at once (``peak``), as torch's
    ``MemTracker`` counts them on a CPU device: a storage counts its bytes
    from the op that made it (or ``track``) until it is freed. The two
    trackers as separate modes took most of a step's host time; this one
    keeps their numbers (tests/test_torch_dryrun.py holds it to them) at
    a fraction of that."""

    def __init__(self, fake_mode):
        super().__init__()
        self.record = []
        self.live, self.peak = {}, {}
        self._fake_mode = fake_mode
        self._storages = WeakIdKeyDictionary()

    def _free(self, device, nbytes, _ref) -> None:
        self.live[device] -= nbytes

    def track(self, *tensors) -> None:
        for t in tensors:
            st = t.untyped_storage()
            if st in self._storages:
                continue
            dev, nbytes = t.device.type, st.nbytes()
            self._storages[st] = weakref.ref(
                st, functools.partial(self._free, dev, nbytes))
            live = self.live[dev] = self.live.get(dev, 0) + nbytes
            if live > self.peak.get(dev, 0):
                self.peak[dev] = live

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        # DTensor first desugars an op into ops on its local tensors
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if func is torch.ops._c10d_functional.wait_tensor.default:
            # its fake form makes a new tensor where the eager op returns
            # its input (MemTracker does the same)
            out = args[0]
        else:
            out = func(*args, **(kwargs or {}))
        if is_collective(func):
            self.record.append(collective_entry(func, args, out))
        # ops of another fake mode (DTensor's propagation) make no memory
        if active_fake_mode() is self._fake_mode:
            self.track(*(t for t in tree_leaves(out)
                         if isinstance(t, torch.Tensor)))
        return out


@contextlib.contextmanager
def _propagation_untracked():
    """On a cache miss DTensor's sharding propagation makes fake tensors
    of an op's global shapes to find its output's metadata, under the
    fake mode it detects. Under the step's own fake mode the tracker
    would count them as the step's memory, and a record would depend on
    what ran before it in the process (the first step's backward peak
    came out 33% high at reduced hymba-1.5b, train_4k). Give the
    propagation a fake mode of its own, which the tracker skips."""
    own = FakeTensorMode(allow_non_fake_inputs=True)
    detect = _sharding_prop.detect_fake_mode
    _sharding_prop.detect_fake_mode = lambda: own
    try:
        yield
    finally:
        _sharding_prop.detect_fake_mode = detect


def record(arch: str, shape_name: str, mesh, mesh_name: str,
           stand_in: bool = True, **build_kw) -> dict:
    """One (arch x shape) step on ``mesh`` (a DeviceMesh over the fake
    process group): its record, with the reference's keys. With
    ``stand_in`` the time loops run their first and last steps only
    (``utils.time_loops``), which leaves the record as it is."""
    chips = mesh.size()
    t0 = time.time()
    step, args, _, meta = build_lowering(arch, shape_name, mesh, **build_kw)
    cfg = meta["cfg"]
    tracker = StepTracker(meta["fake_mode"])
    arg_locals = [_local(t) for t in _flat(args)]
    tracker.track(*arg_locals)
    # only a train step differentiates: a prefill or decode step runs
    # without autograd, as serving does (under no_grad, not inference_mode:
    # a DTensor view cannot be an inference tensor)
    loops = stand_in_time_loops() if stand_in else contextlib.nullcontext()
    with meta["fake_mode"], use_mesh(mesh), _propagation_untracked(), \
            tracker, torch.set_grad_enabled(meta["kind"] == "train"), loops:
        out = step(*args)
    peak_bytes = max(tracker.peak.values(), default=0)
    trips = scan_trip_counts(cfg)
    # the eager loop issues every layer's collectives: no trip scaling
    stats = collective_bytes(tracker.record, 1)

    analytic = step_cost(cfg, get_shape(shape_name))
    terms = roofline_terms(analytic, chips, stats.total_bytes / chips
                           * chips)  # collective bytes are global
    # a Python int argument (decode's pos) is the reference's int32 scalar
    arg_bytes = _bytes(arg_locals) + 4 * sum(isinstance(a, int) for a in args)
    assert arg_bytes == meta["argument_bytes"], (arg_bytes,
                                                 meta["argument_bytes"])
    out_bytes = _bytes(list(_flat(out)))
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "chips": chips, "lower_compile_s": round(time.time() - t0, 2),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": max(peak_bytes - arg_bytes, 0),
            "peak_per_device_gb": round(peak_bytes / 2**30, 3),
            "peak_source": "StepTracker (torch MemTracker's count) under "
                           "FakeTensorMode: arguments plus every tensor "
                           "the step makes",
        },
        "hlo_cost": {"flops_per_device": None, "bytes_per_device": None,
                     "note": "torch has no HLO cost analysis; see "
                             "'analytic'"},
        "analytic": {
            "flops": analytic.flops,
            "weight_bytes": analytic.weight_bytes,
            "kv_bytes": analytic.kv_bytes,
            "act_bytes": analytic.act_bytes,
            "model_flops_6nd": 6.0 * cfg.n_active_params()
            * get_shape(shape_name).global_batch
            * (get_shape(shape_name).seq_len
               if get_shape(shape_name).kind == "train" else 1),
        },
        "collectives": {
            "total_bytes": stats.total_bytes,
            "by_kind_bytes": dict(stats.bytes_by_kind),
            "counts": dict(stats.counts),
            "scan_trips": trips,
            "note": "recorded per issued collective (scan_trips not "
                    "applied); on a CPU mesh DTensor gathers where a "
                    "card's mesh would all-to-all",
        },
        "roofline": terms,
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all",
                    help=f"one of {ARCH_IDS} or 'all'")
    ap.add_argument("--shape", default="all",
                    help=f"one of {SHAPE_NAMES} or 'all'")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun")
    # §Perf knobs (EXPERIMENTS.md §Perf). --variant baseline disables every
    # beyond-baseline optimization for a paper-faithful reference lowering.
    ap.add_argument("--variant", default="optimized",
                    choices=["baseline", "optimized"])
    ap.add_argument("--microbatch", type=int, default=1,
                    help="gradient-accumulation chunks (train shapes, H3)")
    ap.add_argument("--zero2", action="store_true",
                    help="shard the grad accumulator (H4; needs microbatch>1)")
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV cache (decode shapes, H5)")
    args = ap.parse_args()

    build_kw = dict(microbatch=args.microbatch, zero2=args.zero2,
                    kv_quant=args.kv_quant)
    if args.variant == "baseline":
        os.environ["REPRO_MOE_EP"] = "0"
        build_kw = dict(zero1=False)

    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = SHAPE_NAMES if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    failures = []
    n_ok = n_skip = 0
    for multi in meshes:
        for arch in archs:
            cfg = get_config(arch)
            for shape in shapes:
                if shape == "long_500k" and not cfg.supports_long_context:
                    print(f"SKIP {arch} x long_500k "
                          f"(no sub-quadratic path, DESIGN.md §4)")
                    n_skip += 1
                    continue
                try:
                    run_one(arch, shape, multi, args.out, **build_kw)
                    n_ok += 1
                except Exception as e:  # noqa: BLE001
                    failures.append((arch, shape, multi, repr(e)))
                    print(f"FAIL {arch} x {shape} multi={multi}: {e}")
                    traceback.print_exc(limit=4)
    print(f"\ndry-run complete: {n_ok} ok, {n_skip} skipped, "
          f"{len(failures)} failed")
    if dist.is_initialized():
        dist.destroy_process_group()
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()

"""Multi-pod dry-run (port of ``repro.launch.dryrun``): run every
(architecture x input shape) step on the production meshes with fake
tensors, and persist memory, the collectives by kind and the roofline
inputs.

The meshes (16x16 = 256 and 2x16x16 = 512 devices) exist only under
torch's ``fake`` process-group backend: one host process plays rank 0 of
the world, every collective returns at once, and the arguments are
DTensors of fake tensors (``launch.specs.build_lowering``), so no device
memory is touched and the kernels' plain versions run on the host. The
steps run eagerly: a ``CollectiveRecorder`` keeps each collective a step
issues (``analysis.hlo``) and torch's ``MemTracker`` the per-device
peak. MUST be the process entry (it starts the process group itself):

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all
"""
import argparse
import json
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed._tools.mem_tracker import MemTracker
from torch.distributed.tensor import DTensor
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro_torch.analysis.flops import roofline_terms, step_cost
from repro_torch.analysis.hlo import CollectiveRecorder, collective_bytes
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import build_lowering, scan_trip_counts
from repro_torch.shapes import SHAPE_NAMES, get_shape
from repro_torch.utils.shardctx import use_mesh


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


def record(arch: str, shape_name: str, mesh, mesh_name: str,
           **build_kw) -> dict:
    """One (arch x shape) step on ``mesh`` (a DeviceMesh over the fake
    process group): its record, with the reference's keys."""
    chips = mesh.size()
    t0 = time.time()
    step, args, _, meta = build_lowering(arch, shape_name, mesh, **build_kw)
    cfg = meta["cfg"]
    recorder = CollectiveRecorder()
    mt = MemTracker()
    arg_locals = [_local(t) for t in _flat(args)]
    mt.track_external(*arg_locals)
    with meta["fake_mode"], use_mesh(mesh), recorder, mt:
        out = step(*args)
    peak = mt.get_tracker_snapshot("peak")
    peak_bytes = max((d["Total"] for d in peak.values()), default=0)
    trips = scan_trip_counts(cfg)
    # the eager loop issues every layer's collectives: no trip scaling
    stats = collective_bytes(recorder.record, 1)

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
            "peak_source": "torch MemTracker under FakeTensorMode: "
                           "arguments plus every tensor the step makes",
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

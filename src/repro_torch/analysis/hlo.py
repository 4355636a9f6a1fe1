"""Per-collective byte accounting (counterpart of ``repro.analysis.hlo``).

Torch has no HLO. The reference parses post-SPMD HLO; the port records
the collectives a step issues while it runs (``CollectiveRecorder``, a
``CommDebugMode`` that also keeps each collective's local operand and
result bytes, fake tensors included), and ``collective_bytes(record,
scan_trips)`` sums them by kind with the reference's convention. The
reference multiplies ops inside a while (scan) body by its trip count,
because XLA lists the body once; the port's eager layer loop issues each
layer's collectives itself, so ``scan_trips`` stays 1 on its own path.

Byte convention (wire traffic per device, ring algorithms):
  all-reduce:          2x operand bytes x (n-1)/n  ~ 2x operand
  all-gather:          result bytes x (n-1)/n      ~ result
  reduce-scatter:      operand bytes x (n-1)/n     ~ operand
  all-to-all:          operand bytes x (n-1)/n     ~ operand
  collective-permute:  operand bytes
We report the un-discounted tensor bytes (n-1)/n ~= 1 — consistent,
slightly conservative.
"""
from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch
from torch.distributed.tensor.debug import CommDebugMode

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def shape_bytes(type_str: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(type_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


@dataclass
class CollectiveStats:
    counts: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    bytes_by_kind: Dict[str, float] = field(
        default_factory=lambda: defaultdict(float))

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())


# op-name fragments of torch's collectives (functional, DTensor's own and
# c10d's in-place ones) -> the reference's kinds
_KINDS = (("reduce_scatter", "reduce-scatter"), ("all_reduce", "all-reduce"),
          ("allreduce", "all-reduce"), ("all_gather", "all-gather"),
          ("allgather", "all-gather"), ("all_to_all", "all-to-all"),
          ("alltoall", "all-to-all"), ("send", "collective-permute"),
          ("recv", "collective-permute"))


def _kind(func) -> str:
    name = func._overloadpacket.__name__ if hasattr(
        func, "_overloadpacket") else str(func)
    for frag, kind in _KINDS:
        if frag in name:
            return kind
    return name


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


class CollectiveRecorder(CommDebugMode):
    """``CommDebugMode`` that keeps ``record``: one (kind, operand bytes,
    result bytes) per collective, local to one device, in issue order."""

    def __init__(self):
        super().__init__()
        self.record: List[Tuple[str, int, int]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is NotImplemented or isinstance(
                func, torch._ops.HigherOrderOperator):
            return out
        packet = func._overloadpacket
        if packet in self.comm_registry or packet in _c10d_ops():
            self.record.append((_kind(func), _nbytes(args[0] if args
                                                     else None),
                                _nbytes(out)))
        return out


def _c10d_ops():
    from torch.distributed.tensor.debug._comm_mode import c10d_collective_ops
    return c10d_collective_ops


def collective_bytes(record, scan_trips: int = 1) -> CollectiveStats:
    """Sum a ``CollectiveRecorder.record`` by kind: all-gather counts its
    result bytes, all-reduce twice its operand bytes, the others their
    operand bytes (result bytes where the operand has none). Every entry
    is multiplied by ``scan_trips`` (1 on the port's eager path, which
    records each layer's collectives)."""
    stats = CollectiveStats()
    for kind, operand, result in record:
        if kind == "all-gather":
            nbytes = result
        else:
            nbytes = operand or result
        if kind == "all-reduce":
            nbytes *= 2  # ring all-reduce moves ~2x
        stats.counts[kind] += scan_trips
        stats.bytes_by_kind[kind] += float(nbytes) * scan_trips
    return stats

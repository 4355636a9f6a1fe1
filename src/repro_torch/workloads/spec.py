"""Function specifications.

``PAPER_FUNCTIONS`` mirrors Table 1 of the paper (V100 warm/cold seconds,
plus CPU numbers used by the Table-1 benchmark). ``demand`` is the
fraction of device compute a single invocation occupies (drives the
utilization monitor and interference model).

Model-endpoint specs for the 10 assigned architectures are derived from
the roofline cost model in ``repro.workloads.costmodel``.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional

from repro_torch.datapath.stages import ColdStartStages

GB = 1024 ** 3


@dataclass(frozen=True)
class FunctionSpec:
    fn_id: str
    warm_time: float           # device execution time, warm (s)
    cold_init: float           # container/process init overhead (s)
    mem_bytes: int             # device working set
    demand: float = 0.5        # fraction of device compute used
    cpu_warm: float = 0.0      # Table-1 CPU columns (benchmarks only)
    cpu_cold: float = 0.0
    kind: str = "generic"
    # explicit cold-start stage decomposition (repro.datapath); None for
    # legacy specs — the pipeline datapath then decomposes ``cold_init``
    # via ``repro.datapath.stages.stages_for``
    stages: Optional[ColdStartStages] = None

    def with_id(self, fn_id: str) -> "FunctionSpec":
        return replace(self, fn_id=fn_id)


def _f(fn_id, gw, cw, gc, cc, mem_gb, demand, kind):
    return FunctionSpec(fn_id, warm_time=gw, cold_init=max(gc - gw, 0.0),
                        mem_bytes=int(mem_gb * GB), demand=demand,
                        cpu_warm=cw, cpu_cold=cc, kind=kind)


# Table 1: fn, GPU[W], CPU[W], GPU[C], CPU[C]
PAPER_FUNCTIONS: Dict[str, FunctionSpec] = {s.fn_id: s for s in [
    _f("imagenet", 2.253, 5.477, 11.286, 10.103, 1.8, 0.60, "ml"),
    _f("roberta", 0.268, 5.162, 15.481, 14.372, 1.4, 0.45, "ml"),
    _f("ffmpeg", 4.483, 32.997, 4.612, 34.260, 0.8, 0.70, "video"),
    _f("fft", 0.897, 11.584, 3.322, 13.073, 1.5, 0.55, "hpc"),
    _f("isoneural", 0.026, 0.501, 9.963, 1.434, 0.6, 0.30, "hpc"),
    _f("lud", 2.050, 70.915, 2.359, 110.495, 1.0, 0.65, "hpc"),
    _f("needle", 1.979, 144.639, 2.177, 223.306, 1.1, 0.65, "hpc"),
    _f("pathfinder", 1.472, 134.358, 1.797, 106.667, 0.9, 0.60, "hpc"),
    _f("cupy", 0.500, 6.000, 3.500, 8.000, 1.2, 0.50, "hpc"),
    _f("rnn", 0.350, 4.000, 8.000, 9.000, 1.0, 0.40, "ml"),
    _f("srad", 1.100, 20.000, 1.600, 30.000, 0.9, 0.60, "hpc"),
]}


def function_copies(base_ids: List[str], n: int) -> Dict[str, FunctionSpec]:
    """The paper's workloads run multiple copies of the Table-1 functions,
    each copy with its own arrival process ("We create multiple copies of
    the same function code")."""
    out: Dict[str, FunctionSpec] = {}
    i = 0
    while len(out) < n:
        base = PAPER_FUNCTIONS[base_ids[i % len(base_ids)]]
        fid = f"{base.fn_id}-{i // len(base_ids)}"
        out[fid] = base.with_id(fid)
        i += 1
    return out


DEFAULT_MIX = ["imagenet", "roberta", "ffmpeg", "fft", "isoneural",
               "lud", "needle", "pathfinder"]

"""Roofline-based service-time cost model for model endpoints.

Turns each assigned (architecture x input shape) into a ``FunctionSpec``
the scheduler can serve: service time = max(compute, memory) + collective
roofline terms on the target slice, cold init = compile + weight upload,
memory footprint = resident parameter bytes (+ cache). This is how the
paper's "functions" become the assigned architectures in this repro
(DESIGN.md §4).
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.analysis.flops import (HBM_BW, ICI_BW, PEAK_FLOPS, CostTerms,
                                  roofline_terms, step_cost)
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.datapath.stages import ColdStartStages
from repro_torch.shapes import INPUT_SHAPES, InputShape, get_shape
from repro_torch.workloads.spec import FunctionSpec

# endpoint-serving defaults on NVIDIA H100 SXM5
DEFAULT_CHIPS = 1            # one card per endpoint replica
# TorchEndpoint.compile() on first instantiation (s): one warm-up prefill
# and one decode step once the kernels are built (nvcc's build is a
# one-off of the installation, not a cold start). Measured on the card by
# chip_smoke.py phase "replay": the median of its six full-width
# endpoints' compile() (0.18-0.43 s for qwen3-1.7b and hymba-1.5b, 3.2-4.5
# s for xlstm-350m's step loop), one run on an NVIDIA H100 80GB HBM3 at a
# 700.00 W power limit
COMPILE_TIME = 0.36
# host->HBM upload bytes/s: PCIe Gen5 x16, one direction (NVIDIA's H100
# datasheet: 128 GB/s both directions together)
H2D_BW = 64e9
MFU = 0.45                   # achieved fraction of roofline (reference's)


def service_time(cfg, shape: InputShape, chips: int = DEFAULT_CHIPS,
                 collective_bytes: float = 0.0) -> float:
    cost = step_cost(cfg, shape)
    terms = roofline_terms(cost, chips, collective_bytes)
    return (max(terms["compute_s"], terms["memory_s"])
            + terms["collective_s"]) / MFU


def endpoint_spec(arch_id: str, shape_name: str,
                  chips: int = DEFAULT_CHIPS, *,
                  compile_time: float = COMPILE_TIME,
                  h2d_bw: float = H2D_BW,
                  setup_time: float = 0.0) -> FunctionSpec:
    """``compile_time`` / ``h2d_bw`` / ``setup_time`` parameterize the
    cold-start stages (defaults preserve the historical module
    constants), so the cost model and the serving datapath agree on
    bandwidth by construction instead of by two hard-coded numbers. The
    emitted spec carries the explicit ``ColdStartStages``; its scalar
    ``cold_init`` is the uncontended sum of the same stages."""
    cfg = get_config(arch_id)
    shape = get_shape(shape_name)
    svc = service_time(cfg, shape, chips)
    wbytes = cfg.n_params() * (2 if "16" in cfg.param_dtype else 4)
    stages = ColdStartStages(setup_s=setup_time, compile_s=compile_time,
                             weight_bytes=int(wbytes))
    # demand: fraction of the slice's compute this step occupies
    cost = step_cost(cfg, shape)
    demand = min(1.0, cost.flops / (svc * chips * PEAK_FLOPS) + 0.05)
    return FunctionSpec(
        fn_id=f"{arch_id}:{shape_name}",
        warm_time=svc,
        cold_init=stages.scalar_cold_init(h2d_bw),
        mem_bytes=int(wbytes),
        demand=demand,
        kind="endpoint",
        stages=stages,
    )


def endpoint_mix(shape_name: str = "decode_32k",
                 archs: Optional[List[str]] = None,
                 **cost_kw) -> Dict[str, FunctionSpec]:
    """``cost_kw`` (compile_time / h2d_bw / setup_time) is forwarded to
    ``endpoint_spec`` for every architecture in the mix."""
    archs = archs or ARCH_IDS
    out = {}
    for a in archs:
        cfg = get_config(a)
        if shape_name == "long_500k" and not cfg.supports_long_context:
            continue
        s = endpoint_spec(a, shape_name, **cost_kw)
        out[s.fn_id] = s
    return out

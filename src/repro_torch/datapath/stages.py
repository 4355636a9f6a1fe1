"""Cold-start stage decomposition.

The scalar cost model collapses cold init into one number
(``FunctionSpec.cold_init``). The data plane needs the structure back:

    setup    — container/sandbox creation (CPU-side, fixed)
    compile  — XLA compile of the endpoint's executable (fixed)
    transfer — host -> HBM weight upload (``weight_bytes`` over a
               *contended* per-device link, so its duration is decided
               by repro.datapath.link at run time, not here)

Zhao et al.'s fast-setup pipeline overlaps the fixed stages with the
transfer, so a pipelined cold start costs

    max(setup + compile, transfer)      not      setup + compile + transfer

``stages_for`` recovers stages for legacy specs whose ``stages`` field
is unset by peeling the nominal transfer time out of ``cold_init`` and
splitting the fixed remainder 30/70 between setup and compile (the
rough container-vs-XLA ratio behind ``costmodel.COMPILE_TIME``).
"""
from __future__ import annotations

from dataclasses import dataclass

# share of the fixed (non-transfer) cold cost attributed to
# container/sandbox setup when decomposing a scalar cold_init
SETUP_FRACTION = 0.3


@dataclass(frozen=True)
class ColdStartStages:
    setup_s: float          # container/sandbox creation
    compile_s: float        # XLA compile
    weight_bytes: int       # host -> HBM upload volume

    @property
    def fixed_s(self) -> float:
        """The transfer-overlappable fixed cost."""
        return self.setup_s + self.compile_s

    def scalar_cold_init(self, h2d_bw: float) -> float:
        """The equivalent one-term cold cost at an uncontended link —
        what ``FunctionSpec.cold_init`` should say for these stages."""
        return self.setup_s + self.compile_s + self.weight_bytes / h2d_bw

    def n_chunks(self, chunk_bytes) -> int:
        """Pieces the weight transfer splits into under chunked layer
        streaming (``ServerConfig.chunk_bytes``): execution starts when
        the first piece lands. 1 when chunking is off or the weights
        fit in a single chunk."""
        if not chunk_bytes or chunk_bytes <= 0:
            return 1
        return max(1, -(-self.weight_bytes // int(chunk_bytes)))


def stages_for(spec, h2d_bw: float) -> ColdStartStages:
    """Stages of ``spec``: its own ``stages`` field when the cost model
    provided one, else a decomposition of the scalar ``cold_init``
    assuming the transfer ran alone at ``h2d_bw``."""
    st = getattr(spec, "stages", None)
    if st is not None:
        return st
    fixed = spec.cold_init - spec.mem_bytes / h2d_bw
    if fixed < 0.0:
        fixed = 0.0
    return ColdStartStages(setup_s=SETUP_FRACTION * fixed,
                           compile_s=(1.0 - SETUP_FRACTION) * fixed,
                           weight_bytes=spec.mem_bytes)

"""Cold-start data plane (ServerConfig.datapath = "pipeline").

Decomposes cold init into explicit stages (container/sandbox setup, XLA
compile, host->HBM weight transfer), models the per-device PCIe/H2D
link as a contended resource with a bounded pinned-host staging pool,
and gives the scheduler an anticipatory weight-prefetch path over the
existing admit/acquire memory accounting. The scalar cold model stays
verbatim as the differential reference (``datapath="scalar"``).
"""
from repro_torch.datapath.device import DeviceDataPath
from repro_torch.datapath.fabric import Fabric
from repro_torch.datapath.link import ReferenceSharedLink, SharedLink, Transfer
from repro_torch.datapath.stages import ColdStartStages, stages_for

__all__ = ["ColdStartStages", "DeviceDataPath", "Fabric",
           "ReferenceSharedLink", "SharedLink", "Transfer", "stages_for"]

"""Device layer: per-device memory manager + shared container warm pool.

Two interchangeable implementations of the same interface:

  "indexed"   — heap-indexed hot paths, O(log N) per miss/eviction
                (``manager.DeviceMemoryManager`` / ``pool.WarmPool``)
  "reference" — the seed's linear scans kept verbatim as the executable
                specification (``reference``), used by the differential
                tests and as the perf baseline in benchmarks/scale.py

Select per server with ``ServerConfig(device_layer=...)``.
"""
from repro_torch.memory.manager import DeviceMemoryManager, GB, Region
from repro_torch.memory.pool import Container, WarmPool
from repro_torch.memory.reference import (ReferenceDeviceMemoryManager,
                                    ReferenceWarmPool)

DEVICE_LAYERS = {
    "indexed": (DeviceMemoryManager, WarmPool),
    "reference": (ReferenceDeviceMemoryManager, ReferenceWarmPool),
}


def make_device_layer(name: str = "indexed"):
    """Returns (memory_manager_cls, warm_pool_cls) for a layer name."""
    try:
        return DEVICE_LAYERS[name]
    except KeyError:
        raise ValueError(f"unknown device_layer {name!r}; "
                         f"expected one of {sorted(DEVICE_LAYERS)}")

"""Device layer: per-device memory manager + shared container warm pool.

The port carries only the "indexed" layer (``manager.DeviceMemoryManager``
/ ``pool.WarmPool``); the seed's linear-scan "reference" layer stays in
``repro.memory.reference`` as the JAX package's differential baseline.

Select per server with ``ServerConfig(device_layer=...)``.
"""
from repro_torch.memory.manager import DeviceMemoryManager, GB, Region
from repro_torch.memory.pool import Container, WarmPool

DEVICE_LAYERS = {
    "indexed": (DeviceMemoryManager, WarmPool),
}


def make_device_layer(name: str = "indexed"):
    """Returns (memory_manager_cls, warm_pool_cls) for a layer name."""
    try:
        return DEVICE_LAYERS[name]
    except KeyError:
        raise ValueError(f"unknown device_layer {name!r}; "
                         f"expected one of {sorted(DEVICE_LAYERS)}")

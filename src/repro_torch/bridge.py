"""Load the JAX reference's parameters into the port.

``params_from_jax(host_params)`` takes ``JaxEndpoint.host_params`` (or any
nested dict of numpy arrays in ``repro.models``' layout: a leading ``L``
dim on every layer leaf) and returns the same tree of torch tensors, key
names and layout unchanged, on ``device`` (the card unless the caller
passes ``device="cpu"``). It takes numpy only and imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.runtime.device import resolve_device


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    # a private, writable copy: arrays read from JAX are read-only views
    a = np.array(a, order="C", copy=True)
    if a.dtype.name == "bfloat16":
        # ml_dtypes.bfloat16, which torch.from_numpy rejects: move the
        # bits as uint16 and reinterpret them, so no value is rounded
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_jax(host_params, device="cuda"):
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``;
    raises if ``device`` is a CUDA device and CUDA is not available."""
    dev = resolve_device(device)
    if isinstance(host_params, dict):
        return {k: params_from_jax(v, dev) for k, v in host_params.items()}
    return _tensor(host_params, dev)

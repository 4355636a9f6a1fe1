"""Which kernel runs K4 (the mLSTM scan) and K5 (the SSM scan), on the CPU.

``kernel_for`` in each wrapper names the kernel its C entry runs: the step
kernel below one chunk (decode is S = 1), the Hopper kernel (one cluster
launch) from one chunk up at every shape a served arch gives it, and the
mma.sync chunked kernels only where the Hopper kernel does not cover a
shape the wrapper accepts (K4 at dh 32 and 64). The served shapes are
read off the configs of ``repro_torch.configs``. Imports no JAX.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.configs import all_configs
from repro_torch.kernels import _build
from repro_torch.kernels.mlstm_scan import ops as k4
from repro_torch.kernels.ssm_scan import ops as k5

PREFILL_S = (1000, 1024, 4096)   # and one chunk, each scan's own


def _ssm_shapes():
    """(arch, P, N) of every config with SSM heads."""
    return [(a, c.ssm_head_dim, c.ssm_state)
            for a, c in all_configs().items() if c.ssm_heads > 0]


def _mlstm_shapes():
    """(arch, dh) of every config with mLSTM blocks (the model's dh:
    mlstm_proj_factor d_model over n_heads)."""
    return [(a, int(c.mlstm_proj_factor * c.d_model) // c.n_heads)
            for a, c in all_configs().items() if a.startswith("xlstm")]


def test_the_served_archs_are_found():
    assert [a for a, *_ in _ssm_shapes()] == ["hymba-1.5b"]
    assert _mlstm_shapes() == [("xlstm-350m", 512)]


@pytest.mark.parametrize("S", (k5.CHUNK,) + PREFILL_S)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssm_served_prefill_takes_sm90(S, dtype):
    for arch, P, N in _ssm_shapes():
        assert k5.kernel_for(S, dtype, P, N) == "sm90", arch


@pytest.mark.parametrize("S", (k4.CHUNK,) + PREFILL_S)
def test_mlstm_served_prefill_takes_sm90(S):
    for arch, dh in _mlstm_shapes():
        assert k4.kernel_for(S, dh) == "sm90", arch


@pytest.mark.parametrize("S", [1, 2, k5.CHUNK - 1])
def test_ssm_below_one_chunk_takes_steps(S):
    for _, P, N in _ssm_shapes():
        for dtype in _build.DTYPES:
            assert k5.kernel_for(S, dtype, P, N) == "steps"


@pytest.mark.parametrize("S", [1, 2, k4.CHUNK - 1])
def test_mlstm_below_one_chunk_takes_steps(S):
    for _, dh in _mlstm_shapes():
        assert k4.kernel_for(S, dh) == "steps"


@pytest.mark.parametrize("P", k5.HEAD_DIMS)
@pytest.mark.parametrize("N", k5.STATE_SIZES)
def test_ssm_every_accepted_shape_takes_sm90(P, N):
    """The Hopper kernel covers every P, N and x type the wrapper takes."""
    for dtype in _build.DTYPES:
        assert k5.kernel_for(k5.CHUNK, dtype, P, N) == "sm90"
        assert k5.kernel_for(3 * k5.CHUNK + 5, dtype, P, N) == "sm90"


@pytest.mark.parametrize("dh", k4.HEAD_DIMS)
def test_mlstm_chunked_kernel_by_head_dim(dh):
    """dh 128 up (dh / 64 CTAs of 64 rows of C) takes the Hopper kernel;
    dh 32 and 64 the mma.sync chunked kernels."""
    want = "sm90" if dh >= 128 else "mma_sync"
    assert k4.kernel_for(k4.CHUNK, dh) == want
    assert k4.kernel_for(3 * k4.CHUNK + 5, dh) == want
    assert (dh in k4.SM90_HEAD_DIMS) == (want == "sm90")


@pytest.mark.parametrize("args", [
    (0, torch.float32, 64, 16),        # no step
    (64, torch.float16, 64, 16),       # x type
    (64, torch.float32, 24, 16),       # P not a multiple of 16
    (64, torch.float32, 80, 16),       # P past 64
    (64, torch.float32, 64, 32),       # N
])
def test_ssm_unsupported_shapes_raise(args):
    with pytest.raises(ValueError):
        k5.kernel_for(*args)


@pytest.mark.parametrize("args", [(0, 512), (64, 48), (64, 1024),
                                  (1, 16)])
def test_mlstm_unsupported_shapes_raise(args):
    with pytest.raises(ValueError):
        k4.kernel_for(*args)


def test_kernel_codes_are_the_c_entries():
    """The codes the C entries take (``enum Kernel`` in both sources)."""
    assert k4.KERNELS == {"steps": 0, "mma_sync": 1, "sm90": 2}
    assert k5.KERNELS == {"steps": 0, "sm90": 1}

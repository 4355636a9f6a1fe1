"""K1's dispatch, decided in Python (``ops.kernel_for``) so that it can be
read here on the CPU: which of the three kernels of
``csrc/flash_attention.cu`` a CUDA input of a given dtype and head dim
runs. The Hopper kernel (wgmma fed by TMA) takes bf16 at head dims 64 and
128, the head dims of every served arch that has attention; the mma.sync
kernel bf16 at 32 and 256; the SIMT kernel float32 at every head dim. Any
other head dim raises. This file imports no JAX.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fl  # noqa: E402

# every arch but the recurrent one (xlstm-350m: no attention)
ATTENTION_ARCHS = [a for a in ARCH_IDS if get_config(a).family != "ssm"]


def test_the_archs_without_attention_are_the_recurrent_ones():
    assert len(ATTENTION_ARCHS) == len(ARCH_IDS) - 1
    assert {get_config(a).family for a in ARCH_IDS
            if a not in ATTENTION_ARCHS} == {"ssm"}


@pytest.mark.parametrize("arch", ATTENTION_ARCHS)
def test_every_served_attention_head_dim_runs_on_the_hopper_kernel(arch):
    cfg = get_config(arch)
    assert cfg.compute_dtype == torch.bfloat16
    assert fl.kernel_for(cfg.compute_dtype, cfg.head_dim) == "sm90"


@pytest.mark.parametrize("dh", _build.HEAD_DIMS)
def test_float32_runs_on_the_simt_kernel(dh):
    assert fl.kernel_for(torch.float32, dh) == "simt"


@pytest.mark.parametrize("dh,kernel", [(32, "mma_sync"), (64, "sm90"),
                                       (128, "sm90"), (256, "mma_sync")])
def test_bf16_kernel_by_head_dim(dh, kernel):
    assert fl.kernel_for(torch.bfloat16, dh) == kernel


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [0, 16, 48, 80, 96, 160, 512])
def test_other_head_dims_raise(dtype, dh):
    with pytest.raises(ValueError, match="head dim"):
        fl.kernel_for(dtype, dh)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64,
                                   torch.int8])
def test_other_dtypes_raise(dtype):
    with pytest.raises(ValueError, match="dtype"):
        fl.kernel_for(dtype, 64)


def test_each_kernel_has_its_own_entry_code():
    names = {fl.kernel_for(dt, dh) for dt in _build.DTYPES
             for dh in _build.HEAD_DIMS}
    assert names == set(fl.KERNELS)
    assert sorted(fl.KERNELS.values()) == list(range(len(fl.KERNELS)))


def test_a_cpu_input_runs_the_plain_version():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 9, n, 64, generator=g) for n in (4, 2, 2))
    before = fl.flash_attention.launches
    out = fl.flash_attention(q, k, v)
    assert fl.flash_attention.launches == before
    torch.testing.assert_close(out, fl.flash_attention_plain(q, k, v),
                               rtol=0, atol=0)

"""K5: the selective SSM scan (Hymba's Mamba heads) with state in and out,
in model layout.

x (B, S, Hs, P) in float32 or bfloat16; dt (B, S, Hs), b and c (B, S, N),
all float32, b and c shared by every head; a_log and d_skip (Hs,), float32
or bfloat16; an optional initial state (B, Hs, P, N), float32. Each step is
``repro.models.ssm._ssm_step`` with ``A = -exp(a_log)``, then the D skip:

    S   = S * exp(dt_t A) + (dt_t x_t) B_t^T
    y_t = S C_t + d_skip x_t

in float32, with y returned in x's dtype, together with the final state.
Without a state the scan starts from S = 0, as the Pallas kernel does. On
a CUDA tensor ``ssm_scan`` launches the kernel of ``csrc/ssm_scan.cu``; on
a CPU tensor it runs ``ssm_scan_plain``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.models.ssm import _ssm_step

STATE_SIZES = (8, 16)       # N, the kernel's instantiations
HEAD_DIMS = (16, 32, 48, 64)   # P: a multiple of 16 up to 64


def ssm_scan_plain(x, dt, a_log, b, c, d_skip, state=None):
    """K5's function in plain PyTorch: a loop of the model's step over
    time in float32, then the D skip."""
    B, S, Hs, P = x.shape
    N = b.shape[-1]
    if state is None:
        state = torch.zeros(B, Hs, P, N, device=x.device)
    A = -torch.exp(a_log.float())
    xf = x.float()
    y = torch.empty(B, S, Hs, P, device=x.device)
    for t in range(S):
        state, y[:, t] = _ssm_step(state, (xf[:, t], dt[:, t], b[:, t],
                                           c[:, t]), A)
    y = y + d_skip.float()[None, None, :, None] * xf
    return y.to(x.dtype), state


def _check(x, dt, a_log, b, c, d_skip, state) -> None:
    tensors = (x, dt, a_log, b, c, d_skip) + \
        ((state,) if state is not None else ())
    if not (x.is_cuda and all(t.device == x.device for t in tensors)):
        raise ValueError("ssm_scan: inputs must be on one CUDA device")
    if x.dim() != 4:
        raise ValueError("ssm_scan: x (B, S, Hs, P) expected")
    B, S, Hs, P = x.shape
    N = b.shape[-1] if b.dim() == 3 else -1
    if dt.shape != (B, S, Hs) or b.shape != (B, S, N) \
            or c.shape != (B, S, N) or a_log.shape != (Hs,) \
            or d_skip.shape != (Hs,):
        raise ValueError("ssm_scan: dt (B, S, Hs), b, c (B, S, N) and "
                         "a_log, d_skip (Hs,) expected")
    if state is not None and state.shape != (B, Hs, P, N):
        raise ValueError("ssm_scan: state (B, Hs, P, N) expected")
    f32 = torch.float32
    if x.dtype not in _build.DTYPES or a_log.dtype not in _build.DTYPES \
            or d_skip.dtype != a_log.dtype \
            or any(t.dtype != f32 for t in (dt, b, c)) \
            or (state is not None and state.dtype != f32):
        raise ValueError(
            f"ssm_scan: dtypes {[str(t.dtype) for t in tensors]}; the "
            f"kernel takes x float32 or bfloat16, a_log and d_skip alike "
            f"in either, and float32 dt, b, c and state")
    if S < 1:
        raise ValueError("ssm_scan: at least one step expected")
    if N not in STATE_SIZES:
        raise ValueError(f"ssm_scan: state size {N} not in {STATE_SIZES}")
    if P not in HEAD_DIMS:
        raise ValueError(f"ssm_scan: head dim {P} not in {HEAD_DIMS}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssm_scan: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (x, b, c) + tensors[6:]):
        raise ValueError("ssm_scan: x, b, c and state must be 16-byte "
                         "aligned")


def ssm_scan(x, dt, a_log, b, c, d_skip, state=None):
    """The selective scan: K5 on a CUDA tensor, the plain version on a CPU
    tensor. Returns (y, final state)."""
    if x.device.type == "cpu":
        return ssm_scan_plain(x, dt, a_log, b, c, d_skip, state)
    _check(x, dt, a_log, b, c, d_skip, state)
    B, S, Hs, P = x.shape
    N = b.shape[-1]
    y = torch.empty_like(x)
    final = torch.empty((B, Hs, P, N), dtype=torch.float32, device=x.device)
    fn = _build.entry("ssm_scan", "ssm_scan_fwd", 9, 8, n_floats=0)
    err = fn(x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(),
             c.data_ptr(), d_skip.data_ptr(),
             state.data_ptr() if state is not None else None, y.data_ptr(),
             final.data_ptr(), _build.DTYPES[x.dtype],
             _build.DTYPES[a_log.dtype], B, S, Hs, P, N,
             int(state is not None),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "ssm_scan")
    _build.count_launch(ssm_scan)
    return y, final


ssm_scan.launches = 0

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

The kernel has two paths, chosen by S (``uses_chunks``). Below one chunk
(``CHUNK`` steps; decode is S = 1) it runs the recurrence step by step.
From one chunk up it runs the chunked form of Mamba-2 (state-space
duality), which ``ssm_scan_chunked_plain`` transcribes: within a chunk y
is a masked matrix product, and only the state crosses chunks. Both paths
compute ``ssm_scan_plain``'s function.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.models.ssm import _ssm_step
from repro_torch.utils.time_loops import steps

STATE_SIZES = (8, 16)       # N, the kernel's instantiations
HEAD_DIMS = (16, 32, 48, 64)   # P: a multiple of 16 up to 64
CHUNK = 32                  # steps per chunk of the chunked path (csrc: CL)


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
    for t in steps(S):
        state, y[:, t] = _ssm_step(state, (xf[:, t], dt[:, t], b[:, t],
                                           c[:, t]), A)
    y = y + d_skip.float()[None, None, :, None] * xf
    return y.to(x.dtype), state


def ssm_scan_chunked_plain(x, dt, a_log, b, c, d_skip, state=None,
                           chunk=CHUNK):
    """K5's chunked path in plain PyTorch, as the kernel computes it.

    Per chunk and (batch, head), with cum_t the sum of dt_s A over the
    chunk's steps up to t and S0 the state at its start:
        y_t = sum_{s<=t} exp(cum_t - cum_s) (C_t . B_s) dt_s x_s
              + exp(cum_t) S0 C_t + d_skip x_t
        S   = exp(cum_L) S0 + sum_s exp(cum_L - cum_s) dt_s x_s B_s^T
    The exponent is masked to s <= t before the exp. C B^T is one L x L
    matrix per (batch, chunk), shared by every head."""
    B, S, Hs, P = x.shape
    N = b.shape[-1]
    st = state if state is not None else \
        torch.zeros(B, Hs, P, N, device=x.device)
    A = -torch.exp(a_log.float())
    xf = x.float()
    y = torch.empty(B, S, Hs, P, device=x.device)
    for i in steps(-(-S // chunk)):
        sl = slice(i * chunk, min(S, (i + 1) * chunk))
        dtc = dt[:, sl].permute(0, 2, 1)                    # (B, Hs, L)
        cum = torch.cumsum(dtc * A[:, None], -1)
        L = cum.shape[-1]
        causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
        seg = (cum[..., :, None] - cum[..., None, :]).masked_fill(
            ~causal, float("-inf"))
        G = c[:, sl] @ b[:, sl].transpose(-1, -2)           # (B, L, L)
        M = G[:, None] * torch.exp(seg) * dtc[..., None, :]
        X = xf[:, sl].permute(0, 2, 1, 3)                   # (B, Hs, L, P)
        yc = M @ X + torch.exp(cum)[..., None] * (
            c[:, sl][:, None] @ st.transpose(-1, -2))
        y[:, sl] = yc.permute(0, 2, 1, 3)
        cL = cum[..., -1]
        wdt = torch.exp(cL[..., None] - cum) * dtc
        st = torch.exp(cL)[..., None, None] * st + \
            (X * wdt[..., None]).transpose(-1, -2) @ b[:, sl][:, None]
    y = y + d_skip.float()[None, None, :, None] * xf
    return y.to(x.dtype), st


def uses_chunks(S: int) -> bool:
    """Whether the kernel takes its chunked path for S steps."""
    return S >= CHUNK


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
    tensor. Returns (y, final state). Raises if autograd would record an
    input."""
    _build.refuse_dtensor("ssm_scan", x, dt, a_log, b, c, d_skip, state)
    _build.refuse_autograd("ssm_scan", x, dt, a_log, b, c, d_skip, state)
    if x.device.type == "cpu":
        return ssm_scan_plain(x, dt, a_log, b, c, d_skip, state)
    _check(x, dt, a_log, b, c, d_skip, state)
    B, S, Hs, P = x.shape
    N = b.shape[-1]
    y = torch.empty_like(x)
    final = torch.empty((B, Hs, P, N), dtype=torch.float32, device=x.device)
    scratch = ()
    if uses_chunks(S):
        nc = -(-S // CHUNK)
        # each chunk's state increment (then its start state) and decay
        scratch = (torch.empty(B, Hs, nc, P, N, device=x.device),
                   torch.empty(B, Hs, nc, device=x.device))
    fn = _build.entry("ssm_scan", "ssm_scan_fwd", 11, 8, n_floats=0)
    err = fn(x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(),
             c.data_ptr(), d_skip.data_ptr(),
             state.data_ptr() if state is not None else None, y.data_ptr(),
             final.data_ptr(), *([t.data_ptr() for t in scratch]
                                 or [None, None]),
             _build.DTYPES[x.dtype], _build.DTYPES[a_log.dtype], B, S, Hs,
             P, N, int(state is not None),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "ssm_scan")
    _build.count_launch(ssm_scan)
    return y, final


ssm_scan.launches = 0

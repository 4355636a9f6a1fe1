"""K4: the mLSTM recurrence (xLSTM matrix memory) with state in and out,
in model layout.

q, k, v (B, S, H, dh) and the gate pre-activations ig, fg (B, S, H), all
float32; an optional initial state (C0 (B, H, dh, dh), n0 (B, H, dh),
m0 (B, H)), float32. Each step is ``repro.models.xlstm._mlstm_step``:

    m' = max(log sigmoid(fg) + m, ig)
    C  = exp(log sigmoid(fg) + m - m') C + exp(ig - m') v k^T
    n  = exp(log sigmoid(fg) + m - m') n + exp(ig - m') k
    h  = C q / max(|n . q|, 1)

Returns h (B, S, H, dh) and the final (C, n, m). Without a state the
scan starts from C = 0, n = 0, m = -1e30, as the Pallas kernel and
``repro.kernels.mlstm_scan.ref.mlstm_scan_ref`` do; the xLSTM model
passes its own zero state, whose m is 0. Unlike the Pallas wrapper, the
scan runs exactly S steps: no padded steps move m. On a CUDA tensor
``mlstm_scan`` launches the kernel of ``csrc/mlstm_scan.cu``; on a CPU
tensor it runs ``mlstm_scan_plain``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128, 256, 512)   # the kernel's instantiations


def _empty_state(B, H, dh, device):
    return (torch.zeros(B, H, dh, dh, device=device),
            torch.zeros(B, H, dh, device=device),
            torch.full((B, H), NEG_INF, device=device))


def mlstm_scan_plain(q, k, v, ig, fg, state=None):
    """K4's function in plain PyTorch: a loop over time in float32."""
    B, S, H, dh = q.shape
    C, n, m = state if state is not None else \
        _empty_state(B, H, dh, q.device)
    logf = F.logsigmoid(fg)
    h = torch.empty_like(q)
    for t in range(S):
        q_t, k_t, v_t = q[:, t], k[:, t], v[:, t]          # (B, H, dh)
        m_new = torch.maximum(logf[:, t] + m, ig[:, t])
        i_p = torch.exp(ig[:, t] - m_new)
        f_p = torch.exp(logf[:, t] + m - m_new)
        C = f_p[..., None, None] * C + i_p[..., None, None] \
            * (v_t[..., :, None] * k_t[..., None, :])
        n = f_p[..., None] * n + i_p[..., None] * k_t
        num = torch.einsum("bhij,bhj->bhi", C, q_t)
        den = torch.clamp_min(torch.abs((n * q_t).sum(-1)), 1.0)
        h[:, t] = num / den[..., None]
        m = m_new
    return h, (C, n, m)


def _check(q, k, v, ig, fg, state) -> None:
    tensors = (q, k, v, ig, fg) + tuple(state or ())
    if not (q.is_cuda and all(t.device == q.device for t in tensors)):
        raise ValueError("mlstm_scan: inputs must be on one CUDA device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError("mlstm_scan: dtypes "
                         f"{sorted({str(t.dtype) for t in tensors})}; the "
                         f"kernel takes float32 only")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("mlstm_scan: q, k, v (B, S, H, dh) expected")
    B, S, H, dh = q.shape
    if ig.shape != (B, S, H) or fg.shape != (B, S, H):
        raise ValueError("mlstm_scan: ig, fg (B, S, H) expected")
    if state is not None and (state[0].shape != (B, H, dh, dh)
                              or state[1].shape != (B, H, dh)
                              or state[2].shape != (B, H)):
        raise ValueError("mlstm_scan: state (C (B, H, dh, dh), "
                         "n (B, H, dh), m (B, H)) expected")
    if S < 1:
        raise ValueError("mlstm_scan: at least one step expected")
    if dh not in HEAD_DIMS:
        raise ValueError(f"mlstm_scan: head dim {dh} not in {HEAD_DIMS}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("mlstm_scan: inputs must be contiguous")


def mlstm_scan(q, k, v, ig, fg, state=None):
    """The mLSTM scan: K4 on a CUDA tensor, the plain version on a CPU
    tensor. Returns (h, (C, n, m))."""
    if q.device.type == "cpu":
        return mlstm_scan_plain(q, k, v, ig, fg, state)
    _check(q, k, v, ig, fg, state)
    B, S, H, dh = q.shape
    h = torch.empty_like(q)
    C = torch.empty((B, H, dh, dh), dtype=torch.float32, device=q.device)
    n = torch.empty((B, H, dh), dtype=torch.float32, device=q.device)
    m = torch.empty((B, H), dtype=torch.float32, device=q.device)
    s_ptrs = [t.data_ptr() for t in state] if state is not None \
        else [None] * 3
    fn = _build.entry("mlstm_scan", "mlstm_scan_fwd", 12, 5, n_floats=0)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), ig.data_ptr(),
             fg.data_ptr(), *s_ptrs, h.data_ptr(), C.data_ptr(),
             n.data_ptr(), m.data_ptr(), B, S, H, dh, int(state is not None),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "mlstm_scan")
    _build.count_launch(mlstm_scan)
    return h, (C, n, m)


mlstm_scan.launches = 0

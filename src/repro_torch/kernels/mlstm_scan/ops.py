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

The kernel has two paths, chosen by S (``uses_chunks``). Below one chunk
(``CHUNK`` steps; decode is S = 1) it runs the recurrence step by step.
From one chunk up it runs the chunkwise-parallel form of the xLSTM paper,
which ``mlstm_scan_chunked_plain`` transcribes: within a chunk of L steps
h is two matrix products, and only (C, n, m) crosses chunks. Both paths
compute ``mlstm_scan_plain``'s function.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.utils.time_loops import steps

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128, 256, 512)   # the kernel's instantiations
CHUNK = 64        # steps per chunk of the chunkwise path (csrc: CL)


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
    for t in steps(S):
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


def mlstm_scan_chunked_plain(q, k, v, ig, fg, state=None, chunk=CHUNK):
    """K4's chunkwise path in plain PyTorch, as the kernel computes it.

    m follows the step recurrence exactly. Per chunk, with m0, C0, n0 the
    state at its start and F_t the sum of log sigmoid(fg) over the
    chunk's steps up to t:
        a_t  = exp(m0 + F_t - m_t)
        D_ts = exp(ig_s + F_t - F_s - m_t) for s <= t, else 0
        P    = D o (Q K^T)
        h_t  = (P V + a_t Q C0^T)_t / max(|a_t n0 . q_t + sum_s P_ts|, 1)
    and at its end, with g = exp(m0 + F_L - m_L) and
    w_s = exp(ig_s + F_L - F_s - m_L):
        C = g C0 + (w o V)^T K,   n = g n0 + sum_s w_s k_s.
    Every exponent is at most 0, because m_t bounds each term."""
    B, S, H, dh = q.shape
    C, n, m = state if state is not None else \
        _empty_state(B, H, dh, q.device)
    logf = F.logsigmoid(fg)
    ms = torch.empty_like(ig)
    mt = m
    for t in steps(S):
        mt = torch.maximum(logf[:, t] + mt, ig[:, t])
        ms[:, t] = mt
    bhs = lambda a: a.permute(0, 2, 1)            # (B, S', H) -> (B, H, S')
    bhsd = lambda a: a.permute(0, 2, 1, 3)        # -> (B, H, S', dh)
    h = torch.empty_like(q)
    for i in steps(-(-S // chunk)):
        sl = slice(i * chunk, min(S, (i + 1) * chunk))
        Fc = torch.cumsum(bhs(logf[:, sl]), -1)
        mc, igc = bhs(ms[:, sl]), bhs(ig[:, sl])
        Q, K, V = bhsd(q[:, sl]), bhsd(k[:, sl]), bhsd(v[:, sl])
        L = Q.shape[2]
        causal = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
        expo = igc[..., None, :] + Fc[..., :, None] - Fc[..., None, :] \
            - mc[..., :, None]
        D = torch.exp(expo.masked_fill(~causal, float("-inf")))
        P = D * (Q @ K.transpose(-1, -2))
        a = torch.exp(m[..., None] + Fc - mc)
        num = P @ V + a[..., None] * (Q @ C.transpose(-1, -2))
        den = torch.clamp_min(torch.abs(a * (Q @ n[..., None])[..., 0]
                                        + P.sum(-1)), 1.0)
        h[:, sl] = (num / den[..., None]).permute(0, 2, 1, 3)
        FL, mL = Fc[..., -1], mc[..., -1]
        g = torch.exp(m + FL - mL)
        w = torch.exp(igc + FL[..., None] - Fc - mL[..., None])
        C = g[..., None, None] * C + (w[..., None] * V).transpose(-1, -2) @ K
        n = g[..., None] * n + (w[..., None] * K).sum(-2)
        m = mL
    return h, (C, n, m)


def uses_chunks(S: int) -> bool:
    """Whether the kernel takes its chunkwise path for S steps."""
    return S >= CHUNK


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
    tensor. Returns (h, (C, n, m)). Raises if autograd would record an
    input."""
    _build.refuse_dtensor("mlstm_scan", q, k, v, ig, fg, *(state or ()))
    _build.refuse_autograd("mlstm_scan", q, k, v, ig, fg, *(state or ()))
    if q.device.type == "cpu":
        return mlstm_scan_plain(q, k, v, ig, fg, state)
    _check(q, k, v, ig, fg, state)
    B, S, H, dh = q.shape
    h = torch.empty_like(q)
    C = torch.empty((B, H, dh, dh), dtype=torch.float32, device=q.device)
    n = torch.empty((B, H, dh), dtype=torch.float32, device=q.device)
    m = torch.empty((B, H), dtype=torch.float32, device=q.device)
    scratch = ()
    if uses_chunks(S):
        nc = -(-S // CHUNK)
        # P^T of every chunk and its gate vectors (a, row sums of P, w, g)
        scratch = (torch.empty(B * H * nc, CHUNK, CHUNK, device=q.device),
                   torch.empty(B * H * nc, 4, CHUNK, device=q.device))
    ptr = lambda ts, k: [t.data_ptr() for t in ts] if ts else [None] * k
    fn = _build.entry("mlstm_scan", "mlstm_scan_fwd", 14, 5, n_floats=0)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), ig.data_ptr(),
             fg.data_ptr(), *ptr(state, 3), h.data_ptr(), C.data_ptr(),
             n.data_ptr(), m.data_ptr(), *ptr(scratch, 2), B, S, H, dh,
             int(state is not None),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "mlstm_scan")
    _build.count_launch(mlstm_scan)
    return h, (C, n, m)


mlstm_scan.launches = 0

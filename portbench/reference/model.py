"""The plain reference: a decoder's forward pass in float32 PyTorch.

It follows the published decoder (Qwen3, Mistral): RMSNorm before
attention and before the SwiGLU feed-forward, grouped-query attention
with rotary embeddings (rotate-half, frequencies theta^(-2i/dh)), Qwen3's
RMSNorm on each query and key head, a sliding window where the
configuration has one, an untied output head. A VLM's prompt is its patch
embeddings, then its token embeddings.

``served_logits`` runs the prompt and the served tokens fed back through
the decoder, and returns the logits at the positions that chose each
served token. A decoded token attends to the keys the endpoint's cache
holds when it is decoded (``decode_keys``): a full cache sized to the
prompt takes every decoded key in its last slot, so a decoded token sees
the prompt's first S - 1 keys and its own; a ring of W slots holds the
last W positions, which is plain sliding-window attention.

Nothing here imports the program. ``quant="fp8"`` is the control: every
product's inputs (weights, activations, queries, keys, values and
attention weights) rounded to float8 e4m3 with a scale per tensor, the
precision below the bfloat16 that the configuration serves in.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from portbench.reference.weights import head_dim

F8_MAX = 448.0
Q_CHUNK = 1024


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale, in f32."""
    s = t.abs().amax().clamp_min(1e-30) / F8_MAX
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def _mm(a, b, quant):
    if quant == "fp8":
        a, b = fp8(a), fp8(b)
    return a @ b


def rms_norm(x, w, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x, positions, theta: float):
    """x (..., N, heads, dh) rotated at ``positions`` (N,)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[:, None].to(torch.float32) * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def cache_of(arch: Dict, serve_seq: int):
    """("ring", W) for an arch with a sliding window, else ("full", S):
    the cache an endpoint serving prompts of ``serve_seq`` keeps."""
    win = arch.get("sliding_window") or 0
    if win:
        return ("ring", min(win, serve_seq))
    return ("full", serve_seq)


def decode_keys(cache, S: int, p: int, window: int) -> List[int]:
    """Positions of the keys a token decoded at position ``p`` attends to,
    after a prompt of S and decoded tokens at S .. p - 1, each written
    before it attends: a full cache of C slots writes position q to slot
    min(q, C - 1) and counts slot i as position i; a ring of W slots
    writes q to slot q % W."""
    kind, C = cache
    holds = [-1] * C
    for q in range(max(0, S - C) if kind == "ring" else 0, p + 1):
        holds[(q % C) if kind == "ring" else min(q, C - 1)] = q
    keep = []
    for i, q in enumerate(holds):
        at = q if kind == "ring" else i
        if q >= 0 and at <= p and not (window and at <= p - window):
            keep.append(q)
    return sorted(keep)


def _attend(q, k, v, mask, quant):
    """q (Sq, H, dh), k/v (Sk, KV, dh), mask (Sq, Sk) bool -> (Sq, H, dh)."""
    H, KV, dh = q.shape[1], k.shape[1], q.shape[2]
    G = H // KV
    qh = q.permute(1, 0, 2)                                 # H Sq dh
    kh = k.permute(1, 0, 2).repeat_interleave(G, 0)         # H Sk dh
    vh = v.permute(1, 0, 2).repeat_interleave(G, 0)
    s = _mm(qh, kh.transpose(1, 2), quant) * dh ** -0.5
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return _mm(p, vh, quant).permute(1, 0, 2)


def served_logits(arch: Dict, w: Dict, prompt: Dict, fed: torch.Tensor,
                  serve_seq: int, quant: Optional[str] = None
                  ) -> torch.Tensor:
    """f32 logits (B, n + 1, V) at the prompt's last position and at each
    of the n tokens ``fed`` (B, n) after it (the served tokens the
    endpoint fed back): row j chose the served token j. ``w`` holds the
    weights (bf16 or f32, on the device the reference runs on)."""
    dev = fed.device
    d, L = arch["hidden_size"], arch["num_hidden_layers"]
    H, KV, dh = arch["num_attention_heads"], arch["num_key_value_heads"], \
        head_dim(arch)
    eps, theta = arch["rms_norm_eps"], arch["rope_theta"]
    window = arch.get("sliding_window") or 0
    emb = w["emb"]
    parts = []
    if "patch_embeds" in prompt:
        parts.append(prompt["patch_embeds"].float())
    parts += [emb[prompt["tokens"].long()].float(), emb[fed.long()].float()]
    x = torch.cat(parts, dim=1)                            # B N d
    B, N, _ = x.shape
    S, n = serve_seq, fed.shape[1]
    assert N == S + n, (N, S, n)
    pos = torch.arange(N, device=dev)
    # prompt rows: causal (and windowed) over the prompt
    qi = torch.arange(S, device=dev)[:, None]
    kj = torch.arange(S, device=dev)[None, :]
    pmask = kj <= qi
    if window:
        pmask &= kj > qi - window
    # decoded rows: the keys the cache holds
    cache = cache_of(arch, S)
    dmask = torch.zeros((n, N), dtype=torch.bool, device=dev)
    for m in range(n):
        dmask[m, decode_keys(cache, S, S + m, window)] = True
    lay = w["layers"]
    for i in range(L):
        p = {k: t[i].float() for k, t in lay.items()}
        xn = rms_norm(x, p["ln1"], eps)
        q = _mm(xn, p["wq"], quant).view(B, N, H, dh)
        k = _mm(xn, p["wk"], quant).view(B, N, KV, dh)
        v = _mm(xn, p["wv"], quant).view(B, N, KV, dh)
        if "q_norm" in p:
            q, k = rms_norm(q, p["q_norm"], eps), rms_norm(k, p["k_norm"],
                                                           eps)
        q, k = rope(q, pos, theta), rope(k, pos, theta)
        out = torch.empty_like(q)
        for b in range(B):
            for c in range(0, S, Q_CHUNK):
                e = min(c + Q_CHUNK, S)
                out[b, c:e] = _attend(q[b, c:e], k[b, :S], v[b, :S],
                                      pmask[c:e], quant)
            out[b, S:] = _attend(q[b, S:], k[b], v[b], dmask, quant)
        x = x + _mm(out.reshape(B, N, H * dh), p["wo"], quant)
        del q, k, v, out
        xn = rms_norm(x, p["ln2"], eps)
        h = torch.nn.functional.silu(_mm(xn, p["w1"], quant)) \
            * _mm(xn, p["w3"], quant)
        x = x + _mm(h, p["w2"], quant)
        del h, xn
    xs = rms_norm(x[:, S - 1:], w["final_norm"].float(), eps)
    return _mm(xs, w["lm_head"].float(), quant)


def gaps(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each token's logit lies below the best: logits (..., V),
    tokens (...) -> (...) >= 0."""
    chosen = logits.gather(-1, tokens.long()[..., None])[..., 0]
    return logits.amax(-1) - chosen

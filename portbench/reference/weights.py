"""The benchmark's weights and inputs, drawn from a seed.

Both sides get the same numbers from here: the harness copies the weights
into each endpoint's host copy and hands each invocation its inputs, and
the reference draws them again after the window. Nothing here imports the
program.

An architecture is a dict of sizes in the benchmark's configuration file
(``hidden_size``, ``num_hidden_layers``, ...). Its parameters are the
decoder's: an embedding, an untied output head, a final norm, and the
per-layer leaves stacked on a leading layer axis (the layout the program
keeps). Norm weights are ones; every other leaf is N(0, 1) / sqrt(fan in)
in float32, cast to bfloat16, the type the endpoints serve in. The
embedding's fan in is its row count, as the program's own initializer
takes it.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import torch

MASK63 = (1 << 63) - 1


def mix_seed(*parts: int) -> int:
    """A generator seed below 2**63 from integers of any size."""
    h = 0x9E3779B97F4A7C15
    for p in parts:
        h = (h ^ (int(p) & ((1 << 64) - 1))) * 0xBF58476D1CE4E5B9
        h = (h ^ (h >> 31)) & ((1 << 64) - 1)
    return h & MASK63


def head_dim(arch: Dict) -> int:
    return arch.get("head_dim") or arch["hidden_size"] // arch[
        "num_attention_heads"]


def param_shapes(arch: Dict) -> Dict[Tuple[str, ...], Tuple[int, ...]]:
    """{path: shape} of a decoder's parameters, layer leaves stacked."""
    d, L, ff = arch["hidden_size"], arch["num_hidden_layers"], \
        arch["intermediate_size"]
    H, KV, dh = arch["num_attention_heads"], arch["num_key_value_heads"], \
        head_dim(arch)
    V = arch["vocab_size"]
    out = {
        ("emb",): (V, d),
        ("final_norm",): (d,),
        ("layers", "ln1"): (L, d),
        ("layers", "ln2"): (L, d),
        ("layers", "wq"): (L, d, H * dh),
        ("layers", "wk"): (L, d, KV * dh),
        ("layers", "wv"): (L, d, KV * dh),
        ("layers", "wo"): (L, H * dh, d),
        ("layers", "w1"): (L, d, ff),
        ("layers", "w3"): (L, d, ff),
        ("layers", "w2"): (L, ff, d),
    }
    if arch.get("qk_norm"):
        out[("layers", "q_norm")] = (L, dh)
        out[("layers", "k_norm")] = (L, dh)
    if arch.get("tie_word_embeddings"):
        raise ValueError("tied embeddings: the endpoints serve an untied "
                         "output head")
    out[("lm_head",)] = (d, V)
    return out


def _is_norm(path) -> bool:
    return path[-1] in ("ln1", "ln2", "q_norm", "k_norm", "final_norm")


def draw_weights(arch: Dict, seed: int, device) -> Iterator[
        Tuple[Tuple[str, ...], torch.Tensor]]:
    """(path, bf16 tensor on ``device``) for every parameter, in sorted
    path order, from one generator seeded with ``seed``. Stacked leaves
    are drawn a layer at a time, so no float32 copy of a whole leaf is
    ever held."""
    gen = torch.Generator(device).manual_seed(seed)
    for path, shape in sorted(param_shapes(arch).items()):
        if _is_norm(path):
            yield path, torch.ones(shape, dtype=torch.bfloat16,
                                   device=device)
            continue
        scale = shape[-2] ** -0.5
        out = torch.empty(shape, dtype=torch.bfloat16, device=device)
        for part in (out if len(shape) == 3 else [out]):
            part.copy_(torch.randn(part.shape, generator=gen,
                                   dtype=torch.float32, device=device)
                       .mul_(scale))
        yield path, out


def weights(arch: Dict, seed: int, device) -> Dict:
    """The nested parameter dict of ``draw_weights``."""
    out: Dict = {}
    for path, t in draw_weights(arch, seed, device):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return out


def inputs(arch: Dict, batch: int, seq: int, seed: int, device) -> Dict:
    """One invocation's prompt: ``tokens`` (B, seq - n_patches) int32
    uniform over the vocabulary and, for a VLM, ``patch_embeds`` (B,
    n_patches, d) bf16, N(0, 1) * 0.02, which come first in the prompt."""
    gen = torch.Generator(device).manual_seed(seed)
    n_patches = arch.get("n_patches", 0)
    out = {}
    if n_patches:
        out["patch_embeds"] = (torch.randn(
            (batch, n_patches, arch["hidden_size"]), generator=gen,
            dtype=torch.float32, device=device) * 0.02).to(torch.bfloat16)
    out["tokens"] = torch.randint(0, arch["vocab_size"],
                                  (batch, seq - n_patches), generator=gen,
                                  dtype=torch.int32, device=device)
    return out

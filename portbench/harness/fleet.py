"""A configuration's fleet: one ``TorchEndpoint`` a function, with the
benchmark's weights and inputs handed to it, and wrappers that record
what the harness reads.

The harness drives the program only through its public objects: it
builds each endpoint as a user would, copies its own weights into the
endpoint's host copy, makes the endpoint's model draw each invocation's
prompt with the benchmark's generator, and wraps methods of the objects
it built (``execute``, ``upload``, the model's ``decode_fn`` and, when
tracing, ``prefill_fn`` and the attention ops) to read what they did.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from portbench.harness import costs
from portbench.reference import weights as W

# configuration keys -> the program's ModelConfig fields
FIELDS = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
          "num_attention_heads": "n_heads",
          "num_key_value_heads": "n_kv_heads", "head_dim": "head_dim",
          "intermediate_size": "d_ff", "vocab_size": "vocab_size",
          "qk_norm": "qk_norm", "rope_theta": "rope_theta",
          "sliding_window": "sliding_window", "n_patches": "n_patches",
          "tie_word_embeddings": "tie_embeddings"}


@dataclass
class Fn:
    name: str
    arch_id: str
    arch: Dict
    batch: int
    seq: int
    steps: int
    weight_seed: int
    flops: float
    tokens: int


def functions(config: Dict, seed: int) -> Dict[str, Fn]:
    out = {}
    for f in config["functions"]:
        arch = config["archs"][f["arch"]]
        B, S, n = f["serve_batch"], f["serve_seq"], f["decode_steps"]
        out[f["name"]] = Fn(f["name"], f["arch"], arch, B, S, n,
                            W.mix_seed(seed, f["seed_offset"]),
                            costs.invocation_flops(arch, B, S, n),
                            costs.invocation_tokens(B, S, n))
    return out


class Spans:
    """Host ranges (name, start ns, end ns on the wall clock the profiler
    stamps) and roofline bounds, recorded while a trace slice is open."""

    def __init__(self):
        self.active = False
        self.ranges: List[tuple] = []
        self.bound_s = {"k1": 0.0, "k2": 0.0}
        self.lock = threading.Lock()

    def wrap(self, name: str, fn):
        def call(*a, **kw):
            if not self.active:
                return fn(*a, **kw)
            t0 = time.time_ns()
            try:
                return fn(*a, **kw)
            finally:
                self.ranges.append((name, t0, time.time_ns()))
        return call

    def add_bound(self, kernel: str, flops: float, nbytes: float) -> None:
        if self.active:
            with self.lock:
                self.bound_s[kernel] += costs.bound_s(flops, nbytes)


def program_config(arch_id: str, arch: Dict):
    """The program's ModelConfig for ``arch_id``, with every size the
    configuration file states."""
    from repro_torch.configs import get_config
    kw = {FIELDS[k]: (v or 0) if k == "sliding_window" else v
          for k, v in arch.items() if k in FIELDS}
    return dataclasses.replace(get_config(arch_id), **kw)


class Fleet:
    def __init__(self, config: Dict, seed: int, device,
                 spans: Optional[Spans] = None):
        self.config = config
        self.device = torch.device(device)
        self.fns = functions(config, seed)
        self.spans = spans
        self.endpoints: Dict = {}
        self.uploads: List[tuple] = []   # (monotonic start, s, bytes)
        self.parts = {"kernels_s": 0.0, "endpoints_s": 0.0,
                      "warmups_s": 0.0}

    def build(self) -> None:
        from repro_torch.kernels import _build
        from repro_torch.runtime.device import TorchEndpoint
        t = time.monotonic()
        if self.device.type == "cuda":
            _build.build_all()
        self.parts["kernels_s"] = time.monotonic() - t
        for fn in self.fns.values():
            t = time.monotonic()
            ep = TorchEndpoint(fn.name, program_config(fn.arch_id, fn.arch),
                               seed=0, serve_seq=fn.seq,
                               serve_batch=fn.batch, decode_steps=fn.steps,
                               device=self.device)
            self._hand_weights(ep, fn)
            self._instrument(ep, fn)
            self.endpoints[fn.name] = ep
            self.parts["endpoints_s"] += time.monotonic() - t
            t = time.monotonic()
            ep.compile()
            ep.evict()
            self.parts["warmups_s"] += time.monotonic() - t

    def _hand_weights(self, ep, fn: Fn) -> None:
        """Copy the benchmark's weights into the endpoint's host copy, leaf
        by leaf, after checking that the program holds the same leaves."""
        want = {p: s for p, s in W.param_shapes(fn.arch).items()}
        have = {}

        def walk(tree, path=()):
            for k, v in tree.items():
                if isinstance(v, dict):
                    walk(v, path + (k,))
                else:
                    have[path + (k,)] = v
        walk(ep.host_params)
        if {p: tuple(t.shape) for p, t in have.items()} != want:
            raise ValueError(f"{fn.name}: the program's parameters "
                             f"{sorted(have)} are not the configuration's "
                             f"{sorted(want)}")
        for path, t in W.draw_weights(fn.arch, fn.weight_seed, self.device):
            have[path].copy_(t)
            del t

    def _instrument(self, ep, fn: Fn) -> None:
        model, spans, arch = ep.model, self.spans, fn.arch
        first = {}

        def make_batch(shape, generator, device):
            if (shape.global_batch, shape.seq_len) != (fn.batch, fn.seq):
                raise ValueError(f"{fn.name}: asked for a batch of "
                                 f"{shape}")
            return W.inputs(arch, fn.batch, fn.seq,
                            generator.initial_seed(), device)
        model.make_batch = make_batch

        decode_fn = model.decode_fn

        def decode(params, cache, tokens, pos, ring=False):
            if pos == fn.seq:          # the first step: the prefill's token
                first["t1"] = tokens
            return decode_fn(params, cache, tokens, pos, ring=ring)
        model.decode_fn = decode

        execute = ep.execute

        def run(request=None):
            request.setdefault("ran_on", []).append(fn.name)
            t0 = time.monotonic()
            try:
                out = execute(request)
            except Exception as e:      # recorded, then raised as before
                request["error"] = repr(e)
                raise
            request["served"] = torch.cat(
                [first.pop("t1").cpu(), torch.from_numpy(out["tokens"])],
                dim=1)
            request["exec"] = (t0, time.monotonic())
            return out
        ep.execute = run

        upload = ep.upload

        def up():
            t0 = time.monotonic()
            s = upload()
            self.uploads.append((t0, s, ep.weight_bytes))
            return s
        ep.upload = up

        if spans is None:
            return
        ep.execute = spans.wrap("execute", ep.execute)
        ep.upload = spans.wrap("upload", ep.upload)
        model.prefill_fn = spans.wrap("prefill", model.prefill_fn)
        model.decode_fn = spans.wrap("decode", model.decode_fn)
        ops = model.ops

        def prefill(q, k, v, *, causal=True, window=0):
            B, Sq, H, dh = q.shape
            spans.add_bound("k1", *costs.k1_cost(
                B, Sq, k.shape[1], H, k.shape[2], dh, causal, window,
                q.element_size()))
            return ops.prefill(q, k, v, causal=causal, window=window)

        def decode_att(q, ck, cv, pos, *, window=0, ring=False):
            B, _, H, dh = q.shape
            n = costs.valid_slots(ck.shape[1], pos, window, ring)
            spans.add_bound("k2", *costs.k2_cost(
                B, H, ck.shape[2], dh, n, q.element_size(),
                ck.element_size()))
            return ops.decode(q, ck, cv, pos, window=window, ring=ring)
        model.ops = dataclasses.replace(ops, prefill=prefill,
                                        decode=decode_att)

    def reseed(self, seed: int) -> None:
        """Hand every endpoint the weights of another seed; each is left
        on the host."""
        self.fns = functions(self.config, seed)
        for name, ep in self.endpoints.items():
            ep.evict()
            self._hand_weights(ep, self.fns[name])

    def free(self) -> None:
        """Drop the endpoints and their device and host memory."""
        for ep in self.endpoints.values():
            ep.evict()
        self.endpoints.clear()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

"""Real-execution endpoints: the PyTorch device path (port of
``repro.runtime.device``).

A ``TorchEndpoint`` is one serveable function: a model, host-resident
weights (pinned CPU memory when the device is a GPU), and the prefill /
decode steps that run on the hand-written CUDA kernels. For xLSTM the
cache is the recurrent state (``CachePlan("state", 0)``): prefill
returns it and each decode step continues from it, ignoring ``pos`` as
the reference does. A VLM's decode starts after its patch embeddings and
its tokens, at ``s_text + n_patches``, as ``JaxEndpoint``'s does; Whisper's
after its tokens (its frames feed the encoder), over a full self cache of
``serve_seq`` slots and a cross cache of ``encoder_len``. It keeps
``JaxEndpoint``'s duck type, so the control plane's memory "regions" map
to real bytes here:

  cold       — build kernels + warm-up + upload   (first instantiation)
  host_warm  — weights evicted from device: re-upload only
  warm       — device-resident: execute immediately

Each endpoint records its spans through ``runtime.trace`` (off unless
switched on): the wait for its lock, the inputs, the prefill, each decode
step, the closing sync, uploads, the cold start and evictions.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import _build
from repro_torch.models import build_model, decode_cache_plan
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.runtime import trace
from repro_torch.shapes import InputShape


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist (no silent
    fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; pass "
            f"device='cpu' to run on the CPU")
    return dev


class EndpointLock:
    """A ``threading.Lock`` that records each wait for it as a ``lock``
    span: the executor's ``with ep.lock:`` around an execution or a
    prefetch."""

    def __init__(self, fn_id: str):
        self.fn_id = fn_id
        self._lock = threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        t = trace.begin()
        got = self._lock.acquire(blocking, timeout)
        trace.end(t, "lock", self.fn_id)
        return got

    __enter__ = acquire

    def release(self) -> None:
        self._lock.release()

    def __exit__(self, *exc) -> None:
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()


class TorchEndpoint:
    def __init__(self, fn_id: str, cfg: ModelConfig, seed: int = 0,
                 serve_seq: int = 64, serve_batch: int = 2,
                 decode_steps: int = 4, device="cuda"):
        self.fn_id = fn_id
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = build_model(cfg)
        self.serve_shape = InputShape("serve", serve_seq, serve_batch,
                                      "prefill")
        self.decode_steps = decode_steps
        self.plan = decode_cache_plan(cfg, serve_seq)
        # weights drawn on the device, then kept on the host (pinned on a
        # GPU host, so uploads are DMA copies that can run asynchronously)
        gen = torch.Generator(self.device).manual_seed(seed)
        params = self.model.init_params(gen, self.device)
        self.host_params = tree_map(self._to_host, params)
        del params
        self.weight_bytes = sum(t.numel() * t.element_size()
                                for t in tree_leaves(self.host_params))
        self.device_params = None
        self.uploads = 0            # host -> device copies of the weights
        self._compiled = False
        self.lock = EndpointLock(fn_id)  # one instance: serialize executions
        self.last_use = 0.0

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        pin = self.device.type == "cuda"
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
        return host.copy_(t)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- residency ---------------------------------------------------------
    @property
    def resident(self) -> bool:
        return self.device_params is not None

    def upload(self) -> float:
        t0 = time.monotonic()
        span = trace.begin()
        self.device_params = tree_map(
            lambda t: t.to(self.device, non_blocking=True, copy=True),
            self.host_params)
        t = trace.begin()
        self._sync()
        trace.end(t, "sync", self.fn_id)
        self.uploads += 1
        trace.end(span, "upload", self.fn_id, self.weight_bytes)
        return time.monotonic() - t0

    def evict(self) -> None:
        if self.device_params is not None:
            trace.instant("evict", self.fn_id, self.weight_bytes)
        self.device_params = None

    # -- compilation (the "container init" analogue) -------------------------
    def compile(self) -> float:
        """Build the kernels (first use in the process), then run one
        warm-up prefill and decode step."""
        t0 = time.monotonic()
        span = trace.begin()
        if self.device.type == "cuda":
            _build.build_all()
        if self.device_params is None:
            self.upload()
        self._run(seed=0, steps=1)
        self._compiled = True
        trace.end(span, "compile", self.fn_id)
        return time.monotonic() - t0

    @property
    def compiled(self) -> bool:
        return self._compiled

    # -- serving -----------------------------------------------------------
    def _run(self, seed: int, steps: int) -> torch.Tensor:
        fn = self.fn_id
        gen = torch.Generator(self.device).manual_seed(seed)
        t = trace.begin()
        batch = self.model.make_batch(self.serve_shape, gen, self.device)
        trace.end(t, "inputs", fn)
        with torch.inference_mode():
            t = trace.begin()
            logits, cache = self.model.prefill_fn(
                self.device_params, batch, cache_len=self.plan.length,
                ring=self.plan.ring)
            pos = self.model.decode_start(batch)
            tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
            trace.end(t, "prefill", fn)
            toks = []
            for i in range(steps):
                t = trace.begin()
                logits, cache = self.model.decode_fn(
                    self.device_params, cache, tok, pos + i,
                    ring=self.plan.ring)
                tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
                trace.end(t, "decode", fn)
                toks.append(tok)
            t = trace.begin()
            out = torch.cat(toks, dim=1).cpu()
        self._sync()
        trace.end(t, "sync", fn)
        return out

    def execute(self, request: Optional[dict] = None) -> Dict[str, object]:
        """One batched request: prefill + ``decode_steps`` greedy decode
        steps. Returns {"exec_s", "tokens" (B, decode_steps) numpy}."""
        if not (self.resident and self.compiled):
            raise RuntimeError(f"{self.fn_id}: execute() before upload() "
                               f"and compile()")
        t0 = time.monotonic()
        toks = self._run((request or {}).get("seed", 0), self.decode_steps)
        return {"exec_s": time.monotonic() - t0, "tokens": toks.numpy()}

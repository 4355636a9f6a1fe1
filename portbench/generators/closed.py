"""Closed loop: ``clients`` callers, each sending its next invocation as
soon as its last one completes (no think time), as a batch orchestrator
with bounded concurrency does.

Functions come from one deck shared by the clients: ``deck`` cards dealt
in the mix's exact shares (``harness.mixes.shares``), shuffled by the
mix's ``schedule_seed``, and dealt again when it runs out; the run's seed
draws the weights, the prompts and the sample checked. The clients start
together at the warm-up's beginning and send nothing due after the
window closes.
"""
from __future__ import annotations

import random
from typing import Dict, List

from portbench.harness.mixes import deal, shares


def drive(ctx, mix: Dict, fns: List[str], arch_of: Dict[str, str],
          seed: int) -> None:
    rng = random.Random(mix["schedule_seed"])
    cards = deal(shares(mix, fns, arch_of), mix["deck"])
    deck: List[str] = []

    def draw() -> str:
        if not deck:
            deck.extend(cards)
            rng.shuffle(deck)
        return deck.pop()

    t = ctx.now()
    for _ in range(mix["clients"]):
        ctx.submit(draw(), t)
    while True:
        rec = ctx.next_completion(ctx.seconds)
        if rec is None:
            return
        t = ctx.now()
        if t < ctx.seconds:
            ctx.submit(draw(), t)

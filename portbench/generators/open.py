"""Open loop: invocations sent on a schedule, whether or not earlier ones
have finished, as independent tenants send them.

The mix gives ``rate_per_s`` and how the functions share the invocations
(``harness.mixes.shares``). The warm-up (``warm_s`` before the window) and
the window each get round(rate x length) arrivals whose gaps are the
quantiles of an exponential distribution at that rate, scaled to fill the
span, and whose functions are dealt in exact shares; the mix's
``schedule_seed`` orders the gaps and the functions. So every run offers
the same arrivals: the run's seed draws the weights, the prompts and the
sample checked, and leaves the queue's shape alone.
"""
from __future__ import annotations

import math
import random
from typing import Dict, List, Tuple

from portbench.harness.mixes import deal, shares


def schedule(mix: Dict, fns: List[str], arch_of: Dict[str, str],
             warm_s: float, seconds: float) -> List[Tuple[float, str]]:
    """(due seconds from the window's opening, function) in time order."""
    rng = random.Random(mix["schedule_seed"])
    rate, share = mix["rate_per_s"], shares(mix, fns, arch_of)
    out = []
    for lo, span in ((-warm_s, warm_s), (0.0, seconds)):
        n = round(rate * span)
        if n == 0:
            continue
        gaps = [-math.log(1 - (k + 0.5) / n) for k in range(n)]
        scale = span / sum(gaps)
        gaps = [g * scale for g in gaps]
        names = deal(share, n)
        rng.shuffle(gaps)
        rng.shuffle(names)
        t = lo
        for g, f in zip(gaps, names):
            out.append((t, f))
            t += g
    return out


def drive(ctx, mix: Dict, fns: List[str], arch_of: Dict[str, str],
          seed: int) -> None:
    for due, fn in schedule(mix, fns, arch_of, ctx.warm_s, ctx.seconds):
        ctx.wait_until(due)
        ctx.submit(fn, due)
    ctx.wait_until(ctx.seconds)

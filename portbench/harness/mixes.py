"""How a traffic mix shares its invocations among a fleet's functions."""
from __future__ import annotations

from typing import Dict, List


def shares(mix: Dict, fns: List[str], arch_of: Dict[str, str]
           ) -> Dict[str, float]:
    """{function: share} from the mix: ``zipf_s`` weighs the i-th function
    of the configuration 1 / (i + 1)^s (the order sets the ranks);
    ``arch_shares`` gives each architecture a share, split evenly among
    its functions; without either every function gets an even share."""
    if "zipf_s" in mix:
        w = {f: 1.0 / (i + 1) ** mix["zipf_s"] for i, f in enumerate(fns)}
    elif "arch_shares" in mix:
        per = mix["arch_shares"]
        w = {f: per[arch_of[f]] / sum(arch_of[g] == arch_of[f] for g in fns)
             for f in fns}
    else:
        w = {f: 1.0 for f in fns}
    total = sum(w.values())
    return {f: v / total for f, v in w.items()}


def deal(share: Dict[str, float], n: int) -> List[str]:
    """``n`` function names in the given shares, by largest remainder, in
    the configuration's order: the same counts for every seed."""
    exact = {f: s * n for f, s in share.items()}
    count = {f: int(v) for f, v in exact.items()}
    rest = sorted(share, key=lambda f: count[f] - exact[f])
    for f in rest[:n - sum(count.values())]:
        count[f] += 1
    return [f for f in share for _ in range(count[f])]

"""Whether the timed path's answers are right.

Two kinds of number, each beside its limit:

- The control plane's: invocations due in the window that never
  answered (``missing``), that ran on another function's endpoint
  (``wrong_endpoint``) or that ran other than once (``not_once``). Each
  has the limit 0.
- The model's: after the window, a sample of the answered invocations,
  drawn from the seed, with one of each architecture in it (so the
  longest prompt's) and, where any was, one that had to upload its
  weights. The reference draws each
  sampled function's weights and each sampled prompt again, runs the
  prompt and the served tokens in float32 (``reference.model``), and
  reads how far each served token's logit lies below its best. The
  widest gap of an architecture is held to that architecture's limit in
  the configuration (``archs.<arch>.logit_gap_limit``).
"""
from __future__ import annotations

import random
from typing import Dict, List

import torch

from portbench.reference import model as ref
from portbench.reference import weights as W


def control_plane(window, fns) -> Dict[str, int]:
    missing = wrong = not_once = 0
    for r in window:
        ran = r.request.get("ran_on", [])
        missing += not r.ok
        wrong += any(f != r.fn for f in ran)
        not_once += len(ran) != 1
    return {"missing": missing, "wrong_endpoint": wrong,
            "not_once": not_once}


def sample(window, fns, n: int, seed: int) -> List:
    """``n`` answered invocations due in the window, drawn from the seed:
    one of each architecture (so the longest prompt's is in), one that
    uploaded its weights (if any did), the rest at random."""
    ok = [r for r in window if r.ok]
    rng = random.Random(W.mix_seed(seed, 99))
    picks = [rng.choice([r for r in ok if fns[r.fn].arch_id == a])
             for a in sorted({fns[r.fn].arch_id for r in ok})]
    swapped = [r for r in ok if r.start_type != "warm" and r not in picks]
    if swapped:
        picks.append(rng.choice(swapped))
    rest = [r for r in ok if r not in picks]
    picks += rng.sample(rest, min(max(n - len(picks), 0), len(rest)))
    return picks


def model_gaps(picks, fns, device, control: bool = False):
    """{arch: widest gap} over the sampled invocations, the reference run
    in float32 with TF32 off, one function's weights at a time. With
    ``control``, also {arch: widest gap} of the tokens that the reference
    computed in fp8 (``reference.model.fp8``) puts first at the same
    positions: the control, which has to fail."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    widest: Dict[str, float] = {}
    ctrl: Dict[str, float] = {}
    by_fn: Dict[str, list] = {}
    for r in picks:
        by_fn.setdefault(r.fn, []).append(r)
    with torch.inference_mode():
        for name, recs in sorted(by_fn.items()):
            fn = fns[name]
            w = W.weights(fn.arch, fn.weight_seed, device)
            for r in recs:
                served = r.request["served"].to(device)
                prompt = W.inputs(fn.arch, fn.batch, fn.seq,
                                  r.request["seed"], device)
                logits = ref.served_logits(fn.arch, w, prompt,
                                           served[:, :-1], fn.seq)
                g = float(ref.gaps(logits, served).max())
                widest[fn.arch_id] = max(widest.get(fn.arch_id, 0.0), g)
                if control:
                    low = ref.served_logits(fn.arch, w, prompt,
                                            served[:, :-1], fn.seq,
                                            quant="fp8")
                    g = float(ref.gaps(logits, low.argmax(-1)).max())
                    ctrl[fn.arch_id] = max(ctrl.get(fn.arch_id, 0.0), g)
                    del low
                del logits, prompt
            del w
    return (widest, ctrl) if control else widest


def numbers(window, fns, picks, config, device, gaps=None
            ) -> Dict[str, Dict]:
    """Every number compared, {name: {"value", "limit"}}. ``gaps``
    ({arch: widest gap}, as ``model_gaps`` gives) stands in for the
    program's: ``readings.py`` judges the control's gaps by it."""
    out = {k: {"value": v, "limit": 0}
           for k, v in control_plane(window, fns).items()}
    if gaps is None:
        gaps = model_gaps(picks, fns, device)
    for arch_id, g in sorted(gaps.items()):
        out[f"logit_gap.{arch_id}"] = {
            "value": g,
            "limit": config["archs"][arch_id]["logit_gap_limit"]}
    out["sampled"] = {"value": len(picks), "limit": 1}
    return out


def correct(nums: Dict[str, Dict]) -> bool:
    return all((v["value"] >= v["limit"]) if k == "sampled"
               else (v["value"] <= v["limit"]) for k, v in nums.items())

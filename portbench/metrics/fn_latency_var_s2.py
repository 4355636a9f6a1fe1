"""Variance across functions of each function's mean latency from due
time (the paper's inter-function fairness measure), in s^2."""
import statistics


def read(run):
    per = {}
    for r in run.window:
        if r.ok:
            per.setdefault(r.fn, []).append(r.latency)
    means = [statistics.fmean(v) for v in per.values()]
    return statistics.pvariance(means) if len(means) > 1 else None

"""Median latency of the invocations due in the window, from due time to
completion, in seconds."""
from portbench.harness.stats import percentile


def read(run):
    return percentile(run.latencies(), 50)

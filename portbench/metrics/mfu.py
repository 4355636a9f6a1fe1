"""The model step's share, in %, of the card's bf16 peak: the operations of
the invocations completed in the window, by the benchmark's own count
(``harness.costs.invocation_flops``), over the window's seconds x 989
TFLOP/s."""
from portbench.harness.costs import PEAK_BF16_FLOPS


def read(run):
    done = run.completed_in_window
    if not done:
        return None
    flops = sum(run.fns[r.fn].flops for r in done)
    return 100.0 * flops / (run.seconds * PEAK_BF16_FLOPS)

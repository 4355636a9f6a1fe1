"""Share, in %, of the traced slice in which no kernel, copy or set ran
on the card. Read as ``idle_share.open`` in the open-loop cells and as
``idle_share.closed`` in the closed-loop ones."""


def read(run):
    t = run.trace
    return 100.0 * (1 - t["busy_s"] / t["window_s"]) if t else None

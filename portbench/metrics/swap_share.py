"""Share, in %, of the invocations due in the window that the control
plane did not start warm (their weights were not on the card)."""


def read(run):
    win = [r for r in run.window if r.ok]
    return 100.0 * sum(r.start_type != "warm" for r in win) / len(win) \
        if win else None

"""Positions run (B x (prompt + decode steps)) by the invocations that
completed inside the window, over the window's seconds."""


def read(run):
    done = run.completed_in_window
    return sum(run.fns[r.fn].tokens for r in done) / run.seconds \
        if done else None

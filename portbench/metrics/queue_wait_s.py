"""Mean seconds from due time to the control plane's dispatch, over the
invocations due in the window."""
from portbench.harness.stats import mean


def read(run):
    return mean(r.t_dispatch - r.due for r in run.window
                if r.ok and r.t_dispatch is not None)

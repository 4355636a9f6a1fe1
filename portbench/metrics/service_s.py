"""Mean seconds an endpoint's ``execute`` took (``Invocation.service_time``)
over the invocations due in the window. Read as ``service_s.open`` in the
open-loop cells and as ``service_s.closed`` in the closed-loop ones."""
from portbench.harness.stats import mean


def read(run):
    return mean(r.service_s for r in run.window if r.ok)

"""K2's share, in %, of its roofline over the traced slice: the least time
of each decode attention call (``harness.costs.k2_cost``), summed, over
the device time of the K2 kernels by name."""
NAMES = ("decode_sm90", "decode_cluster")


def read(run):
    t = run.kernel_s(*NAMES)
    b = run.bound_s.get("k2", 0.0)
    return 100.0 * b / t if t > 0 and b > 0 else None

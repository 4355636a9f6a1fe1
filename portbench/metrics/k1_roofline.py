"""K1's share, in %, of its roofline over the traced slice: the least time
of each prefill attention call (``harness.costs.k1_cost``), summed, over
the device time of the K1 kernels by name."""
NAMES = ("flash_fwd",)


def read(run):
    t = run.kernel_s(*NAMES)
    b = run.bound_s.get("k1", 0.0)
    return 100.0 * b / t if t > 0 and b > 0 else None

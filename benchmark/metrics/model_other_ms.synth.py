"""Device milliseconds a call of every traced kernel that is not one of
the port's hand-written ones (``readers.CSRC_KERNELS``) and not a copy:
the frontend, the predictors, the plan, the scatter and the postnet."""

from benchmark.readers import other_kernel_seconds


def read(run):
    s = other_kernel_seconds(run)
    if s is None or not run.traced["calls"]:
        return None
    return 1e3 * s / len(run.traced["calls"])

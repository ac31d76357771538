"""The differentiable march's share of its roofline, %: the yardstick's
bound for the traced steps (pair list, forward and backward of every
view) over the device time of ``diffmarch_pairs_kernel``,
``diffmarch_forward_kernel`` and ``diffmarch_backward_kernel``."""

from portbench.roofline import share

KERNELS = ("diffmarch_pairs_kernel", "diffmarch_forward_kernel", "diffmarch_backward_kernel")


def read(ctx):
    if ctx.trace is None or "diffmarch" not in ctx.bounds:
        return None
    return share(ctx.bounds["diffmarch"], ctx.trace.device_seconds(*KERNELS))

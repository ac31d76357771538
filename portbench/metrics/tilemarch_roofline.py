"""The tile-march kernel's share of its roofline, %: the yardstick's bound
for the traced frames (``roofline.bound_s`` of their valid samples and
bytes) over the device time of ``tilemarch_kernel`` in the trace."""

from portbench.roofline import share


def read(ctx):
    if ctx.trace is None or "tilemarch" not in ctx.bounds:
        return None
    return share(ctx.bounds["tilemarch"], ctx.trace.device_seconds("tilemarch_kernel"))

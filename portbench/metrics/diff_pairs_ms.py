"""Device ms a step of the differentiable path's pair-list kernels: every
kernel of the traced steps with ``diffpairs_`` in its name (each view's
pair build, the pair fold forward and backward).  None where the traced
program launches none."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.units:
        return None
    seconds = t.device_seconds("diffpairs_")
    return 1e3 * seconds / t.units if seconds > 0.0 else None

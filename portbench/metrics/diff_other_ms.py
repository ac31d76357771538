"""Device ms a step outside the differentiable march: every kernel and
copy of the traced steps but the march's three kernels (ray set-up, the
fold and its backward, ``numerics.fma``, Adam, the clamp)."""

KERNELS = ("diffmarch_pairs_kernel", "diffmarch_forward_kernel", "diffmarch_backward_kernel")


def read(ctx):
    t = ctx.trace
    if t is None or not t.units or not t.kernels:
        return None
    other = sum(t.kernels.values()) - t.device_seconds(*KERNELS)
    return 1e3 * other / t.units

"""The whole frame's share of the card's float32 peak, %: the operations
of the traced frames' valid samples (``roofline``) over the traced
stretch's length at 67 TFLOP/s."""

from portbench.roofline import peak_percent


def read(ctx):
    t = ctx.trace
    return None if t is None or t.busy_s <= 0.0 else peak_percent(ctx.flops, t.window_s)

"""The share of the traced stretch of a fitting window in which no kernel or
copy ran on the card, %."""


def read(ctx):
    return None if ctx.trace is None else ctx.trace.idle_percent()

"""Frames a second: every frame returned in the window over the window's
whole time, first call's start to last call's end, by the host clock."""


def read(ctx):
    w = ctx.window
    return (w.attempted - w.failed) / w.seconds if w.seconds > 0 else None

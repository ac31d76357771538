"""Optimiser steps a second: every step completed in the window over the
window's whole time, by the host clock."""


def read(ctx):
    w = ctx.window
    return (w.attempted - w.failed) / w.seconds if w.seconds > 0 else None

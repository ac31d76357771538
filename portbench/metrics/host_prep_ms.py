"""Host preparation a frame, ms: ``render_batch``'s own ``host_prep_ms``
counter (visibility order, work lists, bands, table packing) summed over
the window's calls, over the frames they returned."""


def read(ctx):
    frames = ctx.stats.get("frames")
    return ctx.stats["host_prep_ms"] / frames if frames else None

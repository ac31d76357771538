"""Readback a frame, ms: ``render_batch``'s ``readback_ms`` counter (the
wait for each chunk's side-stream copy into pinned memory) summed over
the window's calls, over the frames they returned."""


def read(ctx):
    frames = ctx.stats.get("frames")
    return ctx.stats["readback_ms"] / frames if frames else None

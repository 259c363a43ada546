"""``dispatch_ms``: host ms from entering ``render_frame`` to its return,
mean over the traced window's frames (the render.pipeline layer's host
dispatch)."""

import statistics


def read(run):
    return statistics.fmean(f["dispatch_ms"] for f in run.frames)

"""``trace_ms``: the sum of a frame's ``integrate.trace_rays`` spans (CUDA
events), mean over the traced window's frames: the ray march."""

import statistics


def read(run):
    return statistics.fmean(sum(f["trace_ms"]) for f in run.frames)

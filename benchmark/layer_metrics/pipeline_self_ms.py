"""``pipeline_self_ms``: device ms of a frame's span (CUDA events from its
dispatch to its last operation) less its ``integrate.trace_rays`` spans,
mean over the traced window's frames: render.pipeline's own share of the
frame on the device."""

import statistics


def read(run):
    return statistics.fmean(f["frame_ms"] - sum(f["trace_ms"])
                            for f in run.frames)

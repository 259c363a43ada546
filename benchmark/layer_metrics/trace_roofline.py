"""``trace_roofline``: the ray-march kernel's share of its roofline, in %:
the bound of a frame's launches (``benchmark/roofline.py``: the steps the
reference's march committed, the operations of a step of the launched
instance, the bytes of the rays) over the kernel's device time a frame,
from the profiler by kernel name, or from the ``trace_rays`` spans where
the profile shows no such kernel."""

import statistics

from benchmark import roofline


def read(run):
    ops = roofline.OPS_BY_INSTANCE.get(run.instance)
    if ops is None or not run.launches:
        return None
    seconds = None
    if run.profile is not None:
        seconds = run.profile.kernel_s_per_frame("raymarch_kernel")
    if seconds is None:
        seconds = statistics.fmean(sum(f["trace_ms"])
                                   for f in run.frames) / 1e3
    if not seconds > 0:
        return None
    return 100.0 * roofline.bound_s(run.launches, ops)[0] / seconds

"""The flagship frame configuration: 1920x1080 Kerr in Boyer-Lindquist
coordinates (port of ``geodesic_raytracing_tpu.bench_config``).

The reference's TPU trace tuning (tile size, queue depth, check interval,
step CSE) has no counterpart here: the CUDA kernel takes one thread per ray.
"""

from __future__ import annotations

import math

# Demand-matched EWA probe schedule of the reference's flagship frame: the
# top 11% of pixels by probe demand get 7 probe iterations (odd counts: an
# even count samples only one half of the major axis).
PRODUCTION_PROBE_SEGMENTS = ((0.11, 7),)
# The refine shade set (traced-only shading) concentrates at terminator
# edges, where probe demand is several times the image-wide rate: its top 38%
# get 7 probe iterations and the next 11% get 3.
PRODUCTION_REFINE_SEGMENTS = ((0.38, 7), (0.11, 3))


def flagship_config(width: int = 1920, height: int = 1080, *, device):
    """``(metric, params, camera, settings, features)`` for the 1080p Kerr
    frame: the adaptive frame with traced-only shading, as the reference's
    benchmark renders it.  The settings equal the reference's field for
    field, except for the fields the port does not have: ``planar`` (it has
    no effect on ``kerr_boyer``), the redshift switches (all off there) and
    the TPU trace tuning."""
    from . import metrics
    from .camera import Camera
    from .ops.integrate import Features, TraceOptions
    from .render.pipeline import RenderSettings

    metric = metrics.get_metric("kerr_boyer")
    params = metric.params()
    camera = Camera.default(device=device).rotate(pitch=-math.pi / 2)
    settings = RenderSettings(
        width=width,
        height=height,
        anisotropy=8,
        probe_segments=PRODUCTION_PROBE_SEGMENTS,
        refine_probe_segments=PRODUCTION_REFINE_SEGMENTS,
        trilinear=False,
        adaptive_sampling=True,  # reference default (main.cpp:1152)
        trace=TraceOptions(max_steps=16384),
    )
    return metric, params, camera, settings, Features.for_metric(metric)

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


def flagship_config(width: int = 1920, height: int = 1080, *, device):
    """``(metric, params, camera, settings, features)`` for the 1080p Kerr
    frame.  ``settings.adaptive_sampling`` keeps the reference's True: the
    adaptive pipeline is not ported yet, so callers of this slice pass
    ``dataclasses.replace(settings, adaptive_sampling=False)``."""
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
        trilinear=False,
        adaptive_sampling=True,  # reference default (main.cpp:1152)
        trace=TraceOptions(max_steps=16384),
    )
    return metric, params, camera, settings, Features.for_metric(metric)

"""Carry state from the JAX reference's objects into the port's, as numpy.

Used to hand a scene set up on the reference side (metric parameters, a
camera, a sky atlas, render settings, a ray state with its planar
quaternions) to the port unchanged.  The objects are read through
``numpy.asarray``; nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .camera import Camera
from .ops.integrate import RayState, TraceOptions
from .render.background import Background
from .render.pipeline import RenderSettings


def params_from_jax(params) -> dict:
    """The reference's ``{name: jnp.float32}`` -> ``{name: float32 value}``
    (Python floats, as ``Metric.params`` returns them)."""
    return {k: float(np.asarray(v, dtype=np.float32)) for k, v in
            params.items()}


def _f32(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(device)


def camera_from_jax(camera, *, device) -> Camera:
    """The reference's ``Camera`` -> the port's (the geodesic-camera
    ``frame_override`` is not ported yet and must be None)."""
    if getattr(camera, "frame_override", None) is not None:
        raise NotImplementedError("geodesic-camera frames are not ported yet")
    return Camera(polar_position=_f32(camera.polar_position, device),
                  quat=_f32(camera.quat, device),
                  basis_speed=_f32(camera.basis_speed, device))


def background_from_jax(bgr, *, device) -> Background:
    """The reference's ``Background`` (uint32 rgb10 words) -> the port's
    (int32 words with the same bits)."""
    packed = np.array(bgr.packed, dtype=np.uint32)  # a writable copy
    quad = np.array(bgr.quad, dtype=np.uint32)
    return Background(
        packed=torch.from_numpy(packed.view(np.int32)).to(device),
        quad=torch.from_numpy(quad.view(np.int32)).to(device),
        level_w=tuple(int(v) for v in bgr.level_w),
        level_h=tuple(int(v) for v in bgr.level_h),
        level_x=tuple(int(v) for v in bgr.level_x),
    )


def settings_from_jax(settings) -> RenderSettings:
    """The reference's ``RenderSettings`` -> the port's: every field the
    port has, by name (the redshift switches and ``planar`` included); the
    reference's trace tuning for its own kernel has no counterpart and is
    dropped, as is ``trace.planar``, which the pipeline sets itself."""
    import dataclasses

    t = settings.trace
    trace = TraceOptions(max_steps=int(t.max_steps),
                         reparameterisation=bool(t.reparameterisation),
                         integrator=str(t.integrator))
    names = {f.name for f in dataclasses.fields(RenderSettings)} - {"trace"}
    return RenderSettings(trace=trace,
                          **{n: getattr(settings, n) for n in names})


def ray_state_from_jax(state, inv_quat=None, *, device):
    """The reference's ``RayState`` -> the port's, with the planar rays'
    inverse quaternions (4, N) beside it (None unless the rays were rotated
    into the equator).  Returns ``(state, inv_quat)``."""
    def conv(x, dtype):
        return torch.from_numpy(np.array(x, dtype=dtype)).to(device)

    out = RayState(*(conv(getattr(state, n), np.int32 if n in
                          ("status", "steps") else np.float32)
                     for n in RayState._fields))
    return out, None if inv_quat is None else conv(inv_quat, np.float32)

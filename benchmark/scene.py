"""The inputs of a run, made from ``--seed``, and the program's scene.

A configuration file fixes the metric, its parameters, the camera and the
render settings; a traffic mix fixes the frame size, the sampling mode and
what the seed varies (``seed_varies``: ``"sky"``, the sky texture made on
the device, and ``"azimuth"``, the camera's turn about the spin axis).  Both
of the benchmark's metrics are axisymmetric, so the azimuth moves the sky
and not the shape of the image: every seed asks for about the same work.
The program and the reference are handed the same raw inputs; each builds
its own atlas, camera and launch states from them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class Inputs(NamedTuple):
    sky: torch.Tensor  # (height, width, 3) float32 linear RGB, on the device
    azimuth: float  # radians


def _seed(seed: int, varies: bool) -> int:
    return seed if varies else 0


def inputs(config: dict, mix: dict, seed: int, device) -> Inputs:
    """The seed's sky and azimuth.  The sky is a latitude-longitude grid of
    cells of random colour, each texel scaled by a random grain, made in
    two calls of a generator on the device."""
    varies = set(mix["seed_varies"])
    unknown = varies - {"sky", "azimuth"}
    if unknown:
        raise ValueError(f"the generator cannot vary {sorted(unknown)}")
    s = config["sky"]
    gen = torch.Generator(device=device)
    gen.manual_seed(_seed(seed, "sky" in varies))
    cells_x, cells_y = s["cells"]
    colour = 0.1 + 0.8 * torch.rand((cells_y, cells_x, 3), generator=gen,
                                    device=device)
    grain = 1.0 - s["grain"] * torch.rand((s["height"], s["width"], 3),
                                          generator=gen, device=device)
    iy = torch.arange(s["height"], device=device) * cells_y // s["height"]
    ix = torch.arange(s["width"], device=device) * cells_x // s["width"]
    colour = colour[iy][:, ix]
    host = torch.Generator().manual_seed(_seed(seed, "azimuth" in varies))
    turn = float(torch.rand((), generator=host, dtype=torch.float64))
    return Inputs(sky=(colour * grain).contiguous(),
                  azimuth=2 * math.pi * turn if "azimuth" in varies else 0.0)


def tuples(value):
    """JSON lists as the tuples the settings hold."""
    if isinstance(value, list):
        return tuple(tuples(v) for v in value)
    return value


class Scene(NamedTuple):
    metric: object
    params: dict
    camera: object
    backgrounds: object
    settings: object
    controller: object  # a RefineBudgetController for an adaptive stream

    def render(self, device):
        """A frame of the stream: ``render_frame`` as a frame loop calls it,
        with the same objects every frame."""
        from geodesic_raytracing_tpu_torch.render import pipeline

        return pipeline.render_frame(self.metric, self.camera, self.params,
                                     self.backgrounds, self.settings,
                                     controller=self.controller,
                                     device=device)


def program(config: dict, mix: dict, inp: Inputs, device) -> Scene:
    """The program's objects for the stream, built through its own API:
    the same objects are handed to every frame."""
    from geodesic_raytracing_tpu_torch import camera as cam
    from geodesic_raytracing_tpu_torch import metrics
    from geodesic_raytracing_tpu_torch.ops.integrate import TraceOptions
    from geodesic_raytracing_tpu_torch.render import background as bg
    from geodesic_raytracing_tpu_torch.render.pipeline import (
        RefineBudgetController, RenderSettings)

    metric = metrics.get_metric(config["metric"])
    params = metric.params(**config["params"])
    c = config["camera"]
    f32 = dict(dtype=torch.float32, device=device)
    camera = cam.Camera(
        polar_position=torch.tensor(
            [0.0, c["r"], c["theta"], c["phi"] + inp.azimuth], **f32),
        quat=cam.quat_identity(device=device),
        basis_speed=torch.zeros(3, device=device)).rotate(pitch=c["pitch"])
    turn = cam.axis_angle_quat(torch.tensor([0.0, 0.0, 1.0], **f32),
                               torch.tensor(float(inp.azimuth), **f32))
    camera = camera._replace(quat=cam.quat_multiply(turn, camera.quat))
    settings = RenderSettings(
        width=mix["width"], height=mix["height"],
        adaptive_sampling=mix["adaptive_sampling"],
        trace=TraceOptions(**config["trace"]),
        **{k: tuples(v) for k, v in config["render"].items()})
    backgrounds = bg.build_background(inp.sky.cpu().numpy(), device=device)
    controller = (RefineBudgetController() if mix["adaptive_sampling"]
                  else None)
    return Scene(metric, params, camera, backgrounds, settings, controller)


def reference(config: dict, mix: dict, inp: Inputs, device):
    """``(metric, params, settings, backgrounds, polar position, quaternion,
    basis speed)`` of the plain reference for the same inputs."""
    from benchmark.reference import camera as rcam
    from benchmark.reference import frame as rframe
    from benchmark.reference import sky as rsky
    from benchmark.reference import spacetime

    metric = spacetime.load(config["metric"])
    params = metric.params(config["params"])
    trace = dict(config["trace"])
    settings = rframe.Settings(
        width=mix["width"], height=mix["height"],
        adaptive_sampling=mix["adaptive_sampling"],
        max_steps=trace.pop("max_steps"),
        **trace, **{k: tuples(v) for k, v in config["render"].items()})
    backgrounds = rsky.build_background(inp.sky.cpu().numpy(), device=device)
    c = config["camera"]
    camera = rcam.scene_camera(c["r"], c["theta"], c["phi"], c["pitch"],
                               inp.azimuth, device)
    return metric, params, settings, backgrounds, camera

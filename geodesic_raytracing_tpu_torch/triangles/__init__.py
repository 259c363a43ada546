"""GR triangle rendering (port of ``geodesic_raytracing_tpu.triangles``):
objects on their own timelike geodesics, swept along them, hit by recorded
camera rays."""

from .scene import (
    Object3,
    TriangleScene,
    make_cube,
    object_from_obj,
    subtriangulate,
)
from .physics import ObjectGeodesic, precompute_object, precompute_objects
from .render import (
    build_swept_triangles,
    intersect_scene,
    intersect_scene_binned,
    render_triangles,
)

__all__ = [
    "Object3",
    "TriangleScene",
    "make_cube",
    "object_from_obj",
    "subtriangulate",
    "ObjectGeodesic",
    "precompute_object",
    "precompute_objects",
    "build_swept_triangles",
    "intersect_scene",
    "intersect_scene_binned",
    "render_triangles",
]

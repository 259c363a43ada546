"""Objects and triangle scenes (port of
``geodesic_raytracing_tpu.triangles.scene``).

Host-side numpy, as in the reference: objects with a 4-position, a
3-velocity, a scale and a triangle list; .obj loading; flattening into linear
per-triangle buffers with a ``parent`` object index
(triangle_manager.cpp:206-248); the cube factory (main.cpp:525-631); and the
recursive subtriangulation helper (triangle_manager.cpp:13-44).  The arrays
equal the reference's; the renderer moves them to its device.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Object3:
    """A renderable object (triangle.hpp:8-131)."""

    position: np.ndarray  # (4,) (t, x, y, z): time and world cartesian xyz
    velocity: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, dtype=np.float32)
    )  # tetrad-frame 3-velocity
    scale: float = 1.0
    vertices: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 3), dtype=np.float32)
    )  # (V, 3) local-frame vertices
    triangles: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 3), dtype=np.int32)
    )  # (T, 3) vertex indices


def make_cube(position, velocity=(0.0, 0.0, 0.0), scale=1.0) -> Object3:
    """The reference's cube factory (main.cpp:525-631): 12 triangles."""
    v = np.array(
        [
            [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
            [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
        ],
        dtype=np.float32,
    ) - 0.5
    f = np.array(
        [
            [0, 1, 2], [0, 2, 3],  # -z
            [4, 6, 5], [4, 7, 6],  # +z
            [0, 4, 5], [0, 5, 1],  # -y
            [3, 2, 6], [3, 6, 7],  # +y
            [0, 3, 7], [0, 7, 4],  # -x
            [1, 5, 6], [1, 6, 2],  # +x
        ],
        dtype=np.int32,
    )
    return Object3(
        position=np.asarray(position, dtype=np.float32),
        velocity=np.asarray(velocity, dtype=np.float32),
        scale=float(scale),
        vertices=v,
        triangles=f,
    )


def object_from_obj(path: str, position, velocity=(0.0, 0.0, 0.0),
                    scale=1.0, normalise: bool = True) -> Object3:
    """Load an .obj mesh as an object (``load_tris_from_model``
    triangle_manager.cpp:110-193).  ``normalise`` centres the mesh and
    scales it to unit extent."""
    from .. import runtime

    verts, tris = runtime.load_obj(path)
    if normalise and len(verts):
        centre = 0.5 * (verts.max(0) + verts.min(0))
        extent = max(float((verts.max(0) - verts.min(0)).max()), 1e-9)
        verts = (verts - centre) / extent
    return Object3(
        position=np.asarray(position, dtype=np.float32),
        velocity=np.asarray(velocity, dtype=np.float32),
        scale=float(scale),
        vertices=verts,
        triangles=tris,
    )


def subtriangulate(vertices: np.ndarray, triangles: np.ndarray,
                   max_edge: float) -> tuple[np.ndarray, np.ndarray]:
    """Recursively split triangles into four until every edge is at most
    ``max_edge`` (or 8 levels deep) (triangle_manager.cpp:13-44)."""
    verts = [v for v in np.asarray(vertices, dtype=np.float32)]
    out = []

    def midpoint(a, b):
        verts.append(0.5 * (verts[a] + verts[b]))
        return len(verts) - 1

    def split(tri, depth=0):
        a, b, c = tri
        va, vb, vc = verts[a], verts[b], verts[c]
        edges = [
            float(np.linalg.norm(vb - va)),
            float(np.linalg.norm(vc - vb)),
            float(np.linalg.norm(va - vc)),
        ]
        if max(edges) <= max_edge or depth >= 8:
            out.append([a, b, c])
            return
        ab = midpoint(a, b)
        bc = midpoint(b, c)
        ca = midpoint(c, a)
        for sub in ([a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]):
            split(sub, depth + 1)

    for tri in np.asarray(triangles, dtype=np.int32):
        split(list(tri))
    return (np.asarray(verts, dtype=np.float32),
            np.asarray(out, dtype=np.int32))


@dataclasses.dataclass
class TriangleScene:
    """Flattened scene: linear triangle buffers + parent object indices
    (``manager::build`` triangle_manager.cpp:206-248)."""

    v0: np.ndarray  # (T, 3) local-frame, scaled
    v1: np.ndarray
    v2: np.ndarray
    parent: np.ndarray  # (T,) object index
    objects: list

    @classmethod
    def build(cls, objects: list[Object3]) -> "TriangleScene":
        v0s, v1s, v2s, parents = [], [], [], []
        for i, obj in enumerate(objects):
            if len(obj.triangles) == 0:
                continue
            tris = obj.vertices[obj.triangles] * obj.scale  # (T, 3, 3)
            v0s.append(tris[:, 0])
            v1s.append(tris[:, 1])
            v2s.append(tris[:, 2])
            parents.append(np.full(len(tris), i, dtype=np.int32))
        if not v0s:
            z = np.zeros((0, 3), dtype=np.float32)
            return cls(z, z, z, np.zeros(0, dtype=np.int32), list(objects))
        return cls(
            v0=np.concatenate(v0s).astype(np.float32),
            v1=np.concatenate(v1s).astype(np.float32),
            v2=np.concatenate(v2s).astype(np.float32),
            parent=np.concatenate(parents),
            objects=list(objects),
        )

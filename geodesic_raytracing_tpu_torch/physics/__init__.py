from .geodesics import (
    CAMERA_PATH_STEPS,
    OBJECT_PATH_STEPS,
    GeodesicPath,
    interpolate_camera,
    parallel_transport_quantity,
    parallel_transport_tetrads,
    record_geodesic,
    record_geodesics,
    tetrad_inverses_along_path,
)

__all__ = [
    "CAMERA_PATH_STEPS",
    "OBJECT_PATH_STEPS",
    "GeodesicPath",
    "interpolate_camera",
    "parallel_transport_quantity",
    "parallel_transport_tetrads",
    "record_geodesic",
    "record_geodesics",
    "tetrad_inverses_along_path",
]

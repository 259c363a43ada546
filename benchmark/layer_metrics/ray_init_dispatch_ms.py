"""``ray_init_dispatch_ms``: host ms of the program's ``ray_init`` span,
``init_camera_rays`` (``camera_frame`` and ``rays_for_pixels``) of the dense
frame, median over the recorder's frames."""

from benchmark import program_spans


def read(run):
    return program_spans.stage_ms("ray_init")

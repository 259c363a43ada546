"""``camera_dispatch_ms``: host ms of the program's ``camera`` span
(``camera_frame`` inside the dense frame's ``ray_init``: the camera's
position and its observer tetrad at one point), median over the recorder's
frames.  None where the program has no such span."""

from benchmark import program_spans


def read(run):
    return program_spans.stage_ms("camera")

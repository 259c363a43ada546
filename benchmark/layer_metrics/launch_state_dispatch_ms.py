"""``launch_state_dispatch_ms``: host ms of the program's ``launch_state``
span (``rays_for_pixels`` inside the dense frame's ``ray_init``), median
over the recorder's frames.  None where the program has no such span."""

from benchmark import program_spans


def read(run):
    return program_spans.stage_ms("launch_state")

"""``launch_state_ms``: device ms between the CUDA events of the program's
``launch_state`` span (``rays_for_pixels`` inside the dense frame's
``ray_init``: the pixel directions, the null fix and the launch acceleration
of every ray, its idle time on the card included), median over the
recorder's frames.  None where the program has no such span."""

from benchmark import program_spans


def read(run):
    return program_spans.stage_ms("launch_state", device=True)

"""``ray_init_ms``: device ms between the CUDA events of the program's
``ray_init`` span (the dense frame's stage, its idle time on the card
included), median over the recorder's frames."""

from benchmark import program_spans


def read(run):
    return program_spans.stage_ms("ray_init", device=True)

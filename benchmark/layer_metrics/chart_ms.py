"""``chart_ms``: device ms between the CUDA events of the program's
``chart`` span (the eager ``to_polar`` and ``to_polar_velocity`` of every
endpoint inside ``render_data``, opened only where the metric's chart is
not the identity; its idle time on the card included), median over the
recorder's frames.  None where the program has no such span."""

from benchmark import program_spans


def read(run):
    return program_spans.stage_ms("chart", device=True)

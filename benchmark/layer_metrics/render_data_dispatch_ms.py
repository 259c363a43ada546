"""``render_data_dispatch_ms``: host ms of the program's ``render_data``
span, ``compute_render_data`` of the dense frame, median over the recorder's
frames."""

from benchmark import program_spans


def read(run):
    return program_spans.stage_ms("render_data")

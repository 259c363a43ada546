"""``shade_dispatch_ms``: host ms of the program's ``shade`` span, ``shade``
of the dense frame, median over the recorder's frames."""

from benchmark import program_spans


def read(run):
    return program_spans.stage_ms("shade")

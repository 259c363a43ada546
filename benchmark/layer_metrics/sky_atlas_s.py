"""``sky_atlas_s``: host seconds of the program's ``setup.sky_atlas`` span
(``render.background.build_background``), a part of ``setup_s``."""

from benchmark import program_spans


def read(run):
    return program_spans.setup_s("setup.sky_atlas")

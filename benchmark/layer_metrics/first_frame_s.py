"""``first_frame_s``: host seconds of the stream's first ``frame`` span in
the program's recorder: the first frame's library load and first-call
costs, a part of ``setup_s``."""

from benchmark import program_spans


def read(run):
    return program_spans.first_frame_s()

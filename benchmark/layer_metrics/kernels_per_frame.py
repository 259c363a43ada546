"""``kernels_per_frame``: device kernels launched in the profiled frames
over their number (what the host's dispatch of a frame costs)."""


def read(run):
    if run.profile is None or not run.profile.kernels:
        return None
    return len(run.profile.kernels) / run.profile.frames

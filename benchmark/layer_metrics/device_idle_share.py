"""``device_idle_share``: 1 - (union of device activity) / (the profiled
stretch), from the profiler's trace."""


def read(run):
    if run.profile is None or not run.profile.busy_s > 0:
        return None
    return 1.0 - run.profile.busy_s / run.profile.window_s

"""The end-to-end numbers of a window of frames, on the host clock."""

from __future__ import annotations

import statistics


def window(done: list, start: float, deadline: float) -> list:
    """The frames the loop saw complete inside ``[start, deadline]``."""
    return [d for d in done if start <= d.seen <= deadline]


def mrays_per_s(frames: list, pixels: int, start: float) -> float:
    """Pixels of every frame completed in the window over the window's
    seconds, from its start to the last completion in it, / 1e6."""
    if not frames:
        raise RuntimeError("no frame completed inside the window")
    end = max(d.seen for d in frames)
    return len(frames) * pixels / (end - start) / 1e6


def p90(values: list) -> float:
    """The 90th percentile of all ``values`` (inclusive quantiles)."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=10, method="inclusive")[8]


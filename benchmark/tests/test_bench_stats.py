"""The end-to-end numbers: a rate over the whole window and the 90th
percentile over every frame in it."""

import statistics

import pytest

from benchmark import stats
from benchmark.loop import Done


def frames(latencies, start=100.0, period=0.25):
    return [Done(i + 1, start + i * period, start + i * period + lat)
            for i, lat in enumerate(latencies)]


def test_window_keeps_the_frames_seen_inside_it():
    done = frames([0.5] * 10)  # seen at 100.5, 100.75, ..., 102.75
    inside = stats.window(done, 100.0, 102.0)
    assert [d.index for d in inside] == [1, 2, 3, 4, 5, 6, 7]


def test_rate_is_all_pixels_over_the_window_to_the_last_completion():
    done = frames([0.5] * 8)
    rate = stats.mrays_per_s(done, 1_000_000, start=100.0)
    # 8 frames of a million pixels from 100.0 to the last seen, 102.25
    assert rate == pytest.approx(8 / 2.25)


def test_rate_needs_a_frame():
    with pytest.raises(RuntimeError):
        stats.mrays_per_s([], 1, start=0.0)


def test_p90_is_of_every_frame_not_of_chunk_medians():
    # Each chunk of ten frames has two slow ones: every chunk's median is
    # fast, while a tenth of all frames and more are slow.
    lat = ([0.1] * 8 + [1.0] * 2) * 10
    chunk_medians = [statistics.median(lat[i:i + 10])
                     for i in range(0, 100, 10)]
    assert max(chunk_medians) == pytest.approx(0.1)
    assert stats.p90(lat) == pytest.approx(1.0)
    assert stats.p90(list(range(1, 101))) == pytest.approx(90.1)


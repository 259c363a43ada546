"""The frame loop: a closed loop with a fixed number of frames in flight, as a
frame-loop application drives the renderer (the reference renderer's
double-buffered render state and asynchronous read queue).

Each frame's image is copied into pinned host memory without blocking, and
an event is recorded after the copy.  Before the loop dispatches frame
t + in_flight - 1 it waits for frame t - 1's event.  A frame's latency runs
on the host clock from the moment the loop starts dispatching it to the
moment the loop sees its copy complete.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, NamedTuple

import torch


class Done(NamedTuple):
    index: int  # 1 = the stream's first frame
    dispatched: float  # host clock, s
    seen: float  # host clock, s

    @property
    def latency_s(self) -> float:
        return self.seen - self.dispatched


class FrameStream:
    """Frames of ``render()`` (an (H, W, 3) float32 image each) with
    ``in_flight`` of them in flight at most."""

    def __init__(self, render: Callable, shape: tuple, in_flight: int,
                 device):
        self.render = render
        self.in_flight = in_flight
        self.cuda = torch.device(device).type == "cuda"
        self.buffers = [torch.empty(shape, dtype=torch.float32,
                                    pin_memory=self.cuda)
                        for _ in range(in_flight)]
        self.pending: collections.deque = collections.deque()
        self.done: list[Done] = []
        self.count = 0

    def step(self) -> None:
        """Dispatch the next frame, once fewer than ``in_flight`` are in
        flight."""
        while len(self.pending) >= self.in_flight:
            self._retire()
        t0 = time.perf_counter()
        image = self.render()
        self.buffers[self.count % self.in_flight].copy_(image,
                                                        non_blocking=True)
        event = None
        if self.cuda:
            event = torch.cuda.Event()
            event.record()
        self.count += 1
        self.pending.append((self.count, t0, event))

    def _retire(self) -> None:
        index, t0, event = self.pending.popleft()
        if event is not None:
            event.synchronize()
        self.done.append(Done(index, t0, time.perf_counter()))

    def drain(self) -> None:
        while self.pending:
            self._retire()

    def last_image(self) -> torch.Tensor:
        """The image of the last frame dispatched (after ``drain``)."""
        return self.buffers[(self.count - 1) % self.in_flight].clone()

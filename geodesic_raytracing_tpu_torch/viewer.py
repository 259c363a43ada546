"""Interactive terminal viewer (port of ``geodesic_raytracing_tpu.viewer``),
the frame-loop application's counterpart.

The reference is a GL window with an ImGui interface (main.cpp's frame loop,
fullscreen_window_manager, input_manager).  The port is headless, so the
interactive surface is the terminal: frames render as 24-bit ANSI half-block
art, keys follow the reference's bindings (input_manager.cpp:11-38, through
``settings.DEFAULT_KEYBINDS``), and the status line carries the reference's
readouts (camera position, frame time, main.cpp:1836-1846).  Frames render
with ``render_frame`` on ``--device`` (the CUDA kernel on the card).

Usage:
    python -m geodesic_raytracing_tpu_torch.viewer --metric schwarzschild \\
        --device cuda
    # w/a/s/d/q/e move, i/j/k/l turn, u/o roll, r/f camera time,
    # [ ] speed, p screenshot, x quit

Scripted mode (tests, and the smoke on the card): ``--script "ssji" --frames
4`` renders one frame per scripted key without a TTY.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def frame_to_ansi(rgb8: np.ndarray) -> str:
    """(H, W, 3) uint8 -> half-block ANSI art (two pixel rows per text
    row)."""
    h, w, _ = rgb8.shape
    if h % 2:
        rgb8 = rgb8[:-1]
        h -= 1
    top, bot = rgb8[0::2], rgb8[1::2]
    lines = []
    for y in range(h // 2):
        parts, prev = [], None
        for x in range(w):
            tr, tg, tb = top[y, x]
            br, bg_, bb = bot[y, x]
            code = (tr, tg, tb, br, bg_, bb)
            if code != prev:
                parts.append(f"\x1b[38;2;{tr};{tg};{tb}m"
                             f"\x1b[48;2;{br};{bg_};{bb}m")
                prev = code
            parts.append("\u2580")
        parts.append("\x1b[0m")
        lines.append("".join(parts))
    return "\n".join(lines)


class KeyInput:
    """Non-blocking single-key reads (raw_input.cpp's counterpart)."""

    def __init__(self, script: str | None = None):
        self.script = list(script) if script is not None else None
        self._old = None
        if self.script is None and sys.stdin.isatty():
            import termios
            import tty

            self._fd = sys.stdin.fileno()
            self._old = termios.tcgetattr(self._fd)
            tty.setcbreak(self._fd)

    def poll(self) -> str | None:
        if self.script is not None:
            return self.script.pop(0) if self.script else None
        import select

        r, _, _ = select.select([sys.stdin], [], [], 0)
        return sys.stdin.read(1) if r else None

    def close(self):
        if self._old is not None:
            import termios

            termios.tcsetattr(self._fd, termios.TCSADRAIN, self._old)


MOVE = {"w": (0, 0, 1), "s": (0, 0, -1), "a": (-1, 0, 0), "d": (1, 0, 0),
        "q": (0, -1, 0), "e": (0, 1, 0)}
TURN = {"i": ("pitch", -1), "k": ("pitch", 1), "j": ("yaw", -1),
        "l": ("yaw", 1), "u": ("roll", -1), "o": ("roll", 1)}
TURN_SPEED = 0.15


def apply_key(camera, key: str | None, speed: float):
    """The viewer's response to one key: ``(camera, speed)`` after it
    (the JAX viewer's frame loop, key for key)."""
    import torch

    if key in MOVE:
        camera = camera.translate(
            torch.tensor(MOVE[key], dtype=torch.float32,
                         device=camera.quat.device), speed)
    elif key in TURN:
        axis, sgn = TURN[key]
        camera = camera.rotate(**{axis: sgn * TURN_SPEED})
    elif key in ("r", "f"):
        dt = speed if key == "r" else -speed
        camera = camera._replace(polar_position=torch.cat(
            [camera.polar_position[:1] + dt, camera.polar_position[1:]]))
    elif key == "[":
        speed /= 2
    elif key == "]":
        speed *= 2
    return camera, speed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--metric", default="schwarzschild")
    ap.add_argument("--width", type=int, default=160)
    ap.add_argument("--height", type=int, default=90)
    ap.add_argument("--fov", type=float, default=90.0)
    ap.add_argument("--max-steps", type=int, default=2048)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda marches with the CUDA kernel; cpu with its "
                         "eager reference")
    ap.add_argument("--frames", type=int, default=None,
                    help="exit after N frames (default: run until 'x')")
    ap.add_argument("--script", default=None,
                    help="scripted keys, one per frame (no TTY needed)")
    ap.add_argument("--no-display", action="store_true",
                    help="skip the ANSI output (timing and CI runs)")
    args = ap.parse_args(argv)

    import math

    from . import metrics, runtime
    from .camera import Camera
    from .ops.integrate import Features, TraceOptions
    from .render import background as bg
    from .render import colour
    from .render.pipeline import RenderSettings, check_device, render_frame
    from .utils.profiling import FrameTimer

    device = check_device(args.device)
    metric = metrics.get_metric(args.metric)
    params = metric.params()
    features = Features.for_metric(metric)
    settings = RenderSettings(width=args.width, height=args.height,
                              fov_degrees=args.fov, anisotropy=2,
                              trilinear=False,
                              trace=TraceOptions(max_steps=args.max_steps))
    backgrounds = bg.checker_background(512, 1024, device=device)
    camera = Camera.default(device=device).rotate(pitch=-math.pi / 2)

    speed = 0.5
    writer = runtime.AsyncFrameWriter(threads=1)
    keys = KeyInput(args.script)
    timer = FrameTimer(device=device)
    shots = frame_no = 0
    try:
        while args.frames is None or frame_no < args.frames:
            k = keys.poll()
            if k in ("x", "\x1b"):
                break
            camera, speed = apply_key(camera, k, speed)
            timer.start()
            img = render_frame(metric, camera, params, backgrounds, settings,
                               features, device=device)
            srgb = colour.lin_to_srgb(img).cpu().numpy()
            ms = timer.stop()
            rgb8 = (np.clip(srgb, 0, 1) * 255).astype(np.uint8)
            if k == "p":
                shots += 1
                writer.submit(f"screenshot_{shots:03}.png", rgb8)
            if not args.no_display:
                pos = np.round(camera.polar_position.cpu().numpy(), 2)
                sys.stdout.write("\x1b[H\x1b[2J")
                sys.stdout.write(frame_to_ansi(rgb8))
                sys.stdout.write(
                    f"\n{metric.name}  pos(t,r,th,ph)={pos.tolist()}  "
                    f"{ms:.0f} ms  speed={speed:g}  "
                    "[wasdqe move, ijkl/uo look, rf time, p shot, x quit]\n")
                sys.stdout.flush()
            frame_no += 1
    finally:
        keys.close()
        writer.close()

    print(f"\nviewer: {frame_no} frames, median {timer.median_ms:.0f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())

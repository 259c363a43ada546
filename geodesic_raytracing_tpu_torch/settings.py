"""Persistent application settings (port of ``geodesic_raytracing_tpu.settings``).

The reference's JSON-serialised settings: ``graphics_settings``
(graphics_settings.hpp:8-47, the video and control tiers), ``input.json``'s
key bindings (input_manager.cpp:45-61) and ``backgrounds.json``
(graphics_settings.cpp:245-254), as dataclasses and json.  The schema is the
JAX package's field for field, so a settings file written by either package
loads in the other.

Writes are atomic (a temporary file, then a rename), as the reference's
atomic_write (main.cpp:1479-1482); a load falls back to the defaults on any
error (main.cpp:250-253).
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from pathlib import Path


def _atomic_write(path: Path, text: str) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=str(path.parent), suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


@dataclasses.dataclass
class VideoSettings:
    """graphics_settings.hpp:8-30 (video tier)."""

    width: int = 1280
    height: int = 720
    fullscreen: bool = False
    supersample: bool = False
    supersample_factor: int = 2
    screenshot_width: int = 1920
    screenshot_height: int = 1080
    vsync_enabled: bool = False
    anisotropy: int = 16
    workgroup_size: tuple = (8, 8)


@dataclasses.dataclass
class ControlSettings:
    """graphics_settings.hpp:31-47 (control tier)."""

    mouse_sensitivity: float = 1.0
    keyboard_sensitivity: float = 1.0
    invert_mouse: bool = False
    camera_speed: float = 1.0
    fov: float = 90.0
    no_gpu_reads: bool = False
    use_old_redshift: bool = False
    adaptive_sampling_threshold: float = 64.0
    field_of_view_degrees: float = 90.0


# The reference's 24 named key bindings (input_manager.cpp:11-38).
DEFAULT_KEYBINDS: dict[str, str] = {
    "forward": "w",
    "back": "s",
    "left": "a",
    "right": "d",
    "up": "q",
    "down": "e",
    "time_forwards": "r",
    "time_backwards": "f",
    "speed_x10": "lshift",
    "speed_x100": "x",
    "speed_d100": "lalt",
    "speed_superslow": "b",
    "camera_turn_left": "j",
    "camera_turn_right": "l",
    "camera_turn_up": "i",
    "camera_turn_down": "k",
    "camera_roll_left": "u",
    "camera_roll_right": "o",
    "toggle_wormhole_space": "1",
    "play_geodesic": "2",
    "pause_geodesic": "3",
    "stop_geodesic": "4",
    "toggle_mouse": "tab",
    "screenshot": "f2",
}


@dataclasses.dataclass
class AppSettings:
    """The full settings bundle persisted to settings.json."""

    video: VideoSettings = dataclasses.field(default_factory=VideoSettings)
    control: ControlSettings = dataclasses.field(
        default_factory=ControlSettings)
    keybinds: dict = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_KEYBINDS))
    background_path: str = ""
    background_path2: str = ""

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    def save(self, path: str | Path) -> None:
        _atomic_write(Path(path), self.to_json())

    @classmethod
    def load(cls, path: str | Path) -> "AppSettings":
        """Load settings; any failure falls back to the defaults
        (main.cpp:250-253)."""
        try:
            data = json.loads(Path(path).read_text())
            video = VideoSettings(**{
                k: tuple(v) if k == "workgroup_size" else v
                for k, v in data.get("video", {}).items()})
            control = ControlSettings(**data.get("control", {}))
            keybinds = dict(DEFAULT_KEYBINDS)
            keybinds.update(data.get("keybinds", {}))
            return cls(video=video, control=control, keybinds=keybinds,
                       background_path=data.get("background_path", ""),
                       background_path2=data.get("background_path2", ""))
        except Exception:
            return cls()

"""Host runtime helpers (port of ``geodesic_raytracing_tpu.runtime``): the
mip-pyramid build, as the reference's numpy path (which mirrors its native
box-filter chain exactly), the OBJ mesh parser, as the reference's Python
parser, and the asynchronous PNG writer.  ``runtime.hotswap`` holds the
metric hot-swap."""

from __future__ import annotations

import concurrent.futures
import sys
import threading

import numpy as np


def build_mips(image: np.ndarray, max_levels: int = 10):
    """(h, w, c) float32 -> (atlas (h, 2w, c), level_w, level_h, level_x):
    a 2x2 box-filter chain, each level placed right of the previous one."""
    image = np.ascontiguousarray(image, dtype=np.float32)
    h, w, c = image.shape
    atlas = np.zeros((h, 2 * w, c), dtype=np.float32)
    lw, lh, lx = [], [], []
    cur, x = image, 0
    for _ in range(max_levels):
        ch, cw, _ = cur.shape
        atlas[:ch, x:x + cw] = cur
        lw.append(cw)
        lh.append(ch)
        lx.append(x)
        x += cw
        nh, nw = (ch + 1) // 2, (cw + 1) // 2
        if (nh, nw) == (ch, cw):
            break
        pad = np.pad(cur, ((0, ch % 2), (0, cw % 2), (0, 0)), mode="edge")
        cur = pad.reshape(nh, 2, nw, 2, c).mean(axis=(1, 3))
    return (atlas, np.asarray(lw, np.int32), np.asarray(lh, np.int32),
            np.asarray(lx, np.int32))


def load_obj(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Parse an OBJ file -> (positions (V, 3) float32, indices (T, 3) int32).
    ``v`` lines give positions; each ``f`` line (1-based or negative
    indices, ``i/t/n`` tokens read as ``i``) is fanned into triangles from
    its first vertex."""
    positions, indices = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                positions.append([float(v) for v in parts[1:4]])
            elif line.startswith("f "):
                face = []
                for tok in line.split()[1:]:
                    i = int(tok.split("/")[0])
                    face.append(i - 1 if i > 0 else len(positions) + i)
                for k in range(2, len(face)):
                    indices.append([face[0], face[k - 1], face[k]])
    return (np.asarray(positions, dtype=np.float32),
            np.asarray(indices, dtype=np.int32))


class AsyncFrameWriter:
    """Fire-and-forget PNG writing on a pool of Python worker threads (the
    reference's nonblocking readback and screenshot pipeline,
    main.cpp:434-523, 2777-2808), through the port's ``cli.write_png``.
    ``submit`` copies the frame and returns at once; ``pending`` counts
    the writes not finished, ``failures`` those that raised (each is
    reported on stderr).  The JAX package writes on native threads; the
    port has no native library."""

    def __init__(self, threads: int = 2):
        self._pool = concurrent.futures.ThreadPoolExecutor(threads)
        self._lock = threading.Lock()
        self._pending = 0
        self._failures = 0

    def _write(self, path: str, rgb8: np.ndarray) -> None:
        from ..cli import write_png

        try:
            write_png(path, rgb8)
        except Exception as e:
            with self._lock:
                self._failures += 1
            print(f"[grt_torch] frame write to {path} failed: "
                  f"{type(e).__name__}: {e}", file=sys.stderr, flush=True)
        finally:
            with self._lock:
                self._pending -= 1

    def submit(self, path: str, rgb8: np.ndarray) -> None:
        rgb8 = np.array(rgb8, dtype=np.uint8, copy=True, order="C")
        if rgb8.ndim != 3 or rgb8.shape[2] != 3:
            raise ValueError("AsyncFrameWriter expects (H, W, 3) uint8")
        with self._lock:
            self._pending += 1
        self._pool.submit(self._write, str(path), rgb8)

    @property
    def pending(self) -> int:
        with self._lock:
            return self._pending

    @property
    def failures(self) -> int:
        with self._lock:
            return self._failures

    def close(self) -> None:
        """Wait for every submitted write, then stop the workers."""
        self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

"""Host runtime helpers (port of ``geodesic_raytracing_tpu.runtime``): the
mip-pyramid build, as the reference's numpy path (which mirrors its native
box-filter chain exactly)."""

from __future__ import annotations

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

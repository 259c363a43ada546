"""Whether a frame is correct: the program's image against the plain
reference's image of the same frame of the stream.

Two numbers are compared, each with its limit in ``limits/<cell>.json``:

* ``px_off_share``: the share of pixels whose largest channel differs from
  the reference's by more than ``TOL`` (or is not finite);
* ``worst_tile_off``: the same share in the worst of the image's
  ``TILE`` x ``TILE`` tiles, which catches a fault confined to one region
  that the whole image's share would dilute.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

TOL = 8.0 / 255.0
TILE = 16


def compare(image: torch.Tensor, reference: torch.Tensor) -> dict:
    """``{number: value}`` of the (H, W, 3) ``image`` against
    ``reference``."""
    if image.shape != reference.shape:
        raise ValueError(f"image {tuple(image.shape)} against reference "
                         f"{tuple(reference.shape)}")
    gap = (image.float() - reference.float()).abs().amax(dim=-1)
    off = (~(gap <= TOL)).float()
    tiles = F.avg_pool2d(off[None, None], TILE, ceil_mode=True)
    return {"px_off_share": float(off.mean()),
            "worst_tile_off": float(tiles.max())}


def judge(numbers: dict, limits: dict) -> bool:
    """Every number within its limit."""
    return all(numbers[k] <= limits[k] for k in limits)

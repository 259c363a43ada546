"""Stable grouping by a small integer key (port of
``geodesic_raytracing_tpu.ops.packing``).

The reference partitions with an O(N) counting scan because TPU sorts are
bitonic; on the GPU a stable radix sort is the direct form and gives the
same permutation.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def bucket_sort_perm(bucket: Tensor) -> tuple[Tensor, Tensor]:
    """Stable ascending grouping by ``bucket`` (N,) int.

    Returns ``(perm, dest)``: ``x[perm]`` is grouped by bucket (stable
    within a bucket) and ``x_grouped[dest]`` restores the original order."""
    perm = torch.sort(bucket, stable=True).indices
    dest = torch.empty_like(perm)
    dest[perm] = torch.arange(perm.numel(), device=perm.device,
                              dtype=perm.dtype)
    return perm, dest

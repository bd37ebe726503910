"""Furthest point sampling (FPS) and sectorized FPS.

Counterpart of ``openseg3d_tpu/ops/sampling.py`` (the reference's sampling
extension; no model calls it). FPS is sequential in the samples: each step
updates every point's distance to the chosen set and picks the furthest,
the first index among equal distances (``argmax``), as the JAX package's
``fori_loop`` does. The loop stays on the device: the host never reads an
index, so the steps queue without a synchronisation.
"""

from __future__ import annotations

import math

import torch

from .scatter import inner_group_ranks

_BIG = 1e10


def batched_furthest_point_sample(points: torch.Tensor, valid: torch.Tensor,
                                  num_samples: int) -> torch.Tensor:
    """points [B, N, 3], valid [B, N] -> int32 [B, num_samples]: the first
    valid point, then each time the point furthest from those chosen. With
    fewer valid points than samples the rest repeat the first valid point
    (every distance left is 0)."""
    b = points.shape[0]
    rows = torch.arange(b, device=points.device)
    last = valid.int().argmax(dim=1)                   # the first valid point
    dist = torch.where(valid, _BIG, -_BIG).float()
    idx = torch.empty((b, num_samples), dtype=torch.int32, device=points.device)
    idx[:, 0] = last
    for i in range(1, num_samples):
        diff = points - points[rows, last][:, None, :]
        d = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1] + diff[..., 2] * diff[..., 2]
        dist = torch.minimum(dist, torch.where(valid, d, -_BIG))
        last = dist.argmax(dim=1)
        idx[:, i] = last
    return idx


def furthest_point_sample(points: torch.Tensor, valid: torch.Tensor,
                          num_samples: int) -> torch.Tensor:
    """points [N, 3], valid [N] -> int32 [num_samples]."""
    return batched_furthest_point_sample(points[None], valid[None], num_samples)[0]


def sectorized_fps(points: torch.Tensor, valid: torch.Tensor, num_samples: int,
                   num_sectors: int, sector_capacity: int | None = None) -> torch.Tensor:
    """FPS within azimuth sectors, ceil(num_samples / num_sectors) each, the
    sectors' picks in sector order, cut to num_samples (``sampling.py:
    52-83``). Each sector holds at most sector_capacity points, in index
    order; the overflow is left out of its FPS. points [N, 3] -> [num_samples]
    indices into points (-1 from a sector with no point)."""
    n = points.shape[0]
    if sector_capacity is None:
        sector_capacity = max(256, (2 * n) // num_sectors)
    per_sector = int(math.ceil(num_samples / num_sectors))
    az = torch.atan2(points[:, 1], points[:, 0])
    sector = ((az + math.pi) / (2 * math.pi) * num_sectors).int().clamp(0, num_sectors - 1)
    sector = torch.where(valid, sector, num_sectors)
    ranks = inner_group_ranks(sector, valid)
    ok = valid & (ranks < sector_capacity)
    size = num_sectors * sector_capacity
    slot = torch.where(ok, sector * sector_capacity + ranks, size).long()
    # the rows left out all land on the trash slot `size`, which is cut off
    gather_idx = torch.full((size + 1,), -1, dtype=torch.int32, device=points.device).scatter_(
        0, slot, torch.arange(n, dtype=torch.int32, device=points.device))
    gather_idx = gather_idx[:size].reshape(num_sectors, sector_capacity)
    sec_valid = gather_idx >= 0
    sec_pts = torch.where(sec_valid[..., None], points[gather_idx.clamp(min=0).long()], 0)
    picks = batched_furthest_point_sample(sec_pts, sec_valid, per_sector)
    return torch.gather(gather_idx, 1, picks.long()).reshape(-1)[:num_samples]

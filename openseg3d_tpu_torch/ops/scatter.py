"""Segment reductions over ragged-with-mask arrays, row gathers, and ranks
within groups.

Counterpart of ``openseg3d_tpu/ops/scatter.py``. Segment id -1 means
"unassigned" and is excluded from every reduction; so is any id
>= num_segments. A torch scatter raises on such ids (or wraps -1), where the
JAX code clamps or drops them, so every reduction routes them to an extra
trash segment that is cut off afterwards.
"""

from __future__ import annotations

import torch


def _clean_ids(ids: torch.Tensor, num_segments: int):
    """Map invalid ids (<0 or >= num_segments) to the trash bucket."""
    invalid = (ids < 0) | (ids >= num_segments)
    return torch.where(invalid, num_segments, ids).long(), ~invalid


def _expand_rows(valid: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    return valid.reshape(valid.shape + (1,) * (data.ndim - 1))


def segment_sum(data: torch.Tensor, ids: torch.Tensor, num_segments: int):
    """Sum of data rows per segment, [num_segments, ...]."""
    ids, valid = _clean_ids(ids, num_segments)
    src = torch.where(_expand_rows(valid, data), data, 0)
    out = data.new_zeros((num_segments + 1,) + tuple(data.shape[1:]))
    out.index_add_(0, ids, src)
    return out[:num_segments]


def segment_count(ids: torch.Tensor, num_segments: int):
    ids, valid = _clean_ids(ids, num_segments)
    out = torch.bincount(ids, minlength=num_segments + 1)
    return out[:num_segments].int()


def segment_mean(data: torch.Tensor, ids: torch.Tensor, num_segments: int):
    s = segment_sum(data, ids, num_segments)
    c = segment_count(ids, num_segments).to(s.dtype)
    c = c.reshape(c.shape + (1,) * (s.ndim - 1))
    return s / torch.clamp(c, min=1)


def segment_max(data: torch.Tensor, ids: torch.Tensor, num_segments: int):
    """Max of data rows per segment; empty segments give 0 (the JAX package's
    ``<=`` test: a segment whose max is the dtype's lowest value counts as
    empty too, ``ops/scatter.py:58-61``)."""
    ids, valid = _clean_ids(ids, num_segments)
    dtype = data.dtype
    if dtype in (torch.bfloat16, torch.float16):
        # max is exact under the widening cast, so reduce in float32 and cast
        # back; the reduction then needs no half-precision scatter support
        data = data.float()
    neg = (torch.finfo(data.dtype).min if data.is_floating_point()
           else torch.iinfo(data.dtype).min)
    src = torch.where(_expand_rows(valid, data), data, neg)
    out = torch.full((num_segments + 1,) + tuple(data.shape[1:]), neg,
                     dtype=data.dtype, device=data.device)
    index = _expand_rows(ids, data).expand_as(src)
    out.scatter_reduce_(0, index, src, reduce='amax', include_self=False)
    out = out[:num_segments]
    return torch.where(out <= neg, 0, out).to(dtype)


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched row gather: x [B, N, C], idx [B, M] -> [B, M, C]. One flat
    index_select, so the index costs B*M integers instead of the B*M*C of an
    expanded torch.gather index. Every idx must lie in [0, N): callers build
    them so (an index past N would read the next sample's rows)."""
    b, n, c = x.shape
    offs = (torch.arange(b, device=x.device) * n)[:, None]
    flat = (idx.long() + offs).reshape(-1)
    return x.reshape(b * n, c).index_select(0, flat).reshape(b, idx.shape[1], c)


def take_rows_or_zero(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """take_rows where idx < 0 reads a zero row (appended to x), as the JAX
    package's gathers do for their -1 sentinels."""
    b, n, c = x.shape
    xp = torch.cat([x, x.new_zeros(b, 1, c)], dim=1)
    return take_rows(xp, torch.where(idx >= 0, idx, n))


def voxel_to_point(voxel_features: torch.Tensor, point_voxel_ids: torch.Tensor):
    """Devoxelize: [B, V, C] voxel features, [B, P] sample-local voxel ids ->
    [B, P, C]; id -1 gives zero features (``ops/scatter.py:64-73``). Ids are
    clamped into [0, V) first, which is what the JAX gather does on its own
    (torch would raise, or read another sample's row)."""
    safe = torch.clamp(point_voxel_ids, 0, voxel_features.shape[1] - 1)
    g = take_rows(voxel_features, safe)
    return torch.where((point_voxel_ids >= 0)[..., None], g, 0)


def inner_group_ranks(group_ids: torch.Tensor, valid: torch.Tensor | None = None):
    """Rank of each element within its group (0-based), by flat position
    (``ops/scatter.py:83-107``): one stable sort of the ids, then each
    element's distance from the start of its run, so the ranks repeat run to
    run. group_ids [N] -> int32 [N]. Invalid elements (valid False) rank
    within one shared trash group, which callers mask out."""
    n = group_ids.shape[0]
    g = group_ids.long()
    if valid is not None:
        g = torch.where(valid, g, torch.iinfo(torch.int32).max)
    sorted_g, order = torch.sort(g, stable=True)
    pos = torch.arange(n, device=g.device)
    is_start = torch.ones(n, dtype=torch.bool, device=g.device)
    is_start[1:] = sorted_g[1:] != sorted_g[:-1]
    run_start = torch.cummax(torch.where(is_start, pos, 0), dim=0).values
    ranks = torch.empty(n, dtype=torch.int32, device=g.device)
    ranks[order] = (pos - run_start).int()
    return ranks

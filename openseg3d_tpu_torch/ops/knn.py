"""Nearest-neighbour searches: the 1-NN of the aux-loss label transfer, and
the k-NN of DeepFusion.

Counterpart of ``openseg3d_tpu/ops/knn.py``. ``nearest_point`` is the
public 1-NN search. For CUDA tensors it launches the hand-written kernel
``csrc/nearest_point.cu`` (which replaces the TPU kernel
``_nearest_point_pallas_single``); for CPU tensors it runs
``nearest_point_plain``. The choice follows the tensors' device and nothing
else, and a CUDA failure raises: there is no fallback.

Both compute the distance as ((qx - px)^2 + (qy - py)^2) + (qz - pz)^2 in
float32, in that order and rounding, take the lowest index among equal
minima, never pick an invalid point (nor one at a NaN or infinite distance),
and give -1 to a query with no such point. Equal distances are common on the
label-transfer path (see the CUDA source), so kernel and plain version must
agree on them, and they do: same floats, same tie rule. The JAX package's
non-TPU path (a matmul expansion of the distance) may pick another of the
equidistant points; tests compare it by distance.

``knn_query`` (brute force) and ``voxel_bucket_knn`` (candidates from the
query's voxel neighbourhood) are XLA-composed in the JAX package and plain
PyTorch here, on either device. Both take the k smallest distances with
equal ones going to the lower candidate position, as ``lax.top_k`` orders
them: a stable sort, since ``torch.topk`` promises no order among ties.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .scatter import inner_group_ranks
from .sparse_conv import SparseTensor, build_subm_rulebook

_BIG = 1e10


def nearest_point_plain(queries: torch.Tensor, points: torch.Tensor,
                        valid: torch.Tensor, tile: int = 256) -> torch.Tensor:
    """Plain PyTorch version. queries [B, Q, 3], points [B, P, 3] float32,
    valid [B, P] bool -> int32 [B, Q]. Tiled over queries: no [Q, P] matrix
    beyond one [tile, P] tile."""
    b, q, _ = queries.shape
    out = torch.empty((b, q), dtype=torch.int32, device=queries.device)
    inf = torch.tensor(float('inf'), device=queries.device)
    for bi in range(b):
        p, ok = points[bi], valid[bi][None, :]
        for s in range(0, q, tile):
            qt = queries[bi, s:s + tile]
            d = (qt[:, None, 0] - p[None, :, 0]).square()
            d = d + (qt[:, None, 1] - p[None, :, 1]).square()
            d = d + (qt[:, None, 2] - p[None, :, 2]).square()
            d = torch.where(ok & ~torch.isnan(d), d, inf)
            best = d.min(dim=1, keepdim=True).values
            # the lowest index among equal minima, explicitly
            cols = torch.arange(d.shape[1], device=d.device)
            idx = torch.where(d == best, cols, d.shape[1]).min(dim=1).values
            out[bi, s:s + tile] = torch.where(best[:, 0] < inf, idx, -1).int()
    return out


def _check(lib, rc, what):
    if rc != 0:
        err = lib.nearest_point_error_string
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f'{what} failed: {err(rc).decode()} ({rc})')


def split_plan(b: int, q: int, p: int, device) -> tuple[int, int]:
    """(splits, span): how the CUDA kernel divides each sample's p points
    over blocks on `device`, ranges of span points (the last one shorter),
    each written to its own partial; a combine pass takes the nearest over
    them in ascending order."""
    lib = _build.load('nearest_point')
    fn = lib.nearest_point_plan
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = ctypes.c_int
    splits, span = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):
        _check(lib, fn(b, q, p, ctypes.byref(splits), ctypes.byref(span)), 'nearest_point_plan')
    return splits.value, span.value


def _launch_cuda(queries, points, valid):
    b, q, _ = queries.shape
    p = points.shape[1]
    for name, x, shape, dtype in (('queries', queries, (b, q, 3), torch.float32),
                                  ('points', points, (b, p, 3), torch.float32),
                                  ('valid', valid, (b, p), torch.bool)):
        if tuple(x.shape) != shape or x.dtype != dtype or x.device != queries.device \
                or not x.is_contiguous():
            raise ValueError(f'{name} must be a contiguous {dtype} {shape} on '
                             f'{queries.device}, got {x.dtype} {tuple(x.shape)} on {x.device}')
    out = torch.empty((b, q), dtype=torch.int32, device=queries.device)
    if b == 0 or q == 0:
        return out
    splits, span = split_plan(b, q, p, queries.device)
    part_dist = torch.empty((b, splits, q), dtype=torch.float32, device=queries.device)
    part_idx = torch.empty((b, splits, q), dtype=torch.int32, device=queries.device)
    lib = _build.load('nearest_point')
    fn = lib.nearest_point
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream(queries.device).cuda_stream
        rc = fn(queries.data_ptr(), points.data_ptr(), valid.data_ptr(), part_dist.data_ptr(),
                part_idx.data_ptr(), out.data_ptr(), b, q, p, splits, span, stream)
    _check(lib, rc, 'nearest_point launch')
    nearest_point.launches += 1
    return out


def nearest_point(queries: torch.Tensor, points: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """Index of the nearest valid point for every query: queries [B, Q, 3],
    points [B, P, 3] float32, valid [B, P] bool -> int32 [B, Q], -1 where
    no valid point exists. On CUDA tensors: the CUDA kernels, a search over
    point splits and the combine of its partials (``nearest_point.launches``
    counts the calls); on CPU tensors: ``nearest_point_plain``."""
    if queries.is_cuda:
        return _launch_cuda(queries, points, valid)
    if queries.device.type == 'cpu':
        return nearest_point_plain(queries, points, valid)
    raise NotImplementedError(f'no nearest_point for device {queries.device}')


nearest_point.launches = 0


def nearest_label_transfer(src_centers: torch.Tensor, src_labels: torch.Tensor,
                           src_valid: torch.Tensor, dst_centers: torch.Tensor,
                           dst_valid: torch.Tensor, ignore_index: int = 255) -> torch.Tensor:
    """1-NN label transfer (``knn.py:245-261``): each valid dst takes the
    label of its nearest valid src. src_centers [B, P, 3], src_labels
    [B, P], dst_centers [B, Q, 3] -> int32 [B, Q]; an invalid dst, or one
    with no valid src, gets ignore_index."""
    idx = nearest_point(dst_centers.float().contiguous(), src_centers.float().contiguous(),
                        src_valid.contiguous())
    idx = torch.where(dst_valid, idx, -1)
    gathered = torch.gather(src_labels, 1, idx.clamp(min=0).long())
    return torch.where(idx >= 0, gathered, ignore_index).int()


def _k_smallest(d: torch.Tensor, k: int):
    """(values, positions) of the k smallest along the last axis, equal
    values in ascending position (``lax.top_k`` of -d); k = 1 is an argmin,
    which returns the first of equal minima."""
    if k == 1:
        pos = d.argmin(dim=-1, keepdim=True)
    else:
        pos = torch.sort(d, dim=-1, stable=True).indices[..., :k]
    return d.gather(-1, pos), pos


def knn_query(k: int, points: torch.Tensor, queries: torch.Tensor, p_valid: torch.Tensor,
              q_valid: torch.Tensor, tile: int = 256):
    """Brute-force k-NN (``knn.py:25-67``): points [B, P, 3], queries
    [B, Q, 3] float32 -> (idx [B, Q, k] int32 into P, -1 for an invalid
    query; dist [B, Q, k], 1e10 for an invalid query). The distance is the
    reference's expansion (|q|^2 - 2 q.p) + |p|^2, with |p|^2 = 1e10 for an
    invalid point, which is then picked only when fewer than k are valid.
    Tiled over queries."""
    b, q, _ = queries.shape
    p_sq = torch.where(p_valid, (points * points).sum(-1), _BIG)           # [B, P]
    dist = queries.new_empty((b, q, k))
    idx = torch.empty((b, q, k), dtype=torch.int32, device=queries.device)
    for s in range(0, q, tile):
        qt = queries[:, s:s + tile]
        d = ((qt * qt).sum(-1, keepdim=True) - 2.0 * torch.bmm(qt, points.transpose(1, 2))
             + p_sq[:, None, :])
        dist[:, s:s + tile], pos = _k_smallest(d, k)
        idx[:, s:s + tile] = pos.int()
    idx = torch.where(q_valid[..., None], idx, -1)
    dist = torch.where(q_valid[..., None], dist, _BIG)
    return idx, dist


def _bucket_knn_single(points, p_valid, q_valid, pvid, nb, k: int, bucket_cap: int,
                       tile: int):
    """One sample of ``voxel_bucket_knn``; nb [V, K^3] is the voxel's
    neighbour at each raster offset (-1 none). Returns (dist [P, k], idx
    [P, k])."""
    p = points.shape[0]
    v, nk = nb.shape
    c = bucket_cap
    dev = points.device
    # each voxel's first bucket_cap points by position, the rest dropped
    cand_valid = p_valid & (pvid >= 0)
    ranks = inner_group_ranks(pvid, valid=cand_valid)
    slot = torch.where(cand_valid & (ranks < c), pvid * c + ranks, v * c).long()
    table = torch.full((v * c + 1,), -1, dtype=torch.int32, device=dev)
    table.scatter_(0, slot, torch.arange(p, dtype=torch.int32, device=dev))
    table = torch.cat([table[:v * c].reshape(v, c),
                       torch.full((1, c), -1, dtype=torch.int32, device=dev)])   # [V+1, C]
    # each voxel's candidate xyz as one row; empty slots and the absent-
    # neighbour row V far away, so that they never win
    packed = torch.where((table >= 0)[..., None], points[table.clamp(min=0).long()], _BIG)
    packed = packed.reshape(v + 1, c * 3)
    dist = points.new_empty((p, k))
    idx = torch.empty((p, k), dtype=torch.int32, device=dev)
    for s in range(0, p, tile):
        qxyz, qvid = points[s:s + tile], pvid[s:s + tile]
        t = qxyz.shape[0]
        cv = nb[qvid.clamp(min=0).long()]                                        # [T, K^3]
        cv = torch.where((cv >= 0) & (qvid >= 0)[:, None], cv, v).long()
        x = packed[cv].reshape(t, nk * c, 3)
        # sum((q - x)^2) over x, y, z in order, as the reference reduces it
        diff = qxyz[:, None, :] - x
        sq = diff * diff
        d = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
        dt, pos = _k_smallest(d, k)
        vox = cv.gather(1, pos // c)
        it = table[vox, pos % c]
        ok = q_valid[s:s + tile, None] & (dt < _BIG) & (it >= 0)
        dist[s:s + tile] = torch.where(ok, dt, _BIG)
        idx[s:s + tile] = torch.where(ok, it, -1)
    return dist, idx


def voxel_bucket_knn(k: int, points: torch.Tensor, p_valid: torch.Tensor,
                     q_valid: torch.Tensor, point_voxel_ids: torch.Tensor,
                     voxel_coords: torch.Tensor, spatial_shape, bucket_cap: int = 8,
                     tile: int = 32768, kernel_size: int = 3):
    """Self k-NN over each point's voxel neighbourhood (``knn.py:70-172``):
    points [B, P, 3] float32, point_voxel_ids [B, P] sample-local voxel
    slots (-1 none), voxel_coords [B, V, 3] zyx (-1 padding) -> (idx
    [B, P, k] int32, dist [B, P, k]).

    A point's candidates are the points of the kernel_size^3 voxels around
    its own (the submanifold rulebook's neighbour table, in raster offset
    order), at most bucket_cap a voxel (the first by position, the rest
    dropped). Exact where that shell holds k points; elsewhere the missing
    neighbours are idx -1 and dist 1e10, as for an invalid query. Tiled over
    queries (`tile` rows at a time) for memory; the result does not depend
    on the tile."""
    nb = build_subm_rulebook(SparseTensor(None, voxel_coords, spatial_shape),
                             kernel_size).in_idx.transpose(1, 2)               # [B, V, K^3]
    out = [_bucket_knn_single(points[i], p_valid[i], q_valid[i], point_voxel_ids[i], nb[i],
                              k, bucket_cap, tile) for i in range(points.shape[0])]
    return torch.stack([o[1] for o in out]), torch.stack([o[0] for o in out])

"""1-nearest-neighbour search and the aux-loss label transfer.

Counterpart of ``openseg3d_tpu/ops/knn.py:175-261``. ``nearest_point`` is the
public search. For CUDA tensors it launches the hand-written kernel
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
"""

from __future__ import annotations

import ctypes

import torch

from . import _build


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

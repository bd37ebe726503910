"""Submanifold / strided / inverse sparse 3D convolution.

Counterpart of ``openseg3d_tpu/ops/sparse_conv.py``. The layout is the same:
batched ``[B, V, ...]`` with per-sample capacity V, padding rows have
coords == -1, and every convolution reads a dense rulebook ``in_idx
[B, K^3, V_out]`` (the input row at raster offset k of output o, -1 = none).

What differs from the JAX package, and why the results are the same:
  * The JAX package builds the k=3 submanifold structure with payload-free
    merge sorts (``build_planar_k3_direct``) and executes four rulebook types
    through four custom VJPs. Their forwards are all the same gather-GEMM,
    ``out[o] = sum_k x[in_idx[k, o]] @ W[k]``, so here one rulebook type and
    one executor serve every conv, and the structure is found with
    ``torch.searchsorted`` over the key-sorted voxels (``sort_match``). The
    neighbour table is exact either way, and the tests hold it equal.
  * The inverse conv's candidate-compact pair structure becomes the dense
    transposed rulebook, scattered once from the strided conv's rule
    (``inv[k, rule[k, o]] = o``): the same pairs, read from the fine side.
  * The backwards of the planar subm, strided and inverse custom VJPs
    (``:1105-1150``, ``:687-724``, ``:631-653``) all gather the cotangent
    through the transposed pairs. Here one ``torch.autograd.Function``
    does the same through the transpose each rulebook carries (the subm
    mirror, or the downsample plan's other rule), with the reference's
    float32 accumulation and float32 weight gradient.

Keys are int32 with the JAX package's sentinel (``linearize`` refuses grids
that overflow it); they are cast to int64 only to index.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Sequence

import torch

from .scatter import take_rows_or_zero

INT32_SENTINEL = 2 ** 31 - 1


@dataclass(frozen=True)
class SparseTensor:
    """Batched sparse voxel tensor. coords are (z, y, x) per sample; a row with
    z == -1 is padding. spatial_shape is (gz, gy, gx)."""
    features: torch.Tensor | None              # [B, V, C]
    coords: torch.Tensor                       # [B, V, 3] int32
    spatial_shape: tuple

    @property
    def mask(self) -> torch.Tensor:            # [B, V]
        return self.coords[..., 0] >= 0


class Rulebook(NamedTuple):
    """in_idx [B, K^3, V_out] int32: the input row that contributes to output
    o at kernel offset k (-1 = none). transpose [B, K^3, V_in] int32: the
    same pairs from the input side, transpose[k, u] = o iff in_idx[k, o] = u
    (-1 = none); the backward gathers through it, and a rulebook without one
    has no backward. submanifold: outputs are the inputs, and the backward
    masks dx by the output mask as the reference's subm VJP does."""
    in_idx: torch.Tensor
    transpose: torch.Tensor | None = None
    submanifold: bool = False


class DownsamplePlan(NamedTuple):
    """Everything the paired strided conv and inverse conv need (spconv's
    cached indice pairs for one indice_key)."""
    out_coords: torch.Tensor   # [B, Vo, 3]
    rule: Rulebook             # gather rule into the fine level, [B, K^3, Vo]
    inv_rule: Rulebook         # transposed rule into the coarse level, [B, K^3, V]
    out_shape: tuple
    num_out: torch.Tensor      # [B] true number of outputs (before the capacity cut)


def kernel_offsets(kernel_size: int, device=None) -> torch.Tensor:
    """[K^3, 3] (dz, dy, dx) offsets in raster order."""
    r = kernel_size
    idx = torch.arange(r ** 3, device=device)
    return torch.stack([idx // (r * r), (idx // r) % r, idx % r], dim=1).int()


def linearize(coords: torch.Tensor, spatial_shape: Sequence[int],
              valid: torch.Tensor | None = None) -> torch.Tensor:
    """coords [..., 3] (z,y,x) -> int32 linear keys; invalid or out-of-grid
    rows -> INT32_SENTINEL."""
    gz, gy, gx = spatial_shape
    if gz * gy * gx >= 2 ** 31:
        raise ValueError(f'grid {spatial_shape} overflows int32 key space')
    z, y, x = coords[..., 0], coords[..., 1], coords[..., 2]
    in_range = (z >= 0) & (z < gz) & (y >= 0) & (y < gy) & (x >= 0) & (x < gx)
    if valid is not None:
        in_range = in_range & valid
    # the key of an in-range row is < gz*gy*gx < 2**31, so int32 holds it
    key = (z * gy + y) * gx + x
    return torch.where(in_range, key, INT32_SENTINEL).int()


def delinearize(keys: torch.Tensor, spatial_shape: Sequence[int]) -> torch.Tensor:
    gz, gy, gx = spatial_shape
    z = keys // (gy * gx)
    rem = keys % (gy * gx)
    out = torch.stack([z, rem // gx, rem % gx], dim=-1).int()
    return torch.where((keys != INT32_SENTINEL)[..., None], out, -1)


def sort_match(keys: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """For each query, the index of the matching entry in `keys` (-1 if absent
    or sentinel). keys [..., V] and queries [..., M] share their leading
    dims; valid keys are unique, as in the JAX package's sort_match."""
    sorted_keys, order = torch.sort(keys, dim=-1, stable=True)
    pos = torch.searchsorted(sorted_keys, queries.contiguous())
    pos = torch.clamp(pos, max=keys.shape[-1] - 1)
    hit = (sorted_keys.gather(-1, pos) == queries) & (queries != INT32_SENTINEL)
    return torch.where(hit, order.gather(-1, pos), -1).int()


def build_subm_rulebook(st: SparseTensor, kernel_size: int = 3) -> Rulebook:
    """Submanifold rulebook: outputs are the inputs; in_idx[b, k, o] is the
    row of voxel o's neighbour at raster offset k. Counterpart of
    ``build_planar_k3_direct`` (``ops/sparse_conv.py:876-1007``), which gives
    the same table for k=3 over key-sorted coords. Its transpose is the
    mirror (``_subm_conv_bwd``): o reads u at offset k iff u reads o at
    offset K^3-1-k, whose offset is the negation of k's."""
    coords = st.coords
    b, v, _ = coords.shape
    valid = coords[..., 0] >= 0
    keys = linearize(coords, st.spatial_shape, valid=valid)          # [B, V]
    offs = kernel_offsets(kernel_size, coords.device) - kernel_size // 2
    nb = coords[:, None, :, :] + offs[None, :, None, :]              # [B, K3, V, 3]
    q = linearize(nb, st.spatial_shape, valid=valid[:, None, :])
    k3 = offs.shape[0]
    in_idx = sort_match(keys, q.reshape(b, k3 * v)).reshape(b, k3, v)
    return Rulebook(in_idx=in_idx, transpose=in_idx.flip(1), submanifold=True)


def downsample_shape(spatial_shape, kernel_size: int, stride: int, padding: int):
    return tuple(int(math.floor((g + 2 * padding - kernel_size) / stride) + 1)
                 for g in spatial_shape)


def build_downsample(st: SparseTensor, out_capacity: int, kernel_size: int = 3,
                     stride: int = 2, padding: int = 1) -> DownsamplePlan:
    """Strided sparse conv structure (``ops/sparse_conv.py:305-492``). Output
    set = exact spconv semantics: every site o with o*s - p + off == some
    input, off in [0, K)^3; outputs in ascending key order, the ones past
    out_capacity dropped (the order decides which)."""
    coords = st.coords
    b, v, _ = coords.shape
    valid = coords[..., 0] >= 0
    out_shape = downsample_shape(st.spatial_shape, kernel_size, stride, padding)
    offs = kernel_offsets(kernel_size, coords.device)
    k3 = offs.shape[0]

    # (input, offset) candidates: output cell t/s where t = in + p - off
    t = coords[:, None, :, :] + padding - offs[None, :, None, :]    # [B, K3, V, 3]
    div = torch.all(t % stride == 0, dim=-1)
    cand = linearize(torch.div(t, stride, rounding_mode='floor'), out_shape,
                     valid=valid[:, None, :] & div).reshape(b, k3 * v)
    # stable sort: candidates with equal keys stay in (offset, voxel) order;
    # every consumer below writes unique targets, so tie order is immaterial
    s, perm = torch.sort(cand, dim=-1, stable=True)
    ok_s = s != INT32_SENTINEL
    is_new = torch.cat([torch.ones_like(ok_s[:, :1]), s[:, 1:] != s[:, :-1]], dim=1) & ok_s
    rank = torch.cumsum(is_new, dim=-1) - 1                         # shared by duplicates
    ok = ok_s & (rank < out_capacity)
    num_out = is_new.sum(dim=-1).int()

    # unique output keys -> coords; dropped rows land in a trash column
    trash = out_capacity
    out_keys = torch.full((b, out_capacity + 1), INT32_SENTINEL, dtype=torch.int32,
                          device=coords.device)
    out_keys.scatter_(1, torch.where(is_new & ok, rank, trash), s)
    out_coords = delinearize(out_keys[:, :out_capacity], out_shape)

    # gather rule: rule[k, o] = the input voxel at o*s - p + off_k; for fixed
    # (k, o) there is at most one input, so (k, rank) targets are unique
    kk, vv = perm // v, perm % v
    rule = torch.full((b, k3 * out_capacity + 1), -1, dtype=torch.int32,
                      device=coords.device)
    rule.scatter_(1, torch.where(ok, kk * out_capacity + rank, k3 * out_capacity),
                  vv.int())
    rule = rule[:, :-1].reshape(b, k3, out_capacity)

    # transposed rule: inv[k, v] = o  <=>  rule[k, o] = v (one o per (k, v))
    o_idx = torch.arange(out_capacity, device=coords.device).expand(b, k3, -1)
    k_idx = torch.arange(k3, device=coords.device)[None, :, None]
    inv = torch.full((b, k3 * v + 1), -1, dtype=torch.int32, device=coords.device)
    inv.scatter_(1, torch.where(rule >= 0, k_idx * v + rule, k3 * v).reshape(b, -1),
                 o_idx.reshape(b, -1).int())
    inv = inv[:, :-1].reshape(b, k3, v)
    # each rule is the other's transpose: the inverse conv's backward reads
    # the strided rule, as the reference's reads fwd_idx
    return DownsamplePlan(out_coords=out_coords, rule=Rulebook(rule, inv),
                          inv_rule=Rulebook(inv, rule), out_shape=out_shape,
                          num_out=num_out)


def mm_float32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b summed in float32 with a float32 result, as the reference's
    ``dot_general(..., preferred_element_type=float32)``. On the card, bf16
    operands go to cuBLAS's mixed-precision product (``aten::mm.dtype``), so
    no float32 copy of either is made; on the CPU, which has no kernel for
    that op, both are widened first: a product of two bf16 values is exact
    in float32, so the arithmetic is the same up to summation order."""
    if a.dtype == b.dtype == torch.float32:
        return torch.mm(a, b)
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


# rows of the weight gradient's product that one tensor-core accumulator sums
DW_CHUNK = 2048


def tn_float32(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """x^T g for x [K, M], g [K, N], summed in float32 with a float32 result
    (the weight gradient, K = B*V rows). On the card the tensor cores sum
    pieces of DW_CHUNK rows and the pieces are added in float32: on an
    H100, one tensor-core accumulator over all K (up to 166400) drifts up
    to ~2e-5 of max|dW| from a float32 CUDA-core product, pieces of 2048
    rows ~2e-6."""
    if not x.is_cuda or x.dtype == torch.float32 or x.shape[0] <= DW_CHUNK:
        return mm_float32(x.t(), g)
    n = x.shape[0] // DW_CHUNK
    body = n * DW_CHUNK
    out = torch.bmm(x[:body].reshape(n, DW_CHUNK, -1).transpose(1, 2),
                    g[:body].reshape(n, DW_CHUNK, -1), out_dtype=torch.float32).sum(0)
    if body < x.shape[0]:
        out = out + mm_float32(x[body:].t(), g[body:])
    return out


class _SparseConv(torch.autograd.Function):
    """The gather-GEMM, with the reference's gather-only backward. Saved for
    the backward: the features in the compute dtype, the float32 weights,
    the transposed rulebook and the output mask, never the gathered rows."""

    @staticmethod
    def forward(ctx, features, weights, rulebook: Rulebook, out_mask, compute_dtype):
        in_idx = rulebook.in_idx
        b, k3, vo = in_idx.shape
        x, w = features, weights
        if compute_dtype is not None:
            x, w = x.to(compute_dtype), w.to(compute_dtype)
        cin = x.shape[2]
        idx = in_idx.transpose(1, 2).reshape(b, vo * k3)                 # [B, Vo*K3]
        g = take_rows_or_zero(x, idx).reshape(b, vo, k3 * cin)
        out = torch.matmul(g, w.reshape(k3 * cin, -1)).to(features.dtype)
        ctx.save_for_backward(x, weights, rulebook.transpose, out_mask)
        ctx.submanifold, ctx.features_dtype = rulebook.submanifold, features.dtype
        return torch.where(out_mask[..., None], out, 0)

    @staticmethod
    def backward(ctx, gout):
        """G[u] = [g[transpose[k, u]]]_k, [B*V, K^3*Cout]; then dx = G W^T
        and dW = x^T G, each one float32-accumulated product."""
        x, weights, tr, out_mask = ctx.saved_tensors
        if tr is None:
            raise RuntimeError('this rulebook carries no transpose, so its conv has no '
                               'backward (build it with build_subm_rulebook or '
                               'build_downsample)')
        apply_sparse_conv.backwards += 1
        b, v, cin = x.shape
        k3, cout = tr.shape[1], weights.shape[-1]
        g = torch.where(out_mask[..., None], gout, 0).to(x.dtype)
        gath = take_rows_or_zero(g, tr.transpose(1, 2).reshape(b, v * k3))
        gath = gath.reshape(b * v, k3 * cout)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            wt = weights.to(x.dtype).transpose(1, 2).reshape(k3 * cout, cin)
            dx = mm_float32(gath, wt).reshape(b, v, cin).to(ctx.features_dtype)
            if ctx.submanifold:
                # the subm VJP masks dx; strided and inverse rows without a
                # pair come out zero on their own (``:703-708``)
                dx = torch.where(out_mask[..., None], dx, 0)
        if ctx.needs_input_grad[1]:
            dw = tn_float32(x.reshape(b * v, cin), gath)             # [Cin, K3*Cout]
            dw = dw.reshape(cin, k3, cout).transpose(0, 1).to(weights.dtype)
        return dx, dw, None, None, None


def apply_sparse_conv(features: torch.Tensor, rulebook: Rulebook,
                      weights: torch.Tensor, out_mask: torch.Tensor,
                      compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """features [B, V, Cin], rulebook.in_idx [B, K^3, Vo], weights
    [K^3, Cin, Cout] -> [B, Vo, Cout], zero on rows where out_mask is False.

    One row gather builds [B, Vo, K^3*Cin] (missing neighbours read a zero
    row appended to x, as in the JAX package) and one matmul contracts it with
    the [K^3*Cin, Cout] weights. The backward gathers the cotangent through
    ``rulebook.transpose`` and sums dx and dW in float32; dW keeps the
    weights' dtype (float32 parameters get a float32 gradient), dx the
    features'. ``apply_sparse_conv.backwards`` counts the backwards run."""
    return _SparseConv.apply(features, weights, rulebook, out_mask, compute_dtype)


apply_sparse_conv.backwards = 0


def apply_subm(features: torch.Tensor, rulebook: Rulebook, weights: torch.Tensor,
               out_mask: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """The JAX package dispatches here on the rulebook type to pick a custom
    VJP (``ops/sparse_conv.py:1009-1027``); every forward is the same
    gather-GEMM, so one executor serves submanifold, strided and inverse
    rulebooks alike."""
    return apply_sparse_conv(features, rulebook, weights, out_mask, compute_dtype)

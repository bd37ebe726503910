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

On the card, bf16 convs run the hand-written kernels of
``csrc/sparse_conv.cu`` (``gather_gemm`` for the forward and dx,
``weight_grad`` for dW), which the JAX package has no counterpart of: XLA
composes its gather and dot. CPU tensors and the float32 compute dtype run
the plain gather-GEMM, which writes the gathered rows.

Keys are int32 with the JAX package's sentinel (``linearize`` refuses grids
that overflow it); they are cast to int64 only to index.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import NamedTuple, Sequence

import torch

from . import _build
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


# rows of the weight gradient's product that one tensor-core accumulator sums:
# on an H100, one accumulator over all B*V rows (up to 332800) drifts up to
# ~2e-5 of max|dW| from a float32 CUDA-core product, pieces of 2048 rows ~2e-6
DW_CHUNK = 2048

# GEMM_TABLE[(cin, cout)] / GRAD_TABLE[(cin, cout)]: the tile of the
# gather-GEMM / weight gradient at those widths, an index into the kernel's
# tile shapes (``csrc/sparse_conv.cu`` defines them; ``tile_shapes`` reads
# them). Widths outside the table take the rule in gemm_tile / grad_tile.
# The gather-GEMM's widths are those of the launch: a conv's forward is
# (Cin, Cout), its dx (Cout, Cin).
GEMM_TABLE = {
    (32, 32): 5, (32, 48): 1, (32, 64): 1, (48, 32): 5, (48, 48): 1, (48, 64): 1, (48, 96): 2,
    (64, 32): 5, (64, 48): 1, (64, 64): 4, (64, 128): 2, (96, 48): 1, (96, 96): 2, (96, 192): 4,
    (128, 64): 1, (128, 128): 3, (128, 256): 2, (192, 96): 2, (192, 192): 4, (192, 384): 2,
    (256, 128): 2, (256, 256): 2, (256, 512): 3, (384, 192): 2, (384, 384): 2, (384, 768): 3,
    (512, 256): 2, (768, 384): 2}
GRAD_TABLE = {
    (32, 32): 0, (32, 64): 4, (48, 32): 4, (48, 48): 4, (48, 96): 2, (64, 32): 4, (64, 48): 1,
    (64, 64): 4, (64, 128): 2, (96, 48): 4, (96, 96): 3, (96, 192): 1, (128, 64): 4, (128, 128): 3,
    (128, 256): 1, (192, 96): 2, (192, 192): 1, (192, 384): 1, (256, 128): 3, (256, 256): 4,
    (384, 192): 1, (384, 384): 1, (512, 256): 1, (768, 384): 1}
def kernel_widths(cin: int, cout: int) -> bool:
    """Whether both widths take the kernels' 16-byte rows; other widths take
    their unaligned instantiation (tile 0), which ignores the tables."""
    return cin % 8 == 0 and cout % 8 == 0


def gemm_tile(cin: int, cout: int) -> int:
    """The gather-GEMM's tile for a product of cin -> cout columns; off the
    table, tile 0, 1 or 3 (64 x 32, 64 x 64, 128 x 128) by Cout."""
    if not kernel_widths(cin, cout):
        return 0
    if (cin, cout) in GEMM_TABLE:
        return GEMM_TABLE[cin, cout]
    return 0 if cout <= 32 else (1 if cout <= 64 else 3)


def grad_tile(cin: int, cout: int) -> int:
    """The weight gradient's tile for a [cin, cout] product; off the table,
    tile 4 (64 x 64, 64-row steps) for narrow products, else tile 1 (64 x
    64, 32-row steps)."""
    if not kernel_widths(cin, cout):
        return 0
    if (cin, cout) in GRAD_TABLE:
        return GRAD_TABLE[cin, cout]
    return 4 if cin <= 128 and cout <= 64 else 1


_KERNEL_IDS = {'gather_gemm': 0, 'weight_grad': 1}


@functools.lru_cache(maxsize=None)
def tile_shapes(kernel: str) -> tuple:
    """((rows, columns), ...) of each tile of `kernel` ('gather_gemm' or
    'weight_grad'), in the order its `tile` argument and the tables index
    them, as ``csrc/sparse_conv.cu`` defines them (read from the built
    library, so on a host with the CUDA toolkit only)."""
    lib = _build.load('sparse_conv')
    fn = lib.sparse_conv_tiles
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    fn.restype = ctypes.c_int
    cap = 64
    buf = (ctypes.c_int * (2 * cap))()
    n = fn(_KERNEL_IDS[kernel], buf, cap)
    if not 0 < n <= cap:
        raise RuntimeError(f'sparse_conv_tiles({kernel}) gave {n}')
    return tuple((buf[2 * i], buf[2 * i + 1]) for i in range(n))


def grad_splits(nchunks: int, cin: int, cout: int, tile: int, sms: int) -> int:
    """The runs of row chunks the weight gradient's grid splits `nchunks`
    into for a [cin, cout] product in `tile` on `sms` multiprocessors, as the
    kernel's launch counts them (``sparse_conv_weight_grad_splits``): the
    float32 partials are [splits, 27, cin, cout]."""
    lib = _build.load('sparse_conv')
    fn = lib.sparse_conv_weight_grad_splits
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_int
    splits = fn(nchunks, cin, cout, tile, sms)
    if splits <= 0:
        raise ValueError(f'no weight-gradient tile {tile} for {nchunks} chunks of [{cin}, '
                         f'{cout}]')
    return splits


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


def gather_rows_plain(x, idx, src_mask=None):
    """The plain path's row gather: [B, Vo, K^3*C] from x [B, Vin, C]
    through idx [B, K^3, Vo] (absent rows read a zero row appended to x, as
    in the JAX package; rows whose src_mask [B, Vin] is False read zero),
    written to device memory."""
    b, k3, vo = idx.shape
    if src_mask is not None:
        x = torch.where(src_mask[..., None], x, 0)
    return take_rows_or_zero(x, idx.transpose(1, 2).reshape(b, vo * k3)).reshape(b, vo, -1)


def gather_gemm_plain(x, idx, w, src_mask=None, dst_mask=None):
    """Plain version of ``gather_gemm``: ``gather_rows_plain`` and one
    matmul in x's dtype with the [K^3*Cin, Cout] weights. It is the
    forward of ``_SparseConv`` off the kernels."""
    out = torch.matmul(gather_rows_plain(x, idx, src_mask), w.reshape(-1, w.shape[-1]))
    return out if dst_mask is None else torch.where(dst_mask[..., None], out, 0)


def weight_grad_plain(x, tr, g, src_mask=None):
    """Plain version of ``weight_grad``: the cotangent gathered through the
    transpose (``gather_rows_plain``), then one float32-summed x^T product.
    ``_SparseConv``'s backward off the kernels takes the same product from
    the one gather it shares with dx."""
    b, v, cin = x.shape
    k3, cout = tr.shape[1], g.shape[-1]
    gath = gather_rows_plain(g, tr, src_mask).reshape(b * v, k3 * cout)
    return mm_float32(x.reshape(b * v, cin).t(), gath).reshape(cin, k3, cout).transpose(0, 1)


def _check_kernel_args(tensors, index, masks):
    """The kernels' preconditions: bf16 operands on one device, contiguous
    and 16-byte aligned; the index int32 [B, 27, rows] with each sample's
    [27, rows] contiguous (a downsample plan's rules are views with a wider
    batch stride); masks bool [B, rows], contiguous."""
    dev = tensors[0][1].device
    for name, t in tensors:
        if t.dtype != torch.bfloat16:
            raise ValueError(f'{name} must be bfloat16, got {t.dtype}')
        if t.device != dev:
            raise ValueError(f'{name} is on {t.device}, {tensors[0][0]} on {dev}')
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f'{name} must be contiguous and 16-byte aligned')
    name, idx = index
    if idx.dtype != torch.int32 or idx.device != dev or idx.stride(2) != 1 \
            or idx.stride(1) != idx.shape[2]:
        raise ValueError(f'{name} must be int32 on {dev} with each sample contiguous, got '
                         f'{idx.dtype} on {idx.device}, strides {idx.stride()}')
    for name, m, shape in masks:
        if m is None:
            continue
        if m.dtype != torch.bool or tuple(m.shape) != shape or m.device != dev \
                or not m.is_contiguous():
            raise ValueError(f'{name} must be a contiguous bool {shape} on {dev}, got '
                             f'{m.dtype} {tuple(m.shape)} on {m.device}')


def _raise_on_error(lib, rc: int, what: str):
    if rc != 0:
        err = lib.sparse_conv_error_string
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f'{what} launch failed: {err(rc).decode()} ({rc})')


def _ptr(t):
    return None if t is None else t.data_ptr()


def gather_gemm(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                src_mask: torch.Tensor | None = None, dst_mask: torch.Tensor | None = None, *,
                tile: int | None = None) -> torch.Tensor:
    """out [B, Vo, Cout] = sum_k x[b, idx[b, k, o]] @ w[k] for x [B, Vin,
    Cin], idx int32 [B, K^3, Vo] (-1: no row), w [K^3, Cin, Cout]; a row
    whose src_mask [B, Vin] is False reads zero, and rows whose dst_mask
    [B, Vo] is False are zero. The conv's forward (idx = in_idx) and, through
    the transposed rulebook with w^T, its dx.

    The kernel ``gather_gemm_mma_kernel`` (bf16 operands on the card,
    float32 sums, one rounding to bf16), which never writes the gathered
    rows; ``.launches`` counts its launches. tile: an index into
    ``tile_shapes('gather_gemm')`` to force (chip_smoke and the card tests
    time each), None for ``gemm_tile``'s. Every idx must lie in [-1, Vin).
    Raises on what the kernel does not take (``gather_gemm_plain`` is the
    same function anywhere)."""
    if not x.is_cuda:
        raise ValueError(f'gather_gemm runs on the card; x is on {x.device}')
    b, vin, cin = x.shape
    k3, vo = idx.shape[1], idx.shape[2]
    cout = w.shape[-1]
    if k3 != 27 or idx.shape[0] != b or tuple(w.shape) != (27, cin, cout):
        raise ValueError(f'x {tuple(x.shape)}, idx {tuple(idx.shape)} and w {tuple(w.shape)} '
                         f'are no 3^3 gather-GEMM')
    _check_kernel_args([('x', x), ('w', w)], ('idx', idx),
                       [('src_mask', src_mask, (b, vin)), ('dst_mask', dst_mask, (b, vo))])
    tile = gemm_tile(cin, cout) if tile is None else tile
    out = torch.empty((b, vo, cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.load('sparse_conv')
    fn = lib.sparse_conv_gather_gemm
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), idx.data_ptr(), _ptr(src_mask), w.data_ptr(), _ptr(dst_mask),
                out.data_ptr(), idx.stride(0), b, vin, vo, cin, cout, tile, stream)
    _raise_on_error(lib, rc, 'sparse_conv_gather_gemm')
    gather_gemm.launches += 1
    return out


def weight_grad(x: torch.Tensor, tr: torch.Tensor, g: torch.Tensor,
                src_mask: torch.Tensor | None = None, *, tile: int | None = None) -> torch.Tensor:
    """dW [K^3, Cin, Cout] float32 = sum_u x[b, u]^T g[b, tr[b, k, u]] for x
    [B, Vin, Cin], tr int32 [B, K^3, Vin] (-1: no pair), g [B, Vo, Cout]
    (rows whose src_mask [B, Vo] is False read zero).

    The kernel ``weight_grad_mma_kernel`` on the card: bf16 operands, each
    chunk of at most DW_CHUNK rows summed in its own tensor-core
    accumulators and the chunks added in float32, each block's run of chunks
    into its own float32 partial, which one ``.sum(0)`` adds in a fixed
    order: no atomics, reruns bit-equal. ``.launches`` counts its launches;
    tile forces an index into ``tile_shapes('weight_grad')``. Raises on
    what the kernel does not take (``weight_grad_plain`` is the same
    function anywhere)."""
    if not x.is_cuda:
        raise ValueError(f'weight_grad runs on the card; x is on {x.device}')
    b, vin, cin = x.shape
    vo, cout = g.shape[1], g.shape[2]
    if tuple(tr.shape) != (b, 27, vin) or g.shape[0] != b:
        raise ValueError(f'x {tuple(x.shape)}, tr {tuple(tr.shape)} and g {tuple(g.shape)} '
                         f'are no 3^3 weight gradient')
    _check_kernel_args([('x', x), ('g', g)], ('tr', tr), [('src_mask', src_mask, (b, vo))])
    tile = grad_tile(cin, cout) if tile is None else tile
    nchunks = b * -(-vin // DW_CHUNK)
    if nchunks == 0 or cin == 0 or cout == 0:
        return torch.zeros((27, cin, cout), dtype=torch.float32, device=x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits = grad_splits(nchunks, cin, cout, tile, sms)
    part = torch.empty((splits, 27, cin, cout), dtype=torch.float32, device=x.device)
    lib = _build.load('sparse_conv')
    fn = lib.sparse_conv_weight_grad
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), tr.data_ptr(), _ptr(src_mask), g.data_ptr(), part.data_ptr(),
                tr.stride(0), b, vin, vo, cin, cout, DW_CHUNK, splits, tile, stream)
    _raise_on_error(lib, rc, 'sparse_conv_weight_grad')
    weight_grad.launches += 1
    return part[0] if splits == 1 else part.sum(0)


gather_gemm.launches = 0
weight_grad.launches = 0


def _on_kernels(x: torch.Tensor) -> bool:
    """bf16 features on the card run the kernels; CPU tensors and the
    float32 compute dtype the plain gather-GEMM. ``_SparseConv`` routes here
    and nowhere else."""
    return x.is_cuda and x.dtype == torch.bfloat16


class _SparseConv(torch.autograd.Function):
    """The gather-GEMM, with the reference's gather-only backward. Saved for
    the backward: the features in the compute dtype, the float32 weights,
    the transposed rulebook and the output mask, never the gathered rows.
    bf16 on the card: the forward and dx are ``gather_gemm`` launches and dW
    a ``weight_grad`` launch; elsewhere the plain gather-GEMM."""

    @staticmethod
    def forward(ctx, features, weights, rulebook: Rulebook, out_mask, compute_dtype):
        x, w = features, weights
        if compute_dtype is not None:
            x, w = x.to(compute_dtype), w.to(compute_dtype)
        if _on_kernels(x):
            x = x.contiguous()
            out = gather_gemm(x, rulebook.in_idx, w.contiguous(), dst_mask=out_mask)
        else:
            out = gather_gemm_plain(x, rulebook.in_idx, w, dst_mask=out_mask)
        ctx.save_for_backward(x, weights, rulebook.transpose, out_mask)
        ctx.submanifold, ctx.features_dtype = rulebook.submanifold, features.dtype
        return out.to(features.dtype)

    @staticmethod
    def backward(ctx, gout):
        """The cotangent gathered through the transpose, masked by the output
        mask: dx = G W^T and dW = x^T G, each float32-accumulated."""
        x, weights, tr, out_mask = ctx.saved_tensors
        if tr is None:
            raise RuntimeError('this rulebook carries no transpose, so its conv has no '
                               'backward (build it with build_subm_rulebook or '
                               'build_downsample)')
        apply_sparse_conv.backwards += 1
        # the subm VJP masks dx; strided and inverse rows without a pair
        # come out zero on their own (``:703-708``)
        dx_mask = out_mask if ctx.submanifold else None
        dx = dw = None
        if _on_kernels(x):
            g = gout.to(x.dtype).contiguous()
            if ctx.needs_input_grad[0]:
                wt = weights.to(x.dtype).transpose(1, 2).contiguous()
                dx = gather_gemm(g, tr, wt, src_mask=out_mask, dst_mask=dx_mask)
                dx = dx.to(ctx.features_dtype)
            if ctx.needs_input_grad[1]:
                dw = weight_grad(x, tr, g, src_mask=out_mask).to(weights.dtype)
            return dx, dw, None, None, None
        # off the kernels: dx and dW share one gather of the cotangent, and
        # each is one float32-summed product (``weight_grad_plain``'s for dW)
        b, v, cin = x.shape
        k3, cout = tr.shape[1], weights.shape[-1]
        gath = gather_rows_plain(gout.to(x.dtype), tr, out_mask).reshape(b * v, k3 * cout)
        if ctx.needs_input_grad[0]:
            wt = weights.to(x.dtype).transpose(1, 2).reshape(k3 * cout, cin)
            dx = mm_float32(gath, wt).reshape(b, v, cin).to(ctx.features_dtype)
            if dx_mask is not None:
                dx = torch.where(dx_mask[..., None], dx, 0)
        if ctx.needs_input_grad[1]:
            dw = mm_float32(x.reshape(b * v, cin).t(), gath)             # [Cin, K3*Cout]
            dw = dw.reshape(cin, k3, cout).transpose(0, 1).to(weights.dtype)
        return dx, dw, None, None, None


def apply_sparse_conv(features: torch.Tensor, rulebook: Rulebook,
                      weights: torch.Tensor, out_mask: torch.Tensor,
                      compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """features [B, V, Cin], rulebook.in_idx [B, K^3, Vo], weights
    [K^3, Cin, Cout] -> [B, Vo, Cout], zero on rows where out_mask is False.

    bf16 on the card: the gather-GEMM kernel reads the rows through the
    rulebook (``gather_gemm``); elsewhere one row gather builds [B, Vo,
    K^3*Cin] (missing neighbours read a zero row appended to x, as in the JAX
    package) and one matmul contracts it with the [K^3*Cin, Cout] weights.
    The backward gathers the cotangent through ``rulebook.transpose`` and
    sums dx and dW in float32; dW keeps the weights' dtype (float32
    parameters get a float32 gradient), dx the features'.
    ``apply_sparse_conv.backwards`` counts the backwards run."""
    return _SparseConv.apply(features, weights, rulebook, out_mask, compute_dtype)


apply_sparse_conv.backwards = 0


def apply_subm(features: torch.Tensor, rulebook: Rulebook, weights: torch.Tensor,
               out_mask: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """The JAX package dispatches here on the rulebook type to pick a custom
    VJP (``ops/sparse_conv.py:1009-1027``); every forward is the same
    gather-GEMM, so one executor serves submanifold, strided and inverse
    rulebooks alike."""
    return apply_sparse_conv(features, rulebook, weights, out_mask, compute_dtype)

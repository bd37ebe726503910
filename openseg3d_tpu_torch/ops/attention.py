"""Window attention: the attention core of every SWFormer layer, and the
public unpacked op.

Counterpart of ``openseg3d_tpu/ops/attention.py``. Three public functions:

* ``window_attention_packed`` (eval). For a CUDA tensor it launches the
  hand-written kernel ``csrc/window_attention.cu`` (which replaces the TPU
  kernel ``fused_window_attention_packed`` -> ``_kernel_packed``; bfloat16
  on tensor cores, float32 on FMA units); for a CPU
  tensor it runs ``window_attention_packed_plain``, the einsum with the
  semantics of the JAX package's non-TPU path (``models/swformer.py:167-180``,
  ``reference_window_attention``).
* ``fused_window_attention`` (the unpacked op: q, k and v as three arrays).
  For a CUDA tensor it launches the same kernels through their own entry
  point (replacing ``fused_window_attention`` -> ``_kernel``); for a CPU
  tensor it runs ``fused_window_attention_plain``. No model calls it.
* ``window_attention_packed_train`` (training: attention dropout on the
  softmax weights, differentiable). For a CUDA tensor it is an autograd
  Function whose forward and backward launch the kernels of
  ``csrc/window_attention_train.cu`` (replacing the custom VJP
  ``window_attention_packed_train``: ``_kernel_packed_train`` and
  ``_kernel_packed_bwd``) through ``window_attention_train_forward`` and
  ``window_attention_train_backward``; for a CPU tensor it runs
  ``window_attention_packed_train_plain``, differentiated by autograd. The
  two wrappers take a CPU tensor too and then run their plain versions
  (``window_attention_train_forward_plain``, ``..._backward_plain``), the
  kernels' interface on the CPU.

The choice follows the tensor's device and nothing else, and a CUDA failure
raises: there is no fallback.

Dropout mask. The TPU kernels seed the TPU's PRNG per (grid block, chunk);
its bits cannot be reproduced here. Instead the keep decision of softmax
weight (window n, head h, query i, key j) is a pure function of the int32
seed and those four indices, a counter-based integer hash
(``dropout_keep_mask``), and the plain version computes the same mask with
integer tensor arithmetic: kernel and plain version agree element for
element at any rate. A weight is kept when its 32-bit hash is >= rate *
2**32, as in ``_dropout_mask`` (``ops/attention.py:335-341``), and kept
weights are scaled by 1 / (1 - rate). The bf16 forward kernel stores the
mask as it hashes it, one bit a weight (``pack_keep_bits``'s layout), and
the bf16 backward reads those bits; the float32 kernels hash it where they
need it and store nothing.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

GROUP_ALIGN = 64
KERNEL_HEAD_DIMS = (6, 12, 24, 48)
_MASK32 = 0xFFFFFFFF


def attention_group(max_tokens: int, channels: int = 0, itemsize: int = 4) -> int:
    """Windows per grid step of the TPU kernel (``ops/attention.py:48-59``).
    The Hopper kernel has no use for it, but ``window.make_level_specs``
    rounds each level's window capacity up to a multiple of it, and the port
    keeps that rounding so its buffer shapes match the JAX package's."""
    cb = channels * itemsize
    r_target = 1024 if cb <= 256 else (512 if cb <= 1024 else 256)
    g = max(1, r_target // max_tokens)
    while GROUP_ALIGN % g:
        g -= 1
    return g


# ---------------------------------------------------------------------------
# dropout mask: a counter-based hash, the same bits here and in the kernels
# ---------------------------------------------------------------------------

def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2**32 for int64 a in [0, 2**32) and a constant b < 2**32.
    b is split into 16-bit halves so that no product leaves int64."""
    lo, hi = b & 0xFFFF, b >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _MASK32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer bijection (the "lowbias32" finaliser) on int64
    tensors holding values in [0, 2**32); ``mix32`` in the CUDA source."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def dropout_threshold(drop_rate: float) -> int:
    """Keep a weight when its 32-bit hash is >= this (``_dropout_mask``)."""
    return min(int(drop_rate * 2 ** 32), 2 ** 32 - 1)


def dropout_inv_keep(drop_rate: float) -> float:
    return 1.0 / max(1.0 - drop_rate, 1e-6)


def dropout_keep_mask(seed: torch.Tensor, n: int, nhead: int, t: int,
                      drop_rate: float) -> torch.Tensor:
    """bool [n, nhead, t, t]: whether softmax weight (window, head, query,
    key) survives dropout at `drop_rate`. seed: int32 tensor of one element.
    hash = mix32(mix32(query * t + key) ^ mix32(mix32(seed) ^ (window *
    nhead + head))), in uint32 arithmetic."""
    dev = seed.device
    s = mix32(seed.reshape(1).long() & _MASK32)
    wh = torch.arange(n * nhead, device=dev, dtype=torch.int64).reshape(n, nhead, 1, 1)
    key = mix32(s ^ wh)
    ctr = mix32(torch.arange(t * t, device=dev, dtype=torch.int64).reshape(t, t))
    return mix32(ctr ^ key) >= dropout_threshold(drop_rate)


def pack_keep_bits(keep: torch.Tensor) -> torch.Tensor:
    """bool [N, H, T, T] -> uint32 [N, H, TT, TT, 8] with TT = ceil(T / 16),
    the layout the bf16 train forward kernel writes: per 16 x 16 tile (rt,
    kt) of (query, key), 8 words in the tensor cores' fragment layout, as a
    warp's ballots give them: bit 4 g + t of word (2 nt + r) * 2 + x is
    keep[n, h, 16 rt + g + 8 r, 16 kt + 8 nt + 2 t + x]. Rows and keys past
    T are 0."""
    n, h, t, _ = keep.shape
    tt = -(-t // 16)
    padded = torch.zeros(n, h, 16 * tt, 16 * tt, dtype=torch.int64, device=keep.device)
    padded[:, :, :t, :t] = keep
    # query 16 rt + 8 r + g, key 16 kt + 8 nt + 2 t + x -> [rt, kt, nt, r, x, g, t]
    tiles = padded.reshape(n, h, tt, 2, 8, tt, 2, 4, 2).permute(0, 1, 2, 5, 6, 3, 8, 4, 7)
    place = torch.ones(32, dtype=torch.int64, device=keep.device) << torch.arange(
        32, device=keep.device)
    words = (tiles.reshape(n, h, tt, tt, 8, 32) * place).sum(-1)
    # to uint32 through int32 (two's complement): no uint32 arithmetic needed
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32).view(
        torch.uint32)


def unpack_keep_bits(bits: torch.Tensor, t: int) -> torch.Tensor:
    """The inverse of ``pack_keep_bits``: uint32 [N, H, TT, TT, 8] -> bool
    [N, H, T, T]."""
    n, h, tt = bits.shape[:3]
    words = bits.view(torch.int32).to(torch.int64) & _MASK32
    b = (words[..., None] >> torch.arange(32, device=bits.device)) & 1
    b = b.reshape(n, h, tt, tt, 2, 2, 2, 8, 4).permute(0, 1, 2, 5, 7, 3, 4, 8, 6)
    return b.reshape(n, h, 16 * tt, 16 * tt)[:, :, :t, :t].bool()


def keep_bits_shape(n: int, nhead: int, t: int) -> tuple:
    """The shape of the keep bits of [n, t, 3C] packed rows and nhead heads."""
    tt = -(-t // 16)
    return n, nhead, tt, tt, 8


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _live_windows(n: int, nw: torch.Tensor, device) -> torch.Tensor:
    """bool [n]: window rank within its sample < nw[sample]."""
    wps = n // nw.shape[0]
    rank = torch.arange(n, device=device)
    return (rank % wps) < nw.to(device).repeat_interleave(wps)


def _attention_core(q, k, v, bias, nhead, keep=None, inv_keep=1.0):
    """softmax(q_h k_h^T + bias) v_h per window and head, in float32.
    q, k, v [N, T, C]; bias [N, T]; keep bool [N, H, T, T] or None."""
    n, t, c = q.shape
    hd = c // nhead
    q, k, v = (x.float().reshape(n, t, nhead, hd) for x in (q, k, v))
    logits = torch.einsum('nthd,nshd->nhts', q, k) + bias.float()[:, None, None, :]
    attn = torch.softmax(logits, dim=-1)
    if keep is not None:
        attn = attn * (keep.float() * inv_keep)
    return torch.einsum('nhts,nshd->nthd', attn, v).reshape(n, t, c)


def _attention_plain(packed, bias, nhead, nw, keep=None, inv_keep=1.0):
    c = packed.shape[2] // 3
    out = _attention_core(packed[..., :c], packed[..., c:2 * c], packed[..., 2 * c:],
                          bias, nhead, keep, inv_keep)
    if nw is not None:
        out = torch.where(_live_windows(packed.shape[0], nw, packed.device)[:, None, None],
                          out, 0)
    return out.to(packed.dtype)


def window_attention_packed_plain(packed: torch.Tensor, bias: torch.Tensor,
                                  nhead: int, nw: torch.Tensor | None = None):
    """Plain PyTorch version. packed [N, T, 3C] = q|k|v, bias [N, T] (0 or
    -1e9), nw int32 [B] with B dividing N: windows whose rank within their
    sample is >= nw[sample] give zeros. Computes in float32 and returns
    [N, T, C] in packed's dtype."""
    return _attention_plain(packed, bias, nhead, nw)


def fused_window_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 bias: torch.Tensor, nhead: int) -> torch.Tensor:
    """Plain PyTorch version of the unpacked op: q, k, v [N, T, C], bias
    [N, T] (0 or -1e9). Computes in float32 and returns [N, T, C] in q's
    dtype. Every window is computed; a fully padded window gives the mean of
    its own v rows, as ``reference_window_attention`` does."""
    return _attention_core(q, k, v, bias, nhead).to(q.dtype)


def window_attention_packed_train_plain(packed: torch.Tensor, bias: torch.Tensor,
                                        seed: torch.Tensor, nw: torch.Tensor | None,
                                        nhead: int, drop_rate: float) -> torch.Tensor:
    """Plain PyTorch version of the train attention: the eval plain version
    with dropout on the softmax weights (the mask of ``dropout_keep_mask``,
    kept weights scaled by 1 / (1 - drop_rate)). Differentiable by autograd;
    at drop_rate 0 it is ``window_attention_packed_plain``."""
    keep = None
    if drop_rate > 0.0:
        n, t, _ = packed.shape
        with torch.no_grad():
            keep = dropout_keep_mask(seed, n, nhead, t, drop_rate)
    return _attention_plain(packed, bias, nhead, nw, keep, dropout_inv_keep(drop_rate))


def _stats_plain(packed, bias, nhead):
    """[N, H, T, 2] float32: per query row the softmax's max logit and sum
    of exp(logit - max), as the train forward kernel writes them."""
    n, t, c3 = packed.shape
    c = c3 // 3
    q, k = (x.float().reshape(n, t, nhead, c // nhead)
            for x in (packed[..., :c], packed[..., c:2 * c]))
    logits = torch.einsum('nthd,nshd->nhts', q, k) + bias.float()[:, None, None, :]
    m = logits.amax(-1)
    return torch.stack([m, torch.exp(logits - m[..., None]).sum(-1)], -1)


def window_attention_train_forward_plain(packed, bias, seed, nw, nhead: int, drop_rate: float):
    """Plain version of ``window_attention_train_forward``, its interface on
    the CPU: (out, stats, bits). stats is (0, 1) on the windows past nw,
    where the kernel computes nothing; bits are the packed keep mask
    (``pack_keep_bits``) for bfloat16 at drop_rate > 0, zero past nw, else
    None, as the kernels store them."""
    out = window_attention_packed_train_plain(packed, bias, seed, nw, nhead, drop_rate)
    n, t, _ = packed.shape
    live = _live_windows(n, nw, packed.device)
    stats = torch.where(live[:, None, None, None], _stats_plain(packed, bias, nhead),
                        torch.tensor([0.0, 1.0], device=packed.device))
    bits = None
    if packed.dtype == torch.bfloat16 and drop_rate > 0.0:
        keep = dropout_keep_mask(seed, n, nhead, t, drop_rate) & live[:, None, None, None]
        bits = pack_keep_bits(keep)
    return out, stats, bits


def window_attention_train_backward_plain(packed, bias, seed, nw, out, stats, bits, gout,
                                          nhead: int, drop_rate: float) -> torch.Tensor:
    """Plain version of ``window_attention_train_backward``, its interface
    on the CPU: dq|dk|dv [N, T, 3C] in packed's dtype, computed in float32
    as the kernels compute them: P = exp(q k^T + bias - m) / l from the
    forward's stats, the keep mask from the stored bits (else, at
    drop_rate > 0, hashed from the seed, as the float32 kernels do),
    D = dO . O from the forward's output, dS = P (Z dP / (1 - p) - D); zero
    on the windows past nw."""
    n, t, c3 = packed.shape
    c = c3 // 3
    hd = c // nhead
    q, k, v = (x.float().reshape(n, t, nhead, hd) for x in packed.split(c, -1))
    logits = torch.einsum('nthd,nshd->nhts', q, k) + bias.float()[:, None, None, :]
    st = stats.float()
    p = torch.exp(logits - st[..., :1]) / st[..., 1:]
    zs = 1.0
    if drop_rate > 0.0:
        keep = unpack_keep_bits(bits, t) if bits is not None else \
            dropout_keep_mask(seed, n, nhead, t, drop_rate)
        zs = keep.float() * dropout_inv_keep(drop_rate)
    g = gout.float().reshape(n, t, nhead, hd)
    d = (g * out.float().reshape(n, t, nhead, hd)).sum(-1).permute(0, 2, 1)[..., None]
    dv = torch.einsum('nhts,nthd->nshd', p * zs, g)
    ds = p * (torch.einsum('nthd,nshd->nhts', g, v) * zs - d)
    dq = torch.einsum('nhts,nshd->nthd', ds, k)
    dk = torch.einsum('nhts,nthd->nshd', ds, q)
    dpk = torch.cat([x.reshape(n, t, c) for x in (dq, dk, dv)], -1)
    live = _live_windows(n, nw, packed.device)
    return torch.where(live[:, None, None], dpk, 0).to(packed.dtype)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

def _check_cuda_args(packed, bias, nhead, nw, seed=None):
    if packed.dim() != 3 or packed.shape[2] % 3:
        raise ValueError(f'packed must be [N, T, 3C], got {tuple(packed.shape)}')
    n, t, c3 = packed.shape
    c = c3 // 3
    if packed.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'packed must be float32 or bfloat16, got {packed.dtype}')
    if c % nhead or c // nhead not in KERNEL_HEAD_DIMS:
        raise ValueError(f'C={c} with nhead={nhead}: head_dim must be one of '
                         f'{KERNEL_HEAD_DIMS}')
    if bias.shape != (n, t) or bias.dtype != torch.float32:
        raise ValueError(f'bias must be float32 [{n}, {t}], got '
                         f'{bias.dtype} {tuple(bias.shape)}')
    if nw.dim() != 1 or nw.dtype != torch.int32 or nw.shape[0] == 0 \
            or n % nw.shape[0]:
        raise ValueError(f'nw must be int32 [B] with B dividing N={n}, got '
                         f'{nw.dtype} {tuple(nw.shape)}')
    tensors = [('packed', packed), ('bias', bias), ('nw', nw)]
    if seed is not None:
        if seed.numel() != 1 or seed.dtype != torch.int32:
            raise ValueError(f'seed must be one int32, got {seed.dtype} {tuple(seed.shape)}')
        tensors.append(('seed', seed))
    for name, x in tensors:
        if x.device != packed.device:
            raise ValueError(f'{name} is on {x.device}, packed on {packed.device}')
        if not x.is_contiguous():
            raise ValueError(f'{name} must be contiguous')


def _raise_on_error(lib, rc: int, what: str, error_fn: str):
    if rc != 0:
        err = getattr(lib, error_fn)
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f'{what} launch failed: {err(rc).decode()} ({rc})')


def _dtype_code(x: torch.Tensor) -> int:
    return 0 if x.dtype == torch.float32 else 1


def _launch_cuda(packed, bias, nhead, nw):
    _check_cuda_args(packed, bias, nhead, nw)
    lib = _build.load('window_attention')
    fn = lib.window_attention_packed
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n, t, c3 = packed.shape
    out = torch.empty((n, t, c3 // 3), dtype=packed.dtype, device=packed.device)
    if n == 0 or t == 0:
        return out
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream(packed.device).cuda_stream
        rc = fn(packed.data_ptr(), bias.data_ptr(), nw.data_ptr(), out.data_ptr(),
                n, t, c3 // 3, nhead, n // nw.shape[0], _dtype_code(packed), stream)
    _raise_on_error(lib, rc, 'window_attention_packed', 'window_attention_error_string')
    window_attention_packed.launches += 1
    return out


def _check_unpacked_args(q, k, v, bias, nhead):
    """The JAX op's preconditions (``ops/attention.py:230-233``) and the
    kernel's head widths; raised for every device."""
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f'q, k and v must be [N, T, C] of one shape, got '
                         f'{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}')
    n, t, c = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f'q, k and v must be all float32 or all bfloat16, got '
                        f'{q.dtype}, {k.dtype}, {v.dtype}')
    if c % nhead or c // nhead not in KERNEL_HEAD_DIMS:
        raise ValueError(f'C={c} with nhead={nhead}: head_dim must be one of '
                         f'{KERNEL_HEAD_DIMS}')
    g = attention_group(t, c, q.element_size())
    if n % g:
        raise ValueError(f'N={n} must be a multiple of attention_group({t}, {c}) = {g}')
    if t % 16:
        raise ValueError(f'window max_tokens must be a multiple of 16, got {t}')
    if tuple(bias.shape) != (n, t):
        raise ValueError(f'bias must be [{n}, {t}], got {tuple(bias.shape)}')


def _launch_unpacked(q, k, v, bias, nhead):
    if bias.dtype != torch.float32:
        raise ValueError(f'bias must be float32 on the GPU, got {bias.dtype}')
    for name, x in (('q', q), ('k', k), ('v', v), ('bias', bias)):
        if x.device != q.device:
            raise ValueError(f'{name} is on {x.device}, q on {q.device}')
        if not x.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
    lib = _build.load('window_attention')
    fn = lib.window_attention_unpacked
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n, t, c = q.shape
    out = torch.empty_like(q)
    if n == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
                n, t, c, nhead, _dtype_code(q), stream)
    _raise_on_error(lib, rc, 'fused_window_attention', 'window_attention_error_string')
    fused_window_attention.launches += 1
    return out


MMA_MAX_HEADS = 8


def _check_mma_args(nhead: int, **tensors):
    """The bf16 train kernels run one warp per head and stage rows with
    16-byte copies: nhead <= 8, C a multiple of 8, every bf16 operand
    16-byte aligned."""
    c = tensors['packed'].shape[2] // 3
    if nhead > MMA_MAX_HEADS or c % 8:
        raise ValueError(f'the bfloat16 train kernels take nhead <= {MMA_MAX_HEADS} and C a '
                         f'multiple of 8, got nhead={nhead}, C={c}')
    for name, x in tensors.items():
        if x.data_ptr() % 16:
            raise ValueError(f'{name} must be 16-byte aligned for the bfloat16 train kernels')


def train_forward_bound(plain_out: torch.Tensor, packed: torch.Tensor, nhead: int,
                        drop_rate: float) -> torch.Tensor:
    """Elementwise bound on |bf16 kernel - plain| for the train forward,
    and at drop_rate 0 for the eval kernels (B1, B4: packed = q|k|v),
    [N, T, C] float32. The plain version keeps the softmax weights in
    float32; the bf16 kernel (as the TPU kernel, ``attn.astype(v.dtype)``)
    rounds each weight, dropout scale included, to bf16 (relative 2^-8)
    before P V, which moves a head's output by at most 2^-8 / (1 - p) times
    the largest |v| of that window and head (the weights sum to 1); and both
    round the output once to bf16, 2^-7 of it at most together:
    |err| <= 2^-7 |plain| + 2^-8 / (1 - p) max|v|."""
    n, t, c3 = packed.shape
    c = c3 // 3
    vmax = packed[..., 2 * c:].float().abs().reshape(n, t, nhead, c // nhead).amax(dim=(1, 3))
    vmax = vmax[:, None, :, None].expand(n, t, nhead, c // nhead).reshape(n, t, c)
    return 2.0 ** -7 * plain_out.float().abs() + 2.0 ** -8 * dropout_inv_keep(drop_rate) * vmax


# Block shapes of the bf16 train kernels, chosen by (head_dim, T) alone.
# B2f: a block serves 64 query rows (4 row tiles of 16) of TRAIN_FWD_HEADS
# (2) heads where T lies in TRAIN_FWD_ROWS64[head_dim] (lo, hi), else 16 rows
# of all heads (the PR 4 block); B2b runs in one pass where T lies in
# TRAIN_BWD_ONE_PASS[head_dim], else in two. The ranges come from chip_smoke
# phase 3b, which times both choices at every main-path shape in one call
# (PERF.md): at head_dim 6 and 12 the forward's hash, shared by a block's
# heads, favours 8 heads a block over 64 rows (at head_dim 6 a 64-row block
# of 8 warps cannot be had: its 2 heads' 12 columns are no 16-byte rows).
TRAIN_FWD_ROWS64 = {6: None, 12: None, 24: (16, 800), 48: (16, 800)}
TRAIN_BWD_ONE_PASS = {6: (1, 128), 12: (1, 256), 24: (1, 256), 48: (1, 256)}
TRAIN_FWD_HEADS = 2                                # heads of a 64-row forward block
_FWD_KEY_TILE = {16: {6: 64, 12: 64, 24: 32, 48: 16}, 64: {6: 64, 12: 64, 24: 32, 48: 32}}
_BWD_KEY_TILES_PER_WARP = {6: 2, 12: 2, 24: 1, 48: 1}    # key_tiles_per_warp in the source
_MAX_WARPS = 16
_ONE_PASS_MAX_T = 256                                    # the one-pass block's shared memory


def _in_range(t: int, bounds) -> bool:
    return bounds is not None and bounds[0] <= t <= bounds[1]


def _head_group(nhead: int, hd: int, most: int) -> int:
    """The largest divisor of nhead that is at most `most` and whose
    columns (heads x hd) are a multiple of 8, the kernels' 16-byte row
    pieces; 0 if there is none."""
    for h in range(min(most, nhead), 0, -1):
        if nhead % h == 0 and h * hd % 8 == 0:
            return h
    return 0


def train_forward_shape(t: int, hd: int, nhead: int, rows: int | None = None):
    """(heads, row_tiles, key_tile) of the bf16 train forward's blocks: a
    block serves `heads` heads and row_tiles x 16 query rows and streams
    key_tile key rows a tile. rows: 64 or 16 query rows a block, None for
    the table's choice."""
    heads64 = _head_group(nhead, hd, TRAIN_FWD_HEADS)
    if rows is None:
        rows = 64 if heads64 and _in_range(t, TRAIN_FWD_ROWS64[hd]) else 16
    if rows == 64 and heads64:
        return heads64, min(4, -(-t // 16)), _FWD_KEY_TILE[64][hd]
    if rows == 16:
        return nhead, 1, _FWD_KEY_TILE[16][hd]
    raise ValueError(f'no {rows}-row train forward block for head_dim {hd}, nhead {nhead}')


def train_backward_shape(t: int, hd: int, nhead: int, one_pass: bool | None = None):
    """(heads, warps a head) of the one-pass bf16 train backward's blocks,
    or (0, 0) for the two-pass backward. one_pass: None for the table's
    choice."""
    warps = -(-(-(-t // 16)) // _BWD_KEY_TILES_PER_WARP[hd])
    heads = _head_group(nhead, hd, _MAX_WARPS // warps) if t <= _ONE_PASS_MAX_T else 0
    if one_pass is None:
        one_pass = heads > 0 and _in_range(t, TRAIN_BWD_ONE_PASS[hd])
    if not one_pass:
        return 0, 0
    if not heads:
        raise ValueError(f'no one-pass train backward for T={t}, head_dim {hd}, nhead {nhead}')
    return heads, warps


def window_attention_train_forward(packed, bias, seed, nw, nhead: int, drop_rate: float, *,
                                   rows: int | None = None):
    """The train forward kernel (B2f). Returns (out [N, T, C] in packed's
    dtype, stats [N, nhead, T, 2] float32 = per query row the softmax's max
    logit and sum of exp(logit - max), bits): bits is uint32
    ``keep_bits_shape``, the keep mask in ``pack_keep_bits``' layout, written for
    the windows below nw (the rest is not written), for bfloat16 at
    drop_rate > 0, else None. float32 runs FMA bodies, bfloat16 tensor
    cores (within ``train_forward_bound`` of the plain version) with the
    block shape ``train_forward_shape`` gives (`rows` overrides the table:
    chip_smoke times both shapes). ``.launches`` counts its launches. On a
    CPU tensor: ``window_attention_train_forward_plain``, not counted."""
    if packed.device.type == 'cpu':
        return window_attention_train_forward_plain(packed, bias, seed, nw, nhead, drop_rate)
    _check_cuda_args(packed, bias, nhead, nw, seed)
    lib = _build.load('window_attention_train')
    fn = lib.window_attention_train_forward
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                   + [ctypes.c_uint, ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    n, t, c3 = packed.shape
    c = c3 // 3
    dev = packed.device
    out = torch.empty((n, t, c), dtype=packed.dtype, device=dev)
    stats = torch.empty((n, nhead, t, 2), dtype=torch.float32, device=dev)
    bf16 = packed.dtype == torch.bfloat16
    bits = torch.empty(keep_bits_shape(n, nhead, t), dtype=torch.uint32, device=dev) \
        if bf16 and drop_rate > 0.0 else None
    if n == 0 or t == 0:
        return out, stats, bits
    heads = row_tiles = key_tile = 0
    if bf16:
        _check_mma_args(nhead, packed=packed, out=out)
        heads, row_tiles, key_tile = train_forward_shape(t, c // nhead, nhead, rows)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(packed.data_ptr(), bias.data_ptr(), nw.data_ptr(), seed.data_ptr(),
                out.data_ptr(), stats.data_ptr(), 0 if bits is None else bits.data_ptr(),
                n, t, c, nhead, n // nw.shape[0], dropout_threshold(drop_rate),
                dropout_inv_keep(drop_rate), _dtype_code(packed), heads, row_tiles, key_tile,
                stream)
    _raise_on_error(lib, rc, 'window_attention_train_forward',
                    'window_attention_train_error_string')
    window_attention_train_forward.launches += 1
    return out, stats, bits


def window_attention_train_backward(packed, bias, seed, nw, out, stats, bits, gout,
                                    nhead: int, drop_rate: float, *,
                                    one_pass: bool | None = None) -> torch.Tensor:
    """The train backward kernels (B2b). out, stats and bits are the
    forward's; gout [N, T, C] is the cotangent of out. Returns dpacked
    [N, T, 3C] = dq|dk|dv in packed's dtype, zero for windows past nw.
    float32: FMA bodies in two passes (dq, then dk and dv), the mask hashed
    from the seed. bfloat16: tensor cores, the mask read from the stored
    bits, in one pass or two as ``train_backward_shape`` gives (`one_pass`
    overrides the table: chip_smoke times both), no atomics, the same bits
    from run to run. ``.launches`` counts one per backward, however many
    kernels it runs. On a CPU tensor:
    ``window_attention_train_backward_plain``, not counted."""
    if packed.device.type == 'cpu':
        return window_attention_train_backward_plain(packed, bias, seed, nw, out, stats, bits,
                                                     gout, nhead, drop_rate)
    _check_cuda_args(packed, bias, nhead, nw, seed)
    n, t, c3 = packed.shape
    c = c3 // 3
    bf16 = packed.dtype == torch.bfloat16
    want = [('out', out, (n, t, c), packed.dtype), ('gout', gout, (n, t, c), packed.dtype),
            ('stats', stats, (n, nhead, t, 2), torch.float32)]
    if bf16 and drop_rate > 0.0:
        want.append(('bits', bits, keep_bits_shape(n, nhead, t), torch.uint32))
    elif bits is not None:
        raise ValueError('bits are stored only by the bfloat16 forward at drop_rate > 0')
    for name, x, shape, dtype in want:
        if x is None or tuple(x.shape) != shape or x.dtype != dtype \
                or x.device != packed.device or not x.is_contiguous():
            got = 'None' if x is None else f'{x.dtype} {tuple(x.shape)} on {x.device}'
            raise ValueError(f'{name} must be a contiguous {dtype} {shape} on '
                             f'{packed.device}, got {got}')
    lib = _build.load('window_attention_train')
    fn = lib.window_attention_train_backward
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                   + [ctypes.c_uint, ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    dpacked = torch.empty_like(packed)
    if n == 0 or t == 0:
        return dpacked
    heads = warps = 0
    if bf16:
        _check_mma_args(nhead, packed=packed, out=out, gout=gout, dpacked=dpacked)
        heads, warps = train_backward_shape(t, c // nhead, nhead, one_pass)
    delta = None if heads else torch.empty((n, nhead, t), dtype=torch.float32,
                                           device=packed.device)
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream(packed.device).cuda_stream
        rc = fn(packed.data_ptr(), bias.data_ptr(), nw.data_ptr(), seed.data_ptr(),
                0 if bits is None else bits.data_ptr(), out.data_ptr(), gout.data_ptr(),
                stats.data_ptr(), 0 if delta is None else delta.data_ptr(), dpacked.data_ptr(),
                n, t, c, nhead, n // nw.shape[0], dropout_threshold(drop_rate),
                dropout_inv_keep(drop_rate), _dtype_code(packed), heads, warps, stream)
    _raise_on_error(lib, rc, 'window_attention_train_backward',
                    'window_attention_train_error_string')
    window_attention_train_backward.launches += 1
    return dpacked


class _WindowAttentionTrain(torch.autograd.Function):
    """The CUDA train attention as an autograd Function: forward and
    backward kernels, residuals (packed, bias, seed, nw, out, stats and the
    keep bits, None where the forward stores none)."""

    @staticmethod
    def forward(ctx, packed, bias, seed, nw, nhead, drop_rate):
        out, stats, bits = window_attention_train_forward(packed, bias, seed, nw, nhead,
                                                          drop_rate)
        ctx.save_for_backward(packed, bias, seed, nw, out, stats, bits)
        ctx.nhead, ctx.drop_rate = nhead, drop_rate
        return out

    @staticmethod
    def backward(ctx, gout):
        packed, bias, seed, nw, out, stats, bits = ctx.saved_tensors
        dpacked = window_attention_train_backward(packed, bias, seed, nw, out, stats, bits,
                                                  gout.contiguous(), ctx.nhead, ctx.drop_rate)
        return dpacked, None, None, None, None, None


def window_attention_packed(packed: torch.Tensor, bias: torch.Tensor,
                            nhead: int, nw: torch.Tensor) -> torch.Tensor:
    """Packed window attention, [N, T, 3C] q|k|v -> [N, T, C].

    On a CUDA tensor: the CUDA kernel, output in the input's dtype;
    ``window_attention_packed.launches`` counts its launches. bfloat16 with
    C a multiple of 8 and packed 16-byte aligned (every model shape) runs on
    tensor cores with float32 sums and rounds the softmax weights to bf16
    before P V, as the TPU kernel does: within ``train_forward_bound(plain,
    packed, nhead, 0.0)`` of the plain version. float32, and bfloat16 at
    other widths, runs the FMA body (float32 sums; in float32 within 1e-5
    of the plain version). On a CPU tensor: ``window_attention_packed_plain``."""
    if packed.is_cuda:
        return _launch_cuda(packed, bias, nhead, nw)
    if packed.device.type == 'cpu':
        return window_attention_packed_plain(packed, bias, nhead, nw)
    raise NotImplementedError(f'no window attention for device {packed.device}')


def fused_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor, nhead: int) -> torch.Tensor:
    """Window attention on unpacked q, k, v [N, T, C] (q cosine-normalised
    and tau-scaled, k normalised), bias [N, T] additive (0 valid, -1e9
    padded) -> [N, T, C] in q's dtype. N must be a multiple of
    ``attention_group(T, C, itemsize)`` and T of 16, as for the JAX op;
    head_dim must be one of ``KERNEL_HEAD_DIMS``.

    On a CUDA tensor: the CUDA kernel; its launches are counted in
    ``fused_window_attention.launches``. bfloat16 with C a multiple of 8 and
    q, k and v 16-byte aligned runs on tensor cores, within
    ``train_forward_bound`` at rate 0 of the plain version (the softmax
    weights rounded to bf16 before P V, as the TPU kernel does); float32
    runs the FMA body in float32, and so does bfloat16 with C not a multiple
    of 8 (a head count no model uses) or operands that are not 16-byte
    aligned. On a CPU tensor: ``fused_window_attention_plain``."""
    _check_unpacked_args(q, k, v, bias, nhead)
    if q.is_cuda:
        return _launch_unpacked(q, k, v, bias, nhead)
    if q.device.type == 'cpu':
        return fused_window_attention_plain(q, k, v, bias, nhead)
    raise NotImplementedError(f'no window attention for device {q.device}')


def window_attention_packed_train(packed: torch.Tensor, bias: torch.Tensor,
                                  seed: torch.Tensor, nw: torch.Tensor, nhead: int,
                                  drop_rate: float) -> torch.Tensor:
    """Differentiable packed window attention with attention dropout, the
    training core of every SWFormer layer. seed: int32 tensor of one element
    on packed's device, nw int32 [B] true window counts.

    On a CUDA tensor: the train kernels (``window_attention_train_forward``
    and, in the backward, ``window_attention_train_backward``). On a CPU
    tensor: ``window_attention_packed_train_plain``."""
    if packed.is_cuda:
        return _WindowAttentionTrain.apply(packed, bias, seed, nw, nhead, float(drop_rate))
    if packed.device.type == 'cpu':
        return window_attention_packed_train_plain(packed, bias, seed, nw, nhead, drop_rate)
    raise NotImplementedError(f'no window attention for device {packed.device}')


window_attention_packed.launches = 0
fused_window_attention.launches = 0
window_attention_train_forward.launches = 0
window_attention_train_backward.launches = 0

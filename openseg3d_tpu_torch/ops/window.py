"""Sparse window partition + region batching (SST/SWFormer machinery).

Counterpart of ``openseg3d_tpu/ops/window.py``, batched over the leading
sample axis (the JAX package vmaps a per-sample function). Per shift: assign
each voxel a window, bucket windows by occupancy into levels with per-level
token caps and window capacities, drop the overflow, and give each kept voxel
a slot in its level's [W_l * T_l] buffer.

Sort stability: the JAX package sorts window ids with an unstable sort
(``window.py:133``); here ``torch.sort(stable=True)`` orders voxels of one
window by their row. Window ranks within a level follow window ids either
way, so each voxel's window and each window's voxel set are the same in both
packages; only the token order inside a window may differ, and attention does
not depend on it.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch

from .attention import attention_group
from .scatter import take_rows_or_zero

INT32_MAX = 2 ** 31 - 1


class LevelSpec(NamedTuple):
    max_tokens: int      # T_l
    lower: int           # occupancy range [lower, upper)
    upper: int
    num_windows: int     # static window capacity W_l


class ShiftPartition(NamedTuple):
    """Per-shift result. All tensors [B, V] unless noted."""
    scatter_idx: tuple          # per level: slot into W_l*T_l, -1 elsewhere (int64)
    level: torch.Tensor         # bucket level, -1 for dropped/invalid
    coors_in_win: torch.Tensor  # [B, V, 3] (z, y, x) position inside the window
    num_windows: torch.Tensor   # [B, L] true distinct windows per level (before the cap)


class WindowPartition(NamedTuple):
    shifts: tuple               # (ShiftPartition, ShiftPartition)
    keep: torch.Tensor          # [B, V] final keep mask (both shifts' caps)


def make_level_specs(batching_info, voxel_capacity: int, fraction) -> tuple:
    """Static per-level window capacities (``window.py:59-82``): level l holds
    up to fraction[l] * voxel_capacity tokens, rounded up to a multiple of
    the TPU kernel's window group so the shapes match the JAX package's."""
    specs = []
    if not isinstance(fraction, (list, tuple)):
        fraction = [fraction] * len(batching_info)
    if len(fraction) != len(batching_info):
        raise ValueError(f'fraction list has {len(fraction)} entries for '
                         f'{len(batching_info)} buckets')
    for (_, (max_tokens, lower, upper)), frac in zip(batching_info, fraction):
        w = max(1, int(math.ceil(frac * voxel_capacity / max_tokens)))
        g = attention_group(max_tokens)
        w = (w + g - 1) // g * g
        specs.append(LevelSpec(max_tokens, lower, upper, w))
    return tuple(specs)


def window_coords(coords, valid, sparse_shape, window_shape, do_shift: bool):
    """Per-voxel window id + in-window coords (z, y, x). coords [..., 3] zyx;
    sparse_shape (gz, gy, gx); window_shape (wx, wy, wz)."""
    gz, gy, gx = sparse_shape
    wx, wy, wz = window_shape
    sz = 0 if gz == wz else (wz // 2 if do_shift else 0)
    sx = wx // 2 if do_shift else 0
    sy = wy // 2 if do_shift else 0

    z = coords[..., 0] + sz
    y = coords[..., 1] + sy
    x = coords[..., 2] + sx
    nwy = int(math.ceil(gy / wy)) + 1
    nwz = int(math.ceil(gz / wz)) + 1
    win = (x // wx) * (nwy * nwz) + (y // wy) * nwz + (z // wz)
    win = torch.where(valid, win, INT32_MAX).int()
    ciw = torch.stack([z % wz, y % wy, x % wx], dim=-1).int()
    return win, ciw


def _bucket_level(occ, valid, levels: Sequence[LevelSpec]):
    lvl = torch.full_like(occ, -1)
    cap = torch.zeros_like(occ)
    for i, s in enumerate(levels):
        m = valid & (occ >= s.lower) & (occ < s.upper)
        lvl = torch.where(m, i, lvl)
        cap = torch.where(m, s.max_tokens, cap)
    return lvl, cap


class _SortedStructure(NamedTuple):
    order: torch.Tensor      # [B, V] original row of each sorted position
    inv: torch.Tensor        # [B, V] sorted position of each original row
    is_new: torch.Tensor     # [B, V] first row of its window (sorted order)


def _cummax(x):
    return torch.cummax(x, dim=-1).values


def _sorted_structure(win_id, valid) -> _SortedStructure:
    key = torch.where(valid, win_id, INT32_MAX)
    sk, order = torch.sort(key, dim=-1, stable=True)
    is_new = torch.cat([torch.ones_like(sk[:, :1], dtype=torch.bool),
                        sk[:, 1:] != sk[:, :-1]], dim=1)
    inv = torch.empty_like(order).scatter_(
        1, order, torch.arange(order.shape[1], device=order.device).expand_as(order))
    return _SortedStructure(order=order, inv=inv, is_new=is_new & (sk != INT32_MAX))


def _masked_inner_sorted(is_new, ms):
    """ms: 0/1 mask in sorted order -> (inner rank among mask-True rows of my
    window, first-kept-row flag), both in sorted order."""
    e = torch.cumsum(ms, dim=-1) - ms                # exclusive prefix
    run_e = _cummax(torch.where(is_new, e, -1))      # e at my window's first row
    inner_s = e - torch.clamp(run_e, min=0)
    return inner_s, (ms > 0) & (inner_s == 0)


def _single_shift_keep(ss: _SortedStructure, valid, levels):
    """Keep mask + level per voxel for one shift (``window.py:156-182``):
    occupancy by scans over the shift's sorted order."""
    ms = valid.long().gather(1, ss.order)
    e = torch.cumsum(ms, dim=-1) - ms                # exclusive valid prefix
    total = e[:, -1:] + ms[:, -1:]
    start_e = torch.clamp(_cummax(torch.where(ss.is_new, e, -1)), min=0)
    # e at the next window start: exclusive suffix-min of window-start marks
    g = torch.where(ss.is_new, e, INT32_MAX)
    sm = torch.flip(torch.cummin(torch.flip(g, [1]), dim=-1).values, [1])
    nxt = torch.cat([sm[:, 1:], torch.full_like(sm[:, :1], INT32_MAX)], dim=1)
    occ_s = torch.minimum(nxt, total) - start_e
    lvl_s, cap_s = _bucket_level(occ_s, ms > 0, levels)
    inner_s = e - start_e
    keep_s = (ms > 0) & (inner_s < cap_s)
    return keep_s.gather(1, ss.inv), lvl_s.gather(1, ss.inv)


def _shift_partition(ss: _SortedStructure, final, lvl, levels):
    """Per-level slot indices over the final kept set (``window.py:185-211``).
    A window's rank within its level counts the level's earlier windows in
    window-id order."""
    fin_s = final.long().gather(1, ss.order)
    lv = lvl.gather(1, ss.order)
    inner_s, first_s = _masked_inner_sorted(ss.is_new, fin_s)
    idx_cols, num_windows = [], []
    for li, s in enumerate(levels):
        marks = (first_s & (lv == li)).long()
        carried = _cummax(torch.where(marks > 0, torch.cumsum(marks, dim=-1) - 1, -1))
        ok = ((fin_s > 0) & (lv == li) & (carried >= 0) &
              (carried < s.num_windows) & (inner_s < s.max_tokens))
        idx_cols.append(torch.where(ok, carried * s.max_tokens + inner_s, -1))
        num_windows.append(marks.sum(dim=-1))
    idx = torch.stack(idx_cols, dim=-1)              # [B, V, L] sorted order
    idx = idx.gather(1, ss.inv[..., None].expand_as(idx))
    return (tuple(idx[..., li] for li in range(len(levels))),
            torch.stack(num_windows, dim=-1).int())


def batched_window_partition(coords, valid, sparse_shape, window_shape,
                             levels: Sequence[LevelSpec]) -> WindowPartition:
    """Full dual-shift partition of [B, V] voxels (``window.py:214-245``):
    shift-0 caps drop first, shift-1 caps drop from the survivors, and both
    shifts' slot indices are built over the surviving set."""
    win0, ciw0 = window_coords(coords, valid, sparse_shape, window_shape, False)
    win1, ciw1 = window_coords(coords, valid, sparse_shape, window_shape, True)
    ss0 = _sorted_structure(win0, valid)
    ss1 = _sorted_structure(win1, valid)

    keep0, lvl0 = _single_shift_keep(ss0, valid, levels)
    keep1, lvl1 = _single_shift_keep(ss1, keep0, levels)
    final = keep1  # keep1 already includes keep0

    s0_idx, s0_nw = _shift_partition(ss0, final, lvl0, levels)
    s1_idx, s1_nw = _shift_partition(ss1, final, lvl1, levels)
    shift0 = ShiftPartition(scatter_idx=s0_idx, level=torch.where(final, lvl0, -1),
                            coors_in_win=ciw0, num_windows=s0_nw)
    shift1 = ShiftPartition(scatter_idx=s1_idx, level=torch.where(final, lvl1, -1),
                            coors_in_win=ciw1, num_windows=s1_nw)
    return WindowPartition(shifts=(shift0, shift1), keep=final)


class _PermuteRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fwd_idx, bwd_idx):
        ctx.save_for_backward(bwd_idx)
        return take_rows_or_zero(x, fwd_idx)

    @staticmethod
    def backward(ctx, dout):
        (bwd_idx,) = ctx.saved_tensors
        permute_rows.backwards += 1
        return take_rows_or_zero(dout, bwd_idx), None, None


def permute_rows(x: torch.Tensor, fwd_idx: torch.Tensor, bwd_idx: torch.Tensor) -> torch.Tensor:
    """out[b, i] = x[b, fwd_idx[b, i]], a zero row where fwd_idx < 0, with
    the JAX package's gather-only gradient (``window.py:257-286``): bwd_idx
    is the inverse map (bwd_idx[b, j] = i iff fwd_idx[b, i] = j, -1 where
    row j is never read), and dx[b, j] = dout[b, bwd_idx[b, j]] (a zero row
    where bwd_idx < 0), where autograd's gradient of the forward gather
    would scatter-add rows. Every row of dx has at most one addend, so the
    two agree exactly. The JAX gather would clamp an index past the end;
    these indices come from the partition and are always in range.
    ``permute_rows.backwards`` counts the backwards run."""
    return _PermuteRows.apply(x, fwd_idx, bwd_idx)


permute_rows.backwards = 0


# flat <-> window scatter and gather (``window.py:293-328``); the model runs
# packed windows and uses none of the three, which are public for callers

def flat_to_window(feat: torch.Tensor, scatter_idx: torch.Tensor, spec: LevelSpec):
    """feat [B, V, C], scatter_idx [B, V] (a slot of the level's W x T
    buffer, -1 for none) -> [B, W, T, C], zeros where no row lands."""
    b, v, c = feat.shape
    size = spec.num_windows * spec.max_tokens
    tgt = torch.where(scatter_idx >= 0, scatter_idx, size).long()   # size: a trash row
    out = feat.new_zeros((b, size + 1, c)).scatter(1, tgt[..., None].expand(b, v, c), feat)
    return out[:, :size].reshape(b, spec.num_windows, spec.max_tokens, c)


def window_mask(scatter_idx: torch.Tensor, spec: LevelSpec):
    """[B, W, T] bool: which slots hold a real voxel."""
    b = scatter_idx.shape[0]
    size = spec.num_windows * spec.max_tokens
    tgt = torch.where(scatter_idx >= 0, scatter_idx, size).long()
    out = torch.zeros((b, size + 1), dtype=torch.bool, device=scatter_idx.device)
    out = out.scatter(1, tgt, True)
    return out[:, :size].reshape(b, spec.num_windows, spec.max_tokens)


def window_to_flat(win_feat: torch.Tensor, scatter_idx: torch.Tensor, spec: LevelSpec):
    """[B, W, T, C] -> [B, V, C], zero where scatter_idx == -1."""
    b, c = win_feat.shape[0], win_feat.shape[-1]
    flat = win_feat.reshape(b, spec.num_windows * spec.max_tokens, c)
    flat = torch.cat([flat, flat.new_zeros((b, 1, c))], dim=1)
    idx = torch.where(scatter_idx >= 0, scatter_idx, spec.num_windows * spec.max_tokens)
    return torch.gather(flat, 1, idx.long()[..., None].expand(-1, -1, c))


def positional_embedding(coors_in_win, window_shape, feat_dim: int,
                         pos_temperature: float = 1000.0,
                         normalize_pos: bool = False) -> torch.Tensor:
    """Sine/cosine in-window embedding (``window.py:330-369``), float32.
    coors_in_win [..., 3] (z, y, x)."""
    wx, wy, wz = window_shape
    ndim = 2 if wz in (0, 1) else 3
    z = coors_in_win[..., 0].float() - wz / 2
    y = coors_in_win[..., 1].float() - wy / 2
    x = coors_in_win[..., 2].float() - wx / 2
    if normalize_pos:
        x = x / wx * 2 * math.pi
        y = y / wy * 2 * math.pi
        z = z / wz * 2 * math.pi

    pos_length = feat_dim // ndim
    if pos_length % 2:
        raise ValueError(f'feat_dim {feat_dim} gives an odd embedding length')
    i = torch.arange(pos_length, dtype=torch.float32, device=coors_in_win.device)
    inv_freq = pos_temperature ** (2 * torch.floor(i / 2) / pos_length)
    lane_even = (torch.arange(pos_length, device=coors_in_win.device) % 2) == 0

    def embed(u):
        e = u[..., None] / inv_freq
        return torch.where(lane_even, torch.sin(e), torch.cos(e))

    parts = [embed(x), embed(y)] + ([embed(z)] if ndim == 3 else [])
    pe = torch.cat(parts, dim=-1)
    pad = feat_dim - pe.shape[-1]
    if pad:
        pe = torch.cat([pe, pe.new_zeros(pe.shape[:-1] + (pad,))], dim=-1)
    return pe

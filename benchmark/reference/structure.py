"""The reference's structure: sparse-conv rulebooks per UNet stage and the
dual-shift window partition with its occupancy levels.

Frozen copies of the port's ``ops/sparse_conv`` (structure builders),
``models/backbones/sparse_unet`` (stage capacities and plans), ``ops/window``
(partition, level capacities, positional embedding) and ``ops/attention``
(``attention_group``, whose rounding sets the level capacities). All of it
is integer work on the padded [B, V] layout, so its results are exact.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

INT32_MAX = 2 ** 31 - 1


class Rulebook(NamedTuple):
    """in_idx [B, K^3, Vo]: the input row of output o at offset k (-1 none);
    transpose [B, K^3, Vi] the same pairs from the input side."""
    in_idx: torch.Tensor
    transpose: torch.Tensor
    submanifold: bool = False


class DownsamplePlan(NamedTuple):
    out_coords: torch.Tensor
    rule: Rulebook
    inv_rule: Rulebook
    out_shape: tuple


class UNetPlans(NamedTuple):
    masks: tuple
    coords: tuple
    subm: tuple
    down: tuple
    shapes: tuple


def kernel_offsets(k: int, device) -> torch.Tensor:
    idx = torch.arange(k ** 3, device=device)
    return torch.stack([idx // (k * k), (idx // k) % k, idx % k], dim=1).int()


def linearize(coords, shape, valid=None):
    gz, gy, gx = shape
    z, y, x = coords[..., 0], coords[..., 1], coords[..., 2]
    ok = (z >= 0) & (z < gz) & (y >= 0) & (y < gy) & (x >= 0) & (x < gx)
    if valid is not None:
        ok = ok & valid
    return torch.where(ok, (z * gy + y) * gx + x, INT32_MAX).int()


def delinearize(keys, shape):
    gz, gy, gx = shape
    out = torch.stack([keys // (gy * gx), (keys % (gy * gx)) // gx, keys % gx], dim=-1).int()
    return torch.where((keys != INT32_MAX)[..., None], out, -1)


def sort_match(keys, queries):
    sk, order = torch.sort(keys, dim=-1, stable=True)
    pos = torch.clamp(torch.searchsorted(sk, queries.contiguous()), max=keys.shape[-1] - 1)
    hit = (sk.gather(-1, pos) == queries) & (queries != INT32_MAX)
    return torch.where(hit, order.gather(-1, pos), -1).int()


def subm_rulebook(coords, shape) -> Rulebook:
    b, v, _ = coords.shape
    valid = coords[..., 0] >= 0
    keys = linearize(coords, shape, valid)
    offs = kernel_offsets(3, coords.device) - 1
    q = linearize(coords[:, None] + offs[None, :, None], shape, valid[:, None])
    in_idx = sort_match(keys, q.reshape(b, 27 * v)).reshape(b, 27, v)
    return Rulebook(in_idx, in_idx.flip(1), True)


def downsample(coords, shape, out_capacity: int) -> DownsamplePlan:
    """Stride 2, kernel 3, padding 1: every output site one of whose 27
    taps holds an input, in ascending key order, past the capacity dropped."""
    b, v, _ = coords.shape
    valid = coords[..., 0] >= 0
    out_shape = tuple(int(math.floor((g + 2 - 3) / 2) + 1) for g in shape)
    offs = kernel_offsets(3, coords.device)
    t = coords[:, None] + 1 - offs[None, :, None]
    div = torch.all(t % 2 == 0, dim=-1)
    cand = linearize(torch.div(t, 2, rounding_mode='floor'), out_shape,
                     valid[:, None] & div).reshape(b, 27 * v)
    s, perm = torch.sort(cand, dim=-1, stable=True)
    ok_s = s != INT32_MAX
    is_new = torch.cat([torch.ones_like(ok_s[:, :1]), s[:, 1:] != s[:, :-1]], 1) & ok_s
    rank = torch.cumsum(is_new, -1) - 1
    ok = ok_s & (rank < out_capacity)
    out_keys = torch.full((b, out_capacity + 1), INT32_MAX, dtype=torch.int32,
                          device=coords.device)
    out_keys.scatter_(1, torch.where(is_new & ok, rank, out_capacity), s)
    out_coords = delinearize(out_keys[:, :out_capacity], out_shape)
    kk, vv = perm // v, perm % v
    rule = torch.full((b, 27 * out_capacity + 1), -1, dtype=torch.int32, device=coords.device)
    rule.scatter_(1, torch.where(ok, kk * out_capacity + rank, 27 * out_capacity), vv.int())
    rule = rule[:, :-1].reshape(b, 27, out_capacity)
    o_idx = torch.arange(out_capacity, device=coords.device).expand(b, 27, -1)
    k_idx = torch.arange(27, device=coords.device)[None, :, None]
    inv = torch.full((b, 27 * v + 1), -1, dtype=torch.int32, device=coords.device)
    inv.scatter_(1, torch.where(rule >= 0, k_idx * v + rule, 27 * v).reshape(b, -1),
                 o_idx.reshape(b, -1).int())
    inv = inv[:, :-1].reshape(b, 27, v)
    return DownsamplePlan(out_coords, Rulebook(rule, inv), Rulebook(inv, rule), out_shape)


def stage_capacities(max_voxels: int, ratios) -> list:
    return [max(128, int(-(-(max_voxels * r) // 128) * 128)) for r in ratios]


def unet_plans(coords, shape, capacities) -> UNetPlans:
    masks, cs, subm, downs, shapes = [], [], [], [], []
    for s in range(4):
        masks.append(coords[..., 0] >= 0)
        cs.append(coords)
        shapes.append(shape)
        subm.append(subm_rulebook(coords, shape))
        if s < 3:
            plan = downsample(coords, shape, capacities[s + 1])
            downs.append(plan)
            coords, shape = plan.out_coords, plan.out_shape
    return UNetPlans(tuple(masks), tuple(cs), tuple(subm), tuple(downs), tuple(shapes))


# --- window partition ------------------------------------------------------

class LevelSpec(NamedTuple):
    max_tokens: int
    lower: int
    upper: int
    num_windows: int


class ShiftPartition(NamedTuple):
    scatter_idx: tuple
    level: torch.Tensor
    coors_in_win: torch.Tensor
    num_windows: torch.Tensor


class WindowPartition(NamedTuple):
    shifts: tuple
    keep: torch.Tensor


def attention_group(max_tokens: int) -> int:
    """Windows per grid step of the TPU kernel; the level capacities are
    rounded up to a multiple of it."""
    g = max(1, 1024 // max_tokens)
    while 64 % g:
        g -= 1
    return g


def level_specs(batching_info: dict, capacity: int, fractions) -> tuple:
    """batching_info: {'0': {'max_tokens', 'batching_range'}, ...}."""
    levels = sorted(((int(k), v) for k, v in batching_info.items()), key=lambda kv: kv[0])
    if not isinstance(fractions, (list, tuple)):
        fractions = [fractions] * len(levels)
    out = []
    for (_, v), frac in zip(levels, fractions):
        t = int(v['max_tokens'])
        w = max(1, int(math.ceil(frac * capacity / t)))
        g = attention_group(t)
        out.append(LevelSpec(t, int(v['batching_range'][0]), int(v['batching_range'][1]),
                             (w + g - 1) // g * g))
    return tuple(out)


def _window_coords(coords, valid, shape, window, shift: bool):
    gz, gy, gx = shape
    wx, wy, wz = window
    sz = 0 if gz == wz else (wz // 2 if shift else 0)
    sx, sy = (wx // 2, wy // 2) if shift else (0, 0)
    z, y, x = coords[..., 0] + sz, coords[..., 1] + sy, coords[..., 2] + sx
    nwy, nwz = int(math.ceil(gy / wy)) + 1, int(math.ceil(gz / wz)) + 1
    win = torch.where(valid, (x // wx) * (nwy * nwz) + (y // wy) * nwz + (z // wz),
                      INT32_MAX).int()
    return win, torch.stack([z % wz, y % wy, x % wx], dim=-1).int()


def _sorted(win, valid):
    sk, order = torch.sort(torch.where(valid, win, INT32_MAX), dim=-1, stable=True)
    is_new = torch.cat([torch.ones_like(sk[:, :1], dtype=torch.bool), sk[:, 1:] != sk[:, :-1]], 1)
    inv = torch.empty_like(order).scatter_(
        1, order, torch.arange(order.shape[1], device=order.device).expand_as(order))
    return order, inv, is_new & (sk != INT32_MAX)


def _cummax(x):
    return torch.cummax(x, dim=-1).values


def _keep(ss, valid, levels):
    order, inv, is_new = ss
    ms = valid.long().gather(1, order)
    e = torch.cumsum(ms, -1) - ms
    total = e[:, -1:] + ms[:, -1:]
    start = torch.clamp(_cummax(torch.where(is_new, e, -1)), min=0)
    g = torch.where(is_new, e, INT32_MAX)
    sm = torch.flip(torch.cummin(torch.flip(g, [1]), dim=-1).values, [1])
    nxt = torch.cat([sm[:, 1:], torch.full_like(sm[:, :1], INT32_MAX)], 1)
    occ = torch.minimum(nxt, total) - start
    lvl = torch.full_like(occ, -1)
    cap = torch.zeros_like(occ)
    for i, s in enumerate(levels):
        m = (ms > 0) & (occ >= s.lower) & (occ < s.upper)
        lvl, cap = torch.where(m, i, lvl), torch.where(m, s.max_tokens, cap)
    keep = (ms > 0) & (e - start < cap)
    return keep.gather(1, inv), lvl.gather(1, inv)


def _slots(ss, final, lvl, levels):
    order, inv, is_new = ss
    fin = final.long().gather(1, order)
    lv = lvl.gather(1, order)
    e = torch.cumsum(fin, -1) - fin
    inner = e - torch.clamp(_cummax(torch.where(is_new, e, -1)), min=0)
    first = (fin > 0) & (inner == 0)
    cols, nws = [], []
    for li, s in enumerate(levels):
        marks = (first & (lv == li)).long()
        carried = _cummax(torch.where(marks > 0, torch.cumsum(marks, -1) - 1, -1))
        ok = ((fin > 0) & (lv == li) & (carried >= 0) & (carried < s.num_windows)
              & (inner < s.max_tokens))
        cols.append(torch.where(ok, carried * s.max_tokens + inner, -1))
        nws.append(marks.sum(-1))
    idx = torch.stack(cols, -1)
    idx = idx.gather(1, inv[..., None].expand_as(idx))
    return tuple(idx[..., li] for li in range(len(levels))), torch.stack(nws, -1).int()


def window_partition(coords, valid, shape, window, levels) -> WindowPartition:
    win0, ciw0 = _window_coords(coords, valid, shape, window, False)
    win1, ciw1 = _window_coords(coords, valid, shape, window, True)
    ss0, ss1 = _sorted(win0, valid), _sorted(win1, valid)
    keep0, lvl0 = _keep(ss0, valid, levels)
    final, lvl1 = _keep(ss1, keep0, levels)
    i0, n0 = _slots(ss0, final, lvl0, levels)
    i1, n1 = _slots(ss1, final, lvl1, levels)
    return WindowPartition((ShiftPartition(i0, torch.where(final, lvl0, -1), ciw0, n0),
                            ShiftPartition(i1, torch.where(final, lvl1, -1), ciw1, n1)), final)


def positional_embedding(ciw, window, dim: int, temperature: float = 1000.0):
    wx, wy, wz = window
    ndim = 2 if wz in (0, 1) else 3
    z = ciw[..., 0].float() - wz / 2
    y = ciw[..., 1].float() - wy / 2
    x = ciw[..., 2].float() - wx / 2
    n = dim // ndim
    i = torch.arange(n, dtype=torch.float32, device=ciw.device)
    inv_freq = temperature ** (2 * torch.floor(i / 2) / n)
    even = (torch.arange(n, device=ciw.device) % 2) == 0

    def embed(u):
        e = u[..., None] / inv_freq
        return torch.where(even, torch.sin(e), torch.cos(e))

    pe = torch.cat([embed(x), embed(y)] + ([embed(z)] if ndim == 3 else []), dim=-1)
    pad = dim - pe.shape[-1]
    return torch.cat([pe, pe.new_zeros(pe.shape[:-1] + (pad,))], -1) if pad else pe


def level_offsets(levels) -> tuple:
    offs = [0]
    for s in levels:
        offs.append(offs[-1] + s.num_windows * s.max_tokens)
    return tuple(offs)


def combined_index(sp: ShiftPartition, levels):
    offs = level_offsets(levels)
    comb = torch.full_like(sp.scatter_idx[0], -1)
    for li in range(len(levels)):
        idx = sp.scatter_idx[li]
        comb = torch.where(idx >= 0, idx + offs[li], comb)
    return comb

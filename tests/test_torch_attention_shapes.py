"""The bf16 eval attention kernel's block shapes (B1 packed, B4 unpacked):
every shape ``eval_shape`` gives, and the table's at every level of the
default config, against the kernel's limits, and the wrappers on the CPU.
The CUDA kernel in every block shape against the plain versions, and each
shape's shared memory through the kernel's own check, is in
tests/test_torch_cuda.py and chip_smoke.py (phases 3 and 3d).
"""

import numpy as np
import pytest
import torch

from openseg3d_tpu_torch.config import cfg_from_file
from openseg3d_tpu_torch.models.backbones.sparse_unet import stage_capacities
from openseg3d_tpu_torch.ops.attention import (EVAL_BLOCK_ROWS, EVAL_ROWS, KERNEL_HEAD_DIMS,
                                               attention_group, eval_launch_shapes, eval_rows,
                                               eval_shape, fused_window_attention,
                                               fused_window_attention_plain,
                                               window_attention_packed,
                                               window_attention_packed_plain)
from openseg3d_tpu_torch.ops.window import make_level_specs
from test_torch_attention import NHEAD, _packed_case, _unpacked_case


# the kernel's (head width, key tile) instantiations (BY_TILE in
# csrc/window_attention.cu) and its thread limit
KERNEL_TILES = {(6, 64), (12, 64), (24, 32), (48, 16), (48, 64)}
MAX_THREADS = 256


@pytest.mark.parametrize('hd', KERNEL_HEAD_DIMS)
def test_eval_shapes_fit_the_kernel(hd):
    """Every block shape eval_shape takes, forced and the table's, meets the
    kernel's limits: heads divide nhead with columns a multiple of 8, at
    most 256 threads, a (head width, key tile) the source instantiates; the
    row tiles cover the window's first rows; the table's shape is one of
    eval_launch_shapes'. (Each shape's shared memory is checked by the
    kernel itself, on the card: tests/test_torch_cuda.py.)"""
    for nhead in (1, 2, 4, 8, 16):
        if nhead * hd % 8:
            continue                        # the FMA body's widths: no launch shape
        for t in (16, 32, 48, 64, 100, 128, 256, 512, 800):
            shapes = eval_launch_shapes(t, hd, nhead)
            assert 16 in shapes and eval_rows(t, hd) in shapes, (nhead, t)
            assert eval_shape(t, hd, nhead) == eval_shape(t, hd, nhead, eval_rows(t, hd))
            for rows in EVAL_BLOCK_ROWS:
                try:
                    heads, row_tiles, key_tile = eval_shape(t, hd, nhead, rows)
                except ValueError:
                    assert rows not in shapes, (nhead, t, rows)
                    continue
                assert rows in shapes
                assert nhead % heads == 0 and heads * hd % 8 == 0
                assert 32 * heads * row_tiles <= MAX_THREADS
                assert 16 * row_tiles == min(rows, -(-t // 16) * 16)
                assert (hd, key_tile) in KERNEL_TILES
    assert all(lo <= hi for lo, hi, _ in EVAL_ROWS[hd])
    with pytest.raises(ValueError, match='48-row'):
        eval_shape(64, hd, NHEAD, 48)


def test_eval_rows_on_the_default_configs_levels():
    """The table on the default config's window levels (widths 48/96/192/384,
    8 heads): 32-row blocks of 4 heads at stage 1 from T = 32 and at stage 2
    below T = 256, 64-row blocks of 2 heads elsewhere, the 16-row block of 8
    heads at T = 16."""
    cfg = cfg_from_file('configs/waymo_one_sweep.yaml')
    caps = stage_capacities(cfg.RUNTIME.MAX_VOXELS_PER_SAMPLE, cfg.RUNTIME.STAGE_CAPACITY_RATIOS)
    got = {}
    for s, (info, width) in enumerate(zip(cfg.MODEL.BATCHING_INFO, (48, 96, 192, 384))):
        levels = [(k, (info[k]['max_tokens'], *info[k]['batching_range']))
                  for k in sorted(info, key=int)]
        for spec in make_level_specs(levels, caps[s], cfg.RUNTIME.WINDOW_BUCKET_FRACTIONS[s]):
            got[(s + 1, spec.max_tokens)] = eval_shape(spec.max_tokens, width // NHEAD, NHEAD)
    assert got[(1, 16)] == (8, 1, 64)
    assert got[(1, 800)] == (4, 2, 64)
    assert got[(2, 128)] == (4, 2, 64) and got[(2, 256)] == (2, 4, 64)
    assert got[(3, 32)] == (2, 2, 32) and got[(3, 64)] == (2, 4, 32)
    assert got[(4, 800)] == (2, 4, 64)
    assert len(got) == 23


def test_eval_wrappers_on_cpu_run_the_plain_versions_uncounted():
    """On CPU tensors the public ops run the plain versions, not counted:
    the block shape is the card's alone."""
    rng = np.random.RandomState(1)
    packed, bias, nw = _packed_case(rng, 1, 8, 16, 48, [5])
    args = (torch.from_numpy(packed).bfloat16(), torch.from_numpy(bias), NHEAD,
            torch.from_numpy(nw))
    q, k, v, b = (torch.from_numpy(x)
                  for x in _unpacked_case(rng, attention_group(16, 48, 4), 16, 48, 0.3))
    before = (window_attention_packed.launches, fused_window_attention.launches)
    assert torch.equal(window_attention_packed(*args), window_attention_packed_plain(*args))
    assert torch.equal(fused_window_attention(q, k, v, b, NHEAD),
                       fused_window_attention_plain(q, k, v, b, NHEAD))
    assert (window_attention_packed.launches, fused_window_attention.launches) == before

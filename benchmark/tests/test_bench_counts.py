"""The work counters against hand counts on small shapes, and the copied
roofline arithmetic against chip_smoke.py's on the same inputs."""

import ast
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import counts, reference
from benchmark.reference import structure as st

ROOT = Path(__file__).resolve().parent.parent.parent


def _chip_smoke_functions():
    """chip_smoke.py's bound and attention_bound with their constants,
    taken from its source (the script is not imported: it is a gate run)."""
    tree = ast.parse((ROOT / 'chip_smoke.py').read_text())
    keep = [n for n in tree.body
            if (isinstance(n, ast.FunctionDef) and n.name in ('bound', 'attention_bound'))
            or (isinstance(n, ast.Assign) and any(
                getattr(t, 'id', '') in ('HBM_BYTES_PER_S', 'BF16_FLOPS_PER_S',
                                         'FP32_FLOPS_PER_S') for t in n.targets))]
    ns = {}
    exec(compile(ast.Module(body=keep, type_ignores=[]), 'chip_smoke.py', 'exec'), ns)
    return ns


@pytest.mark.parametrize('kind', ['fwd', 'train_fwd', 'bwd'])
@pytest.mark.parametrize('windows,t,c,itemsize', [(5520, 16, 48, 2), (2, 800, 384, 2),
                                                  (177, 256, 192, 4), (1, 64, 96, 2)])
def test_attention_bound_is_chip_smokes(kind, windows, t, c, itemsize):
    ns = _chip_smoke_functions()
    assert counts.attention_bound(windows, t, c, itemsize, kind=kind) == \
        ns['attention_bound'](windows, t, c, itemsize, kind=kind)
    assert counts.bound(1e9, 1e12) == ns['bound'](1e9, 1e12)


@pytest.mark.parametrize('kind', ['fwd', 'train_fwd', 'bwd'])
def test_live_tokens_reduce_to_the_padded_count_on_full_windows(kind):
    full = counts.attention_tokens_bound([64] * 10, 96, kind=kind)
    assert full == pytest.approx(counts.attention_bound(10, 64, 96, 2, kind=kind))
    part = counts.attention_tokens_bound([64] * 5 + [32] * 5, 96, kind=kind)
    assert part[0] < full[0]


def test_attention_work_by_hand():
    # two windows of 3 and 5 tokens, C = 16: 4 (9 + 25) 16 flops; (3 + 5)
    # rows of q, k, v, out at 2 bytes and the bias at 4
    nbytes, flops = counts.attention_work([3, 5], 16)
    assert flops == 4 * (9 + 25) * 16
    assert nbytes == 8 * (4 * 16 * 2 + 4)
    nbytes, flops = counts.attention_work([3, 5], 16, kind='bwd')
    assert flops == 10 * 34 * 16 and nbytes == 8 * (8 * 16 * 2 + 8 * 8 + 4)


def test_conv_work_by_hand():
    nbytes, flops = counts.conv_work(pairs=100, cin=4, cout=8, rows_in=30, rows_out=20)
    assert flops == 2 * 100 * 4 * 8
    assert nbytes == (30 * 4 + 27 * 4 * 8 + 20 * 8) * 2 + 4 * 100
    nbytes, flops = counts.conv_work(100, 4, 8, 30, 20, backward=True)
    assert flops == 4 * 100 * 4 * 8
    assert nbytes == (20 * 8 + 30 * 4 + 27 * 4 * 8 + 30 * 4) * 2 + 4 * 100 + 4 * 27 * 4 * 8


def test_forward_flops_by_hand():
    records = [('linear', {'rows': 10, 'fin': 3, 'fout': 4}),
               ('conv', {'pairs': 7, 'cin': 2, 'cout': 5, 'rows_in': 3, 'rows_out': 3}),
               ('attention', {'tokens': np.array([2, 4]), 't': 16, 'c': 8, 'nhead': 8,
                              'train': False}),
               ('matmul', {'flops': 11})]
    assert counts.forward_flops(records) == 2 * 10 * 3 * 4 + 2 * 7 * 2 * 5 + 4 * 20 * 8 + 11


def test_a_conv_records_its_live_pairs():
    """Three voxels in a row along x: the subm rulebook of one conv holds
    3 self pairs and 4 neighbour pairs; a padded fourth row counts nothing."""
    coords = torch.tensor([[[0, 0, 0], [0, 0, 1], [0, 0, 2], [-1, -1, -1]]], dtype=torch.int32)
    rb = st.subm_rulebook(coords, (1, 1, 4))
    mask = coords[..., 0] >= 0
    conv = reference.nn.SparseConv(2, 3)
    with reference.counting() as rec:
        conv(torch.ones(1, 4, 2), rb, mask, mask)
    (kind, w), = rec
    assert kind == 'conv' and w['pairs'] == 7 and w['rows_in'] == 3 and w['rows_out'] == 3
    assert counts.forward_flops(rec) == 2 * 7 * 2 * 3


def test_a_linear_records_its_live_rows():
    lin = torch.nn.Linear(4, 6)
    mask = torch.tensor([[True, False, True]])
    with reference.counting() as rec:
        reference.nn.dense(lin, torch.ones(1, 3, 4), mask)
    assert rec == [('linear', {'rows': 2, 'fin': 4, 'fout': 6})]


def test_layer_least_ms_adds_the_backward_in_training():
    rec = [('conv', {'pairs': 1000, 'cin': 16, 'cout': 16, 'rows_in': 100, 'rows_out': 100}),
           ('attention', {'tokens': np.array([16] * 8), 't': 16, 'c': 48, 'nhead': 8,
                          'train': True})]
    for layer in ('conv', 'attention'):
        ev, tr = counts.layer_least_ms(rec, layer, False), counts.layer_least_ms(rec, layer, True)
        assert 0 < ev < tr
    assert math.isclose(counts.layer_least_ms(rec, 'attention', False),
                        counts.attention_bound(8, 16, 48, 2)[0])

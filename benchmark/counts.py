"""Work counts: the FLOPs and bytes each layer of a forward (or a train
step) needs for the frame it runs, and the least time they take on the
card.

The counts come from the reference's work records (``reference.counting``):
every linear records its live rows, every sparse conv its live rulebook
pairs and live input and output rows, every window-attention call the live
tokens of each live window. They are the work these inputs need, whatever
implements the layer: a padded row, an absent neighbour or an empty window
counts nothing.

``bound`` and ``attention_bound`` are frozen copies of ``chip_smoke.py``'s
roofline arithmetic (the data-sheet peaks of one H100 SXM, dense);
``attention_bound`` counts T rows of every live window, and
``attention_tokens_bound`` the same work over each live window's own tokens.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
BF16 = 2


def bound(nbytes: float, flops: float, flops_per_s: float = BF16_FLOPS_PER_S):
    """(least ms, 'bytes' or 'operations')."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / flops_per_s * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def attention_bound(windows, t, c, itemsize, nhead=8, kind='fwd'):
    """The least time of window attention over `windows` live windows of T
    rows: 'fwd' reads q, k, v and the bias and writes out, 'train_fwd' also
    writes the row statistics; 4 T^2 C flops a window. 'bwd' reads q, k, v,
    out, the cotangent, the statistics and the bias and writes dq, dk and
    dv; 10 T^2 C flops a window."""
    rows = windows * t
    if kind == 'bwd':
        return bound(rows * (8 * c * itemsize + 8 * nhead + 4), 10 * windows * t * t * c)
    stats = 8 * nhead if kind == 'train_fwd' else 0
    return bound(rows * (4 * c * itemsize + 4 + stats), 4 * windows * t * t * c)


def attention_work(tokens, c, itemsize=BF16, nhead=8, kind='fwd') -> tuple:
    """(bytes, flops) of window attention over live windows holding
    `tokens` tokens each, by ``attention_bound``'s accounting."""
    n = np.asarray(tokens, dtype=np.float64)
    rows, sq = float(n.sum()), float((n * n).sum())
    if kind == 'bwd':
        return rows * (8 * c * itemsize + 8 * nhead + 4), 10 * sq * c
    stats = 8 * nhead if kind == 'train_fwd' else 0
    return rows * (4 * c * itemsize + 4 + stats), 4 * sq * c


def attention_tokens_bound(tokens, c, itemsize=BF16, nhead=8, kind='fwd'):
    return bound(*attention_work(tokens, c, itemsize, nhead, kind))


def conv_work(pairs, cin, cout, rows_in, rows_out, itemsize=BF16, backward=False) -> tuple:
    """(bytes, flops) of a sparse conv: its inputs read once (live input
    rows, the bf16 weights, one int32 index a pair), its output written once,
    2 x pairs x Cin x Cout flops. The backward reads the cotangent, the
    input rows, the weights and the pairs and writes dx and the float32 dW:
    twice the flops (dx and dW)."""
    w = 27 * cin * cout
    if backward:
        nbytes = (rows_out * cout + rows_in * cin + w + rows_in * cin) * itemsize \
            + 4 * pairs + 4 * w
        return nbytes, 4.0 * pairs * cin * cout
    return (rows_in * cin + w + rows_out * cout) * itemsize + 4 * pairs, \
        2.0 * pairs * cin * cout


def forward_flops(records) -> float:
    """The FLOPs of one forward's records: linears, convs, attention, the
    OCR's matmuls."""
    total = 0.0
    for kind, w in records:
        if kind == 'linear':
            total += 2.0 * w['rows'] * w['fin'] * w['fout']
        elif kind == 'conv':
            total += 2.0 * w['pairs'] * w['cin'] * w['cout']
        elif kind == 'attention':
            total += attention_work(w['tokens'], w['c'], nhead=w['nhead'])[1]
        elif kind == 'matmul':
            total += float(w['flops'])
    return total


def layer_least_ms(records, layer: str, train: bool) -> float:
    """The least ms of one forward's calls of `layer` ('attention' or
    'conv'), with their backward where `train`."""
    total = 0.0
    for kind, w in records:
        if kind != layer:
            continue
        if kind == 'attention':
            parts = ('train_fwd', 'bwd') if train else ('fwd',)
            total += sum(attention_tokens_bound(w['tokens'], w['c'], nhead=w['nhead'],
                                                kind=k)[0] for k in parts)
        else:
            args = (w['pairs'], w['cin'], w['cout'], w['rows_in'], w['rows_out'])
            total += bound(*conv_work(*args))[0]
            if train:
                total += bound(*conv_work(*args, backward=True))[0]
    return total

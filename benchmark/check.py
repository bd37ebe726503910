"""The numbers that decide ``correct``, each against its limit.

Training (the first three steps of the run's own train state, against the
reference's three steps from the same weights, batches and seeds, its
learning rates worked out by the reference itself). Each leaf's gap is
|norm - reference norm| / max(reference norm of the leaf, the median
leaf's), over the leaves whose reference gradient is at least a thousandth
of the median leaf's: the others (a bias ahead of a batch norm, whose
gradient is nought but for round-off) move by round-off alone, and their
gap reads the program's round-off against the median. Compared:
  * ``grad_gap_worst`` / ``change_gap_worst``: the worst leaf of the first
    gradient as the optimizer got it, and of the parameters' change over
    the three steps. A fault that reaches one layer (a gradient left out,
    doubled or taken from the wrong rows) reads near 1 there;
  * ``grad_gap`` / ``change_gap``: the median leaf of each. The float8
    control spreads its rounding over every leaf, and the median separates
    it from bf16's; its worst leaf does not.
Reported beside them and not compared: the first step's loss gap
(``loss_gap``; with labels drawn at random, half a batch has nearly the
loss of the whole, and the float8 control reads under 3x the program's)
and the three steps' largest.
Serving: a point's gap is how far the reference's logit of the served
label lies below the reference's best logit, in units of the standard
deviation of that frame's reference logits. ``label_regret``, compared: the
sum of the squared gaps of an answer's points, the largest over every
answer in the window. A bf16 program flips only near-ties, by small gaps; a
single label altered to a wrong class adds its whole gap squared. The
widest single gap (``label_gap``) is reported beside it and not compared:
over a dozen seeds it came within 3x of the float8 control's least. An
answer of the wrong length counts as failed.
"""

from __future__ import annotations

import statistics

import torch

QUIET_GRADIENT = 1e-3


def leaf_norms(tensors: dict) -> dict:
    return {n: float(torch.linalg.vector_norm(t.detach().double())) for n, t in tensors.items()}


def leaf_gaps(got: dict, want: dict, leaves: list) -> dict:
    """{leaf: |got - want| / max(want, the median of want)}."""
    floor = statistics.median(want[n] for n in leaves)
    return {n: abs(got[n] - want[n]) / max(want[n], floor, 1e-30) for n in leaves}


def moving_leaves(grad_norms: dict) -> list:
    """The leaves whose reference gradient is at least QUIET_GRADIENT of the
    median leaf's."""
    median = statistics.median(grad_norms.values())
    return [n for n in sorted(grad_norms) if grad_norms[n] >= QUIET_GRADIENT * median]


def train_numbers(prog: dict, ref: dict) -> dict:
    """prog/ref: {'losses': [3], 'grad_norms': {leaf: norm}, 'change_norms':
    {leaf: norm}}."""
    losses = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog['losses'], ref['losses'])]
    moving = moving_leaves(ref['grad_norms'])
    grad = leaf_gaps(prog['grad_norms'], ref['grad_norms'], moving)
    change = leaf_gaps(prog['change_norms'], ref['change_norms'], moving)
    return {'loss_gap': losses[0], 'grad_gap': statistics.median(grad.values()),
            'change_gap': statistics.median(change.values()), 'loss_gap_3steps': max(losses),
            'grad_gap_worst': max(grad.values()), 'change_gap_worst': max(change.values())}


def worst_leaves(prog: dict, ref: dict, k: int = 3) -> dict:
    """The k worst moving leaves of the gradient and of the change, with
    their gaps (for a look at single leaves)."""
    moving = moving_leaves(ref['grad_norms'])
    out = {}
    for key in ('grad_norms', 'change_norms'):
        gaps = leaf_gaps(prog[key], ref[key], moving)
        out[key] = sorted(gaps.items(), key=lambda kv: -kv[1])[:k]
    return out


def label_gaps(ref_logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """ref_logits [n, C] float32, labels [n] integer -> each point's gap."""
    scale = ref_logits.std().clamp(min=1e-30)
    best = ref_logits.max(-1).values
    got = ref_logits.gather(-1, labels.long()[:, None])[:, 0]
    return (best - got) / scale


def judge(numbers: dict, limits: dict) -> dict:
    """{'correct', 'compared': [{'name', 'value', 'limit'}]}: every number at
    or under its limit."""
    compared = [{'name': n, 'value': numbers[n], 'limit': limits[n]} for n in sorted(limits)]
    ok = all(c['value'] == c['value'] and c['value'] <= c['limit'] for c in compared)
    return {'correct': ok, 'compared': compared}

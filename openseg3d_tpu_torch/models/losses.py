"""Segmentation losses on padded flat logits.

Counterpart of ``openseg3d_tpu/models/losses.py``: every loss takes logits
[N, C] and int labels [N], where ignore_index (255) marks both ignored ground
truth and padded rows, and computes in float32: cross-entropy, OHEM
cross-entropy (keep-threshold and keep-ratio paths), Lovasz-softmax, Dice and
sigmoid focal, and ``build_criterion``.

Lovasz. The JAX package sorts one packed payload and gives the loss a custom
VJP: d loss_c / d errors[i] = w[j] * 1[errors_sorted[j] > 0] at i's sorted
position j, with the Jaccard weights w held constant (the reference's
detached gradient). Here the errors are sorted with ``torch.sort`` and the
weights are computed from the sorted labels without gradient, so autograd
through the sort (a scatter back to i) gives exactly that gradient. Ties
among errors may sort in another order than the JAX package's unstable sort;
the loss value does not depend on it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _valid(labels: torch.Tensor, ignore_index: int) -> torch.Tensor:
    return (labels != ignore_index) & (labels >= 0)


def cross_entropy(logits, labels, ignore_index: int = 255, class_weight=None):
    """Per-element CE with the ignore mask: (losses [N], valid [N], norm [N]),
    norm the torch-convention mean denominator (the element's class weight
    when weighted, else 1)."""
    valid = _valid(labels, ignore_index)
    safe = torch.where(valid, labels, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[:, None])[:, 0]
    if class_weight is not None:
        w = torch.as_tensor(class_weight, dtype=nll.dtype, device=nll.device)[safe]
        nll = nll * w
        norm = torch.where(valid, w, 0.0)
    else:
        norm = valid.to(nll.dtype)
    return torch.where(valid, nll, 0.0), valid, norm


def ce_loss(logits, labels, ignore_index: int = 255, class_weight=None):
    losses, _, norm = cross_entropy(logits, labels, ignore_index, class_weight)
    return losses.sum() / torch.clamp(norm.sum(), min=1e-12)


def ohem_ce_loss(logits, labels, ignore_index: int = 255,
                 keep_ratio: float | None = None, keep_thresh: float | None = None,
                 class_weight=None):
    """Online hard example mining CE. keep_ratio: the mean of the largest
    int(ratio * |valid|) losses; keep_thresh: the mean over valid elements
    whose target-class probability is below the threshold."""
    losses, valid, norm = cross_entropy(logits, labels, ignore_index, class_weight)
    if keep_ratio is not None:
        kept_count = (valid.sum().float() * keep_ratio).int()
        sorted_losses = torch.sort(torch.where(valid, losses, float('-inf')),
                                   descending=True).values
        keep = torch.arange(losses.shape[0], device=losses.device) < kept_count
        kept = torch.where(keep, sorted_losses, 0.0)
        return kept.sum() / torch.clamp(kept_count, min=1)
    if keep_thresh is not None:
        safe = torch.where(valid, labels, 0).long()
        probs = torch.softmax(logits.float(), dim=-1)
        p_t = probs.gather(-1, safe[:, None])[:, 0]
        keep = valid & (p_t < keep_thresh)
        return torch.where(keep, losses, 0.0).sum() / torch.clamp(keep.sum(), min=1)
    return losses.sum() / torch.clamp(norm.sum(), min=1e-12)


def _lovasz_dot(errors, fgf, validf):
    """Per-class Lovasz dot: errors / fgf / validf [C, N] -> loss_c [C]."""
    # ascending sort of -errors == descending by errors; invalid entries
    # carry +inf keys so they sort last and contribute nothing
    neg = torch.where(validf > 0, -errors, float('inf'))
    neg_s, order = torch.sort(neg, dim=-1, stable=True)
    errors_sorted = torch.where(torch.isfinite(neg_s), -neg_s, 0.0)
    with torch.no_grad():
        fg_s = fgf.gather(-1, order)
        val_s = validf.gather(-1, order)
        gts = fgf.sum(dim=-1, keepdim=True)
        intersection = gts - torch.cumsum(fg_s, dim=-1)
        union = gts + torch.cumsum(val_s * (1.0 - fg_s), dim=-1)
        jaccard = 1.0 - intersection / torch.clamp(union, min=1.0)
        w = torch.cat([jaccard[:, :1], jaccard[:, 1:] - jaccard[:, :-1]], dim=-1)
        w = w * val_s                                  # no pull toward padding
    return (torch.relu(errors_sorted) * w).sum(dim=-1)


def lovasz_softmax_loss(logits, labels, ignore_index: int = 255, class_weight=None):
    """Multi-class Lovasz-softmax over the flattened batch, averaged over the
    classes present in the labels."""
    valid = _valid(labels, ignore_index)
    probs = torch.softmax(logits.float(), dim=-1)
    num_classes = logits.shape[-1]
    safe = torch.where(valid, labels, 0)
    classes = torch.arange(num_classes, device=logits.device)
    fgf = ((safe[None, :] == classes[:, None]) & valid[None, :]).float()   # [C, N]
    validf = valid[None, :].expand_as(fgf).float()
    errors = (fgf - probs.T).abs() * validf
    losses = _lovasz_dot(errors, fgf, validf)
    present = (fgf.sum(dim=-1) > 0).float()
    if class_weight is not None:
        losses = losses * torch.as_tensor(class_weight, dtype=losses.dtype,
                                          device=losses.device)
    return (losses * present).sum() / torch.clamp(present.sum(), min=1.0)


def dice_loss(logits, labels, ignore_index: int = 255, smooth: float = 1.0,
              exponent: float = 2.0):
    """Mean over classes of 1 - (2 sum p y + smooth) / (sum p^e + y^e +
    smooth), softmax probabilities p against one-hot targets y over the
    valid rows (``losses.py:161-172``)."""
    valid = _valid(labels, ignore_index)
    probs = torch.softmax(logits.float(), dim=-1)
    safe = torch.where(valid, labels, 0).long()
    onehot = F.one_hot(safe, logits.shape[-1]).float()
    m = valid.float()[:, None]
    num = 2.0 * (probs * onehot * m).sum(dim=0) + smooth
    den = ((probs ** exponent + onehot ** exponent) * m).sum(dim=0) + smooth
    return (1.0 - num / den).mean()


def focal_loss(logits, labels, ignore_index: int = 255, gamma: float = 2.0,
               alpha: float = 0.25):
    """Sigmoid multi-label focal loss against one-hot targets, summed over
    classes and averaged over the valid rows (``losses.py:175-188``)."""
    valid = _valid(labels, ignore_index)
    safe = torch.where(valid, labels, 0).long()
    onehot = F.one_hot(safe, logits.shape[-1]).float()
    x = logits.float()
    p = torch.sigmoid(x)
    pt = p * onehot + (1 - p) * (1 - onehot)
    at = alpha * onehot + (1 - alpha) * (1 - onehot)
    z = torch.where(onehot > 0, -x, x)
    bce = torch.logaddexp(torch.zeros_like(z), z)
    loss = (at * (1 - pt) ** gamma * bce).sum(dim=-1)
    return torch.where(valid, loss, 0.0).sum() / torch.clamp(valid.sum(), min=1)


def build_criterion(cfg, class_weight=None):
    """List of (loss_fn, weight) from ``MODEL.LOSSES``, as the JAX package's
    ``build_criterion``: class weights only when ``MODEL.USE_CLASS_WEIGHT``
    is set; OHEM keeps by ``MODEL.OHEM_KEEP_THRESH`` when set, else by
    ``MODEL.OHEM_KEEP_RATIO``."""
    ignore = cfg.DATASET.IGNORE_INDEX
    use_cw = bool(cfg.MODEL.get('USE_CLASS_WEIGHT', False))
    if class_weight is None and use_cw and len(cfg.DATASET.CLASS_WEIGHT):
        class_weight = tuple(float(w) for w in cfg.DATASET.CLASS_WEIGHT)
    cw = class_weight
    out = []
    for name, weight in cfg.MODEL.LOSSES.items():
        if name == 'ce':
            fn = lambda lg, lb: ce_loss(lg, lb, ignore, class_weight=cw)   # noqa: E731
        elif name == 'ohem_ce':
            thresh = cfg.MODEL.OHEM_KEEP_THRESH
            ratio = None if thresh else cfg.MODEL.OHEM_KEEP_RATIO
            fn = lambda lg, lb, _t=thresh, _r=ratio: ohem_ce_loss(   # noqa: E731
                lg, lb, ignore, keep_ratio=_r, keep_thresh=_t, class_weight=cw)
        elif name == 'lovasz':
            fn = lambda lg, lb: lovasz_softmax_loss(lg, lb, ignore)   # noqa: E731
        elif name == 'dice':
            fn = lambda lg, lb: dice_loss(lg, lb, ignore)   # noqa: E731
        elif name == 'focal':
            fn = lambda lg, lb: focal_loss(lg, lb, ignore)   # noqa: E731
        else:
            raise NotImplementedError(f'loss {name!r}')
        out.append((fn, float(weight)))
    return out

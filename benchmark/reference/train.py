"""The reference's train step: the loss, the aux labels, the backward and SGD.

Frozen copies of the port's ``models/losses`` (OHEM cross-entropy on the
threshold or the ratio path, Lovasz-softmax, cross-entropy),
``engine.compute_loss`` and ``_aux_labels`` (each stage-4 voxel takes the
label of its nearest full-resolution voxel centre, the lowest index among
equal distances, as the port's plain 1-NN finds it), ``engine.step_generator``
(the dropout generator of a step), ``models/optim`` (SGD with momentum and
decoupled-into-the-gradient weight decay, as optax chains them) and the
warmup-poly schedule, which the reference works out itself from the
config's learning rate and the traffic mix's epochs and updates an epoch.
Single process: the loss is the batch's.
"""

from __future__ import annotations

import torch

IGNORE = 255


def step_generator(seed: int, step: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF))
    return gen


def _cross_entropy(logits, labels):
    valid = (labels != IGNORE) & (labels >= 0)
    safe = torch.where(valid, labels, 0).long()
    nll = -torch.log_softmax(logits, -1).gather(-1, safe[:, None])[:, 0]
    return torch.where(valid, nll, 0.0), valid


def ohem_ce(logits, labels, keep_ratio=None, keep_thresh=None):
    losses, valid = _cross_entropy(logits, labels)
    if keep_ratio is not None:
        kept_count = (valid.sum().float() * keep_ratio).int()
        s = torch.sort(torch.where(valid, losses, float('-inf')), descending=True).values
        keep = torch.arange(losses.shape[0], device=losses.device) < kept_count
        return torch.where(keep, s, 0.0).sum() / torch.clamp(kept_count, min=1)
    if keep_thresh is not None:
        safe = torch.where(valid, labels, 0).long()
        p_t = torch.softmax(logits, -1).gather(-1, safe[:, None])[:, 0]
        keep = valid & (p_t < keep_thresh)
        return torch.where(keep, losses, 0.0).sum() / torch.clamp(keep.sum(), min=1)
    return losses.sum() / torch.clamp(valid.sum(), min=1)


def ce(logits, labels):
    losses, valid = _cross_entropy(logits, labels)
    return losses.sum() / torch.clamp(valid.sum(), min=1)


def lovasz(logits, labels):
    valid = (labels != IGNORE) & (labels >= 0)
    probs = torch.softmax(logits, -1)
    classes = torch.arange(logits.shape[-1], device=logits.device)
    fgf = ((torch.where(valid, labels, 0)[None, :] == classes[:, None]) & valid[None, :]).float()
    validf = valid[None, :].expand_as(fgf).float()
    errors = (fgf - probs.T).abs() * validf
    neg_s, order = torch.sort(torch.where(validf > 0, -errors, float('inf')), dim=-1, stable=True)
    errors_sorted = torch.where(torch.isfinite(neg_s), -neg_s, 0.0)
    with torch.no_grad():
        fg_s, val_s = fgf.gather(-1, order), validf.gather(-1, order)
        gts = fgf.sum(-1, keepdim=True)
        inter = gts - torch.cumsum(fg_s, -1)
        union = gts + torch.cumsum(val_s * (1.0 - fg_s), -1)
        jac = 1.0 - inter / torch.clamp(union, min=1.0)
        w = torch.cat([jac[:, :1], jac[:, 1:] - jac[:, :-1]], -1) * val_s
    losses = (torch.relu(errors_sorted) * w).sum(-1)
    present = (fgf.sum(-1) > 0).float()
    return (losses * present).sum() / torch.clamp(present.sum(), min=1.0)


def criterion(cfg: dict) -> list:
    md = cfg['MODEL']
    out = []
    for name, weight in md['LOSSES'].items():
        if name == 'ohem_ce':
            thresh = md['OHEM_KEEP_THRESH']
            ratio = None if thresh else md['OHEM_KEEP_RATIO']
            fn = (lambda lg, lb, _t=thresh, _r=ratio:  # noqa: E731
                  ohem_ce(lg, lb, keep_ratio=_r, keep_thresh=_t))
        elif name == 'lovasz':
            fn = lovasz
        elif name == 'ce':
            fn = ce
        else:
            raise NotImplementedError(f'the reference has no loss {name!r}')
        out.append((fn, float(weight)))
    if md.get('USE_CLASS_WEIGHT'):
        raise NotImplementedError('the reference has no class weights')
    return out


def voxel_centers(coords, scale, voxel_size, pcr):
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=coords.device) * scale
    origin = torch.tensor(pcr[0:3], dtype=torch.float32, device=coords.device)
    return (coords.flip(-1).float() + 0.5) * vs + origin


def nearest_point(queries, points, valid, tile=256):
    """((qx-px)^2 + (qy-py)^2) + (qz-pz)^2 in float32; the lowest index
    among equal minima; -1 with no valid point."""
    b, q, _ = queries.shape
    out = torch.empty((b, q), dtype=torch.int32, device=queries.device)
    inf = torch.tensor(float('inf'), device=queries.device)
    for bi in range(b):
        p, ok = points[bi], valid[bi][None, :]
        cols = torch.arange(p.shape[0], device=p.device)
        for s in range(0, q, tile):
            qt = queries[bi, s:s + tile]
            d = (qt[:, None, 0] - p[None, :, 0]).square()
            d = d + (qt[:, None, 1] - p[None, :, 1]).square()
            d = d + (qt[:, None, 2] - p[None, :, 2]).square()
            d = torch.where(ok & ~torch.isnan(d), d, inf)
            best = d.min(1, keepdim=True).values
            idx = torch.where(d == best, cols, p.shape[0]).min(1).values
            out[bi, s:s + tile] = torch.where(best[:, 0] < inf, idx, -1).int()
    return out


def aux_labels(out, batch, spec):
    with torch.no_grad():
        src = voxel_centers(out['voxel_coords'], 1.0, spec.voxel_size, spec.point_cloud_range)
        dst = voxel_centers(out['aux_voxel_coords'], 8.0, spec.voxel_size,
                            spec.point_cloud_range)
        idx = nearest_point(dst.contiguous(), src.contiguous(), out['voxel_mask'])
        idx = torch.where(out['aux_voxel_mask'], idx, -1)
        got = torch.gather(batch['voxel_labels'], 1, idx.clamp(min=0).long())
        return torch.where(idx >= 0, got, IGNORE).int()


def loss(out, batch, crit, spec, aux_weight: float):
    nc = spec.num_classes
    aux = aux_labels(out, batch, spec)
    total = 0.0
    for logits, labels, scale in ((out['point_out'], batch['point_labels'], 1.0),
                                  (out['voxel_out'], batch['voxel_labels'], 1.0),
                                  (out['aux_voxel_out'], aux, aux_weight)):
        for fn, w in crit:
            total = total + scale * w * fn(logits.reshape(-1, nc), labels.reshape(-1))
    return total


def warmup_poly(base_lr, max_iters, warmup_iters, warmup_factor=0.001, power=0.9):
    def schedule(count: int) -> float:
        i = min(count, max_iters)
        alpha = min(i / max(warmup_iters, 1), 1.0)
        warm = warmup_factor * (1 - alpha) + alpha
        return base_lr * warm * max(1.0 - i / max_iters, 0.0) ** power
    return schedule


def learning_rates(cfg: dict, schedule: dict, steps: int) -> list:
    """The learning rates of `steps` updates from the mix's `schedule`
    ({'epochs', 'iters_per_epoch', 'start_update'}): the recipe's
    warmup-poly over epochs x iters_per_epoch updates, warming up over the
    first epoch, at update counts start_update, start_update + 1, ..."""
    tr = cfg['TRAIN']
    if tr['LR_SCHEDULER'] != 'warmup_poly_lr':
        raise NotImplementedError(f'the reference has no schedule {tr["LR_SCHEDULER"]!r}')
    ipe = int(schedule['iters_per_epoch'])
    lr = warmup_poly(float(tr['LR']), max(int(schedule['epochs']) * ipe, 1), ipe)
    start = int(schedule['start_update'])
    return [lr(start + i) for i in range(steps)]


@torch.no_grad()
def sgd(params, buffers, lr: float, momentum: float, weight_decay: float):
    """p -= lr * buf, buf = momentum * buf + (grad + wd * p); the first buf
    is the decayed gradient itself."""
    for i, p in enumerate(params):
        d = p.grad.add(p, alpha=weight_decay)
        buffers[i] = d.clone() if buffers[i] is None else buffers[i].mul_(momentum).add_(d)
        p.add_(buffers[i], alpha=-lr)

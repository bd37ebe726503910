"""The pieces of the port's train step against the JAX package's: the losses,
the optimizers and their schedule, train-mode BatchNorm, the voxel centres
and the aux-label 1-NN. The same numpy inputs go to both sides.

Tolerances: losses, values and gradients, float32 1e-5 (log-softmax, sorts
and sums of at most a few hundred terms); optimizer updates and learning
rates 1e-6 (a few float32 operations per element; the schedule is computed
in float64 here and in float32 by JAX); BatchNorm 1e-5 (sums over 60 rows);
voxel centres and 1-NN indices exact, 1-NN against JAX by distance (the JAX
CPU path expands the distance as |q|^2 - 2 q.p + |p|^2 and may pick another
of two equidistant points).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from openseg3d_tpu.models import losses as jlosses
from openseg3d_tpu.models import optim as joptim
from openseg3d_tpu.models.norm import MaskedBatchNorm as JaxMaskedBatchNorm
from openseg3d_tpu.ops.knn import nearest_label_transfer as jax_nearest_label_transfer
from openseg3d_tpu.utils.pointops import get_voxel_centers as jax_get_voxel_centers

from openseg3d_tpu_torch.models import losses, optim
from openseg3d_tpu_torch.models.norm import MaskedBatchNorm
from openseg3d_tpu_torch.ops.knn import nearest_label_transfer, nearest_point
from openseg3d_tpu_torch.utils.pointops import get_voxel_centers

from helpers import tiny_cfg

t = torch.from_numpy


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _loss_case(seed, n=80, c=6):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(n, c) * 2).astype(np.float32)
    labels = rng.randint(0, c - 1, n).astype(np.int32)   # class c-1 never present
    labels[rng.rand(n) < 0.15] = 255                     # ignored ground truth
    labels[-10:] = 255                                   # padded rows
    return logits, labels


CLASS_WEIGHT = (1.0, 2.5, 0.5, 3.0, 1.5, 4.0)
LOSSES = {
    'ce': (lambda lg, lb: jlosses.ce_loss(lg, lb), lambda lg, lb: losses.ce_loss(lg, lb)),
    'ce_weighted': (lambda lg, lb: jlosses.ce_loss(lg, lb, class_weight=CLASS_WEIGHT),
                    lambda lg, lb: losses.ce_loss(lg, lb, class_weight=CLASS_WEIGHT)),
    'ohem_thresh': (lambda lg, lb: jlosses.ohem_ce_loss(lg, lb, keep_thresh=0.7),
                    lambda lg, lb: losses.ohem_ce_loss(lg, lb, keep_thresh=0.7)),
    'ohem_ratio': (lambda lg, lb: jlosses.ohem_ce_loss(lg, lb, keep_ratio=0.3),
                   lambda lg, lb: losses.ohem_ce_loss(lg, lb, keep_ratio=0.3)),
    'ohem_ratio_weighted': (
        lambda lg, lb: jlosses.ohem_ce_loss(lg, lb, keep_ratio=0.3, class_weight=CLASS_WEIGHT),
        lambda lg, lb: losses.ohem_ce_loss(lg, lb, keep_ratio=0.3, class_weight=CLASS_WEIGHT)),
    'lovasz': (lambda lg, lb: jlosses.lovasz_softmax_loss(lg, lb),
               lambda lg, lb: losses.lovasz_softmax_loss(lg, lb)),
}


@pytest.mark.parametrize('name', sorted(LOSSES))
@pytest.mark.parametrize('seed', [0, 1])
def test_loss_value_and_grad_equal_jax(name, seed):
    jfn, fn = LOSSES[name]
    logits, labels = _loss_case(seed)
    jval, jgrad = jax.value_and_grad(jfn)(jnp.asarray(logits), jnp.asarray(labels))
    x = t(logits).requires_grad_(True)
    val = fn(x, t(labels))
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=1e-5)
    assert not x.grad[-10:].any()                        # padded rows get no gradient


def test_losses_of_all_ignored_labels_are_zero():
    logits, labels = _loss_case(2)
    labels[:] = 255
    for name, (_, fn) in LOSSES.items():
        x = t(logits).requires_grad_(True)
        val = fn(x, t(labels))
        val.backward()
        assert float(val.detach()) == 0.0 and not x.grad.any(), name


def test_build_criterion_matches_jax():
    cfg = tiny_cfg()
    logits, labels = _loss_case(3)
    mine = losses.build_criterion(cfg)
    ref = jlosses.build_criterion(cfg)
    assert [w for _, w in mine] == [w for _, w in ref]
    for (fn, _), (jfn, _) in zip(mine, ref):
        np.testing.assert_allclose(float(fn(t(logits), t(labels))),
                                   float(jfn(jnp.asarray(logits), jnp.asarray(labels))),
                                   rtol=1e-5, atol=1e-5)
    # class weights: from DATASET.CLASS_WEIGHT when MODEL.USE_CLASS_WEIGHT is
    # set, or passed in
    lg = np.random.RandomState(0).randn(40, 22).astype(np.float32)
    lb = np.random.RandomState(1).randint(0, 22, 40).astype(np.int32)
    cw = tuple(np.random.RandomState(2).uniform(0.5, 5, 22).tolist())
    for c, kw in ((tiny_cfg(MODEL={'USE_CLASS_WEIGHT': True},
                            DATASET={'CLASS_WEIGHT': list(cw)}), {}),
                  (cfg, {'class_weight': cw})):
        for (fn, _), (jfn, _) in zip(losses.build_criterion(c, **kw),
                                     jlosses.build_criterion(c, **kw)):
            np.testing.assert_allclose(float(fn(t(lg), t(lb))),
                                       float(jfn(jnp.asarray(lg), jnp.asarray(lb))),
                                       rtol=1e-5)


# ---------------------------------------------------------------------------
# optimizers and schedule
# ---------------------------------------------------------------------------

def test_warmup_poly_schedule_equals_jax():
    cfg = tiny_cfg(TRAIN={'LR': 0.05})
    mine = optim.build_schedule(cfg, epochs=3, iters_per_epoch=4)
    ref = joptim.build_schedule(cfg, epochs=3, iters_per_epoch=4)
    for i in range(15):
        np.testing.assert_allclose(mine(i), float(ref(i)), rtol=1e-6, atol=1e-12)
    assert mine(0) == pytest.approx(0.05 * 0.001)
    assert mine(12) == 0.0
    with pytest.raises(NotImplementedError):
        optim.build_schedule(tiny_cfg(TRAIN={'LR_SCHEDULER': 'no_such_schedule'}), 1, 1)


@pytest.mark.parametrize('name', ['sgd', 'adamw'])
def test_optimizer_steps_equal_optax(name):
    """Three updates on the same gradients, learning rate of update i =
    schedule(i), every leaf decayed (a bias and a norm scale included)."""
    cfg = tiny_cfg(TRAIN={'OPTIMIZER': name, 'LR': 0.05, 'MOMENTUM': 0.9,
                          'WEIGHT_DECAY': 0.01})
    rng = np.random.RandomState(5)
    shapes = {'kernel': (4, 3), 'bias': (3,), 'scale': (3,)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]

    schedule = joptim.build_schedule(cfg, epochs=2, iters_per_epoch=2)
    tx = joptim.build_optimizer(cfg, schedule)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)

    tp = {k: torch.nn.Parameter(t(v.copy())) for k, v in params.items()}
    opt = optim.build_optimizer(cfg, tp.values())
    sched = optim.build_schedule(cfg, epochs=2, iters_per_epoch=2)
    for i, g in enumerate(grads):
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = t(g[k].copy())
        optim.set_learning_rate(opt, sched(i))
        opt.step()
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=f'{name} step {i} {k}')


# ---------------------------------------------------------------------------
# train-mode BatchNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('case', ['masked', 'one_valid_row', 'unmasked'])
def test_batchnorm_train_equals_jax(case):
    """Output, gradients (input, scale, bias) and running statistics. With
    one valid row the variance is exactly 0 (E[x^2] - E[x]^2 of one value),
    where the clamp's gradient is split in half as jnp.maximum splits it."""
    rng = np.random.RandomState(7)
    b, n, c = 2, 30, 5
    x = rng.randn(b, n, c).astype(np.float32) * 3 + 1
    mask = rng.rand(b, n) > 0.3
    if case == 'one_valid_row':
        mask[:] = False
        mask[1, 4] = True
    w = rng.randn(b, n, c).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.randn(c).astype(np.float32)
    mean0 = rng.randn(c).astype(np.float32)
    var0 = rng.uniform(0.5, 2, c).astype(np.float32)
    m = None if case == 'unmasked' else mask

    bn = JaxMaskedBatchNorm(momentum=0.9, eps=1e-5)
    variables = {'params': {'scale': jnp.asarray(scale), 'bias': jnp.asarray(bias)},
                 'batch_stats': {'mean': jnp.asarray(mean0), 'var': jnp.asarray(var0)}}

    def jloss(xx, params):
        y, mut = bn.apply({'params': params, 'batch_stats': variables['batch_stats']}, xx,
                          None if m is None else jnp.asarray(m), True, mutable=['batch_stats'])
        return jnp.sum(y * w), (y, mut['batch_stats'])

    (_, (jy, jstats)), (jgx, jgp) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), variables['params'])

    mod = MaskedBatchNorm(c, eps=1e-5, momentum=0.9)
    with torch.no_grad():
        mod.scale.copy_(t(scale))
        mod.bias.copy_(t(bias))
        mod.mean.copy_(t(mean0))
        mod.var.copy_(t(var0))
    xt = t(x).requires_grad_(True)
    y = mod.train()(xt, None if m is None else t(m))
    (y * t(w)).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **tol)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **tol)
    np.testing.assert_allclose(mod.scale.grad.numpy(), np.asarray(jgp['scale']), **tol)
    np.testing.assert_allclose(mod.bias.grad.numpy(), np.asarray(jgp['bias']), **tol)
    np.testing.assert_allclose(mod.mean.numpy(), np.asarray(jstats['mean']), **tol)
    np.testing.assert_allclose(mod.var.numpy(), np.asarray(jstats['var']), **tol)
    # eval mode reads the running statistics and moves nothing
    before = mod.mean.clone()
    mod.eval()(t(x), None if m is None else t(m))
    torch.testing.assert_close(mod.mean, before, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# voxel centres and the aux-label 1-NN
# ---------------------------------------------------------------------------

def test_voxel_centers_equal_jax():
    rng = np.random.RandomState(3)
    coords = rng.randint(-1, 40, (2, 50, 3)).astype(np.int32)
    vs, pcr = (0.1, 0.1, 0.15), (-75.2, -75.2, -2.0, 75.2, 75.2, 4.0)
    for scale in (1.0, 8.0):
        np.testing.assert_array_equal(
            get_voxel_centers(t(coords), scale, vs, pcr).numpy(),
            np.asarray(jax_get_voxel_centers(jnp.asarray(coords), scale, vs, pcr)))


def test_nearest_label_transfer_matches_jax_by_distance():
    """As tests/test_native_and_ops.py holds the Pallas path to the XLA
    path: an invalid dst gets 255; a valid one a label of some source at the
    nearest distance the JAX package finds."""
    rng = np.random.RandomState(11)
    b, p, q = 2, 700, 300
    src = rng.randn(b, p, 3).astype(np.float32) * 5
    dst = rng.randn(b, q, 3).astype(np.float32) * 5
    lbl = rng.randint(0, 22, (b, p)).astype(np.int32)
    sv = rng.rand(b, p) < 0.9
    dv = rng.rand(b, q) < 0.9
    mine = nearest_label_transfer(t(src), t(lbl), t(sv), t(dst), t(dv)).numpy()
    ref = np.asarray(jax_nearest_label_transfer(jnp.asarray(src), jnp.asarray(lbl),
                                                jnp.asarray(sv), jnp.asarray(dst),
                                                jnp.asarray(dv)))
    np.testing.assert_array_equal(mine[~dv], 255)
    np.testing.assert_array_equal(ref[~dv], 255)
    idx = nearest_point(t(dst), t(src), t(sv)).numpy()
    for bi in range(b):
        d2 = ((dst[bi][:, None].astype(np.float64) - src[bi][None]) ** 2).sum(-1)
        d2[:, ~sv[bi]] = np.inf
        best = d2.min(axis=1)
        np.testing.assert_allclose(d2[np.arange(q), idx[bi]], best, rtol=1e-6)
        for qi in np.where(dv[bi])[0]:
            cand = lbl[bi][np.isclose(d2[qi], best[qi], rtol=1e-4, atol=1e-4)]
            assert mine[bi, qi] in cand and ref[bi, qi] in cand, (bi, qi)
        agree = mine[bi][dv[bi]] == ref[bi][dv[bi]]
        assert agree.mean() > 0.99


def test_nearest_point_ties_go_to_the_lowest_index():
    """The label-transfer geometry: an aux centre (stage-4 voxel c, 8x
    downsampled) is equidistant from the 8 full-resolution centres around
    (8c + 4): the plain version (the CUDA kernel's reference) returns the
    lowest index among them, never an invalid point, and -1 without any
    valid point. (Voxel sizes and origin exact in binary, so that the ties
    are exact in float32; with 0.1 m voxels they are near-ties that the
    last bit decides, the same way in kernel and plain version.)"""
    vs, pcr = (0.25, 0.25, 0.125), (-64.0, -64.0, -4.0, 64.0, 64.0, 4.0)
    aux = np.array([[[2, 3, 5]]], np.int32)                     # one stage-4 voxel
    ring = np.array([[8 * 2 + 3 + dz, 8 * 3 + 3 + dy, 8 * 5 + 3 + dx]
                     for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)], np.int32)
    far = ring + 3
    rng = np.random.RandomState(0)
    order = rng.permutation(16)
    full = np.concatenate([ring, far])[order][None]             # shuffled rows
    src = get_voxel_centers(t(full), 1.0, vs, pcr)
    dst = get_voxel_centers(t(aux), 8.0, vs, pcr)
    d = ((dst[0, 0] - src[0]) ** 2).sum(-1)
    tied = np.where(order < 8)[0]                               # rows of the ring
    assert len(set(d[tied].tolist())) == 1                      # exactly equidistant
    valid = torch.ones(1, 16, dtype=torch.bool)
    assert int(nearest_point(dst, src, valid)[0, 0]) == tied.min()
    valid[0, tied.min()] = False                                # the lowest is invalid
    assert int(nearest_point(dst, src, valid)[0, 0]) == np.sort(tied)[1]
    valid[:] = False
    assert int(nearest_point(dst, src, valid)[0, 0]) == -1
    lbl = t(np.arange(16, dtype=np.int32)[None])
    assert int(nearest_label_transfer(src, lbl, valid, dst, torch.ones(1, 1, dtype=torch.bool))) \
        == 255

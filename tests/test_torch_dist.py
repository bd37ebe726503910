"""Data-parallel training (``openseg3d_tpu_torch/parallel/dist.py``) against
the JAX package's SPMD step, on the CPU: two gloo processes
(``tests/torch_dist_workers.py``), B = 1 each.

The JAX package trains data-parallel by SPMD: a step on a batch sharded over
N devices computes what the same step on the whole batch computes on one
device. So the two ranks' step is held against the JAX package's step on the
B = 2 batch (``test_torch_train._step_both``: the same weights through
``load_flax_variables``, dropout off on both sides, JAX fed the aux labels
the port's 1-NN gives): the loss, every gradient, the BatchNorm running
statistics and the parameters after one SGD step, each leaf within
1e-4 x (1 + its largest magnitude) (float32 through ~40 layers and their
backward, summed in another order), the loss abs/rel 1e-4. Both ranks end
with bit-equal parameters. The reference PyTorch recipe (each rank's loss on
its own rows, gradients averaged: DDP) gives another gradient, because OHEM's
keep count and the Lovasz sort are not means of per-sample terms: that step
must differ from JAX's by more than the tolerance, so the comparison can
fail.

Also: MaskedBatchNorm with different valid counts on the ranks against one
process on the concatenated rows (1e-5), the eval histogram and loss over
ranks with a padding duplicate, and the shard order against JAX's. The train
CLI at two ranks is in tests/test_torch_dist_cli.py.
"""

import copy
import functools
import os

import jax
import numpy as np
import pytest
import torch

from openseg3d_tpu import engine as jax_engine
from openseg3d_tpu.parallel.mesh import process_shard_indices as jax_shard_indices

from openseg3d_tpu_torch.config import cfg_from_file
from openseg3d_tpu_torch.data.batch import collate_padded, to_device
from openseg3d_tpu_torch.data.loader import process_shard_indices
from openseg3d_tpu_torch.engine import build_segmentor, make_eval_step
from openseg3d_tpu_torch.models.norm import MaskedBatchNorm
from openseg3d_tpu_torch.parallel import dist as pdist
from openseg3d_tpu_torch.tools import train as train_tool
from openseg3d_tpu_torch.weights import init_weights

import torch_dist_workers as workers
from helpers import TINY_OVERRIDES, synthetic_batch, tiny_cfg
from test_torch_segformer import _randomise
from test_torch_train import EPOCHS, ITERS, _leaves, _step_both

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
TOL = 1e-4
TRAIN_EXTRA = {'MODEL': {'SEGMENTOR': 'segformer', 'DEPTHS': [2, 2, 2, 2],
                         'DROP_PATH_RATE': 0.0},
               'TRAIN': {'OPTIMIZER': 'sgd', 'LR': 50.0, 'MOMENTUM': 0.9,
                         'WEIGHT_DECAY': 1e-4}}


def _overrides(**extra):
    """tests/helpers.tiny_cfg's overrides, for the port's cfg_from_file in a
    rank process."""
    ov = copy.deepcopy(TINY_OVERRIDES)
    for k, v in extra.items():
        ov.setdefault(k, {}).update(v)
    return ov


def _tree_errors(mine, ref):
    """{leaf: max |mine - ref| / (1 + max |ref|)} over a flax tree."""
    a, b = dict(_leaves(mine)), dict(_leaves(ref))
    assert set(a) == set(b), sorted(set(a) ^ set(b))[:5]
    return {'/'.join(p): float(np.abs(a[p] - b[p]).max()) / (1.0 + float(np.abs(b[p]).max()))
            for p in b}


@pytest.fixture(scope='module')
def dp_step(tmp_path_factory):
    """The two ranks' step (both modes) and _step_both's port and JAX steps
    on the B = 2 batch, from the same random weights. The ranks run while
    the JAX step compiles."""
    cfg = tiny_cfg(**TRAIN_EXTRA)
    nb = synthetic_batch(cfg, batch_size=2, seed=3)
    jmodel, _ = jax_engine.build_segmentor(cfg)
    jb = {k: v for k, v in nb.items() if k != 'batch_size'}
    shapes = jax.eval_shape(functools.partial(jmodel.init, train=False),
                            {'params': jax.random.PRNGKey(0)}, jb)
    rng = np.random.RandomState(0)
    variables = (_randomise(shapes['params'], rng), _randomise(shapes['batch_stats'], rng))
    wait = workers.start(workers.train_step, WORLD, tmp_path_factory.mktemp('dp_step'),
                         {'overrides': _overrides(**TRAIN_EXTRA), 'batch': nb,
                          'variables': variables, 'schedule': (EPOCHS, ITERS)})
    with pytest.MonkeyPatch.context() as mp:
        ref = _step_both(mp, cfg, nb, variables=variables)
    return wait(300.0), ref


@pytest.mark.parametrize('what', ['loss', 'grads', 'stats', 'params'])
def test_two_ranks_equal_the_jax_step_on_the_global_batch(dp_step, what):
    ranks, (metrics, grads, stats, params, jloss, jgrads, jstats, jparams, params0) = dp_step
    for r, res in enumerate(ranks):
        got = res['global']
        assert got['finite'] and got['counts'] == (1, 1)
        if what == 'loss':
            np.testing.assert_allclose(got['loss'], float(jloss), rtol=TOL, atol=TOL)
            # the port's own B = 2 step too
            np.testing.assert_allclose(got['loss'], float(metrics['loss']), rtol=TOL, atol=TOL)
            continue
        ref = {'grads': jgrads, 'stats': jstats, 'params': jparams}[what]
        errs = _tree_errors(got[what], ref)
        worst = max(errs.items(), key=lambda kv: kv[1])
        assert worst[1] <= TOL, (r, what, worst)
    if what == 'params':
        # both ranks hold the same parameters, to the bit, and the step moved them
        a, b = dict(_leaves(ranks[0]['global']['params'])), dict(_leaves(ranks[1]['global']['params']))
        assert all(np.array_equal(a[p], b[p]) for p in a)
        moved = max(float(np.abs(a[p] - v).max()) for p, v in _leaves(params0))
        assert moved > 1e-3, moved
    if what == 'stats':
        assert all(np.array_equal(x, y) for (_, x), (_, y) in
                   zip(sorted(_leaves(ranks[0]['global']['stats'])),
                       sorted(_leaves(ranks[1]['global']['stats']))))


def test_per_rank_loss_mean_differs_from_the_jax_step(dp_step):
    """The reference recipe (DDP: each rank's loss on its own rows, the
    gradients averaged) is not the JAX package's step: some gradient leaf
    is off by more than the tolerance the data-parallel step meets."""
    ranks, ref = dp_step
    jgrads = ref[5]
    errs = _tree_errors(ranks[0]['per_rank_mean']['grads'], jgrads)
    worst = max(errs.items(), key=lambda kv: kv[1])
    print(f'per-rank loss mean against JAX: worst gradient leaf {worst}')
    assert worst[1] > 10 * TOL, worst


@pytest.mark.parametrize('masked', [True, False])
def test_batch_norm_over_ranks_equals_one_process(tmp_path, masked):
    """Different valid counts on the two ranks (37 and 12 of 50 rows):
    output and input gradients equal the one-process run's rows, the
    parameter gradients sum to its, the running statistics equal its."""
    rng = np.random.RandomState(4)
    c = 8
    x = [(rng.randn(2, 25, c) * 3 + 1).astype(np.float32) for _ in range(WORLD)]
    mask = [np.zeros((2, 25), bool) for _ in range(WORLD)]
    mask[0].reshape(-1)[rng.permutation(50)[:37]] = True
    mask[1].reshape(-1)[rng.permutation(50)[:12]] = True
    g = [rng.randn(2, 25, c).astype(np.float32) for _ in range(WORLD)]
    payload = {'x': x, 'mask': mask, 'cotangent': g,
               'scale': rng.uniform(0.5, 1.5, c).astype(np.float32),
               'bias': rng.randn(c).astype(np.float32)}
    ranks = workers.run(workers.batch_norm, WORLD, tmp_path, payload, timeout=120.0)

    bn = MaskedBatchNorm(c, eps=1e-3, momentum=0.9).train()
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(payload['scale']))
        bn.bias.copy_(torch.from_numpy(payload['bias']))
    xa = torch.from_numpy(np.concatenate(x)).requires_grad_()
    y = bn(xa, torch.from_numpy(np.concatenate(mask)) if masked else None)
    (y * torch.from_numpy(np.concatenate(g))).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-5)
    for r, res in enumerate(ranks):
        got = res[masked]
        rows = slice(2 * r, 2 * r + 2)
        np.testing.assert_allclose(got['y'], y.detach().numpy()[rows], **tol)
        np.testing.assert_allclose(got['dx'], xa.grad.numpy()[rows], **tol)
        np.testing.assert_allclose(got['mean'], bn.mean.numpy(), **tol)
        np.testing.assert_allclose(got['var'], bn.var.numpy(), **tol)
    for name, want in (('dscale', bn.scale.grad), ('dbias', bn.bias.grad)):
        np.testing.assert_allclose(sum(res[masked][name] for res in ranks), want.numpy(), **tol)


def test_eval_histogram_over_ranks_equals_one_process(tmp_path):
    """3 frames at 2 ranks x B = 2: rank 1's second slot is a padding
    duplicate (sample_valid False). The summed histogram equals the
    one-process histogram of the 3 frames, IOUMetric's all-reduced mIoU its
    mIoU, and the loss the one-process loss of the padded global batch."""
    ov = _overrides(MODEL={'SEGMENTOR': 'segformer', 'DEPTHS': [1, 1, 1, 1]})
    cfg = cfg_from_file(None, overrides=ov)
    nb = synthetic_batch(tiny_cfg(MODEL=ov['MODEL']), batch_size=3, seed=8)
    samples = [{k: v[i] for k, v in nb.items() if k != 'batch_size'} for i in range(3)]
    ranks = workers.run(workers.eval_histogram, WORLD, tmp_path,
                        {'overrides': ov, 'samples': samples, 'batch': 2, 'seed': 3},
                        timeout=120.0)
    assert [list(r['idx']) for r in ranks] == [[0, 1], [2, 0]]
    assert [list(r['valid']) for r in ranks] == [[True, True], [True, False]]

    model, spec = build_segmentor(cfg, device='cpu')
    init_weights(model, torch.Generator().manual_seed(3))
    step = make_eval_step(cfg, spec, model, with_loss=True)
    one = step(to_device(collate_padded(samples), 'cpu'))
    padded = step(to_device(collate_padded([samples[i] for i in (0, 1, 2, 0)]), 'cpu'))
    from openseg3d_tpu_torch.core.metrics import per_class_iou
    for res in ranks:
        np.testing.assert_array_equal(res['hist'], one['hist'].numpy())
        np.testing.assert_allclose(res['loss'], float(padded['loss']), rtol=1e-5, atol=1e-5)
        assert res['miou'] == pytest.approx(float(np.nanmean(per_class_iou(one['hist'].numpy()))),
                                            rel=1e-12)
    assert int(one['hist'].sum()) > 0


@pytest.mark.parametrize('n,batch,shuffle', [(10, 2, True), (7, 1, False), (3, 2, False),
                                             (9, 3, True)])
def test_shard_indices_interleave_to_the_jax_order(n, batch, shuffle):
    """Slot r of every global batch is rank r's: the ranks' indices, taken
    batch by batch in rank order, are JAX's one-process order (and its
    padding marks)."""
    seed = 5 if shuffle else None
    for epoch in range(2):
        idx, valid = zip(*(process_shard_indices(n, seed, epoch, batch * WORLD, WORLD, r,
                                                 return_valid=True) for r in range(WORLD)))
        ref_idx, ref_valid = jax_shard_indices(n, seed, epoch, batch * WORLD, return_valid=True)
        for mine, ref in ((idx, ref_idx), (valid, ref_valid)):
            inter = np.stack([m.reshape(-1, batch) for m in mine], axis=1).reshape(-1)
            np.testing.assert_array_equal(inter, ref)


def test_num_devices_without_the_launcher_raises(tmp_path):
    with pytest.raises(ValueError, match='torchrun --nproc_per_node 2'):
        train_tool.main(['--cfg_file', os.path.join(REPO, 'configs', 'synthetic_smoke.yaml'),
                         '--synthetic', '--num_devices', '2', '--device', 'cpu',
                         '--save_dir', str(tmp_path)])


def test_init_distributed_needs_a_launcher_and_a_card_per_rank(monkeypatch):
    """No torchrun environment: a no-op at world 1. A LOCAL_RANK past the
    visible cards raises: ranks never share a card quietly."""
    for name in ('WORLD_SIZE', 'RANK', 'LOCAL_RANK'):
        monkeypatch.delenv(name, raising=False)
    assert pdist.init_distributed('cuda') == (0, 1)
    assert not pdist.is_distributed() and (pdist.rank(), pdist.world()) == (0, 1)
    assert pdist.local_device('cpu') == torch.device('cpu')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    monkeypatch.setenv('LOCAL_RANK', '1')
    with pytest.raises(RuntimeError, match='no card of its own'):
        pdist.local_device('cuda')

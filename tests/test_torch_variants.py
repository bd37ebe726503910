"""The port's multi-sweep and cylinder Segformers against the JAX package's.

Multi-sweep (``DATASET.USE_MULTI_SWEEPS``): the mean VFE over the raw points
of every sweep feeds the backbone (its stem takes DIM_POINT channels), and
the logits exist only for current points; here a third of the valid points
are history points (``cur_point_mask`` false). Cylinder
(``configs/waymo_one_sweep_cylinder.yaml``: the 1504 x 524 x 72 polar grid,
points (rho, phi, z, x, y, features), DIM_POINT + 2 input channels). Each
at a tiny depth and capacity, from random weights: the float32 eval forward
(abs/rel 1e-4) and one float32 train step (the loss, every gradient, the
BatchNorm statistics and the parameters after one SGD step, abs/rel 1e-4,
as in ``tests/test_torch_train.py``), the latter in
``tests/test_torch_variants_train.py``.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openseg3d_tpu.config import cfg_from_file
from openseg3d_tpu.engine import build_segmentor as jax_build_segmentor

from openseg3d_tpu_torch.core.voxelizer import VoxelGenerator, majority_voxel_labels
from openseg3d_tpu_torch.data.batch import collate_padded, pad_sample, to_device
from openseg3d_tpu_torch.engine import build_segmentor
from openseg3d_tpu_torch.weights import load_flax_variables

from helpers import TINY_OVERRIDES, synthetic_batch, tiny_cfg
from test_torch_segformer import TOL, _randomise

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = {'SEGMENTOR': 'segformer', 'DEPTHS': [1, 1, 1, 1], 'DROP_PATH_RATE': 0.0}
SGD = {'OPTIMIZER': 'sgd', 'LR': 50.0, 'MOMENTUM': 0.9, 'WEIGHT_DECAY': 1e-4}


def _multi_sweep():
    cfg = tiny_cfg(MODEL=MODEL, TRAIN=SGD, DATASET={'USE_MULTI_SWEEPS': True})
    nb = synthetic_batch(cfg, batch_size=2, seed=7)
    history = np.zeros_like(nb['cur_point_mask'])
    history[:, ::3] = True
    nb['cur_point_mask'] &= ~history
    nb['point_labels'][history] = 255       # labels exist for current points only
    assert (nb['point_mask'] & ~nb['cur_point_mask']).any()
    return cfg, nb


def _cylinder():
    cfg = cfg_from_file(os.path.join(REPO, 'configs', 'waymo_one_sweep_cylinder.yaml'),
                        overrides={'RUNTIME': dict(TINY_OVERRIDES['RUNTIME']),
                                   'MODEL': MODEL, 'TRAIN': SGD})
    rng = np.random.RandomState(8)
    vg = VoxelGenerator(cfg.DATASET.VOXEL_SIZE, cfg.DATASET.POINT_CLOUD_RANGE)
    samples = []
    for _ in range(2):
        n = 700
        rho, phi = rng.uniform(2, 6, n), rng.uniform(-0.4, 0.4, n)
        z = rng.uniform(-1.5, 1.5, n)
        x, y = rho * np.cos(phi), rho * np.sin(phi)
        feats = rng.randn(n, cfg.DATASET.DIM_POINT - 3)
        pts = np.concatenate([np.stack([rho, phi, z, x, y], 1), feats], 1).astype(np.float32)
        coords, ids = vg.generate(pts)
        labels = rng.randint(0, cfg.DATASET.NUM_CLASSES, n)
        samples.append(pad_sample(dict(points=pts, voxel_coords=coords, point_voxel_ids=ids,
                                       point_labels=labels,
                                       voxel_labels=majority_voxel_labels(
                                           ids, labels, coords.shape[0])),
                                  cfg.RUNTIME.MAX_POINTS_PER_SAMPLE,
                                  cfg.RUNTIME.MAX_VOXELS_PER_SAMPLE))
    nb = collate_padded(samples)
    assert nb['points'].shape[-1] == cfg.DATASET.DIM_POINT + 2
    assert tuple(jax_build_segmentor(cfg)[1].spatial_shape) == (72, 524, 1504)
    return cfg, nb


CASES = {'multi_sweep': _multi_sweep, 'cylinder': _cylinder}


@pytest.mark.parametrize('case', sorted(CASES))
def test_forward_matches_jax(case):
    cfg, nb = CASES[case]()
    jmodel, _ = jax_build_segmentor(cfg)
    jb = {k: jnp.asarray(v) for k, v in nb.items() if k != 'batch_size'}
    shapes = jax.eval_shape(functools.partial(jmodel.init, train=False),
                            {'params': jax.random.PRNGKey(0)}, jb)
    rng = np.random.RandomState(1)
    params, stats = _randomise(shapes['params'], rng), _randomise(shapes['batch_stats'], rng)
    ref = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
        {'params': params, 'batch_stats': stats}, jb)
    model, _ = build_segmentor(cfg, device='cpu')
    load_flax_variables(model, params, stats)
    with torch.inference_mode():
        out = model.eval()(to_device(nb, 'cpu'))
    for k in ('point_out', 'voxel_out', 'aux_voxel_out'):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), err_msg=k, **TOL)
    cur = nb['point_mask'] & nb['cur_point_mask']
    assert not out['point_out'].numpy()[~cur].any()
    np.testing.assert_array_equal(out['aux_voxel_coords'].numpy(),
                                  np.asarray(ref['aux_voxel_coords']))

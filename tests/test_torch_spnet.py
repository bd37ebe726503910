"""The port's SPNet (sparse-conv UNet with squeeze-excite, OCR and the
UpBlock decoder) against the JAX package's, end to end.

The tiny SPNet's variable tree comes from ``jax.eval_shape`` and every leaf
is random (``test_torch_segformer._randomise``); both packages run the same
padded batch. Held equal: the float32 eval forward (every output, abs/rel
1e-4), the eval step's histogram, and one float32 train step (the loss,
every gradient (the point encoder's within ENCODER_TOL of each leaf's
largest magnitude), the BatchNorm statistics and the parameters after one
SGD step, abs/rel 1e-4; dropout off on both sides and the same aux labels, as
in ``tests/test_torch_train.py``), in which every one of the 43 sparse
convs runs the gather-only backward; on a second batch, not picked for its
conditioning, the loss and the BatchNorm statistics. The bf16 forward is held to
BF16_LOGIT_TOL of the largest logit, as the Segformer's is. The two train
steps are in ``tests/test_torch_spnet_train.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openseg3d_tpu.engine import TrainState
from openseg3d_tpu.engine import build_segmentor as jax_build_segmentor
from openseg3d_tpu.engine import make_eval_step as jax_make_eval_step

from openseg3d_tpu_torch.data.batch import to_device
from openseg3d_tpu_torch.engine import build_segmentor, make_eval_step
from openseg3d_tpu_torch.models.ocr import OCRLayer
from openseg3d_tpu_torch.models.sparse_modules import SparseConv
from openseg3d_tpu_torch.weights import init_weights, load_flax_variables, to_flax_variables

from helpers import synthetic_batch, tiny_cfg
from test_torch_segformer import BF16_LOGIT_TOL, TOL, _randomise

SGD = {'OPTIMIZER': 'sgd', 'LR': 50.0, 'MOMENTUM': 0.9, 'WEIGHT_DECAY': 1e-4}
N_CONVS = 43      # stem 1, stage 1 4, stages 2-4 7 each, OCR 1, decoder 16
ENCODER_TOL = 5e-3   # x the leaf's largest magnitude, point-encoder gradients


def _cfg(dtype='float32'):
    return tiny_cfg(MODEL={'SEGMENTOR': 'spnet'}, TRAIN=SGD, RUNTIME={'COMPUTE_DTYPE': dtype})


@pytest.fixture(scope='module')
def variables():
    cfg = _cfg()
    model, _ = jax_build_segmentor(cfg)
    batch = {k: jnp.asarray(v) for k, v in synthetic_batch(cfg, batch_size=1).items()
             if k != 'batch_size'}
    shapes = jax.eval_shape(functools.partial(model.init, train=False),
                            {'params': jax.random.PRNGKey(0)}, batch)
    rng = np.random.RandomState(0)
    return _randomise(shapes['params'], rng), _randomise(shapes['batch_stats'], rng)


def _port(cfg, params, stats):
    model, spec = build_segmentor(cfg, device='cpu')
    load_flax_variables(model, params, stats)
    return model.eval(), spec


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_spnet_forward_matches_jax(variables, dtype):
    params, stats = variables
    cfg = _cfg(dtype)
    jmodel, _ = jax_build_segmentor(cfg)
    nb = synthetic_batch(cfg, batch_size=2, seed=2)
    jb = {k: jnp.asarray(v) for k, v in nb.items() if k != 'batch_size'}
    ref = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
        {'params': params, 'batch_stats': stats}, jb)
    model, _ = _port(cfg, params, stats)
    with torch.inference_mode():
        out = model(to_device(nb, 'cpu'))
    for k in ('point_out', 'voxel_out', 'aux_voxel_out'):
        got, want = out[k].numpy(), np.asarray(ref[k], np.float32)
        if dtype == 'float32':
            np.testing.assert_allclose(got, want, err_msg=k, **TOL)
        else:
            err = float(np.abs(got - want).max()) / float(np.abs(want).max())
            print(f'{k}: max abs diff / max abs logit {err:.3g}')
            assert err <= BF16_LOGIT_TOL, (k, err)
    for k in ('aux_voxel_coords', 'aux_voxel_mask'):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))


def test_spnet_eval_histogram_matches_jax(variables):
    params, stats = variables
    cfg = _cfg()
    jmodel, jspec = jax_build_segmentor(cfg)
    nb = synthetic_batch(cfg, batch_size=2, seed=5)
    jb = {k: jnp.asarray(v) for k, v in nb.items() if k != 'batch_size'}
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                       opt_state=None, tx=None, apply_fn=jmodel.apply)
    ref = jax_make_eval_step(cfg, jspec, jmodel, with_loss=False)(state, jb)
    model, spec = _port(cfg, params, stats)
    res = make_eval_step(cfg, spec, model)(to_device(nb, 'cpu'))
    np.testing.assert_allclose(res['point_out'].numpy(), np.asarray(ref['point_out']), **TOL)
    np.testing.assert_array_equal(res['hist'].numpy(), np.asarray(ref['hist']))


def test_spnet_structure_and_seeded_init():
    """43 convs (42 SparseConv modules and the OCR transform), squeeze-excite
    on the last block of stages 3-4 only, and init_weights fills every
    tensor the flax tree names."""
    model, _ = build_segmentor(_cfg(), device='cpu')
    unet = model.SparseUnet_0
    assert sum(isinstance(m, SparseConv) for m in model.modules()) + \
        sum(isinstance(m, OCRLayer) for m in model.modules()) == N_CONVS
    with_se = [i for i in range(11)
               if getattr(unet, f'SparseBasicBlock_{i}').FlattenSELayer_0 is not None]
    assert with_se == [7, 10]
    init_weights(model, torch.Generator().manual_seed(0))
    params, _ = to_flax_variables(model)
    k = params['SparseUnet_0']['OCRLayer_0']['transform_kernel']
    assert abs(float(k.std()) * np.sqrt(27 * 256 / 2) - 1) < 0.05

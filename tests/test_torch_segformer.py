"""The port's Segformer eval forward against the JAX package's, end to end.

The JAX model's variable tree comes from ``jax.eval_shape(model.init)`` (a
trace, no compile); every leaf is filled from a seeded numpy generator, the
scale/bias/tau/BN-statistic leaves too, so that each leaf matters. The
variables are carried across with ``weights.load_flax_variables``, and both
packages run the same tiny padded batch in float32.

Tolerance: abs/rel 1e-4. Both sides compute in float32 through ~40 layers
(convs, attention, LayerNorms) with different summation orders; the
observed differences are ~1e-6 relative, so 1e-4 leaves margin while any
wrong weight, mask or index shows up as O(1).
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
from openseg3d_tpu_torch.ops.attention import window_attention_packed
from openseg3d_tpu_torch.weights import load_flax_variables, to_flax_variables

from helpers import synthetic_batch, tiny_cfg

TOL = dict(rtol=1e-4, atol=1e-4)
# bf16 logits: the CPU shows at most 1.35e-2 of the largest logit
BF16_LOGIT_TOL = 4e-2


def _cfg():
    return tiny_cfg(MODEL={'SEGMENTOR': 'segformer', 'DEPTHS': [2, 2, 2, 2]})


def _randomise(tree, rng):
    """Random values for every leaf of a tree of shapes: kernels at the
    1/sqrt(fan-in) scale, positive BN variances, LayerNorm/BN scales, taus."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, 'items'):
            out[k] = _randomise(v, rng)
        elif k in ('scale', 'var'):
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k in ('bias', 'mean', 'in_proj_bias'):
            out[k] = (0.1 * rng.randn(*v.shape)).astype(np.float32)
        elif k == 'tau':
            out[k] = rng.uniform(0.05, 0.2, v.shape).astype(np.float32)
        else:
            fan_in = int(np.prod(v.shape[:-1])) or 1
            out[k] = (rng.randn(*v.shape) / np.sqrt(fan_in)).astype(np.float32)
    return out


@pytest.fixture(scope='module')
def jax_model():
    cfg = _cfg()
    model, spec = jax_build_segmentor(cfg)
    batch = {k: jnp.asarray(v) for k, v in synthetic_batch(cfg, batch_size=1).items()
             if k != 'batch_size'}
    shapes = jax.eval_shape(functools.partial(model.init, train=False),
                            {'params': jax.random.PRNGKey(0)}, batch)
    rng = np.random.RandomState(0)
    params = _randomise(shapes['params'], rng)
    stats = _randomise(shapes['batch_stats'], rng)
    return cfg, model, spec, params, stats


def _port(cfg, params, stats):
    model, spec = build_segmentor(cfg, device='cpu')
    load_flax_variables(model, params, stats)
    return model.eval(), spec


@pytest.mark.parametrize('batch_size,dtype', [
    pytest.param(1, 'float32', id='1'),
    pytest.param(2, 'float32', id='2'),
    pytest.param(1, 'bfloat16', id='1-bfloat16'),
])
def test_forward_matches_jax(jax_model, batch_size, dtype):
    """bfloat16 (``RUNTIME.COMPUTE_DTYPE``): both sides round activations to
    bf16 at their own places (the JAX einsum attention, the port's plain
    version), so each logit array is held to BF16_LOGIT_TOL of its largest
    magnitude instead of 1e-4."""
    cfg, jmodel, _, params, stats = jax_model
    if dtype != 'float32':
        cfg = tiny_cfg(MODEL={'SEGMENTOR': 'segformer', 'DEPTHS': [2, 2, 2, 2]},
                       RUNTIME={'COMPUTE_DTYPE': dtype})
        jmodel, _ = jax_build_segmentor(cfg)
    nb = synthetic_batch(cfg, batch_size=batch_size, seed=batch_size)
    jb = {k: jnp.asarray(v) for k, v in nb.items() if k != 'batch_size'}
    ref = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
        {'params': params, 'batch_stats': stats}, jb)

    model, _ = _port(cfg, params, stats)
    with torch.inference_mode():
        out = model(to_device(nb, 'cpu'))
    for k in ('point_out', 'voxel_out', 'aux_voxel_out'):
        assert out[k].dtype == torch.float32
        got, want = out[k].numpy(), np.asarray(ref[k], np.float32)
        if dtype == 'float32':
            np.testing.assert_allclose(got, want, err_msg=k, **TOL)
        else:
            err = float(np.abs(got - want).max()) / float(np.abs(want).max())
            print(f'{k}: max abs diff / max abs logit {err:.3g}')
            assert err <= BF16_LOGIT_TOL, (k, err)
    np.testing.assert_array_equal(out['aux_voxel_coords'].numpy(),
                                  np.asarray(ref['aux_voxel_coords']))
    np.testing.assert_array_equal(out['aux_voxel_mask'].numpy(),
                                  np.asarray(ref['aux_voxel_mask']))


def test_eval_step_histogram_matches_jax(jax_model):
    cfg, jmodel, spec, params, stats = jax_model
    nb = synthetic_batch(cfg, batch_size=2, seed=5)
    jb = {k: jnp.asarray(v) for k, v in nb.items() if k != 'batch_size'}
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                       opt_state=None, tx=None, apply_fn=jmodel.apply)
    ref = jax_make_eval_step(cfg, spec, jmodel, with_loss=False)(state, jb)

    model, pspec = _port(cfg, params, stats)
    before = window_attention_packed.launches
    res = make_eval_step(cfg, pspec, model)(to_device(nb, 'cpu'))
    assert window_attention_packed.launches == before     # CPU: plain version
    np.testing.assert_allclose(res['point_out'].numpy(), np.asarray(ref['point_out']), **TOL)
    np.testing.assert_array_equal(res['hist'].numpy(), np.asarray(ref['hist']))
    n_valid = int((nb['point_mask'] & nb['cur_point_mask']).sum())
    assert int(res['hist'].sum()) == n_valid


def test_bridge_rejects_unused_and_missing_leaves(jax_model):
    cfg, _, _, params, stats = jax_model
    model, _ = build_segmentor(cfg, device='cpu')
    extra = dict(params, Extra_0={'kernel': np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match='unused'):
        load_flax_variables(model, extra, stats)
    missing = {k: v for k, v in params.items() if k != 'SegmentorHead_0'}
    with pytest.raises(ValueError, match='SegmentorHead_0'):
        load_flax_variables(model, missing, stats)
    head = dict(params['SegmentorHead_0'], Dense_0={'kernel': np.zeros((3, 3), np.float32)})
    with pytest.raises(ValueError, match='Dense_0'):
        load_flax_variables(model, dict(params, SegmentorHead_0=head), stats)
    load_flax_variables(model, params, stats)               # the full tree fits


def test_to_flax_variables_inverts_the_bridge(jax_model):
    """load_flax_variables then to_flax_variables gives the trees back
    exactly: every leaf, Linear kernels transposed back, the scanned layers
    re-stacked on axis 0. With grads=True it returns the gradients under the
    same names (zeros before any backward)."""
    cfg, _, _, params, stats = jax_model
    model, _ = build_segmentor(cfg, device='cpu')
    load_flax_variables(model, params, stats)
    got_params, got_stats = to_flax_variables(model)

    def leaves(tree, prefix=()):
        for k, v in tree.items():
            if hasattr(v, 'items'):
                yield from leaves(v, prefix + (k,))
            else:
                yield prefix + (k,), np.asarray(v)

    for mine, ref in ((got_params, params), (got_stats, stats)):
        a, b = dict(leaves(mine)), dict(leaves(ref))
        assert set(a) == set(b)
        for path in b:
            assert a[path].dtype == np.float32
            np.testing.assert_array_equal(a[path], b[path], err_msg='/'.join(path))
    grads, no_stats = to_flax_variables(model, grads=True)
    assert no_stats == {}
    g = dict(leaves(grads))
    assert set(g) == set(dict(leaves(params)))
    assert not any(v.any() for v in g.values())

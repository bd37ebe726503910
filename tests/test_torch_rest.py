"""The last modules of the port against the JAX package's: the Dice and
focal losses, the cosine and one-cycle schedules, MaskedLayerNorm, the
flat <-> window helpers, SparseBasicBlock's spatial attention (SALayer),
the point ops' grouping and interpolation, furthest point sampling and the
.pcd writer. The same seeded numpy inputs go to both sides.

Tolerances: losses, their gradients, LayerNorm and the point ops 1e-5
(float32 softmax, sums of at most a few hundred terms); the sparse block
1e-4 (two 27-tap convs, BatchNorm and the gate, forward and backward);
the schedules 1e-7 relative, with JAX in 64-bit (JAX's float32 value is
that rounded to float32, held here within 1e-6 of the peak rate); window
helpers, FPS indices and the .pcd bytes exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openseg3d_tpu.models import losses as jlosses
from openseg3d_tpu.models import optim as joptim
from openseg3d_tpu.models.norm import MaskedLayerNorm as JaxMaskedLayerNorm
from openseg3d_tpu.models.sparse_modules import SparseBasicBlock as JaxSparseBasicBlock
from openseg3d_tpu.ops import knn as jknn
from openseg3d_tpu.ops import sampling as jsampling
from openseg3d_tpu.ops import sparse_conv as jsc
from openseg3d_tpu.ops import window as jwin
from openseg3d_tpu.utils import pointops as jpointops
from openseg3d_tpu.utils import visualize as jvisualize

from openseg3d_tpu_torch.models import losses, optim
from openseg3d_tpu_torch.models.norm import MaskedLayerNorm
from openseg3d_tpu_torch.models.sparse_modules import SparseBasicBlock
from openseg3d_tpu_torch.ops import sampling, sparse_conv as sc, window as win
from openseg3d_tpu_torch.utils import pointops, visualize
from openseg3d_tpu_torch.weights import init_weights, load_flax_variables, to_flax_variables

from helpers import tiny_cfg
from test_torch_ops import _make_sparse
from test_torch_segformer import _randomise

t = torch.from_numpy
TOL = dict(rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _logits_labels(seed, n=300, c=22, ignored=40):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(n, c) * 3).astype(np.float32)
    labels = rng.randint(0, c, n).astype(np.int32)
    labels[rng.permutation(n)[:ignored]] = 255
    return logits, labels


@pytest.mark.parametrize('name', ['dice', 'focal'])
@pytest.mark.parametrize('seed', [0, 1])
def test_loss_and_gradient_equal_jax(name, seed):
    logits, labels = _logits_labels(seed)
    fn, jfn = getattr(losses, f'{name}_loss'), getattr(jlosses, f'{name}_loss')
    jval, jgrad = jax.value_and_grad(lambda lg: jfn(lg, jnp.asarray(labels), 255))(
        jnp.asarray(logits))
    x = t(logits).requires_grad_()
    val = fn(x, t(labels).long(), 255)
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(jval), **TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), **TOL)
    assert np.abs(np.asarray(jgrad)).max() > 0


def test_criterion_with_dice_and_focal_equals_jax():
    cfg = tiny_cfg()
    cfg.MODEL.LOSSES.update({'dice': 0.5, 'focal': 2.0})     # not keys of the defaults
    logits, labels = _logits_labels(2)
    mine = sum(w * f(t(logits), t(labels).long()) for f, w in losses.build_criterion(cfg))
    ref = sum(w * f(jnp.asarray(logits), jnp.asarray(labels))
              for f, w in jlosses.build_criterion(cfg))
    assert len(losses.build_criterion(cfg)) == 4
    np.testing.assert_allclose(float(mine), float(ref), **TOL)


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('name', ['cosine_annealing', 'one_cycle'])
def test_schedule_equals_optax(name):
    """Updates 0, 1, the middle, the last and past the end."""
    cfg = tiny_cfg(TRAIN={'LR_SCHEDULER': name, 'LR': 0.01})
    epochs, iters = 3, 7
    total = epochs * iters
    mine = optim.build_schedule(cfg, epochs, iters)
    ref = joptim.build_schedule(cfg, epochs, iters)
    for i in (0, 1, total // 2, total - 1, total, total + 5):
        with jax.enable_x64(True):
            want = float(ref(i))
        np.testing.assert_allclose(mine(i), want, rtol=1e-7, atol=0, err_msg=str(i))
        assert abs(mine(i) - float(ref(i))) <= 1e-6 * 0.01, i
    assert mine(total // 2) > 0


# ---------------------------------------------------------------------------
# MaskedLayerNorm, the window helpers
# ---------------------------------------------------------------------------

def test_masked_layer_norm_equals_jax():
    rng = np.random.RandomState(3)
    x = (rng.randn(2, 30, 16) * 2 + 0.5).astype(np.float32)
    mask = rng.rand(2, 30) > 0.3
    jm = JaxMaskedLayerNorm()
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask))
    params = _randomise(shapes['params'], rng)
    cot = rng.randn(2, 30, 16).astype(np.float32)
    jy, jvjp = jax.vjp(lambda v: jm.apply({'params': params}, v, jnp.asarray(mask)),
                       jnp.asarray(x))
    m = MaskedLayerNorm(16)
    load_flax_variables(m, params, {})
    xt = t(x).requires_grad_()
    y = m(xt, t(mask))
    (y * t(cot)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jvjp(jnp.asarray(cot))[0]), **TOL)
    assert (y.detach().numpy()[~mask] == 0).all()


@pytest.mark.parametrize('fn', ['flat_to_window', 'window_mask', 'window_to_flat'])
def test_window_helpers_equal_jax(fn):
    """A level of 5 windows x 8 tokens; 40 rows, 25 of them in unique slots."""
    rng = np.random.RandomState(4)
    b, v, c = 2, 40, 6
    spec = win.LevelSpec(max_tokens=8, lower=0, upper=8, num_windows=5)
    jspec = jwin.LevelSpec(max_tokens=8, lower=0, upper=8, num_windows=5)
    idx = np.full((b, v), -1, np.int64)
    for i in range(b):
        idx[i, rng.permutation(v)[:25]] = rng.permutation(40)[:25]
    feat = rng.randn(b, v, c).astype(np.float32)
    if fn == 'flat_to_window':
        got, want = win.flat_to_window(t(feat), t(idx), spec), \
            jwin.flat_to_window(jnp.asarray(feat), jnp.asarray(idx), jspec)
    elif fn == 'window_mask':
        got, want = win.window_mask(t(idx), spec), jwin.window_mask(jnp.asarray(idx), jspec)
        assert int(got.sum()) == 50
    else:
        wf = rng.randn(b, 5, 8, c).astype(np.float32)
        got, want = win.window_to_flat(t(wf), t(idx), spec), \
            jwin.window_to_flat(jnp.asarray(wf), jnp.asarray(idx), jspec)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# SparseBasicBlock with spatial attention
# ---------------------------------------------------------------------------

def test_sparse_basic_block_with_sa_equals_jax():
    """Training mode: output, input gradient, every parameter gradient and
    the new BatchNorm statistics, the weights (the SALayer kernel
    [27, C, 1] included) through the bridge both ways."""
    rng = np.random.RandomState(6)
    shape, c = (6, 6, 6), 8
    coords, feats = _make_sparse(rng, 2, 48, 36, shape, c)
    mask = coords[..., 0] >= 0
    cot = rng.randn(2, 48, c).astype(np.float32)
    jst = jsc.SparseTensor(features=jnp.asarray(feats), coords=jnp.asarray(coords),
                           spatial_shape=shape)
    jrule = jax.jit(jsc.build_planar_k3_direct)(jst)
    jblock = JaxSparseBasicBlock(c, with_sa=True)
    shapes = jax.eval_shape(functools.partial(jblock.init, train=True), jax.random.PRNGKey(0),
                            jnp.asarray(feats), jrule, jnp.asarray(mask))
    params, stats = _randomise(shapes['params'], rng), _randomise(shapes['batch_stats'], rng)
    assert params['SALayer_0']['kernel'].shape == (27, c, 1)

    def jloss(p, x):
        y, mut = jblock.apply({'params': p, 'batch_stats': stats}, x, jrule,
                              jnp.asarray(mask), train=True, mutable=['batch_stats'])
        return (y * jnp.asarray(cot)).sum(), (y, mut['batch_stats'])

    (_, (jy, jstats)), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(feats))

    block = SparseBasicBlock(c, with_sa=True).train()
    load_flax_variables(block, params, stats)
    x = t(feats).requires_grad_()
    rule = sc.build_subm_rulebook(sc.SparseTensor(t(feats), t(coords), shape))
    y = block(x, rule, t(mask))
    (y * t(cot)).sum().backward()
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **tol)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgx), **tol)
    grads, _ = to_flax_variables(block, grads=True)
    new_params, new_stats = to_flax_variables(block)
    for mine, ref in ((grads, jax.device_get(jgp)), (new_stats, jax.device_get(jstats)),
                      (new_params, params)):
        for path, want in jax.tree_util.tree_leaves_with_path(ref):
            got = functools.reduce(lambda d, k: d[k.key], path, mine)
            np.testing.assert_allclose(got, np.asarray(want), err_msg=str(path), **tol)
    assert np.abs(grads['SALayer_0']['kernel']).max() > 0
    init_weights(block, torch.Generator().manual_seed(0))
    assert float(block.SALayer_0.kernel.detach().abs().max()) > 0


# ---------------------------------------------------------------------------
# point ops
# ---------------------------------------------------------------------------

def _cloud(rng, p=120, q=50, c=5):
    xyz = rng.uniform(-2, 2, (p, 3)).astype(np.float32)
    xyz[7] = xyz[3]                                     # a duplicated point: a tie
    return (xyz, rng.uniform(-2, 2, (q, 3)).astype(np.float32),
            rng.randn(p, c).astype(np.float32), rng.rand(p) > 0.2, rng.rand(q) > 0.1)


@pytest.mark.parametrize('case', ['queries', 'self', 'no_xyz'])
def test_query_and_group_equals_jax(case):
    rng = np.random.RandomState(7)
    xyz, new_xyz, feat, pv, qv = _cloud(rng)
    if case == 'self':
        new_xyz, qv = None, None
    kw = dict(p_valid=pv, q_valid=qv, use_xyz=case != 'no_xyz')
    got = pointops.query_and_group(
        8, t(xyz), None if new_xyz is None else t(new_xyz), t(feat),
        **{k: (t(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()})
    want = jpointops.query_and_group(
        8, jnp.asarray(xyz), None if new_xyz is None else jnp.asarray(new_xyz),
        jnp.asarray(feat), **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                              for k, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert got.shape[-1] == (8 if case != 'no_xyz' else 5)


def test_interpolation_equals_jax():
    rng = np.random.RandomState(8)
    xyz, new_xyz, feat, pv, qv = _cloud(rng)
    jidx, jdist = jknn.knn_query(3, jnp.asarray(xyz)[None], jnp.asarray(new_xyz)[None],
                                 jnp.asarray(pv)[None], jnp.asarray(qv)[None])
    idx, dist = np.array(jidx[0]), np.array(jdist[0])
    dist = np.where(idx >= 0, np.abs(dist), 1.0).astype(np.float32)
    got = pointops.interpolation(t(idx), t(dist), t(feat))
    want = jpointops.interpolation(jnp.asarray(idx), jnp.asarray(dist), jnp.asarray(feat))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# furthest point sampling
# ---------------------------------------------------------------------------

def _fps_case(case, rng):
    if case == 'random':
        pts = rng.uniform(-5, 5, (300, 3)).astype(np.float32)
        return pts, rng.rand(300) > 0.4, 64
    if case == 'ties':
        # the corners of a cube and its centre, twice: every pick after the
        # first is a tie between equidistant corners
        g = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)]
                     + [[0, 0, 0]], np.float32)
        return np.concatenate([g, g]), np.ones(18, bool), 12
    # fewer valid points than samples, the first of them not at index 0
    pts = rng.uniform(-5, 5, (40, 3)).astype(np.float32)
    valid = np.zeros(40, bool)
    valid[[3, 9, 10, 22, 31]] = True
    return pts, valid, 16


@pytest.mark.parametrize('case', ['random', 'ties', 'few_valid'])
def test_furthest_point_sample_equals_jax(case):
    pts, valid, k = _fps_case(case, np.random.RandomState(9))
    got = sampling.furthest_point_sample(t(pts), t(valid), k)
    want = jsampling.furthest_point_sample(jnp.asarray(pts), jnp.asarray(valid), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32


def test_batched_furthest_point_sample_equals_jax():
    rng = np.random.RandomState(10)
    pts = rng.uniform(-3, 3, (3, 200, 3)).astype(np.float32)
    valid = rng.rand(3, 200) > 0.5
    valid[2] = False
    valid[2, 150:153] = True                            # 3 valid points for 20 samples
    got = sampling.batched_furthest_point_sample(t(pts), t(valid), 20)
    want = jsampling.batched_furthest_point_sample(jnp.asarray(pts), jnp.asarray(valid), 20)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('capacity', [None, 40])
def test_sectorized_fps_equals_jax(capacity):
    """Six sectors over 1500 points; with capacity 40 the sectors overflow
    and their later points are left out."""
    rng = np.random.RandomState(11)
    pts = rng.uniform(-10, 10, (1500, 3)).astype(np.float32)
    valid = rng.rand(1500) > 0.3
    got = sampling.sectorized_fps(t(pts), t(valid), 100, 6, capacity)
    want = jsampling.sectorized_fps(jnp.asarray(pts), jnp.asarray(valid), 100, 6, capacity)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert valid[got.numpy()].all()


# ---------------------------------------------------------------------------
# visualize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('what', ['write_pcd', 'draw_points', 'draw_voxels'])
def test_pcd_bytes_equal_jax(tmp_path, what):
    rng = np.random.RandomState(12)
    palette = rng.randint(0, 256, (22, 3))
    n = 50
    sample = {'points': rng.uniform(-50, 50, (n, 6)).astype(np.float32),
              'point_labels': np.where(rng.rand(n) > 0.1, rng.randint(0, 22, n), 255),
              'voxel_coords': rng.randint(0, 100, (n, 3)).astype(np.int32),
              'voxel_labels': rng.randint(0, 22, n), 'filename': 'frame'}
    out = {}
    for name, mod in (('mine', visualize), ('ref', jvisualize)):
        d = tmp_path / name
        if what == 'write_pcd':
            path = str(d / 'cloud.pcd')
            mod.write_pcd(path, sample['points'][:, :3], palette[sample['voxel_labels']])
        elif what == 'draw_points':
            path = mod.draw_points(palette, sample, str(d))
        else:
            path = mod.draw_voxels(palette, [0.1, 0.1, 0.15], [-75.2, -75.2, -2, 75.2, 75.2, 4],
                                   sample, str(d))
        with open(path, 'rb') as f:
            out[name] = f.read()
    assert out['mine'] == out['ref'] and out['mine'].count(b'\n') == n + 11

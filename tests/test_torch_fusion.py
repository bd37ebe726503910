"""The port's DeepFusion branch (image features) against the JAX package's.

  * ``ops/knn.knn_query`` (k = 1 and k > 1) and ``ops/knn.voxel_bucket_knn``
    (kernel 3 and 5, bucket overflow, invalid points and queries, a
    duplicated point, so that equal distances meet): indices bit-equal to
    JAX's; distances within 1e-6 (the bucket search's direct squared
    differences) or 1e-6 of |q|^2 + |p|^2 (the brute-force expansion,
    whose cancellation sets its rounding); and the JAX tests' own
    scenarios on the port;
  * ``models/deep_fusion.DeepFusionBlock`` on both search paths: float32
    within 1e-5; bfloat16 within twice JAX's own bf16-vs-float32 error;
  * Segformer and SPNet with image features: the forward in float32 within
    1e-4, in bfloat16 within 4e-2 of the largest logit (the tolerance of
    tests/test_torch_segformer.py), both against JAX's float32 forward,
    traced once a segmentor; one Segformer train step (dropout off on
    both sides, as tests/test_torch_train.py does it): the loss, every
    gradient leaf (the DeepFusion leaves included), the BatchNorm
    statistics and the parameters after one SGD step, each within 1e-4 of
    max(1, the leaf's largest element) (a conv bias ahead of BatchNorm has
    a true gradient of 0, so its rounding noise has no scale of its own);
  * the weight bridge both ways with the DeepFusion leaves, and
    ``data/synthetic.make_tree``'s image-feature files read back through
    the port's Waymo reader exactly as through the JAX package's.

The clouds are clustered, so that the 27-voxel shells hold the 16
neighbours for many points and the attention has something to weigh.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openseg3d_tpu.engine import build_segmentor as jax_build_segmentor
from openseg3d_tpu.models.deep_fusion import DeepFusionBlock as JaxDeepFusionBlock
from openseg3d_tpu.ops.knn import knn_query as jax_knn_query
from openseg3d_tpu.ops.knn import voxel_bucket_knn as jax_voxel_bucket_knn

from openseg3d_tpu_torch.config import cfg_from_file, grid_size
from openseg3d_tpu_torch.core.voxelizer import (VoxelGenerator, majority_voxel_labels,
                                                points_to_voxel)
from openseg3d_tpu_torch.data.batch import collate_padded, pad_sample, to_device
from openseg3d_tpu_torch.data.synthetic import make_tree, synthetic_image_features
from openseg3d_tpu_torch.data.waymo_dataset import WaymoDataset
from openseg3d_tpu_torch.engine import build_segmentor
from openseg3d_tpu_torch.models.deep_fusion import DeepFusionBlock
from openseg3d_tpu_torch.ops.knn import knn_query, voxel_bucket_knn
from openseg3d_tpu_torch.weights import load_flax_variables, to_flax_variables

from helpers import TINY_OVERRIDES, tiny_cfg
from test_torch_segformer import _randomise
from test_torch_train import _leaves, _step_both

IMAGE = {'USE_IMAGE_FEATURE': True, 'DIM_IMAGE_FEATURE': 28}
BF16_LOGIT_TOL = 4e-2
BF16_NOISE_FACTOR = 2.0


def _clustered(rng, n, centres, sigma):
    xyz = centres[rng.randint(0, len(centres), n)] + rng.normal(0, sigma, (n, 3))
    return xyz.astype(np.float32)


# --- neighbour searches ---------------------------------------------------

def _knn_inputs(seed):
    """B = 2 clouds of 300 points with 100 queries each: some points and
    queries invalid, one point duplicated, and a query on a point."""
    rng = np.random.RandomState(seed)
    centres = rng.uniform(0, 4, (5, 3))
    pts = np.stack([_clustered(rng, 300, centres, 0.4) for _ in range(2)])
    pts[:, 7] = pts[:, 3]
    qs = np.stack([_clustered(rng, 100, centres, 0.4) for _ in range(2)])
    qs[:, 0] = pts[:, 3]
    p_valid = rng.rand(2, 300) > 0.1
    p_valid[:, [3, 7]] = True
    q_valid = rng.rand(2, 100) > 0.2
    q_valid[:, 0] = True
    return pts, qs, p_valid, q_valid


@pytest.mark.parametrize('k', [1, 5])
def test_knn_query_matches_jax(k):
    pts, qs, p_valid, q_valid = _knn_inputs(0)
    j_idx, j_dist = jax_knn_query(k, jnp.asarray(pts), jnp.asarray(qs), jnp.asarray(p_valid),
                                  jnp.asarray(q_valid))
    idx, dist = knn_query(k, torch.from_numpy(pts), torch.from_numpy(qs),
                          torch.from_numpy(p_valid), torch.from_numpy(q_valid))
    assert idx.dtype == torch.int32 and idx.shape == (2, 100, k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    scale = float((qs ** 2).sum(-1).max() + (pts ** 2).sum(-1).max())
    np.testing.assert_allclose(dist.numpy(), np.asarray(j_dist), rtol=1e-6, atol=1e-6 * scale)
    assert (idx.numpy()[~q_valid] == -1).all()
    if k > 1:       # the duplicated pair: distance 0 twice, the lower index first
        np.testing.assert_array_equal(idx.numpy()[:, 0, :2], [[3, 7], [3, 7]])


def _bucket_inputs(seed, n=600):
    """B = 2 dense clouds voxelized at 0.5 m on a 16 x 16 x 8 grid (as the
    JAX package's test), a duplicated point, invalid points and queries."""
    rng = np.random.RandomState(seed)
    vs, rg = [0.5] * 3, [0, 0, 0, 8, 8, 4]
    pts = rng.uniform(0.01, 3.99, (2, n, 3)).astype(np.float32)
    pts[:, 11] = pts[:, 10]
    pvid = np.stack([points_to_voxel(p, vs, rg)[1] for p in pts])
    coords = [points_to_voxel(p, vs, rg)[0] for p in pts]
    vc = -np.ones((2, max(len(c) for c in coords) + 5, 3), np.int32)
    for b, c in enumerate(coords):
        vc[b, :len(c)] = c
    p_valid = rng.rand(2, n) > 0.05
    p_valid[:, [10, 11]] = True
    q_valid = rng.rand(2, n) > 0.1
    return pts, p_valid, q_valid, pvid, vc, (8, 16, 16)


@pytest.mark.parametrize('kernel_size,bucket_cap', [(3, 8), (3, 2), (5, 4)])
def test_voxel_bucket_knn_matches_jax(kernel_size, bucket_cap):
    """Bucket cap 2 drops points of most voxels (overflow); kernel 5 widens
    the shell to 125 voxels. The port's tile (100 rows) differs from JAX's
    (128): the result does not depend on it."""
    pts, p_valid, q_valid, pvid, vc, shape = _bucket_inputs(1)
    j_idx, j_dist = jax.jit(functools.partial(
        jax_voxel_bucket_knn, 8, spatial_shape=shape, bucket_cap=bucket_cap, tile=128,
        kernel_size=kernel_size))(*map(jnp.asarray, (pts, p_valid, q_valid, pvid, vc)))
    idx, dist = voxel_bucket_knn(8, *map(torch.from_numpy, (pts, p_valid, q_valid, pvid, vc)),
                                 shape, bucket_cap=bucket_cap, tile=100,
                                 kernel_size=kernel_size)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(dist.numpy(), np.asarray(j_dist), rtol=1e-6, atol=1e-6)
    assert (idx.numpy()[~q_valid] == -1).all()
    assert (idx.numpy()[q_valid] == -1).mean() < (0.5 if bucket_cap == 2 else 0.05)


def test_voxel_bucket_knn_matches_brute_force_where_the_shell_suffices():
    """The JAX package's scenario (tests/test_native_and_ops.py): within the
    27-voxel shell the bucket search is exact, so every query whose true 8
    nearest lie in adjacent voxels gets the brute-force neighbour set."""
    rng = np.random.RandomState(7)
    vs, rg = [0.5] * 3, [0, 0, 0, 8, 8, 4]
    pts = rng.uniform(0.01, 3.99, (600, 3)).astype(np.float32)
    coords, pvid = points_to_voxel(pts, vs, rg)
    vc = -np.ones((coords.shape[0] + 5, 3), np.int32)
    vc[:coords.shape[0]] = coords
    valid = torch.ones((1, 600), dtype=torch.bool)
    idx, _ = voxel_bucket_knn(8, torch.from_numpy(pts[None]), valid, valid,
                              torch.from_numpy(pvid[None]), torch.from_numpy(vc[None]),
                              (8, 16, 16), bucket_cap=64)
    brute = np.argsort(np.sum((pts[:, None] - pts[None]) ** 2, axis=-1), axis=1)[:, :8]
    czyx = coords[pvid]
    checked = 0
    for i in range(600):
        if np.all(np.abs(czyx[brute[i]] - czyx[i]) <= 1):
            checked += 1
            assert set(idx[0, i].tolist()) == set(brute[i].tolist()), i
    assert checked > 300


def test_voxel_bucket_knn_masks_and_self():
    """The JAX package's scenario: self is a neighbour at distance 0, an
    invalid query gets -1 everywhere, an isolated point only itself."""
    vs, rg = [0.5] * 3, [0, 0, 0, 8, 8, 4]
    pts = np.array([[1.1, 1.1, 1.1], [1.2, 1.2, 1.2], [7.5, 7.5, 3.5]], np.float32)
    coords, pvid = points_to_voxel(pts, vs, rg)
    vc = -np.ones((8, 3), np.int32)
    vc[:coords.shape[0]] = coords
    idx, dist = voxel_bucket_knn(2, torch.from_numpy(pts[None]), torch.ones((1, 3), dtype=bool),
                                 torch.tensor([[True, False, True]]),
                                 torch.from_numpy(pvid[None]), torch.from_numpy(vc[None]),
                                 (8, 16, 16), tile=2)
    idx = idx[0].tolist()
    assert set(idx[0]) == {0, 1} and idx[1] == [-1, -1] and idx[2] == [2, -1]
    assert float(dist[0, 0, 0]) == 0.0


# --- the block ------------------------------------------------------------

def _block_inputs(seed, cl=96, ci=28, n=400):
    """B = 2: 400 clustered points (the last 50 of sample 1 padding) on the
    tiny config's grid, lidar features, image features with the rear
    sector zero (synthetic_image_features), the voxel structure."""
    cfg = tiny_cfg()
    rng = np.random.RandomState(seed)
    centres = rng.uniform(-2.5, 2.5, (4, 3)) * [1, 1, 0.2]
    pts = np.stack([_clustered(rng, n, centres, 0.3) for _ in range(2)])
    mask = np.ones((2, n), bool)
    mask[1, -50:] = False
    vg = VoxelGenerator(cfg.DATASET.VOXEL_SIZE, cfg.DATASET.POINT_CLOUD_RANGE)
    pvid = -np.ones((2, n), np.int32)
    vc = -np.ones((2, 512, 3), np.int32)
    for b in range(2):
        coords, ids = vg.generate(pts[b][mask[b]])
        vc[b, :len(coords)], pvid[b, mask[b]] = coords, ids
    lidar = rng.randn(2, n, cl).astype(np.float32)
    img = np.stack([synthetic_image_features(rng, p, ci) for p in pts])
    img[~mask] = 0
    return dict(points_xyz=pts, point_mask=mask, lidar=lidar, img=img, pvid=pvid, vc=vc,
                shape=tuple(grid_size(cfg))[::-1])


def _jax_block(d, params, dtype, bucket):
    block = JaxDeepFusionBlock(image_channel=d['img'].shape[-1])
    kw = dict(point_voxel_ids=jnp.asarray(d['pvid']), voxel_coords=jnp.asarray(d['vc']),
              spatial_shape=d['shape']) if bucket else {}
    fn = jax.jit(lambda p, *a: block.apply({'params': p}, *a, False, **kw))
    return np.asarray(fn(params, jnp.asarray(d['points_xyz']), jnp.asarray(d['point_mask']),
                         jnp.asarray(d['lidar']).astype(dtype), jnp.asarray(d['img'])),
                      np.float32)


@pytest.mark.parametrize('bucket', [True, False], ids=['bucket', 'brute'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_deep_fusion_block_matches_jax(bucket, dtype):
    d = _block_inputs(2)
    shapes = jax.eval_shape(
        lambda: JaxDeepFusionBlock(image_channel=28).init(
            jax.random.PRNGKey(0), jnp.asarray(d['points_xyz']), jnp.asarray(d['point_mask']),
            jnp.asarray(d['lidar']), jnp.asarray(d['img']), False))
    params = _randomise(shapes['params'], np.random.RandomState(3))
    assert params['kv_proj']['kernel'].shape == (28, 2, 32)
    block = DeepFusionBlock(96, 28, knn_kernel_size=3, knn_bucket_cap=8)
    load_flax_variables(block, params, {})
    block.eval()
    dt = getattr(torch, dtype)
    kw = dict(point_voxel_ids=torch.from_numpy(d['pvid']), voxel_coords=torch.from_numpy(d['vc']),
              spatial_shape=d['shape']) if bucket else {}
    with torch.no_grad():
        out = block(torch.from_numpy(d['points_xyz']), torch.from_numpy(d['point_mask']),
                    torch.from_numpy(d['lidar']).to(dt), torch.from_numpy(d['img']), **kw)
    assert out.dtype == dt and out.shape == d['img'].shape
    got = out.float().numpy()
    assert not got[~d['point_mask']].any()
    ref32 = _jax_block(d, params, jnp.float32, bucket)
    if dtype == 'float32':
        np.testing.assert_allclose(got, ref32, rtol=1e-5, atol=1e-5)
        return
    own = float(np.abs(_jax_block(d, params, jnp.bfloat16, bucket) - ref32).max())
    err = float(np.abs(got - ref32).max())
    print(f'bf16 block: port {err:.3g}, JAX bf16 {own:.3g} from JAX float32 (max '
          f'{float(np.abs(ref32).max()):.3g})')
    assert err <= BF16_NOISE_FACTOR * own, (err, own)


# --- the segmentors -------------------------------------------------------

def _fusion_batch(cfg, batch_size=2, n_points=900, seed=0):
    """Padded batch of clustered clouds with labels and synthetic image
    features (each cloud in 4 clusters of sigma 0.25 m: ~300 voxels)."""
    rng = np.random.RandomState(seed)
    vg = VoxelGenerator(cfg.DATASET.VOXEL_SIZE, cfg.DATASET.POINT_CLOUD_RANGE)
    samples = []
    for _ in range(batch_size):
        centres = rng.uniform(-2.4, 2.4, (4, 3)) * [1, 1, 0.2]
        xyz = _clustered(rng, n_points, centres, 0.25)
        points = np.concatenate([xyz, rng.randn(n_points, 3).astype(np.float32)], 1)
        coords, ids = vg.generate(points)
        labels = rng.randint(0, cfg.DATASET.NUM_CLASSES, n_points)
        samples.append(pad_sample(dict(
            points=points, voxel_coords=coords, point_voxel_ids=ids, point_labels=labels,
            voxel_labels=majority_voxel_labels(ids, labels, coords.shape[0]),
            point_image_features=synthetic_image_features(
                rng, xyz, cfg.DATASET.DIM_IMAGE_FEATURE)),
            cfg.RUNTIME.MAX_POINTS_PER_SAMPLE, cfg.RUNTIME.MAX_VOXELS_PER_SAMPLE))
    return collate_padded(samples)


def _segmentor_cfg(segmentor, dtype='float32', **extra):
    model = {'SEGMENTOR': segmentor, 'DEPTHS': [1, 1, 1, 1], **extra.pop('MODEL', {})}
    return tiny_cfg(MODEL=model,
                    DATASET=IMAGE, RUNTIME={'COMPUTE_DTYPE': dtype}, **extra)


def _jax_variables(jmodel, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items() if k != 'batch_size'}
    shapes = jax.eval_shape(functools.partial(jmodel.init, train=False),
                            {'params': jax.random.PRNGKey(0)}, jb)
    rng = np.random.RandomState(0)
    return _randomise(shapes['params'], rng), _randomise(shapes['batch_stats'], rng), jb


@pytest.fixture(scope='module')
def jax_forwards():
    """segmentor -> (params, batch_stats, batch, JAX's float32 eval outputs),
    each computed once for this module: random weights over the flax
    model's own tree (the bridge test reads it too)."""
    done = {}

    def get(segmentor):
        if segmentor not in done:
            cfg = _segmentor_cfg(segmentor)
            jmodel, _ = jax_build_segmentor(cfg)
            nb = _fusion_batch(cfg, batch_size=1, seed=4)
            params, stats, jb = _jax_variables(jmodel, nb)
            ref = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
                {'params': params, 'batch_stats': stats}, jb)
            done[segmentor] = (params, stats, nb,
                               {k: np.asarray(v, np.float32) for k, v in ref.items()})
        return done[segmentor]

    return get


@pytest.mark.parametrize('segmentor', ['segformer', 'spnet'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_forward_with_image_features_matches_jax(jax_forwards, segmentor, dtype):
    params, stats, nb, ref = jax_forwards(segmentor)
    model, _ = build_segmentor(_segmentor_cfg(segmentor, dtype), device='cpu')
    load_flax_variables(model, params, stats)
    with torch.inference_mode():
        out = model.eval()(to_device(nb, 'cpu'))
    for k in ('point_out', 'voxel_out', 'aux_voxel_out'):
        got, want = out[k].float().numpy(), ref[k]
        if dtype == 'float32':
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=k)
        else:
            err = float(np.abs(got - want).max()) / float(np.abs(want).max())
            print(f'{k}: max abs diff / max abs logit {err:.3g}')
            assert err <= BF16_LOGIT_TOL, (k, err)


def test_train_step_with_image_features_matches_jax(monkeypatch, jax_forwards):
    """One Segformer step from the same weights (the forward tests') on the
    same batch, dropout
    off on both sides (the port's rates at 0, DeepFusion's included, and
    flax's nn.Dropout patched to the identity), the same aux labels; SGD
    with momentum at the recipe's first learning rate."""
    cfg = _segmentor_cfg('segformer', MODEL={'DROP_PATH_RATE': 0.0},
                         TRAIN={'OPTIMIZER': 'sgd', 'LR': 50.0, 'MOMENTUM': 0.9,
                                'WEIGHT_DECAY': 1e-4})
    # batch seed 6: on seed 5 one OHEM keep decision sits within float32
    # noise of its threshold, and the two packages choose differently there
    # (OHEM alone: worst leaf 2.9e-4; Lovasz alone: 3.6e-6)
    nb = _fusion_batch(cfg, batch_size=2, seed=6)
    metrics, grads, new_stats, new_params, jloss, jgrads, jstats, jparams, _ = \
        _step_both(monkeypatch, cfg, nb, jax_forwards('segformer')[:2])
    np.testing.assert_allclose(float(metrics['loss']), float(jloss), rtol=1e-4, atol=1e-4)
    assert set(grads['DeepFusionBlock_0']) == {'Dense_0', 'kv_proj', 'Dense_1'}
    fusion = {p: g for p, g in _leaves(grads) if p[0] == 'DeepFusionBlock_0'}
    assert all(np.abs(g).max() > 0 for g in fusion.values()), fusion.keys()
    for what, mine, ref in (('grad', grads, jgrads), ('batch_stats', new_stats, jstats),
                            ('params', new_params, jparams)):
        a, b = dict(_leaves(mine)), dict(_leaves(ref))
        assert set(a) == set(b), what
        errs = {'/'.join(p): float(np.abs(a[p] - b[p]).max()) / max(1.0, float(np.abs(b[p]).max()))
                for p in b}
        worst = max(errs.items(), key=lambda kv: kv[1])
        print(f'{what}: worst leaf {worst}')
        assert worst[1] <= 1e-4, (what, worst)


@pytest.mark.parametrize('segmentor', ['segformer', 'spnet'])
def test_weight_bridge_carries_the_deep_fusion_leaves(jax_forwards, segmentor):
    """load_flax_variables then to_flax_variables gives every leaf of the
    flax model's tree back, kv_proj's [Ci, 2, hidden] kernel and [2, hidden]
    bias included; the head takes dim_image_feature more inputs."""
    cfg = _segmentor_cfg(segmentor)
    params, stats, _, _ = jax_forwards(segmentor)
    df = params['DeepFusionBlock_0']
    assert df['kv_proj']['kernel'].shape == (28, 2, 32) and df['kv_proj']['bias'].shape == (2, 32)
    model, _ = build_segmentor(cfg, device='cpu')
    load_flax_variables(model, params, stats)
    got_params, got_stats = to_flax_variables(model)
    for mine, ref in ((got_params, params), (got_stats, stats)):
        a, b = dict(_leaves(mine)), dict(_leaves(ref))
        assert set(a) == set(b)
        for path in b:
            np.testing.assert_array_equal(a[path], b[path], err_msg='/'.join(path))
    head_in = params['SegmentorHead_0']['LinearBNReLU_0']['Dense_0']['kernel'].shape[0]
    assert head_in == 64 + (32 if segmentor == 'segformer' else 64) + 28


def test_image_feature_files_read_as_in_jax(tmp_path):
    """make_tree's image_feature/<frame>.npy ({point index: vector} for the
    points a camera sees) through the port's WaymoDataset equal the JAX
    package's reading of the same tree, array for array, in validation
    mode; the rear sector reads as zero rows. Both packages voxelize on
    their C++ voxelizer where it builds (``_on_numpy``: both on numpy)."""
    from openseg3d_tpu import native
    from openseg3d_tpu.config import cfg_from_file as jax_cfg_from_file
    from openseg3d_tpu.data.waymo_dataset import WaymoDataset as JaxWaymoDataset
    from openseg3d_tpu_torch import native as port_native
    assert native.available() == port_native.available()
    names = make_tree(str(tmp_path), 2, 3000, image_feature_dim=28)
    ov = {k: dict(v) for k, v in TINY_OVERRIDES.items()}
    ov['DATASET'] = dict(ov['DATASET'], POINT_CLOUD_RANGE=[-75.2, -75.2, -2, 75.2, 75.2, 4],
                         VOXEL_SIZE=[0.1, 0.1, 0.1], **IMAGE)
    ov['RUNTIME'] = dict(ov['RUNTIME'], MAX_POINTS_PER_SAMPLE=4096, MAX_VOXELS_PER_SAMPLE=4096)
    ours = WaymoDataset(cfg_from_file(None, overrides=ov), str(tmp_path), 'validation')
    theirs = JaxWaymoDataset(jax_cfg_from_file(None, overrides=ov), str(tmp_path), 'validation')
    assert ours.filenames == theirs.filenames == names
    for i in range(2):
        a, b = ours[i], theirs[i]
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
        f, xyz = a['point_image_features'], a['points'][:, :3]
        assert f.shape == (3000, 28) and f.dtype == np.float32
        behind = np.abs(np.arctan2(xyz[:, 1], xyz[:, 0])) > 2 * np.pi / 3
        assert not f[behind].any() and (np.abs(f[~behind]).sum(1) > 0).all()
        pad = ours.pad(a)
        assert pad['point_image_features'].shape == (4096, 28)


def test_image_feature_files_read_as_in_jax_on_numpy(tmp_path, monkeypatch):
    from openseg3d_tpu import native
    from openseg3d_tpu_torch import native as port_native
    monkeypatch.setattr(native, 'available', lambda: False)
    monkeypatch.setattr(port_native, 'available', lambda: False)
    test_image_feature_files_read_as_in_jax(tmp_path)

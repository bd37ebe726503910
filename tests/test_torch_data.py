"""The port's host data path against the JAX package's: the global
augmentations, PolarMix, instance paste, the synthetic and Waymo datasets,
the loader's index order and the TTA variants. Both sides are numpy code that
draws from the global ``np.random`` in the same order, so under one seed every
array is exactly equal. Both packages voxelize with their C++ extension when
it builds (the port's is a copy of the JAX package's source), which multiplies
by the reciprocal of the voxel size where the numpy path divides, so a point
on a voxel boundary can land one voxel apart from the numpy path: each side
runs the same path, the C++ one (each package's production path) and, in the
``_on_numpy`` cases, both on numpy."""

import os

import numpy as np
import pytest

from openseg3d_tpu.data import transforms as JT
from openseg3d_tpu.data.instance_augmentation import \
    InstanceAugmentation as JaxInstanceAugmentation
from openseg3d_tpu.data.loader import DataLoader as JaxDataLoader
from openseg3d_tpu.data.polarmix import PolarMix as JaxPolarMix
from openseg3d_tpu.data.synthetic import SyntheticDataset as JaxSyntheticDataset
from openseg3d_tpu.data.test_time_aug import MultiScaleFlipAug as JaxMultiScaleFlipAug
from openseg3d_tpu.data.waymo_dataset import WaymoDataset as JaxWaymoDataset
from openseg3d_tpu.parallel.mesh import process_shard_indices as jax_shard_indices

from openseg3d_tpu_torch.config import cfg_from_file
from openseg3d_tpu_torch.data import transforms as T
from openseg3d_tpu_torch.data.instance_augmentation import InstanceAugmentation
from openseg3d_tpu_torch.data.loader import DataLoader, process_shard_indices
from openseg3d_tpu_torch.data.polarmix import PolarMix
from openseg3d_tpu_torch.data.synthetic import SyntheticDataset, make_waymo_like_cloud
from openseg3d_tpu_torch.data.test_time_aug import MultiScaleFlipAug
from openseg3d_tpu_torch.data.waymo_dataset import WaymoDataset
from openseg3d_tpu_torch.utils.pointops import cart2polar

from openseg3d_tpu.config import cfg_from_file as jax_cfg_from_file
from openseg3d_tpu.utils.pointops import cart2polar as jax_cart2polar
from bench import make_waymo_like_cloud as bench_make_waymo_like_cloud
from tools.rehearsal import make_tree

from helpers import TINY_OVERRIDES

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), 'configs')


@pytest.fixture(autouse=True)
def same_voxelizer():
    """Both packages take the same voxelization path."""
    from openseg3d_tpu import native as jax_native
    from openseg3d_tpu_torch import native
    assert native.available() == jax_native.available()


@pytest.fixture
def numpy_voxelizer(monkeypatch):
    """Both packages on their numpy voxelizer."""
    from openseg3d_tpu import native as jax_native
    from openseg3d_tpu_torch import native
    monkeypatch.setattr(jax_native, 'available', lambda: False)
    monkeypatch.setattr(native, 'available', lambda: False)


def _same(a, b, what=''):
    """Equal values, dtypes and keys, for arrays, tuples and dicts."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), what
        for k in a:
            _same(a[k], b[k], f'{what}/{k}')
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f'{what}[{i}]')
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)
        assert np.asarray(a).dtype == np.asarray(b).dtype, what


def _seeded(seed, fn, *args):
    np.random.seed(seed)
    return fn(*args)


def _sample(rng, n=3000, multi_sweep=False):
    pts = np.concatenate([rng.uniform(-60, 60, (n, 2)), rng.uniform(-2, 4, (n, 1)),
                          rng.randn(n, 3)], 1).astype(np.float32)
    d = {'points': pts}
    cur = np.sort(rng.choice(n, n // 2, replace=False)) if multi_sweep else np.arange(n)
    if multi_sweep:
        d['cur_point_indices'] = cur
    d['point_labels'] = rng.randint(0, 22, cur.shape[0])
    d['point_image_features'] = rng.randn(cur.shape[0], 4).astype(np.float32)
    return d


def _copy(d):
    return {k: v.copy() for k, v in d.items()}


@pytest.mark.parametrize('multi_sweep', [False, True])
def test_transforms_equal_jax(multi_sweep):
    rng = np.random.RandomState(0)
    d = _sample(rng, multi_sweep=multi_sweep)
    pairs = [
        (T.RandomGlobalRotation([-0.78539816, 0.78539816]),
         JT.RandomGlobalRotation([-0.78539816, 0.78539816])),
        (T.RandomGlobalScaling([0.95, 1.05]), JT.RandomGlobalScaling([0.95, 1.05])),
        (T.RandomGlobalTranslation(0.5), JT.RandomGlobalTranslation(0.5)),
        (T.RandomFlip(), JT.RandomFlip()),
        (T.PointShuffle(), JT.PointShuffle()),
        (T.PointSample(0.95, 50.0), JT.PointSample(0.95, 50.0)),
        (T.PointSample(0.5), JT.PointSample(0.5)),
        (T.RandomDropPointsColor(0.5), JT.RandomDropPointsColor(0.5)),
    ]
    for seed in range(4):
        for mine, ref in pairs:
            _same(_seeded(seed, mine, _copy(d)), _seeded(seed, ref, _copy(d)),
                  type(mine).__name__)
        composed = T.Compose([m for m, _ in pairs])
        _same(_seeded(seed, composed, _copy(d)),
              _seeded(seed, JT.Compose([r for _, r in pairs]), _copy(d)), 'Compose')
    _same(T.rotate_z(d['points'], 0.3), JT.rotate_z(d['points'], 0.3))
    _same(cart2polar(d['points']), jax_cart2polar(d['points']))


def test_polarmix_equal_jax():
    rng = np.random.RandomState(1)
    a, b = _sample(rng), _sample(rng)
    mine = PolarMix(instance_classes=list(range(13)), rot_angle_range=[0.5, 2.5])
    ref = JaxPolarMix(instance_classes=list(range(13)), rot_angle_range=[0.5, 2.5])
    swapped = set()
    for seed in range(6):                    # both sides of the p=0.5 sector swap
        for feats in (False, True):
            fa = a['point_image_features'] if feats else None
            fb = b['point_image_features'] if feats else None
            args = (a['points'], fa, a['point_labels'], b['points'], fb, b['point_labels'])
            got, want = _seeded(seed, mine, *args), _seeded(seed, ref, *args)
            _same(got, want, f'seed {seed} feats {feats}')
            swapped.add(got[0].shape[0])
    assert len(swapped) > 2


def _bank(path):
    import pickle
    rng = np.random.RandomState(2)
    bank = {lid: [{'cluster_points': (rng.uniform(-0.6, 0.6, (60, 6)) + [5, 5, -1.6, 0, 0, 0]
                                      ).astype(np.float32),
                   'cluster_height': 0.5} for _ in range(3)] for lid in (3, 4, 10)}
    with open(path, 'wb') as fh:
        pickle.dump(bank, fh)
    return str(path)


def test_instance_augmentation_equal_jax(tmp_path):
    path = _bank(tmp_path / 'bank.pkl')
    rng = np.random.RandomState(3)
    d = _sample(rng, n=4000)
    # ground around the bank's instances (labels 17-21), so placements succeed
    d['point_labels'][:2000] = 17 + d['point_labels'][:2000] % 5
    d['points'][:2000, :2] = rng.uniform(-8, 8, (2000, 2))
    d['points'][:2000, 2] = -1.7
    mine, ref = InstanceAugmentation(path), JaxInstanceAugmentation(path)
    grew = 0
    for seed in range(4):
        for feats in (None, d['point_image_features']):
            got = _seeded(seed, mine, d['points'], feats, d['point_labels'])
            want = _seeded(seed, ref, d['points'], feats, d['point_labels'])
            _same(got, want, f'seed {seed}')
            grew += got[0].shape[0] > d['points'].shape[0]
    assert grew > 0


def _tiny_cfgs(**sections):
    import copy
    ov = copy.deepcopy(TINY_OVERRIDES)
    for k, v in sections.items():
        ov.setdefault(k, {}).update(v)
    return cfg_from_file(None, overrides=ov), jax_cfg_from_file(None, overrides=ov)


@pytest.mark.parametrize('cylinder', [False, True])
def test_synthetic_dataset_equal_jax(cylinder):
    cfg, jcfg = _tiny_cfgs(DATASET={'USE_CYLINDER': cylinder})
    for mode, seed in (('training', 5), ('validation', 782)):
        mine = SyntheticDataset(cfg, 3, n_points=1500, mode=mode, seed=seed)
        ref = JaxSyntheticDataset(jcfg, 3, n_points=1500, mode=mode, seed=seed)
        assert len(mine) == len(ref) and mine.class_names == ref.class_names
        for i in range(3):
            _same(mine.load_padded(i), ref.load_padded(i), f'{mode} {i}')


@pytest.mark.parametrize('cylinder', [False, True])
def test_synthetic_dataset_equal_jax_on_numpy(numpy_voxelizer, cylinder):
    test_synthetic_dataset_equal_jax(cylinder)


@pytest.fixture(scope='module')
def waymo_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp('waymo')
    make_tree(str(root), 3, 4096)
    return str(root)


def test_waymo_like_cloud_equals_bench():
    """The port's copy of the benchmark frame generator gives bench.py's
    array, bit for bit, for the same RandomState."""
    got = make_waymo_like_cloud(np.random.RandomState(0), 3000)
    want = bench_make_waymo_like_cloud(np.random.RandomState(0), 3000)
    assert got.shape == (3000, 6) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('mode', ['training', 'validation'])
def test_waymo_dataset_equal_jax(waymo_tree, mode):
    path = os.path.join(CONFIGS, 'waymo_one_sweep.yaml')
    cfg, jcfg = cfg_from_file(path), jax_cfg_from_file(path)
    np.random.seed(7)                         # PolarMix's angles come from the constructor
    mine = WaymoDataset(cfg, waymo_tree, mode)
    np.random.seed(7)
    ref = JaxWaymoDataset(jcfg, waymo_tree, mode)
    assert mine.polar_mix.rot_angle_range == ref.polar_mix.rot_angle_range
    assert mine.filenames == ref.filenames and len(mine) == 3
    for i in range(len(mine)):
        got = _seeded(11 + i, mine.load_padded, i)
        _same(got, _seeded(11 + i, ref.load_padded, i), f'{mode} {i}')
        if mode == 'training':                # instance paste and PolarMix grew the cloud
            assert got[0]['num_points'] != 4096


@pytest.mark.parametrize('mode', ['training', 'validation'])
def test_waymo_dataset_equal_jax_on_numpy(numpy_voxelizer, waymo_tree, mode):
    test_waymo_dataset_equal_jax(waymo_tree, mode)


class _IndexDataset:
    """load_padded(i) -> a one-row sample holding i."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def load_padded(self, i):
        return {'index': np.asarray([i], np.int32)}, str(i)


@pytest.mark.parametrize('n,batch,shuffle', [(10, 3, True), (10, 3, False), (2, 4, False),
                                             (7, 1, True)])
def test_loader_order_equal_jax(n, batch, shuffle):
    for epoch in range(2):
        for valid in (False, True):
            _same(process_shard_indices(n, 5 if shuffle else None, epoch, batch,
                                        return_valid=valid),
                  jax_shard_indices(n, 5 if shuffle else None, epoch, batch,
                                    return_valid=valid))
    for drop_last in (True, False):
        kw = dict(shuffle=shuffle, num_workers=0, seed=5, drop_last=drop_last)
        mine = DataLoader(lambda: _IndexDataset(n), batch, **kw)
        ref = JaxDataLoader(lambda: _IndexDataset(n), batch, **kw)
        assert len(mine) == len(ref)
        for epoch in range(2):
            mine.set_epoch(epoch)
            ref.set_epoch(epoch)
            _same(list(mine), list(ref), f'epoch {epoch} drop_last {drop_last}')


def test_tta_variants_equal_jax():
    cfg, jcfg = _tiny_cfgs()
    mine_ds = SyntheticDataset(cfg, 1, n_points=1200, mode='validation')
    ref_ds = JaxSyntheticDataset(jcfg, 1, n_points=1200, mode='validation')
    mine, ref = MultiScaleFlipAug(mine_ds), JaxMultiScaleFlipAug(ref_ds)
    assert mine.num_variants() == ref.num_variants() == 36
    assert list(mine._variant_params()) == list(ref._variant_params())
    got = list(mine(mine_ds.load_raw(0)))
    want = list(ref(ref_ds.load_raw(0)))
    assert len(got) == 36
    _same(got, want)


def test_loader_workers_equal_inline():
    """Spawned workers (the config pickles across) give the inline batches."""
    import functools
    import pickle
    cfg, _ = _tiny_cfgs()
    assert pickle.loads(pickle.dumps(cfg)) == cfg
    factory = functools.partial(SyntheticDataset, cfg, 3, n_points=1000, seed=4)
    inline = DataLoader(factory, 1, num_workers=0, seed=3)
    pooled = DataLoader(factory, 1, num_workers=1, seed=3)
    try:
        _same(list(pooled), list(inline))
    finally:
        pooled.close()

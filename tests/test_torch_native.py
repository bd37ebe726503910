"""The port's C++ host voxelizer (``openseg3d_tpu_torch/native``) against the
JAX package's (``openseg3d_tpu/native``): the same source (up to a fix of
the capacity path, which no caller takes), built by each package with the
same flags, gives the same ids, coords and majority labels bit for bit,
points on voxel boundaries included; and a failed build says so
once and leaves ``VoxelGenerator`` on the numpy path."""

import logging

import numpy as np
import pytest

from openseg3d_tpu import native as jax_native

from openseg3d_tpu_torch import native
from openseg3d_tpu_torch.core.voxelizer import VoxelGenerator, points_to_voxel

VOXEL_SIZE = [0.1, 0.1, 0.15]
RANGE = [-75.2, -75.2, -2.0, 75.2, 75.2, 4.0]


def _cloud(kind, rng, n=20000):
    lo, hi = np.asarray(RANGE[:3]), np.asarray(RANGE[3:])
    if kind == 'uniform':          # 10% of the points out of range
        xyz = rng.uniform(lo * 1.1, hi * 1.1, (n, 3))
    elif kind == 'dense':          # many points a voxel, a small region
        xyz = rng.uniform(-2.0, 2.0, (n, 3)) * [1, 1, 0.5]
    else:                          # every coordinate exactly on a voxel boundary
        k = rng.randint(0, 1500, (n, 3)) * [1, 1, 0.03]
        xyz = lo + k.astype(np.int64) * np.asarray(VOXEL_SIZE)
    xyz = xyz.astype(np.float32)
    return np.concatenate([xyz, rng.randn(n, 2).astype(np.float32)], 1)


@pytest.fixture(scope='module', autouse=True)
def both_built():
    if not jax_native.available():
        pytest.skip('g++ cannot build the JAX package\'s voxelizer on this host')
    assert native.available(), native.build_error()


@pytest.mark.parametrize('kind,seed', [('uniform', 0), ('dense', 1), ('boundary', 2)])
def test_native_voxelizer_bit_equal_to_jax(kind, seed):
    rng = np.random.RandomState(seed)
    pts = _cloud(kind, rng)
    coords, ids = native.native_points_to_voxel(pts, VOXEL_SIZE, RANGE)
    jc, jids = jax_native.native_points_to_voxel(pts, VOXEL_SIZE, RANGE)
    np.testing.assert_array_equal(coords, jc)
    np.testing.assert_array_equal(ids, jids)
    assert coords.dtype == jc.dtype == ids.dtype == jids.dtype == np.int32
    assert (ids >= 0).any() and coords.shape[0] == ids.max() + 1
    # ascending linearized (z, y, x) key order, as the sparse conv needs
    key = (coords[:, 0].astype(np.int64) * 1504 + coords[:, 1]) * 1504 + coords[:, 2]
    assert (np.diff(key) > 0).all()
    # the port's VoxelGenerator takes this path
    vc, vids = VoxelGenerator(VOXEL_SIZE, RANGE).generate(pts)
    np.testing.assert_array_equal(vc, coords)
    np.testing.assert_array_equal(vids, ids)
    # with a capacity (no caller passes one; the port's copy fixes the
    # original's out-of-bounds read there): the first `cap` voxels in point
    # order are kept, in key order, and the points of the others drop
    cap = max(1, coords.shape[0] // 2)
    cc, cids = native.native_points_to_voxel(pts, VOXEL_SIZE, RANGE, cap)
    assert cc.shape[0] == cap and cids.max() == cap - 1
    first_seen = np.unique(ids[ids >= 0], return_index=True)[1]
    kept = np.sort(np.unique(ids[ids >= 0])[np.argsort(first_seen)][:cap])
    np.testing.assert_array_equal(cc, coords[kept])
    np.testing.assert_array_equal(cids >= 0, np.isin(ids, kept))
    np.testing.assert_array_equal(cc[cids[cids >= 0]], coords[ids[cids >= 0]])
    labels = rng.randint(0, 23, pts.shape[0])
    labels[::5] = 255
    np.testing.assert_array_equal(
        native.native_majority_labels(ids, labels, coords.shape[0] + 2),
        jax_native.native_majority_labels(ids, labels, coords.shape[0] + 2))
    # against the numpy path, printed: the reciprocal multiply puts a point
    # within an ulp of a boundary one voxel over
    nc, nids = points_to_voxel(pts, VOXEL_SIZE, RANGE)
    live = (ids >= 0) & (nids >= 0)
    moved = int((nc[nids[live]] != coords[ids[live]]).any(1).sum())
    print(f'{kind}: {coords.shape[0]} voxels; points in another voxel on the numpy path: '
          f'{moved}, in range on one path only: {int(((nids >= 0) != (ids >= 0)).sum())}')


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.records = []

    def emit(self, record):
        self.records.append(record)


def test_a_failed_build_warns_once_and_falls_back(monkeypatch, tmp_path):
    """A compiler that fails: one WARNING naming its error, available()
    False, VoxelGenerator on the numpy path, the native calls raising. (The
    records are taken at the module's logger: the package's logger, once a
    tool has set it up, does not pass them on to the root logger.)"""
    monkeypatch.setattr(native, '_lib', None)
    monkeypatch.setattr(native, '_error', None)
    monkeypatch.setattr(native, 'BUILD_DIR', tmp_path / 'build')
    monkeypatch.setattr(native, 'CXX_FLAGS', native.CXX_FLAGS + ('-fno-such-flag',))
    seen = _Records()
    native.logger.addHandler(seen)
    try:
        assert not native.available()
        assert not native.available()
    finally:
        native.logger.removeHandler(seen)
    warnings = [r for r in seen.records if r.levelno == logging.WARNING]
    assert len(warnings) == 1, warnings
    assert 'no-such-flag' in warnings[0].getMessage()
    assert 'no-such-flag' in native.build_error()
    assert not list((tmp_path / 'build').glob('*.so'))
    pts = _cloud('uniform', np.random.RandomState(3), 2000)
    got = VoxelGenerator(VOXEL_SIZE, RANGE).generate(pts)
    for x, y in zip(got, points_to_voxel(pts, VOXEL_SIZE, RANGE)):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(RuntimeError, match='no-such-flag'):
        native.native_points_to_voxel(pts, VOXEL_SIZE, RANGE)


def test_the_library_is_built_beside_nothing_of_the_source(monkeypatch, tmp_path):
    """A fresh build lands in the build directory under a name that hashes
    the source and flags, with the compiler's log beside it."""
    monkeypatch.setattr(native, '_lib', None)
    monkeypatch.setattr(native, '_error', None)
    monkeypatch.setattr(native, 'BUILD_DIR', tmp_path)
    assert native.available()
    path = native.library_path()
    assert path.parent == tmp_path and path.exists() and path.with_suffix('.log').exists()
    monkeypatch.setattr(native, 'CXX_FLAGS', native.CXX_FLAGS + ('-g',))
    assert native.library_path() != path
    assert not list(native.SOURCE.parent.glob('*.so'))

"""The port's host-side copies against the JAX package's originals: the
config, padding, collation, voxelization, majority labels, the model spec and
the IoU histogram. Everything here is integer or exact-copy float data, so every
comparison is exact."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from openseg3d_tpu.config import cfg_from_file as jax_cfg_from_file
from openseg3d_tpu.config import default_config as jax_default_config
from openseg3d_tpu.core.metrics import confusion_matrix as jax_confusion_matrix
from openseg3d_tpu.core.voxelizer import VoxelGenerator as JaxVoxelGenerator
from openseg3d_tpu.core.voxelizer import majority_voxel_labels as jax_majority
from openseg3d_tpu.core.voxelizer import points_to_voxel as jax_points_to_voxel
from openseg3d_tpu.data.batch import collate_padded as jax_collate
from openseg3d_tpu.data.batch import pad_sample as jax_pad_sample
from openseg3d_tpu.models.segmentors.common import ModelSpec as JaxModelSpec

from openseg3d_tpu_torch.config import ConfigDict, cfg_from_file, default_config
from openseg3d_tpu_torch.core.metrics import IOUMetric, confusion_matrix
from openseg3d_tpu_torch.core.voxelizer import (VoxelGenerator, majority_voxel_labels,
                                                points_to_voxel)
from openseg3d_tpu_torch.data.batch import collate_padded, pad_sample, to_device
from openseg3d_tpu_torch.models.segmentors.common import ModelSpec

from helpers import TINY_OVERRIDES, tiny_cfg

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), 'configs')


def _cloud(rng, n, cfg):
    rg = np.array(cfg.DATASET.POINT_CLOUD_RANGE)
    # 10% of the points fall outside the range and must get voxel id -1
    xyz = rng.uniform(rg[:3] * 1.1, rg[3:] * 1.1, (n, 3)).astype(np.float32)
    return np.concatenate([xyz, rng.randn(n, 3).astype(np.float32)], 1)


def _assert_same_dict(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


def test_voxelizer_and_majority_labels_equal_jax():
    """Both VoxelGenerators (each package's C++ voxelizer where it builds)
    and both numpy paths give the same arrays."""
    cfg = tiny_cfg()
    rng = np.random.RandomState(0)
    pts = _cloud(rng, 700, cfg)
    vg = VoxelGenerator(cfg.DATASET.VOXEL_SIZE, cfg.DATASET.POINT_CLOUD_RANGE)
    jvg = JaxVoxelGenerator(cfg.DATASET.VOXEL_SIZE, cfg.DATASET.POINT_CLOUD_RANGE)
    for (coords, ids), (jc, jids) in (
            (vg.generate(pts), jvg.generate(pts)),
            (points_to_voxel(pts, cfg.DATASET.VOXEL_SIZE, cfg.DATASET.POINT_CLOUD_RANGE),
             jax_points_to_voxel(pts, cfg.DATASET.VOXEL_SIZE, cfg.DATASET.POINT_CLOUD_RANGE))):
        np.testing.assert_array_equal(coords, jc)
        np.testing.assert_array_equal(ids, jids)
        assert coords.dtype == jc.dtype and ids.dtype == jids.dtype
        assert (ids == -1).any() and (ids >= 0).any()

    labels = rng.randint(0, 5, pts.shape[0])
    labels[::7] = 255
    np.testing.assert_array_equal(
        majority_voxel_labels(ids, labels, coords.shape[0] + 3),
        jax_majority(ids, labels, coords.shape[0] + 3))


def test_pad_and_collate_equal_jax():
    """Plain, point-truncated, voxel-truncated and multi-sweep samples."""
    cfg = tiny_cfg()
    rng = np.random.RandomState(1)
    vg = VoxelGenerator(cfg.DATASET.VOXEL_SIZE, cfg.DATASET.POINT_CLOUD_RANGE)
    samples = []
    for n in (300, 500):
        pts = _cloud(rng, n, cfg)
        coords, ids = vg.generate(pts)
        samples.append(dict(points=pts, voxel_coords=coords, point_voxel_ids=ids,
                            point_labels=rng.randint(0, 22, n),
                            voxel_labels=rng.randint(0, 22, coords.shape[0])))
    multi = dict(samples[0], cur_point_indices=np.arange(0, 300, 2),
                 point_labels=rng.randint(0, 22, 150),
                 point_image_features=rng.randn(150, 4).astype(np.float32),
                 points_ri=rng.randint(0, 50, (150, 3)))
    for caps in ((400, 250), (256, 64)):
        for s in samples + [multi]:
            _assert_same_dict(pad_sample(s, *caps), jax_pad_sample(s, *caps))
        padded = [pad_sample(s, *caps) for s in samples]
        mine, ref = collate_padded(padded), jax_collate(padded)
        assert mine.pop('batch_size') == ref.pop('batch_size') == 2
        _assert_same_dict(mine, ref)

    batch = to_device(collate_padded([pad_sample(s, 400, 250) for s in samples]), 'cpu')
    assert 'batch_size' not in batch
    assert batch['points'].dtype == torch.float32
    assert batch['point_mask'].dtype == torch.bool
    assert batch['voxel_coords'].dtype == torch.int32


def _as_plain(tree):
    """Nested ConfigDicts as plain dicts, with the frozen flag of each level."""
    if isinstance(tree, dict):
        return ({k: _as_plain(v) for k, v in tree.items()},
                object.__getattribute__(tree, '_frozen'))
    return tree


@pytest.mark.parametrize('name', [None] + sorted(os.listdir(CONFIGS)))
def test_config_equals_jax(name):
    """The port's copy of the config module: the defaults, every shipped
    YAML file and the tiny test overrides give the same tree, value for
    value and type for type."""
    path = None if name is None else os.path.join(CONFIGS, name)
    for overrides in (None, TINY_OVERRIDES):
        mine, ref = cfg_from_file(path, overrides), jax_cfg_from_file(path, overrides)
        assert isinstance(mine, ConfigDict)
        assert _as_plain(mine) == _as_plain(ref)
        assert repr(mine) == repr(ref)           # same key order and value types
    assert _as_plain(default_config()) == _as_plain(jax_default_config())
    with pytest.raises(KeyError, match='NO_SUCH_KEY'):
        cfg_from_file(path, {'MODEL': {'NO_SUCH_KEY': 1}})


def test_model_spec_equals_jax():
    for name in (None, 'waymo_one_sweep.yaml', 'waymo_one_sweep_cylinder.yaml'):
        path = None if name is None else os.path.join(CONFIGS, name)
        mine = ModelSpec.from_config(cfg_from_file(path))
        assert vars(mine) == vars(JaxModelSpec.from_config(jax_cfg_from_file(path)))
        assert mine.dtype == torch.bfloat16
    cfg = tiny_cfg(MODEL={'DEPTHS': [2, 2, 2, 2]})
    assert vars(ModelSpec.from_config(cfg)) == vars(JaxModelSpec.from_config(cfg))
    assert ModelSpec.from_config(cfg).dtype == torch.float32


def test_confusion_matrix_and_iou_equal_jax():
    rng = np.random.RandomState(2)
    nc = 5
    preds = rng.randint(0, nc, 400)
    labels = rng.randint(0, nc + 2, 400)          # labels >= nc are excluded
    labels[::9] = 255
    valid = rng.rand(400) > 0.2
    mine = confusion_matrix(torch.from_numpy(preds), torch.from_numpy(labels), nc,
                            torch.from_numpy(valid))
    ref = jax_confusion_matrix(jnp.asarray(preds), jnp.asarray(labels), nc,
                               jnp.asarray(valid))
    np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))

    metric = IOUMetric([f'c{i}' for i in range(nc)])
    metric.add_hist(mine.numpy())
    metric.add(preds[valid], labels[valid])
    assert metric.hist.sum() == 2 * int(mine.sum())
    assert 0.0 <= metric.get_metric()['mIOU'] <= 1.0


def test_library_path_covers_headers(tmp_path, monkeypatch):
    """A kernel's library name hashes its source and every csrc/*.cuh header,
    so an edited header is rebuilt instead of loading a stale library (no
    nvcc needed: only the path is computed)."""
    import shutil

    from openseg3d_tpu_torch.ops import _build
    csrc = tmp_path / 'csrc'
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, 'CSRC', csrc)
    header = csrc / 'window_attention_mma.cuh'
    before = {name: _build.library_path(name) for name in _build.KERNELS}
    assert before['window_attention_train'] == _build.library_path('window_attention_train')
    header.write_text(header.read_text() + '\n// edited\n')
    after = {name: _build.library_path(name) for name in _build.KERNELS}
    assert all(after[name] != before[name] for name in _build.KERNELS)
    (csrc / 'window_attention_train.cu').write_text(
        (csrc / 'window_attention_train.cu').read_text() + '\n')
    assert _build.library_path('window_attention_train') != after['window_attention_train']
    assert _build.library_path('nearest_point') == after['nearest_point']


def test_build_all_returns_the_kept_log_of_a_built_library(tmp_path, monkeypatch):
    """A library built earlier is not rebuilt, and its compiler output (the
    ptxas report chip_smoke.py gates spills on) comes back from the log kept
    beside it (no nvcc needed: nothing is compiled)."""
    from openseg3d_tpu_torch.ops import _build
    monkeypatch.setattr(_build, 'BUILD_DIR', tmp_path)
    lib = _build.library_path('nearest_point')
    assert lib.parent == tmp_path
    lib.write_bytes(b'')
    lib.with_suffix('.log').write_text("ptxas info    : Used 40 registers\n")
    assert _build.build_all(('nearest_point',)) == {
        'nearest_point': (lib, 0.0, "ptxas info    : Used 40 registers\n")}

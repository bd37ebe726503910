"""The port's device-side test-time augmentation against the JAX package's.

  * ``ops/scatter.inner_group_ranks`` and ``ops/voxelize.device_voxelize``
    are integer results: bit-equal to JAX's on the same inputs, and the
    voxelization also to the port's host voxelizer (``core/voxelizer.py``)
    plus ``pad_sample``'s voxel cap;
  * ``tools/eval.tta_device_group`` against a rebuild of the JAX tool's own
    group function (``tools/eval.py:107-135``) from the JAX package's public
    pieces (``device_voxelize``, ``model.apply``, the softmax sum), on a
    tiny Segformer in float32: the summed softmax within 1e-4;
  * the eval tool with ``--tta_device --device cpu`` on one synthetic
    frame.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openseg3d_tpu.engine import build_segmentor as jax_build_segmentor
from openseg3d_tpu.ops.scatter import inner_group_ranks as jax_inner_group_ranks
from openseg3d_tpu.ops.voxelize import device_voxelize as jax_device_voxelize

from openseg3d_tpu_torch import parity
from openseg3d_tpu_torch.core.voxelizer import points_to_voxel
from openseg3d_tpu_torch.data.test_time_aug import MultiScaleFlipAug
from openseg3d_tpu_torch.engine import build_segmentor
from openseg3d_tpu_torch.ops.scatter import inner_group_ranks
from openseg3d_tpu_torch.ops.voxelize import device_voxelize
from openseg3d_tpu_torch.tools import eval as eval_tool
from openseg3d_tpu_torch.weights import load_flax_variables

from helpers import tiny_cfg

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('with_valid', [False, True])
def test_inner_group_ranks_matches_jax(with_valid):
    """Bit-equal ranks: groups of every size, -1 ids, and (with `valid`)
    invalid elements pooled in the trash group."""
    rng = np.random.RandomState(1)
    ids = rng.randint(-1, 40, 2000).astype(np.int32)
    valid = rng.rand(2000) > 0.3 if with_valid else None
    want = np.asarray(jax_inner_group_ranks(jnp.asarray(ids),
                                            None if valid is None else jnp.asarray(valid)))
    got = inner_group_ranks(torch.from_numpy(ids),
                            None if valid is None else torch.from_numpy(valid))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _cloud(rng, n, pc_range, spill=1.15):
    """Points over `spill` x the range (some outside it on every axis),
    with a few exact duplicates and points on voxel boundaries."""
    rg = np.asarray(pc_range, np.float32)
    mid, half = (rg[:3] + rg[3:]) / 2, (rg[3:] - rg[:3]) / 2 * spill
    xyz = rng.uniform(mid - half, mid + half, (n, 3)).astype(np.float32)
    xyz[1::50] = xyz[::50][:len(xyz[1::50])]
    xyz[2::50, 0] = np.float32(0.4)
    return np.concatenate([xyz, rng.randn(n, 3).astype(np.float32)], 1)


@pytest.mark.parametrize('max_voxels', [1024, 150])
def test_device_voxelize_matches_jax_and_host(max_voxels):
    """B = 2 with masked points and points out of range; at 150 the cap is
    below both samples' voxel counts. Coords, mask, ids and the uncapped
    count equal JAX's, and the host voxelizer's (its voxels cut at the cap
    as pad_sample cuts them: ids past the cap become -1)."""
    cfg = tiny_cfg()
    vs, pr = cfg.DATASET.VOXEL_SIZE, cfg.DATASET.POINT_CLOUD_RANGE
    rng = np.random.RandomState(2)
    pts = np.stack([_cloud(rng, 900, pr), _cloud(rng, 900, pr)])
    pmask = rng.rand(2, 900) > 0.1
    pmask[1, 700:] = False
    want = [np.asarray(a) for a in jax_device_voxelize(jnp.asarray(pts), jnp.asarray(pmask),
                                                       vs, pr, max_voxels)]
    got = [t.numpy() for t in device_voxelize(torch.from_numpy(pts), torch.from_numpy(pmask),
                                              vs, pr, max_voxels)]
    for name, g, w in zip(('coords', 'mask', 'ids', 'num_voxels'), got, want):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    coords, vmask, ids, num = got
    assert (num > max_voxels).all() == (max_voxels == 150)
    for b in range(2):
        host_coords, host_ids = points_to_voxel(pts[b][pmask[b]], vs, pr)
        m = min(len(host_coords), max_voxels)
        assert num[b] == len(host_coords) and vmask[b].sum() == m
        np.testing.assert_array_equal(coords[b][:m], host_coords[:m])
        assert (coords[b][m:] == -1).all()
        np.testing.assert_array_equal(ids[b][pmask[b]],
                                      np.where(host_ids >= max_voxels, -1, host_ids))
        assert (ids[b][~pmask[b]] == -1).all()


def _variants():
    """Four of the 36 TTA variants, each scale, angle and flip among them."""
    tta = MultiScaleFlipAug(None, scales=[0.95, 1.0, 1.05],
                            angles=[-np.pi / 4, 0.0, np.pi / 4], flip_x=True, flip_y=True)
    return eval_tool.variant_params(tta)[[0, 13, 22, 35]]


def _jax_tta_device_group(model, variables, points1, pmask1, var_params, cfg):
    """The JAX tool's tta_device_group (tools/eval.py:107-135), rebuilt from
    the package's public pieces."""
    vs = tuple(float(v) for v in cfg.DATASET.VOXEL_SIZE)
    pr = tuple(float(v) for v in cfg.DATASET.POINT_CLOUD_RANGE)
    v_cap = int(cfg.RUNTIME.MAX_VOXELS_PER_SAMPLE)

    @jax.jit
    def group(points1, pmask1, var_params):
        def tx(pp):
            scale, angle, mx, my = pp[0], pp[1], pp[2], pp[3]
            xyz = points1[:, :3] * scale
            cth, sth = jnp.cos(angle), jnp.sin(angle)
            rot = jnp.stack([
                jnp.stack([cth, sth, jnp.float32(0)]),
                jnp.stack([-sth, cth, jnp.float32(0)]),
                jnp.stack([jnp.float32(0), jnp.float32(0), jnp.float32(1)]),
            ])
            xyz = (xyz @ rot) * jnp.stack([mx, my, jnp.float32(1)])
            return jnp.concatenate([xyz, points1[:, 3:]], axis=1)

        pts = jax.vmap(tx)(var_params)
        pm = jnp.broadcast_to(pmask1[None], pts.shape[:2])
        vc, vm, vids, _ = jax_device_voxelize(pts, pm, vs, pr, v_cap)
        batch = {'points': pts, 'point_mask': pm, 'cur_point_mask': pm,
                 'point_voxel_ids': vids, 'voxel_coords': vc, 'voxel_mask': vm}
        out = model.apply(variables, batch, train=False)
        return jax.nn.softmax(out['point_out'].astype(jnp.float32), -1).sum(axis=0)

    return np.asarray(group(jnp.asarray(points1), jnp.asarray(pmask1), jnp.asarray(var_params)))


def test_tta_device_group_matches_jax():
    """Four variants of a 700-point cloud (some points outside the range)
    padded to 1024, through a tiny float32 Segformer with seeded weights:
    the port's softmax sum within 1e-4 of the JAX rebuild's, and every
    variant's voxelization bit-equal to JAX's on the port's transformed
    points."""
    cfg = tiny_cfg(MODEL={'DEPTHS': [1, 1, 1, 1]})
    rng = np.random.RandomState(3)
    cloud = _cloud(rng, 700, cfg.DATASET.POINT_CLOUD_RANGE, spill=1.05)
    points1 = np.zeros((1024, 6), np.float32)
    points1[:700] = cloud
    pmask1 = np.arange(1024) < 700
    vp = _variants()
    params, stats = parity.reference_weights(cfg, 5)
    jmodel, _ = jax_build_segmentor(cfg)
    want = _jax_tta_device_group(jmodel, {'params': params, 'batch_stats': stats},
                                 points1, pmask1, vp, cfg)
    model, spec = build_segmentor(cfg, device='cpu')
    load_flax_variables(model, params, stats)
    got = eval_tool.tta_device_group(model, spec, torch.from_numpy(points1),
                                     torch.from_numpy(pmask1), torch.from_numpy(vp),
                                     cfg.RUNTIME.MAX_VOXELS_PER_SAMPLE)
    assert got.shape == (1024, cfg.DATASET.NUM_CLASSES) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy()[:700].sum(-1), len(vp), rtol=1e-5)
    pts = eval_tool.transform_variants(torch.from_numpy(points1), torch.from_numpy(vp))
    pm = torch.from_numpy(pmask1)[None].expand(len(vp), -1)
    vs, pr = cfg.DATASET.VOXEL_SIZE, cfg.DATASET.POINT_CLOUD_RANGE
    mine = device_voxelize(pts, pm, vs, pr, 512)
    ref = jax_device_voxelize(jnp.asarray(pts.numpy()), jnp.asarray(pm.numpy()), vs, pr, 512)
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (mine[2][:, :700] == -1).any()                   # some points fall outside


def test_eval_tool_with_tta_device(tmp_path):
    """--tta_device --device cpu on one synthetic frame of a small SPNet
    config (random weights; SPNet has no attention, whose plain version
    makes 36 Segformer variants cost ~20 CPU-seconds even at this size, and
    tta_device_group's Segformer is held against JAX above): a finite mIoU
    over a histogram that counts every kept point; --tta_batch must divide
    36 here too."""
    cfg_file = tmp_path / 'tiny.yaml'
    cfg_file.write_text('DATASET: {POINT_CLOUD_RANGE: [-3.2, -3.2, -0.8, 3.2, 3.2, 0.8], '
                        'VOXEL_SIZE: [0.2, 0.2, 0.2]}\n'
                        'MODEL: {SEGMENTOR: spnet}\n'
                        'RUNTIME: {MAX_POINTS_PER_SAMPLE: 256, MAX_VOXELS_PER_SAMPLE: 256, '
                        'COMPUTE_DTYPE: float32}\n')
    argv = ['--cfg_file', str(cfg_file), '--synthetic', '--synthetic_frames', '1',
            '--device', 'cpu', '--tta_device', '--save_dir', str(tmp_path)]
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        result = eval_tool.main(argv + ['--tta_batch', '36'])
        with pytest.raises(ValueError, match='tta_batch'):
            eval_tool.main(argv + ['--tta_batch', '5'])
    finally:
        torch.set_num_threads(threads)
    assert int(result['hist'].sum()) == 256 and np.isfinite(result['mIOU'])
    assert os.path.exists(tmp_path / 'eval.log')

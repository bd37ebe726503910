"""The port against the JAX package at full width and full capacity.

The reference files ``openseg3d_tpu_torch/parity_data/<name>.npz`` hold what
the JAX package's own eval step (``engine.make_eval_step``, with the loss,
so the aux-label 1-NN runs) computed on a CPU, in float32 and in bfloat16,
for each configuration of ``parity.REFERENCES`` on its frame, with the
seeded weights of ``parity.reference_weights``. The GPU machine has no JAX,
so the files are committed; regenerate them on a host with JAX:

    python tests/test_torch_fullsize.py --write [name ...]

and hold the port on this host's CPU (float32, full size) to them:

    python tests/test_torch_fullsize.py --check [name ...]

and count the aux labels that the port's rounding of the voxel centres
flips against the JAX package's own (the loss difference stays inside the
loss gate, see PERF.md section 6):

    python tests/test_torch_fullsize.py --ties [name ...]

``chip_smoke.py`` holds the port on the card to them. The tests here check
the files' provenance (the weights and frame rebuilt from their seeds have
the recorded digests) and run the writer and ``compare_with_reference`` on
a tiny configuration against JAX: the port's CPU output passes the gates,
and perturbed logits fail them.
"""

import argparse
import contextlib
import copy
import functools
import os
import sys
import time
from unittest import mock

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

from openseg3d_tpu_torch import parity  # noqa: E402

MAX_FILE_BYTES = 1 << 20


def pallas_label_transfer(src_centers, src_labels, src_valid, dst_centers, dst_valid,
                          ignore_index: int = 255, tile: int = 256):
    """``ops/knn.nearest_label_transfer``'s TPU branch, the JAX package's
    fused 1-NN kernel (``_nearest_point_pallas_single``), run in interpret
    mode. Off the TPU that function takes the tiled XLA path instead, whose
    distances (|q|^2 - 2 q.p + |p|^2) round differently, so that a tie
    between equidistant voxel centres, which the aux centres' half-voxel
    offsets make common, can go another way; the port's B3 follows the
    kernel's rule (direct squared differences, the lowest index)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from openseg3d_tpu.ops.knn import _nearest_point_pallas_single
    with mock.patch.object(pl, 'pallas_call', functools.partial(pl.pallas_call, interpret=True)):
        idx = jax.vmap(_nearest_point_pallas_single)(dst_centers, src_centers, src_valid)
    idx = jnp.where(dst_valid, idx, -1)
    gathered = jnp.take_along_axis(src_labels, jnp.maximum(idx, 0), axis=1)
    return jnp.where(idx >= 0, gathered, ignore_index)


def unfused_voxel_centers(voxel_coords, downsample_scale, voxel_size, point_cloud_range):
    """``utils/pointops.get_voxel_centers`` with the product rounded before
    the sum, as the port computes it: XLA on the CPU contracts
    ``(xyz + 0.5) * vs + origin`` into one fused multiply-add, and a one-ulp
    difference in a centre decides ties that the half-voxel offsets of the
    aux centres make exact in real arithmetic. The same float32 operations
    run in numpy, through a host callback. Only ``--ties`` uses it, to count
    the aux labels that the rounding flips."""
    import jax
    import jax.numpy as jnp
    vs = np.asarray(voxel_size, np.float32) * np.float32(downsample_scale)
    origin = np.asarray(point_cloud_range[0:3], np.float32)

    def centers(coords):
        xyz = np.asarray(coords)[..., ::-1].astype(np.float32)
        return ((xyz + np.float32(0.5)) * vs + origin).astype(np.float32)

    shape = jax.ShapeDtypeStruct(voxel_coords.shape, jnp.float32)
    return jax.pure_callback(centers, shape, voxel_coords)


def run_jax_eval_step(jcfg, params, stats, batch, port_rounding=False):
    """The JAX package's eval step (with the loss, its aux labels from the
    1-NN kernel of its TPU path, ``pallas_label_transfer``; with
    `port_rounding`, on centres rounded as the port rounds them,
    ``unfused_voxel_centers``) on a numpy batch. Its result holds the
    histogram, point_out, the loss and the aux labels; the model's other
    outputs come out of the jitted step through a debug callback."""
    import jax
    import jax.numpy as jnp
    from openseg3d_tpu import engine
    from openseg3d_tpu.engine import TrainState, build_segmentor, make_eval_step
    model, spec = build_segmentor(jcfg)
    captured = {}

    def apply_fn(variables, b, train):
        out = model.apply(variables, b, train=train)
        jax.debug.callback(
            lambda *a: captured.update(zip(parity.OUTPUT_KEYS, (np.asarray(x) for x in a))),
            *[out[k] for k in parity.OUTPUT_KEYS])
        return out

    def label_transfer(*args):
        labels = pallas_label_transfer(*args)
        jax.debug.callback(lambda a: captured.update(aux_labels=np.asarray(a)), labels)
        return labels

    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                       opt_state=None, tx=None, apply_fn=apply_fn)
    jb = {k: jnp.asarray(v) for k, v in batch.items() if isinstance(v, np.ndarray)}
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(engine, 'nearest_label_transfer', label_transfer))
        if port_rounding:
            stack.enter_context(mock.patch.object(engine, 'get_voxel_centers',
                                                  unfused_voxel_centers))
        res = jax.device_get(make_eval_step(jcfg, spec, model, with_loss=True)(state, jb))
    jax.effects_barrier()
    return dict(captured, point_out=res['point_out'], hist=res['hist'], loss=res['loss'])


def build_record(port_cfgs, jax_cfgs, batch, params, stats, provenance, port_rounding=False):
    """The reference record of one configuration: the JAX eval step in
    float32 and bf16 (port_cfgs / jax_cfgs: dtype -> config)."""
    counts = parity.overfull_windows(port_cfgs['float32'], batch)
    out32 = run_jax_eval_step(jax_cfgs['float32'], params, stats, batch, port_rounding)
    rec = parity.record(parity.summarize(out32, batch))
    out16 = run_jax_eval_step(jax_cfgs['bfloat16'], params, stats, batch, port_rounding)
    own = parity.measure(out16, batch, rec)
    rec.update(
        argmax_bfloat16=parity.summarize(out16, batch, {k: rec[f'{k}_rows'] for k in
                                                        ('point', 'voxel', 'aux')})['argmax'],
        loss_bfloat16=np.float64(float(out16['loss'])),
        bf16_agreement=np.float64(own['agreement']),
        bf16_logit_err=np.float64(own['logit_err']),
        overfull=np.asarray(counts, np.int32).reshape(-1, 3),
        live_voxels=np.int64(batch['voxel_mask'].sum()),
        weight_paths=np.asarray(list(parity.tree_digests(params, stats))),
        weight_digests=np.asarray(list(parity.tree_digests(params, stats).values())),
        batch_keys=np.asarray(list(parity.batch_digests(batch))),
        batch_digests=np.asarray(list(parity.batch_digests(batch).values())),
        **{k: np.asarray(v) for k, v in provenance.items()})
    return rec, own


def jax_config(name, dtype):
    """The JAX package's configuration of reference `name` at `dtype`."""
    from openseg3d_tpu.config import cfg_from_file
    cfg_file, overrides, _ = parity.REFERENCES[name]
    ov = {k: dict(v) for k, v in overrides.items()}
    ov.setdefault('RUNTIME', {})['COMPUTE_DTYPE'] = dtype
    return cfg_from_file(os.path.join(parity.REPO, 'configs', cfg_file), overrides=ov)


def write_reference(name):
    cfg_file, overrides, frame = parity.REFERENCES[name]
    port_cfgs = {dt: parity.reference_config(name, dt) for dt in ('float32', 'bfloat16')}
    jax_cfgs = {dt: jax_config(name, dt) for dt in port_cfgs}
    batch = parity.reference_frame(port_cfgs['float32'], frame)
    params, stats = parity.reference_weights(port_cfgs['float32'])
    t0 = time.time()
    rec, own = build_record(port_cfgs, jax_cfgs, batch, params, stats, dict(
        name=name, config=cfg_file, overrides=repr(overrides), weight_seed=parity.WEIGHT_SEED,
        frame=frame, frame_seed=parity.FRAME_SEED))
    os.makedirs(parity.DATA_DIR, exist_ok=True)
    np.savez_compressed(parity.reference_path(name), **rec)
    size = os.path.getsize(parity.reference_path(name))
    print(f'{name}: {time.time() - t0:.0f} s, {size} bytes; JAX bf16 vs float32: agreement '
          f'{own["agreement"]:.6f}, sampled-logit error {own["logit_err"]:.4g}; loss '
          f'{float(rec["loss"]):.6g} (bf16 {float(rec["loss_bfloat16"]):.6g}); over-full '
          f'windows {int(rec["overfull"][:, 2].sum())}', flush=True)
    assert size <= MAX_FILE_BYTES, size


def tie_check(name):
    """The JAX float32 eval step of reference `name` with the package's own
    voxel centres against the port's rounding (``unfused_voxel_centers``):
    the aux labels that differ and the relative loss difference."""
    cfg = parity.reference_config(name)
    batch = parity.reference_frame(cfg, parity.REFERENCES[name][2])
    params, stats = parity.reference_weights(cfg)
    t0 = time.time()
    own, port = (run_jax_eval_step(jax_config(name, 'float32'), params, stats, batch, r)
                 for r in (False, True))
    live = own['aux_voxel_mask'][0]
    m = {'aux_voxels': int(live.sum()),
         'aux_labels_differing': int((own['aux_labels'][0] != port['aux_labels'][0])[live].sum()),
         'loss_own': float(own['loss']), 'loss_port_rounding': float(port['loss']),
         'loss_rel': abs(float(own['loss']) - float(port['loss'])) / abs(float(port['loss'])),
         'loss_rtol': parity.LOSS_RTOL}
    print(f'{name} ({time.time() - t0:.0f} s): {m}', flush=True)
    return m


def check_reference(name):
    t0 = time.time()
    m = parity.check_reference(name, ('float32',), 'cpu')['float32']
    print(f'{name} (float32, the port on the CPU, {time.time() - t0:.0f} s): {m}', flush=True)
    return m


# --- tests ------------------------------------------------------------------

@pytest.mark.parametrize('name', sorted(parity.REFERENCES))
def test_reference_provenance(name):
    """Each file names its configuration and seeds, is at most 1 MB, and
    the weights and frame rebuilt from them have the recorded digests."""
    path = parity.reference_path(name)
    assert os.path.getsize(path) <= MAX_FILE_BYTES
    ref = parity.load_reference(name)
    cfg_file, overrides, frame = parity.REFERENCES[name]
    assert (str(ref['name']), str(ref['config']), str(ref['frame'])) == (name, cfg_file, frame)
    assert str(ref['overrides']) == repr(overrides)
    cfg = parity.reference_config(name)
    params, stats = parity.reference_weights(cfg, int(ref['weight_seed']))
    got = parity.tree_digests(params, stats)
    assert list(got) == list(ref['weight_paths'])
    assert list(got.values()) == list(ref['weight_digests'])
    batch = parity.reference_frame(cfg, frame, int(ref['frame_seed']))
    got = parity.batch_digests(batch)
    assert list(got) == list(ref['batch_keys'])
    assert list(got.values()) == list(ref['batch_digests'])
    valid = parity.valid_points(batch)
    assert ref['argmax'].shape == ref['argmax_bfloat16'].shape == (int(valid.sum()),)
    assert int(ref['live_voxels']) == int(batch['voxel_mask'].sum())
    assert int(ref['hist'].sum()) == int(valid.sum())


TINY = {'MODEL': {'DEPTHS': [1, 1, 1, 1]}}


def tiny_cfgs(extra=None):
    """{dtype: config} of a tiny Segformer for the port and for the JAX
    package, with `extra` overrides."""
    from helpers import TINY_OVERRIDES
    from openseg3d_tpu.config import cfg_from_file as jax_cfg_from_file
    port_cfgs, jax_cfgs = {}, {}
    for dt in ('float32', 'bfloat16'):
        ov = copy.deepcopy(TINY_OVERRIDES)
        for k, v in (extra or TINY).items():
            ov.setdefault(k, {}).update(copy.deepcopy(v))
        ov['RUNTIME']['COMPUTE_DTYPE'] = dt
        port_cfgs[dt] = parity.cfg_from_file(None, overrides=ov)
        jax_cfgs[dt] = jax_cfg_from_file(None, overrides=ov)
    return port_cfgs, jax_cfgs


@pytest.fixture(scope='module')
def tiny_record():
    """The writer's record for a tiny Segformer on a tiny batch, on voxel
    centres rounded as the port rounds them: with a few hundred aux centres
    the ties that JAX's fused rounding decides otherwise move the loss by
    more than LOSS_RTOL (the test prints by how much), where at full size
    they stay inside it (``--ties``)."""
    from helpers import synthetic_batch
    port_cfgs, jax_cfgs = tiny_cfgs()
    batch = synthetic_batch(jax_cfgs['float32'], batch_size=1, n_points=900, seed=6)
    params, stats = parity.reference_weights(port_cfgs['float32'], 3)
    rec, _ = build_record(port_cfgs, jax_cfgs, batch, params, stats, {'name': 'tiny'},
                          port_rounding=True)
    rec['loss_jax_rounding'] = run_jax_eval_step(jax_cfgs['float32'], params, stats, batch)['loss']
    return port_cfgs, batch, params, stats, rec


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_compare_with_reference_on_a_tiny_config(tiny_record, dtype):
    """The port's CPU eval step passes the gates against the writer's
    record; perturbing its point logits at one sampled row by 1% of the
    largest logit fails the float32 gate, and flipping argmaxes fails the
    agreement gate."""
    port_cfgs, batch, params, stats, rec = tiny_record
    assert not rec['overfull'][:, 2].any()
    out = parity.port_outputs(port_cfgs[dtype], params, stats, batch, 'cpu')
    m = parity.compare_with_reference(out, batch, rec, dtype)
    print(m)
    if dtype == 'float32':
        own = float(rec['loss_jax_rounding'])
        print(f'loss on JAX\'s own voxel centres {own:.7g}, relative difference '
              f'{abs(own - m["ref_loss"]) / m["ref_loss"]:.3g}')
        assert m['logit_err'] < 1e-4 and m['disagreeing'] == 0 and m['hist_l1'] == 0
        bad = {k: v.copy() for k, v in out.items()}
        row = int(rec['point_rows'][0])
        bad['point_out'][0, row, 0] += 0.01 * max(1.0, m['max_abs_logit'])
        with pytest.raises(AssertionError):
            parity.compare_with_reference(bad, batch, rec, dtype)
    bad = {k: v.copy() for k, v in out.items()}
    valid = np.flatnonzero(parity.valid_points(batch))
    flip = valid[: max(1, len(valid) // 50)]
    bad['point_out'][0, flip] = np.roll(bad['point_out'][0, flip], 1, axis=-1) + \
        np.eye(bad['point_out'].shape[-1])[(rec['argmax'][:len(flip)] + 1) % 22] * 1e3
    with pytest.raises(AssertionError):
        parity.compare_with_reference(bad, batch, rec, dtype)


def test_a_frame_with_an_over_full_window_is_refused(tiny_record):
    """A first-stage token cap of 12 makes one window of the tiny batch
    over-full: ``overfull_windows`` counts it where the JAX partition drops
    voxels too (as many, from the same window), and ``compare_with_reference``
    refuses a record that holds it, since which voxels drop is the JAX
    package's unstable in-window order."""
    import jax.numpy as jnp
    from openseg3d_tpu.ops import window as jax_window
    from openseg3d_tpu_torch.config import _ladder, default_config
    from openseg3d_tpu_torch.models.backbones.point_transformer import stage_level_specs
    from openseg3d_tpu_torch.models.segmentors.common import ModelSpec
    from openseg3d_tpu_torch.ops.window import batched_window_partition
    port_cfgs, batch, params, stats, rec = tiny_record
    d = default_config()
    capped, _ = tiny_cfgs({'MODEL': {**TINY['MODEL'], 'BATCHING_INFO':
                                     [_ladder([4, 8], top=12)] + d.MODEL.BATCHING_INFO[1:]},
                           'RUNTIME': {'WINDOW_BUCKET_FRACTIONS':
                                       [[1.0] * 3] + d.RUNTIME.WINDOW_BUCKET_FRACTIONS[1:]}})
    assert [c for c in parity.overfull_windows(capped['float32'], batch) if c[2]] == [(0, 2, 1)]
    assert not any(c[2] for c in parity.overfull_windows(port_cfgs['float32'], batch))

    spec = ModelSpec.from_config(capped['float32'])
    levels = stage_level_specs(spec)[0]
    coords = np.asarray(batch['voxel_coords'])
    valid = coords[..., 0] >= 0
    port = batched_window_partition(torch.from_numpy(coords), torch.from_numpy(valid),
                                    spec.spatial_shape, spec.window_shape, levels).keep.numpy()
    jax_keep = np.asarray(jax_window.batched_window_partition(
        jnp.asarray(coords), jnp.asarray(valid), spec.spatial_shape, spec.window_shape,
        tuple(jax_window.LevelSpec(*lv) for lv in levels)).keep)
    dropped = [np.flatnonzero(valid[0] & ~k[0]) for k in (port, jax_keep)]
    print('dropped voxels: port', dropped[0], 'JAX', dropped[1])
    assert len(dropped[0]) == len(dropped[1]) > 0

    bad = dict(rec, overfull=np.asarray([(0, 2, 1)], np.int32))
    out = parity.port_outputs(port_cfgs['float32'], params, stats, batch, 'cpu')
    with pytest.raises(AssertionError, match='over-full'):
        parity.compare_with_reference(out, batch, bad)


def test_reference_weights_follow_the_leaf_rules():
    """Seeded, independent of the global generators, BN statistics drawn
    (not identity), kernels at the fan-in scale."""
    cfg = parity.cfg_from_file(os.path.join(parity.REPO, 'configs', 'waymo_one_sweep.yaml'),
                               overrides={'MODEL': {'SEGMENTOR': 'spnet'}})
    p1, s1 = parity.reference_weights(cfg, 4)
    np.random.seed(123)
    p2, _ = parity.reference_weights(cfg, 4)
    assert parity.tree_digests(p1, s1) == parity.tree_digests(p2, s1)
    k = p1['SparseUnet_0']['UpBlock_0']['ConvModule_0']['SparseConv_0']['kernel']
    assert abs(float(k.std()) * np.sqrt(27 * 512 / 2) - 1) < 0.05
    var = s1['SparseUnet_0']['ConvModule_0']['MaskedBatchNorm_0']['var']
    assert var.min() >= 0.5 and var.max() <= 2.0 and not np.allclose(var, 1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument('--write', action='store_true',
                      help='run the JAX eval step and write the reference files')
    mode.add_argument('--check', action='store_true',
                      help="hold the port's CPU float32 output to the files")
    mode.add_argument('--ties', action='store_true',
                      help="count the aux labels that JAX's own voxel centres flip against "
                           "the port's rounding, and the loss difference")
    ap.add_argument('names', nargs='*', default=sorted(parity.REFERENCES))
    args = ap.parse_args(argv)
    os.environ.setdefault('JAX_PLATFORMS', 'cpu')
    for name in args.names:
        if args.write:
            write_reference(name)
        elif args.ties:
            tie_check(name)
        else:
            check_reference(name)


if __name__ == '__main__':
    main()

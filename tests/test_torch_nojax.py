"""The port runs without JAX: its runtime path, tools and measuring entry
points import nothing of JAX, flax, optax, the JAX package or its bench."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


_NO_JAX_SCRIPT = r'''
import sys
for name in ('jax', 'jaxlib', 'flax', 'optax', 'openseg3d_tpu', 'bench'):
    sys.modules[name] = None            # any import of them now fails
import numpy as np, torch
from openseg3d_tpu_torch.config import cfg_from_file
from openseg3d_tpu_torch.core.voxelizer import VoxelGenerator, majority_voxel_labels
from openseg3d_tpu_torch.data.batch import collate_padded, pad_sample, to_device
from openseg3d_tpu_torch.engine import (TrainState, build_segmentor, make_eval_step,
                                        make_forward, make_train_step)
from openseg3d_tpu_torch.models.optim import build_optimizer, build_schedule
from openseg3d_tpu_torch.weights import init_weights
from openseg3d_tpu_torch.tools import eval as eval_tool, train as train_tool
from openseg3d_tpu_torch.data import loader, synthetic, test_time_aug, waymo_dataset
from openseg3d_tpu_torch.utils import checkpoint
from openseg3d_tpu_torch.ops.voxelize import device_voxelize
from openseg3d_tpu_torch.models.deep_fusion import DeepFusionBlock
from openseg3d_tpu_torch import bench
from openseg3d_tpu_torch.tools import measure_capacities, profile_step, verify_capacities
from openseg3d_tpu_torch.utils import profiling
from openseg3d_tpu_torch import native, parity
from openseg3d_tpu_torch.tools import import_checkpoint, rehearsal
OV = %r
cfg = cfg_from_file(None, overrides=OV)
rng = np.random.RandomState(0)
pts = np.concatenate([rng.uniform(-3, 3, (500, 3)), rng.randn(500, 3)], 1).astype(np.float32)
vg = VoxelGenerator(cfg.DATASET.VOXEL_SIZE, cfg.DATASET.POINT_CLOUD_RANGE)
coords, ids = vg.generate(pts)
assert native.available(), native.build_error()   # the C++ voxelizer, the production path
nc, nids = native.native_points_to_voxel(pts, cfg.DATASET.VOXEL_SIZE,
                                        cfg.DATASET.POINT_CLOUD_RANGE)
assert np.array_equal(nc, coords) and np.array_equal(nids, ids)
labels = rng.randint(0, 22, 500)
s = dict(points=pts, voxel_coords=coords, point_voxel_ids=ids, point_labels=labels,
         voxel_labels=majority_voxel_labels(ids, labels, coords.shape[0]))
batch = to_device(collate_padded([pad_sample(s, 1024, 512)]), 'cpu')
model, spec = build_segmentor(cfg, device='cpu')
init_weights(model, torch.Generator().manual_seed(0))
model.eval()
logits = make_forward(model)(batch)
hist = make_eval_step(cfg, spec, model)(batch)['hist']
assert torch.isfinite(logits).all() and int(hist.sum()) == 500
state = TrainState(model, build_optimizer(cfg, model.parameters()), build_schedule(cfg, 1, 1))
state, metrics = make_train_step(cfg, spec)(state, batch, seed=0)
assert metrics['grads_finite'] and torch.isfinite(metrics['loss']) and state.updates == 1
vc, vm, vids, nv = device_voxelize(batch['points'], batch['point_mask'], cfg.DATASET.VOXEL_SIZE,
                                   cfg.DATASET.POINT_CLOUD_RANGE, 512)
assert torch.equal(vc, batch['voxel_coords']) and torch.equal(vids, batch['point_voxel_ids'])
img_cfg = cfg_from_file(None, overrides=dict(OV, DATASET=dict(OV['DATASET'],
                                                              USE_IMAGE_FEATURE=True)))
s['point_image_features'] = synthetic.synthetic_image_features(rng, pts[:, :3], 28)
img_batch = to_device(collate_padded([pad_sample(s, 1024, 512)]), 'cpu')
img_model, _ = build_segmentor(img_cfg, device='cpu')
assert isinstance(img_model.DeepFusionBlock_0, DeepFusionBlock)
init_weights(img_model, torch.Generator().manual_seed(0))
assert torch.isfinite(make_forward(img_model)(img_batch)).all()
assert not any(m.split('.')[0] in ('jax', 'flax', 'optax', 'openseg3d_tpu', 'bench')
               for m, v in sys.modules.items() if v is not None)
print('ok')
'''


def _no_jax_script():
    from helpers import TINY_OVERRIDES
    return _NO_JAX_SCRIPT % dict(TINY_OVERRIDES, MODEL={'DEPTHS': [2, 2, 2, 2],
                                                        'WINDOW_SHAPE': [4, 4, 4]})


def test_port_runs_without_jax():
    """The port's runtime path imports no JAX, flax or optax and nothing of
    the JAX package: with them and the JAX bench blocked, a subprocess
    imports the port, its data modules, the command-line tools (train,
    eval, rehearsal, import_checkpoint), the checkpoint and parity modules,
    the C++ voxelizer's binding and the measuring entry points (bench,
    profile_step, the capacity tools and utils.profiling), voxelizes on the
    C++ path, builds the model, runs a forward and an eval step,
    and takes one train step; then voxelizes on the device (equal to the
    host voxelizer's batch) and runs the forward of a Segformer with image
    features (DeepFusion)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, '-c', _no_jax_script()], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith('ok')

"""The port's submission path against the JAX package's, and its test tool.

``utils/submission`` and ``utils/wod_stub`` are copies of the JAX package's:
for the same predictions both writers give the same file, byte for byte,
through either package's proto stand-in. ``tools.test`` runs end to end on
the CPU on a tiny tree in the offline parser's format (single sweep, and
three sweeps, whose history points must not be submitted): each frame's
decoded range images equal the eval forward's argmax over the frame's
current points, scattered through ``points_ri``.
"""

import os
import sys

import numpy as np
import pytest
import torch

from openseg3d_tpu.utils import submission as jax_submission
from openseg3d_tpu.utils import wod_stub as jax_wod_stub

from openseg3d_tpu_torch.config import cfg_from_file
from openseg3d_tpu_torch.data.batch import collate_padded, to_device
from openseg3d_tpu_torch.data.synthetic import make_tree
from openseg3d_tpu_torch.data.waymo_dataset import WaymoDataset
from openseg3d_tpu_torch.engine import TrainState, build_segmentor, make_forward
from openseg3d_tpu_torch.models.optim import build_optimizer, build_schedule
from openseg3d_tpu_torch.tools import test as test_tool
from openseg3d_tpu_torch.utils import submission, wod_stub
from openseg3d_tpu_torch.utils.checkpoint import save_checkpoint
from openseg3d_tpu_torch.weights import init_weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, 'configs', 'synthetic_smoke.yaml')


@pytest.fixture
def stub(monkeypatch):
    """A function installing one package's proto stand-in for the test."""
    def install(module):
        for name, mod in module.build_modules().items():
            monkeypatch.setitem(sys.modules, name, mod)
    return install


def _frames(rng, n_frames=3, n=5000):
    out = []
    for f in range(n_frames):
        ri = np.stack([rng.randint(-2, 2660, n), rng.randint(-1, 66, n),
                       rng.randint(0, 2, n)], 1).astype(np.int32)
        out.append((rng.randint(0, 22, n), ri, f'seg{f:03d}', 1000000 + f))
    return out


def test_range_images_equal_jax():
    rng = np.random.RandomState(0)
    for preds, ri, _, _ in _frames(rng):
        for a, b in zip(submission.assemble_range_image_labels(preds, ri),
                        jax_submission.assemble_range_image_labels(preds, ri)):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('stub_of', ['port', 'jax'])
def test_submission_file_equals_jax(tmp_path, stub, stub_of):
    """The same predictions through both writers (under one stand-in, either
    package's) give the same bytes, and the port's decoder reads back each
    frame's range images."""
    stub(wod_stub if stub_of == 'port' else jax_wod_stub)
    frames = _frames(np.random.RandomState(1))
    paths = []
    for pkg, d in ((submission, 'port'), (jax_submission, 'jax')):
        built = [pkg.construct_seg_frame(p, ri, context_name=c, timestamp=t)
                 for p, ri, c, t in frames]
        paths.append(pkg.write_submission_file(built, str(tmp_path / d), method_name='m'))
    data = [open(p, 'rb').read() for p in paths]
    assert data[0] == data[1]
    method, decoded = wod_stub.read_submission(paths[0])
    assert method == 'm' and len(decoded) == len(frames)
    for (preds, ri, ctx, ts), (dctx, dts, lasers) in zip(frames, decoded):
        assert (dctx, dts) == (ctx, ts) and len(lasers) == 1
        want = submission.assemble_range_image_labels(preds, ri)
        np.testing.assert_array_equal(lasers[0][1], want[0])
        np.testing.assert_array_equal(lasers[0][2], want[1])


@pytest.fixture(scope='module', autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize('sweeps', [1, 3])
def test_tools_test_submits_the_eval_argmax(tmp_path, monkeypatch, sweeps):
    """tools.test on a 3-frame tree (configs/synthetic_smoke.yaml, seeded
    random weights in epoch_1.pt): every testing frame is submitted, with
    all of its current points and, for the later frames of the multi-sweep
    case, the history points of the earlier frames beside them in the
    batch; its range images are the eval forward's argmax over its current
    points scattered through their points_ri."""
    n = 4096 // sweeps
    tree = str(tmp_path / 'tree')
    names = make_tree(tree, 3, n)
    cfg_file = tmp_path / 'cfg.yaml'
    text = open(SMOKE).read()
    if sweeps > 1:
        text = text.replace('DATASET:\n', f'DATASET:\n  USE_MULTI_SWEEPS: True\n'
                                          f'  NUM_SWEEPS: {sweeps}\n')
    cfg_file.write_text(text)
    cfg = cfg_from_file(str(cfg_file))
    assert cfg.DATASET.USE_MULTI_SWEEPS == (sweeps > 1)

    save_dir = str(tmp_path / 'run')
    os.makedirs(save_dir)
    model, _ = build_segmentor(cfg, device='cpu')
    init_weights(model, torch.Generator().manual_seed(4))
    save_checkpoint(save_dir, 1, TrainState(model, build_optimizer(cfg, model.parameters()),
                                            build_schedule(cfg, 1, 1)))
    monkeypatch.setenv('OPENSEG3D_ALLOW_WOD_STUB', '1')
    for name in wod_stub.build_modules():
        monkeypatch.delitem(sys.modules, name, raising=False)
    path = test_tool.main(['--cfg_file', str(cfg_file), '--data_dir', tree,
                           '--save_dir', save_dir, '--device', 'cpu'])
    assert os.path.basename(path) == 'wod_test_set_pred_semantic_seg.bin'
    method, decoded = wod_stub.read_submission(path)
    assert method == 'openseg3d_tpu_torch' and len(decoded) == 3

    dataset = WaymoDataset(cfg, tree, 'testing')
    assert dataset.filenames == names
    forward = make_forward(model.eval())
    for i, (ctx, ts, lasers) in enumerate(decoded):
        raw = dataset[i]
        file_idx, frame_idx, stamp = dataset.parse_filename(raw['filename'])
        assert (ctx, ts) == (file_idx, stamp)
        b = collate_padded([dataset.pad(raw)])
        mask = b['point_mask'][0] & b['cur_point_mask'][0]
        assert int(mask.sum()) == n
        assert int(b['point_mask'][0].sum()) == n * min(frame_idx + 1, sweeps)
        preds = forward(to_device(b, 'cpu'))[0].argmax(dim=-1).numpy()
        want = submission.assemble_range_image_labels(preds[mask], b['points_ri'][0][mask])
        np.testing.assert_array_equal(lasers[0][1], want[0])
        np.testing.assert_array_equal(lasers[0][2], want[1])
        # every current point has a pixel of its own (data/synthetic.make_tree)
        assert int((lasers[0][1][..., 1] > 0).sum() + (lasers[0][2][..., 1] > 0).sum()) == n


_NO_JAX_SCRIPT = r'''
import os, sys, tempfile
for name in ('jax', 'jaxlib', 'flax', 'optax', 'openseg3d_tpu', 'bench'):
    sys.modules[name] = None            # any import of them now fails
import numpy as np, torch
from openseg3d_tpu_torch.config import cfg_from_file
from openseg3d_tpu_torch.data.batch import collate_padded, to_device
from openseg3d_tpu_torch.data.synthetic import make_tree
from openseg3d_tpu_torch.data.waymo_dataset import WaymoDataset
from openseg3d_tpu_torch.engine import (TrainState, build_segmentor, make_eval_step,
                                        make_forward, make_train_step)
from openseg3d_tpu_torch.models.optim import build_optimizer, build_schedule
from openseg3d_tpu_torch.tools import test as test_tool
from openseg3d_tpu_torch.utils import wod_stub
from openseg3d_tpu_torch.utils.checkpoint import save_checkpoint
from openseg3d_tpu_torch.weights import init_weights
torch.set_num_threads(2)
smoke = %(smoke)r
with tempfile.TemporaryDirectory() as tmp:
    tree = os.path.join(tmp, 'tree')
    make_tree(tree, 2, 1365)
    for name, ov in (('spnet', {'MODEL': {'SEGMENTOR': 'spnet'}}),
                     ('multi_sweep', {'DATASET': {'USE_MULTI_SWEEPS': True, 'NUM_SWEEPS': 3}})):
        cfg = cfg_from_file(smoke, overrides=ov)
        ds = WaymoDataset(cfg, tree, 'validation')
        batch = to_device(collate_padded([ds.pad(ds[1])]), 'cpu')
        assert (~batch['cur_point_mask'] & batch['point_mask']).any() == (name == 'multi_sweep')
        model, spec = build_segmentor(cfg, device='cpu')
        init_weights(model, torch.Generator().manual_seed(0))
        model.eval()
        assert torch.isfinite(make_forward(model)(batch)).all()
        hist = make_eval_step(cfg, spec, model)(batch)['hist']
        assert int(hist.sum()) == int((batch['point_mask'] & batch['cur_point_mask']).sum())
        state = TrainState(model, build_optimizer(cfg, model.parameters()),
                           build_schedule(cfg, 1, 1))
        state, metrics = make_train_step(cfg, spec)(state, batch, seed=0)
        assert metrics['grads_finite'] and torch.isfinite(metrics['loss'])
        if name == 'spnet':
            save_dir = os.path.join(tmp, 'run')
            os.makedirs(save_dir)
            save_checkpoint(save_dir, 1, state)
            cfg_file = os.path.join(tmp, 'spnet.yaml')
            with open(smoke) as src, open(cfg_file, 'w') as dst:
                dst.write(src.read().replace("SEGMENTOR: 'segformer'", "SEGMENTOR: 'spnet'"))
            os.environ['OPENSEG3D_ALLOW_WOD_STUB'] = '1'
            path = test_tool.main(['--cfg_file', cfg_file, '--data_dir', tree, '--save_dir',
                                   save_dir, '--device', 'cpu'])
            assert len(wod_stub.read_submission(path)[1]) == 2
assert not any(m.split('.')[0] in ('jax', 'flax', 'optax', 'openseg3d_tpu', 'bench')
               for m, v in sys.modules.items() if v is not None)
print('ok')
'''


def test_variants_and_test_tool_run_without_jax():
    """With JAX, flax, optax, the JAX package and the benchmark script
    blocked, a subprocess runs a tiny SPNet and a tiny multi-sweep Segformer
    (forward, eval step, one train step) on a frame of a tree in the offline
    parser's format, and tools.test writes a submission from the SPNet's
    checkpoint under the stand-in protos."""
    import subprocess
    script = _NO_JAX_SCRIPT % dict(smoke=SMOKE)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, '-c', script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith('ok')

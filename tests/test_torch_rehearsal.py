"""``python -m openseg3d_tpu_torch.tools.rehearsal`` on the CPU: a 2-frame
tree in the offline parser's format through the three tools, each in its own
process (2 torch threads each), ending in a submission that decodes to one
frame a test-set entry, with a label for every current point."""

import os

import numpy as np

from openseg3d_tpu_torch.tools import rehearsal
from openseg3d_tpu_torch.utils import wod_stub

N_POINTS = 4096


def test_rehearsal_runs_train_eval_test_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv('OMP_NUM_THREADS', '2')
    work = tmp_path / 'rehearsal'
    res = rehearsal.main(['--work_dir', str(work), '--frames', '2', '--n_points', str(N_POINTS),
                          '--cfg_file', 'configs/synthetic_smoke.yaml', '--optimizer', 'adamw',
                          '--lr', '0.001', '--drop_path', '0.0', '--device', 'cpu'])
    assert len(res['losses']) == 2 and np.isfinite(res['losses']).all(), res['losses']
    assert res['miou'] is not None and np.isfinite(res['miou'])
    assert res['cfg_file'] == str(work / 'cfg_rehearsal.yaml')
    assert os.path.exists(os.path.join(res['save_dir'], 'epoch_1.pt'))
    method, frames = wod_stub.read_submission(res['submission'])
    assert method == 'rehearsal' and res['size'] == os.path.getsize(res['submission'])
    assert [(ctx, int(ts)) for ctx, ts, _ in frames] == \
        [(n.split('-')[0], int(n.split('-')[1])) for n in res['names']]
    for _, _, lasers in frames:
        (_, first, second), = lasers
        # the make_tree index gives each point its own pixel of the first return
        assert int((first[..., 1] > 0).sum() + (second[..., 1] > 0).sum()) == N_POINTS
    log = (work / 'rehearsal.log').read_text()
    assert 'openseg3d_tpu_torch.tools.test' in log and 'loaded' in log

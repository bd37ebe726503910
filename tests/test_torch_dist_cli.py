"""The train CLI at two ranks on the CPU (gloo processes,
tests/torch_dist_workers.py); the data-parallel step against the JAX
package's is in tests/test_torch_dist.py."""

import os

import numpy as np

import torch_dist_workers as workers
from test_torch_dist import REPO, WORLD


def test_train_cli_at_two_ranks(tmp_path):
    """tools.train --launcher pytorch --device cpu on synthetic_smoke.yaml
    at 2 ranks x B = 1: one epoch of 2 steps with validation. The seed is
    drawn on rank 0 and broadcast (no --seed), one epoch_1.pt is written
    (by rank 0), both ranks end with bit-equal parameters equal to the
    file's, and rank 0 logs one mIoU, the same on both ranks."""
    run_dir = tmp_path / 'run'
    argv = ['--cfg_file', os.path.join(REPO, 'configs', 'synthetic_smoke.yaml'), '--synthetic',
            '--synthetic_frames', '4', '--batch_size', '1', '--epochs', '1',
            '--num_workers', '0', '--eval_epoch_interval', '1', '--log_iter_interval', '1',
            '--device', 'cpu', '--launcher', 'pytorch', '--save_dir', str(run_dir)]
    ranks = workers.run(workers.train_cli, WORLD, tmp_path / 'ranks', {'argv': argv},
                        timeout=400.0)
    assert sorted(os.listdir(run_dir)) == ['epoch_1.pt', 'train.log']
    digest = workers.model_digest(str(run_dir / 'epoch_1.pt'))
    assert [r['digests'] for r in ranks] == [[digest], [digest]]
    for r in ranks:
        h = r['history']
        assert [(e, i) for e, i, *_ in h['train']] == [(1, 1), (1, 2)]
        assert all(np.isfinite(t[3]) for t in h['train']) and h['skipped'] == 0
        assert len(h['val']) == 1 and np.isfinite(h['val'][0][1])
    # the same losses, learning rates and mIoU on both ranks (the times differ)
    assert [[t[:4] for t in r['history']['train']] for r in ranks[1:]] == \
        [[t[:4] for t in ranks[0]['history']['train']]]
    assert ranks[0]['history']['val'] == ranks[1]['history']['val']
    log = (run_dir / 'train.log').read_text()
    assert 'process 0/2, backend: gloo, device: cpu' in log
    assert log.count('Metrics on validation dataset') == 1
    assert 'process 1/2' not in log

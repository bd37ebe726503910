"""One float32 train step of the port's multi-sweep and cylinder Segformers
against the JAX package's (the cases and the forward tests are in
tests/test_torch_variants.py): the loss, every gradient, the BatchNorm
statistics and the parameters after one SGD step, abs/rel 1e-4."""

import numpy as np
import pytest

from test_torch_segformer import TOL
from test_torch_train import _assert_trees_close, _step_both
from test_torch_variants import CASES


@pytest.mark.parametrize('case', sorted(CASES))
def test_train_step_matches_jax(monkeypatch, case):
    cfg, nb = CASES[case]()
    metrics, grads, new_stats, new_params, jloss, jgrads, jstats, jparams, _ = \
        _step_both(monkeypatch, cfg, nb)
    np.testing.assert_allclose(float(metrics['loss']), float(jloss), **TOL)
    _assert_trees_close(grads, jgrads, 'grad')
    _assert_trees_close(new_stats, jstats, 'batch_stats')
    _assert_trees_close(new_params, jparams, 'params')

"""The benchmark's own ranges around the program's layers, opened only in
the traced stretch of a ``--trace 1`` run.

Each is a ``record_function`` range named ``bench.<what>``, put around a
call into the program from outside it: a forward hook on the model, and the
module attributes through which the program calls its attention core, its
sparse convs, its loss, its guard and its backward, patched for the time
the ranges are open. The program's own outputs are unchanged: a range only
marks the host's time. In the backward the autograd nodes name the layer
(the trace reader calls them ``backward: <node>``).

Phases (what the host is doing; the idle gaps are put to them): h2d,
host_prep, forward, loss, backward, guard, optimizer, readback. Layers:
attention, sparse_conv.
"""

from __future__ import annotations

import contextlib
from unittest import mock

ATTENTION = 'bench.attention'
SPARSE_CONV = 'bench.sparse_conv'
# the autograd nodes of the program's attention and sparse-conv backwards
ATTENTION_BACKWARD = 'backward: _WindowAttentionTrainBackward'
SPARSE_CONV_BACKWARD = 'backward: _SparseConvBackward'


def _wrapped(fn, name):
    from torch.profiler import record_function

    def call(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)
    return call


@contextlib.contextmanager
def phase(name: str):
    from torch.profiler import record_function
    with record_function(f'bench.{name}'):
        yield


@contextlib.contextmanager
def installed(model, optimizer=None):
    """While open: forward, attention, sparse-conv, loss, guard, backward and
    optimizer ranges."""
    import torch
    from torch.profiler import record_function
    from openseg3d_tpu_torch import engine
    from openseg3d_tpu_torch.models import layers, ocr, sparse_modules, swformer

    open_ranges = []

    def pre(module, args, kwargs=None):
        rf = record_function('bench.forward')
        rf.__enter__()
        open_ranges.append(rf)

    def post(module, args, output):
        open_ranges.pop().__exit__(None, None, None)

    patches = [mock.patch.object(swformer, n, _wrapped(getattr(swformer, n), ATTENTION))
               for n in ('window_attention_packed', 'window_attention_packed_train')]
    patches += [mock.patch.object(m, 'apply_subm', _wrapped(m.apply_subm, SPARSE_CONV))
                for m in (sparse_modules, ocr, layers)]
    patches += [mock.patch.object(engine, 'compute_loss',
                                  _wrapped(engine.compute_loss, 'bench.loss')),
                mock.patch.object(engine, '_grads_finite',
                                  _wrapped(engine._grads_finite, 'bench.guard')),
                mock.patch.object(torch.Tensor, 'backward',
                                  _wrapped(torch.Tensor.backward, 'bench.backward'))]
    if optimizer is not None:
        patches.append(mock.patch.object(optimizer, 'step',
                                         _wrapped(optimizer.step, 'bench.optimizer')))
    handles = [model.register_forward_pre_hook(pre),
               model.register_forward_hook(post, always_call=True)]
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        try:
            yield
        finally:
            for h in handles:
                h.remove()

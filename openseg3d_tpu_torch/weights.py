"""Weights for the port: carried across from the JAX package, or seeded.

``load_flax_variables`` fills a port model from the JAX package's ``params``
and ``batch_stats`` trees, given as nested dicts of numpy arrays (the JAX to
numpy step, ``jax.device_get``, is the caller's; this module needs numpy
only). Port modules carry their flax counterparts' names, so the walk is by
name:
  * ``nn.Linear``: Dense ``kernel [in, out]`` -> ``weight`` (transposed), ``bias``;
  * ``nn.LayerNorm``: ``scale`` -> ``weight``, ``bias``;
  * ``nn.ModuleList``: an ``nn.scan`` over layers; every leaf below it is
    stacked on axis 0, and layer i takes slice i;
  * anything else: parameters and buffers by their own names (sparse-conv
    ``kernel [27, Cin, Cout]`` as it is, SALayer's ``kernel [27, Cin, 1]``, OCR's ``transform_kernel`` too,
    DeepFusion's ``kv_proj`` (a DenseGeneral: ``kernel [Ci, 2, hc]``,
    ``bias [2, hc]``), ``in_proj_kernel [C, 3C]``, ``in_proj_bias``, ``tau``, BN
    ``scale``/``bias``/``mean``/``var``).
Any leaf left unused, any tensor left unset, and any shape mismatch raises.

``to_flax_variables`` is the inverse: the model's parameters (or their
gradients) and BatchNorm buffers as flax-named trees of numpy arrays, Linear
kernels transposed back and ``ModuleList`` layers re-stacked on axis 0, so
that they compare leaf by leaf with the JAX package's trees.

``init_weights`` fills a model with seeded random weights from a
``torch.Generator`` instead, for runs that need full-width weights but no
trained ones.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
from torch import nn

from .models.deep_fusion import DenseGeneral
from .models.layers import SALayer
from .models.norm import MaskedBatchNorm
from .models.ocr import OCRLayer
from .models.sparse_modules import SparseConv
from .models.swformer import WindowAttention


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, 'items'):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _targets(module: nn.Module, prefix: tuple, pick: Callable, out: list):
    """(flax leaf path, tensor, transform) for every parameter and buffer."""
    if isinstance(module, nn.ModuleList):
        for i, child in enumerate(module):
            _targets(child, prefix, lambda a, i=i: pick(a)[i], out)
        return
    if isinstance(module, nn.Linear):
        out.append((prefix + ('kernel',), module.weight, lambda a: pick(a).T))
        if module.bias is not None:
            out.append((prefix + ('bias',), module.bias, pick))
        return
    if isinstance(module, nn.LayerNorm):
        out.append((prefix + ('scale',), module.weight, pick))
        out.append((prefix + ('bias',), module.bias, pick))
        return
    for name, t in list(module.named_parameters(recurse=False)) + \
            list(module.named_buffers(recurse=False)):
        out.append((prefix + (name,), t, pick))
    for name, child in module.named_children():
        _targets(child, prefix + (name,), pick, out)


def parameter_leaves(model: nn.Module) -> list:
    """(flax leaf path, parameter, fn) for every parameter of `model`: fn
    maps the flax leaf (or any tree leaf of the same layout, such as an
    optimizer moment) to the parameter's layout, transposing Linear kernels
    and slicing ``ModuleList`` layers."""
    targets: list = []
    _targets(model, (), lambda a: a, targets)
    return [(path, t, fn) for path, t, fn in targets if isinstance(t, nn.Parameter)]


def load_flax_variables(model: nn.Module, params: dict, batch_stats: dict) -> None:
    """Copy the JAX package's variables into `model` in place."""
    leaves = _flatten(params)
    stats = _flatten(batch_stats)
    both = set(leaves) & set(stats)
    if both:
        raise ValueError(f'paths in both params and batch_stats: {sorted(both)[:5]}')
    leaves.update(stats)
    targets: list = []
    _targets(model, (), lambda a: a, targets)
    unset = sorted({'/'.join(p) for p, _, _ in targets if p not in leaves})
    unused = sorted({'/'.join(p) for p in set(leaves) - {p for p, _, _ in targets}})
    if unset or unused:
        raise ValueError(f'flax tree does not match the model: unset {unset[:10]} '
                         f'({len(unset)}), unused {unused[:10]} ({len(unused)})')
    with torch.no_grad():
        for path, tensor, fn in targets:
            value = np.array(fn(leaves[path]), dtype=np.float32, order='C')
            if tuple(value.shape) != tuple(tensor.shape):
                raise ValueError(f'{"/".join(path)}: flax {value.shape} vs '
                                 f'torch {tuple(tensor.shape)}')
            tensor.copy_(torch.from_numpy(value))


def _export(module: nn.Module, prefix: tuple, grads: bool) -> dict:
    """{flax leaf path: (numpy array, 'params' or 'batch_stats')}."""
    if isinstance(module, nn.ModuleList):
        per_layer = [_export(child, prefix, grads) for child in module]
        return {path: (np.stack([layer[path][0] for layer in per_layer]), kind)
                for path, (_, kind) in (per_layer[0] if per_layer else {}).items()}

    def value(t):
        if not grads:
            return t.detach().cpu().numpy()
        if t.grad is None:
            return np.zeros(tuple(t.shape), np.float32)
        return t.grad.detach().cpu().numpy()

    out = {}
    if isinstance(module, nn.Linear):
        out[prefix + ('kernel',)] = (value(module.weight).T, 'params')
        if module.bias is not None:
            out[prefix + ('bias',)] = (value(module.bias), 'params')
        return out
    if isinstance(module, nn.LayerNorm):
        out[prefix + ('scale',)] = (value(module.weight), 'params')
        out[prefix + ('bias',)] = (value(module.bias), 'params')
        return out
    for name, t in module.named_parameters(recurse=False):
        out[prefix + (name,)] = (value(t), 'params')
    if not grads:
        for name, t in module.named_buffers(recurse=False):
            out[prefix + (name,)] = (t.detach().cpu().numpy(), 'batch_stats')
    for name, child in module.named_children():
        out.update(_export(child, prefix + (name,), grads))
    return out


def _unflatten(leaves: dict) -> dict:
    tree: dict = {}
    for path, arr in leaves.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.ascontiguousarray(arr)
    return tree


def to_flax_variables(model: nn.Module, grads: bool = False):
    """(params, batch_stats): the inverse of ``load_flax_variables``, nested
    dicts of float32 numpy arrays under the flax names. With grads=True,
    params holds each parameter's ``.grad`` (zeros where it has none) and
    batch_stats is empty."""
    leaves = _export(model, (), grads)
    params = {p: a for p, (a, kind) in leaves.items() if kind == 'params'}
    stats = {p: a for p, (a, kind) in leaves.items() if kind == 'batch_stats'}
    return _unflatten(params), _unflatten(stats)


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights, scaled as the JAX package's initialisers scale
    them: kernels fan-in normal with gain 2 (kaiming), in_proj Xavier-uniform,
    tau 0.1, biases 0, norms at identity. Reproducible from the generator's
    seed, independent of the global RNG."""
    def normal(shape, std):
        return torch.randn(shape, generator=generator) * std

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                mod.weight.copy_(normal(mod.weight.shape, math.sqrt(2.0 / mod.in_features)))
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, OCRLayer):
                k3, cin, _ = mod.transform_kernel.shape
                mod.transform_kernel.copy_(normal(mod.transform_kernel.shape,
                                                  math.sqrt(2.0 / (k3 * cin))))
            elif isinstance(mod, DenseGeneral):
                mod.kernel.copy_(normal(mod.kernel.shape, math.sqrt(2.0 / mod.kernel.shape[0])))
                mod.bias.zero_()
            elif isinstance(mod, (SparseConv, SALayer)):
                k3, cin, _ = mod.kernel.shape
                mod.kernel.copy_(normal(mod.kernel.shape, math.sqrt(2.0 / (k3 * cin))))
                if getattr(mod, 'bias', None) is not None:
                    mod.bias.zero_()
            elif isinstance(mod, WindowAttention):
                c, c3 = mod.in_proj_kernel.shape
                bound = math.sqrt(6.0 / (c + c3))
                mod.in_proj_kernel.copy_(
                    (torch.rand(mod.in_proj_kernel.shape, generator=generator) * 2 - 1) * bound)
                mod.in_proj_bias.zero_()
                mod.tau.fill_(0.1)
            elif isinstance(mod, MaskedBatchNorm):
                mod.scale.fill_(1.0)
                mod.bias.zero_()
                mod.mean.zero_()
                mod.var.fill_(1.0)
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()

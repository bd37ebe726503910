"""Seeded weights, made on the device in a few large draws.

The rule follows the model's initialisers (the port's
``weights.init_weights``, after the JAX package's): conv kernels [27, Cin,
Cout] and linear weights [out, in] fan-in normal with gain 2; the packed
attention in-projection [C, 3C] Xavier-uniform; tau 0.1; biases 0; norms at
identity (scale 1, bias 0, running mean 0 and variance 1). Every entry of a
state dict is placed by its name and shape alone, in sorted-name order, so
the program and the reference, whose state dicts have the same names, get
the same values from one seed.
"""

from __future__ import annotations

import math

import torch

from .frames import seed_sequence


def _rule(name: str, shape: tuple):
    """('normal', std), ('uniform', bound) or ('fill', value)."""
    leaf = name.rsplit('.', 1)[-1]
    if leaf in ('kernel', 'transform_kernel') and len(shape) == 3:
        return 'normal', math.sqrt(2.0 / (shape[0] * shape[1]))
    if leaf == 'in_proj_kernel':
        return 'uniform', math.sqrt(6.0 / (shape[0] + shape[1]))
    if leaf == 'weight' and len(shape) == 2:
        return 'normal', math.sqrt(2.0 / shape[1])
    if leaf == 'tau':
        return 'fill', 0.1
    if leaf in ('scale', 'var') or (leaf == 'weight' and len(shape) == 1):
        return 'fill', 1.0
    if leaf in ('bias', 'in_proj_bias', 'mean'):
        return 'fill', 0.0
    raise KeyError(f'no weight rule for {name} {shape}')


def draw(shapes: dict, seed: int, device) -> dict:
    """{name: float32 tensor on `device`} for {name: shape}: one normal and
    one uniform draw over all the entries that take them."""
    names = sorted(shapes)
    rules = {n: _rule(n, tuple(shapes[n])) for n in names}
    sizes = {kind: sum(math.prod(shapes[n]) for n in names if rules[n][0] == kind)
             for kind in ('normal', 'uniform')}
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed_sequence(seed, 'weights').generate_state(2, dtype='uint64')[0]))
    pools = {'normal': torch.randn(sizes['normal'], generator=gen, device=device),
             'uniform': torch.rand(sizes['uniform'], generator=gen, device=device) * 2 - 1}
    used = {'normal': 0, 'uniform': 0}
    out = {}
    for n in names:
        kind, value = rules[n]
        shape = tuple(shapes[n])
        if kind == 'fill':
            out[n] = torch.full(shape, value, dtype=torch.float32, device=device)
            continue
        size = math.prod(shape)
        out[n] = pools[kind][used[kind]:used[kind] + size].view(shape) * value
        used[kind] += size
    return out


def load(model: torch.nn.Module, seed: int) -> dict:
    """Draw the weights of `model` on its device and copy them in; returns
    them."""
    state = model.state_dict()
    device = next(model.parameters()).device
    weights = draw({k: tuple(v.shape) for k, v in state.items()}, seed, device)
    model.load_state_dict(weights)
    return weights

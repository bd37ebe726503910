"""Configuration: the JAX package's schema and defaults, without its import.

A copy of ``openseg3d_tpu/config.py`` (``ConfigDict`` with its pickling and
``unfrozen_copy``, ``default_config``, ``cfg_from_file``, ``grid_size``), so
that the port's runtime path imports nothing of the JAX package. The
defaults are the same values; the reasons for each capacity and ladder are
documented at the original.
``tests/test_torch_host.py`` holds this module equal to the original on the
defaults and on every file under ``configs/``.

PyYAML is imported only when a file is read: the defaults and overrides work
without it.
"""

from __future__ import annotations

import copy
from typing import Any

import numpy as np


def _rebuild_config(items: dict, frozen: bool) -> 'ConfigDict':
    c = ConfigDict(items)
    return c.freeze() if frozen else c


class ConfigDict(dict):
    """A dict with attribute access, immutable once ``freeze()`` is called.

    Picklable (``__reduce__``): default dict-subclass pickling restores the
    items through ``__setitem__`` before ``_frozen`` exists, which raises,
    and configs cross to the spawned data-loader workers."""

    def __reduce__(self):
        return (_rebuild_config, (dict(self), object.__getattribute__(self, '_frozen')))

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        object.__setattr__(self, '_frozen', False)
        for k, v in list(self.items()):
            if isinstance(v, dict) and not isinstance(v, ConfigDict):
                self[k] = ConfigDict(v)

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, '_frozen'):
            raise AttributeError(f'Config is frozen; cannot set {name!r}')
        if isinstance(value, dict) and not isinstance(value, ConfigDict):
            value = ConfigDict(value)
        self[name] = value

    def __setitem__(self, key, value):
        if object.__getattribute__(self, '_frozen'):
            raise AttributeError(f'Config is frozen; cannot set {key!r}')
        super().__setitem__(key, value)

    def freeze(self) -> 'ConfigDict':
        for v in self.values():
            if isinstance(v, ConfigDict):
                v.freeze()
        object.__setattr__(self, '_frozen', True)
        return self

    def unfrozen_copy(self) -> 'ConfigDict':
        """A deep, writable copy: the route to a change the strict merge
        refuses, such as new keys under MODEL.LOSSES."""
        out = ConfigDict()
        for k, v in self.items():
            out[k] = v.unfrozen_copy() if isinstance(v, ConfigDict) else copy.deepcopy(v)
        return out


def _ladder(ts, top=800):
    """Window-occupancy bucket table: one level per max_tokens in ts, plus
    the 800-token drop cap."""
    out, lo = {}, 0
    for i, t in enumerate(ts):
        out[str(i)] = {'max_tokens': t, 'batching_range': [lo, t]}
        lo = t
    out[str(len(ts))] = {'max_tokens': top, 'batching_range': [lo, 100000]}
    return out


def default_config() -> ConfigDict:
    """The JAX package's defaults: DATASET / MODEL / TRAIN, plus RUNTIME's
    static capacities."""
    c = ConfigDict()

    c.DATASET = ConfigDict()
    c.DATASET.USE_MULTI_SWEEPS = False
    c.DATASET.MAX_NUM_SWEEPS = 5
    c.DATASET.NUM_SWEEPS = 3
    c.DATASET.USE_CYLINDER = False
    c.DATASET.POINT_CLOUD_RANGE = [-72, -72, -2, 72, 72, 4.4]
    c.DATASET.VOXEL_SIZE = [0.1, 0.1, 0.1]
    c.DATASET.DIM_POINT = 6
    c.DATASET.USE_IMAGE_FEATURE = False
    c.DATASET.DIM_IMAGE_FEATURE = 28
    c.DATASET.NUM_CLASSES = 22
    c.DATASET.CLASS_NAMES = []
    c.DATASET.CLASS_WEIGHT = []
    c.DATASET.PALETTE = []
    c.DATASET.IGNORE_INDEX = 255
    c.DATASET.AUG_DATA = True
    c.DATASET.AUG_ROT_RANGE = [-0.78539816, 0.78539816]
    c.DATASET.AUG_SCALE_RANGE = [0.95, 1.05]
    c.DATASET.AUG_TRANSLATE_STD = 0.5
    c.DATASET.AUG_SAMPLE_RATIO = 0.95
    c.DATASET.AUG_SAMPLE_RANGE = 50.0
    c.DATASET.AUG_COLOR_DROP_RATIO = 0.5
    c.DATASET.VISUALIZE = False

    c.MODEL = ConfigDict()
    c.MODEL.SEGMENTOR = 'segformer'
    c.MODEL.LOSSES = {'ohem_ce': 1.0, 'lovasz': 1.0}
    c.MODEL.OHEM_KEEP_RATIO = 0.3
    c.MODEL.OHEM_KEEP_THRESH = 0.7
    c.MODEL.USE_CLASS_WEIGHT = False
    c.MODEL.AUX_LOSS_WEIGHT = 0.4
    c.MODEL.BATCHING_INFO = [
        _ladder([16, 32, 64, 128, 256]),
        _ladder([32, 64, 128, 256, 512]),
        _ladder([32, 64, 128, 256, 512]),
        _ladder([64, 128, 256, 512]),
    ]
    c.MODEL.WINDOW_SHAPE = [10, 10, 8]
    c.MODEL.DEPTHS = [3, 4, 8, 3]
    c.MODEL.DROP_PATH_RATE = 0.3
    c.MODEL.FUSION_KNN_KERNEL_SIZE = 3
    c.MODEL.FUSION_KNN_BUCKET_CAP = 8

    c.TRAIN = ConfigDict()
    c.TRAIN.OPTIMIZER = 'adamw'
    c.TRAIN.LR = 0.001
    c.TRAIN.WEIGHT_DECAY = 0.01
    c.TRAIN.MOMENTUM = 0.9
    c.TRAIN.LR_SCHEDULER = 'warmup_poly_lr'

    c.RUNTIME = ConfigDict()
    c.RUNTIME.MAX_POINTS_PER_SAMPLE = 180224
    c.RUNTIME.MAX_VOXELS_PER_SAMPLE = 114688
    c.RUNTIME.STAGE_CAPACITY_RATIOS = [1.0, 1.45, 0.7, 0.25]
    c.RUNTIME.WINDOW_BUCKET_FRACTIONS = [
        [1.02, 0.28, 0.37, 0.40, 0.14, 0.02],
        [0.30, 0.32, 0.51, 0.52, 0.04, 0.02],
        [0.24, 0.26, 0.50, 0.75, 0.10, 0.02],
        [0.45, 0.42, 0.76, 0.11, 0.02],
    ]
    c.RUNTIME.COMPUTE_DTYPE = 'bfloat16'
    c.RUNTIME.SCAN_UNROLL = True
    c.RUNTIME.NUM_DEVICES = 0
    return c


def _merge_a_into_b(a: dict, b: ConfigDict, path: str = '') -> None:
    """Strict merge: every key of a must exist in b with a matching type
    (an int may stand for a float)."""
    for k, v in a.items():
        if k not in b:
            raise KeyError(f'{path}{k} is not a valid config key')
        old = b[k]
        if isinstance(old, ConfigDict):
            if not isinstance(v, dict):
                raise ValueError(f'Type mismatch ({type(old)} vs {type(v)}) for config key: {path}{k}')
            _merge_a_into_b(v, old, path=f'{path}{k}.')
            continue
        if old is not None and v is not None and not isinstance(old, type(v)):
            if isinstance(old, float) and isinstance(v, int):
                v = float(v)
            else:
                raise ValueError(
                    f'Type mismatch ({type(old)} vs. {type(v)}) for config key: {path}{k}')
        b[k] = v


def cfg_from_file(filename: str | None = None, overrides: dict | None = None) -> ConfigDict:
    """A YAML config overlaid onto the defaults, then the overrides; frozen."""
    c = default_config()
    if filename is not None:
        import yaml
        with open(filename, 'r') as f:
            yaml_cfg = yaml.safe_load(f)
        if yaml_cfg:
            _merge_a_into_b(yaml_cfg, c)
    if overrides:
        _merge_a_into_b(overrides, c)
    return c.freeze()


def grid_size(cfg: ConfigDict) -> tuple[int, int, int]:
    """Integer (gx, gy, gz) voxel grid size from the range and voxel size."""
    rng = np.array(cfg.DATASET.POINT_CLOUD_RANGE, dtype=np.float32)
    vs = np.array(cfg.DATASET.VOXEL_SIZE, dtype=np.float32)
    gs = np.round((rng[3:] - rng[:3]) / vs).astype(np.int64)
    return int(gs[0]), int(gs[1]), int(gs[2])

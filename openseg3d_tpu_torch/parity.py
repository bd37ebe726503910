"""The full-capacity comparison of the port with the JAX package.

Reference files (``parity_data/<name>.npz``) hold what the JAX package's own
eval step (``openseg3d_tpu/engine.make_eval_step``, with the loss) computed
on a CPU, in float32 and in bfloat16, at full width and the full ``RUNTIME``
capacities, for a named configuration, seeded weights and a named frame.
``python tests/test_torch_fullsize.py --write`` writes them on a host with
JAX; everything here needs numpy and torch only, so the GPU machine rebuilds
the same weights and frame, runs the port and holds it to the file
(``compare_with_reference``).

Weights (``reference_weights``): every leaf of the flax tree is drawn from
one ``np.random.RandomState(seed)``, leaf by leaf in sorted (collection,
path) order, at the scale ``weights.init_weights`` uses (kernels fan-in
normal with gain 2, in_proj Xavier-uniform, tau near 0.1), with BatchNorm
and LayerNorm scales near 1, small biases and drawn BatchNorm statistics
(mean small, var in [0.5, 2]) so that eval-mode BatchNorm is exercised.
Drawing with numpy keeps the weights independent of the torch version.

The train reference (``TRAIN_REFERENCES``) holds the JAX package's float32
train step instead: ``jax.value_and_grad`` of its loss with the BatchNorm
statistics mutable, dropout and drop path off, no optimizer. Its aux labels
(JAX's 1-NN on JAX's own voxel centres) are stored and fed to the port, so
that ties between equidistant centres cannot move the loss. Per gradient and
BatchNorm leaf it stores the largest magnitude, the L2 norm, the values at up
to SAMPLED_PER_LEAF seeded flat indices, and JAX's own movement: the largest
change of the leaf under two draws of 1e-7 relative noise on the weights,
over its largest magnitude. ``check_train_reference`` runs the port's step
and holds it to the file.

Frames (``reference_frame``):
  * ``one_sweep``: the benchmark frame, ``make_waymo_like_cloud`` from
    RandomState(0), 163840 points, random labels (``chip_smoke.py``'s), and
    where the configuration uses image features, synthetic ones drawn next
    (``data/synthetic.synthetic_image_features``);
  * ``multi_sweep``: the last of 3 frames of one segment written by
    ``data/synthetic.make_tree`` and read through ``WaymoDataset`` in
    validation mode with 3 sweeps, 60074 points a frame so that the 3
    sweeps (180222 points) fill ``MAX_POINTS_PER_SAMPLE`` 180224 without
    cutting a current point.

Over-full windows: a window that holds more voxels than its level's token
cap drops some, and which ones follows the in-window order, which the JAX
package leaves to an unstable sort; the dropped voxels miss that block's
attention, and the difference spreads through the later layers beyond the
window. So the gates hold only on a frame without one: the writer counts
them (``overfull_windows``) and ``compare_with_reference`` refuses a
reference that has any.
"""

from __future__ import annotations

import copy
import hashlib
import os
import tempfile

import numpy as np
import torch

from .config import cfg_from_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'parity_data')

# name -> (config file under configs/, overrides, frame); the names in
# TRAIN_REFERENCES hold a train step (``check_train_reference``), the others
# an eval step (``check_reference``)
REFERENCES = {
    'waymo_one_sweep': ('waymo_one_sweep.yaml', {}, 'one_sweep'),
    'waymo_multi_sweeps': ('waymo_multi_sweeps.yaml', {}, 'multi_sweep'),
    'waymo_one_sweep_spnet': ('waymo_one_sweep.yaml', {'MODEL': {'SEGMENTOR': 'spnet'}},
                              'one_sweep'),
    'waymo_one_sweep_deepfusion': ('waymo_one_sweep.yaml', {'DATASET': {
        'USE_IMAGE_FEATURE': True, 'DIM_IMAGE_FEATURE': 28}}, 'one_sweep'),
    'waymo_one_sweep_train': ('waymo_one_sweep.yaml', {'MODEL': {'DROP_PATH_RATE': 0.0}},
                              'one_sweep'),
}
TRAIN_REFERENCES = ('waymo_one_sweep_train',)
EVAL_REFERENCES = tuple(n for n in sorted(REFERENCES) if n not in TRAIN_REFERENCES)
WEIGHT_SEED = 0
FRAME_SEED = 0
FRAME_POINTS = {'one_sweep': 163840, 'multi_sweep': 60074}
SAMPLED_ROWS = {'point': 4096, 'voxel': 2048, 'aux': 1024}

# gates (PERF.md section 6 states the values measured against them)
FLOAT32_LOGIT_TOL = 1e-3      # x max(1, max |logit|) at the sampled rows
FLOAT32_AGREEMENT = 0.999
LOSS_RTOL = 1e-3
BF16_AGREEMENT_SLACK = 0.005  # below JAX bf16's own agreement with JAX float32
BF16_LOGIT_FACTOR = 2.0       # x JAX bf16's own sampled-logit error
# the train reference (float32): the loss relative; each gradient leaf within
# (TRAIN_TOL + TRAIN_MOVEMENT_FACTOR x JAX's own movement) x (1 + its largest
# magnitude); the BatchNorm statistics within TRAIN_TOL x (1 + their largest)
TRAIN_LOSS_RTOL = 1e-4
TRAIN_TOL = 1e-4
TRAIN_MOVEMENT_FACTOR = 2.0
SAMPLED_PER_LEAF = 64


def reference_path(name: str) -> str:
    return os.path.join(DATA_DIR, f'{name}.npz')


def reference_config(name: str, dtype: str = 'float32'):
    """The configuration of reference `name` at RUNTIME.COMPUTE_DTYPE
    `dtype`."""
    cfg_file, ov, _ = REFERENCES[name]
    ov = copy.deepcopy(ov)
    ov.setdefault('RUNTIME', {})['COMPUTE_DTYPE'] = dtype
    return cfg_from_file(os.path.join(REPO, 'configs', cfg_file), overrides=ov)


def _stacked_prefixes(model: torch.nn.Module) -> list:
    """Flax paths under which ``to_flax_variables`` stacks layers on axis 0
    (the port's ModuleLists)."""
    return [tuple(name.split('.')) for name, m in model.named_modules()
            if isinstance(m, torch.nn.ModuleList)]


def _draw(rng, name: str, shape: tuple, layer_shape: tuple,
          fan_in: int | None = None) -> np.ndarray:
    if name in ('kernel', 'transform_kernel'):
        fan_in = fan_in or int(np.prod(layer_shape[:-1]))
        return rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)
    if name == 'in_proj_kernel':
        bound = np.sqrt(6.0 / (layer_shape[0] + layer_shape[1]))
        return rng.uniform(-bound, bound, shape)
    if name == 'tau':
        return rng.uniform(0.08, 0.12, shape)
    if name in ('bias', 'in_proj_bias'):
        return 0.05 * rng.standard_normal(shape)
    if name == 'scale':
        return rng.uniform(0.8, 1.2, shape)
    if name == 'mean':
        return 0.1 * rng.standard_normal(shape)
    if name == 'var':
        return rng.uniform(0.5, 2.0, shape)
    raise ValueError(f'no rule for leaf {name}')


def reference_weights(cfg, seed: int = WEIGHT_SEED):
    """(params, batch_stats): flax-named trees of float32 numpy arrays for
    the model of `cfg` (names and shapes from the port's model, values from
    numpy only)."""
    from .engine import build_segmentor
    from .weights import to_flax_variables
    model, _ = build_segmentor(cfg, device='cpu')
    trees = dict(zip(('params', 'batch_stats'), to_flax_variables(model)))
    stacked = _stacked_prefixes(model)
    leaves = []
    for coll, tree in trees.items():
        def walk(node, prefix):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(v, prefix + (k,))
                else:
                    leaves.append(((coll,) + prefix + (k,), v.shape))
        walk(tree, ())
    rng = np.random.RandomState(seed)
    out = {'params': {}, 'batch_stats': {}}
    for path, shape in sorted(leaves):
        is_stacked = any(path[1:1 + len(p)] == p for p in stacked)
        layer_shape = shape[1:] if is_stacked else shape
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        # DeepFusion's kv_proj is a DenseGeneral to (2, hidden): fan-in is its first axis
        fan_in = layer_shape[0] if path[-2] == 'kv_proj' else None
        node[path[-1]] = _draw(rng, path[-1], shape, layer_shape, fan_in).astype(np.float32)
    return out['params'], out['batch_stats']


def reference_frame(cfg, name: str, seed: int = FRAME_SEED) -> dict:
    """The padded numpy batch (B = 1) of frame `name` under `cfg`."""
    from .data.batch import collate_padded
    from .data.synthetic import bench_frame, make_tree
    n = FRAME_POINTS[name]
    if name == 'one_sweep':
        return bench_frame(cfg, n, seed, image_features=cfg.DATASET.USE_IMAGE_FEATURE)
    if name != 'multi_sweep':
        raise ValueError(name)
    if not cfg.DATASET.USE_MULTI_SWEEPS or cfg.DATASET.NUM_SWEEPS != 3:
        raise ValueError('the multi_sweep frame needs a 3-sweep configuration')
    from .data.waymo_dataset import WaymoDataset
    if seed != FRAME_SEED:
        raise ValueError('make_tree draws from RandomState(0) only')
    # the dataset's constructor draws PolarMix's angles from the global numpy
    # generator: leave it as it was
    state = np.random.get_state()
    try:
        with tempfile.TemporaryDirectory() as root:
            names = make_tree(root, 3, n)
            ds = WaymoDataset(cfg, root, 'validation')
            padded = ds.pad(ds[ds.filenames.index(names[-1])])
    finally:
        np.random.set_state(state)
    if int(padded['cur_point_mask'].sum()) != n:
        raise AssertionError('current points were cut')
    return collate_padded([padded])


def digest(a) -> str:
    """sha256 (first 16 hex digits) of an array's dtype, shape and bytes."""
    a = np.ascontiguousarray(a)
    h = hashlib.sha256(f'{a.dtype.str}{a.shape}'.encode())
    h.update(a.tobytes())
    return h.hexdigest()[:16]


def tree_digests(params: dict, batch_stats: dict) -> dict:
    """{'collection/path': digest} over both trees."""
    out = {}
    for coll, tree in (('params', params), ('batch_stats', batch_stats)):
        def walk(node, prefix):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(v, prefix + (k,))
                else:
                    out['/'.join((coll,) + prefix + (k,))] = digest(v)
        walk(tree, ())
    return out


def batch_digests(batch: dict) -> dict:
    return {k: digest(v) for k, v in sorted(batch.items()) if isinstance(v, np.ndarray)}


def valid_points(batch) -> np.ndarray:
    """[P] bool: the points the eval step scores (current and valid)."""
    return (np.asarray(batch['point_mask']) & np.asarray(batch['cur_point_mask']))[0]


def overfull_windows(cfg, batch) -> list:
    """Over-full windows of the frame: [(stage, level, count summed over the
    two shifts)]."""
    from .models.backbones.point_transformer import stage_level_specs
    from .models.backbones.sparse_unet import build_unet_plans
    from .models.segmentors.common import ModelSpec
    from .ops.sparse_conv import SparseTensor
    from .ops.window import _bucket_level, window_coords
    spec = ModelSpec.from_config(cfg)
    coords = torch.from_numpy(np.asarray(batch['voxel_coords']))
    with torch.no_grad():
        plans = build_unet_plans(SparseTensor(None, coords, spec.spatial_shape),
                                 spec.capacities)
    counts = []
    for s, levels in enumerate(stage_level_specs(spec)):
        sc, valid = plans.coords[s][0], plans.masks[s][0]
        per_level = np.zeros(len(levels), np.int64)
        for shift in (False, True):
            win, _ = window_coords(sc[None], valid[None], plans.shapes[s],
                                   spec.window_shape, shift)
            _, occ = torch.unique(win[0][valid], return_counts=True)
            lvl, cap = _bucket_level(occ, torch.ones_like(occ, dtype=torch.bool), levels)
            per_level += np.bincount(lvl[occ > cap].numpy(), minlength=len(levels))
        counts += [(s, li, int(c)) for li, c in enumerate(per_level)]
    return counts


def summarize(outputs: dict, batch: dict, rows: dict | None = None, seed: int = 0) -> dict:
    """The reference record's numbers from one eval step's outputs (numpy:
    point_out, voxel_out, aux_voxel_out, aux_voxel_coords, aux_voxel_mask,
    hist, loss). `rows` gives the sampled rows; without it they are drawn
    from RandomState(seed) over the valid points and the live voxels."""
    valid = valid_points(batch)
    if rows is None:
        rng = np.random.RandomState(seed)
        pick = lambda live, k: np.sort(rng.choice(np.flatnonzero(live), min(k, int(live.sum())),
                                                  replace=False)).astype(np.int32)
        rows = {'point': pick(valid, SAMPLED_ROWS['point']),
                'voxel': pick(np.asarray(batch['voxel_mask'])[0], SAMPLED_ROWS['voxel']),
                'aux': pick(np.asarray(outputs['aux_voxel_mask'])[0], SAMPLED_ROWS['aux'])}
    point_out = np.asarray(outputs['point_out'], np.float32)[0]
    return {
        'rows': rows,
        'argmax': point_out[valid].argmax(-1).astype(np.uint8),
        'point_logits': point_out[rows['point']],
        'voxel_logits': np.asarray(outputs['voxel_out'], np.float32)[0][rows['voxel']],
        'aux_logits': np.asarray(outputs['aux_voxel_out'], np.float32)[0][rows['aux']],
        'class_sums': point_out[valid].astype(np.float64).sum(0),
        'aux_voxel_coords': np.asarray(outputs['aux_voxel_coords'], np.int32)[0],
        'aux_voxel_mask': np.asarray(outputs['aux_voxel_mask'], bool)[0],
        'hist': np.asarray(outputs['hist'], np.int64),
        'loss': float(outputs['loss']),
    }


def _logit_error(got: np.ndarray, want: np.ndarray) -> float:
    """max |got - want| / max(1, max |want|)."""
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


def load_reference(name: str) -> dict:
    with np.load(reference_path(name), allow_pickle=False) as f:
        return {k: f[k] for k in f.files}


def measure(outputs: dict, batch: dict, ref: dict) -> dict:
    """One eval step's outputs (numpy, as for ``summarize``) against the
    reference record `ref` (``load_reference``, or a ``record`` of another
    run), at the reference's sampled rows."""
    rows = {k: ref[f'{k}_rows'] for k in ('point', 'voxel', 'aux')}
    got = summarize(outputs, batch, rows)
    agree = got['argmax'] == ref['argmax']
    m = {
        'agreement': float(agree.mean()),
        'disagreeing': int((~agree).sum()),
        'point_logit_err': _logit_error(got['point_logits'], ref['point_logits']),
        'voxel_logit_err': _logit_error(got['voxel_logits'], ref['voxel_logits']),
        'aux_logit_err': _logit_error(got['aux_logits'], ref['aux_logits']),
        'max_abs_logit': float(np.abs(ref['point_logits']).max()),
        'hist_l1': int(np.abs(got['hist'] - ref['hist']).sum()),
        'loss': got['loss'],
        'ref_loss': float(ref['loss']),
        'loss_rel': abs(got['loss'] - float(ref['loss'])) / abs(float(ref['loss'])),
        'class_sum_rel': float(np.abs(got['class_sums'] - ref['class_sums']).max()
                               / max(1.0, float(np.abs(ref['class_sums']).max()))),
        'aux_equal': bool(np.array_equal(got['aux_voxel_coords'], ref['aux_voxel_coords'])
                          and np.array_equal(got['aux_voxel_mask'], ref['aux_voxel_mask'])),
    }
    m['logit_err'] = max(m['point_logit_err'], m['voxel_logit_err'], m['aux_logit_err'])
    return m


def record(summary: dict) -> dict:
    """A ``summarize`` result as the flat arrays of a reference record."""
    out = {f'{k}_rows': v for k, v in summary['rows'].items()}
    out.update({k: np.asarray(v) for k, v in summary.items() if k != 'rows'})
    return out


OUTPUT_KEYS = ('voxel_out', 'aux_voxel_out', 'aux_voxel_coords', 'aux_voxel_mask')


def port_outputs(cfg, params, stats, batch, device='cuda') -> dict:
    """The port's eval step (``engine.make_eval_step`` with the loss) on a
    numpy batch, as numpy arrays: the step's point_out, hist and loss, and
    the model's other outputs (OUTPUT_KEYS, through a forward hook)."""
    from .data.batch import to_device
    from .engine import build_segmentor, make_eval_step
    from .weights import load_flax_variables
    model, spec = build_segmentor(cfg, device=device)
    load_flax_variables(model, params, stats)
    seen = {}
    hook = model.register_forward_hook(
        lambda m, args, out: seen.update({k: out[k] for k in OUTPUT_KEYS}))
    try:
        res = make_eval_step(cfg, spec, model, with_loss=True)(to_device(batch, device))
    finally:
        hook.remove()
    out = dict(seen, point_out=res['point_out'], hist=res['hist'], loss=res['loss'])
    return {k: v.detach().float().cpu().numpy() if v.is_floating_point()
            else v.detach().cpu().numpy() for k, v in out.items()}


def check_reference(name: str, dtypes=('float32', 'bfloat16'), device='cuda') -> dict:
    """The port on `device` against reference file `name`, at each compute
    dtype: {dtype: ``compare_with_reference``'s numbers}. The weights and
    the frame are built once."""
    ref = load_reference(name)
    cfg = reference_config(name)
    batch = reference_frame(cfg, REFERENCES[name][2])
    params, stats = reference_weights(cfg)
    return {dt: compare_with_reference(port_outputs(reference_config(name, dt), params, stats,
                                                    batch, device), batch, ref, dt)
            for dt in dtypes}


def compare_with_reference(outputs: dict, batch: dict, ref: dict,
                           dtype: str = 'float32') -> dict:
    """``measure``, then the gates: in float32 the sampled logits within
    FLOAT32_LOGIT_TOL x max(1, max |logit|), argmax agreement >=
    FLOAT32_AGREEMENT, the histogram within twice the disagreeing points
    (L1), the loss within LOSS_RTOL; in bfloat16 (against the JAX float32
    reference) agreement no lower than JAX bf16's own minus
    BF16_AGREEMENT_SLACK and the sampled logits within BF16_LOGIT_FACTOR x
    JAX bf16's own error. Both: the aux coords and mask equal. A reference
    whose frame has an over-full window is refused. Raises AssertionError
    on a failed gate; returns the measured numbers."""
    overfull = [tuple(int(x) for x in r) for r in ref['overfull'] if r[2]]
    assert not overfull, f'over-full windows (stage, level, count): {overfull}'
    m = measure(outputs, batch, ref)
    m['dtype'] = dtype
    assert m['aux_equal'], m
    if dtype == 'float32':
        m['gates'] = dict(logit_err=FLOAT32_LOGIT_TOL, agreement=FLOAT32_AGREEMENT,
                          hist_l1=2 * m['disagreeing'], loss_rel=LOSS_RTOL)
        assert m['logit_err'] <= FLOAT32_LOGIT_TOL, m
        assert m['agreement'] >= FLOAT32_AGREEMENT, m
        assert m['hist_l1'] <= 2 * m['disagreeing'], m
        assert m['loss_rel'] <= LOSS_RTOL, m
    else:
        own_agree, own_err = float(ref['bf16_agreement']), float(ref['bf16_logit_err'])
        m['gates'] = dict(agreement=own_agree - BF16_AGREEMENT_SLACK,
                          logit_err=BF16_LOGIT_FACTOR * own_err)
        assert m['agreement'] >= own_agree - BF16_AGREEMENT_SLACK, m
        assert m['logit_err'] <= BF16_LOGIT_FACTOR * own_err, m
    return m


# --- the train reference -----------------------------------------------------

def flat_leaves(tree: dict, prefix: tuple = ()) -> dict:
    """{'a/b/leaf': numpy array} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_leaves(v, prefix + (k,)))
        else:
            out['/'.join(prefix + (k,))] = np.asarray(v)
    return out


def leaf_summary(leaves: dict, prefix: str, seed: int = 0, movement: dict | None = None) -> dict:
    """The flat arrays of a train record for one tree ({path: array}):
    `prefix`_paths, _max (largest magnitude), _norm (L2, float64), _index
    ([L, SAMPLED_PER_LEAF] flat indices from RandomState(seed), -1 padded),
    _values (float32 there), and _movement when `movement` ({path: relative
    movement}) is given."""
    rng = np.random.RandomState(seed)
    paths = sorted(leaves)
    index = np.full((len(paths), SAMPLED_PER_LEAF), -1, np.int64)
    values = np.zeros((len(paths), SAMPLED_PER_LEAF), np.float32)
    for i, p in enumerate(paths):
        flat = np.asarray(leaves[p], np.float32).reshape(-1)
        k = min(SAMPLED_PER_LEAF, flat.size)
        pick = np.sort(rng.choice(flat.size, k, replace=False))
        index[i, :k], values[i, :k] = pick, flat[pick]
    out = {f'{prefix}_paths': np.asarray(paths),
           f'{prefix}_max': np.asarray([float(np.abs(leaves[p]).max()) for p in paths]),
           f'{prefix}_norm': np.asarray([float(np.linalg.norm(np.asarray(leaves[p], np.float64)))
                                        for p in paths]),
           f'{prefix}_index': index, f'{prefix}_values': values}
    if movement is not None:
        out[f'{prefix}_movement'] = np.asarray([float(movement[p]) for p in paths])
    return out


def perturbed(tree: dict, rng, rel: float = 1e-7) -> dict:
    """A copy of a nested dict of float32 arrays, each leaf x (1 + rel x a
    standard normal draw from `rng`), leaves in sorted key order."""
    return {k: perturbed(tree[k], rng, rel) if isinstance(tree[k], dict)
            else (tree[k] * (1 + rel * rng.standard_normal(np.shape(tree[k])))).astype(np.float32)
            for k in sorted(tree)}


def movement(base: dict, moved: list) -> dict:
    """{path: the largest |moved - base| over the draws / max |base|}."""
    return {p: max(float(np.abs(np.asarray(m[p], np.float64) - base[p]).max()) for m in moved)
            / max(float(np.abs(base[p]).max()), 1e-30) for p in base}


def no_dropout(model: torch.nn.Module) -> None:
    """Every dropout rate of the port's model set to 0 (attention, MLP,
    head, OCR and DeepFusion dropout; drop path comes from the config)."""
    from .models.deep_fusion import DeepFusionBlock
    from .models.ocr import OCRLayer
    from .models.segmentors.common import SegmentorHead
    from .models.swformer import MLP, WindowAttention
    for m in model.modules():
        if isinstance(m, WindowAttention):
            m.attn_drop = 0.0
        elif isinstance(m, (MLP, SegmentorHead, OCRLayer)):
            m.drop = 0.0
        elif isinstance(m, DeepFusionBlock):
            m.attn_pdrop = 0.0


def port_train_step(cfg, params, stats, batch, aux_labels, device='cuda') -> dict:
    """The port's train step without the optimizer: the forward in training
    mode with dropout off, ``engine.compute_loss`` on the given aux labels
    ([B, A]) and the backward. Returns {'loss', 'grads' and 'stats' (flat
    {path: numpy}: the gradients, the BatchNorm statistics after the
    step)}."""
    from .data.batch import to_device
    from .engine import build_segmentor, compute_loss, step_generator
    from .models.losses import build_criterion
    from .weights import load_flax_variables, to_flax_variables
    model, spec = build_segmentor(cfg, device=device)
    load_flax_variables(model, params, stats)
    no_dropout(model)
    model.train()
    tb = to_device(batch, device)
    out = model(tb, rng=step_generator(0, 0, device))
    loss = compute_loss(out, tb, build_criterion(cfg), spec, float(cfg.MODEL.AUX_LOSS_WEIGHT),
                        aux_labels=torch.as_tensor(np.asarray(aux_labels, np.int64),
                                                   device=device))
    loss.backward()
    grads, _ = to_flax_variables(model, grads=True)
    _, new_stats = to_flax_variables(model)
    return {'loss': float(loss.detach()), 'grads': flat_leaves(grads),
            'stats': flat_leaves(new_stats)}


def compare_with_train_reference(result: dict, ref: dict) -> dict:
    """A ``port_train_step`` result against a train record: the loss within
    TRAIN_LOSS_RTOL relative; each gradient leaf's sampled values and L2
    norm within (TRAIN_TOL + TRAIN_MOVEMENT_FACTOR x its JAX movement) x (1
    + its largest magnitude); each BatchNorm statistic's within TRAIN_TOL x
    (1 + its largest). Raises AssertionError naming the leaves past their
    gate; returns the numbers: the loss, the worst leaf (error over gate)
    and the leaves past half their gate."""
    loss_rel = abs(result['loss'] - float(ref['loss'])) / abs(float(ref['loss']))
    ratios = {}
    for prefix, key in (('grad', 'grads'), ('stats', 'stats')):
        got = result[key]
        paths = [str(p) for p in ref[f'{prefix}_paths']]
        assert sorted(got) == paths, sorted(set(got) ^ set(paths))[:5]
        for i, p in enumerate(paths):
            big = float(ref[f'{prefix}_max'][i])
            move = float(ref[f'{prefix}_movement'][i]) if prefix == 'grad' else 0.0
            gate = (TRAIN_TOL + TRAIN_MOVEMENT_FACTOR * move) * (1.0 + big)
            flat = np.asarray(got[p], np.float32).reshape(-1)
            idx = ref[f'{prefix}_index'][i]
            idx = idx[idx >= 0]
            err = max(float(np.abs(flat[idx] - ref[f'{prefix}_values'][i][:idx.size]).max()),
                      abs(float(np.linalg.norm(flat.astype(np.float64)))
                          - float(ref[f'{prefix}_norm'][i])))
            ratios[f'{key}/{p}'] = (err / gate, err, gate)
    worst = max(ratios.items(), key=lambda kv: kv[1][0])
    m = {'loss': result['loss'], 'ref_loss': float(ref['loss']), 'loss_rel': loss_rel,
         'leaves': len(ratios), 'worst': worst[0], 'worst_ratio': worst[1][0],
         'worst_err': worst[1][1], 'worst_gate': worst[1][2],
         'over_half': {k: round(v[0], 3) for k, v in ratios.items() if v[0] > 0.5}}
    over = {k: v for k, v in ratios.items() if v[0] > 1.0}
    assert loss_rel <= TRAIN_LOSS_RTOL, m
    assert not over, (over, m)
    return m


def check_train_reference(name: str, device='cuda') -> dict:
    """The port's float32 train step on `device` against train reference
    `name` (``compare_with_train_reference``'s numbers, plus the seconds of
    the step). A reference whose frame has an over-full window is refused."""
    import time
    ref = load_reference(name)
    assert str(ref['kind']) == 'train', name
    overfull = [tuple(int(x) for x in r) for r in ref['overfull'] if r[2]]
    assert not overfull, f'over-full windows (stage, level, count): {overfull}'
    cfg = reference_config(name)
    batch = reference_frame(cfg, REFERENCES[name][2])
    params, stats = reference_weights(cfg)
    t0 = time.perf_counter()
    res = port_train_step(cfg, params, stats, batch, ref['aux_labels'], device)
    seconds = time.perf_counter() - t0
    m = compare_with_train_reference(res, ref)
    m['seconds'] = seconds
    return m

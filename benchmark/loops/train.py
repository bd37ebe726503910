"""Loop ``train``: the program's train step, back to back.

Set-up voxelizes and pads the ring's frames on the host into batches of the
mix's ``batch_size`` (taken in ring order), as the loader's workers do,
builds the program's model from the run's seeded weights, its optimizer
and schedule (the mix's ``schedule``: the warmup-poly recipe at the update
count ``start_update``) and runs the first three steps through the timed
call. Those steps warm every shape up and are the ones the reference
follows: their losses, the first gradient as the optimizer got it (its
momentum buffer less the weight decay) and the change of the parameters
over the three are kept. The window continues the same train state. The
timed call is ``data.batch.to_device`` then ``engine.make_train_step``'s
step, the non-finite guard's host sync included; ``train_step_ms`` is the
window over the steps it completed.
"""

from __future__ import annotations

import contextlib
import gc
import time

import torch

from benchmark import check as compare
from benchmark import frames, spans, weights
from benchmark.frames import seed_sequence

FIRST_STEPS = 3


class Session:
    pass


def program_batch(ring_frames, cfg, vg) -> dict:
    from openseg3d_tpu_torch.core.voxelizer import majority_voxel_labels
    from openseg3d_tpu_torch.data.batch import collate_padded, pad_sample
    rt = cfg.RUNTIME
    samples = []
    for f in ring_frames:
        coords, ids = vg.generate(f['points'])
        samples.append(pad_sample(
            dict(points=f['points'], voxel_coords=coords, point_voxel_ids=ids,
                 point_labels=f['labels'],
                 voxel_labels=majority_voxel_labels(ids, f['labels'], coords.shape[0])),
            rt.MAX_POINTS_PER_SAMPLE, rt.MAX_VOXELS_PER_SAMPLE))
    return collate_padded(samples)


def setup(run, process_start: float) -> Session:
    from openseg3d_tpu_torch import native
    from openseg3d_tpu_torch.core.voxelizer import VoxelGenerator
    from openseg3d_tpu_torch.data.batch import to_device
    from openseg3d_tpu_torch.engine import TrainState, build_segmentor, make_train_step
    from openseg3d_tpu_torch.models.optim import build_optimizer, build_schedule
    from openseg3d_tpu_torch.ops import _build

    s = Session()
    s.run, s.process_start, s.device = run, process_start, run.device
    if s.device.type == 'cuda':
        _build.build_all()
    native.available()
    cfg = run.program_config()
    mix = run.traffic
    bsz = int(mix['batch_size'])
    s.ring = frames.draw_ring(mix['frames'], run.seed)
    vg = VoxelGenerator(cfg.DATASET.VOXEL_SIZE, cfg.DATASET.POINT_CLOUD_RANGE)
    s.frame_batches = [s.ring[i:i + bsz] for i in range(0, len(s.ring) - bsz + 1, bsz)]
    if len(s.frame_batches) < FIRST_STEPS:
        raise ValueError(f'the ring makes {len(s.frame_batches)} batches; the check needs '
                         f'{FIRST_STEPS}')
    s.batches = [program_batch(fb, cfg, vg) for fb in s.frame_batches]

    model, spec = build_segmentor(cfg, s.device)
    s.weights0 = weights.load(model, run.seed)
    opt = build_optimizer(cfg, model.parameters())
    sch = mix['schedule']
    state = TrainState(model, opt, build_schedule(cfg, int(sch['epochs']),
                                                  int(sch['iters_per_epoch'])),
                       step=0, updates=int(sch['start_update']))
    step_fn = make_train_step(cfg, spec)
    s.dropout_seed = int(seed_sequence(run.seed, 'dropout').generate_state(1)[0])
    s.model, s.optimizer, s.state = model, opt, state
    s.count, s.traced = 0, False

    def timed():
        with spans.phase('h2d') if s.traced else contextlib.nullcontext():
            batch = to_device(s.batches[s.count % len(s.batches)], s.device)
        s.count += 1
        return step_fn(s.state, batch, s.dropout_seed)[1]
    s.timed = timed

    wd = float(cfg.TRAIN.WEIGHT_DECAY)
    params = dict(model.named_parameters())
    losses, finite = [], []
    for i in range(FIRST_STEPS):
        out = timed()
        losses.append(float(out['loss']))
        finite.append(bool(out['grads_finite']))
        if i == 0:
            # a step that kept no momentum reads as a zero gradient
            grads = {n: opt.state.get(p, {}).get('momentum_buffer', wd * s.weights0[n])
                     - wd * s.weights0[n] for n, p in params.items()}
            grad_norms = compare.leaf_norms(grads)
            del grads
    change_norms = compare.leaf_norms({n: p.detach() - s.weights0[n] for n, p in params.items()})
    s.readings = {'losses': losses, 'grad_norms': grad_norms, 'change_norms': change_norms,
                  'finite': all(finite)}
    del s.weights0
    if s.device.type == 'cuda':
        torch.cuda.synchronize(s.device)
    return s


def window(s: Session, seconds: float, profiler=None) -> dict:
    """Steps back to back for `seconds`; with a profiler, the three steps
    that take the first three batches again run traced."""
    profiled = (len(s.batches) - s.count % len(s.batches)) % len(s.batches)
    profiled = range(profiled, profiled + FIRST_STEPS) if profiler else range(0)
    steps, failed = 0, 0
    t0 = time.perf_counter()
    s.setup_s = t0 - s.process_start
    while True:
        if steps == profiled.start and profiler:
            profiler.start()
            ranges = spans.installed(s.model, s.optimizer)
            ranges.__enter__()
            s.traced = True
        out = s.timed()
        failed += not out['grads_finite']
        steps += 1
        if profiler and steps == profiled.stop:
            s.traced = False
            ranges.__exit__(None, None, None)
            profiler.stop()
        if time.perf_counter() - t0 >= seconds and (not profiler or steps >= profiled.stop):
            break
    if s.device.type == 'cuda':
        torch.cuda.synchronize(s.device)
    elapsed = time.perf_counter() - t0
    s.profiled_steps = len(profiled)
    return {'attempted': steps, 'failed': failed, 'train_step_ms': elapsed / steps * 1e3,
            'setup_s': s.setup_s}


def release(s: Session) -> None:
    """Frees the program's state before the reference runs."""
    s.state.model = s.state.optimizer = None
    del s.model, s.optimizer, s.state, s.timed, s.batches
    gc.collect()
    if s.device.type == 'cuda':
        torch.cuda.empty_cache()


def reference_readings(s: Session, precision: str = 'float32', frame_batches=None) -> dict:
    """The configuration's reference's three steps from the run's weights,
    batches and seeds, at the learning rates it works out from the mix's
    schedule; with the run's trace flag, its work records."""
    run, reference = s.run, s.run.reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    probe = reference.Segmentor(reference.Spec(run.config))
    shapes = {k: tuple(v.shape) for k, v in probe.state_dict().items()}
    del probe
    w0 = weights.draw(shapes, run.seed, s.device)
    model = reference.build(run.config, w0, s.device)
    batches = (frame_batches or s.frame_batches)[:FIRST_STEPS]
    counting = reference.counting() if run.trace else contextlib.nullcontext()
    with reference.precision(precision), counting as records:
        res = reference.train_steps(model, batches, run.config, s.dropout_seed,
                                    run.traffic['schedule'])
    out = {'losses': res['losses'], 'grad_norms': compare.leaf_norms(res['grads']),
           'change_norms': compare.leaf_norms({n: p - w0[n] for n, p in res['params'].items()}),
           'records': records}
    del model, res, w0
    gc.collect()
    if s.device.type == 'cuda':
        torch.cuda.empty_cache()
    return out


def check(s: Session) -> dict:
    ref = reference_readings(s)
    s.records = ref['records']
    numbers = compare.train_numbers(s.readings, ref)
    judged = compare.judge(numbers, s.run.limits)
    judged['correct'] = judged['correct'] and s.readings['finite']
    judged['numbers'] = numbers
    return judged


def layer_context(s: Session, profiler, checked) -> dict:
    records = s.records or []
    return {'events': profiler.events, 'window_ms': profiler.window_ms,
            'units': s.profiled_steps, 'records': records,
            'records_units': FIRST_STEPS, 'train': True, 'device': s.device}

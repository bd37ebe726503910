"""Loop ``eval``: per-frame serving, a closed loop of one client.

Each frame goes from raw points on the host to per-point labels on the
host: the program's host voxelizer (``core.voxelizer.VoxelGenerator``, the
C++ path), ``data.batch.pad_sample``/``collate_padded``,
``data.batch.to_device``, ``engine.make_forward``, the argmax and its copy
back. The next frame goes in when the last one's labels are out, as
``tools/test.py`` and an onboard stack serve a sweep; the frames cycle
through the ring. Set-up serves every ring frame once (warm-up).
``eval_frames_s`` is the frames completed over the window,
``eval_ms_p95`` the 95th percentile of every frame's latency in it, and the
host span around voxelize, pad and copy gives ``host_prep_ms``. A traced
run's readers get the same rate and percentile over the frames that ran
untraced, outside the stretch from the profiler's start to its stop
(``frames_s``, ``ms_p95``).
"""

from __future__ import annotations

import contextlib
import gc
import time

import numpy as np
import torch

from benchmark import check as compare
from benchmark import frames, spans, weights

PROFILED_FRAMES = 10


class Session:
    pass


def setup(run, process_start: float) -> Session:
    from openseg3d_tpu_torch import native
    from openseg3d_tpu_torch.core.voxelizer import VoxelGenerator
    from openseg3d_tpu_torch.data.batch import collate_padded, pad_sample, to_device
    from openseg3d_tpu_torch.engine import build_segmentor, make_forward
    from openseg3d_tpu_torch.ops import _build

    s = Session()
    s.run, s.process_start, s.device = run, process_start, run.device
    if s.device.type == 'cuda':
        _build.build_all()
    native.available()
    cfg = run.program_config()
    s.ring = frames.draw_ring(run.traffic['frames'], run.seed)
    vg = VoxelGenerator(cfg.DATASET.VOXEL_SIZE, cfg.DATASET.POINT_CLOUD_RANGE)
    model, _ = build_segmentor(cfg, s.device)
    weights.load(model, run.seed)
    forward = make_forward(model)
    cap_p, cap_v = cfg.RUNTIME.MAX_POINTS_PER_SAMPLE, cfg.RUNTIME.MAX_VOXELS_PER_SAMPLE
    s.model = model

    def serve(points, traced=False):
        """(labels uint8 [n] on the host, host-prep ms)."""
        t0 = time.perf_counter()
        with spans.phase('host_prep') if traced else contextlib.nullcontext():
            coords, ids = vg.generate(points)
            batch = collate_padded([pad_sample(
                dict(points=points, voxel_coords=coords, point_voxel_ids=ids), cap_p, cap_v)])
            tb = to_device(batch, s.device)
        prep = (time.perf_counter() - t0) * 1e3
        logits = forward(tb)
        with spans.phase('readback') if traced else contextlib.nullcontext():
            labels = logits[0, :points.shape[0]].argmax(-1).to(torch.uint8).cpu().numpy()
        return labels, prep
    s.serve = serve
    for f in s.ring:
        serve(f['points'])
    if s.device.type == 'cuda':
        torch.cuda.synchronize(s.device)
    return s


def window(s: Session, seconds: float, profiler=None) -> dict:
    """Frames one after another for `seconds`; with a profiler, frames 2 to
    11 of the window run traced."""
    profiled = range(2, 2 + PROFILED_FRAMES) if profiler else range(0)
    s.answers, latencies, preps, untraced = [], [], [], []
    n, traced_s = 0, 0.0
    t0 = time.perf_counter()
    s.setup_s = t0 - s.process_start
    while True:
        traced = n in profiled
        if profiler and n == profiled.start:
            traced_from = time.perf_counter()
            profiler.start()
            ranges = spans.installed(s.model)
            ranges.__enter__()
        ring_index = n % len(s.ring)
        start = time.perf_counter()
        labels, prep = s.serve(s.ring[ring_index]['points'], traced)
        latencies.append((time.perf_counter() - start) * 1e3)
        s.answers.append((ring_index, labels))
        if not traced:
            preps.append(prep)
            untraced.append(latencies[-1])
        n += 1
        if profiler and n == profiled.stop:
            ranges.__exit__(None, None, None)
            profiler.stop()
            traced_s = time.perf_counter() - traced_from
        if time.perf_counter() - t0 >= seconds and (not profiler or n >= profiled.stop):
            break
    elapsed = time.perf_counter() - t0
    s.host_prep_ms = float(np.mean(preps)) if preps else None
    s.frames_s = len(untraced) / (elapsed - traced_s) if untraced else None
    s.ms_p95 = float(np.percentile(untraced, 95)) if untraced else None
    s.profiled_ring = [i % len(s.ring) for i in profiled]
    return {'attempted': n, 'failed': 0, 'eval_frames_s': n / elapsed,
            'eval_ms_p95': float(np.percentile(latencies, 95)), 'setup_s': s.setup_s}


def release(s: Session) -> None:
    del s.model, s.serve
    gc.collect()
    if s.device.type == 'cuda':
        torch.cuda.empty_cache()


def reference_logits(s: Session, precision: str = 'float32') -> list:
    """The configuration's reference's point logits of every ring frame;
    with the run's trace flag, each frame's work records in s.records."""
    run, reference = s.run, s.run.reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    probe = reference.Segmentor(reference.Spec(run.config))
    shapes = {k: tuple(v.shape) for k, v in probe.state_dict().items()}
    del probe
    model = reference.build(run.config, weights.draw(shapes, run.seed, s.device), s.device)
    out, s.records = [], []
    with reference.precision(precision):
        for f in s.ring:
            if run.trace:
                with reference.counting() as rec:
                    out.append(reference.eval_logits(model, f, run.config, s.device))
                s.records.append(rec)
            else:
                out.append(reference.eval_logits(model, f, run.config, s.device))
    del model
    return out


def answers_gap(ref_logits: list, answers: list) -> dict:
    """The widest point gap and the largest squared-gap sum over the answers,
    and how many answers had the wrong length."""
    out = {'label_regret': 0.0, 'label_gap': 0.0, 'wrong_length': 0}
    for ring_index, labels in answers:
        ref = ref_logits[ring_index]
        if labels.shape[0] != ref.shape[0]:
            out['wrong_length'] += 1
            continue
        gaps = compare.label_gaps(ref, torch.from_numpy(labels).to(ref.device))
        out['label_regret'] = max(out['label_regret'], float(gaps.square().sum()))
        out['label_gap'] = max(out['label_gap'], float(gaps.max()))
    return out


def check(s: Session) -> dict:
    numbers = answers_gap(reference_logits(s), s.answers)
    judged = compare.judge(numbers, s.run.limits)
    judged['correct'] = judged['correct'] and numbers['wrong_length'] == 0
    judged['numbers'] = numbers
    judged['failed'] = numbers['wrong_length']
    return judged


def layer_context(s: Session, profiler, checked) -> dict:
    records = [r for i in s.profiled_ring for r in s.records[i]] if s.records else []
    return {'events': profiler.events, 'window_ms': profiler.window_ms,
            'units': len(s.profiled_ring), 'records': records,
            'records_units': len(s.profiled_ring), 'train': False, 'device': s.device,
            'host_prep_ms': s.host_prep_ms, 'frames_s': s.frames_s, 'ms_p95': s.ms_p95}

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases (each asserts or raises; nothing is caught):
  1. device: the card's name and power limit; TF32 off for float32 matmuls
     and convolutions, so float32 comparisons are float32;
  2. build: compiles every kernel source of openseg3d_tpu_torch/csrc/ with
     nvcc for sm_90a, one nvcc process each, all started together;
  3. kernel vs plain: the eval window-attention kernel (B1) against its plain
     PyTorch version at every (T, C) the default config's window levels give
     the 4 stages, in float32 (max abs error <= 1e-5) and bfloat16 (at most
     one bf16 rounding of the output apart: |err| <= 2^-7 |plain| + 1e-6),
     with fully padded windows and a true window count below the capacity;
     times both;
  3b. train kernels vs plain: the train attention forward (B2f) and backward
     (B2b) against the plain version and its autograd gradient at the same
     (T, C), float32 and bfloat16, drop rate 0 and 0.1 (the same hash mask on
     both sides), for a random cotangent that is zero past nw: forward as
     phase 3 (float32 within 1e-5 of the largest output), dq, dk and dv each
     within 1e-4 (float32) or 4 bf16 ulps (bfloat16) of their largest
     magnitude; times both (forward, backward);
  3c. 1-NN vs plain: the B3 kernel against its plain version on the real
     frame's voxel centres (the stage-4 aux centres against the
     full-resolution ones, the train step's label transfer) and on random
     points: indices equal; times both;
  4. eval slice: the full-width, full-capacity bfloat16 Segformer eval step
     (configs/waymo_one_sweep.yaml, seeded random weights) on one bench.py
     frame; checks the kernel's launch count against the config, finite
     logits, the histogram's count, and >= 99% argmax agreement with the same
     forward through the plain attention; times 5 forwards of each; then
     profiles one forward of each with torch.profiler: the kernel's device
     time on the main path, the plain attention's, and the device-busy share
     of that forward's wall time;
  4b. train slice: the full-width, full-capacity bfloat16 train step (the
     config's SGD with momentum and weight decay, warmup-poly schedule,
     OHEM-CE + Lovasz losses on point, voxel and 0.4x aux logits, attention
     dropout 0.1, drop path, head dropout) on the same frame; checks the
     launches of one step (B2f and B2b once per attention level and layer,
     B3 once), a finite loss, finite gradients, moved parameters and
     BatchNorm statistics; takes the same first step through the plain
     versions and compares loss and gradients; times 1 + 5 steps; profiles
     one step of each;
  5. small reference: a tiny float32 model on the GPU against the same model
     on the CPU (whose path tests/test_torch_segformer.py and
     tests/test_torch_train.py hold against the JAX package): the eval
     forward, abs/rel 1e-4; one train step with the dropout rates at 0 (the
     CPU's and the GPU's generators give different bits for one seed): the
     loss abs/rel 1e-4, every gradient, parameter and BatchNorm statistic
     within 1e-4 x (1 + the leaf's largest magnitude).
The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}. Without a CUDA device the script exits 1.
"""

from __future__ import annotations

import copy
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

# the port must not need JAX or the JAX package: make any import of them fail
for _name in ('jax', 'jaxlib', 'flax', 'optax', 'openseg3d_tpu'):
    sys.modules[_name] = None

REPO = os.path.dirname(os.path.abspath(__file__))
N_POINTS = 163840            # one bench.py frame
TINY_OVERRIDES = {
    'DATASET': {'POINT_CLOUD_RANGE': [-3.2, -3.2, -0.8, 3.2, 3.2, 0.8],
                'VOXEL_SIZE': [0.2, 0.2, 0.2]},
    'RUNTIME': {'MAX_POINTS_PER_SAMPLE': 1024, 'MAX_VOXELS_PER_SAMPLE': 512,
                'COMPUTE_DTYPE': 'float32'},
    'MODEL': {'WINDOW_SHAPE': [4, 4, 4], 'DEPTHS': [2, 2, 2, 2]},
}


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call of fn() on the current stream."""
    import torch
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_case(gen, n, t, c, nw, dtype, nhead=8):
    """Model-shaped packed q|k|v: q per-head unit and scaled by 1/tau
    (10..100), k unit, padded tokens zero with bias -1e9, window 1 fully
    padded, windows at rank >= nw padding."""
    import torch
    dev = torch.device('cuda')

    def unit(x):
        x = x.reshape(n, t, nhead, c // nhead)
        return (x / x.norm(dim=-1, keepdim=True)).reshape(n, t, c)

    scale = 10 + 90 * torch.rand(c, generator=gen, device=dev)
    q = unit(torch.randn(n, t, c, generator=gen, device=dev)) * scale
    k = unit(torch.randn(n, t, c, generator=gen, device=dev))
    v = torch.randn(n, t, c, generator=gen, device=dev)
    valid = torch.rand(n, t, generator=gen, device=dev) > 0.3
    valid[:, 0] = True
    if n > 2:
        valid[1] = False
    valid[nw:] = False
    packed = torch.where(valid[..., None], torch.cat([q, k, v], -1), 0).to(dtype)
    bias = torch.where(valid, 0.0, -1e9)
    return packed, bias, torch.tensor([nw], dtype=torch.int32, device=dev)


def check_kernel(spec, levels, channels, depths):
    """Phase 3. Returns (kernel ms, plain ms, max float32 error); the times
    are summed over shapes, depth x the time of one call at the level's
    window capacity."""
    import torch
    from openseg3d_tpu_torch.ops.attention import (window_attention_packed,
                                                   window_attention_packed_plain)
    gen = torch.Generator(device='cuda').manual_seed(0)
    fwd_ms = fwd_plain_ms = 0.0
    max_err32 = 0.0
    print('stage   T    C     W    nw  err_f32   err_bf16  kernel_ms  plain_ms')
    for s, stage_levels in enumerate(levels):
        c = channels[s]
        for lv in stage_levels:
            t, n = lv.max_tokens, lv.num_windows
            nw = max(1, n - max(1, n // 4))
            errs = {}
            for dtype in (torch.float32, torch.bfloat16):
                args = attention_case(gen, n, t, c, nw, dtype)
                got = window_attention_packed(*args[:2], 8, args[2]).float()
                want = window_attention_packed_plain(*args[:2], 8, args[2]).float()
                torch.cuda.synchronize()
                err = (got - want).abs()
                errs[dtype] = float(err.max())
                if dtype == torch.float32:
                    assert errs[dtype] <= 1e-5, (s, t, c, errs[dtype])
                else:
                    bound = 2.0 ** -7 * want.abs() + 1e-6
                    assert bool((err <= bound).all()), (s, t, c, errs[dtype])
            # time the production dtype; kernel and plain in turns
            k_fn = lambda: window_attention_packed(*args[:2], 8, args[2])   # noqa: E731
            p_fn = lambda: window_attention_packed_plain(*args[:2], 8, args[2])  # noqa: E731
            k_fn(), p_fn()
            kms = (cuda_ms(k_fn, 10) + cuda_ms(k_fn, 10)) / 2
            pms = (cuda_ms(p_fn, 10) + cuda_ms(p_fn, 10)) / 2
            max_err32 = max(max_err32, errs[torch.float32])
            fwd_ms += depths[s] * kms
            fwd_plain_ms += depths[s] * pms
            print(f'{s + 1:5d} {t:4d} {c:4d} {n:5d} {nw:5d}  {errs[torch.float32]:.2e}  '
                  f'{errs[torch.bfloat16]:.2e}  {kms:9.4f} {pms:9.4f}', flush=True)
    return fwd_ms, fwd_plain_ms, max_err32


def live_cotangent(gen, n, t, c, nw, dtype):
    """A random cotangent of a [n, t, c] attention output, zero on the
    windows past nw (the model reads nothing there)."""
    import torch
    g = torch.randn(n, t, c, generator=gen, device='cuda')
    return torch.where((torch.arange(n, device='cuda') < nw)[:, None, None], g, 0).to(dtype)


def check_train_kernels(levels, channels):
    """Phase 3b. Returns (max float32 forward error, max float32 gradient
    error), in absolute terms."""
    import torch
    from openseg3d_tpu_torch.ops.attention import (window_attention_packed_train_plain,
                                                   window_attention_train_backward,
                                                   window_attention_train_forward)
    gen = torch.Generator(device='cuda').manual_seed(2)
    seed = torch.tensor([20260516], dtype=torch.int32, device='cuda')
    max_fwd32, max_grad32 = 0.0, 0.0
    print('stage   T    C     W    nw  fwd_f32   grad_f32(rel)  fwd_bf16  grad_bf16(rel)  '
          'kfwd_ms  kbwd_ms  pfwd_ms  pbwd_ms')
    for s, stage_levels in enumerate(levels):
        c = channels[s]
        for lv in stage_levels:
            t, n = lv.max_tokens, lv.num_windows
            nw = max(1, n - max(1, n // 4))
            res = {}
            for dtype in (torch.float32, torch.bfloat16):
                for rate in (0.0, 0.1):
                    packed, bias, nwt = attention_case(gen, n, t, c, nw, dtype)
                    gout = live_cotangent(gen, n, t, c, nw, dtype)
                    out, stats = window_attention_train_forward(packed, bias, seed, nwt, 8, rate)
                    dpk = window_attention_train_backward(packed, bias, seed, nwt, out, stats,
                                                          gout, 8, rate)
                    x = packed.clone().requires_grad_(True)
                    want = window_attention_packed_train_plain(x, bias, seed, nwt, 8, rate)
                    want.backward(gout)
                    torch.cuda.synchronize()
                    want = want.detach().float()
                    err = (out.float() - want).abs()
                    fwd_abs = float(err.max())
                    if dtype == torch.float32:
                        assert fwd_abs <= 1e-5 * max(1.0, float(want.abs().max())), \
                            (s, t, c, rate, fwd_abs)
                    else:
                        assert bool((err <= 2.0 ** -7 * want.abs() + 1e-6).all()), \
                            (s, t, c, rate, fwd_abs)
                    # dq, dk and dv, each against its own largest magnitude
                    g_abs, g_rel = 0.0, 0.0
                    for part in range(3):
                        got_p = dpk[..., part * c:(part + 1) * c].float()
                        ref_p = x.grad[..., part * c:(part + 1) * c].float()
                        e = float((got_p - ref_p).abs().max())
                        g_abs = max(g_abs, e)
                        g_rel = max(g_rel, e / max(float(ref_p.abs().max()), 1e-30))
                    bound = 1e-4 if dtype == torch.float32 else 4 * 2.0 ** -7
                    assert g_rel <= bound, (s, t, c, rate, dtype, g_rel)
                    assert not out[nw:].any() and not dpk[nw:].any()
                    res[(dtype, rate)] = (fwd_abs, g_abs, g_rel)
                    if dtype == torch.float32:
                        max_fwd32, max_grad32 = max(max_fwd32, fwd_abs), max(max_grad32, g_abs)
            # time the production case (bf16, rate 0.1); kernel and plain in turns
            out, stats = window_attention_train_forward(packed, bias, seed, nwt, 8, 0.1)
            kf = lambda: window_attention_train_forward(packed, bias, seed, nwt, 8, 0.1)  # noqa: E731
            kb = lambda: window_attention_train_backward(packed, bias, seed, nwt, out,  # noqa: E731
                                                         stats, gout, 8, 0.1)
            x = packed.clone().requires_grad_(True)

            def pf():
                with torch.no_grad():
                    window_attention_packed_train_plain(packed, bias, seed, nwt, 8, 0.1)

            def pfb():
                window_attention_packed_train_plain(x, bias, seed, nwt, 8, 0.1).backward(gout)

            kf(), kb(), pf(), pfb()
            kf_ms, kb_ms = cuda_ms(kf, 5), cuda_ms(kb, 5)
            pf_ms, pfb_ms = cuda_ms(pf, 3), cuda_ms(pfb, 3)
            pb_ms = pfb_ms - pf_ms
            r32, r16 = res[(torch.float32, 0.1)], res[(torch.bfloat16, 0.1)]
            print(f'{s + 1:5d} {t:4d} {c:4d} {n:5d} {nw:5d}  {r32[0]:.2e}  {r32[2]:.2e}       '
                  f'{r16[0]:.2e}  {r16[2]:.2e}        {kf_ms:7.4f}  {kb_ms:7.4f}  {pf_ms:7.4f}  '
                  f'{pb_ms:7.4f}', flush=True)
    return max_fwd32, max_grad32


def check_nearest_point(cfg, spec, batch):
    """Phase 3c. Returns (queries, points, kernel ms, plain ms) of the real
    frame's label transfer."""
    import torch
    from openseg3d_tpu_torch.models.backbones.sparse_unet import build_unet_plans
    from openseg3d_tpu_torch.ops.knn import nearest_point, nearest_point_plain
    from openseg3d_tpu_torch.ops.sparse_conv import SparseTensor
    from openseg3d_tpu_torch.utils.pointops import get_voxel_centers
    with torch.no_grad():
        plans = build_unet_plans(SparseTensor(None, batch['voxel_coords'], spec.spatial_shape),
                                 spec.capacities)
        src = get_voxel_centers(batch['voxel_coords'], 1.0, spec.voxel_size,
                                spec.point_cloud_range)
        dst = get_voxel_centers(plans.coords[3], 8.0, spec.voxel_size, spec.point_cloud_range)
    valid = batch['voxel_mask'].contiguous()
    got = nearest_point(dst, src, valid)
    want = nearest_point_plain(dst, src, valid)
    torch.cuda.synchronize()
    live = plans.masks[3]
    assert torch.equal(got, want), int((got != want).sum())
    assert bool((got[live] >= 0).all())
    print(f'1-NN on the frame: {dst.shape[1]} aux centres ({int(live.sum())} live) against '
          f'{src.shape[1]} voxel centres ({int(valid.sum())} valid): indices equal', flush=True)

    gen = torch.Generator(device='cuda').manual_seed(3)
    q = torch.rand(1, dst.shape[1], 3, generator=gen, device='cuda') * 100 - 50
    p = torch.rand(1, src.shape[1], 3, generator=gen, device='cuda') * 100 - 50
    pv = torch.rand(1, src.shape[1], generator=gen, device='cuda') > 0.2
    assert torch.equal(nearest_point(q, p, pv), nearest_point_plain(q, p, pv))
    k_ms = cuda_ms(lambda: nearest_point(dst, src, valid), 5)
    p_ms = cuda_ms(lambda: nearest_point_plain(dst, src, valid), 2)
    print(f'1-NN random points: indices equal; frame shapes: kernel {k_ms:.4f} ms, plain '
          f'{p_ms:.4f} ms', flush=True)
    return dst.shape[1], src.shape[1], k_ms, p_ms


def frame_batch(cfg, device):
    """One bench.py frame (RandomState(0)), voxelized and padded."""
    import numpy as np
    from bench import make_waymo_like_cloud
    from openseg3d_tpu_torch.core.voxelizer import VoxelGenerator, majority_voxel_labels
    from openseg3d_tpu_torch.data.batch import collate_padded, pad_sample, to_device
    rng = np.random.RandomState(0)
    pts = make_waymo_like_cloud(rng, N_POINTS)
    vg = VoxelGenerator(cfg.DATASET.VOXEL_SIZE, cfg.DATASET.POINT_CLOUD_RANGE)
    coords, ids = vg.generate(pts)
    labels = rng.randint(0, cfg.DATASET.NUM_CLASSES, N_POINTS)
    sample = dict(points=pts, voxel_coords=coords, point_voxel_ids=ids,
                  point_labels=labels,
                  voxel_labels=majority_voxel_labels(ids, labels, coords.shape[0]))
    padded = pad_sample(sample, cfg.RUNTIME.MAX_POINTS_PER_SAMPLE,
                        cfg.RUNTIME.MAX_VOXELS_PER_SAMPLE)
    return to_device(collate_padded([padded]), device), coords.shape[0]


def busy_ms(events) -> float:
    """Milliseconds during which at least one kernel, copy or memset ran."""
    spans = sorted((e['ts'], e['ts'] + e['dur']) for e in events
                   if e.get('cat') in ('kernel', 'gpu_memcpy', 'gpu_memset'))
    total, lo, hi = 0.0, None, None
    for s, e in spans:
        if hi is None or s > hi:
            total += 0.0 if hi is None else hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    return (total + (0.0 if hi is None else hi - lo)) / 1e3


def trace(fn):
    """Run fn() once under torch.profiler. Returns (chrome trace events,
    wall ms of the run by CUDA events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start.record()
            fn()
            end.record()
            end.synchronize()
        path = os.path.join(tmp, 'trace.json')
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)['traceEvents']
    return events, start.elapsed_time(end)


def range_kernels(events, name):
    """(number of record_function ranges called name, device ms and count
    of the kernels launched inside them, matched by correlation id)."""
    ranges = [(e['ts'], e['ts'] + e['dur']) for e in events
              if e.get('cat') == 'user_annotation' and e.get('name') == name]
    launched = {e.get('args', {}).get('correlation') for e in events
                if e.get('cat') in ('cuda_runtime', 'cuda_driver')
                and any(lo <= e['ts'] <= hi for lo, hi in ranges)}
    durs = [e['dur'] for e in events if e.get('cat') == 'kernel'
            and e.get('args', {}).get('correlation') in launched - {None}]
    return len(ranges), sum(durs) / 1e3, len(durs)


def named_kernels(events, name):
    """(device ms, count) of the kernels whose name contains `name`."""
    durs = [e['dur'] for e in events if e.get('cat') == 'kernel' and name in e['name']]
    return sum(durs) / 1e3, len(durs)


def top_kernels(events, k=12):
    """The k kernel names with the most device time: [(name, ms, count)]."""
    by_name = {}
    for e in events:
        if e.get('cat') == 'kernel':
            ms, n = by_name.get(e['name'], (0.0, 0))
            by_name[e['name']] = (ms + e['dur'] / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:k]
    return [(name[:90], round(ms, 3), n) for name, (ms, n) in top]


def profile_forward(forward, batch, core):
    """One forward under torch.profiler, with the attention core (``core``,
    the kernel's wrapper or the plain version) patched into the SWFormer
    layers inside a record_function range. Returns a dict of ms: the
    forward's wall time (CUDA events), the device-busy time, the device time
    of the kernels launched inside the attention ranges (and their count),
    and of the kernels named like the CUDA kernel (and their count)."""
    from torch.profiler import record_function
    from openseg3d_tpu_torch.models import swformer

    def annotated(*args):
        with record_function('attention_core'):
            return core(*args)

    with mock.patch.object(swformer, 'window_attention_packed', annotated):
        events, wall = trace(lambda: forward(batch))
    calls, core_ms, core_kernels = range_kernels(events, 'attention_core')
    b1_ms, b1_kernels = named_kernels(events, 'window_attention_packed_kernel')
    return dict(wall_ms=wall, busy_ms=busy_ms(events), core_calls=calls, core_ms=core_ms,
                core_kernels=core_kernels, b1_ms=b1_ms, b1_kernels=b1_kernels)


def run_slice(cfg, device, expected_launches):
    """Phase 4. Returns (launches, median forward ms, median plain forward
    ms, peak bytes, profile of the kernel's forward, of the plain one)."""
    import torch
    from openseg3d_tpu_torch.engine import build_segmentor, make_eval_step, make_forward
    from openseg3d_tpu_torch.models import swformer
    from openseg3d_tpu_torch.ops.attention import (window_attention_packed,
                                                   window_attention_packed_plain)
    from openseg3d_tpu_torch.weights import init_weights

    batch, n_voxels = frame_batch(cfg, device)
    print(f'frame: {N_POINTS} points, {n_voxels} voxels '
          f'(capacity {cfg.RUNTIME.MAX_VOXELS_PER_SAMPLE})', flush=True)
    model, spec = build_segmentor(cfg)
    init_weights(model, torch.Generator().manual_seed(0))
    model.to(device).eval()
    eval_step = make_eval_step(cfg, spec, model)
    # the plain attention in place of the kernel, for the reference forward
    plain_core = mock.patch.object(swformer, 'window_attention_packed',
                                   window_attention_packed_plain)

    window_attention_packed.launches = 0
    res = eval_step(batch)
    torch.cuda.synchronize()
    launches = window_attention_packed.launches
    print(f'kernel launches in one eval step: {launches} (config implies '
          f'{expected_launches})', flush=True)
    assert launches == expected_launches, (launches, expected_launches)

    logits = res['point_out']
    assert logits.shape == (1, cfg.RUNTIME.MAX_POINTS_PER_SAMPLE, spec.num_classes)
    assert logits.dtype == torch.float32 and bool(torch.isfinite(logits).all())
    valid = (batch['point_mask'] & batch['cur_point_mask']).reshape(-1)
    assert int(res['hist'].sum()) == int(valid.sum()) == N_POINTS

    with plain_core:
        ref = eval_step(batch)['point_out']
    assert bool(torch.isfinite(ref).all())
    a, b = logits.reshape(-1, spec.num_classes)[valid], ref.reshape(-1, spec.num_classes)[valid]
    agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    print(f'kernel vs plain forward: argmax agreement {agree:.5f}, max abs logit '
          f'diff {float((a - b).abs().max()):.4g}, max abs logit {float(b.abs().max()):.4g}',
          flush=True)
    assert agree >= 0.99, agree

    forward = make_forward(model)
    times, peaks, profiles = {}, {}, {}
    for name, core in (('kernel', window_attention_packed),
                       ('plain', window_attention_packed_plain)):
        with mock.patch.object(swformer, 'window_attention_packed', core):
            forward(batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times[name] = [cuda_ms(lambda: forward(batch), 1) for _ in range(5)]
            peaks[name] = torch.cuda.max_memory_allocated()
        profiles[name] = prof = profile_forward(forward, batch, core)
        print(f'{name} forward ms: {[round(x, 3) for x in times[name]]}, peak '
              f'{peaks[name] / 2**30:.2f} GiB', flush=True)
        print(f'{name} forward under the profiler: {prof}', flush=True)
        assert prof['core_calls'] == expected_launches, prof
        assert prof['core_ms'] > 0 and prof['busy_ms'] > 0, prof
    assert profiles['kernel']['b1_kernels'] == expected_launches, profiles['kernel']
    assert profiles['plain']['b1_kernels'] == 0, profiles['plain']
    return (launches, statistics.median(times['kernel']),
            statistics.median(times['plain']), peaks['kernel'],
            profiles['kernel'], profiles['plain'])


def plain_train_cores():
    """The plain versions patched in for the train path, each inside
    record_function ranges so that a profile can attribute their kernels:
    the attention forward ('b2_plain_fwd'), its autograd backward
    ('b2_plain_bwd') and the 1-NN ('b3_plain'). The plain attention keeps
    only its inputs between forward and backward and recomputes its graph
    in the backward ('b2_plain_recompute'), as the kernel recomputes the
    softmax: the graphs of all 105 layers ([N, H, T, T] float32 weights,
    mask and dropped weights each) would outgrow the card at full capacity."""
    import torch
    from torch.profiler import record_function
    from openseg3d_tpu_torch.models import swformer
    from openseg3d_tpu_torch.ops import knn
    from openseg3d_tpu_torch.ops.attention import window_attention_packed_train_plain

    class PlainAttention(torch.autograd.Function):
        @staticmethod
        def forward(ctx, packed, bias, seed, nw, nhead, rate):
            with record_function('b2_plain_fwd'):
                out = window_attention_packed_train_plain(packed, bias, seed, nw, nhead, rate)
            ctx.save_for_backward(packed, bias, seed, nw)
            ctx.nhead, ctx.rate = nhead, rate
            return out

        @staticmethod
        def backward(ctx, gout):
            packed, bias, seed, nw = ctx.saved_tensors
            with torch.enable_grad():
                x = packed.detach().requires_grad_(True)
                with record_function('b2_plain_recompute'):
                    out = window_attention_packed_train_plain(x, bias, seed, nw, ctx.nhead,
                                                              ctx.rate)
                with record_function('b2_plain_bwd'):
                    (gx,) = torch.autograd.grad(out, x, gout)
            return gx, None, None, None, None, None

    def plain_knn(*args):
        with record_function('b3_plain'):
            return knn.nearest_point_plain(*args)

    return (mock.patch.object(swformer, 'window_attention_packed_train', PlainAttention.apply),
            mock.patch.object(knn, 'nearest_point', plain_knn))


def run_train_slice(cfg, batch, expected_attention):
    """Phase 4b. Returns a dict of the results."""
    import torch
    from openseg3d_tpu_torch.engine import TrainState, build_segmentor, make_train_step
    from openseg3d_tpu_torch.models.optim import build_optimizer, build_schedule
    from openseg3d_tpu_torch.ops.attention import (window_attention_train_backward,
                                                   window_attention_train_forward)
    from openseg3d_tpu_torch.ops.knn import nearest_point
    from openseg3d_tpu_torch.weights import init_weights

    device = batch['points'].device
    model, spec = build_segmentor(cfg)
    init_weights(model, torch.Generator().manual_seed(0))
    model.to(device)
    initial = copy.deepcopy(model.state_dict())
    step = make_train_step(cfg, spec)
    counters = (window_attention_train_forward, window_attention_train_backward, nearest_point)

    def fresh_state():
        model.load_state_dict(initial)
        return TrainState(model, build_optimizer(cfg, model.parameters()),
                          build_schedule(cfg, 30, 1000))

    def grads():
        return {k: p.grad.float().clone() for k, p in model.named_parameters()}

    # the main path: one step from the initial state, launches counted
    state = fresh_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    state, m = step(state, batch, seed=0)
    torch.cuda.synchronize()
    launches = [c.launches for c in counters]
    print(f'train step launches: B2 forward {launches[0]}, B2 backward {launches[1]}, '
          f'B3 {launches[2]} (config implies {expected_attention}, {expected_attention}, 1); '
          f'peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB', flush=True)
    assert launches == [expected_attention, expected_attention, 1], launches
    loss, g_kernel = float(m['loss']), grads()
    assert m['grads_finite'] and torch.isfinite(m['loss']), m
    moved = {k: float((v.float() - initial[k].float()).abs().max())
             for k, v in model.state_dict().items()}
    params_moved = sum(moved[k] > 0 for k, _ in model.named_parameters())
    stats_moved = sum(moved[k] > 0 for k, _ in model.named_buffers())
    n_params, n_stats = len(list(model.parameters())), len(list(model.buffers()))
    print(f'after one step: {params_moved}/{n_params} parameter tensors and {stats_moved}/'
          f'{n_stats} BatchNorm statistics moved; loss {loss:.6g}', flush=True)
    # the first update's learning rate is the warmup's LR x 0.001: on a
    # parameter near 1 (a norm scale) an update below its float32 spacing
    # does not show, so most tensors, not all, must move
    assert 2 * params_moved > n_params and stats_moved == n_stats

    # the same first step through the plain versions
    state = fresh_state()
    attention_patch, knn_patch = plain_train_cores()
    with attention_patch, knn_patch:
        state, pm = step(state, batch, seed=0)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == launches       # plain: nothing launched
    assert pm['grads_finite']
    plain_loss, g_plain = float(pm['loss']), grads()
    num = sum(float((g_kernel[k] - g_plain[k]).square().sum()) for k in g_plain)
    den = sum(float(g_plain[k].square().sum()) for k in g_plain)
    rel = {k: float((g_kernel[k] - g_plain[k]).norm() / g_plain[k].norm().clamp(min=1e-30))
           for k in g_plain}
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:3]
    loss_rel = abs(loss - plain_loss) / abs(plain_loss)
    grad_rel = (num / den) ** 0.5
    print(f'kernel vs plain first step: loss {loss:.6g} vs {plain_loss:.6g} (rel {loss_rel:.3g}); '
          f'gradient rel L2 error {grad_rel:.4g} overall, median leaf '
          f'{statistics.median(rel.values()):.4g}, worst {worst}', flush=True)
    assert loss_rel <= 0.02 and grad_rel <= 0.1, (loss_rel, grad_rel)

    # timing: kernel path, one warm-up step then 5 timed ones
    state = fresh_state()
    state, _ = step(state, batch, seed=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = [cuda_ms(lambda i=i: step(state, batch, seed=i), 1) for i in range(2, 7)]
    peak = torch.cuda.max_memory_allocated()
    print(f'train step ms: {[round(x, 3) for x in times]}, peak {peak / 2**30:.2f} GiB',
          flush=True)
    plain_times = []
    with attention_patch, knn_patch:
        plain_times = [cuda_ms(lambda i=i: step(state, batch, seed=i), 1) for i in range(7, 9)]
    print(f'train step ms through the plain versions: {[round(x, 3) for x in plain_times]}',
          flush=True)

    # one profiled step of each
    events, wall = trace(lambda: step(state, batch, seed=9))
    prof = dict(wall_ms=wall, busy_ms=busy_ms(events),
                b2f=named_kernels(events, 'window_attention_train_fwd_kernel'),
                b2b=tuple(map(sum, zip(named_kernels(events, 'window_attention_train_dq_kernel'),
                                       named_kernels(events, 'window_attention_train_dkdv_kernel')))),
                b3=named_kernels(events, 'nearest_point_kernel'))
    print('kernel step, kernels with the most device time (name, ms, count):', flush=True)
    for row in top_kernels(events):
        print(f'  {row}', flush=True)
    with attention_patch, knn_patch:
        events, wall = trace(lambda: step(state, batch, seed=10))
    ranges = {k: range_kernels(events, name) for k, name in
              (('b2f', 'b2_plain_fwd'), ('b2b', 'b2_plain_bwd'), ('b3', 'b3_plain'))}
    plain_prof = dict(wall_ms=wall, busy_ms=busy_ms(events),
                      **{k: (ms, n) for k, (_, ms, n) in ranges.items()})
    print(f'kernel step under the profiler (ms, kernels): {prof}', flush=True)
    print(f'plain step under the profiler (ms, kernels): {plain_prof}', flush=True)
    assert prof['b2f'][1] == expected_attention and prof['b3'][1] == 1, prof
    assert prof['b2b'][1] == 2 * expected_attention, prof           # dq + dk/dv passes
    assert [ranges[k][0] for k in ('b2f', 'b2b', 'b3')] == \
        [expected_attention, expected_attention, 1], ranges
    return dict(launches=launches, loss=loss, plain_loss=plain_loss, loss_rel=loss_rel,
                grad_rel=grad_rel, step_ms=statistics.median(times),
                plain_step_ms=statistics.median(plain_times), peak=peak, prof=prof,
                plain_prof=plain_prof)


def check_small_reference(device):
    """Phase 5: the tiny float32 model on the GPU against the CPU."""
    import numpy as np
    import torch
    from openseg3d_tpu_torch.config import cfg_from_file
    from openseg3d_tpu_torch.core.voxelizer import VoxelGenerator
    from openseg3d_tpu_torch.data.batch import collate_padded, pad_sample, to_device
    from openseg3d_tpu_torch.engine import build_segmentor
    from openseg3d_tpu_torch.ops.attention import window_attention_packed
    from openseg3d_tpu_torch.weights import init_weights

    cfg = cfg_from_file(None, overrides=TINY_OVERRIDES)
    rng = np.random.RandomState(1)
    vg = VoxelGenerator(cfg.DATASET.VOXEL_SIZE, cfg.DATASET.POINT_CLOUD_RANGE)
    samples = []
    for _ in range(2):
        pts = np.concatenate([rng.uniform(-3, 3, (600, 3)) * [1, 1, 0.25],
                              rng.randn(600, 3)], 1).astype(np.float32)
        coords, ids = vg.generate(pts)
        samples.append(dict(points=pts, voxel_coords=coords, point_voxel_ids=ids))
    nb = collate_padded([pad_sample(s, 1024, 512) for s in samples])
    model, _ = build_segmentor(cfg)
    init_weights(model, torch.Generator().manual_seed(1))
    model.eval()
    with torch.inference_mode():
        want = model(to_device(nb, 'cpu'))['point_out']
        before = window_attention_packed.launches
        got = model.to(device)(to_device(nb, device))['point_out'].cpu()
    assert window_attention_packed.launches > before
    err = float((got - want).abs().max())
    print(f'small reference (GPU vs CPU, float32): max abs diff {err:.3g}, '
          f'max abs logit {float(want.abs().max()):.3g}', flush=True)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def check_small_train_reference(device):
    """Phase 5, train: one tiny float32 train step on the GPU (the train
    kernels) against the same step on the CPU (the plain versions): same
    weights, batch and seed, dropout rates 0."""
    import numpy as np
    import torch
    from openseg3d_tpu_torch.config import cfg_from_file
    from openseg3d_tpu_torch.core.voxelizer import VoxelGenerator, majority_voxel_labels
    from openseg3d_tpu_torch.data.batch import collate_padded, pad_sample, to_device
    from openseg3d_tpu_torch.engine import TrainState, build_segmentor, make_train_step
    from openseg3d_tpu_torch.models.optim import build_optimizer, build_schedule
    from openseg3d_tpu_torch.models.segmentors.common import SegmentorHead
    from openseg3d_tpu_torch.models.swformer import WindowAttention
    from openseg3d_tpu_torch.ops.attention import window_attention_train_backward
    from openseg3d_tpu_torch.weights import init_weights

    overrides = copy.deepcopy(TINY_OVERRIDES)
    overrides['MODEL']['DROP_PATH_RATE'] = 0.0
    overrides['TRAIN'] = {'OPTIMIZER': 'sgd', 'LR': 50.0, 'MOMENTUM': 0.9, 'WEIGHT_DECAY': 1e-4}
    cfg = cfg_from_file(None, overrides=overrides)
    rng = np.random.RandomState(2)
    vg = VoxelGenerator(cfg.DATASET.VOXEL_SIZE, cfg.DATASET.POINT_CLOUD_RANGE)
    samples = []
    for _ in range(2):
        pts = np.concatenate([rng.uniform(-3, 3, (600, 3)) * [1, 1, 0.25],
                              rng.randn(600, 3)], 1).astype(np.float32)
        coords, ids = vg.generate(pts)
        labels = rng.randint(0, cfg.DATASET.NUM_CLASSES, 600)
        samples.append(dict(points=pts, voxel_coords=coords, point_voxel_ids=ids,
                            point_labels=labels,
                            voxel_labels=majority_voxel_labels(ids, labels, coords.shape[0])))
    nb = collate_padded([pad_sample(s, 1024, 512) for s in samples])

    results = {}
    for dev in ('cpu', device):
        model, spec = build_segmentor(cfg)
        init_weights(model, torch.Generator().manual_seed(3))
        for mod in model.modules():
            if isinstance(mod, WindowAttention):
                mod.attn_drop = 0.0
            elif isinstance(mod, SegmentorHead):
                mod.drop = 0.0
        model.to(dev)
        state = TrainState(model, build_optimizer(cfg, model.parameters()),
                           build_schedule(cfg, 1, 10))
        before = window_attention_train_backward.launches
        state, m = make_train_step(cfg, spec)(state, to_device(nb, dev), seed=0)
        assert m['grads_finite']
        launched = window_attention_train_backward.launches - before
        assert (launched > 0) == (dev != 'cpu'), (dev, launched)
        results[dev] = (float(m['loss']), {k: p.grad.cpu() for k, p in model.named_parameters()},
                        {k: v.cpu() for k, v in model.state_dict().items()})
    (lc, gc, sc), (lg, gg, sg) = results['cpu'], results[device]

    def scaled_err(got, want):
        """max |got - want| over 1 + the leaf's largest |want|."""
        return float((got - want).abs().max()) / (1.0 + float(want.abs().max()))

    # per leaf, not per element: with random weights a gradient leaf is a
    # sum over thousands of rows with cancellation (the first attention
    # layer's out_proj.bias: largest magnitude ~160, and 1e-7 relative noise
    # on the weights moves it by ~6e-3 on the CPU alone), so float32
    # summation order sets its error on the scale of its largest element
    g_err = max((scaled_err(gg[k], gc[k]), k) for k in gc)
    s_err = max((scaled_err(sg[k].float(), sc[k].float()), k) for k in sc)
    print(f'small train reference (GPU vs CPU, float32): loss {lg:.6g} vs {lc:.6g}; worst '
          f'gradient leaf {g_err[1]}: max abs diff / (1 + max abs) {g_err[0]:.3g}; worst '
          f'parameter or statistic after the step {s_err[1]}: {s_err[0]:.3g}', flush=True)
    np.testing.assert_allclose(lg, lc, rtol=1e-4, atol=1e-4)
    assert g_err[0] <= 1e-4 and s_err[0] <= 1e-4, (g_err, s_err)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this test runs only on a GPU', file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from openseg3d_tpu_torch.config import cfg_from_file
    from openseg3d_tpu_torch.models.backbones.point_transformer import (CHANNELS,
                                                                        stage_level_specs)
    from openseg3d_tpu_torch.models.segmentors.common import ModelSpec
    from openseg3d_tpu_torch.ops import _build

    # 1. device
    device = torch.device('cuda:0')
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader', '--id=0'],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f'torch {torch.__version__} (CUDA {torch.version.cuda}), device: {kind}')
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build, every source at once
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f'built {len(built)} kernel libraries in {time.perf_counter() - t0:.1f} s')
    for name, (path, seconds, log) in built.items():
        print(f'  {path.relative_to(REPO)}')
        for line in log.splitlines():
            if 'spill' in line and ' 0 bytes spill stores' not in line:
                print('    ptxas:', line.strip())

    # 3. kernel vs plain at the main path's shapes
    cfg = cfg_from_file(os.path.join(REPO, 'configs', 'waymo_one_sweep.yaml'))
    spec = ModelSpec.from_config(cfg)
    levels = stage_level_specs(spec)
    t0 = time.perf_counter()
    k_ms, p_ms, err32 = check_kernel(spec, levels, CHANNELS, spec.depths)
    print(f'kernel check: {time.perf_counter() - t0:.1f} s; sum over shapes of depth x '
          f'one call at capacity (bf16): kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms',
          flush=True)

    # 3b. train kernels vs plain at the same shapes
    t0 = time.perf_counter()
    fwd_err32, grad_err32 = check_train_kernels(levels, CHANNELS)
    print(f'train kernel check: {time.perf_counter() - t0:.1f} s; max float32 error forward '
          f'{fwd_err32:.3g}, gradient {grad_err32:.3g}', flush=True)

    # 3c. 1-NN vs plain on the frame's voxel centres
    batch, _ = frame_batch(cfg, device)
    knn_q, knn_p, knn_ms, knn_plain_ms = check_nearest_point(cfg, spec, batch)

    # 4. the eval slice
    expected = sum(d * len(lv) for d, lv in zip(spec.depths, levels))
    launches, step_ms, plain_step_ms, peak, prof, plain_prof = run_slice(
        cfg, device, expected)
    print(f'slice: median forward {step_ms:.2f} ms ({N_POINTS / step_ms / 1e3:.3f} '
          f'Mpoints/s), plain attention {plain_step_ms:.2f} ms, peak memory '
          f'{peak / 2**30:.2f} GiB, on {smi}', flush=True)
    for name, p, med in (('kernel', prof, step_ms), ('plain', plain_prof, plain_step_ms)):
        print(f'{name} forward, profiled: attention core {p["core_ms"]:.3f} ms of '
              f'device time; device busy {p["busy_ms"]:.3f} ms = '
              f'{p["busy_ms"] / p["wall_ms"]:.3f} of its {p["wall_ms"]:.3f} ms wall time '
              f'(and {p["busy_ms"] / med:.3f} of the unprofiled median)', flush=True)

    # 4b. the train slice
    tr = run_train_slice(cfg, batch, expected)
    print(f'train slice: median step {tr["step_ms"]:.2f} ms '
          f'({N_POINTS / tr["step_ms"] / 1e3:.3f} Mpoints/s), through the plain versions '
          f'{tr["plain_step_ms"]:.2f} ms, peak memory {tr["peak"] / 2**30:.2f} GiB, on {smi}',
          flush=True)
    for name, p, med in (('kernel', tr['prof'], tr['step_ms']),
                         ('plain', tr['plain_prof'], tr['plain_step_ms'])):
        print(f'{name} train step, profiled: B2 forward {p["b2f"][0]:.3f} ms, B2 backward '
              f'{p["b2b"][0]:.3f} ms, B3 {p["b3"][0]:.3f} ms of device time; device busy '
              f'{p["busy_ms"]:.3f} ms = {p["busy_ms"] / p["wall_ms"]:.3f} of its '
              f'{p["wall_ms"]:.3f} ms wall time (and {p["busy_ms"] / med:.3f} of the '
              f'unprofiled median)', flush=True)

    # 5. small references against the CPU path
    check_small_reference(device)
    check_small_train_reference(device)

    kp, pp = tr['prof'], tr['plain_prof']
    print(json.dumps({'kernels': [{
        'name': 'window_attention_packed',
        'route': 'cuda',
        'source': 'openseg3d_tpu_torch/csrc/window_attention.cu',
        'replaces': 'openseg3d_tpu/ops/attention.py:317',
        'launches': launches,
        'max_abs_err': err32,
        'ms': prof['b1_ms'],
        'plain_ms': plain_prof['core_ms'],
    }, {
        'name': 'window_attention_train_forward',
        'route': 'cuda',
        'source': 'openseg3d_tpu_torch/csrc/window_attention_train.cu',
        'replaces': 'openseg3d_tpu/ops/attention.py:673',
        'launches': tr['launches'][0],
        'max_abs_err': fwd_err32,
        'ms': kp['b2f'][0],
        'plain_ms': pp['b2f'][0],
    }, {
        'name': 'window_attention_train_backward',
        'route': 'cuda',
        'source': 'openseg3d_tpu_torch/csrc/window_attention_train.cu',
        'replaces': 'openseg3d_tpu/ops/attention.py:683',
        'launches': tr['launches'][1],
        'max_abs_err': grad_err32,
        'ms': kp['b2b'][0],
        'plain_ms': pp['b2b'][0],
    }, {
        'name': 'nearest_point',
        'route': 'cuda',
        'source': 'openseg3d_tpu_torch/csrc/nearest_point.cu',
        'replaces': 'openseg3d_tpu/ops/knn.py:223',
        'launches': tr['launches'][2],
        'max_abs_err': 0.0,
        'ms': kp['b3'][0],
        'plain_ms': pp['b3'][0],
    }]}))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases (each asserts or raises; nothing is caught):
  1. device: the card's name and power limit; TF32 off for float32 matmuls
     and convolutions, so float32 comparisons are float32;
  1b. host voxelizer: the C++ voxelizer (openseg3d_tpu_torch/native, g++
     at first use) must build and be VoxelGenerator's path here; the bench
     frame and the 3-sweep frame, voxelized on it, must have the batch
     digests stored in the reference files (written on another host: the
     same ids and coords to the bit); its host ms on the bench cloud beside
     the numpy path's;
  2. build: compiles every kernel source of openseg3d_tpu_torch/csrc/ with
     nvcc for sm_90a, one nvcc process each, all started together; prints
     each kernel's registers and spills (ptxas); the bf16 tensor-core
     kernels (*_mma_kernel, 22: the eval kernel's and the train forward's 5
     (head width, key tile) pairs each, the one-pass backward's 4 and the
     two-pass backward's 2 x 4; and the sparse conv's gather-GEMM and weight
     gradient in every tile and unaligned) must not spill;
  3. kernel vs plain: the eval window-attention kernel (B1) against its plain
     PyTorch version at every (T, C) the default config's window levels give
     the 4 stages, in float32 (max abs error <= 1e-5) and bfloat16 (within
     train_forward_bound at rate 0, 2^-7 |plain| + 2^-8 max|v|: the
     tensor-core kernel rounds the softmax weights to bf16, as the TPU kernel
     does), with a fully padded window (zero) and a true window count below
     the capacity (zeros past it); bfloat16 in every block shape the
     kernel takes there (ops/attention.eval_launch_shapes: 16-, 32- and
     64-row blocks); then per shape in bf16 the device time of B1 in each
     block shape (the table's, ops/attention.eval_rows, marked), of SDPA on
     the live windows and of the plain version, and the bound, and the sums
     over shapes in the table's shape and in the 16-row block;
  3b. train kernels vs plain: the train attention forward (B2f) and backward
     (B2b) against the plain version and its autograd gradient at the same
     (T, C), float32 and bfloat16, drop rate 0 and 0.1 (the same hash mask on
     both sides), for a random cotangent that is zero past nw: forward
     float32 within 1e-5 of the largest output, bfloat16 within
     train_forward_bound (2^-7 |plain| + 2^-8 / (1 - p) max|v|: the kernel
     rounds the softmax weights to bf16, as the TPU kernel does); dq, dk and
     dv each within 1e-4 (float32) or 4 bf16 ulps (bfloat16) of their
     largest magnitude; windows past nw zero, gradients finite; in bf16 at
     rate 0.1 also: the keep bits B2f stores, in each block shape (16 and,
     above head_dim 6, 64 query rows), equal pack_keep_bits of the plain
     mask on the live
     windows bit for bit, and B2b in both paths (one pass where T allows
     it, two passes) within the bound and bit-equal over two calls; then
     per shape in bf16: B2f and B2b at rate 0 (the tables' choice) and at
     0.1 in each block shape and path, the chosen one marked, SDPA with
     dropout 0.1, SDPA's backward (live windows), both bounds, the stored
     bits' bytes, and the plain version;
  3c. 1-NN vs plain: the B3 kernels (a search over point splits, then a
     combine of the partials) against their plain version on the real
     frame's voxel centres (the stage-4 aux centres against the
     full-resolution ones, the train step's label transfer), on random
     points and on the split search's edge cases (tests/test_torch_cuda.py:
     ties straddling every split boundary, P and Q off the split and tile
     sizes, an all-invalid sample, B = 2 with different valid counts):
     indices equal; one search and one combine kernel per call, by name
     under the profiler; B3's device ms beside its bound, the issue floor of
     its _rn arithmetic, cdist + argmin and the plain version;
  3d. unpacked attention vs plain: the B4 kernel (fused_window_attention,
     q, k and v as three arrays, every window computed) against its plain
     version at the same 23 (T, C) plus the JAX test's (800, 384), N the
     level's window capacity rounded to attention_group, in float32 (max abs
     error <= 1e-5 x max(1, largest output)) and bfloat16 (train_forward_bound
     at rate 0), fully padded windows held to the mean of their own v rows
     (the JAX oracle's result), in bfloat16 in every block shape as in 3;
     then B4's own path: one bf16 call of the public op per shape with its
     counter set to 0 before and read after; per shape the device time of
     the kernel in each block shape, of the plain version and of scaled_dot_product_attention, and
     the bound;
  4. eval slice: the full-width, full-capacity bfloat16 Segformer eval step
     (configs/waymo_one_sweep.yaml, seeded random weights) on one bench.py
     frame; checks the kernel's launch count against the config, finite
     logits, the histogram's count, and >= 99% argmax agreement with the same
     forward through the plain attention; times 5 forwards of each; then
     profiles one forward of each with torch.profiler: the kernel's device
     time on the main path, the plain attention's, and the device-busy share
     of that forward's wall time; the bf16 forward launches the tensor-core
     eval kernel (window_attention_mma_kernel) once per attention call and
     the FMA body (window_attention_kernel) never; then B1 on the frame's
     captured inputs per level (the first call of each level shape; its live
     windows printed), in the table's block shape and in the 16-row block,
     summed over the levels' calls beside the profiled B1 ms; the same on
     tools.eval's inputs (its first synthetic frame alone, and that frame's
     first TTA group of 2 variants at the default --tta_batch 2);
  4b. train slice: the full-width, full-capacity bfloat16 train step (the
     config's SGD with momentum and weight decay, warmup-poly schedule,
     OHEM-CE + Lovasz losses on point, voxel and 0.4x aux logits, attention
     dropout 0.1, drop path, head dropout) on the same frame; checks the
     launches of one step (B2f and B2b once per attention level and layer,
     B3 once) and its gather-only backwards (one per sparse conv, two per
     encoder layer for permute_rows), a finite loss, finite gradients,
     moved parameters and BatchNorm statistics; prints the keep bits'
     bytes a step and the step's peak memory; under the profiler the bf16
     step runs B2f and B2b as the tensor-core kernels (B2b's one-pass kernel
     and two-pass kernels as ops/attention's table chooses them by T), never
     the float32 FMA bodies, and at most one bf16 index_add_ (the devoxelize gather's
     backward); takes the same first step through the plain versions and
     compares loss and gradients; takes it once more and prints whether the
     gradients are bit-equal (no --deterministic); times 1 + 5 steps, with
     the peak memory; profiles one step of each; then one sparse conv of
     each kind (subm, strided, inverse) at full size: its float32 dW (the
     weight-gradient kernel) from bf16 inputs within 1e-5 of a float32
     product of the same inputs;
  4c. sparse-conv kernels: every conv of a bf16 Segformer and SPNet eval
     forward on the bench frame, recorded as it ran: the gather-GEMM (S1)
     forward and dx and the weight-gradient kernel (S2) in the tables'
     tiles, each conv's forward and dx within 2**-6 of the plain path's
     largest output and its dW within 1e-5 of max|dW| of a float32 product
     of the same inputs, device ms (CUDA events) beside the least time of
     each (benchmark/counts.conv_work, grad_work) and the plain path's ms,
     and the share of (tile, offset) pairs and of 32-row dW steps with a
     live pair (from the rulebook by torch ops); then every tile of each
     kernel at every width, the fastest marked beside the table's
     (ops/sparse_conv.GEMM_TABLE and GRAD_TABLE come from here). Every phase
     that counts launches counts S1 and S2 too: one S1 a conv in an eval
     forward, two S1 and one S2 a conv in a train step;
  5. small reference: a tiny float32 model on the GPU against the same model
     on the CPU (whose path tests/test_torch_segformer.py and
     tests/test_torch_train.py hold against the JAX package): the eval
     forward, abs/rel 1e-4; one train step with the dropout rates at 0 (the
     CPU's and the GPU's generators give different bits for one seed): the
     loss abs/rel 1e-4, every gradient, parameter and BatchNorm statistic
     within 1e-4 x (1 + the leaf's largest magnitude).
  6. yardsticks: for every kernel of the JSON line, the device time (the
     call's kernels under the profiler, host gaps not counted) of one PyTorch
     call that computes the same function on the main path's inputs
     (scaled_dot_product_attention with the bias as attn_mask for B1, B2f
     (dropout 0.1) and B4, its backward at dropout 0 for B2b, a
     query-chunked torch.cdist + argmin for B3; the port never calls them),
     and the least time the card could take: the larger of the bytes moved
     (each input read once, each output written once, live windows only)
     over 3.35 TB/s and the flops over 989 TFLOP/s (bf16 attention) or 67
     TFLOP/s (float32 1-NN distances);
  7. the command-line tools on the card, in-process through main([...]) in a
     temporary directory: (a) tools.train on configs/synthetic_accuracy.yaml
     (full width and capacity, bf16), 32 synthetic frames, batch 1, 4
     epochs = 128 steps, validation every 2 epochs: a finite loss, the last
     epoch's mean logged loss below the first's, final validation mIoU >=
     0.15 (chance is 1/22), every kernel of the train and eval paths
     launched; (b) resume on configs/synthetic_smoke.yaml: train 2 epochs,
     delete epoch_2.pt, resume with --auto_resume, both with --deterministic
     (without it the atomics of the devoxelize gather's index_add_
     backward reorder sums, and the Adam moments of leaves whose true
     gradient is zero, conv biases ahead of BatchNorm, hold only that
     rounding noise): the new epoch_2.pt has the
     same step and update counts and parameters and optimizer state within
     1e-6 of the first (relative to each tensor's largest magnitude); (c)
     2 train steps through WaymoDataset on a tree in
     the offline parser's format (data/synthetic.make_tree), instance paste
     and PolarMix on; (d) tools.eval on (a)'s checkpoints, without TTA on 4
     frames, with the 36-variant host TTA on 1 frame and with --tta_device
     (--tta_batch 1) on 1 frame: finite mIoUs, B1 launched 36 x 105 times
     by the device TTA.
  A. full capacity against the JAX package: for each reference file of
     openseg3d_tpu_torch/parity_data/ (written by the JAX package's own eval
     step on a CPU: configs/waymo_one_sweep.yaml, waymo_multi_sweeps.yaml,
     waymo_one_sweep.yaml with SPNet, and waymo_one_sweep.yaml with image
     features (DeepFusion, synthetic features); seeded numpy weights; the
     bench frame or a 3-sweep frame), the port's eval step with the loss on the
     card in float32 (B1's FMA body) and in bfloat16, held to
     parity.compare_with_reference's gates: float32 sampled logits within
     1e-3 x max(1, max|logit|), argmax agreement >= 99.9%, the histogram
     within twice the disagreeing points, the loss within 1e-3; bfloat16
     agreement no lower than JAX bf16's own minus 0.5 points and sampled
     logits within twice JAX bf16's own error; the aux coords and mask
     equal. Prints the measured numbers. Then the train reference
     (waymo_one_sweep_train: the JAX package's float32 train step at full
     capacity on the bench frame, dropout and drop path off, its aux labels
     stored): the port's float32 step (B2f and B2b's FMA bodies) on the
     stored aux labels, held to parity.compare_with_train_reference: the
     loss within 1e-4 relative, each gradient leaf's sampled values and L2
     norm within (1e-4 + 2 x JAX's own movement under 1e-7 relative weight
     noise) x (1 + its largest magnitude), the BatchNorm statistics within
     1e-4 x (1 + their largest); prints the worst leaf and those past half
     their gate;
  C. configs/waymo_multi_sweeps.yaml on the 3-sweep reference frame
     (180222 points, 60074 current) and configs/waymo_one_sweep_cylinder.yaml
     on the bench frame in (rho, phi, z, x, y, features): the bf16 eval step
     and one train step at full width and capacity, finite, with B1, B2f,
     B2b and B3 launched as the config implies and one gather-only backward
     per sparse conv; multi-sweep: forward and step ms, peak memory,
     device-busy share; then tools/repro_nan_dw.py's degenerate cylinder
     cloud through 5 full-scale bf16 train steps: each step's non-finite
     gradient leaves and whether the guard skipped it, printed, not gated;
  D. SPNet (configs/waymo_one_sweep.yaml, MODEL.SEGMENTOR spnet) on the
     bench frame: bf16 eval step and train step, finite, 1 B3 launch and 43
     gather-only conv backwards a step, at most one bf16 index_add_, times,
     peak and busy share; then tools.train on
     configs/synthetic_accuracy_spnet.yaml as 7a: a falling loss, validation
     mIoU >= 0.15;
  E. device TTA (tools/eval.tta_device_group) on the bench frame, bf16,
     full width and capacity: each of the 36 variants' device_voxelize on
     the card bit-equal to its plain CPU run on the same transformed points;
     the points whose voxel differs from the host path, at most
     TTA_VOXEL_DIFFER a variant; one frame
     of device TTA (--tta_batch 1) against one frame of host TTA: seconds
     each, B1 launched 36 x 105 times, argmax agreement >= TTA_AGREEMENT;
  F. DeepFusion (configs/waymo_one_sweep.yaml with DATASET.USE_IMAGE_FEATURE,
     the bench frame with synthetic image features): the Segformer's bf16
     eval step and train step as in C (launch counts, forward and step ms,
     peak, busy share), with exactly two bf16 index_add_ in the step (the
     devoxelize gather's backward and DeepFusion's neighbour gather's); the
     share of points whose candidate shell yields fewer than 8 and 16
     neighbours by range band; SPNet with image features: an eval step and
     a train step, finite, with launch counts;
  B. the rehearsal through python -m openseg3d_tpu_torch.tools.rehearsal
     (--frames 2, bench-size frames, on a tree in the offline parser's
     format with a test-set frame list, data/synthetic.make_tree): train 2
     steps, eval, then tools.test under the stand-in protos
     (OPENSEG3D_ALLOW_WOD_STUB=1), each tool in its own process; the decoded submission holds each frame's
     eval-forward argmax over its current points, scattered through
     points_ri; then the same on a tree with synthetic image_feature/ files
     and DATASET.USE_IMAGE_FEATURE, whose checkpoint holds DeepFusion's
     tensors; there also 2 epochs with --deterministic and the
     augmentation off, and epoch 2 again from epoch_1.pt must give
     epoch_2.pt as before (as 7b);
  G. data-parallel training (parallel/dist.py) and the last modules:
     G1 two spawned ranks on cuda:0 over gloo (the only place where ranks
     share a card) against one process taking their two frames at B = 2:
     (a) float32, full width, DP_POINTS points a frame with the caps cut to
     match, no dropout: loss within DP_TOL relative, the state after one
     step within DP_TOL of (1 + each leaf's max), both ranks bit-equal; a
     float64 witness of the same step on the host's cores (dp_float64): one
     process and two gloo ranks within DP_FLOAT64_TOL of each other; each
     gradient leaf within DP_TOL plus the one-process float32 leaf's own
     distance from the float64 one (of (1 + the leaf's max)); over the tree
     within DP_NOISE_FACTOR x the one-process step with its frames swapped;
     (b) bf16 at full capacity: loss within DP_BF16_LOSS_RTOL of
     the one-process step, 105 B2f, 105 B2b and 1 B3 launches and 20 conv
     and 36 permute_rows backwards a rank, median step, peak and the
     all-reduce's device and host ms under the profiler (an upper bound:
     shared card, gloo through the host); G2 torchrun --nproc_per_node 1
     of tools.train --launcher pytorch (NCCL): rc 0, process 0/1, one
     epoch_1.pt, a finite mIoU; G3 Dice and focal in a full-size bf16 step,
     then the last modules on the card against their CPU run (losses,
     SparseBasicBlock with_sa, MaskedLayerNorm, the window helpers,
     query_and_group, interpolation, FPS and sectorized FPS of FPS_SAMPLES
     on the bench frame's voxel centres).
  H. the measuring entry points, in-process through main([...]): the bench
     (openseg3d_tpu_torch.bench, BENCH_ITERS steps after the first, at its
     own defaults: 163840 points, --max_voxels 98304) for Segformer infer,
     train_fwd and train, SPNet train and Segformer with image features
     infer: one finite JSON line each, and the launches each wrapper counted
     equal to the run's launches a step (BENCH_RUNS) times its calls, as the
     line's launches_per_step says too; tools.profile_step --mode train
     --steps 2 --by_module: B2f, B2b and B3 under their kernel names with
     their launches a step (PROFILED_KERNELS), the attention and knn buckets,
     the by-module table's ranges and backward nodes; measure_capacities on
     2 bench frames on the card, each stage's voxel count equal to
     verify_capacities' numpy count on the same frames; verify_capacities
     at the default RUNTIME on the 4 bench frames: zero drops.
The run's seconds in all come before the kernels' JSON summary, the line
before the last; the last line is {"ok": true, "device": {...}}. Without a
CUDA device the script exits 1.
Every time printed comes with the card's name and power limit.
"""

from __future__ import annotations

import copy
import functools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

# the port must not need JAX, the JAX package or its benchmark script: make
# any import of them fail
for _name in ('jax', 'jaxlib', 'flax', 'optax', 'openseg3d_tpu', 'bench'):
    sys.modules[_name] = None

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
from openseg3d_tpu_torch.utils.profiling import (busy_ms, kernel_name,  # noqa: E402
                                                 named_kernels, range_kernels, top_kernels,
                                                 trace)
N_POINTS = 163840            # one bench.py frame
IMAGE_FEATURES = {'USE_IMAGE_FEATURE': True, 'DIM_IMAGE_FEATURE': 28}
# device TTA against host TTA (phase E): argmax agreement over the frame,
# and the points of one variant whose voxel may differ from the host path's
# (float32 rotation against the host's float64 moves boundary points; a
# wrong flip, scale or angle moves nearly all of them)
TTA_AGREEMENT = 0.99
TTA_VOXEL_DIFFER = 50
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


def device_ms(fn, iters: int = 5) -> float:
    """Device milliseconds of one fn() call: the durations of the kernels,
    copies and memsets it launches (torch.profiler), summed over `iters`
    calls and divided by them. Unlike cuda_ms, host time between launches
    is not counted: a call whose host side (autograd's backward, say)
    outlasts its kernels is timed by its kernels. One call is traced first
    to count its device events; a trace of the `iters` calls is taken only
    if it holds exactly `iters` times that count (the profiler sometimes
    delivers part of a short run), else both are taken again; after three
    such tries the call is timed by CUDA events instead (cuda_ms), and a line
    says so."""
    import torch

    def device_events(calls):
        torch.cuda.synchronize()
        events, _ = trace(lambda: [fn() for _ in range(calls)])
        return [e['dur'] for e in events
                if e.get('cat') in ('kernel', 'gpu_memcpy', 'gpu_memset')]

    fn()
    for _ in range(3):
        per_call = len(device_events(1))
        durs = device_events(iters)
        if per_call and len(durs) == iters * per_call:
            return sum(durs) / 1e3 / iters
    ms = cuda_ms(fn, iters)
    print(f'  (three traces held no whole calls: {ms:.4f} ms by CUDA events)', flush=True)
    return ms


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




def ptxas_usage(log: str):
    """[(kernel<template args>, registers, spill store bytes, spill load
    bytes)] of every entry function in nvcc's -Xptxas -v output."""
    import re
    rows, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = kernel_name(m.group(1))
            continue
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads', line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r'Used (\d+) registers', line)
        if m and name is not None:
            rows.append((name, int(m.group(1)), *spills))
            name, spills = None, (0, 0)
    return rows


def check_launch_shapes(fn, want, lim, t, hd, where, extra_check=None):
    """The bf16 eval kernel's launch fn(rows=rows) (the private _launch_cuda
    or _launch_unpacked, which force a block shape) in every block shape at
    T and head_dim hd (eval_launch_shapes: 16, 32 or 64 query rows): within
    lim of the plain output `want`, extra_check(out) where given. Returns
    ({rows: device ms a call}, worst err / bound)."""
    import torch
    from openseg3d_tpu_torch.ops.attention import eval_launch_shapes
    times, worst = {}, 0.0
    for rows in eval_launch_shapes(t, hd, 8):
        call = functools.partial(fn, rows=rows)
        got = call()
        torch.cuda.synchronize()
        err = (got.float() - want).abs()
        assert bool((err <= lim).all()), (where, rows, float(err.max()))
        worst = max(worst, float((err / lim.clamp(min=1e-30)).max()))
        if extra_check is not None:
            extra_check(got, (where, rows))
        times[rows] = device_ms(call, 10)
    return times, worst


def shape_times(times, choice):
    """'16 0.0375  32 0.0341*  ...': device ms a call in blocks of each
    query row count, the table's marked *."""
    return '  '.join(f'{r} {ms:.4f}' + '*' * (r == choice) for r, ms in times.items())


def check_kernel(levels, channels, depths):
    """Phase 3. Returns (kernel ms, the 16-row block's ms, plain ms, max
    float32 error); the times are bf16 device times summed over shapes,
    depth x the time of one call at the level's window capacity, the kernel
    in the table's block shape. At every shape: float32 within 1e-5; in
    bf16 every block shape (check_launch_shapes) within the bound, windows
    past nw and the fully padded window zero. Prints per shape every block
    shape's device ms, SDPA's (live windows), the plain version's and the
    bound."""
    import torch
    from openseg3d_tpu_torch.ops.attention import (_launch_cuda, eval_rows,
                                                   train_forward_bound,
                                                   window_attention_packed,
                                                   window_attention_packed_plain)
    gen = torch.Generator(device='cuda').manual_seed(0)
    fwd_ms = fwd16_ms = fwd_plain_ms = 0.0
    max_err32, rows = 0.0, []
    print('stage   T    C     W    nw  err_f32   err_bf16/bound (worst block shape)')
    for s, stage_levels in enumerate(levels):
        c = channels[s]
        for lv in stage_levels:
            t, n = lv.max_tokens, lv.num_windows
            nw = max(1, n - max(1, n // 4))
            packed, bias, nwt = attention_case(gen, n, t, c, nw, torch.float32)
            got = window_attention_packed(packed, bias, 8, nwt).float()
            want = window_attention_packed_plain(packed, bias, 8, nwt).float()
            torch.cuda.synchronize()
            err32 = float((got - want).abs().max())
            assert err32 <= 1e-5, (s, t, c, err32)
            assert not got[nw:].any() and (n <= 2 or not got[1].any()), (s, t, c)

            def zeros(out, where):
                assert not out[nw:].any(), where                     # windows past nw
                assert n <= 2 or not out[1].any(), where             # fully padded: v = 0

            # bf16, the production dtype: every block shape, SDPA on the live windows
            packed, bias, nwt = attention_case(gen, n, t, c, nw, torch.bfloat16)
            want = window_attention_packed_plain(packed, bias, 8, nwt).float()
            lim = train_forward_bound(want, packed, 8, 0.0)
            times, rel = check_launch_shapes(
                functools.partial(_launch_cuda, packed, bias, 8, nwt), want, lim,
                t, c // 8, (s + 1, t, c), zeros)
            choice = eval_rows(t, c // 8)
            pms = device_ms(functools.partial(window_attention_packed_plain, packed, bias, 8,
                                              nwt), 3)
            q, k, v = (y.contiguous() for y in packed[:nw].split(c, dim=-1))
            lms = sdpa_ms(q, k, v, bias[:nw], iters=10)
            bms, _ = attention_bound(nw, t, c, 2)
            rows.append((s + 1, t, c, nw, shape_times(times, choice), lms, bms, pms))
            max_err32 = max(max_err32, err32)
            fwd_ms += depths[s] * times[choice]
            fwd16_ms += depths[s] * times[16]
            fwd_plain_ms += depths[s] * pms
            print(f'{s + 1:5d} {t:4d} {c:4d} {n:5d} {nw:5d}  {err32:.2e}  {rel:.3f}', flush=True)
    print('B1 per shape, bf16 (device ms per call at the window capacity, in blocks of each '
          'query row count, * the table\'s; SDPA and the bound on the live windows): '
          'B1, SDPA, bound, plain')
    for row in rows:
        print('  st {} T {:4d} C {:4d} nw {:5d}: B1 {}  SDPA {:.4f}  bound {:.5f}  '
              'plain {:.4f}'.format(*row), flush=True)
    print('bf16, every shape: each block shape within the bound, windows past nw zero',
          flush=True)
    return fwd_ms, fwd16_ms, fwd_plain_ms, max_err32


def live_cotangent(gen, n, t, c, nw, dtype):
    """A random cotangent of a [n, t, c] attention output, zero on the
    windows past nw (the model reads nothing there)."""
    import torch
    g = torch.randn(n, t, c, generator=gen, device='cuda')
    return torch.where((torch.arange(n, device='cuda') < nw)[:, None, None], g, 0).to(dtype)


def check_train_kernels(levels, channels):
    """Phase 3b. Returns (max float32 forward error, max float32 gradient
    error), in absolute terms. Prints per shape, in bf16: B2f and B2b at
    rate 0 (the tables' choice) and at 0.1 in each block shape and path
    (the chosen one marked *), SDPA with dropout 0.1 and SDPA's backward on
    the live windows, the bounds of B2f and B2b, and the stored bits' bytes
    on the live windows beside the time the card takes to write and read
    them once."""
    import torch
    from openseg3d_tpu_torch.ops.attention import (dropout_keep_mask, pack_keep_bits,
                                                   train_backward_shape, train_forward_bound,
                                                   train_forward_shape,
                                                   window_attention_packed_train_plain,
                                                   window_attention_train_backward,
                                                   window_attention_train_forward)
    gen = torch.Generator(device='cuda').manual_seed(2)
    seed = torch.tensor([20260516], dtype=torch.int32, device='cuda')
    max_fwd32, max_grad32, rows = 0.0, 0.0, []
    print('stage   T    C     W    nw  fwd_f32   grad_f32(rel)  fwd_bf16(/bound)  '
          'grad_bf16(rel, worst path)  pfwd_ms  pbwd_ms')

    def grad_rel(dpk, ref, c):
        return max(float((g.float() - r.float()).abs().max()) / max(float(r.float().abs().max()),
                                                                    1e-30)
                   for g, r in zip(dpk.split(c, -1), ref.split(c, -1)))

    for s, stage_levels in enumerate(levels):
        c = channels[s]
        for lv in stage_levels:
            t, n = lv.max_tokens, lv.num_windows
            nw = max(1, n - max(1, n // 4))
            hd = c // 8
            try:                                   # the one pass takes T <= 256
                one_pass_ok = train_backward_shape(t, hd, 8, True)[0] > 0
            except ValueError:
                one_pass_ok = False
            paths = (False, True) if one_pass_ok else (False,)
            try:                                   # no 64-row block at head_dim 6
                block_rows_all = (16, 64) if train_forward_shape(t, hd, 8, 64) else (16,)
            except ValueError:
                block_rows_all = (16,)
            res = {}
            for dtype in (torch.float32, torch.bfloat16):
                for rate in (0.0, 0.1):
                    packed, bias, nwt = attention_case(gen, n, t, c, nw, dtype)
                    gout = live_cotangent(gen, n, t, c, nw, dtype)
                    out, stats, bits = window_attention_train_forward(packed, bias, seed, nwt, 8,
                                                                      rate)
                    dpk = window_attention_train_backward(packed, bias, seed, nwt, out, stats,
                                                          bits, gout, 8, rate)
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
                        fwd_rel = fwd_abs
                    else:
                        # the kernel rounds the softmax weights to bf16, as the TPU kernel
                        lim = train_forward_bound(want, packed, 8, rate)
                        assert bool((err <= lim).all()), (s, t, c, rate, fwd_abs)
                        fwd_rel = float((err / lim.clamp(min=1e-30)).max())
                    # dq, dk and dv, each against its own largest magnitude
                    g_abs = max(float((g.float() - r.float()).abs().max())
                                for g, r in zip(dpk.split(c, -1), x.grad.split(c, -1)))
                    g_rel = grad_rel(dpk, x.grad, c)
                    bound = 1e-4 if dtype == torch.float32 else 4 * 2.0 ** -7
                    assert g_rel <= bound, (s, t, c, rate, dtype, g_rel)
                    assert not out[nw:].any() and not dpk[nw:].any()
                    assert bool(torch.isfinite(dpk.float()).all())
                    if dtype == torch.bfloat16 and rate > 0.0:
                        # the stored bits in each block shape, bit for bit;
                        # both backward paths, each twice: the same bits
                        live = (torch.arange(n, device='cuda') < nw)[:, None, None, None]
                        keep = pack_keep_bits(dropout_keep_mask(seed, n, 8, t, rate) & live)
                        for block_rows in block_rows_all:
                            o2, _, b2 = window_attention_train_forward(
                                packed, bias, seed, nwt, 8, rate, rows=block_rows)
                            stored = torch.where(live[..., None], b2.view(torch.int32), 0)
                            assert torch.equal(stored, keep.view(torch.int32)), \
                                (s, t, c, block_rows)
                            assert bool(((o2.float() - want).abs() <= lim).all()), \
                                (s, t, c, block_rows)
                        for one_pass in paths:
                            d1, d2 = (window_attention_train_backward(
                                packed, bias, seed, nwt, out, stats, bits, gout, 8, rate,
                                one_pass=one_pass) for _ in range(2))
                            assert torch.equal(d1.view(torch.int16), d2.view(torch.int16)), \
                                (s, t, c, one_pass)
                            g_rel = max(g_rel, grad_rel(d1, x.grad, c))
                            assert g_rel <= bound, (s, t, c, one_pass, g_rel)
                    res[(dtype, rate)] = (fwd_rel, g_abs, g_rel)
                    if dtype == torch.float32:
                        max_fwd32, max_grad32 = max(max_fwd32, fwd_abs), max(max_grad32, g_abs)
            # time the production dtype (bf16): at rate 0 the tables' choice,
            # at 0.1 every block shape and path; kernel and plain in turns,
            # the library calls on the live windows
            out0, stats0, _ = window_attention_train_forward(packed, bias, seed, nwt, 8, 0.0)
            t_f0 = device_ms(functools.partial(window_attention_train_forward, packed, bias, seed,
                                               nwt, 8, 0.0), 10)
            t_b0 = device_ms(functools.partial(window_attention_train_backward, packed, bias,
                                               seed, nwt, out0, stats0, None, gout, 8, 0.0), 10)
            t_f = {r: device_ms(functools.partial(window_attention_train_forward, packed, bias,
                                                  seed, nwt, 8, 0.1, rows=r), 10)
                   for r in block_rows_all}
            t_b = {op: device_ms(functools.partial(window_attention_train_backward, packed, bias,
                                                   seed, nwt, out, stats, bits, gout, 8, 0.1,
                                                   one_pass=op), 10)
                   for op in paths}
            x = packed.clone().requires_grad_(True)

            def pf():
                with torch.no_grad():
                    window_attention_packed_train_plain(packed, bias, seed, nwt, 8, 0.1)

            def pfb():
                window_attention_packed_train_plain(x, bias, seed, nwt, 8, 0.1).backward(gout)

            pf(), pfb()
            pf_ms, pfb_ms = cuda_ms(pf, 3), cuda_ms(pfb, 3)
            q, k, v = (y.contiguous() for y in packed[:nw].split(c, dim=-1))
            sd_ms = sdpa_ms(q, k, v, bias[:nw], dropout_p=0.1, iters=10)
            sb_ms = sdpa_backward_ms(q, k, v, bias[:nw], iters=10)
            bf_ms, _ = attention_bound(nw, t, c, 2, kind='train_fwd')
            bb_ms, _ = attention_bound(nw, t, c, 2, kind='bwd')
            bits_bytes = nw * 8 * (-(-t // 16)) ** 2 * 32
            fwd64 = train_forward_shape(t, hd, 8)[0] != 8
            one = train_backward_shape(t, hd, 8)[0] > 0
            rows.append((s + 1, t, c, nw, t_f0, f'{t_f[16]:.4f}' + '*' * (not fwd64),
                         f'{t_f[64]:.4f}' + '*' * fwd64 if 64 in t_f else '-', t_b0,
                         f'{t_b[False]:.4f}' + '*' * (not one),
                         f'{t_b[True]:.4f}' + '*' * one if one_pass_ok else '-',
                         sd_ms, sb_ms, bf_ms, bb_ms, bits_bytes / 1e6,
                         2 * bits_bytes / HBM_BYTES_PER_S * 1e3))
            r32, r16 = res[(torch.float32, 0.1)], res[(torch.bfloat16, 0.1)]
            print(f'{s + 1:5d} {t:4d} {c:4d} {n:5d} {nw:5d}  {r32[0]:.2e}  {r32[2]:.2e}       '
                  f'{r16[0]:.3f}             {r16[2]:.2e}                    {pf_ms:7.4f}  '
                  f'{pfb_ms - pf_ms:7.4f}', flush=True)
    print('bf16 per shape, live windows (device ms per call; * the tables\' choice): B2f at '
          'rate 0 / at 0.1 in 16- and 64-row blocks, B2b at rate 0 / at 0.1 in two passes and '
          'in one, SDPA with dropout 0.1, SDPA backward, bound of B2f / B2b, stored bits MB '
          '(written once, read once: ms at 3.35 TB/s)')
    for row in rows:
        print('  st {} T {:4d} C {:4d} nw {:5d}: B2f {:.4f} / {} {}  B2b {:.4f} / {} {}  '
              'SDPA {:.4f}  SDPA bwd {:.4f}  bound {:.5f} / {:.5f}  bits {:.3f} MB '
              '({:.5f} ms)'.format(*row), flush=True)
    print('bf16 at rate 0.1, every shape: stored bits equal the plain packer\'s in each block '
          'shape; B2b bit-equal over two calls in each path', flush=True)
    return max_fwd32, max_grad32


def check_nearest_point(cfg, spec, batch, smi):
    """Phase 3c. Returns B3's yardsticks on the real frame's label transfer
    (knn_yardstick). Prints the kernel's device ms beside its bound, the
    issue floor of its _rn arithmetic and cdist + argmin."""
    import torch
    from openseg3d_tpu_torch.models.backbones.sparse_unet import build_unet_plans
    from openseg3d_tpu_torch.ops.knn import nearest_point, nearest_point_plain, split_plan
    from openseg3d_tpu_torch.ops.sparse_conv import SparseTensor
    from openseg3d_tpu_torch.utils.pointops import get_voxel_centers
    sys.path.insert(0, os.path.join(REPO, 'tests'))
    from test_torch_cuda import nearest_point_edge_cases
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
    print('1-NN random points: indices equal', flush=True)
    # the split search's edge cases (tests/test_torch_cuda.py): bit-equal
    for name, eq, ep, ev in nearest_point_edge_cases(torch.device('cuda'), gen):
        got_e, want_e = nearest_point(eq, ep, ev), nearest_point_plain(eq, ep, ev)
        torch.cuda.synchronize()
        assert torch.equal(got_e, want_e), (name, int((got_e != want_e).sum()))
        print(f'1-NN {name} (B {eq.shape[0]}, Q {eq.shape[1]}, P {ep.shape[1]}, split plan '
              f'{split_plan(eq.shape[0], eq.shape[1], ep.shape[1], eq.device)}): indices equal',
              flush=True)

    # the frame's call: one search and one combine kernel, matched by name
    events, _ = trace(lambda: nearest_point(dst, src, valid))
    search, combine = (named_kernels(events, n) for n in ('nearest_point_kernel',
                                                          'nearest_point_combine_kernel'))
    assert search[1] == 1 and combine[1] == 1, (search, combine)
    k_ms = device_ms(lambda: nearest_point(dst, src, valid), 10)
    p_ms = device_ms(lambda: nearest_point_plain(dst, src, valid), 2)
    y = knn_yardstick(dst[0], src[0], valid[0])
    splits, span = split_plan(1, dst.shape[1], src.shape[1], dst.device)
    print(f'B3 on the frame ({splits} splits of {span} points): {k_ms:.4f} ms of device time '
          f'(search {search[0]:.4f}, combine {combine[0]:.4f} in one profiled call); bound '
          f'{y["bound_ms"]:.4f} ms ({y["bound_by"]}); issue floor of the _rn arithmetic '
          f'{y["floor_ms"]:.4f} ms (8 unfused operations a pair, one FMA slot each), '
          f'{y["floor_ms"] * 11 / 8:.4f} ms with the compare and two selects; cdist + argmin '
          f'{y["library_ms"]:.4f} ms; plain {p_ms:.4f} ms; on {smi}', flush=True)
    return y


# the card's peaks (NVIDIA H100 SXM data sheet, dense): the least time of a
# function is the larger of its bytes over the memory rate and its flops over
# the rate of their type
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
FP32_FLOPS_PER_S = 67e12


def bound(nbytes: float, flops: float, flops_per_s: float = BF16_FLOPS_PER_S):
    """(least ms, 'bytes' or 'operations')."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / flops_per_s * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def attention_bound(windows, t, c, itemsize, nhead=8, kind='fwd'):
    """The least time of window attention over `windows` live windows: 'fwd'
    reads q, k, v and the bias and writes out (B1, B4), 'train_fwd' also
    writes the row statistics (B2f); 4 T^2 C flops a window. 'bwd' reads q,
    k, v, out, the cotangent, the statistics and the bias and writes dq, dk
    and dv (B2b); 10 T^2 C flops a window (the logits again, dV, dP, dQ,
    dK)."""
    rows = windows * t
    if kind == 'bwd':
        return bound(rows * (8 * c * itemsize + 8 * nhead + 4), 10 * windows * t * t * c)
    stats = 8 * nhead if kind == 'train_fwd' else 0
    return bound(rows * (4 * c * itemsize + 4 + stats), 4 * windows * t * t * c)


def sdpa_inputs(q, k, v, bias, nhead=8):
    """q, k, v [N, T, C] -> [N, H, T, hd] views and the additive mask
    [N, 1, 1, T] in q's dtype, for scaled_dot_product_attention."""
    n, t, c = q.shape
    heads = [x.reshape(n, t, nhead, c // nhead).transpose(1, 2) for x in (q, k, v)]
    return heads, bias[:, None, None, :].to(q.dtype)


def sdpa_ms(q, k, v, bias, dropout_p=0.0, iters=5):
    """Device ms of one scaled_dot_product_attention call (scale 1: q comes
    scaled)."""
    import torch.nn.functional as F
    (qh, kh, vh), mask = sdpa_inputs(q, k, v, bias)
    fn = lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,  # noqa: E731
                                                dropout_p=dropout_p, scale=1.0)
    return device_ms(fn, iters)


def sdpa_backward_ms(q, k, v, bias, iters=3):
    """Device ms of the backward of one scaled_dot_product_attention call at
    dropout 0, for a random cotangent."""
    import torch
    import torch.nn.functional as F
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    (qh, kh, vh), mask = sdpa_inputs(*leaves, bias)
    out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask, scale=1.0)
    gout = torch.randn_like(out)
    fn = lambda: torch.autograd.grad(out, leaves, gout, retain_graph=True)  # noqa: E731
    return device_ms(fn, iters)


def unpacked_case(gen, n, t, c, dtype, nhead=8):
    """attention_case's model-shaped q and k as three arrays, with v random
    on every row (padded rows too), so a fully padded window's result (the
    mean of its own v rows) is not zero. Window 1 and the last quarter of
    the windows are fully padded."""
    import torch
    packed, bias, _ = attention_case(gen, n, t, c, n - n // 4, torch.float32, nhead)
    q, k, _ = (x.contiguous() for x in packed.split(c, dim=-1))
    v = torch.randn(n, t, c, generator=gen, device='cuda')
    return q.to(dtype), k.to(dtype), v.to(dtype), bias


def check_unpacked(levels, channels):
    """Phase 3d. Returns a dict: max float32 error, B4's launches on its own
    path (one bf16 call per shape), and over the shapes the sums of kernel
    (the table's block shape and the 16-row block), plain and SDPA ms and of
    the bound. In bf16 every block shape is held to the bound and its fully
    padded windows to the mean of their own v rows (check_launch_shapes)."""
    import torch
    from openseg3d_tpu_torch.ops.attention import (_launch_unpacked, attention_group,
                                                   eval_rows, fused_window_attention,
                                                   fused_window_attention_plain,
                                                   train_forward_bound)
    gen = torch.Generator(device='cuda').manual_seed(4)
    shapes = []
    for s, stage_levels in enumerate(levels):
        for lv in stage_levels:
            t, c = lv.max_tokens, channels[s]
            g = max(attention_group(t, c, 2), attention_group(t, c, 4))
            shapes.append((str(s + 1), t, c, -(-lv.num_windows // g) * g))
    shapes.append(('JAX test', 800, 384, 2 * attention_group(800, 384, 4)))
    max_err32, cases, rows = 0.0, [], []
    print('   stage    T    C     N  err_f32   err_bf16/bound  padded  (bf16 device ms per '
          'call by query rows a block, * the table\'s)  plain_ms  sdpa_ms  bound_ms')
    for st, t, c, n in shapes:
        q, k, v, bias = unpacked_case(gen, n, t, c, torch.float32)
        got = fused_window_attention(q, k, v, bias, 8).float()
        want = fused_window_attention_plain(q, k, v, bias, 8).float()
        torch.cuda.synchronize()
        # fully padded windows: the oracle's own-window mean of v
        pad = ~(bias == 0).any(dim=1)
        mean = v[pad].float().mean(dim=1, keepdim=True)
        tol = 1e-5 * max(1.0, float(want.abs().max()))
        err = (got - want).abs()
        assert bool((err <= tol).all() and ((got[pad] - mean).abs() <= tol).all()), (st, t, c)
        err32 = float(err.max())

        q, k, v, bias = unpacked_case(gen, n, t, c, torch.bfloat16)
        want = fused_window_attention_plain(q, k, v, bias, 8).float()
        lim = train_forward_bound(want, torch.cat([q, k, v], -1), 8, 0.0)
        pad = ~(bias == 0).any(dim=1)
        mean = v[pad].float().mean(dim=1, keepdim=True)

        def padded_mean(out, where):
            assert bool(((out[pad].float() - mean).abs() <= lim[pad] + 1e-6).all()), where

        times, rel = check_launch_shapes(
            functools.partial(_launch_unpacked, q, k, v, bias, 8), want, lim, t, c // 8,
            (st, t, c), padded_mean)
        choice = eval_rows(t, c // 8)
        max_err32 = max(max_err32, err32)
        cases.append((q, k, v, bias))
        pms = device_ms(functools.partial(fused_window_attention_plain, q, k, v, bias, 8), 3)
        lms = sdpa_ms(q, k, v, bias, iters=10)
        bms, by = attention_bound(n, t, c, 2)
        rows.append((times[choice], times[16], pms, lms, bms,
                     bms if by == 'bytes' else 0.0))
        print(f'{st:>8} {t:4d} {c:4d} {n:5d}  {err32:.2e}  {rel:.3f}  {int(pad.sum()):5d} ok  '
              f'{shape_times(times, choice)}  {pms:9.4f} {lms:8.4f} {bms:9.5f}', flush=True)
    # B4's own path: the public op once per shape, in the production dtype
    fused_window_attention.launches = 0
    for q, k, v, bias in cases:
        fused_window_attention(q, k, v, bias, 8)
    torch.cuda.synchronize()
    launches = fused_window_attention.launches
    assert launches == len(shapes), (launches, len(shapes))
    kms, k16_ms, pms, lms, bms, bytes_ms = (sum(col) for col in zip(*rows))
    return dict(max_err32=max_err32, launches=launches, ms=kms, ms16=k16_ms, plain_ms=pms,
                library_ms=lms, bound_ms=bms,
                bound_by='bytes' if bytes_ms >= bms / 2 else 'operations')


def capture_attention_inputs(model_forward, batch):
    """One eval forward with the attention core wrapped: {(N, T, C): [calls,
    packed, bias, nw]} with the first call's inputs of each level shape."""
    from openseg3d_tpu_torch.models import swformer
    from openseg3d_tpu_torch.ops.attention import window_attention_packed
    seen = {}

    def record(packed, bias, nhead, nw):
        key = tuple(packed.shape)
        if key in seen:
            seen[key][0] += 1
        else:
            seen[key] = [1, packed, bias, nw]
        return window_attention_packed(packed, bias, nhead, nw)

    with mock.patch.object(swformer, 'window_attention_packed', record):
        model_forward(batch)
    return seen


def attention_yardsticks(seen):
    """Library ms and bound ms of B1, B2f and B2b over one main-path run:
    per level shape, the calls x the time of one call on that level's live
    windows (one sample: the first nw windows). Also prints each level's
    live windows."""
    import torch
    out = {k: dict(library_ms=0.0, bound_ms=0.0, bytes_ms=0.0)
           for k in ('b1', 'b2f', 'b2b')}
    for (n, t, c3), (calls, packed, bias, nw) in sorted(seen.items()):
        c, live = c3 // 3, int(nw[0])
        print(f'  level T={t} C={c}: {live}/{n} windows live, {calls} calls', flush=True)
        if live == 0:                  # a level this frame leaves empty: no work
            continue
        q, k, v = (x.contiguous() for x in packed[:live].split(c, dim=-1))
        b = bias[:live]
        item = packed.element_size()
        for name, lib_ms, kind in (('b1', sdpa_ms(q, k, v, b), 'fwd'),
                                   ('b2f', sdpa_ms(q, k, v, b, dropout_p=0.1), 'train_fwd'),
                                   ('b2b', sdpa_backward_ms(q, k, v, b), 'bwd')):
            bms, by = attention_bound(live, t, c, item, kind=kind)
            out[name]['library_ms'] += calls * lib_ms
            out[name]['bound_ms'] += calls * bms
            out[name]['bytes_ms'] += calls * bms * (by == 'bytes')
    for d in out.values():
        d['bound_by'] = 'bytes' if d.pop('bytes_ms') >= d['bound_ms'] / 2 else 'operations'
    torch.cuda.synchronize()
    return out


def time_b1_levels(seen, what):
    """Phase 4: B1 on a frame's captured inputs (the first call of each
    level shape; `what` names the frame), device ms of one call in the
    table's block shape and in the 16-row block; prints each level's live
    windows and times, and returns the sums over the levels of calls x
    each."""
    from openseg3d_tpu_torch.ops.attention import _launch_cuda, eval_rows
    sums = [0.0, 0.0]
    for (n, t, c3), (calls, packed, bias, nw) in sorted(seen.items(), key=lambda kv: kv[0][1:]):
        c = c3 // 3
        rows = eval_rows(t, c // 8)
        ms = [device_ms(functools.partial(_launch_cuda, packed, bias, 8, nw, r), 10)
              for r in (rows, 16)]
        print(f'  B1 {what} T={t} C={c}: {nw.tolist()} of {n // nw.numel()} windows live a '
              f'sample, {calls} calls: {rows} rows {ms[0]:.4f} ms, 16 rows {ms[1]:.4f} ms a '
              f'call', flush=True)
        sums = [x + calls * y for x, y in zip(sums, ms)]
    return sums


def eval_tool_batches(cfg, device):
    """tools.eval's inputs for its first synthetic frame
    (``SyntheticDataset(cfg, 8, mode='validation')``, the frames of
    ``tools.eval --synthetic``): the frame alone, as with --no_tta, and its
    first TTA group at the default --tta_batch 2 (MultiScaleFlipAug's first
    two variants in one batch, as tools.eval builds it). Returns {name:
    batch on the device}."""
    import numpy as np
    from openseg3d_tpu_torch.data.batch import collate_padded, to_device
    from openseg3d_tpu_torch.data.synthetic import SyntheticDataset
    from openseg3d_tpu_torch.data.test_time_aug import MultiScaleFlipAug
    dataset = SyntheticDataset(cfg, 8, mode='validation')
    prepared = dataset.prepare_data(dataset.load_raw(0))
    dataset.prepare_voxel_labels(prepared)
    single = collate_padded([dataset.pad(prepared)])
    tta = MultiScaleFlipAug(dataset, scales=[0.95, 1.0, 1.05],
                            angles=[-np.pi / 4, 0.0, np.pi / 4], flip_x=True, flip_y=True)
    try:
        group = []
        for b in tta(dataset.load_raw(0), index=0):
            group.append(b)
            if len(group) == 2:
                break
    finally:
        tta.close()
    pair = {k: np.concatenate([g[k] for g in group]) for k in group[0] if k != 'batch_size'}
    return {'tools.eval frame 0, --no_tta': to_device(single, device),
            'tools.eval frame 0, TTA group of 2': to_device(pair, device)}


def knn_yardstick(dst, src, valid, chunk=4096):
    """B3's library ms (torch.cdist over query chunks, invalid points at
    +inf, argmin; ties may resolve otherwise), bound and issue floor for
    queries dst [Q, 3] against points src [P, 3] (valid [P]): 8 float32
    operations a pair (3 differences, 3 squares, 2 sums) over the valid
    points, at 67 TFLOP/s for the bound; for the floor each of the 8 takes a
    whole FMA issue slot (the _rn rule contracts none into an FMA, and the
    peak counts an FMA as two operations), so the floor is twice the
    bound's operation time."""
    import torch

    def cdist_argmin():
        out = []
        for lo in range(0, dst.shape[0], chunk):
            d = torch.cdist(dst[lo:lo + chunk], src)
            out.append(d.masked_fill(~valid, float('inf')).argmin(dim=1))
        return torch.cat(out)

    lib_ms = device_ms(cdist_argmin, 3)
    q, p, pv = dst.shape[0], src.shape[0], int(valid.sum())
    bms, by = bound(q * 12 + p * 13 + q * 4, 8.0 * q * pv, FP32_FLOPS_PER_S)
    floor_ms = 2 * 8.0 * q * pv / FP32_FLOPS_PER_S * 1e3
    return dict(library_ms=lib_ms, bound_ms=bms, bound_by=by, floor_ms=floor_ms)


def frame_batch(cfg, device, cloud=None):
    """One bench.py frame (the port's copy of its generator, RandomState(0)),
    or `cloud` ([N, 6] xyz + features), in `cfg`'s input (the cylinder's
    where it is set), voxelized and padded (data/synthetic.bench_frame).
    Returns (batch, live voxels)."""
    from openseg3d_tpu_torch.data.batch import to_device
    from openseg3d_tpu_torch.data.synthetic import bench_frame
    batch = bench_frame(cfg, N_POINTS, cloud=cloud)
    return to_device(batch, device), int(batch['voxel_mask'].sum())












def profile_forward(forward, batch, core):
    """One forward under torch.profiler, with the attention core (``core``,
    the kernel's wrapper or the plain version) patched into the SWFormer
    layers inside a record_function range. Returns a dict of ms: the
    forward's wall time (CUDA events), the device-busy time, the device time
    of the kernels launched inside the attention ranges (and their count),
    of the tensor-core eval kernel (and its count), and the count of the FMA
    body's launches."""
    from torch.profiler import record_function
    from openseg3d_tpu_torch.models import swformer

    def annotated(*args):
        with record_function('attention_core'):
            return core(*args)

    with mock.patch.object(swformer, 'window_attention_packed', annotated):
        events, wall = trace(lambda: forward(batch))
    calls, core_ms, core_kernels = range_kernels(events, 'attention_core')
    b1_ms, b1_kernels = named_kernels(events, 'window_attention_mma_kernel')
    return dict(wall_ms=wall, busy_ms=busy_ms(events), core_calls=calls, core_ms=core_ms,
                core_kernels=core_kernels, b1_ms=b1_ms, b1_kernels=b1_kernels,
                b1_fma_kernels=named_kernels(events, 'window_attention_kernel')[1])


def run_slice(cfg, device, expected_launches):
    """Phase 4. Returns (launches, median forward ms, median plain forward
    ms, peak bytes, profile of the kernel's forward, of the plain one, the
    attention kernels' yardsticks on this forward's inputs, {frame: B1's
    sums over the levels of its forward in the table's block shape and in
    the 16-row block (time_b1_levels)} for the bench frame and tools.eval's
    frame alone and in its TTA group of 2)."""
    import torch
    from openseg3d_tpu_torch.engine import build_segmentor, make_eval_step, make_forward
    from openseg3d_tpu_torch.models import swformer
    from openseg3d_tpu_torch.ops.attention import (window_attention_packed,
                                                   window_attention_packed_plain)
    from openseg3d_tpu_torch.ops.sparse_conv import gather_gemm, weight_grad
    from openseg3d_tpu_torch.weights import init_weights

    batch, n_voxels = frame_batch(cfg, device)
    print(f'frame: {N_POINTS} points, {n_voxels} voxels '
          f'(capacity {cfg.RUNTIME.MAX_VOXELS_PER_SAMPLE})', flush=True)
    model, spec = build_segmentor(cfg, device)
    init_weights(model, torch.Generator().manual_seed(0))
    model.eval()
    eval_step = make_eval_step(cfg, spec, model)
    # the plain attention in place of the kernel, for the reference forward
    plain_core = mock.patch.object(swformer, 'window_attention_packed',
                                   window_attention_packed_plain)

    window_attention_packed.launches = gather_gemm.launches = weight_grad.launches = 0
    res = eval_step(batch)
    torch.cuda.synchronize()
    launches = window_attention_packed.launches
    convs, n_convs = (gather_gemm.launches, weight_grad.launches), model_convs(cfg)
    print(f'kernel launches in one eval step: {launches} (config implies '
          f'{expected_launches}); sparse conv S1, S2: {convs} (the model\'s convs '
          f'{n_convs})', flush=True)
    assert launches == expected_launches, (launches, expected_launches)
    assert convs == (n_convs, 0), convs

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
    # the bf16 forward runs the tensor-core kernel, never the FMA body
    assert profiles['kernel']['b1_kernels'] == expected_launches, profiles['kernel']
    assert profiles['kernel']['b1_fma_kernels'] == 0, profiles['kernel']
    assert profiles['plain']['b1_kernels'] == profiles['plain']['b1_fma_kernels'] == 0, \
        profiles['plain']
    seen = capture_attention_inputs(forward, batch)
    yardsticks = attention_yardsticks(seen)
    b1_levels = {'bench frame': time_b1_levels(seen, 'bench frame')}
    for name, frame in eval_tool_batches(cfg, device).items():
        b1_levels[name] = time_b1_levels(capture_attention_inputs(forward, frame), name)
    return (launches, statistics.median(times['kernel']),
            statistics.median(times['plain']), peaks['kernel'],
            profiles['kernel'], profiles['plain'], yardsticks, b1_levels)


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


def check_conv_weight_grads(spec, batch):
    """Phase 4b: one sparse conv of each kind at full size on the frame's
    rulebooks, in the production dtypes (bf16 features and cotangent,
    float32 weights, compute dtype bf16): the subm conv of stage 2 (96 ->
    96, UpBlock_2's), the strided conv into stage 2 (48 -> 96,
    ConvModule_1) and the inverse conv from stage 3 into stage 2 (192 ->
    96, UpBlock_1's). The backward's float32 dW against a float32 product
    of the same bf16 inputs gathered through the forward rulebook (not the
    transpose the backward reads), within 1e-5 of max|dW|: both sum the
    same exact products in float32, in another order. Returns {kind:
    max |dW - reference| / max |reference|}."""
    import torch
    from openseg3d_tpu_torch.models.backbones.sparse_unet import build_unet_plans
    from openseg3d_tpu_torch.ops.scatter import take_rows_or_zero
    from openseg3d_tpu_torch.ops.sparse_conv import SparseTensor, apply_sparse_conv
    with torch.no_grad():
        plans = build_unet_plans(SparseTensor(None, batch['voxel_coords'], spec.spatial_shape),
                                 spec.capacities)
    m1, m2, m3, _ = plans.masks
    dev = m1.device
    gen = torch.Generator(device=dev).manual_seed(5)
    errs = {}
    for kind, rb, in_mask, out_mask, cin, cout in (
            ('subm', plans.subm[1], m2, m2, 96, 96),
            ('strided', plans.down[0].rule, m1, m2, 48, 96),
            ('inverse', plans.down[1].inv_rule, m3, m2, 192, 96)):
        b, k3, vo = rb.in_idx.shape
        x = torch.randn(b, in_mask.shape[1], cin, generator=gen, device=dev)
        x = torch.where(in_mask[..., None], x, 0).bfloat16()
        w = torch.randn(k3, cin, cout, generator=gen, device=dev) / (k3 * cin) ** 0.5
        w.requires_grad_(True)
        g = torch.randn(b, vo, cout, generator=gen, device=dev).bfloat16()
        apply_sparse_conv(x, rb, w, out_mask, torch.bfloat16).backward(g)
        with torch.no_grad():
            gm = torch.where(out_mask[..., None], g, 0).float().reshape(-1, cout)
            ref = torch.stack([take_rows_or_zero(x.float(), rb.in_idx[:, k]).reshape(-1, cin).t()
                               @ gm for k in range(k3)])
        assert w.grad.dtype == torch.float32
        errs[kind] = float((w.grad - ref).abs().max()) / float(ref.abs().max())
    print(f'full-size bf16 conv dW against a float32 product of the same inputs (max abs error '
          f'/ max |dW|): {errs}', flush=True)
    assert all(e <= 1e-5 for e in errs.values()), errs
    return errs


def record_convs(cfg):
    """Every sparse conv of one bf16 eval forward of `cfg`'s model (random
    weights) on the bench frame: [(features, weights, rulebook, out_mask)]
    as ``_SparseConv`` received them, in call order."""
    import torch
    from openseg3d_tpu_torch.engine import build_segmentor, make_forward
    from openseg3d_tpu_torch.ops import sparse_conv as sc
    from openseg3d_tpu_torch.weights import init_weights
    device = torch.device('cuda')
    batch, _ = frame_batch(cfg, device)
    model, _ = build_segmentor(cfg, device)
    init_weights(model, torch.Generator().manual_seed(0))
    model.eval()
    calls, apply = [], sc._SparseConv.apply

    def recording(features, weights, rulebook, out_mask, compute_dtype):
        calls.append((features.to(compute_dtype), weights.detach(), rulebook, out_mask))
        return apply(features, weights, rulebook, out_mask, compute_dtype)

    with torch.no_grad(), mock.patch.object(sc._SparseConv, 'apply', recording):
        make_forward(model)(batch)
    torch.cuda.synchronize()
    return calls


def live_share(idx, mask_in, mask_out, rows):
    """The share of (block of `rows` index columns, offset) pairs with a live
    entry: an index >= 0 whose gathered row (mask_in, None for every row)
    and whose own row (mask_out, None for every row) are live. What the
    kernels' skips leave to run, from the rulebook by torch ops."""
    import torch
    b, k3, n = idx.shape
    live = idx >= 0
    if mask_in is not None:
        live &= torch.gather(mask_in, 1, idx.clamp(min=0).reshape(b, -1).long()).reshape(b, k3, n)
    if mask_out is not None:
        live &= mask_out[:, None, :]
    pad = -n % rows
    live = torch.nn.functional.pad(live, (0, pad)).reshape(b, k3, -1, rows).any(-1)
    return float(live.float().mean())


def grad_work(pairs, cin, cout, rows_in, rows_out):
    """(bytes, flops) of the weight gradient alone: the live input rows and
    the cotangent rows read once, one int32 index a pair, the float32 dW
    written; 2 x pairs x Cin x Cout flops. (benchmark/counts.conv_work
    gives the forward, and the dx as a forward with the widths and rows
    swapped.)"""
    return ((rows_in * cin + rows_out * cout) * 2 + 4 * pairs + 4 * 27 * cin * cout,
            2.0 * pairs * cin * cout)


def check_sparse_conv_kernels(smi):
    """Phase 4c: the gather-GEMM (S1) and weight-gradient (S2) kernels at
    every main-path conv of both models on the bench frame. Per conv: the
    forward and dx within 2**-6 of the plain path's largest output and dW
    within 1e-5 of max|dW| of the plain path's product of the same bf16
    values in float32 (TF32 off: no tensor-core accumulator over all the
    rows); forward, dx and dW device ms (CUDA events) in the table's
    tiles, each beside its least time (``benchmark.counts.conv_work`` for
    the forward and, widths and rows swapped, dx; ``grad_work`` for dW) and
    beside the plain path's ms (the row gather to device memory and one
    product); and the share of (tile, offset) pairs that ran. Every tile of
    each kernel is timed at every width and the fastest printed: the tables
    GEMM_TABLE and GRAD_TABLE of ops/sparse_conv.py come from here. Returns
    {model: sums and worst errors, 'tables': the fastest tiles}."""
    import torch
    from benchmark.counts import conv_work
    from openseg3d_tpu_torch.config import cfg_from_file
    from openseg3d_tpu_torch.ops import sparse_conv as sc
    gemm_tiles, grad_tiles = sc.tile_shapes('gather_gemm'), sc.tile_shapes('weight_grad')
    summary, tile_ms, grad_tile_ms = {}, {}, {}
    parts = ('fwd', 'dx', 'dw')
    for model in ('segformer', 'spnet'):
        cfg = cfg_from_file(os.path.join(REPO, 'configs', 'waymo_one_sweep.yaml'),
                            {'MODEL': {'SEGMENTOR': model}})
        calls = record_convs(cfg)
        gen = torch.Generator(device='cuda').manual_seed(11)
        tot = {f'{k}{p}': 0.0 for k in ('', 'bound_', 'plain_') for p in parts}
        tot.update(err_gemm=0.0, err_dw=0.0, convs=len(calls))
        print(f'{model}: {len(calls)} convs; per conv: Cin Cout kind rows_out pairs | ms (bound, '
              f'plain) forward | dx | dW | live (tile, offset) share forward, dx, dW steps',
              flush=True)
        for x, weights, rb, out_mask in calls:
            b, vin, cin = x.shape
            cout = weights.shape[-1]
            in_mask = (rb.transpose >= 0).any(1)          # input rows with a pair
            w = weights.bfloat16().contiguous()
            wt = w.transpose(1, 2).contiguous()
            g = torch.randn(b, out_mask.shape[1], cout, generator=gen, device='cuda').bfloat16()
            dx_mask = out_mask if rb.submanifold else None
            pairs = int(((rb.in_idx >= 0) & out_mask[:, None, :]).sum())
            rows_in, rows_out = int(in_mask.sum()), int(out_mask.sum())
            bounds = (bound(*conv_work(pairs, cin, cout, rows_in, rows_out))[0],
                      bound(*conv_work(pairs, cout, cin, rows_out, rows_in))[0],
                      bound(*grad_work(pairs, cin, cout, rows_in, rows_out))[0])
            kernels = (functools.partial(sc.gather_gemm, x, rb.in_idx, w, dst_mask=out_mask),
                       functools.partial(sc.gather_gemm, g, rb.transpose, wt, out_mask, dx_mask),
                       functools.partial(sc.weight_grad, x, rb.transpose, g, out_mask))
            plains = (functools.partial(sc.gather_gemm_plain, x, rb.in_idx, w, dst_mask=out_mask),
                      functools.partial(sc.gather_gemm_plain, g, rb.transpose, wt, out_mask,
                                        dx_mask),
                      functools.partial(sc.weight_grad_plain, x, rb.transpose, g, out_mask))
            refs = plains[:2] + (functools.partial(sc.weight_grad_plain, x.float(), rb.transpose,
                                                   g.float(), out_mask),)
            for i, (kernel, ref) in enumerate(zip(kernels, refs)):
                got, want = kernel().float(), ref().float()
                err = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)
                gate = 1e-5 if i == 2 else 2 ** -6
                assert err <= gate, (parts[i], cin, cout, err)
                key = 'err_dw' if i == 2 else 'err_gemm'
                tot[key] = max(tot[key], err)
            ms = [cuda_ms(f, 5) for f in kernels]
            plain_ms = [cuda_ms(f, 3) for f in plains]
            share = (live_share(rb.in_idx, None, out_mask, gemm_tiles[sc.gemm_tile(cin, cout)][0]),
                     live_share(rb.transpose, out_mask, dx_mask,
                                gemm_tiles[sc.gemm_tile(cout, cin)][0]),
                     live_share(rb.transpose, out_mask, None, 32))
            kind = 'subm' if rb.submanifold else ('strided' if rb.in_idx.shape[2] < vin
                                                  else 'inverse')
            print(f'  {cin:4d} {cout:4d} {kind:8s} {out_mask.shape[1]:6d} {pairs:8d} | '
                  + ' | '.join(f'{m:.4f} ({bd:.4f}, {pm:.4f})'
                               for m, bd, pm in zip(ms, bounds, plain_ms))
                  + f' | {share[0]:.3f} {share[1]:.3f} {share[2]:.3f}', flush=True)
            for i, p in enumerate(parts):
                tot[p] += ms[i]
                tot[f'bound_{p}'] += bounds[i]
                tot[f'plain_{p}'] += plain_ms[i]
            for t in range(len(gemm_tiles)):
                tile_ms.setdefault((cin, cout), [0.0] * len(gemm_tiles))[t] += cuda_ms(
                    functools.partial(sc.gather_gemm, x, rb.in_idx, w, dst_mask=out_mask,
                                      tile=t), 3)
                tile_ms.setdefault((cout, cin), [0.0] * len(gemm_tiles))[t] += cuda_ms(
                    functools.partial(sc.gather_gemm, g, rb.transpose, wt, out_mask, dx_mask,
                                      tile=t), 3)
            for t in range(len(grad_tiles)):
                grad_tile_ms.setdefault((cin, cout), [0.0] * len(grad_tiles))[t] += cuda_ms(
                    functools.partial(sc.weight_grad, x, rb.transpose, g, out_mask, tile=t), 3)
        print(f'{model} convs on the bench frame, sums (ms; bound, plain): '
              + ', '.join(f'{p} {tot[p]:.3f} ({tot["bound_" + p]:.3f}, {tot["plain_" + p]:.3f})'
                          for p in parts)
              + f'; worst error forward/dx {tot["err_gemm"]:.3g} of max|out|, dW '
                f'{tot["err_dw"]:.3g} of max|dW|; on {smi}', flush=True)
        summary[model] = tot
    best = {k: min(range(len(v)), key=v.__getitem__) for k, v in sorted(tile_ms.items())}
    best_grad = {k: min(range(len(v)), key=v.__getitem__) for k, v in sorted(grad_tile_ms.items())}
    for name, tiles, times, choice, table in (
            ('gather-GEMM', gemm_tiles, tile_ms, best, sc.GEMM_TABLE),
            ('weight gradient', grad_tiles, grad_tile_ms, best_grad, sc.GRAD_TABLE)):
        print(f'{name} tiles {tiles} (rows, columns), ms summed over the convs of each width '
              f'(fastest *, table\'s +):', flush=True)
        for k, v in sorted(times.items()):
            print(f'  {k}: ' + '  '.join(f'{t} {ms:.4f}' + '*' * (t == choice[k])
                                         + '+' * (t == table.get(k)) for t, ms in enumerate(v)),
                  flush=True)
        print(f'{name} fastest: {choice}', flush=True)
    summary['tables'] = {'gemm': best, 'grad': best_grad}
    return summary


def conv_kernel_rows(sums, launches):
    """The `kernels` line's rows of S1 and S2, which replace no TPU kernel
    (the JAX package composes the sparse conv in XLA): `launches` counted in
    the main path's train step (phase 4b), device ms, bound and plain ms
    summed over every conv of the bench frame's forward (phase 4c: S1 the
    forward and dx, S2 dW), and the worst error relative to the largest
    output. No library runs this function (spconv has no build here)."""
    rows = []
    for name, n, parts, err in (('gather_gemm', launches['S1'], ('fwd', 'dx'), 'err_gemm'),
                                ('weight_grad', launches['S2'], ('dw',), 'err_dw')):
        rows.append({
            'name': name, 'route': 'cuda', 'source': 'openseg3d_tpu_torch/csrc/sparse_conv.cu',
            'replaces': None, 'launches': n, 'max_abs_err': None,
            'max_err_of_largest': sums[err],
            'ms': sum(sums[p] for p in parts),
            'plain_ms': sum(sums[f'plain_{p}'] for p in parts),
            'bound_ms': sum(sums[f'bound_{p}'] for p in parts),
            'bound_by': 'bytes or operations, the larger per conv', 'library_ms': None})
    return rows


def b2b_paths(spec):
    """(B2b's launches a train step in one pass, in two passes, the keep
    bits' bytes a step): the passes as ops/attention.train_backward_shape
    chooses them at the config's window levels, the bits as B2f stores them
    at the levels' window capacities."""
    from openseg3d_tpu_torch.models.backbones.point_transformer import (CHANNELS,
                                                                        stage_level_specs)
    from openseg3d_tpu_torch.ops.attention import train_backward_shape
    one = two = nbytes = 0
    for s, stage_levels in enumerate(stage_level_specs(spec)):
        for lv in stage_levels:
            t, depth = lv.max_tokens, spec.depths[s]
            if train_backward_shape(t, CHANNELS[s] // 8, 8)[0]:
                one += depth
            else:
                two += depth
            nbytes += depth * lv.num_windows * 8 * (-(-t // 16)) ** 2 * 32
    return one, two, nbytes


def run_train_slice(cfg, batch, expected_attention):
    """Phase 4b. Returns a dict of the results."""
    import torch
    from openseg3d_tpu_torch.engine import TrainState, build_segmentor, make_train_step
    from openseg3d_tpu_torch.models.optim import build_optimizer, build_schedule
    from openseg3d_tpu_torch.models.sparse_modules import SparseConv
    from openseg3d_tpu_torch.ops.attention import (window_attention_train_backward,
                                                   window_attention_train_forward)
    from openseg3d_tpu_torch.ops.knn import nearest_point
    from openseg3d_tpu_torch.ops.sparse_conv import apply_sparse_conv, gather_gemm, weight_grad
    from openseg3d_tpu_torch.ops.window import permute_rows
    from openseg3d_tpu_torch.weights import init_weights

    device = batch['points'].device
    model, spec = build_segmentor(cfg, device)
    init_weights(model, torch.Generator().manual_seed(0))
    initial = copy.deepcopy(model.state_dict())
    step = make_train_step(cfg, spec)
    counters = (window_attention_train_forward, window_attention_train_backward, nearest_point)
    # the gather-only backwards: one per conv, two per encoder layer
    backwards = (apply_sparse_conv, permute_rows)
    expected_backwards = [sum(isinstance(m, SparseConv) for m in model.modules()),
                          2 * sum(spec.depths)]

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
    for c in counters + (gather_gemm, weight_grad):
        c.launches = 0
    for f in backwards:
        f.backwards = 0
    state, m = step(state, batch, seed=0)
    torch.cuda.synchronize()
    launches = [c.launches for c in counters]
    conv_counts = {'S1': gather_gemm.launches, 'S2': weight_grad.launches}
    n_backwards = [f.backwards for f in backwards]
    print(f'train step launches: B2 forward {launches[0]}, B2 backward {launches[1]}, '
          f'B3 {launches[2]} (config implies {expected_attention}, {expected_attention}, 1); '
          f'gather-only backwards: sparse conv {n_backwards[0]}, permute_rows {n_backwards[1]} '
          f'(the model implies {expected_backwards[0]}, {expected_backwards[1]}); '
          f'peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB', flush=True)
    assert launches == [expected_attention, expected_attention, 1], launches
    assert n_backwards == expected_backwards, (n_backwards, expected_backwards)
    want_convs = conv_launches(cfg, steps=1)
    print(f'train step sparse-conv launches: {conv_counts} (the model implies {want_convs})',
          flush=True)
    assert conv_counts == want_convs, (conv_counts, want_convs)
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

    # the same first step again, without --deterministic: printed, not a gate
    state = fresh_state()
    state, _ = step(state, batch, seed=0)
    again = grads()
    differ = [k for k in g_kernel if not torch.equal(g_kernel[k], again[k])]
    print(f'two identical first steps: {len(g_kernel) - len(differ)}/{len(g_kernel)} gradient '
          f'leaves bit-equal; differing: {differ[:6]}', flush=True)

    # timing: kernel path, one warm-up step then 5 timed ones
    state = fresh_state()
    state, _ = step(state, batch, seed=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = [cuda_ms(lambda i=i: step(state, batch, seed=i), 1) for i in range(2, 7)]
    peak = torch.cuda.max_memory_allocated()
    one_pass, two_pass, bits_bytes = b2b_paths(spec)
    print(f'train step ms: {[round(x, 3) for x in times]}, peak {peak / 2**30:.2f} GiB, of it '
          f'the keep bits B2f stores for the backward {bits_bytes / 2**30:.3f} GiB a step '
          f'({bits_bytes} bytes at the window capacities); B2b {one_pass} launches in one '
          f'pass, {two_pass} in two', flush=True)
    plain_times = []
    with attention_patch, knn_patch:
        plain_times = [cuda_ms(lambda i=i: step(state, batch, seed=i), 1) for i in range(7, 9)]
    print(f'train step ms through the plain versions: {[round(x, 3) for x in plain_times]}',
          flush=True)

    # one profiled step of each
    events, wall = trace(lambda: step(state, batch, seed=9))
    # the bf16 step runs the tensor-core kernels; the float32 FMA bodies
    # (window_attention_train_{fwd,dq,dkdv}_kernel) must not launch
    b2b_kernels = {k: named_kernels(events, f'window_attention_train_{k}_mma_kernel')
                   for k in ('onepass', 'dq', 'dkdv')}
    prof = dict(wall_ms=wall, busy_ms=busy_ms(events),
                b2f=named_kernels(events, 'window_attention_train_fwd_mma_kernel'),
                b2b=tuple(map(sum, zip(*b2b_kernels.values()))),
                b3=tuple(map(sum, zip(named_kernels(events, 'nearest_point_kernel'),
                                      named_kernels(events, 'nearest_point_combine_kernel')))),
                fma=sum(named_kernels(events, f'window_attention_train_{k}_kernel')[1]
                        for k in ('fwd', 'dq', 'dkdv')),
                index_add_bf16=named_kernels(events, 'indexFuncLargeIndex', 'BFloat16'),
                index_add=named_kernels(events, 'indexFunc'))
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
    assert prof['b2f'][1] == expected_attention, prof
    assert prof['b3'][1] == 2, prof                                 # search + combine
    # one kernel a one-pass backward, two (dq, dk/dv) a two-pass one
    assert [b2b_kernels[k][1] for k in ('onepass', 'dq', 'dkdv')] == \
        [one_pass, two_pass, two_pass] and one_pass + two_pass == expected_attention, \
        (b2b_kernels, one_pass, two_pass)
    assert prof['fma'] == 0, prof
    # the gathers' backwards scatter no more: at most the devoxelize gather's
    assert prof['index_add_bf16'][1] <= 1, prof
    assert [ranges[k][0] for k in ('b2f', 'b2b', 'b3')] == \
        [expected_attention, expected_attention, 1], ranges
    return dict(launches=launches, conv_launches=conv_counts, backwards=n_backwards, loss=loss,
                plain_loss=plain_loss,
                loss_rel=loss_rel, grad_rel=grad_rel, repeat_differ=len(differ),
                step_ms=statistics.median(times), plain_step_ms=statistics.median(plain_times),
                peak=peak, prof=prof, plain_prof=plain_prof, bits_bytes=bits_bytes,
                b2b_paths=(one_pass, two_pass))


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
    model, _ = build_segmentor(cfg, device='cpu')
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
        model, spec = build_segmentor(cfg, dev)
        init_weights(model, torch.Generator().manual_seed(3))
        set_dropout_off(model)
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


def assert_close_payloads(a, b, rtol):
    """Two checkpoints (utils/checkpoint.py payloads): the same counts, and
    every floating tensor of the model and the optimizer within rtol of the
    other's largest magnitude, every other entry equal. Returns the worst
    (relative difference, name)."""
    import torch
    assert (a['step'], a['updates'], a['epoch']) == (b['step'], b['updates'], b['epoch']), \
        ((a['step'], a['updates'], a['epoch']), (b['step'], b['updates'], b['epoch']))
    assert a['optimizer']['param_groups'] == b['optimizer']['param_groups']
    pairs = [(f'model/{k}', v, b['model'][k]) for k, v in a['model'].items()]
    sa, sb = a['optimizer']['state'], b['optimizer']['state']
    assert sorted(sa) == sorted(sb)
    pairs += [(f'optimizer/{i}/{k}', v, sb[i][k]) for i in sa for k, v in sa[i].items()]
    worst = (0.0, '')
    for name, x, y in pairs:
        if torch.is_tensor(x) and x.is_floating_point():
            rel = float((x.float() - y.float()).abs().max()) / max(float(y.float().abs().max()),
                                                                   1e-30)
            worst = max(worst, (rel, name))
        else:
            assert torch.equal(x, y) if torch.is_tensor(x) else x == y, name
    assert worst[0] <= rtol, worst
    return worst


def run_cli(smi, per_step):
    """Phase 7: the command-line tools in-process. per_step: the attention
    launches one forward makes (B2f and B2b per train step, B1 per eval
    forward). Returns a dict of the results."""
    import math
    import statistics as st
    import torch
    from openseg3d_tpu_torch.config import cfg_from_file
    from openseg3d_tpu_torch.data.synthetic import make_tree
    from openseg3d_tpu_torch.tools import eval as eval_tool
    from openseg3d_tpu_torch.tools import train as train_tool

    counters = model_counters()
    acc_cfg = os.path.join(REPO, 'configs', 'synthetic_accuracy.yaml')
    smoke_cfg = os.path.join(REPO, 'configs', 'synthetic_smoke.yaml')
    out = {}

    def timed(fn, argv):
        t0 = time.perf_counter()
        res = fn(argv)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        # (a) learning: 128 steps at full width and capacity
        a_dir = os.path.join(tmp, 'a')
        frames, epochs, interval = 32, 4, 4
        for c in counters.values():
            c.launches = 0
        hist, secs = timed(train_tool.main, [
            '--cfg_file', acc_cfg, '--synthetic', '--synthetic_frames', str(frames),
            '--batch_size', '1', '--epochs', str(epochs), '--eval_epoch_interval', '2',
            '--num_workers', '4', '--log_iter_interval', str(interval), '--seed', '100',
            '--save_dir', a_dir])
        launches = {k: c.launches for k, c in counters.items()}
        steps = frames * epochs
        val_frames = max(frames // 4, 2) * (epochs // 2)
        # validation's eval step computes the loss too, aux-label 1-NN included
        want = {'B1': per_step * val_frames, 'B2f': per_step * steps,
                'B2b': per_step * steps, 'B3': steps + val_frames,
                **conv_launches(cfg_from_file(acc_cfg), val_frames, steps)}
        print(f'(a) learning run: {steps} steps + {val_frames} validation frames in {secs:.1f} s '
              f'on {smi}; launches {launches} (expected {want})', flush=True)
        assert launches == want, (launches, want)
        for epoch, it, lr, loss, step_ms, data_ms in hist['train']:
            print(f'    epoch {epoch} iter {it:2d}: lr {lr:.6f} loss {loss:.4f} step '
                  f'{step_ms:.1f} ms data-wait {data_ms:.1f} ms', flush=True)
        losses = {e: [r[3] for r in hist['train'] if r[0] == e] for e in range(1, epochs + 1)}
        assert all(math.isfinite(x) for v in losses.values() for x in v), losses
        first, last = st.mean(losses[1]), st.mean(losses[epochs])
        step_ms = st.median(r[4] for r in hist['train'] if r[0] > 1)
        data_ms = st.median(r[5] for r in hist['train'] if r[0] > 1)
        mious = [m for _, m in hist['val']]
        print(f'(a) mean logged loss epoch 1 {first:.4f} -> epoch {epochs} {last:.4f}; '
              f'validation mIoU {mious} (epochs {[e for e, _ in hist["val"]]}); median step '
              f'{step_ms:.1f} ms, data-wait {data_ms:.1f} ms after epoch 1; skipped updates '
              f'{hist["skipped"]}; on {smi}. Accuracy reference, not a gate: the JAX package '
              f'on a TPU reached mIoU 0.4571 after 128 frames seen (64 frames, batch 2, 2 '
              f'epochs; runs/synth_r2/train.log)', flush=True)
        assert last < first, (first, last)
        assert mious[-1] >= 0.15, mious
        out['learning'] = dict(first_loss=first, last_loss=last, mious=mious, step_ms=step_ms,
                               data_ms=data_ms, seconds=secs, launches=launches)

        # (b) resume: the same epoch_2.pt with or without a stop after epoch 1
        b_dir = os.path.join(tmp, 'b')
        argv = ['--cfg_file', smoke_cfg, '--synthetic', '--synthetic_frames', '8',
                '--batch_size', '2', '--epochs', '2', '--num_workers', '0', '--seed', '5',
                '--no_validate', '--log_iter_interval', '1', '--deterministic',
                '--save_dir', b_dir]
        _, secs = timed(train_tool.main, argv)
        path = os.path.join(b_dir, 'epoch_2.pt')
        first_run = torch.load(path, map_location='cpu', weights_only=True)
        os.remove(path)
        hist_b, secs_b = timed(train_tool.main, argv + ['--auto_resume'])
        assert [r[0] for r in hist_b['train']] == [2] * 4, hist_b['train']
        worst = assert_close_payloads(torch.load(path, map_location='cpu', weights_only=True),
                                      first_run, 1e-6)
        print(f'(b) resume: 2 epochs in {secs:.1f} s, epoch 2 again from epoch_1.pt in '
              f'{secs_b:.1f} s; step {first_run["step"]}, updates {first_run["updates"]} equal; '
              f'worst relative difference {worst[0]:.3g} ({worst[1]}); on {smi}', flush=True)
        out['resume_worst'] = worst[0]

        # (c) real schema: WaymoDataset with instance paste and PolarMix
        tree = os.path.join(tmp, 'tree')
        make_tree(tree, 2, N_POINTS)
        hist_c, secs = timed(train_tool.main, [
            '--cfg_file', os.path.join(REPO, 'configs', 'waymo_one_sweep.yaml'),
            '--data_dir', tree, '--batch_size', '1', '--epochs', '1', '--num_workers', '2',
            '--no_validate', '--log_iter_interval', '1', '--seed', '0',
            '--save_dir', os.path.join(tmp, 'c')])
        losses_c = [r[3] for r in hist_c['train']]
        print(f'(c) real schema: {len(losses_c)} steps through WaymoDataset in {secs:.1f} s, '
              f'losses {losses_c}; on {smi}', flush=True)
        assert len(losses_c) == 2 and all(math.isfinite(x) for x in losses_c), losses_c

        # (d) evaluation of (a)'s checkpoints
        base = ['--cfg_file', acc_cfg, '--synthetic', '--save_dir', a_dir]
        res_d, secs = timed(eval_tool.main, base + ['--synthetic_frames', '4', '--no_tta'])
        res_t, secs_t = timed(eval_tool.main, base + ['--synthetic_frames', '1',
                                                      '--tta_batch', '2', '--tta_workers', '4'])
        print(f'(d) eval: no TTA, 4 frames, mIoU {res_d["mIOU"]:.4f} in {secs:.1f} s; 36-variant '
              f'host TTA, 1 frame, mIoU {res_t["mIOU"]:.4f} in {secs_t:.1f} s; on {smi}',
              flush=True)
        assert math.isfinite(res_d['mIOU']) and math.isfinite(res_t['mIOU'])
        assert int(res_d['hist'].sum()) == 4 * N_POINTS and int(res_t['hist'].sum()) == N_POINTS
        counters['B1'].launches = 0
        res_v, secs_v = timed(eval_tool.main, base + ['--synthetic_frames', '1', '--tta_device',
                                                      '--tta_batch', '1'])
        b1 = counters['B1'].launches
        print(f'(d) --tta_device, 1 frame: mIoU {res_v["mIOU"]:.4f} (host TTA '
              f'{res_t["mIOU"]:.4f}) in {secs_v:.1f} s, {b1} B1 launches; on {smi}', flush=True)
        assert math.isfinite(res_v['mIOU']) and int(res_v['hist'].sum()) == N_POINTS
        assert b1 == 36 * per_step, b1
        out['eval'] = dict(no_tta=res_d['mIOU'], tta=res_t['mIOU'], tta_device=res_v['mIOU'],
                           no_tta_s=secs, tta_s=secs_t, tta_device_s=secs_v)
    return out


def model_counters():
    """{kernel: its wrapper}, each with the .launches counter its wrapper
    adds one to where it launches the kernel: the attention kernels, the
    1-NN, and the sparse conv's gather-GEMM (S1) and weight gradient (S2)."""
    from openseg3d_tpu_torch.ops.attention import (window_attention_packed,
                                                   window_attention_train_backward,
                                                   window_attention_train_forward)
    from openseg3d_tpu_torch.ops.knn import nearest_point
    from openseg3d_tpu_torch.ops.sparse_conv import gather_gemm, weight_grad
    return {'B1': window_attention_packed, 'B2f': window_attention_train_forward,
            'B2b': window_attention_train_backward, 'B3': nearest_point,
            'S1': gather_gemm, 'S2': weight_grad}


def model_convs(cfg):
    """The sparse convs of cfg's model: its [27, Cin, Cout] kernels (the
    model built on the host)."""
    from openseg3d_tpu_torch.engine import build_segmentor
    model, _ = build_segmentor(cfg, device='cpu')
    return sum(p.ndim == 3 and p.shape[0] == 27 for p in model.parameters())


def conv_launches(cfg, forwards=0, steps=0):
    """{'S1': ..., 'S2': ...}, the sparse-conv kernels' launches in
    `forwards` eval forwards and `steps` train steps of cfg's bf16 model: a
    gather-GEMM a conv in every forward, and in a step's backward one more
    (dx: every conv's input needs its gradient) and one weight gradient."""
    n = model_convs(cfg)
    return {'S1': n * (forwards + 2 * steps), 'S2': n * steps}


def check_host_voxelizer(smi):
    """The host voxelizer: the C++ path (openseg3d_tpu_torch/native, built
    with g++) must be taken here, and the frames of the reference files
    (the bench frame and the 3-sweep frame), voxelized on it, must have the
    digests recorded in the files, which were written on another host: the
    same ids and coords to the bit. Times the C++ and the numpy path on the
    bench cloud (host ms, median of 5)."""
    import numpy as np
    from openseg3d_tpu_torch import native, parity
    from openseg3d_tpu_torch.core.voxelizer import points_to_voxel
    from openseg3d_tpu_torch.data.synthetic import bench_cloud
    assert native.available(), f'the C++ voxelizer did not build: {native.build_error()}'
    print(f'host voxelizer: native (C++, {native.library_path().relative_to(REPO)})', flush=True)
    frames = {}
    for name in ('waymo_one_sweep', 'waymo_multi_sweeps'):
        ref = parity.load_reference(name)
        cfg = parity.reference_config(name)
        batch = parity.reference_frame(cfg, parity.REFERENCES[name][2])
        got = parity.batch_digests(batch)
        want = dict(zip(ref['batch_keys'], ref['batch_digests']))
        assert got == want, {k: (got.get(k), want.get(k)) for k in set(got) | set(want)
                             if got.get(k) != want.get(k)}
        frames[name] = int(batch['voxel_mask'].sum())
    cfg = parity.reference_config('waymo_one_sweep')
    pts = bench_cloud(cfg, N_POINTS)['points']
    vs, rg = cfg.DATASET.VOXEL_SIZE, cfg.DATASET.POINT_CLOUD_RANGE
    ms = {}
    for label, fn in (('native', native.native_points_to_voxel), ('numpy', points_to_voxel)):
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn(pts, vs, rg)
            times.append((time.perf_counter() - t0) * 1e3)
        ms[label] = statistics.median(times)
    a, b = native.native_points_to_voxel(pts, vs, rg), points_to_voxel(pts, vs, rg)
    moved = int((a[1] != b[1]).sum())
    print(f'host voxelizer: the reference frames\' ids and coords equal the files\' '
          f'(live voxels {frames}); the bench cloud ({N_POINTS} points) in '
          f'{ms["native"]:.2f} ms native, {ms["numpy"]:.2f} ms numpy (host, median of 5; '
          f'{moved} point ids differ between the two paths), on {smi}', flush=True)
    return ms


def check_references(smi):
    """Phase A: the port on the card against each reference file of the
    JAX package's eval step (parity.EVAL_REFERENCES), in float32 (B1's FMA
    body) and in bfloat16, with parity.compare_with_reference's gates (it
    raises on a failed one); then its float32 train step against each
    train reference (parity.TRAIN_REFERENCES: the JAX package's full-size
    train step, B2f and B2b's FMA bodies here) with
    parity.compare_with_train_reference's gates. Returns ({name: {dtype:
    measured numbers}}, {name: the train step's numbers})."""
    import gc
    import torch
    from openseg3d_tpu_torch import parity
    out, train = {}, {}
    for name in parity.EVAL_REFERENCES:
        t0 = time.perf_counter()
        out[name] = res = parity.check_reference(name, ('float32', 'bfloat16'), 'cuda')
        for dtype, m in res.items():
            print(f'(A) {name} {dtype}: argmax agreement {m["agreement"]:.6f} ({m["disagreeing"]} '
                  f'points differ), sampled '
                  f'logits {m["logit_err"]:.3g} x max(1, max|logit|) (point '
                  f'{m["point_logit_err"]:.3g}, voxel {m["voxel_logit_err"]:.3g}, aux '
                  f'{m["aux_logit_err"]:.3g}; max|logit| {m["max_abs_logit"]:.4g}), histogram L1 '
                  f'{m["hist_l1"]}, loss {m["loss"]:.6g} vs {m["ref_loss"]:.6g} (rel '
                  f'{m["loss_rel"]:.3g}), class sums {m["class_sum_rel"]:.3g}, aux coords and '
                  f'mask equal {m["aux_equal"]}; gates {m["gates"]}', flush=True)
        print(f'(A) {name}: {time.perf_counter() - t0:.1f} s', flush=True)
    for name in parity.TRAIN_REFERENCES:
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        train[name] = m = parity.check_train_reference(name, 'cuda')
        print(f'(A) {name} float32 train step: loss {m["loss"]:.7g} vs {m["ref_loss"]:.7g} (rel '
              f'{m["loss_rel"]:.3g}); {m["leaves"]} gradient and BatchNorm leaves, worst '
              f'{m["worst"]} at {m["worst_ratio"]:.3g} of its gate ({m["worst_err"]:.3g} of '
              f'{m["worst_gate"]:.3g}); over half their gate: {m["over_half"] or "none"}; the '
              f'step {m["seconds"]:.1f} s, the check {time.perf_counter() - t0:.1f} s, on {smi}',
              flush=True)
    return out, train


def run_variant(label, cfg, batch, smi, timed=True, index_adds=None):
    """Phases C and D: one configuration's full-width, full-capacity bf16
    eval forward and train step on `batch` (seeded random weights). Checks
    finite logits and loss, the histogram's count, finite gradients, the
    kernels' launches as the configuration implies (B1 once per attention
    layer and level in the eval step, B2f and B2b so in the train step, B3
    once in the train step) and one gather-only backward per sparse conv
    (the OCR transform's included) and two permute_rows backwards per
    encoder layer; with `timed`, the median forward and step ms, peak memory,
    the device-busy share of one profiled forward and step, and the step's
    bf16 index_add_ kernels: at most one (the devoxelize gather's backward),
    or exactly `index_adds` where it is given. Returns a dict of the
    numbers."""
    import torch
    from openseg3d_tpu_torch.engine import (TrainState, build_segmentor, make_eval_step,
                                            make_forward, make_train_step)
    from openseg3d_tpu_torch.models.backbones.point_transformer import stage_level_specs
    from openseg3d_tpu_torch.models.ocr import OCRLayer
    from openseg3d_tpu_torch.models.optim import build_optimizer, build_schedule
    from openseg3d_tpu_torch.models.sparse_modules import SparseConv
    from openseg3d_tpu_torch.ops.sparse_conv import apply_sparse_conv
    from openseg3d_tpu_torch.ops.window import permute_rows
    from openseg3d_tpu_torch.weights import init_weights

    counters = model_counters()
    model, spec = build_segmentor(cfg, batch['points'].device)
    init_weights(model, torch.Generator().manual_seed(0))
    segformer = cfg.MODEL.SEGMENTOR == 'segformer'
    attention = (sum(d * len(lv) for d, lv in zip(spec.depths, stage_level_specs(spec)))
                 if segformer else 0)
    convs = sum(isinstance(m, (SparseConv, OCRLayer)) for m in model.modules())
    assert convs == model_convs(cfg), convs
    valid = batch['point_mask'] & batch['cur_point_mask']
    out = dict(points=int(valid.sum()), history=int((batch['point_mask'] & ~valid).sum()),
               voxels=int(batch['voxel_mask'].sum()), convs=convs)

    for c in counters.values():
        c.launches = 0
    res = make_eval_step(cfg, spec, model)(batch)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    assert launches == {'B1': attention, 'B2f': 0, 'B2b': 0, 'B3': 0, 'S1': convs,
                        'S2': 0}, launches
    logits = res['point_out']
    assert bool(torch.isfinite(logits).all()), label
    assert int(res['hist'].sum()) == out['points'], (int(res['hist'].sum()), out['points'])
    assert not logits[~valid].any(), label            # logits only for current points

    state = TrainState(model, build_optimizer(cfg, model.parameters()),
                       build_schedule(cfg, 30, 1000))
    step = make_train_step(cfg, spec)
    for c in counters.values():
        c.launches = 0
    apply_sparse_conv.backwards = permute_rows.backwards = 0
    state, m = step(state, batch, seed=0)
    torch.cuda.synchronize()
    train_launches = {k: c.launches for k, c in counters.items()}
    backwards = (apply_sparse_conv.backwards, permute_rows.backwards)
    print(f'({label}) {out["points"]} current points ({out["history"]} history), '
          f'{out["voxels"]} voxels; eval launches {launches}; train step launches '
          f'{train_launches}, gather-only backwards (conv, permute_rows) {backwards}, model '
          f'convs {convs}; loss {float(m["loss"]):.6g}', flush=True)
    assert train_launches == {'B1': 0, 'B2f': attention, 'B2b': attention, 'B3': 1,
                              'S1': 2 * convs, 'S2': convs}, train_launches
    assert backwards == (convs, 2 * sum(spec.depths) if segformer else 0), backwards
    assert m['grads_finite'] and bool(torch.isfinite(m['loss'])), m
    out.update(eval_launches=launches, train_launches=train_launches, backwards=backwards,
               loss=float(m['loss']))
    if not timed:
        return out

    forward = make_forward(model)
    forward(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fwd = [cuda_ms(lambda: forward(batch), 1) for _ in range(5)]
    fwd_peak = torch.cuda.max_memory_allocated()
    events, wall = trace(lambda: forward(batch))
    fwd_busy = busy_ms(events) / wall
    print(f'({label}) profiled forward, kernels with the most device time (name, ms, count): '
          f'{top_kernels(events, 6)}', flush=True)
    torch.cuda.reset_peak_memory_stats()
    steps = [cuda_ms(lambda i=i: step(state, batch, seed=i), 1) for i in range(1, 5)]
    step_peak = torch.cuda.max_memory_allocated()
    events, wall = trace(lambda: step(state, batch, seed=5))
    step_busy = busy_ms(events) / wall
    print(f'({label}) profiled step, kernels with the most device time (name, ms, count): '
          f'{top_kernels(events, 8)}', flush=True)
    index_add_bf16 = named_kernels(events, 'indexFuncLargeIndex', 'BFloat16')
    if index_adds is None:
        assert index_add_bf16[1] <= 1, index_add_bf16
    else:
        assert index_add_bf16[1] == index_adds, (index_add_bf16, index_adds)
    out.update(forward_ms=statistics.median(fwd), forward_peak=fwd_peak, forward_busy=fwd_busy,
               step_ms=statistics.median(steps[1:]), step_peak=step_peak, step_busy=step_busy,
               index_add_bf16=index_add_bf16)
    print(f'({label}) eval forward ms {[round(x, 2) for x in fwd]} (median '
          f'{out["forward_ms"]:.2f}), peak {fwd_peak / 2**30:.2f} GiB, device busy '
          f'{fwd_busy:.3f} of a profiled forward; train step ms {[round(x, 2) for x in steps]} '
          f'(median after the first {out["step_ms"]:.2f}), peak {step_peak / 2**30:.2f} GiB, '
          f'device busy {step_busy:.3f} of a profiled step; bf16 index_add_ (ms, launches) '
          f'{index_add_bf16}; on {smi}', flush=True)
    return out


def degenerate_cloud(rng, n, rg):
    """tools/repro_nan_dw.py's cloud: the old cylinder generator's
    geometry, cartesian spans computed from the (rho, phi, z) range, which
    packs the frame into a ~3 m disk (a numpy copy, so that the port runs it
    without the JAX package)."""
    import numpy as np
    span = (rg[3:5] - rg[0:2]) / 2 * 0.95
    zlo, zhi = rg[2] * 0.95, rg[5] * 0.95
    n_ground = int(n * 0.55)
    r = np.sqrt(rng.uniform(1.0, (min(span) * 0.98) ** 2, n_ground))
    th = rng.uniform(-np.pi, np.pi, n_ground)
    gx, gy = r * np.cos(th), r * np.sin(th)
    gz = np.full(n_ground, zlo + 0.05) + rng.normal(0, 0.02, n_ground)
    n_obj = n - n_ground
    ox = rng.uniform(-min(span), min(span), n_obj)
    oy = rng.uniform(-min(span), min(span), n_obj)
    oz = rng.uniform(zlo, zhi, n_obj)
    xyz = np.stack([np.concatenate([gx, ox]), np.concatenate([gy, oy]),
                    np.concatenate([gz, oz])], axis=1).astype(np.float32)
    feats = rng.randn(n, 3).astype(np.float32)
    return np.concatenate([xyz, feats], axis=1)


def nan_repro(smi):
    """The bf16 NaN-gradient repro of tools/repro_nan_dw.py through the
    port: its degenerate cylinder cloud (163840 points, voxel capacity
    98304), full width, 5 bf16 train steps from seeded weights.
    Printed, not gated: each step's loss, its count of non-finite gradient
    leaves and whether the guard skipped its update. Returns [(loss,
    non-finite leaves, skipped)]."""
    import numpy as np
    import torch
    from openseg3d_tpu_torch.config import cfg_from_file
    from openseg3d_tpu_torch.engine import TrainState, build_segmentor, make_train_step
    from openseg3d_tpu_torch.models.optim import build_optimizer, build_schedule
    from openseg3d_tpu_torch.weights import init_weights
    cfg = cfg_from_file(os.path.join(REPO, 'configs', 'waymo_one_sweep_cylinder.yaml'),
                        overrides={'RUNTIME': {'MAX_POINTS_PER_SAMPLE': N_POINTS,
                                               'MAX_VOXELS_PER_SAMPLE': 98304}})
    rng = np.random.RandomState(0)
    cloud = degenerate_cloud(rng, N_POINTS, np.asarray(cfg.DATASET.POINT_CLOUD_RANGE, np.float32))
    batch, n_voxels = frame_batch(cfg, 'cuda', cloud)
    model, spec = build_segmentor(cfg, 'cuda')
    init_weights(model, torch.Generator().manual_seed(0))
    state = TrainState(model, build_optimizer(cfg, model.parameters()),
                       build_schedule(cfg, 30, 1000))
    step = make_train_step(cfg, spec)
    rows, steps = [], 5
    for i in range(steps):
        state, m = step(state, batch, seed=i)
        bad = [k for k, p in model.named_parameters()
               if p.grad is not None and not bool(torch.isfinite(p.grad).all())]
        rows.append((float(m['loss']), len(bad), not m['grads_finite']))
        print(f'(NaN repro) degenerate cylinder cloud, {n_voxels} voxels, step {i}: loss '
              f'{rows[-1][0]:.6g}, non-finite gradient leaves {len(bad)} {bad[:4]}, update '
              f'skipped by the guard: {rows[-1][2]}', flush=True)
    print(f'(NaN repro) {"REPRODUCED" if any(r[1] for r in rows) else "NOT REPRODUCED"} over '
          f'{steps} bf16 steps on {smi}', flush=True)
    return rows


def run_spnet_learning(smi):
    """Phase D: tools.train on configs/synthetic_accuracy_spnet.yaml (full
    width and capacity, bf16) as phase 7a: 32 synthetic frames, batch 1, 4
    epochs, validation every 2: finite losses, the last epoch's mean logged
    loss below the first's, final validation mIoU >= 0.15, and B3 launched
    once per train step and validation frame (SPNet has no attention), the
    sparse-conv kernels as conv_launches counts them."""
    import math
    import torch
    from openseg3d_tpu_torch.config import cfg_from_file
    from openseg3d_tpu_torch.tools import train as train_tool
    frames, epochs = 32, 4
    cfg_file = os.path.join(REPO, 'configs', 'synthetic_accuracy_spnet.yaml')
    counters = model_counters()
    for c in counters.values():
        c.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        hist = train_tool.main([
            '--cfg_file', cfg_file,
            '--synthetic', '--synthetic_frames', str(frames), '--batch_size', '1',
            '--epochs', str(epochs), '--eval_epoch_interval', '2', '--num_workers', '4',
            '--log_iter_interval', '4', '--seed', '100', '--save_dir', tmp])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    steps = frames * epochs
    val_frames = max(frames // 4, 2) * (epochs // 2)
    launches = {k: c.launches for k, c in counters.items()}
    want = {'B1': 0, 'B2f': 0, 'B2b': 0, 'B3': steps + val_frames,
            **conv_launches(cfg_from_file(cfg_file), val_frames, steps)}
    losses = {e: [r[3] for r in hist['train'] if r[0] == e] for e in range(1, epochs + 1)}
    first, last = statistics.mean(losses[1]), statistics.mean(losses[epochs])
    mious = [m for _, m in hist['val']]
    step_ms = statistics.median(r[4] for r in hist['train'] if r[0] > 1)
    print(f'(D) SPNet learning run: {steps} steps + {val_frames} validation frames in {secs:.1f} '
          f's; launches {launches} (expected {want}); mean logged loss epoch 1 {first:.4f} -> '
          f'epoch {epochs} {last:.4f}; validation mIoU {mious}; median step {step_ms:.1f} ms '
          f'after epoch 1; skipped updates {hist["skipped"]}; on {smi}', flush=True)
    assert launches == want, (launches, want)
    assert all(math.isfinite(x) for v in losses.values() for x in v), losses
    assert last < first, (first, last)
    assert mious[-1] >= 0.15, mious
    return dict(first_loss=first, last_loss=last, mious=mious, step_ms=step_ms, seconds=secs)


def run_rehearsal(smi, image_feature_dim=None):
    """Phase B: python -m openseg3d_tpu_torch.tools.rehearsal (2 frames of
    the bench cloud on a tree in the offline parser's format with a
    test-set frame list, data/synthetic.make_tree, at full width and the
    production capacities): tools.train for 2 steps on
    configs/waymo_one_sweep.yaml, tools.eval --no_tta, then tools.test with
    OPENSEG3D_ALLOW_WOD_STUB=1, each in its own process. The decoded
    submission holds every testing frame, and each frame's range images
    equal the eval forward's argmax over its current points (the newest
    checkpoint's weights) scattered through points_ri. With
    image_feature_dim: a config with DATASET.USE_IMAGE_FEATURE passed as
    --cfg_file on a tree with image_feature/ files (synthetic), so DeepFusion
    trains, evaluates and serves; the checkpoint must hold its leaves; then
    on the same tree 2 epochs with --deterministic and the augmentation off,
    and epoch 2 resumed from epoch_1.pt must end as the uninterrupted run
    did (as 7b: the same counts, every tensor within 1e-6 of the other's
    largest)."""
    import numpy as np
    import torch
    from openseg3d_tpu_torch.config import cfg_from_file
    from openseg3d_tpu_torch.data.batch import collate_padded, to_device
    from openseg3d_tpu_torch.data.synthetic import make_tree
    from openseg3d_tpu_torch.data.waymo_dataset import WaymoDataset
    from openseg3d_tpu_torch.engine import build_segmentor, make_forward
    from openseg3d_tpu_torch.tools import rehearsal
    from openseg3d_tpu_torch.tools import train as train_tool
    from openseg3d_tpu_torch.utils import wod_stub
    from openseg3d_tpu_torch.utils.checkpoint import latest_checkpoint, load_model
    from openseg3d_tpu_torch.utils.submission import assemble_range_image_labels
    cfg_file = os.path.join(REPO, 'configs', 'waymo_one_sweep.yaml')
    n_frames, device = 2, 'cuda'
    with tempfile.TemporaryDirectory() as tmp:
        if image_feature_dim:
            import yaml
            with open(cfg_file) as f:
                text = yaml.safe_load(f)
            text['DATASET'].update(USE_IMAGE_FEATURE=True, DIM_IMAGE_FEATURE=image_feature_dim)
            cfg_file = os.path.join(tmp, 'image.yaml')
            with open(cfg_file, 'w') as f:
                yaml.safe_dump(text, f)
        work = os.path.join(tmp, 'rehearsal')
        t0 = time.perf_counter()
        if image_feature_dim:
            # the same tree with image_feature/ files: the tool's make_tree
            # writes the lidar, label and pose files again, alike, and leaves
            # the image features in place
            make_tree(os.path.join(work, 'data'), n_frames, N_POINTS,
                      image_feature_dim=image_feature_dim)
        res = rehearsal.main(['--work_dir', work, '--frames', str(n_frames),
                              '--n_points', str(N_POINTS), '--cfg_file', cfg_file])
        tree, save, names, losses = res['data_dir'], res['save_dir'], res['names'], res['losses']
        assert len(losses) == n_frames and all(np.isfinite(losses)), losses
        assert np.isfinite(res['miou']), res
        secs = time.perf_counter() - t0
        resumed = ''
        if image_feature_dim:
            # resume as 7b, with the augmentation off: its draws come from the
            # global np.random, which a resumed run starts afresh
            text['DATASET']['AUG_DATA'] = False
            det_cfg, det = os.path.join(tmp, 'no_aug.yaml'), os.path.join(tmp, 'det')
            with open(det_cfg, 'w') as f:
                yaml.safe_dump(text, f)
            argv = ['--cfg_file', det_cfg, '--data_dir', tree, '--batch_size', '1',
                    '--epochs', '2', '--num_workers', '0', '--no_validate',
                    '--log_iter_interval', '1', '--seed', '0', '--deterministic',
                    '--save_dir', det]
            train_tool.main(argv)
            path = os.path.join(det, 'epoch_2.pt')
            first_run = torch.load(path, map_location='cpu', weights_only=True)
            os.remove(path)
            hist_r = train_tool.main(argv + ['--auto_resume'])
            assert [r[0] for r in hist_r['train']] == [2] * n_frames, hist_r['train']
            worst = assert_close_payloads(torch.load(path, map_location='cpu',
                                                     weights_only=True), first_run, 1e-6)
            resumed = (f'; 2 epochs without augmentation, epoch 2 resumed with '
                       f'--deterministic: worst relative difference {worst[0]:.3g} ({worst[1]})')
        held = [k for k in torch.load(latest_checkpoint(save), map_location='cpu',
                                      weights_only=True)['model'] if 'DeepFusionBlock_0' in k]
        assert len(held) == (6 if image_feature_dim else 0), held
        method, frames = wod_stub.read_submission(res['submission'])
        cfg = cfg_from_file(cfg_file)
        model, _ = build_segmentor(cfg, device)
        forward = make_forward(load_model(latest_checkpoint(save), model))
        dataset = WaymoDataset(cfg, tree, 'testing')
        assert dataset.filenames == names and len(frames) == len(names), (names, len(frames))
        labelled = 0
        for i, (ctx, ts, lasers) in enumerate(frames):
            raw = dataset[i]
            file_idx, _, stamp = dataset.parse_filename(raw['filename'])
            assert (ctx, ts) == (file_idx, stamp), (ctx, ts, file_idx, stamp)
            b = collate_padded([dataset.pad(raw)])
            mask = b['point_mask'][0] & b['cur_point_mask'][0]
            preds = forward(to_device(b, device))[0].argmax(dim=-1).cpu().numpy()
            want = assemble_range_image_labels(preds[mask], b['points_ri'][0][mask])
            assert np.array_equal(lasers[0][1], want[0]) and np.array_equal(lasers[0][2], want[1])
            labelled += int((want[0][..., 1] > 0).sum() + (want[1][..., 1] > 0).sum())
        assert labelled == n_frames * N_POINTS, labelled     # a pixel per current point
    print(f'(B) rehearsal{" with image features" if image_feature_dim else ""} through '
          f'tools.rehearsal: train {len(losses)} steps (losses {losses}){resumed}, checkpoint '
          f'DeepFusion tensors {len(held)}, eval mIoU {res["miou"]:.4f}, test: {len(frames)} '
          f'frames submitted ({method}, {res["size"]} bytes), {labelled} range-image pixels '
          f'labelled, each frame equal to the eval forward\'s argmax; the three tools '
          f'{secs:.1f} s on {smi}', flush=True)
    return dict(losses=losses, miou=res['miou'], frames=len(frames), seconds=secs)


def run_device_tta(cfg, smi, per_forward):
    """Phase E: device TTA on the bench frame at full width and capacity,
    bf16, seeded random weights. The 36 variants (3 scales x 3 angles x
    flip_x x flip_y) of the raw cloud, padded to MAX_POINTS_PER_SAMPLE:
      * each variant's device_voxelize on the card bit-equal (coords, mask,
        ids, count) to the same function's plain run on the CPU on the same
        transformed points; the points whose voxel differs from the host
        path's (_prepare_variant and the host voxelizer, whose
        float64-then-float32 rotation may move a point across a voxel
        boundary) at most TTA_VOXEL_DIFFER a variant;
      * one frame of host TTA (inline: _prepare_variant, one forward a
        variant) and of device TTA (tools/eval.tta_device_group, --tta_batch
        1), each timed with its argmax read back; B1 launched
        per_forward x 36 times by the device TTA; their argmax agreement over
        the points both score at least TTA_AGREEMENT.
    Returns a dict of the numbers."""
    import numpy as np
    import torch
    from openseg3d_tpu_torch.data.batch import to_device
    from openseg3d_tpu_torch.data.synthetic import SyntheticDataset, bench_cloud
    from openseg3d_tpu_torch.data.test_time_aug import MultiScaleFlipAug, _prepare_variant
    from openseg3d_tpu_torch.engine import build_segmentor, make_forward
    from openseg3d_tpu_torch.ops.attention import window_attention_packed
    from openseg3d_tpu_torch.ops.voxelize import device_voxelize
    from openseg3d_tpu_torch.tools.eval import (transform_variants, tta_device_group,
                                                variant_params)
    from openseg3d_tpu_torch.weights import init_weights

    raw = bench_cloud(cfg, N_POINTS)            # the bench frame's raw cloud and labels
    cloud = raw['points']
    dataset = SyntheticDataset(cfg, 1, mode='validation')      # the host path's voxelize, pad
    tta = MultiScaleFlipAug(dataset, scales=[0.95, 1.0, 1.05],
                            angles=[-np.pi / 4, 0.0, np.pi / 4], flip_x=True, flip_y=True)
    variants = list(tta._variant_params())
    p_cap, v_cap = int(cfg.RUNTIME.MAX_POINTS_PER_SAMPLE), int(cfg.RUNTIME.MAX_VOXELS_PER_SAMPLE)
    vs, pr = cfg.DATASET.VOXEL_SIZE, cfg.DATASET.POINT_CLOUD_RANGE
    points1 = torch.zeros((p_cap, cloud.shape[1]), device='cuda')
    points1[:N_POINTS] = torch.from_numpy(cloud).cuda()
    pmask1 = torch.arange(p_cap, device='cuda') < N_POINTS
    params = torch.from_numpy(variant_params(tta)).cuda()
    model, spec = build_segmentor(cfg, 'cuda')
    init_weights(model, torch.Generator().manual_seed(0))
    forward = make_forward(model)

    def point_coords(coords, ids):
        """[P, 3] each point's voxel coords, -1 where it has none."""
        return torch.where((ids >= 0)[:, None], coords[ids.clamp(min=0).long()], -1)

    # host TTA, inline
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc, host_coords = None, []
    for scale, angle, fx, fy in variants:
        b = _prepare_variant(dataset, raw, scale, angle, fx, fy)
        ps = torch.softmax(forward(to_device(b, 'cuda')).float(), dim=-1).sum(dim=0)
        acc = ps if acc is None else acc + ps
        host_coords.append((b['voxel_coords'][0], b['point_voxel_ids'][0]))
    host_preds = acc.argmax(dim=-1).cpu().numpy()
    host_s = time.perf_counter() - t0
    host_mask = b['point_mask'][0] & b['cur_point_mask'][0]

    # device TTA, --tta_batch 1
    window_attention_packed.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc = None
    for i in range(len(variants)):
        ps = tta_device_group(model, spec, points1, pmask1, params[i:i + 1], v_cap)
        acc = ps if acc is None else acc + ps
    dev_preds = acc.argmax(dim=-1).cpu().numpy()
    dev_s = time.perf_counter() - t0
    launches = window_attention_packed.launches
    both = host_mask & pmask1.cpu().numpy()
    agreement = float((dev_preds[both] == host_preds[both]).mean())

    # every variant's voxelization: card against the CPU, and against the host path
    differ, voxels = [], []
    for i in range(len(variants)):
        pts = transform_variants(points1, params[i:i + 1])
        got = device_voxelize(pts, pmask1[None], vs, pr, v_cap)
        want = device_voxelize(pts.cpu(), pmask1[None].cpu(), vs, pr, v_cap)
        for name, g, w in zip(('coords', 'mask', 'ids', 'num_voxels'), got, want):
            assert torch.equal(g.cpu(), w), (i, variants[i], name)
        voxels.append(int(got[3][0]))
        hc, hi = (torch.from_numpy(a) for a in host_coords[i])
        dev = point_coords(got[0][0].cpu(), got[2][0].cpu())
        differ.append(int((dev != point_coords(hc, hi)).any(dim=-1).sum()))
    print(f'(E) device_voxelize on the card bit-equal to its CPU run on all {len(variants)} '
          f'variants; voxels per variant {min(voxels)}-{max(voxels)} (capacity {v_cap}); points '
          f'whose voxel differs from the host path: {differ} (total {sum(differ)} of '
          f'{len(variants) * N_POINTS}; gate {TTA_VOXEL_DIFFER} a variant)', flush=True)
    print(f'(E) one frame: host TTA (inline) {host_s:.2f} s, device TTA {dev_s:.2f} s; B1 '
          f'launches {launches} (expected {36 * per_forward}); argmax agreement {agreement:.6f} '
          f'over {int(both.sum())} points (gate {TTA_AGREEMENT}); on {smi}', flush=True)
    assert launches == 36 * per_forward, launches
    assert agreement >= TTA_AGREEMENT, agreement
    assert max(differ) <= TTA_VOXEL_DIFFER, differ
    return dict(host_s=host_s, device_s=dev_s, agreement=agreement, launches=launches,
                differ=sum(differ), voxels=(min(voxels), max(voxels)))


def knn_shell(spec, batch, smi):
    """Phase F: the share of the frame's valid points whose candidate shell
    (DeepFusion's voxel-bucket k-NN, kernel FUSION_KNN_KERNEL_SIZE, bucket
    FUSION_KNN_BUCKET_CAP) yields fewer than 8 and 16 neighbours, by range
    band (NOTES_NEXT.md's table), and the search's device ms. Printed."""
    import torch
    from openseg3d_tpu_torch.models.deep_fusion import N_NEIGHBORS
    from openseg3d_tpu_torch.ops.knn import voxel_bucket_knn
    cur = batch['point_mask'] & batch['cur_point_mask']

    def search():
        return voxel_bucket_knn(N_NEIGHBORS, batch['points'][..., :3].contiguous(), cur, cur,
                                batch['point_voxel_ids'], batch['voxel_coords'],
                                spec.spatial_shape, bucket_cap=spec.fusion_knn_bucket_cap,
                                kernel_size=spec.fusion_knn_kernel_size)[0]
    ids = search()
    ms = device_ms(search, 3)
    found = (ids >= 0).sum(dim=-1)[cur]
    rng = batch['points'][..., :2].norm(dim=-1)[cur]
    rows = []
    for lo, hi in ((0, 20), (20, 40), (40, 75)):
        sel = (rng >= lo) & (rng < hi)
        share = [round(float((found[sel] < k).float().mean()), 3) for k in (8, 16)]
        rows.append((f'{lo}-{hi} m', int(sel.sum()), *share))
    print(f'(F) DeepFusion candidate shell: (range, points, share < 8, share < 16) {rows}; '
          f'voxel-bucket k-NN {ms:.3f} ms of device time; on {smi}', flush=True)
    return rows, ms


# ---------------------------------------------------------------------------
# phase G: data-parallel training (parallel/dist.py) and the last modules
# ---------------------------------------------------------------------------

DP_WORLD = 2
DP_POINTS = 32768            # G1(a): two frames of this many points, the caps cut to match
DP_CAPS = {'MAX_POINTS_PER_SAMPLE': 32768, 'MAX_VOXELS_PER_SAMPLE': 32768}
DP_TOL = 1e-4                # G1(a): loss relative; each leaf x (1 + its largest magnitude)
# G1(a): a float64 witness of the step (dp_float64) measures how far the
# one-process float32 gradient itself lies from the exact one. Each leaf of
# the two-rank float32 gradient may differ from the one-process leaf by
# DP_TOL plus that distance, as it does when it lies within DP_TOL of the
# exact leaf (triangle inequality): the cancelling attention out_proj.bias
# sums put the one-process float32 step itself up to ~4e-4 off there.
# Over the tree, the two ranks within this factor of the one-process step
# with its frames swapped:
DP_NOISE_FACTOR = 2.0
# G1(a): the float64 two-rank step against the float64 one-process step, each
# leaf x (1 + its largest magnitude): the same function
DP_FLOAT64_TOL = 1e-9
DP_BF16_LOSS_RTOL = 1e-2     # G1(b): the bf16 loss against the one-process B = 2 step
FPS_SAMPLES = 4096


def set_dropout_off(model):
    """Every dropout and drop-path rate of the model at 0; returns what
    restores them."""
    saved = []
    for m in model.modules():
        for attr in ('attn_drop', 'drop', 'drop_path', 'attn_pdrop'):
            if isinstance(getattr(m, attr, None), float):
                saved.append((m, attr, getattr(m, attr)))
                setattr(m, attr, 0.0)
    return saved


def dp_configs(dtype='float32'):
    """(G1(a): `dtype`, full width, the caps cut for DP_POINTS and no drop
    path; G1(b): the default config, bf16 at full capacity)."""
    from openseg3d_tpu_torch.config import cfg_from_file
    path = os.path.join(REPO, 'configs', 'waymo_one_sweep.yaml')
    return (cfg_from_file(path, overrides={'RUNTIME': {**DP_CAPS, 'COMPUTE_DTYPE': dtype},
                                           'MODEL': {'DROP_PATH_RATE': 0.0}}),
            cfg_from_file(path))


def dp_frames(cfg, n_points):
    """Every rank's frame, in rank order: rank r takes bench_frame from seed
    r, so rank 0 the bench frame (numpy, B = 1 each)."""
    from openseg3d_tpu_torch.data.synthetic import bench_frame
    return [bench_frame(cfg, n_points, seed=r) for r in range(DP_WORLD)]


def dp_state(cfg, device):
    """The train state from the seeded weights every G1 run starts from."""
    import torch
    from openseg3d_tpu_torch.engine import TrainState, build_segmentor
    from openseg3d_tpu_torch.models.optim import build_optimizer, build_schedule
    from openseg3d_tpu_torch.weights import init_weights
    model, spec = build_segmentor(cfg, device)
    init_weights(model, torch.Generator().manual_seed(0))
    return TrainState(model, build_optimizer(cfg, model.parameters()),
                      build_schedule(cfg, 30, 1000)), spec


def dp_one_process(cfg, frames, device):
    """One process on the ranks' frames as one B = 2 batch, dropout off:
    (loss, {name: gradient}, {name: parameter or statistic after}) on the
    host."""
    import numpy as np
    import torch
    from openseg3d_tpu_torch.data.batch import to_device
    from openseg3d_tpu_torch.engine import make_train_step
    state, spec = dp_state(cfg, device)
    set_dropout_off(state.model)
    batch = to_device({k: np.concatenate([f[k] for f in frames]) for k in frames[0]
                       if k != 'batch_size'}, device)
    state, m = make_train_step(cfg, spec)(state, batch, seed=0)
    assert m['grads_finite'], 'one-process B = 2 step'
    out = (float(m['loss']), {k: p.grad.float().cpu() for k, p in state.model.named_parameters()},
           {k: v.float().cpu() for k, v in state.model.state_dict().items()})
    del state, batch
    torch.cuda.empty_cache()
    return out


def scaled_err(got, want):
    """max |got - want| over 1 + the largest |want|."""
    return float((got - want).abs().max()) / (1.0 + float(want.abs().max()))


def tree_err(got, want):
    """|got - want| / |want| over every leaf of {name: tensor} together (L2)."""
    num = sum(float((got[k] - want[k]).double().square().sum()) for k in want)
    return (num / sum(float(want[k].double().square().sum()) for k in want)) ** 0.5


def dp_rank(rank, tmp):
    """G1, one rank: joins a gloo group of DP_WORLD processes that all run
    on cuda:0. Writes rank{rank}.json in tmp."""
    import hashlib
    import torch
    import torch.distributed
    from torch.profiler import record_function
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, REPO)
    from openseg3d_tpu_torch.data.batch import to_device
    from openseg3d_tpu_torch.data.synthetic import bench_frame
    from openseg3d_tpu_torch.engine import make_train_step
    from openseg3d_tpu_torch.parallel import dist as pdist
    device = torch.device('cuda', 0)
    torch.cuda.set_device(device)
    pdist.init_distributed('cuda', backend='gloo', init_method=f'file://{tmp}/rendezvous',
                           rank=rank, world_size=DP_WORLD)
    try:
        res = {'rank': rank, 'backend': pdist.backend()}
        f32, bf16 = dp_configs()

        # (a) float32 at full width on the cut capacity; the parent compares
        state, spec = dp_state(f32, device)
        set_dropout_off(state.model)
        batch = to_device({k: v for k, v in bench_frame(f32, DP_POINTS, seed=rank).items()
                           if k != 'batch_size'}, device)
        state, m = make_train_step(f32, spec)(state, batch, seed=0)
        grads = {k: p.grad.float().cpu() for k, p in state.model.named_parameters()}
        after = {k: v.float().cpu() for k, v in state.model.state_dict().items()}
        digest = hashlib.sha256()
        for k in sorted(after):
            digest.update(after[k].numpy().tobytes())
        res['f32'] = {'finite': bool(m['grads_finite']), 'loss': float(m['loss']),
                      'digest': digest.hexdigest()}
        if rank == 0:
            torch.save((grads, after), os.path.join(tmp, 'f32_ranks.pt'))
        del state, batch, grads, after
        torch.cuda.empty_cache()

        # (b) bf16 at full capacity: one counted step with dropout off
        # (compared with one process), then timed steps with the dropout on
        state, spec = dp_state(bf16, device)
        saved = set_dropout_off(state.model)
        batch = to_device({k: v for k, v in bench_frame(bf16, N_POINTS, seed=rank).items()
                           if k != 'batch_size'}, device)
        step = make_train_step(bf16, spec)
        counters = model_counters()
        from openseg3d_tpu_torch.ops.sparse_conv import apply_sparse_conv
        from openseg3d_tpu_torch.ops.window import permute_rows
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        apply_sparse_conv.backwards = permute_rows.backwards = 0
        state, m = step(state, batch, seed=0)
        torch.cuda.synchronize()
        res['bf16'] = {'finite': bool(m['grads_finite']), 'loss': float(m['loss']),
                       'launches': {k: c.launches for k, c in counters.items()},
                       'backwards': [apply_sparse_conv.backwards, permute_rows.backwards]}
        for mod, attr, value in saved:
            setattr(mod, attr, value)
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch, seed=0)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            assert m['grads_finite'], ('bf16 step', i)
        res['bf16'].update(step_ms=statistics.median(times[1:]), times=times,
                           peak=torch.cuda.max_memory_allocated())

        # every collective of one step under the profiler, in a range each
        all_reduce = torch.distributed.all_reduce

        def annotated(*args, **kwargs):
            with record_function('all_reduce'):
                return all_reduce(*args, **kwargs)

        with mock.patch.object(torch.distributed, 'all_reduce', annotated):
            events, wall = trace(lambda: step(state, batch, seed=0))
        n, dev_ms, host_ms = range_device(events, 'all_reduce')
        res['bf16'].update(all_reduce_calls=n, all_reduce_device_ms=dev_ms,
                           all_reduce_host_ms=host_ms, profiled_step_ms=wall)
        with open(os.path.join(tmp, f'rank{rank}.json'), 'w') as f:
            json.dump(res, f)
    finally:
        pdist.destroy()


def range_device(events, name):
    """(number of record_function ranges called name, device ms of the
    kernels, copies and memsets launched inside them by any thread, host ms
    the ranges lasted)."""
    ranges = [(e['ts'], e['ts'] + e['dur']) for e in events
              if e.get('cat') == 'user_annotation' and e.get('name') == name]
    launched = {e.get('args', {}).get('correlation') for e in events
                if e.get('cat') in ('cuda_runtime', 'cuda_driver')
                and any(lo <= e['ts'] <= hi for lo, hi in ranges)}
    durs = [e['dur'] for e in events if e.get('cat') in ('kernel', 'gpu_memcpy', 'gpu_memset')
            and e.get('args', {}).get('correlation') in launched - {None}]
    return len(ranges), sum(durs) / 1e3, sum(hi - lo for lo, hi in ranges) / 1e3


def keep_float64():
    """The float64 witness's precision rule, patched into a process of its
    own: a float64 tensor stays float64 through the port's float32 upcasts
    (Tensor.float and the float32 classifier heads, layers.dense) and a mask
    becomes float64; integer coordinates still become float32, as in the
    float32 steps, so that the 1-NN's ties fall the same way."""
    import torch
    from openseg3d_tpu_torch import engine  # noqa: F401  (every module that imports dense)
    from openseg3d_tpu_torch.models import layers
    to_float, dense = torch.Tensor.float, layers.dense

    def float_(self, *args, **kwargs):
        if self.dtype in (torch.float64, torch.bool):
            return self.double()
        return to_float(self, *args, **kwargs)

    def dense64(layer, x, dtype=None):
        return dense(layer, x, None if x.dtype == torch.float64 else dtype)

    torch.Tensor.float = float_
    for module in list(sys.modules.values()):
        if getattr(module, 'dense', None) is dense:
            module.dense = dense64


def dp_float64(rank, world, tmp, threads):
    """G1(a)'s float64 witness on the host's cores: the float32 config's
    step with the model, the frames and the compute dtype in float64. With
    world 1 one process takes both frames as one batch; else rank `rank` of
    a gloo group of `world` takes frame `rank`. Rank 0 saves its gradients
    to tmp/float64_world{world}.pt."""
    import resource
    import numpy as np
    import torch
    sys.path.insert(0, REPO)
    torch.set_num_threads(threads)
    keep_float64()
    from openseg3d_tpu_torch.engine import make_train_step
    from openseg3d_tpu_torch.parallel import dist as pdist
    if world > 1:
        pdist.init_distributed('cpu', backend='gloo', init_method=f'file://{tmp}/rendezvous64',
                               rank=rank, world_size=world)
    try:
        cfg = dp_configs('float64')[0]
        frames = dp_frames(cfg, DP_POINTS)
        frames = frames if world == 1 else frames[rank:rank + 1]
        state, spec = dp_state(cfg, 'cpu')
        state.model.double()
        set_dropout_off(state.model)
        batch = {k: torch.from_numpy(np.concatenate([f[k] for f in frames]))
                 for k in frames[0] if k != 'batch_size'}
        batch = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
        state, m = make_train_step(cfg, spec)(state, batch, seed=0)
        assert m['grads_finite'], ('float64 witness', rank, world)
        if rank == 0:
            torch.save((float(m['loss']), {k: p.grad for k, p in state.model.named_parameters()}),
                       os.path.join(tmp, f'float64_world{world}.pt'))
            with open(os.path.join(tmp, f'float64_peak{world}.txt'), 'w') as f:
                f.write(f'{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f}')
    finally:
        pdist.destroy()


def start(target, world, args):
    """target(rank, *args) in `world` spawned processes, started."""
    import multiprocessing as mp
    ctx = mp.get_context('spawn')
    procs = [ctx.Process(target=target, args=(r,) + tuple(args)) for r in range(world)]
    for p in procs:
        p.start()
    return procs


def join(procs, timeout):
    """Every process must exit 0 within `timeout` seconds; the survivors
    are killed."""
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]


def run_data_parallel(smi, device):
    """G1: two ranks on the one card (gloo, both on cuda:0: the only place
    where ranks share a card) against one process taking their two frames
    as one batch, then (a)'s float64 witness on the host's cores. Returns
    the ranks' results and (a)'s summary."""
    import torch
    f32, bf16 = dp_configs()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        frames = dp_frames(f32, DP_POINTS)
        ref_loss, ref, ref_after = dp_one_process(f32, frames, device)
        swapped = dp_one_process(f32, frames[::-1], device)[1]
        bf16_loss = dp_one_process(bf16, dp_frames(bf16, N_POINTS), device)[0]
        print(f'G1 one-process B = 2 references: {time.perf_counter() - t0:.1f} s; bf16 loss '
              f'{bf16_loss:.6g}', flush=True)
        t0 = time.perf_counter()
        join(start(dp_rank, DP_WORLD, (tmp,)), 600)
        ranks = []
        for r in range(DP_WORLD):
            with open(os.path.join(tmp, f'rank{r}.json')) as f:
                ranks.append(json.load(f))
        grads, after = torch.load(os.path.join(tmp, 'f32_ranks.pt'), weights_only=True)
        print(f'G1 two ranks: {time.perf_counter() - t0:.1f} s', flush=True)
        t0 = time.perf_counter()
        # one after the other: side by side they pass 96 GiB of host memory
        cores = os.cpu_count() or 2
        join(start(dp_float64, 1, (1, tmp, cores)), 900)
        one_s = time.perf_counter() - t0
        join(start(dp_float64, DP_WORLD, (DP_WORLD, tmp, max(1, cores // DP_WORLD))), 900)
        loss64, exact = torch.load(os.path.join(tmp, 'float64_world1.pt'), weights_only=True)
        loss64_ranks, exact_ranks = torch.load(
            os.path.join(tmp, f'float64_world{DP_WORLD}.pt'), weights_only=True)
        peak = []
        for world in (1, DP_WORLD):
            with open(os.path.join(tmp, f'float64_peak{world}.txt')) as f:
                peak.append(f.read())
        print(f'G1 float64 witness on {cores} host cores: one process {one_s:.1f} s, peak '
              f'resident memory {peak[0]} GiB; {DP_WORLD} ranks {time.perf_counter() - t0 - one_s:.1f}'
              f' s, rank 0 {peak[1]} GiB', flush=True)

    # the float32 runs against each other, and each against the float64 witness
    two = {k: scaled_err(grads[k], ref[k]) for k in ref}
    to64 = {name: {k: scaled_err(g[k].double(), exact[k]) for k in exact}
            for name, g in (('one process', ref), ('frames swapped', swapped),
                            ('two ranks', grads))}
    # leaves past DP_TOL: (ranks vs one process, its gate, each float32 run vs float64, leaf)
    over = [(two[k], DP_TOL + to64['one process'][k], to64['one process'][k],
             to64['frames swapped'][k], to64['two ranks'][k], k)
            for k in sorted(ref, key=lambda k: -two[k]) if two[k] > DP_TOL]
    tree, tree_noise = tree_err(grads, ref), tree_err(swapped, ref)
    tree64 = {name: tree_err({k: g[k].double() for k in exact}, exact)
              for name, g in (('one process', ref), ('frames swapped', swapped),
                              ('two ranks', grads))}
    ranks64 = max((scaled_err(exact_ranks[k], exact[k]), k) for k in exact)
    worst = max((v, k) for k, v in two.items())
    after_err = max((scaled_err(after[k], ref_after[k]), k) for k in ref_after)
    caps = ', '.join(f'{k} {v}' for k, v in DP_CAPS.items())
    print(f'G1(a) {DP_WORLD} ranks ({ranks[0]["backend"]}, cuda:0 shared), float32, full '
          f'width, {DP_POINTS} points a frame ({caps}): loss {ranks[0]["f32"]["loss"]:.6g} rel '
          f'{abs(ranks[0]["f32"]["loss"] - ref_loss) / abs(ref_loss):.3g} against one process '
          f'at B = 2; worst gradient leaf {worst[1]} {worst[0]:.3g}; worst parameter or '
          f'statistic after the step {after_err[1]} {after_err[0]:.3g} (gate {DP_TOL}); on '
          f'{smi}', flush=True)
    print(f'G1(a) gradient leaves past {DP_TOL} of (1 + the leaf\'s max): two ranks vs one '
          f'process, its gate ({DP_TOL} + the one process vs float64); float64 witness vs the '
          f'one process, the frames swapped, the two ranks; leaf', flush=True)
    for row in over:
        print('  ' + ' '.join(f'{v:.3g}' for v in row[:5]) + f' {row[5]}', flush=True)
    print(f'G1(a) over the tree (relative L2): two ranks vs one process {tree:.3g}, frames '
          f'swapped vs one process {tree_noise:.3g} (gate {DP_NOISE_FACTOR} x); against the '
          f'float64 witness: ' + ', '.join(f'{n} {v:.3g}' for n, v in tree64.items())
          + f'; float64 {DP_WORLD} ranks vs one process: loss {loss64_ranks:.12g} vs '
          f'{loss64:.12g}, worst leaf {ranks64[1]} {ranks64[0]:.3g} (gate {DP_FLOAT64_TOL})',
          flush=True)
    for res in ranks:
        b = res['bf16']
        print(f'G1(b) rank {res["rank"]}/{DP_WORLD}, bf16 at full capacity: loss '
              f'{b["loss"]:.6g} (one process B = 2: {bf16_loss:.6g}, rel '
              f'{abs(b["loss"] - bf16_loss) / abs(bf16_loss):.3g}); launches {b["launches"]}, '
              f'gather-only backwards (conv, permute_rows) {b["backwards"]}; median step '
              f'{b["step_ms"]:.2f} ms (steps {[round(x, 2) for x in b["times"]]}), peak memory '
              f'{b["peak"] / 2**30:.2f} GiB; all-reduce under the profiler: '
              f'{b["all_reduce_calls"]} calls, device {b["all_reduce_device_ms"]:.3f} ms, host '
              f'{b["all_reduce_host_ms"]:.3f} ms of a {b["profiled_step_ms"]:.2f} ms step; an '
              f'upper bound for NCCL across cards: two ranks share the card and gloo '
              f'goes through the host; on {smi}', flush=True)
    for res in ranks:
        a, b = res['f32'], res['bf16']
        assert a['finite'] and b['finite'], res
        assert abs(a['loss'] - ref_loss) <= DP_TOL * abs(ref_loss), (a['loss'], ref_loss)
        assert abs(b['loss'] - bf16_loss) <= DP_BF16_LOSS_RTOL * abs(bf16_loss), (b, bf16_loss)
        assert b['launches'] == {'B1': 0, 'B2f': 105, 'B2b': 105, 'B3': 1, 'S1': 40,
                                 'S2': 20}, b['launches']
        assert b['backwards'] == [20, 36], b['backwards']
    assert len({res['f32']['digest'] for res in ranks}) == 1, 'ranks hold other parameters'
    assert after_err[0] <= DP_TOL, after_err
    assert tree <= DP_NOISE_FACTOR * tree_noise, (tree, tree_noise)
    bad = [row for row in over if row[0] > row[1]]
    assert not bad, bad
    assert ranks64[0] <= DP_FLOAT64_TOL, ranks64
    return ranks, {'loss_rel': max(abs(r['f32']['loss'] - ref_loss) for r in ranks) / abs(ref_loss),
                   'grad': worst[0], 'float64': ranks64[0]}


def run_torchrun(smi):
    """G2: the launcher users run, torchrun with one process on this card
    (NCCL), a subprocess whose exit code is checked."""
    import math
    import re
    import torch
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        run_dir = os.path.join(tmp, 'run')
        cmd = [sys.executable, '-m', 'torch.distributed.run', '--standalone',
               '--nproc_per_node', '1', '-m', 'openseg3d_tpu_torch.tools.train',
               '--launcher', 'pytorch', '--cfg_file',
               os.path.join(REPO, 'configs', 'synthetic_smoke.yaml'), '--synthetic',
               '--synthetic_frames', '4', '--batch_size', '1', '--epochs', '1',
               '--eval_epoch_interval', '1', '--log_iter_interval', '1', '--num_workers', '0',
               '--save_dir', run_dir]
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get('PYTHONPATH', ''))
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=tmp, env=env, capture_output=True, text=True,
                              timeout=600)
        seconds = time.perf_counter() - t0
        print(proc.stdout[-2000:] + proc.stderr[-4000:], flush=True)
        assert proc.returncode == 0, proc.returncode
        with open(os.path.join(run_dir, 'train.log')) as f:
            log = f.read()
        files = sorted(n for n in os.listdir(run_dir) if n.startswith('epoch_'))
    mious = [float(x) for x in re.findall(r'mIoU=([-0-9.naNinf]+)', log)]
    print(f'G2 torchrun --nproc_per_node 1 ... --launcher pytorch: rc {proc.returncode} in '
          f'{seconds:.1f} s, checkpoints {files}, validation mIoU {mious}, on {smi}', flush=True)
    assert 'process 0/1, backend: nccl' in log, log[:2000]
    assert files == ['epoch_1.pt'], files
    assert len(mious) == 1 and math.isfinite(mious[0]), mious
    return seconds


def dice_focal_step(cfg, batch):
    """G3: Dice and focal added to MODEL.LOSSES, in one full-size bf16
    train step: a finite loss and gradients, the kernels launched."""
    import math
    import torch
    from openseg3d_tpu_torch.engine import make_train_step
    cfg = copy.deepcopy(cfg)
    cfg.MODEL.LOSSES.update({'dice': 1.0, 'focal': 1.0})
    device = batch['points'].device
    state, spec = dp_state(cfg, device)
    counters = model_counters()
    for c in counters.values():
        c.launches = 0
    state, m = make_train_step(cfg, spec)(state, batch, seed=0)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    print(f'G3 bf16 train step with MODEL.LOSSES {dict(cfg.MODEL.LOSSES)}: loss '
          f'{float(m["loss"]):.6g}, gradients finite {m["grads_finite"]}, launches {launches}',
          flush=True)
    assert m['grads_finite'] and math.isfinite(float(m['loss'])), m
    assert launches == {'B1': 0, 'B2f': 105, 'B2b': 105, 'B3': 1,
                        **conv_launches(cfg, steps=1)}, launches
    del state
    torch.cuda.empty_cache()


def rest_against_cpu(smi, cfg, batch):
    """G3: the last modules on the batch's device against their CPU run at
    a small float32 size (the CPU runs are held against the JAX package by
    tests/test_torch_rest.py), and FPS on the frame's voxel centres.
    Returns ({module: max abs difference}, {FPS: (seconds, equal)})."""
    import numpy as np
    import torch
    from openseg3d_tpu_torch.models import losses
    from openseg3d_tpu_torch.models.norm import MaskedLayerNorm
    from openseg3d_tpu_torch.models.segmentors.common import ModelSpec
    from openseg3d_tpu_torch.models.sparse_modules import SparseBasicBlock
    from openseg3d_tpu_torch.ops import sampling, sparse_conv as sc, window as win
    from openseg3d_tpu_torch.utils import pointops
    from openseg3d_tpu_torch.weights import init_weights

    device = batch['points'].device
    sync = torch.cuda.synchronize if device.type == 'cuda' else (lambda: None)
    rng = np.random.RandomState(5)
    worst = {}

    def both(fn, *arrays, grad=()):
        """fn on the card and on the CPU from the same arrays: (outputs on
        the host, gradients of (output x a fixed cotangent) w.r.t. the
        inputs listed in grad), card first."""
        out = []
        for dev in (device, 'cpu'):
            ts = [torch.from_numpy(a).to(dev) if isinstance(a, np.ndarray) else a
                  for a in arrays]
            for i in grad:
                ts[i].requires_grad_()
            y = fn(*ts)
            g = []
            if grad:
                cot = torch.from_numpy(np.asarray(np.random.RandomState(0).randn(*y.shape),
                                                  dtype=np.float32)).to(dev)
                g = torch.autograd.grad((y.float() * cot).sum(), [ts[i] for i in grad])
            out.append((y.detach().cpu(), [x.cpu() for x in g]))
        return out

    def check(name, pair, tol):
        (yg, gg), (yc, gc) = pair
        err = max([float((yg.float() - yc.float()).abs().max())]
                  + [float((a - b).abs().max()) for a, b in zip(gg, gc)])
        worst[name] = err
        assert err <= tol, (name, err, tol)

    logits = (rng.randn(4096, 22) * 3).astype(np.float32)
    labels = rng.randint(0, 22, 4096)
    labels[rng.permutation(4096)[:300]] = 255
    for name in ('dice', 'focal'):
        fn = getattr(losses, f'{name}_loss')
        check(name, both(lambda lg, lb, fn=fn: fn(lg, lb, 255), logits, labels, grad=(0,)), 1e-5)

    # SparseBasicBlock(with_sa=True) on a small sparse tensor
    shape, c = (12, 12, 12), 16
    coords = np.full((2, 600, 3), -1, np.int32)
    for i in range(2):
        lin = np.sort(rng.choice(12 ** 3, 500, replace=False))
        coords[i, :500] = np.stack([lin // 144, (lin // 12) % 12, lin % 12], 1)
    feats = rng.randn(2, 600, c).astype(np.float32) * (coords[..., :1] >= 0)
    block = SparseBasicBlock(c, with_sa=True)
    init_weights(block, torch.Generator().manual_seed(1))
    state_dict = copy.deepcopy(block.state_dict())

    def sa_block(x, co):
        blk = SparseBasicBlock(c, with_sa=True).to(x.device).train()
        blk.load_state_dict(state_dict)
        rule = sc.build_subm_rulebook(sc.SparseTensor(x, co, shape))
        return blk(x, rule, co[..., 0] >= 0)

    check('SparseBasicBlock with_sa', both(sa_block, feats, coords, grad=(0,)), 1e-4)

    x = (rng.randn(2, 300, 48) * 2).astype(np.float32)
    mask = rng.rand(2, 300) > 0.3
    ln = MaskedLayerNorm(48)
    with torch.no_grad():
        ln.LayerNorm_0.weight.uniform_(0.5, 1.5)
        ln.LayerNorm_0.bias.normal_()

    def layer_norm(v, mk):
        return copy.deepcopy(ln).to(v.device)(v, mk)

    check('MaskedLayerNorm', both(layer_norm, x, mask, grad=(0,)), 1e-5)

    spec_l = win.LevelSpec(max_tokens=64, lower=0, upper=64, num_windows=40)
    idx = np.full((2, 3000), -1, np.int64)
    for i in range(2):
        idx[i, rng.permutation(3000)[:2000]] = rng.permutation(2560)[:2000]
    wf = rng.randn(2, 40, 64, 8).astype(np.float32)
    flat = rng.randn(2, 3000, 8).astype(np.float32)
    for name, fn, args in (('flat_to_window', win.flat_to_window, (flat, idx)),
                           ('window_mask', win.window_mask, (idx,)),
                           ('window_to_flat', win.window_to_flat, (wf, idx))):
        check(name, both(lambda *a, fn=fn: fn(*a, spec_l), *args), 0.0)

    xyz = rng.uniform(-20, 20, (4000, 3)).astype(np.float32)
    qxyz = rng.uniform(-20, 20, (1500, 3)).astype(np.float32)
    pf = rng.randn(4000, 16).astype(np.float32)
    pv, qv = rng.rand(4000) > 0.2, rng.rand(1500) > 0.1
    check('query_and_group', both(lambda a, b, f, p, q: pointops.query_and_group(
        16, a, b, f, p_valid=p, q_valid=q), xyz, qxyz, pf, pv, qv, grad=(2,)), 1e-5)
    from openseg3d_tpu_torch.ops.knn import knn_query
    kidx, kdist = knn_query(3, torch.from_numpy(xyz)[None], torch.from_numpy(qxyz)[None],
                            torch.from_numpy(pv)[None], torch.from_numpy(qv)[None])
    kdist = torch.where(kidx >= 0, kdist.abs(), 1.0)
    check('interpolation', both(pointops.interpolation, kidx[0].numpy(), kdist[0].numpy(), pf,
                                grad=(2,)), 1e-5)

    # FPS on the bench frame's voxel centres
    from openseg3d_tpu_torch.utils.pointops import get_voxel_centers
    mspec = ModelSpec.from_config(cfg)
    centres = get_voxel_centers(batch['voxel_coords'][0], 1.0, mspec.voxel_size,
                                mspec.point_cloud_range)
    valid = batch['voxel_mask'][0]
    fps = {}
    for name, fn in (('furthest_point_sample', lambda p, v: sampling.furthest_point_sample(
                          p, v, FPS_SAMPLES)),
                     ('sectorized_fps', lambda p, v: sampling.sectorized_fps(
                         p, v, FPS_SAMPLES, 6))):
        sync()
        t0 = time.perf_counter()
        on_card = fn(centres, valid)
        sync()
        card_s = time.perf_counter() - t0
        on_cpu = fn(centres.cpu(), valid.cpu())
        equal = bool(torch.equal(on_card.cpu(), on_cpu))
        fps[name] = (card_s, equal)
        assert equal, (name, int((on_card.cpu() != on_cpu).sum()))
    print(f'G3 the last modules on the card against their CPU run, max abs difference: '
          f'{ {k: float(f"{v:.3g}") for k, v in worst.items()} }; FPS of {FPS_SAMPLES} on the '
          f'bench frame\'s {int(valid.sum())} voxel centres (card s, indices equal to the '
          f'CPU run): {fps}, on {smi}', flush=True)
    return worst, fps


# phase H: the bench's calls a run (the first, then --iters), and the
# launches a step of each of its runs (the config's 105 attention levels
# and layers; B3 once a step with the loss; S1 once a conv in a forward and
# once more in a backward, S2 once a conv in a backward: Segformer's 20
# convs, SPNet's 43)
BENCH_ITERS = 5
BENCH_RUNS = (
    ('Segformer infer', ['--mode', 'infer'], {'B1': 105, 'S1': 20}),
    ('Segformer train_fwd', ['--mode', 'train_fwd'], {'B2f': 105, 'B3': 1, 'S1': 20}),
    ('Segformer train', ['--mode', 'train'],
     {'B2f': 105, 'B2b': 105, 'B3': 1, 'S1': 40, 'S2': 20}),
    ('SPNet train', ['--mode', 'train', '--segmentor', 'spnet'], {'B3': 1, 'S1': 86, 'S2': 43}),
    ('Segformer+DeepFusion infer', ['--mode', 'infer', '--image_feature'], {'B1': 105, 'S1': 20}),
)
# the kernels of a Segformer train step as the profiler names them, and their
# launches a step: B2f; B2b's one-pass kernel, or its dq pass and dk/dv pass
# (None: as b2b_paths counts them); B3's search and combine
PROFILED_KERNELS = {'window_attention_train_fwd': 105, 'window_attention_train_onepass': None,
                    'window_attention_train_dq': None, 'window_attention_train_dkdv': None,
                    'nearest_point_kernel': 1, 'nearest_point_combine_kernel': 1}


def run_measuring_tools(smi, b2b_split):
    """Phase H: the port's measuring entry points on the card, in-process
    through main([...]): the bench in each run of BENCH_RUNS (one JSON line,
    finite, the launches each wrapper counted equal to the run's launches a
    step times its calls, and the line's own launches_per_step), then
    profile_step --mode train --steps 2 --by_module (B2f, B2b and B3 under
    their kernel names with their launches a step, the by-module table),
    then measure_capacities on 2 bench frames on the card (each stage's
    voxel count equal to verify_capacities' numpy count on the same frames)
    and verify_capacities at the default RUNTIME: zero drops. Returns
    ({run: bench line}, profile_step's result)."""
    import contextlib
    import io
    import math
    from openseg3d_tpu_torch import bench
    from openseg3d_tpu_torch.tools import measure_capacities, profile_step, verify_capacities
    counters = model_counters()
    names = {'B1': 'window_attention_packed', 'B2f': 'window_attention_train_forward',
             'B2b': 'window_attention_train_backward', 'B3': 'nearest_point'}
    lines = {}
    for label, argv, per_step in BENCH_RUNS:
        for c in counters.values():
            c.launches = 0
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            res = bench.main(argv + ['--iters', str(BENCH_ITERS)])
        launches = {k: c.launches for k, c in counters.items()}
        printed = out.getvalue().strip().splitlines()
        print(f'H bench {label}: step {res["step_ms"]} ms, {res["value"]} Mpoints/s, first step '
              f'{res["first_step_s"]} s, build {res["build_s"]} s, launches {launches} in '
              f'{BENCH_ITERS + 1} calls, on {smi}', flush=True)
        assert len(printed) == 1 and json.loads(printed[0]) == res, printed
        assert all(math.isfinite(res[k]) for k in ('value', 'step_ms', 'first_step_s')), res
        want = {k: per_step.get(k, 0) * (BENCH_ITERS + 1) for k in counters}
        assert launches == want, (label, launches, want)
        assert res['launches_per_step'] == dict(
            {names[k]: per_step.get(k, 0) for k in names}, fused_window_attention=0), res
        lines[label] = res

    # the profiler, by kernel and by module
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        prof = profile_step.main(['--mode', 'train', '--steps', '2', '--by_module',
                                  '--top', '400', '--trace_dir', tmp])
    launches = {k: c.launches for k, c in counters.items()}
    print(f'H profile_step ({time.perf_counter() - t0:.1f} s): {prof["device_ms_per_step"]:.3f} '
          f'device ms a step (busy {prof["busy_ms_per_step"]:.3f}), by bucket '
          f'{ {k: round(v, 3) for k, v in prof["by_bucket"].items()} }, launches {launches} in '
          f'3 steps, on {smi}', flush=True)
    assert launches == {'B1': 0, 'B2f': 315, 'B2b': 315, 'B3': 3, 'S1': 120, 'S2': 60}, launches
    one_pass, two_pass = b2b_split
    for part, per_step in PROFILED_KERNELS.items():
        if per_step is None:
            per_step = one_pass if part.endswith('onepass') else two_pass
        n = sum(c for name, _, c in prof['top'] if part in name)
        assert n == per_step, (part, n)
    assert prof['by_bucket']['attention'] > 0 and prof['by_bucket']['knn'] > 0, prof
    for module in ('PointBranch_0', 'PointTransformer_0.ConvModule_0',
                   'PointTransformer_0.SWFormerBlock_3', 'PointTransformer_0.UpBlock_3',
                   'SegmentorHead_0', 'seg3d.structure.rulebooks', 'seg3d.structure.windows',
                   'seg3d.loss'):
        assert any(k.startswith(module) for k in prof['by_module']), (module, prof['by_module'])
    assert any(k.startswith('backward: ') for k in prof['by_module'])

    # the capacity tools: measure on the card, verify on the host
    t0 = time.perf_counter()
    measured = measure_capacities.main(['--frames', '2', '--seed', '0'])
    verified = verify_capacities.main([])
    print(f'H capacities ({time.perf_counter() - t0:.1f} s): measured on 2 bench frames, stage '
          f'occupancy {measured["occupancy"]}, ratios {measured["ratios"]}; verify at the '
          f'default RUNTIME, {len(verified["voxels"])} frames: {verified["violations"]} '
          f'capacity violations; on {smi}', flush=True)
    assert measured['occupancy'] == [max(v) for v in zip(*verified['voxels'][:2])], \
        (measured, verified)
    assert verified['violations'] == 0, verified
    return lines, prof




def check_build():
    """Phase 2: every kernel source built at once, each kernel's registers
    and spills (ptxas) printed; the bf16 tensor-core kernels must not
    spill, and the gate must have seen each of them."""
    from openseg3d_tpu_torch.ops import _build
    from openseg3d_tpu_torch.ops.sparse_conv import tile_shapes
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f'built {len(built)} kernel libraries in {time.perf_counter() - t0:.1f} s')
    mma_kernels, conv_kernels = set(), []
    for name, (path, seconds, log) in built.items():
        print(f'  {path.relative_to(REPO)}: ptxas registers, spill stores / loads (bytes)')
        for kernel, regs, stores, loads in ptxas_usage(log):
            print(f'    {kernel:48s} {regs:4d}  {stores:4d} / {loads:4d}')
            # the tensor-core (bf16) kernels must not spill
            if '_mma_kernel' in kernel:
                if name == 'sparse_conv':
                    conv_kernels.append(kernel)
                else:
                    mma_kernels.add(kernel)
                assert stores == loads == 0, (kernel, stores, loads)
    # every bf16 tensor-core kernel was seen by the gate: the one-pass and
    # two two-pass train backward kernels at head widths 6, 12, 24 and 48,
    # and the eval kernel and the train forward, each at its 5 (head width,
    # key tile) pairs; the sparse conv's two kernels in every tile the
    # library defines and their unaligned instantiation (ptxas names them
    # without their tile)
    assert len(mma_kernels) == 22, sorted(mma_kernels)
    gemm, grad = tile_shapes('gather_gemm'), tile_shapes('weight_grad')
    print(f'  sparse conv tiles (rows, columns): gather-GEMM {gemm}, weight gradient {grad}')
    assert sorted(conv_kernels) == (['gather_gemm_mma_kernel'] * (len(gemm) + 1)
                                    + ['weight_grad_mma_kernel'] * (len(grad) + 1)), conv_kernels


def main() -> int:
    t_run = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this test runs only on a GPU', file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from openseg3d_tpu_torch.config import cfg_from_file
    from openseg3d_tpu_torch.models.backbones.point_transformer import (CHANNELS,
                                                                        stage_level_specs)
    from openseg3d_tpu_torch.models.segmentors.common import ModelSpec

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

    # 1b. the host voxelizer: the C++ path, bit-equal to the reference files' frames
    host_vox = check_host_voxelizer(smi)

    # 2. build, every source at once
    check_build()

    # 3. kernel vs plain at the main path's shapes
    cfg = cfg_from_file(os.path.join(REPO, 'configs', 'waymo_one_sweep.yaml'))
    spec = ModelSpec.from_config(cfg)
    levels = stage_level_specs(spec)
    t0 = time.perf_counter()
    k_ms, k16_ms, p_ms, err32 = check_kernel(levels, CHANNELS, spec.depths)
    print(f'kernel check: {time.perf_counter() - t0:.1f} s; sum over shapes of depth x '
          f'one call at capacity (bf16 device time): kernel {k_ms:.3f} ms in the table\'s '
          f'launch shapes, {k16_ms:.3f} ms in the 16-row block, plain {p_ms:.3f} ms, on {smi}',
          flush=True)

    # 3b. train kernels vs plain at the same shapes
    t0 = time.perf_counter()
    fwd_err32, grad_err32 = check_train_kernels(levels, CHANNELS)
    print(f'train kernel check: {time.perf_counter() - t0:.1f} s; max float32 error forward '
          f'{fwd_err32:.3g}, gradient {grad_err32:.3g}', flush=True)

    # 3c. 1-NN vs plain on the frame's voxel centres
    batch, _ = frame_batch(cfg, device)
    b3_yard = check_nearest_point(cfg, spec, batch, smi)

    # 3d. the unpacked attention (B4) vs plain, and its own path
    t0 = time.perf_counter()
    b4 = check_unpacked(levels, CHANNELS)
    print(f'unpacked kernel check: {time.perf_counter() - t0:.1f} s; B4 over the '
          f'{b4["launches"]} shapes (bf16): kernel {b4["ms"]:.3f} ms in the table\'s launch '
          f'shapes, {b4["ms16"]:.3f} ms in the 16-row block, plain {b4["plain_ms"]:.3f} '
          f'ms, SDPA {b4["library_ms"]:.3f} ms, bound {b4["bound_ms"]:.4f} ms '
          f'({b4["bound_by"]}), on {smi}', flush=True)

    # 4. the eval slice
    expected = sum(d * len(lv) for d, lv in zip(spec.depths, levels))
    launches, step_ms, plain_step_ms, peak, prof, plain_prof, yard, b1_levels = run_slice(
        cfg, device, expected)
    print(f'B1 on the bench frame: {prof["b1_ms"]:.3f} ms profiled in one forward, on {smi}',
          flush=True)
    for name, (table_ms, ms16) in b1_levels.items():
        print(f'B1 on the {name}: the levels\' first calls x their calls: {table_ms:.4f} ms '
              f'in the table\'s block shapes, {ms16:.4f} ms in the 16-row block, on {smi}',
              flush=True)
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
          f'{tr["plain_step_ms"]:.2f} ms, peak memory {tr["peak"] / 2**30:.2f} GiB, '
          f'gather-only backwards {tr["backwards"]} (conv, permute_rows), bf16 index_add '
          f'{tr["prof"]["index_add_bf16"]}, all index kernels {tr["prof"]["index_add"]} (ms, '
          f'launches), {tr["repeat_differ"]} gradient leaves differ between two identical '
          f'steps, keep bits {tr["bits_bytes"] / 2**30:.3f} GiB a step, on {smi}', flush=True)
    for name, p, med in (('kernel', tr['prof'], tr['step_ms']),
                         ('plain', tr['plain_prof'], tr['plain_step_ms'])):
        print(f'{name} train step, profiled: B2 forward {p["b2f"][0]:.3f} ms, B2 backward '
              f'{p["b2b"][0]:.3f} ms, B3 {p["b3"][0]:.3f} ms of device time; device busy '
              f'{p["busy_ms"]:.3f} ms = {p["busy_ms"] / p["wall_ms"]:.3f} of its '
              f'{p["wall_ms"]:.3f} ms wall time (and {p["busy_ms"] / med:.3f} of the '
              f'unprofiled median)', flush=True)
    check_conv_weight_grads(spec, batch)

    # 4c. the sparse-conv kernels at every main-path conv of both models
    t0 = time.perf_counter()
    convs = check_sparse_conv_kernels(smi)
    print(f'sparse conv kernel check: {time.perf_counter() - t0:.1f} s', flush=True)

    # 5. small references against the CPU path
    check_small_reference(device)
    check_small_train_reference(device)

    # 6. yardsticks: one library call for the same function, and the bound
    yard['b3'] = b3_yard
    yard['b4'] = {k: b4[k] for k in ('library_ms', 'bound_ms', 'bound_by')}
    for name, y in yard.items():
        print(f'{name}: library {y["library_ms"]:.3f} ms, bound {y["bound_ms"]:.4f} ms '
              f'({y["bound_by"]}) over the main-path run, on {smi}', flush=True)

    # 7. the command-line tools
    t0 = time.perf_counter()
    cli = run_cli(smi, expected)
    print(f'CLI phase: {time.perf_counter() - t0:.1f} s', flush=True)

    # A. the port against the JAX package's eval step and train step at
    # full capacity
    t0 = time.perf_counter()
    refs, train_refs = check_references(smi)
    print(f'phase A: {time.perf_counter() - t0:.1f} s', flush=True)

    # C. multi-sweep (the 3-sweep reference frame) and cylinder
    from openseg3d_tpu_torch import parity
    from openseg3d_tpu_torch.data.batch import to_device
    from openseg3d_tpu_torch.data.synthetic import bench_frame
    t0 = time.perf_counter()
    ms_cfg = cfg_from_file(os.path.join(REPO, 'configs', 'waymo_multi_sweeps.yaml'))
    multi = run_variant('C multi-sweep', ms_cfg,
                        to_device(parity.reference_frame(ms_cfg, 'multi_sweep'), device), smi)
    cyl_cfg = cfg_from_file(os.path.join(REPO, 'configs', 'waymo_one_sweep_cylinder.yaml'))
    run_variant('C cylinder', cyl_cfg, frame_batch(cyl_cfg, device)[0], smi, timed=False)
    nan_repro(smi)
    print(f'phase C: {time.perf_counter() - t0:.1f} s', flush=True)

    # D. SPNet on the bench frame, then a learning run through tools.train
    t0 = time.perf_counter()
    sp_cfg = cfg_from_file(os.path.join(REPO, 'configs', 'waymo_one_sweep.yaml'),
                           overrides={'MODEL': {'SEGMENTOR': 'spnet'}})
    spnet = run_variant('D SPNet', sp_cfg, batch, smi)
    assert spnet['backwards'][0] == 43, spnet['backwards']
    spnet_learning = run_spnet_learning(smi)
    print(f'phase D: {time.perf_counter() - t0:.1f} s', flush=True)

    # E. device TTA on the bench frame against host TTA
    t0 = time.perf_counter()
    dtta = run_device_tta(cfg, smi, expected)
    print(f'phase E: {time.perf_counter() - t0:.1f} s', flush=True)

    # F. DeepFusion (synthetic image features) on the bench frame: Segformer, SPNet
    t0 = time.perf_counter()
    df_cfg = cfg_from_file(os.path.join(REPO, 'configs', 'waymo_one_sweep.yaml'),
                           overrides={'DATASET': IMAGE_FEATURES})
    df_batch = to_device(bench_frame(df_cfg, N_POINTS, image_features=True), device)
    fusion = run_variant('F DeepFusion', df_cfg, df_batch, smi, index_adds=2)
    shell, knn_ms = knn_shell(ModelSpec.from_config(df_cfg), df_batch, smi)
    df_sp_cfg = cfg_from_file(os.path.join(REPO, 'configs', 'waymo_one_sweep.yaml'),
                              overrides={'DATASET': IMAGE_FEATURES,
                                         'MODEL': {'SEGMENTOR': 'spnet'}})
    run_variant('F SPNet DeepFusion', df_sp_cfg, df_batch, smi, timed=False)
    print(f'phase F: {time.perf_counter() - t0:.1f} s', flush=True)

    # B. the rehearsal: train, eval and test through the port's tools, then
    # the same with image features
    import gc
    gc.collect()
    torch.cuda.empty_cache()    # the tools' processes share the card with this one
    t0 = time.perf_counter()
    rehearsal = run_rehearsal(smi)
    run_rehearsal(smi, image_feature_dim=IMAGE_FEATURES['DIM_IMAGE_FEATURE'])
    print(f'phase B: {time.perf_counter() - t0:.1f} s', flush=True)

    # G. data-parallel training: two ranks sharing the card over gloo, then
    # torchrun (NCCL) at world size 1; the last modules on the card
    t0 = time.perf_counter()
    dp, dp_f32 = run_data_parallel(smi, device)
    print(f'phase G1: {time.perf_counter() - t0:.1f} s', flush=True)
    t0 = time.perf_counter()
    torchrun_s = run_torchrun(smi)
    print(f'phase G2: {time.perf_counter() - t0:.1f} s', flush=True)
    t0 = time.perf_counter()
    dice_focal_step(cfg, batch)
    rest = rest_against_cpu(smi, cfg, batch)
    print(f'phase G3: {time.perf_counter() - t0:.1f} s', flush=True)

    # H. the measuring entry points: the bench in its modes, the profiler,
    # the capacity tools
    t0 = time.perf_counter()
    bench_lines, profiled = run_measuring_tools(smi, tr['b2b_paths'])
    print(f'phase H: {time.perf_counter() - t0:.1f} s', flush=True)

    kp, pp = tr['prof'], tr['plain_prof']
    rows = [
        ('window_attention_packed', 'window_attention.cu', 'attention.py:317', launches,
         err32, prof['b1_ms'], plain_prof['core_ms'], yard['b1']),
        ('window_attention_train_forward', 'window_attention_train.cu', 'attention.py:673',
         tr['launches'][0], fwd_err32, kp['b2f'][0], pp['b2f'][0], yard['b2f']),
        ('window_attention_train_backward', 'window_attention_train.cu', 'attention.py:683',
         tr['launches'][1], grad_err32, kp['b2b'][0], pp['b2b'][0], yard['b2b']),
        ('nearest_point', 'nearest_point.cu', 'knn.py:223', tr['launches'][2], 0.0,
         kp['b3'][0], pp['b3'][0], yard['b3']),
        ('fused_window_attention', 'window_attention.cu', 'attention.py:256', b4['launches'],
         b4['max_err32'], b4['ms'], b4['plain_ms'], yard['b4']),
    ]
    print(f'learning run: loss {cli["learning"]["first_loss"]:.4f} -> '
          f'{cli["learning"]["last_loss"]:.4f}, validation mIoU {cli["learning"]["mious"]}, on '
          f'{smi}', flush=True)
    print(f'host voxelizer: native {host_vox["native"]:.2f} ms, numpy {host_vox["numpy"]:.2f} '
          f'ms a bench frame (host), on {smi}', flush=True)
    for name, m in train_refs.items():
        print(f'reference {name}: float32 train step, loss rel {m["loss_rel"]:.3g}, worst leaf '
              f'{m["worst"]} at {m["worst_ratio"]:.3g} of its gate', flush=True)
    for name, res in refs.items():
        print(f'reference {name}: ' + '; '.join(
            f'{dt} agreement {m["agreement"]:.6f}, logits {m["logit_err"]:.3g}, loss rel '
            f'{m["loss_rel"]:.3g}' for dt, m in res.items()), flush=True)
    for name, v in (('multi-sweep', multi), ('SPNet', spnet), ('DeepFusion', fusion)):
        print(f'{name} bf16: forward {v["forward_ms"]:.2f} ms (peak '
              f'{v["forward_peak"] / 2**30:.2f} GiB, busy {v["forward_busy"]:.3f}), train step '
              f'{v["step_ms"]:.2f} ms (peak {v["step_peak"] / 2**30:.2f} GiB, busy '
              f'{v["step_busy"]:.3f}), on {smi}', flush=True)
    print(f'device TTA: {dtta["device_s"]:.2f} s a frame (host TTA {dtta["host_s"]:.2f} s), '
          f'argmax agreement {dtta["agreement"]:.6f}; DeepFusion step bf16 index_add_ (ms, '
          f'launches) {fusion["index_add_bf16"]}, k-NN {knn_ms:.3f} ms; on {smi}', flush=True)
    print(f'SPNet learning run: loss {spnet_learning["first_loss"]:.4f} -> '
          f'{spnet_learning["last_loss"]:.4f}, validation mIoU {spnet_learning["mious"]}; '
          f'rehearsal: {rehearsal["frames"]} frames submitted, equal to the eval argmax',
          flush=True)
    print(f'data-parallel, 2 ranks sharing the card over gloo: float32 loss rel '
          f'{dp_f32["loss_rel"]:.3g}, worst gradient leaf {dp_f32["grad"]:.3g}, float64 '
          f'ranks vs one process {dp_f32["float64"]:.3g}; bf16 median step '
          f'{[round(r["bf16"]["step_ms"], 2) for r in dp]} ms, all-reduce host '
          f'{[round(r["bf16"]["all_reduce_host_ms"], 2) for r in dp]} ms, device '
          f'{[round(r["bf16"]["all_reduce_device_ms"], 3) for r in dp]} ms a rank; torchrun '
          f'(NCCL) {torchrun_s:.1f} s; the last modules on the card, max abs difference from '
          f'the CPU {max(rest[0].values()):.3g}, FPS indices equal; on {smi}', flush=True)
    print(f'measuring entry points (bench at its own defaults, --max_voxels 98304, '
          f'{BENCH_ITERS} steps after the first): step ms '
          f'{ {k: v["step_ms"] for k, v in bench_lines.items()} }; profile_step train, '
          f'device ms a step by bucket '
          f'{ {k: round(v, 3) for k, v in profiled["by_bucket"].items()} }; on {smi}',
          flush=True)
    print(f'chip_smoke: {time.perf_counter() - t_run:.1f} s in all, on {smi}', flush=True)
    print(json.dumps({'kernels': [{
        'name': name,
        'route': 'cuda',
        'source': f'openseg3d_tpu_torch/csrc/{src}',
        'replaces': f'openseg3d_tpu/ops/{where}',
        'launches': n,
        'max_abs_err': err,
        'ms': ms,
        'plain_ms': plain,
        'bound_ms': y['bound_ms'],
        'bound_by': y['bound_by'],
        'library_ms': y['library_ms'],
    } for name, src, where, n, err, ms, plain, y in rows] + conv_kernel_rows(
        convs['segformer'], tr['conv_launches'])}))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())

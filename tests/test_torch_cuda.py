"""The CUDA kernels against their plain PyTorch versions, on the same GPU:
window attention (eval, B1), the unpacked window attention (B4), the train
attention forward and backward (B2)
and the 1-NN search (B3). Every test here needs an NVIDIA GPU with nvcc and
skips without one; on the GPU machine run them with

    python3 -m pytest tests/test_torch_cuda.py

This file imports no part of the JAX package (flax is not installed there).

Tolerances. Eval and train forward, float32: atol/rtol 1e-5 (the same math
in another summation order). Eval and train forward, bfloat16: the
tensor-core kernels round the softmax weights to bf16 before P V, as the TPU
kernel does, and both sides round the output once to bf16, so
``train_forward_bound``: 2**-7 |plain| + 2**-8 / (1 - p) max|v| of the
window and head (p = 0 for the eval kernels). Train gradients, each of dq, dk and dv against its own
largest magnitude: float32 within 1e-4 (sums of T products); bfloat16 within
4 bf16 ulps (the kernel rounds P and dS to bf16 before their products, and
its residual O). The dropout mask is the same hash in both, so these hold at
drop rate 0.1 as at 0. 1-NN: indices equal.
"""

import pytest
import torch

from openseg3d_tpu_torch.ops.attention import (attention_group, fused_window_attention,
                                               fused_window_attention_plain,
                                               train_forward_bound,
                                               window_attention_packed,
                                               window_attention_packed_plain,
                                               window_attention_packed_train,
                                               window_attention_packed_train_plain,
                                               window_attention_train_backward,
                                               window_attention_train_forward)
from openseg3d_tpu_torch.ops.knn import nearest_point, nearest_point_plain

NHEAD = 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _packed_case(device, n, t, c, nw, dtype, seed=0, nhead=NHEAD):
    """Model-shaped inputs (see chip_smoke.attention_case): unit q scaled by
    1/tau, unit k (per head), padded tokens zero with bias -1e9, window 1
    fully padded, windows at rank >= nw[sample] padding. Two samples of
    n // 2 windows."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def unit(x):
        x = x.reshape(n, t, nhead, c // nhead)
        return (x / x.norm(dim=-1, keepdim=True)).reshape(n, t, c)

    q = unit(torch.randn(n, t, c, generator=gen, device=device))
    q = q * (10 + 90 * torch.rand(c, generator=gen, device=device))
    k = unit(torch.randn(n, t, c, generator=gen, device=device))
    v = torch.randn(n, t, c, generator=gen, device=device)
    valid = torch.rand(n, t, generator=gen, device=device) > 0.3
    valid[:, 0] = True
    valid[1] = False
    wps = n // 2
    for s, count in enumerate(nw):
        valid[s * wps + count:(s + 1) * wps] = False
    packed = torch.where(valid[..., None], torch.cat([q, k, v], -1), 0).to(dtype)
    bias = torch.where(valid, 0.0, -1e9)
    return packed, bias, torch.tensor(nw, dtype=torch.int32, device=device)


def _check_packed(device, t, c, dtype, nhead):
    packed, bias, nw = _packed_case(device, 48, t, c, [7, 19], dtype, nhead=nhead)
    before = window_attention_packed.launches
    got = window_attention_packed(packed, bias, nhead, nw)
    torch.cuda.synchronize()
    assert window_attention_packed.launches == before + 1
    assert got.dtype == dtype and got.shape == (48, t, c)
    got = got.float()
    want = window_attention_packed_plain(packed, bias, nhead, nw).float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        err = (got - want).abs()
        assert bool((err <= train_forward_bound(want, packed, nhead, 0.0)).all()), \
            float(err.max())
    assert not got[1].any()                            # fully padded window
    assert not got[7:24].any() and not got[24 + 19:].any()   # windows past nw


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('t,c', [(16, 48), (32, 96), (32, 192), (64, 384), (100, 96),
                                 (800, 48), (800, 384)])
def test_kernel_matches_plain(cuda, t, c, dtype):
    _check_packed(cuda, t, c, dtype, NHEAD)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('nhead,t,c', [(2, 32, 96), (4, 100, 96), (4, 64, 192), (1, 48, 48)])
def test_kernel_matches_plain_at_other_head_counts(cuda, nhead, t, c, dtype):
    """Fewer than 8 heads: the tensor-core kernel runs one warp a head."""
    _check_packed(cuda, t, c, dtype, nhead)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    packed, bias, nw = _packed_case(cuda, 4, 16, 48, [2, 2], torch.float32)
    with pytest.raises(ValueError, match='head_dim'):
        window_attention_packed(packed, bias, 16, nw)            # head_dim 3
    with pytest.raises(TypeError):
        window_attention_packed(packed.half(), bias, NHEAD, nw)
    with pytest.raises(ValueError, match='contiguous'):
        window_attention_packed(packed.transpose(0, 1).contiguous().transpose(0, 1),
                                bias, NHEAD, nw)
    with pytest.raises(ValueError, match='nw'):
        window_attention_packed(packed, bias, NHEAD, nw[:1].repeat(3))
    with pytest.raises(ValueError, match='bias'):
        window_attention_packed(packed, bias.half(), NHEAD, nw)


def _unpacked_case(device, t, c, dtype, nhead):
    """q, k, v for B4 (N = 2 attention groups); window 1 fully padded, its
    v rows random (padded rows need not be zero)."""
    n = 2 * attention_group(t, c, torch.tensor([], dtype=dtype).element_size())
    packed, bias, _ = _packed_case(device, n, t, c, [n // 2, n // 2], torch.float32,
                                   nhead=nhead)
    q, k, v = (x.contiguous().to(dtype) for x in packed.split(c, dim=-1))
    v[1] = torch.randn(t, c, device=device).to(dtype)
    return q, k, v, bias


def _check_unpacked(q, k, v, bias, nhead):
    """B4 against its plain version; window 1 must give the mean of its own
    v rows, as the plain version (and the JAX oracle) do."""
    (n, t, c), dtype = q.shape, q.dtype
    before = fused_window_attention.launches
    got = fused_window_attention(q, k, v, bias, nhead)
    torch.cuda.synchronize()
    assert fused_window_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == (n, t, c)
    got = got.float()
    want = fused_window_attention_plain(q, k, v, bias, nhead).float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        err = (got - want).abs()
        bound = train_forward_bound(want, torch.cat([q, k, v], -1), nhead, 0.0)
        assert bool((err <= bound).all()), float(err.max())
    torch.testing.assert_close(got[1], v[1].float().mean(0).expand(t, c), rtol=1e-2, atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('t,c', [(16, 48), (32, 96), (64, 384), (800, 48), (800, 384)])
def test_unpacked_kernel_matches_plain(cuda, t, c, dtype):
    """B4: every window computed, window 1 fully padded."""
    _check_unpacked(*_unpacked_case(cuda, t, c, dtype, NHEAD), NHEAD)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('nhead,t,c', [(4, 64, 96), (16, 32, 96), (12, 48, 72), (16, 64, 384),
                                       (3, 32, 18)])
def test_unpacked_kernel_matches_plain_at_other_head_counts(cuda, nhead, t, c, dtype):
    """More than 8 heads run in groups of 8 (the last group may be smaller:
    12 = 8 + 4); C = 18 is not a multiple of 8, so bf16 keeps the FMA body."""
    _check_unpacked(*_unpacked_case(cuda, t, c, dtype, nhead), nhead)


def _kernel_names(fn):
    """Names of the CUDA kernels that fn() launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if 'window_attention' in e.name]


def _bodies(names):
    """(tensor-core launches, FMA-body launches) among kernel names."""
    return (sum('window_attention_mma_kernel' in x for x in names),
            sum('window_attention_kernel' in x for x in names))


@pytest.mark.cuda
def test_eval_kernel_body_follows_dtype_width_and_alignment(cuda):
    """bf16 with C % 8 == 0 and 16-byte aligned operands runs the
    tensor-core kernel; float32, bf16 with C % 8 != 0 and bf16 operands off
    16-byte alignment run the FMA body; each result matches its plain
    version."""
    for dtype, body in ((torch.bfloat16, (1, 0)), (torch.float32, (0, 1))):
        packed, bias, nw = _packed_case(cuda, 48, 64, 96, [7, 19], dtype)
        assert _bodies(_kernel_names(
            lambda: window_attention_packed(packed, bias, NHEAD, nw))) == body, dtype
        q, k, v, b = _unpacked_case(cuda, 64, 96, dtype, NHEAD)
        assert _bodies(_kernel_names(
            lambda: fused_window_attention(q, k, v, b, NHEAD))) == body, dtype
    q, k, v, b = _unpacked_case(cuda, 32, 18, torch.bfloat16, 3)
    assert _bodies(_kernel_names(lambda: fused_window_attention(q, k, v, b, 3))) == (0, 1)
    # q two bytes past a 16-byte boundary (still contiguous)
    q, k, v, b = _unpacked_case(cuda, 64, 96, torch.bfloat16, NHEAD)
    flat = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)
    q_off = flat[1:].view(q.shape)
    q_off.copy_(q)
    assert q_off.data_ptr() % 16 and q_off.is_contiguous()
    assert _bodies(_kernel_names(lambda: fused_window_attention(q_off, k, v, b, NHEAD))) == (0, 1)
    _check_unpacked(q_off, k, v, b, NHEAD)


def train_attention_check(packed, bias, seed, nw, nhead, rate, gen):
    """B2 forward and backward against the plain version's forward and
    autograd gradient for a random cotangent that is zero past nw. Returns
    (|out err|, the largest of dq, dk and dv's max |grad err| / max |plain
    grad|, plain out, kernel out, kernel dpacked)."""
    n, t, c3 = packed.shape
    out, stats = window_attention_train_forward(packed, bias, seed, nw, nhead, rate)
    x = packed.detach().clone().requires_grad_(True)
    want = window_attention_packed_train_plain(x, bias, seed, nw, nhead, rate)
    wps = n // nw.shape[0]
    live = (torch.arange(n, device=packed.device) % wps) < nw.repeat_interleave(wps)
    gout = torch.randn(n, t, c3 // 3, generator=gen, device=packed.device)
    gout = torch.where(live[:, None, None], gout, 0).to(packed.dtype)
    want.backward(gout)
    dpacked = window_attention_train_backward(packed, bias, seed, nw, out, stats, gout,
                                              nhead, rate)
    torch.cuda.synchronize()
    g_rel = max(float((got - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)
                for got, ref in zip(dpacked.float().split(c3 // 3, -1),
                                    x.grad.float().split(c3 // 3, -1)))
    return (out.float() - want.detach().float()).abs(), g_rel, want.detach().float(), out, dpacked


@pytest.mark.cuda
@pytest.mark.parametrize('rate', [0.0, 0.1])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('t,c', [(16, 48), (32, 96), (32, 192), (64, 384), (100, 96),
                                 (256, 192), (800, 48), (800, 192), (800, 384)])
def test_train_kernels_match_plain(cuda, t, c, dtype, rate):
    packed, bias, nw = _packed_case(cuda, 8 if t >= 800 else 48, t, c,
                                    [2, 3] if t >= 800 else [7, 19], dtype)
    seed = torch.tensor([12345], dtype=torch.int32, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    before = (window_attention_train_forward.launches,
              window_attention_train_backward.launches)
    err, g_rel, want, out, dpacked = train_attention_check(packed, bias, seed, nw, NHEAD,
                                                           rate, gen)
    assert (window_attention_train_forward.launches,
            window_attention_train_backward.launches) == (before[0] + 1, before[1] + 1)
    assert out.dtype == dtype and dpacked.dtype == dtype and dpacked.shape == packed.shape
    if dtype == torch.float32:
        assert float(err.max()) <= 1e-5 + 1e-5 * float(want.abs().max()), float(err.max())
        assert g_rel <= 1e-4, g_rel
    else:
        assert bool((err <= train_forward_bound(want, packed, NHEAD, rate)).all()), \
            float(err.max())
        assert g_rel <= 4 * 2.0 ** -7, g_rel
    n, wps = packed.shape[0], packed.shape[0] // 2
    for s, count in enumerate(nw.tolist()):            # windows past nw: zeros
        assert not out[s * wps + count:(s + 1) * wps].any()
        assert not dpacked[s * wps + count:(s + 1) * wps].any()
    assert bool(torch.isfinite(dpacked.float()).all())  # incl. the fully padded window


@pytest.mark.cuda
def test_train_autograd_function_uses_both_kernels(cuda):
    packed, bias, nw = _packed_case(cuda, 16, 32, 96, [5, 8], torch.float32)
    seed = torch.tensor([7], dtype=torch.int32, device=cuda)
    x = packed.clone().requires_grad_(True)
    before = (window_attention_train_forward.launches,
              window_attention_train_backward.launches)
    out = window_attention_packed_train(x, bias, seed, nw, NHEAD, 0.1)
    out.square().sum().backward()
    assert (window_attention_train_forward.launches,
            window_attention_train_backward.launches) == (before[0] + 1, before[1] + 1)
    y = packed.clone().requires_grad_(True)
    window_attention_packed_train_plain(y, bias, seed, nw, NHEAD, 0.1).square().sum().backward()
    torch.testing.assert_close(x.grad, y.grad, rtol=1e-4, atol=1e-4 * float(y.grad.abs().max()))


@pytest.mark.cuda
def test_nearest_point_matches_plain_with_ties_and_no_valid_point(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    b, q, p = 2, 1000, 5000
    # a coarse grid: many equal distances (a query at a cell centre is
    # equidistant from the 8 grid points around it)
    points = torch.randint(0, 12, (b, p, 3), generator=gen, device=cuda).float() * 0.2
    queries = (torch.randint(0, 6, (b, q, 3), generator=gen, device=cuda).float() * 2 + 1) * 0.2
    valid = torch.rand(b, p, generator=gen, device=cuda) > 0.3
    valid[1] = False                                   # sample 1: no valid point
    before = nearest_point.launches
    got = nearest_point(queries, points, valid)
    torch.cuda.synchronize()
    assert nearest_point.launches == before + 1
    want = nearest_point_plain(queries, points, valid)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (got[1] == -1).all() and (got[0] >= 0).all()
    assert bool(valid[0][got[0].long()].all())
    # duplicated points: the lowest index wins, never the copy
    dup = torch.cat([points[:, :10], points[:, :10]], dim=1).contiguous()
    ones = torch.ones(b, 20, dtype=torch.bool, device=cuda)
    idx = nearest_point(dup[:, :10].contiguous(), dup, ones)
    assert bool((idx <= torch.arange(10, device=cuda)).all())
    torch.testing.assert_close(idx, nearest_point_plain(dup[:, :10].contiguous(), dup, ones),
                               rtol=0, atol=0)

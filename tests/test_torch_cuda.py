"""The CUDA kernels against their plain PyTorch versions, on the same GPU:
window attention (eval, B1), the unpacked window attention (B4), the train
attention forward and backward (B2),
the 1-NN search (B3, with its split search's edge cases) and the sparse
conv's gather-GEMM and weight-gradient kernels. Every test here needs an
NVIDIA GPU with nvcc and skips without one; on the GPU machine run them with

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
drop rate 0.1 as at 0; the bits the bf16 forward stores equal the plain
packer's to the bit, and the bf16 backward (no atomics) gives the same bits
twice. The bf16 eval kernel in every block shape (16-, 32- and 64-row
blocks) holds the same bound. 1-NN: indices equal. Sparse conv, against
the exact (float64) sums of the same bf16 values: forward and dx (one
rounding of a float32 sum to bf16) within 2**-8 |sum| + 2**-14 x the sum of
the products' magnitudes (``gemm_bound``); dW within 1e-5 of its largest
element, chip_smoke's gate; every kernel bit-equal on a rerun.
"""

import pytest
import torch

from openseg3d_tpu_torch.ops.attention import (_launch_cuda, _launch_unpacked, attention_group,
                                               dropout_keep_mask, eval_launch_shapes, eval_rows,
                                               eval_shape, fused_window_attention,
                                               fused_window_attention_plain, pack_keep_bits,
                                               train_backward_shape, train_forward_bound,
                                               window_attention_packed,
                                               window_attention_packed_plain,
                                               window_attention_packed_train,
                                               window_attention_packed_train_plain,
                                               window_attention_train_backward,
                                               window_attention_train_forward)
from openseg3d_tpu_torch.ops.knn import nearest_point, nearest_point_plain
from openseg3d_tpu_torch.ops.scatter import take_rows_or_zero
from openseg3d_tpu_torch.ops.sparse_conv import (DW_CHUNK, GEMM_TABLE, GRAD_TABLE, SparseTensor,
                                                 apply_sparse_conv, build_downsample,
                                                 build_subm_rulebook, gather_gemm, grad_splits,
                                                 grad_tile, tile_shapes, weight_grad)

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


@pytest.mark.cuda
@pytest.mark.parametrize('t,c,nhead,n,nw', [
    (800, 384, 8, 2, [1, 0]), (800, 48, 8, 2, [1, 0]), (512, 96, 8, 8, [3, 2]),
    (256, 192, 8, 12, [5, 4]), (128, 96, 4, 12, [5, 4]), (64, 48, 2, 16, [6, 5]),
    (100, 48, 1, 12, [4, 5]), (48, 96, 16, 12, [4, 5]), (32, 24, 4, 16, [5, 6]),
    (16, 48, 8, 48, [7, 19])])
def test_eval_launch_shapes_match_plain(cuda, t, c, nhead, n, nw):
    """bf16 B1 in every block shape (16-, 32- and 64-row blocks; the private
    launch, which forces one) at T = 800 with one live window, the
    few-window and many-window levels, T off the 16-row tiles, nhead 1, 2,
    4, 8 and 16: within the bound of the plain version, windows past nw and
    the fully padded window zero, one launch a call; the public op runs the
    table's shape."""
    packed, bias, nwt = _packed_case(cuda, n, t, c, nw, torch.bfloat16, nhead=nhead)
    want = window_attention_packed_plain(packed, bias, nhead, nwt).float()
    lim = train_forward_bound(want, packed, nhead, 0.0)
    wps = n // 2
    shapes = eval_launch_shapes(t, c // nhead, nhead)
    assert 16 in shapes and len(shapes) > 1
    for rows in shapes:
        before = window_attention_packed.launches
        got = _launch_cuda(packed, bias, nhead, nwt, rows)
        torch.cuda.synchronize()
        assert window_attention_packed.launches == before + 1
        err = (got.float() - want).abs()
        assert bool((err <= lim).all()), (rows, float(err.max()))
        assert not got[1].any(), rows
        for s_, count in enumerate(nw):
            assert not got[s_ * wps + count:(s_ + 1) * wps].any(), rows
    chosen = _launch_cuda(packed, bias, nhead, nwt, eval_rows(t, c // nhead))
    assert torch.equal(window_attention_packed(packed, bias, nhead, nwt), chosen)


@pytest.mark.cuda
def test_eval_shape_the_kernel_refuses_raises(cuda):
    """A block shape past the kernel's limits (no 64-row block at head_dim
    6) is refused by eval_shape before any launch, and nothing is
    counted."""
    packed, bias, nw = _packed_case(cuda, 4, 16, 48, [2, 2], torch.bfloat16)
    before = window_attention_packed.launches
    with pytest.raises(ValueError, match='64-row'):
        _launch_cuda(packed, bias, NHEAD, nw, 64)
    assert window_attention_packed.launches == before
    assert eval_shape(16, 6, NHEAD, 16) == (8, 1, 64)


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


@pytest.mark.cuda
@pytest.mark.parametrize('t,c,nhead', [(800, 384, 8), (256, 96, 8), (64, 96, 4), (64, 384, 16)])
def test_unpacked_launch_shapes_fully_padded_window(cuda, t, c, nhead):
    """bf16 B4 in every block shape: within the bound, the fully padded
    window 1 the mean of its own v rows."""
    q, k, v, bias = _unpacked_case(cuda, t, c, torch.bfloat16, nhead)
    want = fused_window_attention_plain(q, k, v, bias, nhead).float()
    lim = train_forward_bound(want, torch.cat([q, k, v], -1), nhead, 0.0)
    mean = v[1].float().mean(0).expand(t, c)
    for rows in eval_launch_shapes(t, c // nhead, nhead):
        got = _launch_unpacked(q, k, v, bias, nhead, rows)
        torch.cuda.synchronize()
        err = (got.float() - want).abs()
        assert bool((err <= lim).all()), (rows, float(err.max()))
        assert bool(((got[1].float() - mean).abs() <= lim[1] + 1e-6).all()), rows


def _kernel_names(fn):
    """Names of the CUDA kernels that fn() launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if 'window_attention' in e.name]


def _bodies(names, mma='window_attention_mma_kernel'):
    """(tensor-core launches, FMA-body launches) among kernel names; mma:
    the tensor-core kernel's name with its template arguments (head width,
    key tile) as the profiler gives them."""
    return (sum(mma in x for x in names), sum('window_attention_kernel' in x for x in names))


@pytest.mark.cuda
def test_eval_kernel_body_follows_dtype_width_and_alignment(cuda):
    """bf16 with C % 8 == 0 and 16-byte aligned operands runs the
    tensor-core kernel, window_attention_mma_kernel<head width, key tile>
    (here <12, 64>); float32, bf16 with C % 8 != 0 and bf16 operands off
    16-byte alignment run the FMA body; each result matches its plain
    version."""
    for dtype, body in ((torch.bfloat16, (1, 0)), (torch.float32, (0, 1))):
        packed, bias, nw = _packed_case(cuda, 48, 64, 96, [7, 19], dtype)
        assert _bodies(_kernel_names(lambda: window_attention_packed(packed, bias, NHEAD, nw)),
                       'window_attention_mma_kernel<12, 64>') == body, dtype
        q, k, v, b = _unpacked_case(cuda, 64, 96, dtype, NHEAD)
        assert _bodies(_kernel_names(lambda: fused_window_attention(q, k, v, b, NHEAD)),
                       'window_attention_mma_kernel<12, 64>') == body, dtype
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


def train_attention_check(packed, bias, seed, nw, nhead, rate, gen, rows=None, one_pass=None):
    """B2 forward and backward against the plain version's forward and
    autograd gradient for a random cotangent that is zero past nw (rows and
    one_pass: the bf16 block shapes, None for the tables'). Returns
    (|out err|, the largest of dq, dk and dv's max |grad err| / max |plain
    grad|, plain out, kernel out, kernel dpacked, bits, the backward's
    arguments)."""
    n, t, c3 = packed.shape
    out, stats, bits = window_attention_train_forward(packed, bias, seed, nw, nhead, rate,
                                                      rows=rows)
    x = packed.detach().clone().requires_grad_(True)
    want = window_attention_packed_train_plain(x, bias, seed, nw, nhead, rate)
    wps = n // nw.shape[0]
    live = (torch.arange(n, device=packed.device) % wps) < nw.repeat_interleave(wps)
    gout = torch.randn(n, t, c3 // 3, generator=gen, device=packed.device)
    gout = torch.where(live[:, None, None], gout, 0).to(packed.dtype)
    want.backward(gout)
    bwd_args = (packed, bias, seed, nw, out, stats, bits, gout, nhead, rate)
    dpacked = window_attention_train_backward(*bwd_args, one_pass=one_pass)
    torch.cuda.synchronize()
    g_rel = max(float((got - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)
                for got, ref in zip(dpacked.float().split(c3 // 3, -1),
                                    x.grad.float().split(c3 // 3, -1)))
    return ((out.float() - want.detach().float()).abs(), g_rel, want.detach().float(), out,
            dpacked, bits, bwd_args)


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
    err, g_rel, want, out, dpacked, _, _ = train_attention_check(packed, bias, seed, nw, NHEAD,
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
@pytest.mark.parametrize('t,c', [(16, 48), (64, 96), (100, 192), (256, 192), (128, 384),
                                 (512, 96)])
def test_train_bf16_block_shapes_and_stored_bits(cuda, t, c):
    """bf16 at rate 0.1, every block shape of both kernels (forward 16 and,
    above head_dim 6, 64 rows; backward in one pass where the table takes
    it, and in two): the
    stored bits equal the plain packer's on the live windows, forward and
    gradients within their bounds of the plain version, and two backward
    calls bit-equal."""
    packed, bias, nw = _packed_case(cuda, 12, t, c, [4, 5], torch.bfloat16)
    seed = torch.tensor([99], dtype=torch.int32, device=cuda)
    live = (torch.arange(12, device=cuda) % 6) < nw.repeat_interleave(6)
    keep = dropout_keep_mask(seed, 12, NHEAD, t, 0.1) & live[:, None, None, None]
    passes = (True, False) if train_backward_shape(t, c // NHEAD, NHEAD)[0] else (False,)
    for rows in (16, 64) if c // NHEAD > 6 else (16,):   # no 64-row block at head_dim 6
        for one_pass in passes:
            gen = torch.Generator(device=cuda).manual_seed(3)
            err, g_rel, want, out, dpacked, bits, args = train_attention_check(
                packed, bias, seed, nw, NHEAD, 0.1, gen, rows, one_pass)
            stored = torch.where(live[:, None, None, None, None], bits.view(torch.int32), 0)
            assert torch.equal(stored, pack_keep_bits(keep).view(torch.int32)), (rows, one_pass)
            assert bool((err <= train_forward_bound(want, packed, NHEAD, 0.1)).all()), \
                (rows, one_pass, float(err.max()))
            assert g_rel <= 4 * 2.0 ** -7, (rows, one_pass, g_rel)
            again = window_attention_train_backward(*args, one_pass=one_pass)
            assert torch.equal(again.view(torch.int16), dpacked.view(torch.int16)), one_pass


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


@pytest.mark.cuda
@pytest.mark.parametrize('rows', [2048, 50000, 166400])
def test_weight_gradient_product_sums_in_float32(cuda, rows):
    """The sparse conv's dW kernel (x^T G through the transposed rulebook,
    bf16 operands, float32 result) within 1e-5 of max|dW| of the exact sum
    (float64 of the same bf16 values; each product of two bf16 values is
    exact in float32), at the main path's longest contraction (166400 rows
    a sample): every row pairs with itself at every offset, so each dW[k] is
    the whole x^T g."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(1, rows, 96, generator=gen, device=cuda).bfloat16()
    g = torch.randn(1, rows, 32, generator=gen, device=cuda).bfloat16()
    tr = torch.arange(rows, dtype=torch.int32, device=cuda).expand(1, 27, rows).contiguous()
    got = weight_grad(x, tr, g)
    assert got.dtype == torch.float32 and got.shape == (27, 96, 32)
    want = x[0].double().t() @ g[0].double()
    err = float((got.double() - want).abs().max()) / float(want.abs().max())
    assert err <= 1e-5, err


# ---------------------------------------------------------------------------
# sparse conv: the gather-GEMM and weight-gradient kernels
# ---------------------------------------------------------------------------

def conv_scene(device, seed, v=4608, grid=(10, 40, 40), fill=(0.25, 0.12), empty=()):
    """Voxel coords [B, v, 3] in ascending key order with padding (-1) at the
    end, as the voxelizer emits them: sample i keeps each cell of the grid
    with probability fill[i] (samples in `empty` keep none), so rows share
    most neighbours and some tiles hold a single live offset."""
    gen = torch.Generator(device=device).manual_seed(seed)
    cells = torch.stack(torch.meshgrid(*[torch.arange(n, device=device) for n in grid],
                                       indexing='ij'), -1).reshape(-1, 3).int()
    coords = torch.full((len(fill), v, 3), -1, dtype=torch.int32, device=device)
    for i, p in enumerate(fill):
        if i in empty:
            continue
        keep = cells[torch.rand(len(cells), generator=gen, device=device) < p][:v]
        coords[i, :len(keep)] = keep
    return SparseTensor(None, coords, grid)


def conv_cases(st):
    """[(kind, rulebook, input mask, output mask)]: the subm conv, the
    strided conv into the coarse level and the inverse conv back."""
    plan = build_downsample(st, out_capacity=st.coords.shape[1] // 2)
    coarse = plan.out_coords[..., 0] >= 0
    return [('subm', build_subm_rulebook(st), st.mask, st.mask),
            ('strided', plan.rule, st.mask, coarse),
            ('inverse', plan.inv_rule, coarse, st.mask)]


def gemm_exact(x, idx, w, src_mask=None, dst_mask=None):
    """(the exact float64 gather-GEMM of the same bf16 values, the same sum
    of the products' magnitudes)."""
    b, k3, vo = idx.shape
    x = x.double()
    if src_mask is not None:
        x = torch.where(src_mask[..., None], x, 0)
    rows = take_rows_or_zero(x, idx.transpose(1, 2).reshape(b, vo * k3)).reshape(b, vo, -1)
    w = w.double().reshape(-1, w.shape[-1])
    exact, mag = rows @ w, rows.abs() @ w.abs()
    if dst_mask is not None:
        exact = torch.where(dst_mask[..., None], exact, 0)
    return exact, mag


def gemm_bound(exact, mag):
    """bf16's rounding of the float32 sum (half a unit in the last of its 8
    bits: 2**-8 |sum|) and the float32 sum's own error (2**-14 of the sum of
    the products' magnitudes: the tensor cores' float32 accumulation over up
    to 27 x 768 products)."""
    return 2.0 ** -8 * exact.abs() + 2.0 ** -14 * mag


def check_gemm(x, idx, w, src_mask=None, dst_mask=None, tile=None):
    """The kernel twice (bit-equal, one launch each) against the exact sum;
    masked rows exactly zero. Returns the output."""
    before = gather_gemm.launches
    got = gather_gemm(x, idx, w, src_mask, dst_mask, tile=tile)
    again = gather_gemm(x, idx, w, src_mask, dst_mask, tile=tile)
    torch.cuda.synchronize()
    assert gather_gemm.launches == before + 2
    assert got.dtype == torch.bfloat16 and got.shape == (x.shape[0], idx.shape[2], w.shape[2])
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))
    exact, mag = gemm_exact(x, idx, w, src_mask, dst_mask)
    err = (got.double() - exact).abs()
    assert bool((err <= gemm_bound(exact, mag)).all()), float(err.max())
    if dst_mask is not None:
        assert not got[~dst_mask].any()
    return got


def check_weight_grad(x, tr, g, src_mask, tile=None):
    """dW twice (bit-equal, one launch each) within 1e-5 of max|dW| of the
    exact sum, chip_smoke's gate."""
    before = weight_grad.launches
    got = weight_grad(x, tr, g, src_mask, tile=tile)
    again = weight_grad(x, tr, g, src_mask, tile=tile)
    torch.cuda.synchronize()
    assert weight_grad.launches == before + 2
    assert got.dtype == torch.float32 and got.shape == (27, x.shape[2], g.shape[2])
    assert torch.equal(got, again)
    b, v, cin = x.shape
    gm = torch.where(src_mask[..., None], g.double(), 0)
    rows = take_rows_or_zero(gm, tr.transpose(1, 2).reshape(b, v * 27)).reshape(b * v, 27, -1)
    want = torch.einsum('uc,ukn->kcn', x.double().reshape(b * v, cin), rows)
    err = float((got.double() - want).abs().max()) / max(float(want.abs().max()), 1e-30)
    assert err <= 1e-5, err
    return got


def conv_operands(st, rb, in_mask, out_mask, cin, cout, seed):
    """bf16 features (zero on padding rows, as the model's), weights and a
    cotangent with values on masked rows too (the kernels must mask them)."""
    gen = torch.Generator(device=in_mask.device).manual_seed(seed)
    dev = in_mask.device
    b = in_mask.shape[0]
    x = torch.randn(b, in_mask.shape[1], cin, generator=gen, device=dev)
    x = torch.where(in_mask[..., None], x, 0).bfloat16()
    w = (torch.randn(27, cin, cout, generator=gen, device=dev) / (27 * cin) ** 0.5).bfloat16()
    g = torch.randn(b, out_mask.shape[1], cout, generator=gen, device=dev).bfloat16()
    return x, w, g


@pytest.mark.cuda
@pytest.mark.parametrize('cin,cout', sorted(set(GRAD_TABLE)) + [(6, 48), (6, 32), (96, 1)])
def test_sparse_conv_kernels_match_exact_sums(cuda, cin, cout):
    """Forward, dx and dW of every conv width the configurations build (and
    the multi-sweep stem's Cin = 6, SALayer's Cout = 1) on submanifold,
    strided and inverse rulebooks, each through the table's tiles."""
    st = conv_scene(cuda, seed=cin + cout, v=4608 if cin * cout < 2 ** 17 else 2048)
    for kind, rb, in_mask, out_mask in conv_cases(st):
        x, w, g = conv_operands(st, rb, in_mask, out_mask, cin, cout, seed=cin)
        check_gemm(x, rb.in_idx, w, dst_mask=out_mask)
        dx_mask = in_mask if kind == 'subm' else None
        dx = check_gemm(g, rb.transpose, w.transpose(1, 2).contiguous(), out_mask, dx_mask)
        if kind == 'subm':
            assert not dx[~in_mask].any()
        check_weight_grad(x, rb.transpose, g, out_mask)


@pytest.mark.cuda
@pytest.mark.parametrize('cin,cout', [(64, 64), (96, 192), (768, 384), (256, 128)])
def test_sparse_conv_every_tile_matches_exact_sums(cuda, cin, cout):
    """Every tile of both kernels (what chip_smoke times) on the subm
    rulebook holds the same bounds."""
    st = conv_scene(cuda, seed=5, v=2048)
    _, rb, mask, _ = conv_cases(st)[0]
    x, w, g = conv_operands(st, rb, mask, mask, cin, cout, seed=6)
    for tile in range(len(tile_shapes('gather_gemm'))):
        check_gemm(x, rb.in_idx, w, dst_mask=mask, tile=tile)
    for tile in range(len(tile_shapes('weight_grad'))):
        check_weight_grad(x, rb.transpose, g, mask, tile=tile)


@pytest.mark.cuda
def test_sparse_conv_tables_name_the_kernels_tiles(cuda):
    """Every table entry indexes a tile the library defines (its shapes
    come from csrc/sparse_conv.cu, whose static_asserts hold each within 256
    threads and 227 KB), a tile index past them is refused at launch, and
    the weight gradient's float32 partials stay under 0.1 GB at every
    width at the largest stage capacity of a batch of 2."""
    from openseg3d_tpu_torch.config import cfg_from_file
    from openseg3d_tpu_torch.models.backbones.sparse_unet import stage_capacities
    gemm, grad = tile_shapes('gather_gemm'), tile_shapes('weight_grad')
    assert all(r % 16 == 0 and c % 16 == 0 for r, c in gemm + grad), (gemm, grad)
    assert set(GEMM_TABLE.values()) <= set(range(len(gemm)))
    assert set(GRAD_TABLE.values()) <= set(range(len(grad)))
    cfg = cfg_from_file('configs/waymo_one_sweep.yaml')
    caps = stage_capacities(cfg.RUNTIME.MAX_VOXELS_PER_SAMPLE, cfg.RUNTIME.STAGE_CAPACITY_RATIOS)
    chunks = 2 * -(-max(caps) // DW_CHUNK)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for cin, cout in GRAD_TABLE:
        splits = grad_splits(chunks, cin, cout, grad_tile(cin, cout), sms)
        assert 1 <= splits <= chunks
        assert splits * 27 * cin * cout * 4 <= 0.1e9, (cin, cout, splits)
    x = torch.zeros(1, 64, 16, dtype=torch.bfloat16, device=cuda)
    idx = torch.full((1, 27, 64), -1, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match='launch failed'):
        gather_gemm(x, idx, torch.zeros(27, 16, 16, dtype=torch.bfloat16, device=cuda),
                    tile=len(gemm))
    with pytest.raises(ValueError, match='no weight-gradient tile'):
        weight_grad(x, idx, torch.zeros(1, 64, 16, dtype=torch.bfloat16, device=cuda),
                    tile=len(grad))


@pytest.mark.cuda
def test_sparse_conv_kernels_on_degenerate_rulebooks(cuda):
    """An all-padding sample, a tile whose only live offset is the centre,
    and a rulebook of only -1: exact zeros where nothing is gathered."""
    st = conv_scene(cuda, seed=3, v=2048, empty=(1,))
    for kind, rb, in_mask, out_mask in conv_cases(st):
        x, w, g = conv_operands(st, rb, in_mask, out_mask, 64, 64, seed=4)
        out = check_gemm(x, rb.in_idx, w, dst_mask=out_mask)
        assert not out[1].any(), kind
        check_weight_grad(x, rb.transpose, g, out_mask)
    b, v = 2, 300
    gen = torch.Generator(device=cuda).manual_seed(8)
    x = torch.randn(b, v, 32, generator=gen, device=cuda).bfloat16()
    w = torch.randn(27, 32, 48, generator=gen, device=cuda).bfloat16()
    g = torch.randn(b, v, 48, generator=gen, device=cuda).bfloat16()
    centre = torch.full((b, 27, v), -1, dtype=torch.int32, device=cuda)
    centre[:, 13, :70] = torch.arange(70, dtype=torch.int32, device=cuda)
    assert not check_gemm(x, centre, w)[:, 70:].any()
    mask = torch.ones(b, v, dtype=torch.bool, device=cuda)
    check_weight_grad(x, centre, g, mask)
    none = torch.full((b, 27, v), -1, dtype=torch.int32, device=cuda)
    assert not check_gemm(x, none, w).any()
    assert not check_weight_grad(x, none, g, mask).any()


@pytest.mark.cuda
def test_sparse_conv_autograd_runs_the_kernels(cuda):
    """apply_sparse_conv on bf16 features on the card: the forward one
    gather-GEMM launch, the backward one for dx and one weight-gradient
    launch, and the gradients within the kernels' bounds of the exact sums;
    float32 features run the plain path, uncounted."""
    st = conv_scene(cuda, seed=9, v=2048)
    kind, rb, in_mask, out_mask = conv_cases(st)[1]
    x, w, g = conv_operands(st, rb, in_mask, out_mask, 48, 96, seed=10)
    wp = w.float().requires_grad_(True)
    xp = x.clone().requires_grad_(True)
    before = (gather_gemm.launches, weight_grad.launches)
    out = apply_sparse_conv(xp, rb, wp, out_mask, torch.bfloat16)
    out.backward(g)
    assert (gather_gemm.launches, weight_grad.launches) == (before[0] + 2, before[1] + 1)
    exact, mag = gemm_exact(x, rb.in_idx, w, None, out_mask)
    assert bool(((out.double() - exact).abs() <= gemm_bound(exact, mag)).all())
    exact, mag = gemm_exact(g, rb.transpose, w.transpose(1, 2), out_mask)
    assert bool(((xp.grad.double() - exact).abs() <= gemm_bound(exact, mag)).all())
    assert wp.grad.dtype == torch.float32
    check_weight_grad(x, rb.transpose, g, out_mask)
    before = (gather_gemm.launches, weight_grad.launches)
    x32 = x.float().requires_grad_(True)
    apply_sparse_conv(x32, rb, w.float(), out_mask).backward(g.float())
    assert (gather_gemm.launches, weight_grad.launches) == before


def nearest_point_edge_cases(device, gen):
    """[(name, queries, points, valid)] for the split search: every split
    boundary straddled by a tie (the point before it duplicated after it,
    queries on both copies), P a multiple of neither the split nor the
    chunk, Q not a multiple of the query tile, an all-invalid sample, B = 2
    with different valid counts and padding past the last valid point, and
    P smaller than one chunk."""
    from openseg3d_tpu_torch.ops.knn import split_plan
    cases = []
    b, q, p = 2, 3001, 40000 + 77
    _, span = split_plan(b, q, p, device)
    points = torch.randint(0, 40, (b, p, 3), generator=gen, device=device).float() * 0.25
    bounds = torch.arange(span, p, span, device=device)
    assert bounds.numel() > 0, (p, span)
    points[:, bounds] = points[:, bounds - 1]
    queries = (torch.randint(0, 20, (b, q, 3), generator=gen, device=device).float() * 2 + 1) * 0.25
    queries[:, :bounds.numel()] = points[:, bounds]
    valid = torch.ones(b, p, dtype=torch.bool, device=device)
    valid[1, 30000:] = False                      # sample 1: padding past 30000
    valid[1, :5000] = torch.rand(5000, generator=gen, device=device) > 0.5
    cases.append(('ties at split boundaries, B = 2, padded tail', queries, points.contiguous(),
                  valid))
    none = valid.clone()
    none[0] = False
    cases.append(('an all-invalid sample', queries, points.contiguous(), none))
    small_p = points[:, :300].contiguous()
    cases.append(('P below one chunk', queries[:, :77].contiguous(), small_p,
                  torch.ones(b, 300, dtype=torch.bool, device=device)))
    return cases


@pytest.mark.cuda
def test_nearest_point_split_edge_cases_match_plain(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    for name, queries, points, valid in nearest_point_edge_cases(cuda, gen):
        got = nearest_point(queries, points, valid)
        want = nearest_point_plain(queries, points, valid)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (name, int((got != want).sum()))
        assert bool(((got >= 0) == valid.any(dim=1, keepdim=True)).all()), name
    # the boundary ties went to the copy before the boundary
    from openseg3d_tpu_torch.ops.knn import split_plan
    name, queries, points, valid = nearest_point_edge_cases(cuda, gen)[0]
    _, span = split_plan(*queries.shape[:2], points.shape[1], cuda)
    bounds = torch.arange(span, points.shape[1], span, device=cuda)
    got = nearest_point(queries, points, valid)[0, :bounds.numel()]
    assert bool((got < bounds).all()), (got, bounds)

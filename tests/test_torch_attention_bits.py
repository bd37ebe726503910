"""The stored dropout bits of the train attention (B2f writes them, B2b reads
them) and the plain versions of the train kernels' interface on the CPU:
``pack_keep_bits`` against ``dropout_keep_mask``, the plain backward that
takes the bits against autograd through ``window_attention_packed_train_plain``
and, at drop rate 0, against the JAX package's Pallas train kernel (interpret
mode, as tests/test_torch_attention.py runs it), and the bf16 kernels' block
shapes. The CUDA kernels against these plain versions are in chip_smoke.py
(phase 3b) and tests/test_torch_cuda.py.

Tolerances. The plain backward and autograd compute the same float32 sums in
another order: P from the forward's (max, sum) instead of the softmax, and
D = dO . O instead of rowsum(P dP), each within a few float32 ulps, so each
of dq, dk and dv is held to 1e-5 of its largest magnitude. bf16: the plain
backward takes D = dO . O from the bf16 output, as the kernel does, where
autograd sums P dP in float32; each part is held to the 4 bf16 ulps of its
largest magnitude that the card holds the kernel to. Against the Pallas kernel
at drop rate 0: the 2e-4 of tests/test_torch_attention.py (sums of T
products of float32 softmax terms whose logits reach ~100).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openseg3d_tpu.ops.attention import _train_group
from openseg3d_tpu.ops.attention import \
    window_attention_packed_train as jax_window_attention_packed_train

from openseg3d_tpu_torch.ops.attention import (TRAIN_BWD_ONE_PASS, TRAIN_FWD_HEADS,
                                               TRAIN_FWD_ROWS64, dropout_keep_mask,
                                               keep_bits_shape, pack_keep_bits,
                                               train_backward_shape,
                                               train_forward_shape, unpack_keep_bits,
                                               window_attention_packed_train_plain,
                                               window_attention_train_backward,
                                               window_attention_train_backward_plain,
                                               window_attention_train_forward,
                                               window_attention_train_forward_plain)
from test_torch_attention import GRAD_BOUND_BF16, NHEAD, _max_grad_rel, _packed_case, _seed


@pytest.mark.parametrize('t', [16, 40, 128])
def test_pack_keep_bits_round_trips_to_the_mask(t):
    """The packer's layout, bit by bit against Python integers (bit 4 g + t
    of word (2 nt + r) * 2 + x of tile (rt, kt) is the weight of query
    16 rt + g + 8 r and key 16 kt + 8 nt + 2 t + x), the padding past T
    zero, and the round trip."""
    n, seed = 3, _seed(77)
    keep = dropout_keep_mask(seed, n, NHEAD, t, 0.1)
    bits = pack_keep_bits(keep)
    tt = -(-t // 16)
    assert bits.dtype == torch.uint32 and tuple(bits.shape) == (n, NHEAD, tt, tt, 8) \
        == keep_bits_shape(n, NHEAD, t)
    assert torch.equal(unpack_keep_bits(bits, t), keep)
    words = bits.view(torch.int32).long() & 0xFFFFFFFF
    rng = np.random.RandomState(t)
    for _ in range(200):
        wi, h, rt, kt = rng.randint(n), rng.randint(NHEAD), rng.randint(tt), rng.randint(tt)
        nt, r, x, g, lane_t = (rng.randint(k) for k in (2, 2, 2, 8, 4))
        i, j = 16 * rt + g + 8 * r, 16 * kt + 8 * nt + 2 * lane_t + x
        bit = (int(words[wi, h, rt, kt, (2 * nt + r) * 2 + x]) >> (4 * g + lane_t)) & 1
        assert bit == (int(keep[wi, h, i, j]) if i < t and j < t else 0), (i, j)
    # every set bit is a kept weight: the padding past T is 0
    assert int(((words[..., None] >> torch.arange(32)) & 1).sum()) == int(keep.sum())


def _live_cotangent(rng, n, t, c, nw, wps):
    g = rng.randn(n, t, c).astype(np.float32)
    for s in range(n // wps):
        g[s * wps + nw[s]:(s + 1) * wps] = 0
    return torch.from_numpy(g)


@pytest.mark.parametrize('t,c', [(16, 48), (40, 96), (64, 192)])
def test_backward_plain_with_bits_equals_autograd(t, c):
    """float32 at rate 0.1: the plain backward with the packed bits (and
    with the mask hashed from the seed) equals autograd through the plain
    train attention; zero past nw."""
    rng = np.random.RandomState(t + c)
    wps = 6
    nw = [4, 5]
    packed, bias, nw = _packed_case(rng, 2, wps, t, c, nw)
    p, b, nwt, seed = (torch.from_numpy(packed), torch.from_numpy(bias), torch.from_numpy(nw),
                       _seed(31))
    gout = _live_cotangent(rng, 2 * wps, t, c, nw, wps)
    out, stats, bits = window_attention_train_forward_plain(p, b, seed, nwt, NHEAD, 0.1)
    assert bits is None                              # float32 kernels store no bits
    bits = pack_keep_bits(dropout_keep_mask(seed, 2 * wps, NHEAD, t, 0.1))
    x = p.clone().requires_grad_(True)
    window_attention_packed_train_plain(x, b, seed, nwt, NHEAD, 0.1).backward(gout)
    for given in (bits, None):
        got = window_attention_train_backward_plain(p, b, seed, nwt, out, stats, given, gout,
                                                    NHEAD, 0.1)
        rel = _max_grad_rel(got, x.grad, c)
        assert rel <= 1e-5, (given is None, rel)
        for s in range(2):
            assert not got[s * wps + nw[s]:(s + 1) * wps].any()


def test_backward_plain_bf16_reads_the_forward_bits():
    """bfloat16 at rate 0.1: the forward's plain version stores the bits
    the kernel stores (the packed mask, zero past nw), and the plain
    backward that reads them is within 4 bf16 ulps of autograd."""
    rng = np.random.RandomState(5)
    t, c, wps = 32, 96, 5
    packed, bias, nw = _packed_case(rng, 2, wps, t, c, [3, 5])
    p = torch.from_numpy(packed).bfloat16()
    b, nwt, seed = torch.from_numpy(bias), torch.from_numpy(nw), _seed(-9)
    out, stats, bits = window_attention_train_forward_plain(p, b, seed, nwt, NHEAD, 0.1)
    keep = dropout_keep_mask(seed, 2 * wps, NHEAD, t, 0.1)
    keep[3:wps] = False                              # windows past nw
    assert torch.equal(bits.view(torch.int32), pack_keep_bits(keep).view(torch.int32))
    assert torch.equal(stats[3:wps], torch.tensor([0.0, 1.0]).expand(2, NHEAD, t, 2))
    gout = _live_cotangent(rng, 2 * wps, t, c, nw, wps).bfloat16()
    x = p.clone().requires_grad_(True)
    want = window_attention_packed_train_plain(x, b, seed, nwt, NHEAD, 0.1)
    want.backward(gout)
    assert torch.equal(out, want.detach())
    got = window_attention_train_backward_plain(p, b, seed, nwt, out, stats, bits, gout,
                                                NHEAD, 0.1)
    assert got.dtype == torch.bfloat16
    assert _max_grad_rel(got, x.grad, c) <= GRAD_BOUND_BF16


@pytest.mark.parametrize('t,c', [(16, 48), (64, 96)])
def test_backward_plain_matches_pallas_train_kernel_at_zero_drop(t, c):
    """At drop rate 0 (no bits), the plain backward against the Pallas
    train kernel's VJP (interpret mode) on windows with a valid key: the
    cotangent is zero past nw and on fully padded windows, where the Pallas
    kernel's chunked softmax gives the chunk's mean."""
    rng = np.random.RandomState(3 * t + c)
    b = 2
    wps = 2 * _train_group(t, c, 4)
    packed, bias, nw = _packed_case(rng, b, wps, t, c, [2, wps - 3])
    live = np.zeros((b * wps, 1, 1), np.float32)
    for s in range(b):
        live[s * wps:s * wps + nw[s]] = 1.0
    live[~(bias == 0).any(axis=1)] = 0.0
    w = (rng.randn(b * wps, t, c) * live).astype(np.float32)

    def jax_loss(p):
        o = jax_window_attention_packed_train(p, jnp.asarray(bias), jnp.zeros((1,), jnp.int32),
                                              jnp.asarray(nw), NHEAD, 0.0, True)
        return jnp.sum(o * w)

    jg = np.asarray(jax.grad(jax_loss)(jnp.asarray(packed)))
    p, bt, nwt, seed = (torch.from_numpy(packed), torch.from_numpy(bias), torch.from_numpy(nw),
                        _seed(0))
    out, stats, bits = window_attention_train_forward(p, bt, seed, nwt, NHEAD, 0.0)
    assert bits is None
    got = window_attention_train_backward(p, bt, seed, nwt, out, stats, None,
                                          torch.from_numpy(w), NHEAD, 0.0)
    np.testing.assert_allclose(got.numpy(), jg, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize('hd', [6, 12, 24, 48])
def test_bf16_block_shapes_fit_the_kernels(hd):
    """The block shapes the tables give at T = 16..800 (and the forced
    ones) meet the kernels' limits: heads divide nhead, a block's columns
    are 16-byte pieces, at most 256 threads a forward block and 512 a
    backward one; the one-pass backward only up
    to T = 256 and with every key tile owned; a 64-row forward block covers
    the window's first 64 rows (all of it below 64); the tables' choices
    are those of TRAIN_FWD_ROWS64 and TRAIN_BWD_ONE_PASS."""
    kpw = {6: 2, 12: 2, 24: 1, 48: 1}[hd]
    for t in (16, 32, 40, 64, 100, 128, 256, 512, 800):
        for rows in (None, 16, 64):
            if rows == 64 and TRAIN_FWD_HEADS * hd % 8:
                with pytest.raises(ValueError):     # no 16-byte rows for 2 heads of 6
                    train_forward_shape(t, hd, NHEAD, rows)
                continue
            heads, row_tiles, key_tile = train_forward_shape(t, hd, NHEAD, rows)
            assert NHEAD % heads == 0 and heads * hd % 8 == 0, (t, rows)
            assert 32 * heads * row_tiles <= 256 and key_tile % 16 == 0, (t, rows)
            if rows == 64:
                assert heads == TRAIN_FWD_HEADS
                assert 16 * row_tiles == min(64, -(-t // 16) * 16)
        lo, hi = TRAIN_FWD_ROWS64[hd] or (1, 0)
        assert (train_forward_shape(t, hd, NHEAD)[0] != NHEAD) == (lo <= t <= hi)
        warps = -(-(-(-t // 16)) // kpw)
        possible = t <= 256 and any(NHEAD % h == 0 and h * hd % 8 == 0 and h * warps <= 16
                                    for h in (1, 2, 4, 8))
        for one_pass in (None, True, False):
            if one_pass and not possible:
                with pytest.raises(ValueError):
                    train_backward_shape(t, hd, NHEAD, one_pass)
                continue
            heads, warps = train_backward_shape(t, hd, NHEAD, one_pass)
            if one_pass is None:
                lo, hi = TRAIN_BWD_ONE_PASS[hd]
                assert (heads > 0) == (lo <= t <= min(hi, 256)), t
            if heads == 0:
                assert not one_pass, t
                continue
            assert NHEAD % heads == 0 and heads * hd % 8 == 0 and t <= 256
            assert 32 * heads * warps <= 512 and warps * kpw >= -(-t // 16) > (warps - 1) * kpw


def test_train_wrappers_on_cpu_run_the_plain_versions_uncounted():
    """On CPU tensors the two kernel wrappers run their plain versions and
    count no launch; their results are the plain versions'."""
    rng = np.random.RandomState(2)
    t, c = 16, 48
    packed, bias, nw = _packed_case(rng, 1, 4, t, c, [3])
    p = torch.from_numpy(packed).bfloat16()
    args = (p, torch.from_numpy(bias), _seed(4), torch.from_numpy(nw), NHEAD, 0.1)
    before = (window_attention_train_forward.launches, window_attention_train_backward.launches)
    out, stats, bits = window_attention_train_forward(*args)
    want = window_attention_train_forward_plain(*args)
    for got, ref in zip((out, stats, bits.view(torch.int32)),
                        (want[0], want[1], want[2].view(torch.int32))):
        assert torch.equal(got, ref)
    gout = _live_cotangent(rng, 4, t, c, [3], 4).bfloat16()
    dpk = window_attention_train_backward(*args[:4], out, stats, bits, gout, NHEAD, 0.1)
    assert torch.equal(dpk, window_attention_train_backward_plain(*args[:4], out, stats, bits,
                                                                   gout, NHEAD, 0.1))
    assert (window_attention_train_forward.launches,
            window_attention_train_backward.launches) == before

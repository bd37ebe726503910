"""Window attention: the port's plain versions against the JAX package's
Pallas kernels (run in interpret mode on the CPU, as tests/test_attention.py
runs them) and its einsum oracle, and the public functions' device dispatch.
The CUDA kernels against the plain versions are in tests/test_torch_cuda.py.

Tolerances: eval forward float32 on both sides with the same math in another
summation order, atol/rtol 1e-5. The unpacked op (B4) at the JAX test's own
tolerances (tests/test_attention.py): float32 2e-5, bfloat16 3e-2 (the Pallas
kernel rounds the softmax weights to bf16 before attn @ v; the port keeps
them in float32, as the oracle does). Train path at drop rate 0, as
tests/test_attention.py holds the Pallas train kernel to the oracle: forward
2e-5, packed gradient 2e-4 (the gradient sums T products of float32
softmax terms whose logits reach ~100). At a drop rate above 0 the TPU's
in-kernel PRNG cannot be reproduced, so the tests hold the invariants that
tests/test_attention.py holds on the TPU: same seed same output, another seed
another output, the mean over seeds near the no-drop output, and the autograd
gradient equal to a directional finite difference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openseg3d_tpu.ops.attention import attention_group as jax_attention_group
from openseg3d_tpu.ops.attention import (_train_group, fused_window_attention_packed,
                                         reference_window_attention)
from openseg3d_tpu.ops.attention import fused_window_attention as jax_fused_window_attention
from openseg3d_tpu.ops.attention import \
    window_attention_packed_train as jax_window_attention_packed_train

from openseg3d_tpu_torch.ops.attention import (attention_group, dropout_keep_mask,
                                               dropout_threshold, fused_window_attention,
                                               fused_window_attention_plain, mix32,
                                               window_attention_packed,
                                               window_attention_packed_plain,
                                               window_attention_packed_train,
                                               window_attention_packed_train_plain,
                                               window_attention_train_backward,
                                               window_attention_train_forward)

NHEAD = 8


def _packed_case(rng, b, wps, t, c, nw):
    """Model-shaped inputs: q per-head L2-normalised and scaled by 1/tau, k
    normalised, partially padded windows, fully padded windows at rank >= nw
    (zero rows, -1e9 bias, as the window partition leaves them) and one
    fully padded window below nw."""
    n, hd = b * wps, c // NHEAD

    def unit(x):
        x = x.reshape(n, t, NHEAD, hd)
        return (x / np.linalg.norm(x, axis=-1, keepdims=True)).reshape(n, t, c)

    q = unit(rng.randn(n, t, c)) * rng.uniform(5, 100, c)
    k = unit(rng.randn(n, t, c))
    v = rng.randn(n, t, c)
    packed = np.concatenate([q, k, v], -1).astype(np.float32)
    valid = rng.rand(n, t) > 0.3
    valid[:, 0] = True
    valid[1] = False                                   # a padded window below nw
    for s in range(b):
        valid[s * wps + nw[s]:(s + 1) * wps] = False   # windows past nw
    packed[~valid] = 0.0
    bias = np.where(valid, 0.0, -1e9).astype(np.float32)
    return packed, bias, np.asarray(nw, np.int32)


@pytest.mark.parametrize('t,c', [(16, 48), (16, 96), (32, 48), (32, 96)])
def test_plain_matches_pallas_kernel_and_oracle(t, c):
    rng = np.random.RandomState(t + c)
    b = 2
    wps = 2 * attention_group(t, 2 * c)               # two kernel groups per sample
    nw = [3, wps - 5]
    packed, bias, nw = _packed_case(rng, b, wps, t, c, nw)

    mine = window_attention_packed_plain(torch.from_numpy(packed), torch.from_numpy(bias),
                                         NHEAD, torch.from_numpy(nw)).numpy()
    pallas = np.asarray(fused_window_attention_packed(
        jnp.asarray(packed), jnp.asarray(bias), nhead=NHEAD, interpret=True,
        nw=jnp.asarray(nw)))
    oracle = np.asarray(reference_window_attention(
        jnp.asarray(packed[..., :c]), jnp.asarray(packed[..., c:2 * c]),
        jnp.asarray(packed[..., 2 * c:]), jnp.asarray(bias), nhead=NHEAD))
    # The Pallas kernel attends over chunks of several windows with a
    # block-diagonal bias, so a fully padded window (all keys -1e9) averages
    # the chunk's v rows instead of giving zero; the model never reads those
    # slots. Windows with a real token must agree; the oracle everywhere.
    live = (bias == 0).any(axis=1)
    np.testing.assert_allclose(mine[live], pallas[live], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mine, oracle, rtol=1e-5, atol=1e-5)
    for s in range(b):                                 # windows past nw are zero
        assert not mine[s * wps + nw[s]:(s + 1) * wps].any()
    assert not mine[1].any()                           # fully padded window


def test_cpu_dispatch_is_plain_and_not_counted():
    rng = np.random.RandomState(0)
    packed, bias, nw = _packed_case(rng, 1, 8, 16, 48, [5])
    args = (torch.from_numpy(packed), torch.from_numpy(bias), NHEAD, torch.from_numpy(nw))
    before = window_attention_packed.launches
    out = window_attention_packed(*args)
    assert window_attention_packed.launches == before
    torch.testing.assert_close(out, window_attention_packed_plain(*args), rtol=0, atol=0)
    bf = window_attention_packed(args[0].bfloat16(), *args[1:])
    assert bf.dtype == torch.bfloat16


def test_attention_group_equals_jax():
    for t in (16, 32, 64, 128, 256, 512, 800):
        for c in (0, 48, 96, 192, 384):
            for itemsize in (2, 4):
                assert attention_group(t, c, itemsize) == jax_attention_group(t, c, itemsize)


# ---------------------------------------------------------------------------
# the unpacked op (B4): plain version against the Pallas kernel and the oracle
# ---------------------------------------------------------------------------

def _unpacked_case(rng, n, t, c, frac_pad):
    """tests/test_attention.py's inputs: gaussian q, k, v and a random key
    padding with at least one valid key per window."""
    q, k, v = (rng.randn(n, t, c).astype(np.float32) for _ in range(3))
    valid = rng.rand(n, t) > frac_pad
    valid[:, 0] = True
    return q, k, v, np.where(valid, 0.0, -1e9).astype(np.float32)


def _b4(q, k, v, bias):
    return fused_window_attention(*(torch.from_numpy(x) for x in (q, k, v, bias)), NHEAD)


@pytest.mark.parametrize('t,c', [(16, 48), (64, 48), (256, 96)])
def test_unpacked_plain_matches_pallas_kernel_and_oracle(t, c):
    rng = np.random.RandomState(t + c)
    q, k, v, bias = _unpacked_case(rng, 2 * attention_group(t, c, 4), t, c, 0.4)
    mine = _b4(q, k, v, bias).numpy()
    args = [jnp.asarray(x) for x in (q, k, v, bias)]
    pallas = np.asarray(jax_fused_window_attention(*args, nhead=NHEAD, interpret=True))
    oracle = np.asarray(reference_window_attention(*args, nhead=NHEAD))
    np.testing.assert_allclose(mine, pallas, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(mine, oracle, rtol=2e-5, atol=2e-5)


def test_unpacked_bfloat16():
    rng = np.random.RandomState(2)
    t, c = 32, 96
    q, k, v, bias = _unpacked_case(rng, attention_group(t, c, 2), t, c, 0.3)
    bf = [torch.from_numpy(x).bfloat16() for x in (q, k, v)]
    mine = fused_window_attention(*bf, torch.from_numpy(bias), NHEAD)
    assert mine.dtype == torch.bfloat16
    args = [jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in bf]
    pallas = jax_fused_window_attention(*args, jnp.asarray(bias), nhead=NHEAD, interpret=True)
    oracle = reference_window_attention(*args, jnp.asarray(bias), nhead=NHEAD)
    for ref in (pallas, oracle):
        np.testing.assert_allclose(mine.float().numpy(), np.asarray(ref, np.float32),
                                   rtol=3e-2, atol=3e-2)


def test_unpacked_block_diagonality():
    """A window's output does not depend on the other windows (of its kernel
    group on the TPU)."""
    rng = np.random.RandomState(3)
    t, c = 16, 48
    q, k, v, bias = _unpacked_case(rng, attention_group(t, c, 4), t, c, 0.0)
    base = _b4(q, k, v, bias).numpy()
    v2 = v.copy()
    v2[1] += 100.0
    out2 = _b4(q, k, v2, bias).numpy()
    np.testing.assert_array_equal(out2[0], base[0])
    np.testing.assert_array_equal(out2[2:], base[2:])
    assert np.abs(out2[1] - base[1]).max() > 1.0


def test_unpacked_fully_padded_window_equals_oracle():
    """Every key of window 0 at -1e9: a uniform softmax over its own T keys,
    the mean of its own v rows, as the oracle gives. The Pallas kernel's
    grouped path spreads that softmax over its whole group (the result
    depends on the group size), so it is held only on the other windows."""
    rng = np.random.RandomState(1)
    t, c = 16, 48
    q, k, v, bias = _unpacked_case(rng, attention_group(t, c, 4), t, c, 0.0)
    bias[0] = -1e9
    mine = _b4(q, k, v, bias).numpy()
    args = [jnp.asarray(x) for x in (q, k, v, bias)]
    oracle = np.asarray(reference_window_attention(*args, nhead=NHEAD))
    pallas = np.asarray(jax_fused_window_attention(*args, nhead=NHEAD, interpret=True))
    assert np.isfinite(mine).all()
    np.testing.assert_allclose(mine, oracle, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(mine[0], np.broadcast_to(v[0].mean(0), (t, c)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mine[1:], pallas[1:], rtol=2e-5, atol=2e-5)


def test_unpacked_cpu_dispatch_is_plain_and_not_counted_and_checks_shapes():
    rng = np.random.RandomState(4)
    t, c = 16, 48
    n = attention_group(t, c, 4)
    q, k, v, bias = (torch.from_numpy(x) for x in _unpacked_case(rng, n, t, c, 0.3))
    before = fused_window_attention.launches
    out = fused_window_attention(q, k, v, bias, NHEAD)
    assert fused_window_attention.launches == before
    torch.testing.assert_close(out, fused_window_attention_plain(q, k, v, bias, NHEAD),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match='multiple of attention_group'):
        fused_window_attention(q[:-1], k[:-1], v[:-1], bias[:-1], NHEAD)
    with pytest.raises(ValueError, match='multiple of 16'):
        fused_window_attention(q[:, :8], k[:, :8], v[:, :8], bias[:, :8], NHEAD)
    with pytest.raises(ValueError, match='head_dim'):
        fused_window_attention(q[..., :40], k[..., :40], v[..., :40], bias, NHEAD)


# ---------------------------------------------------------------------------
# the train path (B2): plain version against the JAX custom VJP
# ---------------------------------------------------------------------------

def _seed(value):
    return torch.tensor([value], dtype=torch.int32)


@pytest.mark.parametrize('t,c', [(16, 48), (64, 96)])
def test_train_plain_matches_pallas_train_kernel_at_zero_drop(t, c):
    """Forward and packed gradient at drop rate 0 against the Pallas train
    kernel (interpret mode) and the oracle, with windows past nw skipped: a
    cotangent that is zero on those windows, as in the model."""
    rng = np.random.RandomState(t * c)
    b = 2
    wps = 2 * _train_group(t, c, 4)
    nw = [2, wps - 3]
    packed, bias, nw = _packed_case(rng, b, wps, t, c, nw)
    # the cotangent is zero where the model reads nothing: windows past nw
    # and fully padded windows (where the Pallas kernel's chunked softmax
    # gives the chunk's mean instead of zero, see above)
    live = np.zeros((b * wps, 1, 1), np.float32)
    for s in range(b):
        live[s * wps:s * wps + nw[s]] = 1.0
    live[~(bias == 0).any(axis=1)] = 0.0
    w = (rng.randn(b * wps, t, c) * live).astype(np.float32)

    def jax_loss(p):
        o = jax_window_attention_packed_train(p, jnp.asarray(bias), jnp.zeros((1,), jnp.int32),
                                              jnp.asarray(nw), NHEAD, 0.0, True)
        return jnp.sum(o * w), o

    def oracle_loss(p):
        o = reference_window_attention(p[..., :c], p[..., c:2 * c], p[..., 2 * c:],
                                       jnp.asarray(bias), nhead=NHEAD)
        return jnp.sum(o * w), o

    (_, jo), jg = jax.value_and_grad(jax_loss, has_aux=True)(jnp.asarray(packed))
    (_, oo), og = jax.value_and_grad(oracle_loss, has_aux=True)(jnp.asarray(packed))

    x = torch.from_numpy(packed).requires_grad_(True)
    out = window_attention_packed_train(x, torch.from_numpy(bias), _seed(0),
                                        torch.from_numpy(nw), NHEAD, 0.0)
    (out * torch.from_numpy(w)).sum().backward()
    mine, grad = out.detach().numpy(), x.grad.numpy()

    keep = live[:, 0, 0] > 0
    np.testing.assert_allclose(mine[keep], np.asarray(jo)[keep], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(mine[keep], np.asarray(oo)[keep], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(grad, np.asarray(jg), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(grad, np.asarray(og), rtol=2e-4, atol=2e-4)
    for s in range(b):                                 # windows past nw: zero
        assert not mine[s * wps + nw[s]:(s + 1) * wps].any()
        assert not grad[s * wps + nw[s]:(s + 1) * wps].any()


def test_dropout_hash_is_uint32_arithmetic():
    """The int64 emulation of the mask hash equals the same hash computed
    with Python integers modulo 2**32 (the CUDA kernels' uint32 arithmetic),
    and keeps about 1 - rate of the weights."""
    def mix(x):
        x ^= x >> 16
        x = (x * 0x7FEB352D) & 0xFFFFFFFF
        x ^= x >> 15
        x = (x * 0x846CA68B) & 0xFFFFFFFF
        return x ^ (x >> 16)

    vals = [0, 1, 2, 12345, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1, 0xDEADBEEF]
    got = mix32(torch.tensor(vals, dtype=torch.int64)).tolist()
    assert got == [mix(v) for v in vals]

    n, nh, t, rate = 3, 8, 16, 0.1
    seed = 2 ** 31 - 2
    keep = dropout_keep_mask(_seed(seed), n, nh, t, rate)
    thr = dropout_threshold(rate)
    for (wi, h, i, j) in [(0, 0, 0, 0), (2, 7, 15, 15), (1, 3, 4, 9)]:
        bits = mix(mix(i * t + j) ^ mix(mix(seed) ^ (wi * nh + h)))
        assert bool(keep[wi, h, i, j]) == (bits >= thr)
    frac = float(keep.float().mean())
    assert abs(frac - 0.9) < 0.01, frac
    # a negative int32 seed hashes as its two's complement, as uint32 does
    neg = dropout_keep_mask(_seed(-5), n, nh, t, rate)
    bits = mix(mix(0) ^ mix(mix(2 ** 32 - 5) ^ 0))
    assert bool(neg[0, 0, 0, 0]) == (bits >= thr)


def test_train_plain_dropout_invariants():
    """At drop rate > 0: deterministic per seed, different across seeds, the
    mean over seeds near the no-drop output, and the autograd gradient equal
    to a directional finite difference (tests/test_attention.py:130-170)."""
    rng = np.random.RandomState(11)
    t, c = 64, 96
    n = 2 * _train_group(t, c, 4)
    packed, bias, nw = _packed_case(rng, 1, n, t, c, [n])
    args = (torch.from_numpy(bias),)
    p, nwt = torch.from_numpy(packed), torch.from_numpy(nw)

    def run(x, seed, rate):
        return window_attention_packed_train(x, args[0], _seed(seed), nwt, NHEAD, rate)

    a, b, d = run(p, 123, 0.1), run(p, 123, 0.1), run(p, 456, 0.1)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float((a - d).abs().max()) > 1e-4

    outs = torch.stack([run(p, s, 0.5) for s in range(24)])
    nodrop = run(p, 0, 0.0)
    err = float((outs.mean(0) - nodrop).abs().mean() / (nodrop.abs().mean() + 1e-9))
    assert err < 0.25, err

    w = torch.from_numpy(rng.randn(n, t, c).astype(np.float32))
    x = p.clone().requires_grad_(True)
    (run(x, 123, 0.1) * w).sum().backward()
    dvec = torch.from_numpy(rng.randn(*packed.shape).astype(np.float32))
    eps = 1e-3
    with torch.no_grad():
        num = (float((run(p + eps * dvec, 123, 0.1) * w).sum())
               - float((run(p - eps * dvec, 123, 0.1) * w).sum())) / (2 * eps)
    ana = float((x.grad * dvec).sum())
    np.testing.assert_allclose(num, ana, rtol=5e-3, atol=5e-2)


def test_train_cpu_dispatch_is_plain_and_not_counted():
    rng = np.random.RandomState(1)
    packed, bias, nw = _packed_case(rng, 1, 8, 16, 48, [5])
    args = (torch.from_numpy(packed), torch.from_numpy(bias), _seed(3),
            torch.from_numpy(nw), NHEAD, 0.1)
    before = (window_attention_train_forward.launches,
              window_attention_train_backward.launches)
    out = window_attention_packed_train(*args)
    torch.testing.assert_close(out, window_attention_packed_train_plain(*args),
                               rtol=0, atol=0)
    assert (window_attention_train_forward.launches,
            window_attention_train_backward.launches) == before
    # at rate 0 the train plain version is the eval plain version
    torch.testing.assert_close(window_attention_packed_train_plain(*args[:5], 0.0),
                               window_attention_packed_plain(args[0], args[1], NHEAD, args[3]),
                               rtol=0, atol=0)

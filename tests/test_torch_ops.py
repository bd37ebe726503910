"""The port's ops against the JAX package's: segment reductions, sparse-conv
structure and forwards, and the window partition. The same numpy inputs go
to both.

Tolerances: integer outputs (ids, rulebooks, coords, masks, window
assignment) must be equal. Float outputs are float32 on both sides: sums of
a few terms agree to allclose 1e-6; convolutions sum 27*Cin products in
another order, so they get 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openseg3d_tpu.ops import scatter as jscatter
from openseg3d_tpu.ops import sparse_conv as jsc
from openseg3d_tpu.ops import window as jwin

from openseg3d_tpu_torch.ops import scatter, sparse_conv as sc, window as win
from openseg3d_tpu_torch.models.swformer import combined_scatter_index

t = torch.from_numpy


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# segment ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('name', ['segment_sum', 'segment_mean', 'segment_max'])
def test_segment_reductions_equal_jax(name):
    rng = np.random.RandomState(0)
    n, s, c = 200, 30, 5
    data = rng.randn(n, c).astype(np.float32)
    ids = rng.randint(-1, s + 3, n).astype(np.int32)   # -1 and >= s are dropped
    ids[ids == 7] = 8                                   # segment 7 stays empty
    mine = getattr(scatter, name)(t(data), t(ids), s).numpy()
    ref = _np(getattr(jscatter, name)(jnp.asarray(data), jnp.asarray(ids), s))
    np.testing.assert_allclose(mine, ref, rtol=1e-6, atol=1e-6)
    if name == 'segment_max':
        np.testing.assert_array_equal(mine[7], 0)       # empty segment -> 0


def test_segment_count_and_max_dtypes_equal_jax():
    rng = np.random.RandomState(1)
    ids = rng.randint(-2, 12, 100).astype(np.int32)
    np.testing.assert_array_equal(
        scatter.segment_count(t(ids), 10).numpy(),
        _np(jscatter.segment_count(jnp.asarray(ids), 10)))
    idata = rng.randint(-50, 50, (100, 3)).astype(np.int32)
    np.testing.assert_array_equal(
        scatter.segment_max(t(idata), t(ids), 10).numpy(),
        _np(jscatter.segment_max(jnp.asarray(idata), jnp.asarray(ids), 10)))
    bf = torch.from_numpy(rng.randn(100, 3).astype(np.float32)).bfloat16()
    got = scatter.segment_max(bf, t(ids), 10)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  scatter.segment_max(bf.float(), t(ids), 10).numpy())


def test_voxel_to_point_equal_jax():
    rng = np.random.RandomState(2)
    b, v, p, c = 2, 12, 40, 4
    vf = rng.randn(b, v, c).astype(np.float32)
    ids = rng.randint(-1, v, (b, p)).astype(np.int32)
    mine = scatter.voxel_to_point(t(vf), t(ids)).numpy()
    ref = _np(jax.vmap(jscatter.voxel_to_point)(jnp.asarray(vf), jnp.asarray(ids)))
    np.testing.assert_array_equal(mine, ref)
    assert (mine[ids < 0] == 0).all()


# ---------------------------------------------------------------------------
# sparse conv (cases of tests/test_sparse_conv.py)
# ---------------------------------------------------------------------------

def _make_sparse(rng, b, v_cap, n_active, shape, c, shuffled=False):
    """Unique random sites in ascending key order (the pipeline invariant);
    `shuffled` breaks it for the structure tests that must not rely on it."""
    coords = np.full((b, v_cap, 3), -1, dtype=np.int32)
    feats = np.zeros((b, v_cap, c), dtype=np.float32)
    total = shape[0] * shape[1] * shape[2]
    for i in range(b):
        lin = np.sort(rng.choice(total, size=n_active, replace=False))
        if shuffled:
            rng.shuffle(lin)
        coords[i, :n_active] = np.stack([lin // (shape[1] * shape[2]),
                                         (lin // shape[2]) % shape[1],
                                         lin % shape[2]], 1)
        feats[i, :n_active] = rng.randn(n_active, c)
    return coords, feats


def test_linearize_delinearize_sort_match_equal_jax():
    rng = np.random.RandomState(3)
    shape = (6, 7, 8)
    coords, _ = _make_sparse(rng, 1, 40, 30, shape, 1, shuffled=True)
    coords = coords[0]
    coords[3] = (6, 0, 0)                              # out of the grid
    keys = sc.linearize(t(coords), shape)
    np.testing.assert_array_equal(keys.numpy(), _np(jsc.linearize(jnp.asarray(coords), shape)))
    assert keys.dtype == torch.int32
    np.testing.assert_array_equal(sc.delinearize(keys, shape).numpy(),
                                  _np(jsc.delinearize(jnp.asarray(keys.numpy()), shape)))
    queries = np.concatenate([keys.numpy()[::-2], rng.randint(0, 336, 20).astype(np.int32)])
    np.testing.assert_array_equal(
        sc.sort_match(keys, t(queries)).numpy(),
        _np(jsc.sort_match(jnp.asarray(keys.numpy()), jnp.asarray(queries))))
    with pytest.raises(ValueError):
        sc.linearize(t(coords), (2048, 2048, 1024))


@pytest.mark.parametrize('seed', [0, 1])
def test_subm_rulebook_and_conv_equal_jax(seed):
    rng = np.random.RandomState(seed)
    shape, cin, cout = (6, 7, 8), 5, 4
    coords, feats = _make_sparse(rng, 2, 40, 30, shape, cin)
    w = rng.randn(27, cin, cout).astype(np.float32)
    jst = jsc.SparseTensor(features=jnp.asarray(feats), coords=jnp.asarray(coords),
                           spatial_shape=shape)
    jrb = jax.jit(jsc.build_planar_k3_direct)(jst)
    rb = sc.build_subm_rulebook(sc.SparseTensor(t(feats), t(coords), shape))
    np.testing.assert_array_equal(rb.in_idx.numpy(), _np(jrb.in_idx))
    mask = coords[..., 0] >= 0
    ref = jax.jit(jsc.apply_subm)(jnp.asarray(feats), jrb, jnp.asarray(w), jnp.asarray(mask))
    mine = sc.apply_subm(t(feats), rb, t(w), t(mask))
    np.testing.assert_allclose(mine.numpy(), _np(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('out_capacity', [64, 24])
def test_downsample_strided_and_inverse_conv_equal_jax(out_capacity):
    """Output coords, order, rule and true count equal; the strided and
    inverse conv forwards agree. Capacity 24 is below the true output count,
    so the largest keys drop, in the same order on both sides."""
    rng = np.random.RandomState(7)
    shape, cin, cout = (8, 8, 8), 5, 3
    coords, feats = _make_sparse(rng, 2, 40, 30, shape, cin)
    jst = jsc.SparseTensor(features=jnp.asarray(feats), coords=jnp.asarray(coords),
                           spatial_shape=shape)
    jplan = jax.jit(jsc.build_downsample, static_argnums=(1,))(jst, out_capacity)
    plan = sc.build_downsample(sc.SparseTensor(t(feats), t(coords), shape), out_capacity)
    assert plan.out_shape == jplan.out_shape
    np.testing.assert_array_equal(plan.out_coords.numpy(), _np(jplan.out_coords))
    np.testing.assert_array_equal(plan.rule.in_idx.numpy(), _np(jplan.rule.in_idx))
    np.testing.assert_array_equal(plan.num_out.numpy(), _np(jplan.num_out))
    if out_capacity == 24:
        assert (plan.num_out.numpy() > out_capacity).all()

    w = rng.randn(27, cin, cout).astype(np.float32)
    cmask = plan.out_coords[..., 0] >= 0
    ref = jax.jit(jsc.apply_subm)(jnp.asarray(feats), jplan.rule, jnp.asarray(w),
                                  jnp.asarray(cmask.numpy()))
    mine = sc.apply_subm(t(feats), plan.rule, t(w), cmask)
    np.testing.assert_allclose(mine.numpy(), _np(ref), rtol=1e-5, atol=1e-5)

    coarse = rng.randn(2, out_capacity, cout).astype(np.float32) * cmask.numpy()[..., None]
    w_inv = rng.randn(27, cout, cin).astype(np.float32)
    fmask = coords[..., 0] >= 0
    ref = jax.jit(jsc.apply_subm)(jnp.asarray(coarse), jplan.inv_rule,
                                  jnp.asarray(w_inv), jnp.asarray(fmask))
    mine = sc.apply_subm(t(coarse), plan.inv_rule, t(w_inv), t(fmask))
    np.testing.assert_allclose(mine.numpy(), _np(ref), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# window partition
# ---------------------------------------------------------------------------

# The top level's token cap equals the window volume (4*4*4), so no window
# overflows its cap: which voxels such an overflow drops depends on the token
# order inside the window, which the JAX package leaves to an unstable sort.
BATCHING = (
    (0, (2, 0, 2)),
    (1, (4, 2, 4)),
    (2, (64, 4, 100000)),
)


def _partition_case(seed, b, v_cap, n, shape):
    rng = np.random.RandomState(seed)
    coords, _ = _make_sparse(rng, b, v_cap, n, shape, 1)
    return coords, coords[..., 0] >= 0


@pytest.mark.parametrize('case', [
    # (seed, B, V, active, grid, window, fraction): in the last case more
    # windows than a level's capacity hold voxels, so the later ones drop
    (1, 1, 64, 48, (8, 12, 12), (4, 4, 4), 1.0),
    (2, 2, 96, 80, (8, 12, 12), (4, 4, 4), 1.0),
    (3, 2, 640, 600, (4, 80, 80), (4, 4, 4), 0.15),
])
def test_window_partition_equal_jax(case):
    seed, b, v, n, shape, wshape, frac = case
    coords, valid = _partition_case(seed, b, v, n, shape)
    levels = win.make_level_specs(BATCHING, v, frac)
    assert levels == jwin.make_level_specs(BATCHING, v, frac)
    jpart = jax.jit(lambda c, m: jwin.batched_window_partition(c, m, shape, wshape, levels))(
        jnp.asarray(coords), jnp.asarray(valid))
    part = win.batched_window_partition(t(coords), t(valid), shape, wshape, levels)

    keep = part.keep.numpy()
    np.testing.assert_array_equal(keep, _np(jpart.keep))
    for sp, jsp in zip(part.shifts, jpart.shifts):
        np.testing.assert_array_equal(sp.level.numpy(), _np(jsp.level))
        np.testing.assert_array_equal(sp.num_windows.numpy(), _np(jsp.num_windows))
        np.testing.assert_array_equal(sp.coors_in_win.numpy(), _np(jsp.coors_in_win))
        for li, spec in enumerate(levels):
            mine, ref = sp.scatter_idx[li].numpy(), _np(jsp.scatter_idx[li])
            # same voxels placed, in the same window; the token order inside
            # a window may differ (unstable sort in the JAX package)
            np.testing.assert_array_equal(mine >= 0, ref >= 0)
            np.testing.assert_array_equal(mine // spec.max_tokens, ref // spec.max_tokens)
            for bi in range(b):
                used = mine[bi][mine[bi] >= 0]
                assert len(np.unique(used)) == len(used)
        comb = combined_scatter_index(sp, levels).numpy()
        assert not (comb >= 0)[~keep].any()
        if frac < 1:
            assert ((comb < 0) & keep).any()      # the window cap did bind


def test_positional_embedding_and_permute_rows_equal_jax():
    rng = np.random.RandomState(4)
    ciw = rng.randint(0, 10, (2, 30, 3)).astype(np.int32)
    for wshape, dim in (((10, 10, 8), 48), ((10, 10, 8), 96), ((10, 10, 1), 48)):
        np.testing.assert_allclose(
            win.positional_embedding(t(ciw), wshape, dim).numpy(),
            _np(jwin.positional_embedding(jnp.asarray(ciw), wshape, dim)),
            rtol=1e-6, atol=1e-6)

    x = rng.randn(2, 10, 4).astype(np.float32)
    idx = rng.randint(-1, 10, (2, 14)).astype(np.int32)
    np.testing.assert_array_equal(
        win.permute_rows(t(x), t(idx)).numpy(),
        _np(jwin.permute_rows(jnp.asarray(x), jnp.asarray(idx), jnp.asarray(idx))))


# ---------------------------------------------------------------------------
# gradients: autograd through the port's ops against the JAX package's
# custom VJPs (the subm, strided and inverse convs, permute_rows) and
# jax.grad (segment_max with tied maxima). Float32, 1e-5 as the forwards.
# ---------------------------------------------------------------------------

def _conv_grads(jrule, rule, feats, w, mask, cot):
    """d sum(conv(x, w) * cot) / d (x, w) on both sides."""
    def jloss(x, ww):
        return jnp.sum(jsc.apply_subm(x, jrule, ww, jnp.asarray(mask)) * cot)

    jgx, jgw = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(feats), jnp.asarray(w))
    x, ww = t(feats).requires_grad_(True), t(w).requires_grad_(True)
    (sc.apply_subm(x, rule, ww, t(mask)) * t(cot)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), _np(jgx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ww.grad.numpy(), _np(jgw), rtol=1e-5, atol=1e-5)


def test_sparse_conv_gradients_equal_jax_custom_vjps():
    rng = np.random.RandomState(8)
    shape, cin, cout = (8, 8, 8), 5, 4
    coords, feats = _make_sparse(rng, 2, 40, 30, shape, cin)
    mask = coords[..., 0] >= 0
    jst = jsc.SparseTensor(features=jnp.asarray(feats), coords=jnp.asarray(coords),
                           spatial_shape=shape)
    st = sc.SparseTensor(t(feats), t(coords), shape)

    # submanifold: the planar rulebook's custom VJP
    w = rng.randn(27, cin, cout).astype(np.float32)
    cot = rng.randn(2, 40, cout).astype(np.float32)
    _conv_grads(jax.jit(jsc.build_planar_k3_direct)(jst), sc.build_subm_rulebook(st),
                feats, w, mask, cot)

    # strided and inverse: the downsample plan's rules
    jplan = jax.jit(jsc.build_downsample, static_argnums=(1,))(jst, 24)
    plan = sc.build_downsample(st, 24)
    cmask = (plan.out_coords[..., 0] >= 0).numpy()
    _conv_grads(jplan.rule, plan.rule, feats, w, cmask,
                rng.randn(2, 24, cout).astype(np.float32))
    coarse = rng.randn(2, 24, cout).astype(np.float32) * cmask[..., None]
    _conv_grads(jplan.inv_rule, plan.inv_rule, coarse,
                rng.randn(27, cout, cin).astype(np.float32), mask,
                rng.randn(2, 40, cin).astype(np.float32))


def test_permute_rows_gradient_equals_jax_custom_vjp():
    rng = np.random.RandomState(9)
    b, n, m, c = 2, 12, 16, 3
    x = rng.randn(b, n, c).astype(np.float32)
    fwd = np.full((b, m), -1, np.int32)
    bwd = np.full((b, n), -1, np.int32)
    for bi in range(b):                      # a partial permutation and its inverse
        slots = rng.choice(m, size=9, replace=False)
        rows = rng.choice(n, size=9, replace=False)
        fwd[bi, slots] = rows
        bwd[bi, rows] = slots
    cot = rng.randn(b, m, c).astype(np.float32)
    jg = jax.grad(lambda xx: jnp.sum(jwin.permute_rows(xx, jnp.asarray(fwd),
                                                       jnp.asarray(bwd)) * cot))(jnp.asarray(x))
    xt = t(x).requires_grad_(True)
    (win.permute_rows(xt, t(fwd)) * t(cot)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), _np(jg))


def test_segment_max_gradient_with_ties_equals_jax():
    """Max-VFE: rows tied for a segment's maximum share its gradient as
    jax.grad of segment_max shares it."""
    rng = np.random.RandomState(10)
    n, s, c = 60, 8, 4
    data = rng.randint(-3, 4, (n, c)).astype(np.float32)    # small ints: many ties
    ids = rng.randint(-1, s + 1, n).astype(np.int32)
    cot = rng.randn(s, c).astype(np.float32)
    jg = jax.grad(lambda d: jnp.sum(jscatter.segment_max(d, jnp.asarray(ids), s) * cot))(
        jnp.asarray(data))
    x = t(data).requires_grad_(True)
    (scatter.segment_max(x, t(ids), s) * t(cot)).sum().backward()
    # the case has maxima shared by several rows
    seg_max = np.stack([data[ids == k].max(0) for k in range(s)])
    ties = [(data[ids == k] == seg_max[k]).sum(0) for k in range(s)]
    assert max(int(x.max()) for x in ties) >= 2
    np.testing.assert_allclose(x.grad.numpy(), _np(jg), rtol=1e-6, atol=1e-6)

"""The sparse-conv kernels' tile tables and wrappers on the CPU: the tables
cover every conv width the configurations build, CPU tensors run the plain
gather-GEMM (uncounted) while the kernels' wrappers refuse them, and the
names the benchmark's traced run hooks stay. The tile shapes and their
limits (threads, shared memory, 16-byte rows) live in csrc/sparse_conv.cu,
whose static_asserts check them where it compiles; the kernels against exact
sums, and the weight gradient's partials at the configurations' sizes, are
in tests/test_torch_cuda.py and chip_smoke.py (phase 4c).
"""

import pytest
import torch

from openseg3d_tpu_torch.config import cfg_from_file
from openseg3d_tpu_torch.engine import build_segmentor
from openseg3d_tpu_torch.ops import sparse_conv as sc
from openseg3d_tpu_torch.ops.scatter import take_rows_or_zero

CONFIGS = {
    'segformer': ('configs/waymo_one_sweep.yaml', None),
    'spnet': ('configs/waymo_one_sweep.yaml', {'MODEL': {'SEGMENTOR': 'spnet'}}),
    'segformer_multisweep': ('configs/waymo_multi_sweeps.yaml', None),
    'spnet_multisweep': ('configs/waymo_multi_sweeps.yaml', {'MODEL': {'SEGMENTOR': 'spnet'}}),
    'segformer_deepfusion': ('configs/waymo_one_sweep.yaml',
                             {'DATASET': {'USE_IMAGE_FEATURE': True}}),
}


def conv_widths(name):
    """{(Cin, Cout)} of every 3^3 kernel [27, Cin, Cout] the config's model
    holds, and the config."""
    path, overrides = CONFIGS[name]
    cfg = cfg_from_file(path, overrides)
    model, _ = build_segmentor(cfg, device='cpu')
    return {(p.shape[1], p.shape[2]) for p in model.parameters()
            if p.ndim == 3 and p.shape[0] == 27}, cfg


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_tables_cover_every_conv_width(name):
    """Each conv's forward (Cin, Cout) and dx (Cout, Cin) are in GEMM_TABLE
    and its dW (Cin, Cout) in GRAD_TABLE, or its widths take the unaligned
    instantiation (the multi-sweep stem's Cin = 6 only); every entry is a
    tile index, and the weight gradient's chunk is whole 64-row steps within
    2048 rows, as the kernel takes it."""
    widths, _ = conv_widths(name)
    unaligned = set()
    for cin, cout in widths:
        if not sc.kernel_widths(cin, cout):
            unaligned.add((cin, cout))
            assert sc.gemm_tile(cin, cout) == sc.grad_tile(cin, cout) == 0
            continue
        assert (cin, cout) in sc.GEMM_TABLE and (cout, cin) in sc.GEMM_TABLE, (cin, cout)
        assert (cin, cout) in sc.GRAD_TABLE, (cin, cout)
    assert {c for c, _ in unaligned} == ({6} if 'multisweep' in name else set())
    for table in (sc.GEMM_TABLE, sc.GRAD_TABLE):
        assert all(isinstance(t, int) and t >= 0 for t in table.values())
    assert 0 < sc.DW_CHUNK <= 2048 and sc.DW_CHUNK % 64 == 0


@pytest.mark.parametrize('kernel', ['gather_gemm', 'weight_grad'])
def test_kernel_wrappers_refuse_cpu_tensors(kernel):
    """The wrappers launch a kernel or raise: CPU tensors are refused, with
    no launch counted and no fall back to the plain path (``_SparseConv``
    alone routes between the two)."""
    x = torch.zeros(1, 64, 16, dtype=torch.bfloat16)
    idx = torch.full((1, 27, 64), -1, dtype=torch.int32)
    launches = (sc.gather_gemm.launches, sc.weight_grad.launches)
    with pytest.raises(ValueError, match='runs on the card'):
        if kernel == 'gather_gemm':
            sc.gather_gemm(x, idx, torch.zeros(27, 16, 8, dtype=torch.bfloat16))
        else:
            sc.weight_grad(x, idx, torch.zeros(1, 64, 8, dtype=torch.bfloat16))
    assert (sc.gather_gemm.launches, sc.weight_grad.launches) == launches


def _scene(seed=0, b=2, v=256, grid=(6, 12, 12)):
    gen = torch.Generator().manual_seed(seed)
    cells = torch.stack(torch.meshgrid(*[torch.arange(n) for n in grid], indexing='ij'),
                        -1).reshape(-1, 3).int()
    coords = torch.full((b, v, 3), -1, dtype=torch.int32)
    for i in range(b):
        keep = cells[torch.rand(len(cells), generator=gen) < 0.2 / (i + 1)][:v]
        coords[i, :len(keep)] = keep
    return sc.SparseTensor(None, coords, grid)


def _exact(x, idx, w):
    """sum_k x[idx[k]] @ w[k] in float64, one offset at a time."""
    out = 0
    for k in range(idx.shape[1]):
        out = out + take_rows_or_zero(x.double(), idx[:, k]) @ w[k].double()
    return out


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('kind', ['subm', 'strided', 'inverse'])
def test_cpu_runs_the_plain_gather_gemm_uncounted(kind, dtype):
    """On CPU tensors the conv runs the plain versions, and no kernel launch
    is counted; the plain versions equal the sums offset by offset (forward
    and dx within the dtype's rounding, dW in float32), and the conv's
    backward, which shares one gather between dx and dW, gives dW's."""
    st = _scene()
    plan = sc.build_downsample(st, out_capacity=128)
    coarse = plan.out_coords[..., 0] >= 0
    rb, in_mask, out_mask = {'subm': (sc.build_subm_rulebook(st), st.mask, st.mask),
                             'strided': (plan.rule, st.mask, coarse),
                             'inverse': (plan.inv_rule, coarse, st.mask)}[kind]
    gen = torch.Generator().manual_seed(1)
    x = torch.where(in_mask[..., None], torch.randn(2, in_mask.shape[1], 16, generator=gen), 0)
    w = torch.randn(27, 16, 24, generator=gen)
    g = torch.randn(2, out_mask.shape[1], 24, generator=gen)
    x, g = x.to(dtype), g.to(dtype)
    launches = (sc.gather_gemm.launches, sc.weight_grad.launches)
    out = sc.gather_gemm_plain(x, rb.in_idx, w.to(dtype), dst_mask=out_mask)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else dict(rtol=2 ** -7, atol=1e-2)
    want = torch.where(out_mask[..., None], _exact(x, rb.in_idx, w.to(dtype)), 0)
    torch.testing.assert_close(out.double(), want, **tol)
    gm = torch.where(out_mask[..., None], g, 0)
    dx = sc.gather_gemm_plain(g, rb.transpose, w.to(dtype).transpose(1, 2), src_mask=out_mask)
    torch.testing.assert_close(dx.double(), _exact(gm, rb.transpose, w.to(dtype).transpose(1, 2)),
                               **tol)
    dw = sc.weight_grad_plain(x, rb.transpose, g, src_mask=out_mask)
    assert dw.dtype == torch.float32 and dw.shape == (27, 16, 24)
    want = torch.stack([x.double().reshape(-1, 16).t()
                        @ take_rows_or_zero(gm.double(), rb.transpose[:, k]).reshape(-1, 24)
                        for k in range(27)])
    torch.testing.assert_close(dw.double(), want, rtol=1e-5, atol=1e-5)

    xg = x.clone().requires_grad_(True)
    wg = w.clone().requires_grad_(True)
    backwards = sc.apply_sparse_conv.backwards
    y = sc.apply_subm(xg, rb, wg, out_mask, compute_dtype=dtype)
    y.backward(g)
    assert sc.apply_sparse_conv.backwards == backwards + 1
    assert (sc.gather_gemm.launches, sc.weight_grad.launches) == launches
    torch.testing.assert_close(y, out, rtol=0, atol=0)
    torch.testing.assert_close(wg.grad, dw, rtol=1e-6, atol=1e-6)


def test_names_the_traced_run_hooks():
    """benchmark/spans.py patches apply_subm and the rooflines read the
    autograd node _SparseConvBackward: the names stay, and the backward
    counter with them."""
    from benchmark import spans
    assert callable(sc.apply_subm) and callable(sc.apply_sparse_conv)
    assert sc._SparseConv.__name__ == '_SparseConv'
    assert spans.SPARSE_CONV_BACKWARD.endswith('_SparseConvBackward')
    st = _scene()
    rb = sc.build_subm_rulebook(st)
    x = torch.randn(2, 256, 8).requires_grad_(True)
    y = sc.apply_subm(x, rb, torch.randn(27, 8, 8), st.mask)
    assert y.grad_fn.name() == '_SparseConvBackward'
    assert isinstance(sc.apply_sparse_conv.backwards, int)


def test_kernel_arguments_are_checked():
    """What the kernels would misread is refused before a launch: another
    dtype, a strided operand, an index whose samples are not contiguous, a
    mask of another shape."""
    x = torch.zeros(2, 64, 16, dtype=torch.bfloat16)
    idx = torch.zeros(2, 27, 64, dtype=torch.int32)
    mask = torch.ones(2, 64, dtype=torch.bool)
    sc._check_kernel_args([('x', x)], ('idx', idx), [('m', mask, (2, 64))])
    # a downsample plan's rules: each sample contiguous, a wider batch stride
    sc._check_kernel_args([('x', x)], ('idx', torch.zeros(2, 27 * 64 + 1,
                                                         dtype=torch.int32)[:, :-1].reshape(
        2, 27, 64)), [])
    with pytest.raises(ValueError, match='bfloat16'):
        sc._check_kernel_args([('x', x.float())], ('idx', idx), [])
    with pytest.raises(ValueError, match='contiguous'):
        sc._check_kernel_args([('x', x.transpose(1, 2))], ('idx', idx), [])
    with pytest.raises(ValueError, match='int32'):
        sc._check_kernel_args([('x', x)], ('idx', idx.transpose(1, 2)), [])
    with pytest.raises(ValueError, match='int32'):
        sc._check_kernel_args([('x', x)], ('idx', idx.long()), [])
    with pytest.raises(ValueError, match='bool'):
        sc._check_kernel_args([('x', x)], ('idx', idx), [('m', mask[:, :32], (2, 64))])

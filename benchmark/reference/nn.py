"""The reference's layers and the two segmentors, in float32 plain PyTorch.

Frozen copies of the port's ``models/`` (layers, norm, sparse modules, OCR,
SWFormer, the two backbones, the point branch and the head) with the
port's plain paths in place of every kernel: the sparse conv is a row gather
and one matmul whose backward gathers the cotangent through the transposed
rulebook (the autograd gradient of the gather would hold every gathered row
of 43 convs at once), and window attention is an einsum and a softmax, its
dropout mask the port's counter hash of the per-level seed, recomputed in
the backward instead of kept. Submodules carry the port's names, so one
state dict serves both.

Everything computes in float32 with TF32 off (the caller sets it). Under
``precision('fp8')`` every matmul operand (linear and conv inputs and
weights, q, k, v and the softmax weights) is rounded to float8 e4m3 with a
per-tensor scale first, as an fp8 deployment computes them, and so is every
activation a layer hands on; in training the cotangents flowing back
through them are rounded to float8 e5m2. That is the control of the
comparison that decides ``correct``. ``precision('bf16')`` rounds the same
tensors and cotangents to bfloat16 instead: the reference in the program's
own precision, a witness of how far bf16 rounding alone moves each number
(``calibrate.py``). Under ``counting()``
every linear, conv and attention call records the work its live rows need
(``benchmark/counts.py`` turns the records into FLOPs and bytes).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import structure as st

_STATE = {'round': None, 'records': None}
FP8_MAX = 448.0
FP8_E5M2_MAX = 57344.0


@contextlib.contextmanager
def precision(name: str):
    """'float32', 'fp8' or 'bf16': every matmul operand, and every activation
    a layer hands on (each module's tensor output but the head's float32
    logits), rounded to float8 e4m3 (or bfloat16) where the program rounds
    to bf16."""
    old = _STATE['round']
    _STATE['round'] = {'float32': None, 'fp8': _RoundFp8, 'bf16': _RoundBf16}[name]
    hook = None
    if _STATE['round'] is not None:
        def round_output(module, args, output):
            if torch.is_tensor(output) and output.is_floating_point() \
                    and not isinstance(module, SegmentorHead):
                return rnd(output)
            return output
        hook = nn.modules.module.register_module_forward_hook(round_output)
    try:
        yield
    finally:
        _STATE['round'] = old
        if hook is not None:
            hook.remove()


@contextlib.contextmanager
def counting():
    """Collects work records of the calls inside into the yielded list."""
    records, old = [], _STATE['records']
    _STATE['records'] = records
    try:
        yield records
    finally:
        _STATE['records'] = old


def _record(kind: str, **work):
    if counting_on():
        _STATE['records'].append((kind, {k: (int(v) if torch.is_tensor(v) and v.dim() == 0
                                             else v) for k, v in work.items()}))


def _fp8(x, dtype, largest):
    scale = torch.clamp(x.detach().abs().amax() / largest, min=1e-30)
    return (x / scale).to(dtype).float() * scale


class _RoundFp8(torch.autograd.Function):
    """e4m3 forward, and the cotangent rounded to e5m2 on its way back (the
    usual float8 training recipe), each with a per-tensor scale."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn, FP8_MAX)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, FP8_E5M2_MAX)


class _RoundBf16(torch.autograd.Function):
    """bfloat16 forward and backward."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).float()

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).float()


def rnd(x: torch.Tensor) -> torch.Tensor:
    """A matmul operand in the precision in force."""
    return _STATE['round'].apply(x) if _STATE['round'] is not None else x


def counting_on() -> bool:
    return _STATE['records'] is not None


def dense(layer: nn.Linear, x, mask=None):
    if counting_on():
        rows = mask.sum() if mask is not None else int(np.prod(x.shape[:-1]))
        _record('linear', rows=rows, fin=layer.in_features, fout=layer.out_features)
    return F.linear(rnd(x), rnd(layer.weight), layer.bias)


def dropout(x, rate, rng, training):
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=rng, device=x.device) < keep
    return torch.where(mask, x / keep, 0)


def drop_path(x, rate, rng, training, rate_dtype=torch.float32):
    """Stochastic depth; the keep probability is worked out in the config's
    compute dtype, as the program's rate rides in its activations' dtype: it
    sets which samples are kept, so the reference derives the same masks."""
    if not training or rate == 0.0:
        return x
    keep = float(1 - torch.tensor(rate, dtype=rate_dtype))
    mask = torch.rand((x.shape[0],) + (1,) * (x.dim() - 1), generator=rng, device=x.device) < keep
    return torch.where(mask, x / max(keep, 1e-6), 0)


def take_rows_or_zero(x, idx):
    b, n, c = x.shape
    xp = torch.cat([x, x.new_zeros(b, 1, c)], 1)
    flat = (torch.where(idx >= 0, idx, n).long()
            + (torch.arange(b, device=x.device) * (n + 1))[:, None]).reshape(-1)
    return xp.reshape(b * (n + 1), c).index_select(0, flat).reshape(b, idx.shape[1], c)


def segment_max(data, ids, num):
    bad = (ids < 0) | (ids >= num)
    ids = torch.where(bad, num, ids).long()
    neg = torch.finfo(data.dtype).min
    src = torch.where(~bad[:, None], data, neg)
    out = torch.full((num + 1, data.shape[1]), neg, dtype=data.dtype, device=data.device)
    out.scatter_reduce_(0, ids[:, None].expand_as(src), src, reduce='amax', include_self=False)
    out = out[:num]
    return torch.where(out <= neg, 0, out)


def vfe_max(features, vids, num_voxels):
    b, p, c = features.shape
    ok = (vids >= 0) & (vids < num_voxels)
    offs = (torch.arange(b, device=features.device) * num_voxels)[:, None]
    flat = torch.where(ok, vids.long() + offs, -1).reshape(-1)
    return segment_max(features.reshape(b * p, c), flat, b * num_voxels).reshape(
        b, num_voxels, c)


def voxel_to_point(vf, vids):
    g = take_rows_or_zero(vf, torch.clamp(vids, 0, vf.shape[1] - 1))
    return torch.where((vids >= 0)[..., None], g, 0)


class MaskedBatchNorm(nn.Module):
    def __init__(self, n, eps=1e-3, momentum=0.99):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer('mean', torch.zeros(n))
        self.register_buffer('var', torch.ones(n))

    def forward(self, x, mask):
        if self.training:
            axes = tuple(range(x.dim() - 1))
            m = mask.float()[..., None]
            xm = x * m
            count = torch.clamp(m.sum(), min=1.0)
            mean = xm.sum(axes) / count
            var = torch.maximum((xm * x).sum(axes) / count - mean.square(),
                                torch.zeros_like(mean))
        else:
            mean, var = self.mean, self.var
        y = (x - mean) * torch.rsqrt(var + self.eps) * self.scale + self.bias
        return torch.where(mask[..., None], y, 0)


class LinearBNReLU(nn.Module):
    def __init__(self, fin, fout, act=True):
        super().__init__()
        self.act = act
        self.Dense_0 = nn.Linear(fin, fout, bias=False)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(fout, eps=1e-5, momentum=0.9)

    def forward(self, x, mask):
        x = self.MaskedBatchNorm_0(dense(self.Dense_0, x, mask), mask)
        return F.relu(x) if self.act else x


class PointEncoder(nn.Module):
    def __init__(self, fin, fout=64, hidden=(64, 128, 256)):
        super().__init__()
        self.MaskedBatchNorm_0 = MaskedBatchNorm(fin, eps=1e-5, momentum=0.9)
        dims = (fin,) + tuple(hidden)
        for i in range(len(hidden)):
            setattr(self, f'LinearBNReLU_{i}', LinearBNReLU(dims[i], dims[i + 1]))
        self.num_hidden = len(hidden)
        self.Dense_0 = nn.Linear(dims[-1], fout)

    def forward(self, points, mask):
        x = self.MaskedBatchNorm_0(points, mask)
        for i in range(self.num_hidden):
            x = getattr(self, f'LinearBNReLU_{i}')(x, mask)
        return torch.where(mask[..., None], dense(self.Dense_0, x, mask), 0)


class FlattenSELayer(nn.Module):
    def __init__(self, c, reduction=4):
        super().__init__()
        self.Dense_0 = nn.Linear(c, c // reduction, bias=False)
        self.Dense_1 = nn.Linear(c // reduction, c, bias=False)

    def forward(self, x, mask):
        m = mask.float()[..., None]
        pooled = (x * m).sum(1) / torch.clamp(m.sum(1), min=1)
        s = torch.sigmoid(dense(self.Dense_1, F.relu(dense(self.Dense_0, pooled))))
        return x * s[:, None, :]


# --- sparse convs ----------------------------------------------------------

class _SparseConv(torch.autograd.Function):
    """out[o] = sum_k x[in_idx[k, o]] @ W[k]; the backward gathers the
    cotangent through the transposed rulebook (one addend a row)."""

    @staticmethod
    def forward(ctx, x, w, rb: st.Rulebook, out_mask):
        b, k3, vo = rb.in_idx.shape
        cin = x.shape[2]
        g = take_rows_or_zero(rnd(x), rb.in_idx.transpose(1, 2).reshape(b, vo * k3))
        out = torch.matmul(g.reshape(b, vo, k3 * cin), rnd(w).reshape(k3 * cin, -1))
        ctx.save_for_backward(x, w, rb.transpose, out_mask)
        ctx.submanifold = rb.submanifold
        return torch.where(out_mask[..., None], out, 0)

    @staticmethod
    def backward(ctx, gout):
        x, w, tr, out_mask = ctx.saved_tensors
        b, v, cin = x.shape
        k3, cout = tr.shape[1], w.shape[-1]
        g = torch.where(out_mask[..., None], gout, 0)
        gath = take_rows_or_zero(g, tr.transpose(1, 2).reshape(b, v * k3)).reshape(b * v, k3 * cout)
        dx = (gath @ w.transpose(1, 2).reshape(k3 * cout, cin)).reshape(b, v, cin)
        if ctx.submanifold:
            dx = torch.where(out_mask[..., None], dx, 0)
        dw = (x.reshape(b * v, cin).t() @ gath).reshape(cin, k3, cout).transpose(0, 1)
        return dx, dw, None, None


def sparse_conv(x, rb: st.Rulebook, w, out_mask, in_mask):
    if counting_on():
        _record('conv', pairs=((rb.in_idx >= 0) & out_mask[:, None, :]).sum(), cin=w.shape[1],
                cout=w.shape[2], rows_in=in_mask.sum(), rows_out=out_mask.sum())
    return _SparseConv.apply(x, w, rb, out_mask)


class SparseConv(nn.Module):
    def __init__(self, fin, fout, use_bias=False):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(27, fin, fout))
        self.bias = nn.Parameter(torch.zeros(fout)) if use_bias else None

    def forward(self, x, rb, out_mask, in_mask):
        y = sparse_conv(x, rb, self.kernel, out_mask, in_mask)
        if self.bias is not None:
            y = torch.where(out_mask[..., None], y + self.bias, 0)
        return y


BN = dict(eps=1e-3, momentum=0.99)


class ConvModule(nn.Module):
    def __init__(self, fin, fout):
        super().__init__()
        self.SparseConv_0 = SparseConv(fin, fout)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(fout, **BN)

    def forward(self, x, rb, out_mask, in_mask):
        return F.relu(self.MaskedBatchNorm_0(self.SparseConv_0(x, rb, out_mask, in_mask),
                                             out_mask))


class SparseBasicBlock(nn.Module):
    def __init__(self, planes, with_se=False):
        super().__init__()
        self.SparseConv_0 = SparseConv(planes, planes, use_bias=True)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(planes, **BN)
        self.SparseConv_1 = SparseConv(planes, planes, use_bias=True)
        self.MaskedBatchNorm_1 = MaskedBatchNorm(planes, **BN)
        self.FlattenSELayer_0 = FlattenSELayer(planes) if with_se else None

    def forward(self, x, rb, mask):
        out = F.relu(self.MaskedBatchNorm_0(self.SparseConv_0(x, rb, mask, mask), mask))
        out = self.MaskedBatchNorm_1(self.SparseConv_1(out, rb, mask, mask), mask)
        if self.FlattenSELayer_0 is not None:
            out = self.FlattenSELayer_0(out, mask)
        return torch.where(mask[..., None], F.relu(out + x), 0)


class UpBlock(nn.Module):
    def __init__(self, inplanes, planes):
        super().__init__()
        self.inplanes = inplanes
        self.SparseBasicBlock_0 = SparseBasicBlock(inplanes)
        self.ConvModule_0 = ConvModule(2 * inplanes, inplanes)
        self.ConvModule_1 = ConvModule(inplanes, planes)

    def forward(self, x_bottom, x_lateral, rb, mask, out_rb, out_mask):
        x_trans = self.SparseBasicBlock_0(x_lateral, rb, mask)
        x = torch.cat([x_bottom, x_trans], -1)
        x_m = self.ConvModule_0(x, rb, mask, mask)
        n, v, c2 = x.shape
        x_red = x.reshape(n, v, self.inplanes, c2 // self.inplanes).sum(-1)
        return self.ConvModule_1(x_m + x_red, out_rb, out_mask, mask)


class _ProjectBNReLU(nn.Module):
    def __init__(self, fin, fout):
        super().__init__()
        self.Dense_0 = nn.Linear(fin, fout, bias=False)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(fout, eps=1e-5, momentum=0.9)

    def forward(self, x, mask):
        return F.relu(self.MaskedBatchNorm_0(dense(self.Dense_0, x, mask), mask))


class OCRLayer(nn.Module):
    drop = 0.05

    def __init__(self, cin=256, mid=128, key=64):
        super().__init__()
        self.key_channels = key
        self.transform_kernel = nn.Parameter(torch.zeros(27, cin, mid))
        self.MaskedBatchNorm_0 = MaskedBatchNorm(mid, eps=1e-5, momentum=0.9)
        self._ProjectBNReLU_0 = _ProjectBNReLU(mid, key)
        self._ProjectBNReLU_1 = _ProjectBNReLU(mid, key)
        self._ProjectBNReLU_2 = _ProjectBNReLU(mid, key)
        self._ProjectBNReLU_3 = _ProjectBNReLU(key, mid)
        self._ProjectBNReLU_4 = _ProjectBNReLU(2 * mid, cin)

    def forward(self, features, probs, rb, mask, rng=None):
        feats = F.relu(self.MaskedBatchNorm_0(
            sparse_conv(features, rb, self.transform_kernel, mask, mask), mask))
        attn = torch.softmax(torch.where(mask[..., None], probs, -1e9), dim=1)
        context = torch.einsum('bvk,bvc->bkc', rnd(attn), rnd(feats))
        ones = torch.ones(context.shape[:2], dtype=torch.bool, device=context.device)
        query = self._ProjectBNReLU_0(feats, mask)
        key = self._ProjectBNReLU_1(context, ones)
        value = self._ProjectBNReLU_2(context, ones)
        sim = torch.einsum('bvk,bck->bvc', rnd(query), rnd(key)) * (self.key_channels ** -0.5)
        sim = torch.softmax(sim, dim=-1)
        ctx = self._ProjectBNReLU_3(torch.einsum('bvc,bck->bvk', rnd(sim), rnd(value)), mask)
        if counting_on():
            nc, kc = probs.shape[-1], self.key_channels
            _record('matmul', flops=2 * mask.sum() * nc * (feats.shape[-1] + 2 * kc))
        out = self._ProjectBNReLU_4(torch.cat([ctx, feats], -1), mask)
        out = dropout(out, self.drop, rng, self.training)
        return torch.where(mask[..., None], out, 0)


# --- window attention ------------------------------------------------------

MASK32 = 0xFFFFFFFF


def _mul32(a, b: int):
    lo, hi = b & 0xFFFF, b >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & MASK32


def mix32(x):
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def keep_mask(seed, n, nhead, t, rate):
    """bool [n, nhead, t, t]: the dropout keep decision of each softmax
    weight, the counter hash of (seed, window, head, query, key)."""
    s = mix32(seed.reshape(1).long() & MASK32)
    wh = torch.arange(n * nhead, device=seed.device, dtype=torch.int64).reshape(n, nhead, 1, 1)
    ctr = mix32(torch.arange(t * t, device=seed.device, dtype=torch.int64).reshape(t, t))
    return mix32(ctr ^ mix32(s ^ wh)) >= min(int(rate * 2 ** 32), 2 ** 32 - 1)


def attention(packed, bias, nhead, nw, seed=None, rate=0.0):
    """packed [N, T, 3C] q|k|v, bias [N, T], nw [B]: softmax(q k^T + bias)
    (dropped out at `rate`) v per window and head; windows past nw give 0."""
    n, t, c3 = packed.shape
    c = c3 // 3
    hd = c // nhead
    q, k, v = (rnd(x).reshape(n, t, nhead, hd) for x in packed.split(c, -1))
    w = torch.softmax(torch.einsum('nthd,nshd->nhts', q, k) + bias[:, None, None, :], -1)
    if rate > 0.0:
        with torch.no_grad():
            keep = keep_mask(seed, n, nhead, t, rate)
        w = w * (keep.float() / max(1.0 - rate, 1e-6))
    out = torch.einsum('nhts,nshd->nthd', rnd(w), v).reshape(n, t, c)
    wps = n // nw.shape[0]
    live = (torch.arange(n, device=packed.device) % wps) < nw.repeat_interleave(wps)
    return torch.where(live[:, None, None], out, 0)


class _RecomputedAttention(torch.autograd.Function):
    """The train attention keeping only its inputs: the graph of all layers'
    [N, H, T, T] weights would outgrow the card."""

    @staticmethod
    def forward(ctx, packed, bias, seed, nw, nhead, rate):
        ctx.save_for_backward(packed, bias, seed, nw)
        ctx.nhead, ctx.rate = nhead, rate
        return attention(packed, bias, nhead, nw, seed, rate)

    @staticmethod
    def backward(ctx, g):
        packed, bias, seed, nw = ctx.saved_tensors
        with torch.enable_grad():
            x = packed.detach().requires_grad_(True)
            (gx,) = torch.autograd.grad(attention(x, bias, ctx.nhead, nw, seed, ctx.rate), x, g)
        return gx, None, None, None, None, None


def _record_attention(bias, nw, c, nhead, train):
    if not counting_on():
        return
    n, t = bias.shape
    wps = n // nw.shape[0]
    live = (torch.arange(n, device=bias.device) % wps) < nw.repeat_interleave(wps)
    tokens = (bias == 0).sum(-1)[live]
    _record('attention', tokens=tokens.cpu().numpy(), t=t, c=c, nhead=nhead, train=train)


def head_l2norm(x, nhead, eps=1e-12):
    shp = x.shape
    xh = x.reshape(shp[:-1] + (nhead, shp[-1] // nhead))
    return (xh * torch.rsqrt(xh.square().sum(-1, keepdim=True) + eps)).reshape(shp)


ATTN_DROP = 0.1


class WindowAttention(nn.Module):
    def __init__(self, d, nhead, levels, shift, tau_min=0.01):
        super().__init__()
        self.d_model, self.nhead, self.levels, self.shift = d, nhead, levels, shift
        self.attn_drop, self.tau_min = ATTN_DROP, tau_min
        self.in_proj_kernel = nn.Parameter(torch.zeros(d, 3 * d))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.tau = nn.Parameter(torch.full((nhead,), 0.1))
        self.out_proj = nn.Linear(d, d)

    def forward(self, feat, windowed, part, rng=None):
        pos, biases, comb, inv_idx = windowed
        c, h = self.d_model, self.nhead
        b = feat.shape[0]
        if counting_on():
            _record('linear', rows=part.keep.sum(), fin=c, fout=3 * c)
        wk = rnd(self.in_proj_kernel)
        qk = rnd(feat + pos) @ wk[:, :2 * c] + self.in_proj_bias[:2 * c]
        val = rnd(feat) @ wk[:, 2 * c:] + self.in_proj_bias[2 * c:]
        scale = (1.0 / torch.clamp(self.tau, min=self.tau_min)).repeat_interleave(c // h)
        q = head_l2norm(qk[..., :c], h) * scale
        k = head_l2norm(qk[..., c:], h)
        big = take_rows_or_zero(torch.cat([q, k, val], -1), inv_idx)
        offs = st.level_offsets(self.levels)
        if self.training:
            seeds = torch.randint(0, 2 ** 31 - 1, (len(self.levels),), generator=rng,
                                  device=feat.device, dtype=torch.int32)
        outs = []
        for li, spec in enumerate(self.levels):
            w, t = spec.num_windows, spec.max_tokens
            seg = big[:, offs[li]:offs[li + 1]].reshape(b * w, t, 3 * c)
            bias2 = biases[li].reshape(b * w, t)
            nw = torch.clamp(part.shifts[self.shift].num_windows[:, li], max=w)
            _record_attention(bias2, nw, c, h, self.training)
            if self.training:
                o = _RecomputedAttention.apply(seg, bias2, seeds[li:li + 1], nw, h, self.attn_drop)
            else:
                o = attention(seg, bias2, h, nw)
            outs.append(o.reshape(b, w * t, c))
        out = take_rows_or_zero(torch.cat(outs, 1), comb)
        return dense(self.out_proj, out, part.keep)


class MLP(nn.Module):
    def __init__(self, d, hidden):
        super().__init__()
        self.Dense_0 = nn.Linear(d, hidden)
        self.Dense_1 = nn.Linear(hidden, d)

    def forward(self, x, mask):
        return dense(self.Dense_1, F.gelu(dense(self.Dense_0, x, mask), approximate='tanh'), mask)


class EncoderLayer(nn.Module):
    def __init__(self, d, nhead, hidden, levels, shift, rate=0.0, rate_dtype=torch.float32):
        super().__init__()
        self.drop_path, self.rate_dtype = rate, rate_dtype
        self.WindowAttention_0 = WindowAttention(d, nhead, levels, shift)
        self.LayerNorm_0 = nn.LayerNorm(d, eps=1e-6)
        self.MLP_0 = MLP(d, hidden)
        self.LayerNorm_1 = nn.LayerNorm(d, eps=1e-6)

    def forward(self, feat, windowed, part, rng=None):
        a = self.LayerNorm_0(self.WindowAttention_0(feat, windowed, part, rng))
        feat = feat + drop_path(a, self.drop_path, rng, self.training, self.rate_dtype)
        m = self.LayerNorm_1(self.MLP_0(feat, part.keep))
        return feat + drop_path(m, self.drop_path, rng, self.training, self.rate_dtype)


class SWFormerBlock(nn.Module):
    def __init__(self, d, nhead, depth, window, levels, mlp_ratio=2.0, rates=(),
                 rate_dtype=torch.float32):
        super().__init__()
        self.d_model, self.window_shape, self.levels = d, tuple(window), levels
        rates = tuple(rates) if rates else (0.0,) * depth
        half = depth // 2
        hidden = int(d * mlp_ratio)
        self.layers_shift0 = nn.ModuleList(
            EncoderLayer(d, nhead, hidden, levels, 0, rates[i], rate_dtype) for i in range(half))
        self.layers_shift1 = nn.ModuleList(
            EncoderLayer(d, nhead, hidden, levels, 1, rates[i], rate_dtype)
            for i in range(half, depth))

    def forward(self, feat, part, rng=None):
        feat = torch.where(part.keep[..., None], feat, 0)
        b, v = feat.shape[:2]
        total = st.level_offsets(self.levels)[-1]
        offs = st.level_offsets(self.levels)
        for shift, layers in ((0, self.layers_shift0), (1, self.layers_shift1)):
            if len(layers) == 0:
                continue
            sp = part.shifts[shift]
            pos = st.positional_embedding(sp.coors_in_win, self.window_shape, self.d_model)
            comb = st.combined_index(sp, self.levels)
            inv_idx = torch.full((b, total + 1), -1, dtype=torch.long, device=feat.device)
            inv_idx.scatter_(1, torch.where(comb >= 0, comb, total),
                             torch.arange(v, device=feat.device).expand(b, v))
            inv_idx = inv_idx[:, :total]
            big = torch.where(inv_idx >= 0, 0.0, -1e9)
            biases = tuple(big[:, offs[li]:offs[li + 1]].reshape(b, s.num_windows, s.max_tokens)
                           for li, s in enumerate(self.levels))
            windowed = (pos, biases, comb, inv_idx)
            for layer in layers:
                feat = layer(feat, windowed, part, rng)
        return feat


# --- the segmentors --------------------------------------------------------

class Spec:
    """The model's static sizes, read from a config dict."""

    def __init__(self, cfg: dict):
        ds, md, rt = cfg['DATASET'], cfg['MODEL'], cfg['RUNTIME']
        gx, gy, gz = (int(g) for g in np.round(
            (np.asarray(ds['POINT_CLOUD_RANGE'], np.float32)[3:]
             - np.asarray(ds['POINT_CLOUD_RANGE'], np.float32)[:3])
            / np.asarray(ds['VOXEL_SIZE'], np.float32)).astype(np.int64))
        self.segmentor = md['SEGMENTOR']
        self.num_classes = int(ds['NUM_CLASSES'])
        self.dim_point = int(ds['DIM_POINT'])
        self.spatial_shape = (gz, gy, gx)
        self.capacities = st.stage_capacities(int(rt['MAX_VOXELS_PER_SAMPLE']),
                                              rt['STAGE_CAPACITY_RATIOS'])
        self.window_shape = tuple(md['WINDOW_SHAPE'])
        self.depths = tuple(md['DEPTHS'])
        self.drop_path_rate = float(md['DROP_PATH_RATE'])
        self.levels = tuple(st.level_specs(md['BATCHING_INFO'][s], self.capacities[s],
                                           rt['WINDOW_BUCKET_FRACTIONS'][s]) for s in range(4))
        self.compute_dtype = getattr(torch, rt['COMPUTE_DTYPE'])
        self.voxel_size = tuple(ds['VOXEL_SIZE'])
        self.point_cloud_range = tuple(ds['POINT_CLOUD_RANGE'])
        for key, want in (('USE_MULTI_SWEEPS', False), ('USE_CYLINDER', False),
                          ('USE_IMAGE_FEATURE', False)):
            if ds[key] != want:
                raise NotImplementedError(f'the reference has no DATASET.{key} = {ds[key]}')


class SegmentorHead(nn.Module):
    def __init__(self, cin, num_classes, fusion=64):
        super().__init__()
        self.drop = 0.3
        self.LinearBNReLU_0 = LinearBNReLU(cin, 256)
        self.LinearBNReLU_1 = LinearBNReLU(256, 128)
        self.LinearBNReLU_2 = LinearBNReLU(128, fusion)
        self.FlattenSELayer_0 = FlattenSELayer(fusion)
        self.LinearBNReLU_3 = LinearBNReLU(fusion, 64)
        self.Dense_0 = nn.Linear(64, num_classes, bias=False)

    def forward(self, x, mask, rng=None):
        x = self.LinearBNReLU_0(x, mask)
        x = self.LinearBNReLU_1(x, mask)
        x = self.LinearBNReLU_2(x, mask)
        x = x + self.FlattenSELayer_0(x, mask)
        x = self.LinearBNReLU_3(x, mask)
        x = dropout(x, self.drop, rng, self.training)
        return torch.where(mask[..., None], dense(self.Dense_0, x, mask), 0)


class PointBranch(nn.Module):
    def __init__(self, spec: Spec, channels=64):
        super().__init__()
        self.PointEncoder_0 = PointEncoder(spec.dim_point, channels)

    def forward(self, batch):
        cur = batch['cur_point_mask'] & batch['point_mask']
        per_point = self.PointEncoder_0(batch['points'], cur)
        v_cap = batch['voxel_coords'].shape[1]
        voxels = vfe_max(per_point, torch.where(cur, batch['point_voxel_ids'], -1), v_cap)
        return per_point, voxels, cur


CHANNELS = (48, 96, 192, 384)


class PointTransformer(nn.Module):
    def __init__(self, spec: Spec, cin=64, cout=32):
        super().__init__()
        chans = (cin,) + CHANNELS
        dpr = np.linspace(0, spec.drop_path_rate, sum(spec.depths)).tolist()
        bounds = np.cumsum((0,) + spec.depths).tolist()
        for s in range(4):
            setattr(self, f'ConvModule_{s}', ConvModule(chans[s], chans[s + 1]))
            setattr(self, f'SWFormerBlock_{s}', SWFormerBlock(
                CHANNELS[s], 8, spec.depths[s], spec.window_shape, spec.levels[s],
                rates=tuple(dpr[bounds[s]:bounds[s + 1]]), rate_dtype=spec.compute_dtype))
        self.aux_voxel_classifier = nn.Linear(CHANNELS[3], spec.num_classes, bias=False)
        self.UpBlock_0 = UpBlock(384, 192)
        self.UpBlock_1 = UpBlock(192, 96)
        self.UpBlock_2 = UpBlock(96, 48)
        self.UpBlock_3 = UpBlock(48, cout)
        self.voxel_classifier = nn.Linear(cout, spec.num_classes, bias=False)
        self.spec = spec

    def forward(self, x, plans: st.UNetPlans, rng=None):
        spec = self.spec
        m1, m2, m3, m4 = plans.masks
        rb1, rb2, rb3, rb4 = plans.subm
        d2, d3, d4 = plans.down
        rules = (rb1, d2.rule, d3.rule, d4.rule)
        in_masks = (m1, m1, m2, m3)
        skips = []
        for s in range(4):
            x = getattr(self, f'ConvModule_{s}')(x, rules[s], plans.masks[s], in_masks[s])
            part = st.window_partition(plans.coords[s], plans.masks[s], plans.shapes[s],
                                       spec.window_shape, spec.levels[s])
            x = getattr(self, f'SWFormerBlock_{s}')(x, part, rng)
            skips.append(x)
        aux = dense(self.aux_voxel_classifier, skips[3], m4)
        x = self.UpBlock_0(skips[3], skips[3], rb4, m4, d4.inv_rule, m3)
        x = self.UpBlock_1(x, skips[2], rb3, m3, d3.inv_rule, m2)
        x = self.UpBlock_2(x, skips[1], rb2, m2, d2.inv_rule, m1)
        x = self.UpBlock_3(x, skips[0], rb1, m1, rb1, m1)
        return x, dense(self.voxel_classifier, x, m1), aux


class SparseUnet(nn.Module):
    def __init__(self, cin, cout, num_classes):
        super().__init__()
        prev, block = cin, 0
        for s, c in enumerate((32, 64, 128, 256)):
            setattr(self, f'ConvModule_{s}', ConvModule(prev, c))
            n = 2 if s == 0 else 3
            for i in range(n):
                setattr(self, f'SparseBasicBlock_{block}',
                        SparseBasicBlock(c, with_se=s >= 2 and i == n - 1))
                block += 1
            prev = c
        self.aux_voxel_classifier = nn.Linear(256, num_classes, bias=False)
        self.OCRLayer_0 = OCRLayer(256, 128, 64)
        self.UpBlock_0 = UpBlock(256, 128)
        self.UpBlock_1 = UpBlock(128, 64)
        self.UpBlock_2 = UpBlock(64, 32)
        self.UpBlock_3 = UpBlock(32, cout)
        self.voxel_classifier = nn.Linear(cout, num_classes, bias=False)

    def forward(self, x, plans: st.UNetPlans, rng=None):
        m1, m2, m3, m4 = plans.masks
        rb1, rb2, rb3, rb4 = plans.subm
        d2, d3, d4 = plans.down
        rules = (rb1, d2.rule, d3.rule, d4.rule)
        in_masks = (m1, m1, m2, m3)
        skips, block = [], 0
        for s in range(4):
            x = getattr(self, f'ConvModule_{s}')(x, rules[s], plans.masks[s], in_masks[s])
            for _ in range(2 if s == 0 else 3):
                x = getattr(self, f'SparseBasicBlock_{block}')(x, plans.subm[s], plans.masks[s])
                block += 1
            skips.append(x)
        aux = dense(self.aux_voxel_classifier, skips[3], m4)
        x4 = self.OCRLayer_0(skips[3], aux, rb4, m4, rng)
        x = self.UpBlock_0(x4, x4, rb4, m4, d4.inv_rule, m3)
        x = self.UpBlock_1(x, skips[2], rb3, m3, d3.inv_rule, m2)
        x = self.UpBlock_2(x, skips[1], rb2, m2, d2.inv_rule, m1)
        x = self.UpBlock_3(x, skips[0], rb1, m1, rb1, m1)
        return x, dense(self.voxel_classifier, x, m1), aux


class Segmentor(nn.Module):
    """Segformer (voxel channels 32) or SPNet (64): point branch, backbone,
    devoxelize, fusion head. forward -> the logits and what the loss needs."""

    def __init__(self, spec: Spec):
        super().__init__()
        self.spec = spec
        self.PointBranch_0 = PointBranch(spec, 64)
        if spec.segmentor == 'segformer':
            voxel_channels = 32
            self.PointTransformer_0 = PointTransformer(spec, 64, voxel_channels)
        elif spec.segmentor == 'spnet':
            voxel_channels = 64
            self.SparseUnet_0 = SparseUnet(64, voxel_channels, spec.num_classes)
        else:
            raise NotImplementedError(spec.segmentor)
        self.SegmentorHead_0 = SegmentorHead(64 + voxel_channels, spec.num_classes)

    def forward(self, batch, rng=None):
        spec = self.spec
        per_point, voxels, cur = self.PointBranch_0(batch)
        plans = st.unet_plans(batch['voxel_coords'], spec.spatial_shape, spec.capacities)
        backbone = (self.PointTransformer_0 if spec.segmentor == 'segformer'
                    else self.SparseUnet_0)
        vf, voxel_out, aux_out = backbone(voxels, plans, rng)
        vids = batch['point_voxel_ids']
        fusion = torch.cat([per_point, voxel_to_point(vf, vids)], -1)
        return {'point_out': self.SegmentorHead_0(fusion, cur, rng),
                'voxel_out': voxel_out, 'aux_voxel_out': aux_out,
                'voxel_coords': batch['voxel_coords'], 'voxel_mask': batch['voxel_mask'],
                'aux_voxel_coords': plans.coords[3], 'aux_voxel_mask': plans.masks[3]}

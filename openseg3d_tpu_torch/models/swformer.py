"""SWFormer window-attention blocks.

Counterpart of ``openseg3d_tpu/models/swformer.py``. Each encoder layer runs
cosine multi-head attention per occupancy level on static [B*W_l, T_l, C]
window buffers, followed by the post-norm residual and MLP. The flax
``nn.scan`` over layers becomes a ``ModuleList`` per shift (weights.py
unstacks the scanned parameters).

Training (``nn.Module.training``) adds, with randomness drawn from the
``torch.Generator`` the caller passes (``rng``):
  * attention dropout (rate 0.1) inside the train attention core, one int32
    seed per level and layer (``swformer.py:145-148``);
  * drop path per sample, [B, 1, 1] masks, x / keep, on both residuals
    (``swformer.py:208-215,240-242``), at the layer's rate;
  * MLP dropout (rate 0.0 by default, ``swformer.py:197-205``).
The train attention core covers every level: the JAX package's VMEM fallback
to an einsum (``_level_fits``) has no counterpart on this card. The JAX
package rematerialises each layer in the backward (``nn.remat``, a memory
choice); autograd here keeps the activations.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import window_attention_packed, window_attention_packed_train
from ..ops.window import WindowPartition, permute_rows, positional_embedding
from .layers import dense, dropout

# flax nn.LayerNorm's default epsilon (torch's default is 1e-5)
FLAX_LN_EPS = 1e-6
# training dropout rates, the JAX modules' defaults, which no config changes:
# attention weights (``swformer.py:75``) and MLP (``:197``); a test may set an
# instance's ``attn_drop`` / ``drop`` to 0
ATTN_DROP = 0.1
MLP_DROP = 0.0


def level_offsets(levels):
    """Row offsets of each level's [W_l*T_l] slot range in the combined
    all-levels window buffer."""
    offs = [0]
    for sp in levels:
        offs.append(offs[-1] + sp.num_windows * sp.max_tokens)
    return tuple(offs)


def combined_scatter_index(sp, levels):
    """Per-voxel slot into the combined buffer (-1 = dropped): each voxel
    belongs to at most one level per shift."""
    offs = level_offsets(levels)
    comb = torch.full_like(sp.scatter_idx[0], -1)
    for li in range(len(levels)):
        idx = sp.scatter_idx[li]
        comb = torch.where(idx >= 0, idx + offs[li], comb)
    return comb


def _head_l2norm(x: torch.Tensor, nhead: int, eps: float = 1e-12) -> torch.Tensor:
    """Per-head L2 normalisation of flat [..., C] features, in float32."""
    shp = x.shape
    xh = x.reshape(shp[:-1] + (nhead, shp[-1] // nhead)).float()
    xh = xh * torch.rsqrt(xh.square().sum(-1, keepdim=True) + eps)
    return xh.reshape(shp)


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """flax LayerNorm(dtype=x.dtype): statistics and affine in float32, the
    result cast back to x's dtype."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps).to(x.dtype)


def drop_path(x: torch.Tensor, rate: float, rng: torch.Generator | None,
              training: bool) -> torch.Tensor:
    """Stochastic depth (``swformer.py:208-215``): per sample, keep x / keep
    with probability keep = 1 - rate, else zero. The rate rides in x's dtype,
    as the JAX package's scanned rate does."""
    if not training or rate == 0.0:
        return x
    keep = 1 - torch.tensor(rate, dtype=x.dtype)
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    mask = torch.rand(shape, generator=rng, device=x.device) < float(keep)
    return torch.where(mask, x / torch.clamp(keep, min=1e-6).to(x.device), 0)


class WindowAttention(nn.Module):
    """Cosine window multi-head attention.

    The packed in_proj, per-head cosine normalisation and 1/tau scale run on
    the flat [B, V, C] features; one row gather fills the combined window
    buffer with q|k|v, the attention core runs once per level, and one row
    gather brings the outputs back. The attention core is
    ``ops.attention.window_attention_packed`` in eval and
    ``window_attention_packed_train`` (attention dropout, differentiable) in
    training: the CUDA kernels on a CUDA tensor, the plain versions on a CPU
    tensor."""

    def __init__(self, d_model: int, nhead: int, levels: tuple, shift: int,
                 tau_min: float = 0.01):
        super().__init__()
        self.d_model, self.nhead, self.levels, self.shift = d_model, nhead, levels, shift
        self.attn_drop, self.tau_min = ATTN_DROP, tau_min
        self.in_proj_kernel = nn.Parameter(torch.zeros(d_model, 3 * d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.tau = nn.Parameter(torch.full((nhead,), 0.1))
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, feat, windowed, part: WindowPartition, rng=None):
        pos, biases, comb, inv_idx = windowed
        c, h = self.d_model, self.nhead
        b = feat.shape[0]
        dt = feat.dtype

        # q and k project feat+pos, v projects feat: slicing the packed
        # kernel multiplies each input once
        wd, bd = self.in_proj_kernel.to(dt), self.in_proj_bias.to(dt)
        qk = (feat + pos) @ wd[:, :2 * c] + bd[:2 * c]
        val = feat @ wd[:, 2 * c:] + bd[2 * c:]
        scale = 1.0 / torch.clamp(self.tau, min=self.tau_min)       # [h]
        scale_c = scale.repeat_interleave(c // h)                    # [C]
        q = (_head_l2norm(qk[..., :c], h) * scale_c).to(dt)
        k = _head_l2norm(qk[..., c:], h).to(dt)

        big = permute_rows(torch.cat([q, k, val], dim=-1), inv_idx, comb)  # [B, S, 3C]
        offs = level_offsets(self.levels)
        if self.training:
            # one int32 seed per level for the attention dropout
            seeds = torch.randint(0, 2 ** 31 - 1, (len(self.levels),), generator=rng,
                                  device=feat.device, dtype=torch.int32)
        outs = []
        for li, spec in enumerate(self.levels):
            w, t = spec.num_windows, spec.max_tokens
            seg = big[:, offs[li]:offs[li + 1]].reshape(b * w, t, 3 * c).contiguous()
            bias2 = biases[li].reshape(b * w, t).contiguous()
            # true window count per sample: windows past it are padding
            nw = torch.clamp(part.shifts[self.shift].num_windows[:, li], max=w).int()
            if self.training:
                o3 = window_attention_packed_train(seg, bias2, seeds[li:li + 1], nw, h,
                                                   self.attn_drop)
            else:
                o3 = window_attention_packed(seg, bias2, h, nw)
            outs.append(o3.reshape(b, w * t, c))
        out = permute_rows(torch.cat(outs, dim=1), comb, inv_idx)    # [B, V, C]
        return dense(self.out_proj, out.to(dt))


class MLP(nn.Module):
    def __init__(self, d_model: int, hidden: int):
        super().__init__()
        self.drop = MLP_DROP
        self.Dense_0 = nn.Linear(d_model, hidden)
        self.Dense_1 = nn.Linear(hidden, d_model)

    def forward(self, x, rng=None):
        # flax nn.gelu defaults to the tanh approximation (torch's to the exact erf)
        x = F.gelu(dense(self.Dense_0, x), approximate='tanh')
        x = dense(self.Dense_1, dropout(x, self.drop, rng, self.training))
        return dropout(x, self.drop, rng, self.training)


class EncoderLayer(nn.Module):
    """Post-norm residual encoder layer:
    x = x + drop_path(LN(attn(x))); x = x + drop_path(LN(mlp(x)))."""

    def __init__(self, d_model: int, nhead: int, mlp_hidden: int, levels: tuple,
                 shift: int, drop_path: float = 0.0):
        super().__init__()
        self.drop_path = drop_path
        self.WindowAttention_0 = WindowAttention(d_model, nhead, levels, shift)
        # flax LayerNorm's epsilon is 1e-6, not torch's 1e-5
        self.LayerNorm_0 = nn.LayerNorm(d_model, eps=FLAX_LN_EPS)
        self.MLP_0 = MLP(d_model, mlp_hidden)
        self.LayerNorm_1 = nn.LayerNorm(d_model, eps=FLAX_LN_EPS)

    def forward(self, feat, windowed, part, rng=None):
        a = _layer_norm(self.LayerNorm_0, self.WindowAttention_0(feat, windowed, part, rng))
        feat = feat + drop_path(a, self.drop_path, rng, self.training)
        m = _layer_norm(self.LayerNorm_1, self.MLP_0(feat, rng))
        return feat + drop_path(m, self.drop_path, rng, self.training)


class SWFormerBlock(nn.Module):
    """depth//2 layers on shift 0, then the rest on shift 1; drop_path holds
    one stochastic-depth rate per layer."""

    def __init__(self, d_model: int, nhead: int, depth: int, window_shape: tuple,
                 levels: tuple, mlp_ratio: float = 2.0, drop_path: tuple = ()):
        super().__init__()
        self.d_model, self.window_shape, self.levels = d_model, tuple(window_shape), levels
        hidden = int(d_model * mlp_ratio)
        rates = tuple(drop_path) if drop_path else (0.0,) * depth
        half = depth // 2
        self.layers_shift0 = nn.ModuleList(
            EncoderLayer(d_model, nhead, hidden, levels, 0, rates[i])
            for i in range(half))
        self.layers_shift1 = nn.ModuleList(
            EncoderLayer(d_model, nhead, hidden, levels, 1, rates[i])
            for i in range(half, depth))

    def forward(self, feat, part: WindowPartition, rng=None):
        # drop everything the dual-shift caps dropped
        feat = torch.where(part.keep[..., None], feat, 0)
        b, v = feat.shape[:2]
        total = level_offsets(self.levels)[-1]
        for shift, layers in ((0, self.layers_shift0), (1, self.layers_shift1)):
            if len(layers) == 0:
                continue
            sp = part.shifts[shift]
            pos = positional_embedding(sp.coors_in_win, self.window_shape,
                                       self.d_model).to(feat.dtype)
            comb = combined_scatter_index(sp, self.levels)
            # invert comb into the layer-invariant slot -> voxel index (-1 =
            # padding slot). JAX drops out-of-range scatter targets
            # (mode='drop'); a torch scatter would raise, so dropped voxels
            # write to a trash column that is cut off.
            inv_idx = torch.full((b, total + 1), -1, dtype=torch.long, device=feat.device)
            inv_idx.scatter_(1, torch.where(comb >= 0, comb, total),
                             torch.arange(v, device=feat.device).expand(b, v))
            inv_idx = inv_idx[:, :total]
            big = torch.where(inv_idx >= 0, 0.0, -1e9)               # key bias, float32
            offs = level_offsets(self.levels)
            biases = tuple(big[:, offs[li]:offs[li + 1]].reshape(
                b, spec.num_windows, spec.max_tokens) for li, spec in enumerate(self.levels))
            windowed = (pos, biases, comb, inv_idx)
            for layer in layers:
                feat = layer(feat, windowed, part, rng)
        return feat

// Packed window attention for training on Hopper (sm_90a): the forward with
// attention dropout, and its backward.
//
// Replaces the TPU kernels of the custom VJP window_attention_packed_train in
// openseg3d_tpu/ops/attention.py:
//   forward  _train_call -> _kernel_packed_train (B1 plus dropout on the
//            softmax weights, kept weights scaled by 1/(1-p));
//   backward _train_call -> _kernel_packed_bwd / _kernel_packed_bwd_body
//            (recomputes the softmax, regenerates the dropout mask, returns
//            dq|dk|dv packed like the input).
// Semantics per window n and head h of packed q|k|v rows [N, T, 3C]:
//   P = softmax(q_h k_h^T + bias[n]),  Z = keep mask,  O = (P * Z / (1-p)) v_h.
// Windows whose rank within their sample is >= nw[sample] give zero output
// and zero gradients without being computed.
//
// Dropout mask. The keep decision of weight (n, h, i, j) is a pure function
// of (seed, n, h, i, j): bits = mix32(mix32(i*T + j) ^ mix32(mix32(seed) ^
// (n*H + h))), kept iff bits >= threshold (threshold = p * 2^32). The forward
// and both backward passes evaluate it where they need it, so nothing of the
// mask is stored, and the plain PyTorch version (ops/attention.py,
// dropout_keep_mask) computes the same bits with integer tensor arithmetic.
// The bf16 kernels compute the inner mix32(i*T + j), which no head changes,
// once per block and tile in shared memory (stage_hash), for all its heads.
//
// Residual. The forward writes O and, per row and head, the softmax's max
// logit m and sum l (float2), from which the backward rebuilds
// P = exp(s - m) / l. (A single log-sum-exp would lose P for a fully padded
// window: its logits sit at -1e9, where the float32 spacing is 64.) The
// backward is two launches, no atomics, so its sums are the same from run to
// run: a dq pass (D_i = dO_i . O_i, equal to sum_j P_ij dP_ij with dropout;
// dS_ij = P_ij (Z_ij dP_ij / (1-p) - D_i); dq_i = sum_j dS_ij k_j; writes dq
// and D), then a dk/dv pass (dv_j = sum_i P_ij Z_ij / (1-p) dO_i,
// dk_j = sum_i dS_ij q_i).
//
// bf16, the production dtype: tensor cores (window_attention_mma.cuh).
//   What bounds it on this card: per window and head the forward does
//   4 T^2 HD flops against T (8C + 4 + 64) bytes, the backward 10 T^2 HD
//   against ~2x the bytes: 100-160 flop/byte at T = 256, above the ridge of
//   the CUDA cores' float32 (20) and below that of the bf16 tensor cores
//   (295) up to T ~ 590. So the products go to mma.sync and the kernels
//   should be bound by bytes, or by what runs per softmax weight besides
//   the products: exp, and the dropout hash (two mix32, ~12 integer
//   operations; see PERF.md for its measured cost).
//   Design. A block is one window and 16 rows of it, with one warp per head
//   (all heads of the window share the block's staged rows): query rows for
//   the forward and the dq pass, key rows for the dk/dv pass. The block
//   stages its own 16 rows once, then streams the other side of the product
//   (k|v rows, or q and dO rows with their m, 1/l and D) through shared
//   memory in tiles of KT rows, two tiles in flight (cp.async of whole rows,
//   double buffered), so T = 800 needs no [T, T] buffer. Per 16-key (or
//   16-query) chunk a warp computes its 16 x 16 logits with mma_head, and
//   - forward: FlashAttention-2's online softmax on the accumulator
//     fragments; each element knows its (query, key), so it applies keep()
//     and 1/(1-p) before the weights are rounded to bf16 and become the A
//     fragment of P V (the eval kernel's body, wa_mma::attend_rows, with a
//     dropout hook);
//   - dq pass: P from (m, l), dP = dO V^T, dS, then dq += dS K with dS in
//     bf16;
//   - dk/dv pass: the transposed logits S^T = K Q^T and dP^T = V dO^T, then
//     dv += (P Z / (1-p))^T dO and dk += dS^T Q, both bf16, the dk and dv
//     accumulators fragments of the warp's 16 key rows.
//   Rounding as the TPU kernel's: P and dS are rounded to bf16 before their
//   products (attention.py:429, :626, :636); sums are float32.
//   Keys past T are excluded outright (logit -inf), not biased by -1e9: a
//   fully padded window keeps the uniform softmax over exactly its own T
//   keys.
//   Logits in the backward. The forward and the dq pass compute each logit
//   with the same fragment routine (mma_head: k16 steps, then a k8 step) and
//   add the bias the same way, so the dq pass's logits are the forward's.
//   The dk/dv pass computes them transposed, K Q^T, from the same bf16
//   operands in the same k-step order: the products of two bf16 values are
//   exact in float32 and only the order of the tensor core's float32 sum can
//   differ, so the rebuilt logit is within a few float32 ulps of |s| <~ 100
//   (the model's q is unit-norm times 1/tau <= 100 and k unit-norm): an
//   error ~1e-5 in the exponent, a relative 1e-5 in P, far below the 2^-8
//   of P's own bf16 rounding.
// float32 keeps FMA bodies (tensor cores give no float32 that holds the
//   1e-5 gates; TF32 keeps ~3 digits): one thread per row of one head, the
//   other side streamed in 32-row tiles of float, several heads per block at
//   small T, all three kernels in the same operation order, so the backward
//   rebuilds the forward's P bit for bit. It serves the small float32
//   configurations and the float32 references.
//
// Interface: plain C, loaded with ctypes; one entry point per direction,
// dispatching on the dtype. Launches go on the caller's stream; the
// functions return cudaGetLastError() (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "window_attention_mma.cuh"

namespace {

// 32-bit integer bijection ("lowbias32"); mix32 in ops/attention.py
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t window_head_key(uint32_t seed, int n, int nhead, int h) {
  return mix32(mix32(seed) ^ static_cast<uint32_t>(n * nhead + h));
}

__device__ __forceinline__ bool keep(uint32_t key, int i, int j, int t, uint32_t threshold) {
  return threshold == 0u || mix32(mix32(static_cast<uint32_t>(i * t + j)) ^ key) >= threshold;
}

__device__ __forceinline__ bool padding_window(int n, int wps, const int* nw) {
  return n % wps >= nw[n / wps];
}

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
  return cudaSuccess;
}

// ===========================================================================
// float32: FMA bodies
// ===========================================================================
constexpr int kThreads = 128;  // rows (times heads) per block
constexpr int kTile = 32;      // rows staged in shared memory per step

struct Geometry {
  int rows;    // rows of one head per block
  int heads;   // heads per block
};

Geometry geometry(int t, int nhead) {
  Geometry g{t >= kThreads ? kThreads : t, 1};
  if (t < kThreads) {
    for (int h = nhead; h >= 1; --h) {
      if (nhead % h == 0 && h * t <= kThreads) { g.heads = h; break; }
    }
  }
  return g;
}

// Kernel arguments shared by the three kernels.
struct Args {
  int t, c, nhead, heads_per_block, rows_per_block, windows_per_sample;
  uint32_t threshold;
  float inv_keep;
};

// Thread placement, common to the three kernels: grid x = window, y = head
// group, z = row chunk; thread i serves head h0 + i / rows and row
// z * rows + i % rows. An inactive thread (past the block's heads or the
// window's rows) keeps head h0 and row 0 for its addresses and writes nothing.
struct Place {
  int n, h0, hl, h, row;
  bool active, padding;
};

__device__ __forceinline__ Place place(const Args& a, const int* nw) {
  Place p;
  p.n = blockIdx.x;
  p.h0 = blockIdx.y * a.heads_per_block;
  p.hl = threadIdx.x / a.rows_per_block;
  const int row = blockIdx.z * a.rows_per_block + threadIdx.x % a.rows_per_block;
  p.active = p.hl < a.heads_per_block && row < a.t;
  p.h = p.active ? p.h0 + p.hl : p.h0;
  p.row = p.active ? row : 0;
  p.padding = padding_window(p.n, a.windows_per_sample, nw);
  return p;
}

// Stage rows [r0, r0 + nr) of two column groups (offsets off0, off1 within
// the packed row, heads_per_block * HD columns each, starting at head h0)
// into shared memory.
template <int HD>
__device__ __forceinline__ void stage_rows(const float* win, size_t row_stride, int r0, int nr,
                                           int off0, int off1, int h0, int cols,
                                           float* s0, float* s1) {
  for (int i = threadIdx.x; i < nr * cols; i += kThreads) {
    const int j = i / cols, col = i % cols;
    const float* r = win + static_cast<size_t>(r0 + j) * row_stride + h0 * HD + col;
    s0[j * cols + col] = r[off0];
    s1[j * cols + col] = r[off1];
  }
}

// forward: O and (m, l) per query row
template <int HD>
__global__ void __launch_bounds__(kThreads)
window_attention_train_fwd_kernel(const float* __restrict__ packed, const float* __restrict__ bias,
                                  const int* __restrict__ nw, const int* __restrict__ seed,
                                  float* __restrict__ out, float2* __restrict__ stats, Args a) {
  extern __shared__ float smem[];
  const Place p = place(a, nw);
  const int col0 = p.h * HD;
  const size_t c3 = 3 * static_cast<size_t>(a.c);
  const float* win = packed + static_cast<size_t>(p.n) * a.t * c3;
  float* out_row = out + (static_cast<size_t>(p.n) * a.t + p.row) * a.c + col0;
  float2* st = stats + (static_cast<size_t>(p.n) * a.nhead + p.h) * a.t + p.row;

  if (p.padding) {  // the whole block takes this branch
    if (p.active) {
#pragma unroll
      for (int d = 0; d < HD; ++d) out_row[d] = 0.f;
      *st = make_float2(0.f, 1.f);
    }
    return;
  }

  const int cols = a.heads_per_block * HD;
  float* ks = smem;                       // [kTile][cols]
  float* vs = ks + kTile * cols;          // [kTile][cols]
  float* bs = vs + kTile * cols;          // [kTile]

  float q[HD], acc[HD];
  const float* q_row = win + static_cast<size_t>(p.row) * c3 + col0;
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    q[d] = q_row[d];
    acc[d] = 0.f;
  }
  const uint32_t key = window_head_key(static_cast<uint32_t>(seed[0]), p.n, a.nhead, p.h);
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < a.t; k0 += kTile) {
    const int nk = min(kTile, a.t - k0);
    __syncthreads();
    stage_rows<HD>(win, c3, k0, nk, a.c, 2 * a.c, p.h0, cols, ks, vs);
    for (int j = threadIdx.x; j < nk; j += kThreads)
      bs[j] = bias[static_cast<size_t>(p.n) * a.t + k0 + j];
    __syncthreads();
    if (!p.active) continue;

    float s[kTile];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      if (j < nk) {
        const float* kr = ks + j * cols + p.hl * HD;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) dot = fmaf(q[d], kr[d], dot);
        s[j] = dot + bs[j];
        tile_max = fmaxf(tile_max, s[j]);
      }
    }
    const float m_new = fmaxf(m, tile_max);   // finite: bias is -1e9 at worst
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] *= corr;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      if (j < nk) {
        const float e = expf(s[j] - m_new);
        l += e;
        if (keep(key, p.row, k0 + j, a.t, a.threshold)) {
          const float* vr = vs + j * cols + p.hl * HD;
#pragma unroll
          for (int d = 0; d < HD; ++d) acc[d] = fmaf(e, vr[d], acc[d]);
        }
      }
    }
    m = m_new;
  }

  if (p.active) {
    const float scale = a.inv_keep / l;
#pragma unroll
    for (int d = 0; d < HD; ++d) out_row[d] = acc[d] * scale;
    *st = make_float2(m, l);
  }
}

// backward, pass 1: dq and D per query row
template <int HD>
__global__ void __launch_bounds__(kThreads)
window_attention_train_dq_kernel(const float* __restrict__ packed, const float* __restrict__ bias,
                                 const int* __restrict__ nw, const int* __restrict__ seed,
                                 const float* __restrict__ out, const float* __restrict__ gout,
                                 const float2* __restrict__ stats, float* __restrict__ delta,
                                 float* __restrict__ dpacked, Args a) {
  extern __shared__ float smem[];
  const Place p = place(a, nw);
  const int col0 = p.h * HD;
  const size_t c3 = 3 * static_cast<size_t>(a.c);
  const float* win = packed + static_cast<size_t>(p.n) * a.t * c3;
  float* dq_row = dpacked + (static_cast<size_t>(p.n) * a.t + p.row) * c3 + col0;

  if (p.padding) {
    if (p.active) {
#pragma unroll
      for (int d = 0; d < HD; ++d) dq_row[d] = 0.f;
    }
    return;
  }

  const int cols = a.heads_per_block * HD;
  float* ks = smem;
  float* vs = ks + kTile * cols;
  float* bs = vs + kTile * cols;

  // this row's q, dO, O and softmax statistics
  float q[HD], g[HD], dq[HD];
  const int r = p.row;
  const size_t orow = (static_cast<size_t>(p.n) * a.t + r) * a.c + col0;
  const float* q_row = win + static_cast<size_t>(r) * c3 + col0;
  float dsum = 0.f;
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    q[d] = q_row[d];
    g[d] = gout[orow + d];
    dsum = fmaf(g[d], out[orow + d], dsum);
    dq[d] = 0.f;
  }
  const size_t srow = (static_cast<size_t>(p.n) * a.nhead + p.h) * a.t + r;
  const float2 ml = p.active ? stats[srow] : make_float2(0.f, 1.f);
  const float inv_l = 1.f / ml.y;
  if (p.active) delta[srow] = dsum;
  const uint32_t key = window_head_key(static_cast<uint32_t>(seed[0]), p.n, a.nhead, p.h);

  for (int k0 = 0; k0 < a.t; k0 += kTile) {
    const int nk = min(kTile, a.t - k0);
    __syncthreads();
    stage_rows<HD>(win, c3, k0, nk, a.c, 2 * a.c, p.h0, cols, ks, vs);
    for (int j = threadIdx.x; j < nk; j += kThreads)
      bs[j] = bias[static_cast<size_t>(p.n) * a.t + k0 + j];
    __syncthreads();
    if (!p.active) continue;

    float s[kTile];
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      if (j < nk) {
        const float* kr = ks + j * cols + p.hl * HD;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) dot = fmaf(q[d], kr[d], dot);
        s[j] = dot + bs[j];
      }
    }
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      if (j < nk) {
        const float pij = expf(s[j] - ml.x) * inv_l;
        float dp = 0.f;
        if (keep(key, p.row, k0 + j, a.t, a.threshold)) {
          const float* vr = vs + j * cols + p.hl * HD;
#pragma unroll
          for (int d = 0; d < HD; ++d) dp = fmaf(g[d], vr[d], dp);
          dp *= a.inv_keep;
        }
        const float ds = pij * (dp - dsum);
        const float* kr = ks + j * cols + p.hl * HD;
#pragma unroll
        for (int d = 0; d < HD; ++d) dq[d] = fmaf(ds, kr[d], dq[d]);
      }
    }
  }

  if (p.active) {
#pragma unroll
    for (int d = 0; d < HD; ++d) dq_row[d] = dq[d];
  }
}

// backward, pass 2: dk and dv per key row
template <int HD>
__global__ void __launch_bounds__(kThreads)
window_attention_train_dkdv_kernel(const float* __restrict__ packed, const float* __restrict__ bias,
                                   const int* __restrict__ nw, const int* __restrict__ seed,
                                   const float* __restrict__ gout, const float2* __restrict__ stats,
                                   const float* __restrict__ delta, float* __restrict__ dpacked,
                                   Args a) {
  extern __shared__ float smem[];
  const Place p = place(a, nw);              // p.row is this thread's key row
  const int col0 = p.h * HD;
  const size_t c3 = 3 * static_cast<size_t>(a.c);
  const float* win = packed + static_cast<size_t>(p.n) * a.t * c3;
  float* dk_row = dpacked + (static_cast<size_t>(p.n) * a.t + p.row) * c3 + a.c + col0;
  float* dv_row = dk_row + a.c;

  if (p.padding) {
    if (p.active) {
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        dk_row[d] = 0.f;
        dv_row[d] = 0.f;
      }
    }
    return;
  }

  const int cols = a.heads_per_block * HD;
  const int heads = a.heads_per_block;
  float* qs = smem;                          // [kTile][cols] q rows
  float* gs = qs + kTile * cols;             // [kTile][cols] dO rows
  float* ms = gs + kTile * cols;             // [kTile][heads] row max
  float* ls = ms + kTile * heads;            // [kTile][heads] 1 / row sum
  float* ds_ = ls + kTile * heads;           // [kTile][heads] D

  float k[HD], v[HD], dk[HD], dv[HD];
  const int r = p.row;
  const float* kv_row = win + static_cast<size_t>(r) * c3 + col0;
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    k[d] = kv_row[a.c + d];
    v[d] = kv_row[2 * a.c + d];
    dk[d] = 0.f;
    dv[d] = 0.f;
  }
  const float bj = bias[static_cast<size_t>(p.n) * a.t + r];
  const uint32_t key = window_head_key(static_cast<uint32_t>(seed[0]), p.n, a.nhead, p.h);

  for (int i0 = 0; i0 < a.t; i0 += kTile) {
    const int ni = min(kTile, a.t - i0);
    __syncthreads();
    for (int i = threadIdx.x; i < ni * cols; i += kThreads) {
      const int rr = i / cols, col = i % cols;
      const size_t row = static_cast<size_t>(p.n) * a.t + i0 + rr;
      qs[rr * cols + col] = packed[row * c3 + p.h0 * HD + col];
      gs[rr * cols + col] = gout[row * a.c + p.h0 * HD + col];
    }
    for (int i = threadIdx.x; i < ni * heads; i += kThreads) {
      const int rr = i / heads, hh = i % heads;
      const size_t srow = (static_cast<size_t>(p.n) * a.nhead + p.h0 + hh) * a.t + i0 + rr;
      const float2 ml = stats[srow];
      ms[rr * heads + hh] = ml.x;
      ls[rr * heads + hh] = 1.f / ml.y;
      ds_[rr * heads + hh] = delta[srow];
    }
    __syncthreads();
    if (!p.active) continue;

#pragma unroll 1
    for (int i = 0; i < ni; ++i) {
      const float* qr = qs + i * cols + p.hl * HD;
      const float* gr = gs + i * cols + p.hl * HD;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], k[d], dot);
      const float s = dot + bj;
      const float pij = expf(s - ms[i * heads + p.hl]) * ls[i * heads + p.hl];
      float dp = 0.f;
      if (keep(key, i0 + i, p.row, a.t, a.threshold)) {
        const float pz = pij * a.inv_keep;
#pragma unroll
        for (int d = 0; d < HD; ++d) {
          dv[d] = fmaf(pz, gr[d], dv[d]);
          dp = fmaf(gr[d], v[d], dp);
        }
        dp *= a.inv_keep;
      }
      const float ds = pij * (dp - ds_[i * heads + p.hl]);
#pragma unroll
      for (int d = 0; d < HD; ++d) dk[d] = fmaf(ds, qr[d], dk[d]);
    }
  }

  if (p.active) {
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      dk_row[d] = dk[d];
      dv_row[d] = dv[d];
    }
  }
}

Args make_args(int t, int c, int nhead, int wps, uint32_t threshold, float inv_keep,
               dim3* grid) {
  const Geometry g = geometry(t, nhead);
  *grid = dim3(0, nhead / g.heads, (t + g.rows - 1) / g.rows);
  return Args{t, c, nhead, g.heads, g.rows, wps, threshold, inv_keep};
}

template <int HD>
cudaError_t forward_f32(const float* packed, const float* bias, const int* nw, const int* seed,
                        float* out, float2* stats, int n, int t, int c, int nhead, int wps,
                        uint32_t threshold, float inv_keep, cudaStream_t stream) {
  dim3 grid;
  const Args a = make_args(t, c, nhead, wps, threshold, inv_keep, &grid);
  grid.x = n;
  const size_t smem = (2 * static_cast<size_t>(kTile) * a.heads_per_block * HD + kTile) * sizeof(float);
  auto kernel = window_attention_train_fwd_kernel<HD>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(packed, bias, nw, seed, out, stats, a);
  return cudaGetLastError();
}

template <int HD>
cudaError_t backward_f32(const float* packed, const float* bias, const int* nw, const int* seed,
                         const float* out, const float* gout, const float2* stats, float* delta,
                         float* dpacked, int n, int t, int c, int nhead, int wps,
                         uint32_t threshold, float inv_keep, cudaStream_t stream) {
  dim3 grid;
  const Args a = make_args(t, c, nhead, wps, threshold, inv_keep, &grid);
  grid.x = n;
  const size_t cols = static_cast<size_t>(a.heads_per_block) * HD;
  const size_t smem_dq = (2 * kTile * cols + kTile) * sizeof(float);
  const size_t smem_dkdv = (2 * kTile * cols + 3 * kTile * a.heads_per_block) * sizeof(float);
  auto dq_kernel = window_attention_train_dq_kernel<HD>;
  auto dkdv_kernel = window_attention_train_dkdv_kernel<HD>;
  cudaError_t err = set_smem(dq_kernel, smem_dq);
  if (err != cudaSuccess) return err;
  err = set_smem(dkdv_kernel, smem_dkdv);
  if (err != cudaSuccess) return err;
  dq_kernel<<<grid, kThreads, smem_dq, stream>>>(packed, bias, nw, seed, out, gout, stats, delta,
                                                 dpacked, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<<<grid, kThreads, smem_dkdv, stream>>>(packed, bias, nw, seed, gout, stats, delta,
                                                     dpacked, a);
  return cudaGetLastError();
}

// ===========================================================================
// bf16: tensor cores
// ===========================================================================
using wa_mma::bf16;
using wa_mma::Head;
using wa_mma::kRowPad;
using wa_mma::kMaxHeads;
using wa_mma::kRows;
using wa_mma::stream_tile;
using wa_mma::zero_rows;

struct MmaArgs {
  int t, c, nhead, wps;
  uint32_t threshold;
  float inv_keep;
};

// The dropout hash is mix32(mix32(i * T + j) ^ key(n, h)). Its inner half
// does not depend on the head, so a block computes it once for its 16 own
// rows and a tile of ST rows of the other side, ctr[own][streamed] (pitch
// ST + 8 words: the 64-bit loads of a half-warp hit distinct banks), and its
// warps (heads) share it. query_own: the own rows are the queries i.
template <int ST>
__device__ __forceinline__ void stage_hash(uint32_t* ctr, const MmaArgs& a, int own0, int str0,
                                           bool query_own) {
  if (a.threshold == 0u) return;
  for (int idx = threadIdx.x; idx < kRows * ST; idx += blockDim.x) {
    const int r = idx / ST, j = idx - r * ST;
    const int i = query_own ? own0 + r : str0 + j, k = query_own ? str0 + j : own0 + r;
    ctr[r * (ST + 8) + j] = mix32(static_cast<uint32_t>(i * a.t + k));
  }
}

// The shared inner halves of a thread's two elements (own row g + 8 r,
// streamed columns c0 and c0 + 1) of the tile; keep_hashed finishes keep().
__device__ __forceinline__ uint2 shared_hash(const uint32_t* ctr, int pitch, int r, int c0) {
  return *reinterpret_cast<const uint2*>(ctr + (wa_mma::lane_g() + 8 * r) * pitch + c0);
}

__device__ __forceinline__ bool keep_hashed(uint32_t inner, uint32_t key, uint32_t threshold) {
  return threshold == 0u || mix32(inner ^ key) >= threshold;
}

// Stage one tile of key rows [k0, k0 + KT) for the dq pass: their k|v
// columns and biases (-inf past T) as one cp.async group, and the hash's
// inner half for the query rows [q0, q0 + 16).
template <int KT>
__device__ __forceinline__ void stage_keys(bf16* kvs, float* bs, uint32_t* ctr, const bf16* win,
                                           const float* bias_win, const MmaArgs& a, int k0,
                                           int q0) {
  wa_mma::stage_rows(kvs, 2 * a.c + kRowPad, win + a.c, 3 * static_cast<size_t>(a.c), k0, KT,
                     a.t, 2 * a.c);
  for (int j = threadIdx.x; j < KT; j += blockDim.x)
    bs[j] = k0 + j < a.t ? bias_win[k0 + j] : -INFINITY;
  stage_hash<KT>(ctr, a, q0, k0, true);
  wa_mma::cp_async_commit();
}

// attend_rows' hook for the train forward: per key tile the hash's inner
// half for the block's 16 query rows (cts, [2][kRows][KT + 8]); per chunk
// the keep decision and 1/(1-p) on each weight before it is rounded to bf16.
template <int KT>
struct DropoutWeights {
  uint32_t* cts;
  MmaArgs a;
  int r0;
  uint32_t key;   // window_head_key of the warp's head

  __device__ __forceinline__ void stage(int buf, int k0) {
    stage_hash<KT>(cts + buf * kRows * (KT + 8), a, r0, k0, true);
  }

  __device__ __forceinline__ void apply(int buf, int kc, float (&s)[2][4]) {
    const uint32_t* ct = cts + buf * kRows * (KT + 8);
    const int t = wa_mma::lane_t();
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint2 inner = shared_hash(ct, KT + 8, r, kc + 8 * nt + 2 * t);
        s[nt][2 * r] = keep_hashed(inner.x, key, a.threshold) ? s[nt][2 * r] * a.inv_keep : 0.f;
        s[nt][2 * r + 1] =
            keep_hashed(inner.y, key, a.threshold) ? s[nt][2 * r + 1] * a.inv_keep : 0.f;
      }
  }
};

// forward: O and (m, l) for 16 query rows, all heads (the eval kernel's
// body, wa_mma::attend_rows, with dropout and the statistics)
template <int HD>
__global__ void __launch_bounds__(32 * kMaxHeads)
window_attention_train_fwd_mma_kernel(const bf16* __restrict__ packed,
                                      const float* __restrict__ bias, const int* __restrict__ nw,
                                      const int* __restrict__ seed, bf16* __restrict__ out,
                                      float2* __restrict__ stats, MmaArgs a) {
  constexpr int KT = stream_tile<HD>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = blockIdx.x, r0 = kRows * blockIdx.y, h = threadIdx.x >> 5;
  const int g = wa_mma::lane_g(), t = wa_mma::lane_t();
  const int c = a.c;
  const size_t c3 = 3 * static_cast<size_t>(c);
  const bf16* win = packed + static_cast<size_t>(n) * a.t * c3;
  bf16* out_win = out + static_cast<size_t>(n) * a.t * c;
  float2* st = stats + (static_cast<size_t>(n) * a.nhead + h) * a.t;

  if (padding_window(n, a.wps, nw)) {
    zero_rows(out_win, c, r0, a.t, 0, c);
    const int row = r0 + g + 8 * (t & 1);
    if (t < 2 && row < a.t) st[row] = make_float2(0.f, 1.f);
    return;
  }

  DropoutWeights<KT> weights{
      reinterpret_cast<uint32_t*>(smem_raw + wa_mma::attend_smem<HD>(c)), a, r0,
      window_head_key(static_cast<uint32_t>(seed[0]), n, a.nhead, h)};
  wa_mma::RowSoftmax sm;
  float l[2];
  wa_mma::attend_rows<HD>(win, win + c, win + 2 * c, c3, bias + static_cast<size_t>(n) * a.t,
                          a.t, r0, c, out_win, c, smem_raw, weights, sm, l);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + g + 8 * r;
      if (row < a.t) st[row] = make_float2(sm.m[r], l[r]);
    }
  }
}

// backward, pass 1: dq and D for 16 query rows, all heads
template <int HD>
__global__ void __launch_bounds__(32 * kMaxHeads)
window_attention_train_dq_mma_kernel(const bf16* __restrict__ packed,
                                     const float* __restrict__ bias, const int* __restrict__ nw,
                                     const int* __restrict__ seed, const bf16* __restrict__ out,
                                     const bf16* __restrict__ gout,
                                     const float2* __restrict__ stats, float* __restrict__ delta,
                                     bf16* __restrict__ dpacked, MmaArgs a) {
  using H = Head<HD>;
  constexpr int KT = stream_tile<HD>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = blockIdx.x, r0 = kRows * blockIdx.y, h = threadIdx.x >> 5;
  const int g = wa_mma::lane_g(), t = wa_mma::lane_t();
  const int c = a.c;
  const size_t c3 = 3 * static_cast<size_t>(c);
  const bf16* win = packed + static_cast<size_t>(n) * a.t * c3;
  bf16* dwin = dpacked + static_cast<size_t>(n) * a.t * c3;

  if (padding_window(n, a.wps, nw)) {
    zero_rows(dwin, c3, r0, a.t, 0, c);
    return;
  }

  const int qp = c + kRowPad, kvp = 2 * c + kRowPad;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);                     // [kRows][qp] q
  bf16* gs = qs + kRows * qp;                                   // [kRows][qp] dO
  bf16* os = gs + kRows * qp;                                   // [kRows][qp] O
  bf16* kvs = os + kRows * qp;                                  // [2][KT][kvp]
  float* bs = reinterpret_cast<float*>(kvs + 2 * KT * kvp);     // [2][KT]
  constexpr int cp = KT + 8;
  uint32_t* cts = reinterpret_cast<uint32_t*>(bs + 2 * KT);     // [2][kRows][cp]
  const float* bias_win = bias + static_cast<size_t>(n) * a.t;
  const size_t orow0 = static_cast<size_t>(n) * a.t * c;

  wa_mma::stage_rows(qs, qp, win, c3, r0, kRows, a.t, c);
  wa_mma::stage_rows(gs, qp, gout + orow0, c, r0, kRows, a.t, c);
  wa_mma::stage_rows(os, qp, out + orow0, c, r0, kRows, a.t, c);
  stage_keys<KT>(kvs, bs, cts, win, bias_win, a, 0, r0);

  // this thread's rows: softmax statistics (rows past T: P = 0)
  const size_t srow0 = (static_cast<size_t>(n) * a.nhead + h) * a.t;
  float m[2], il[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    const float2 ml = row < a.t ? stats[srow0 + row] : make_float2(INFINITY, 1.f);
    m[r] = ml.x;
    il[r] = row < a.t ? 1.f / ml.y : 0.f;
  }
  const int ntiles = (a.t + KT - 1) / KT;
  const uint32_t key = window_head_key(static_cast<uint32_t>(seed[0]), n, a.nhead, h);
  uint32_t qa[H::kA], ga[H::kA];
  float dq[H::kN8][4] = {};

  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < ntiles) {
      stage_keys<KT>(kvs + (buf ^ 1) * KT * kvp, bs + (buf ^ 1) * KT,
                     cts + (buf ^ 1) * kRows * cp, win, bias_win, a, (it + 1) * KT, r0);
      wa_mma::cp_async_wait<1>();
    } else {
      wa_mma::cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
      wa_mma::load_a<HD>(qa, qs, qp, h * HD);
      wa_mma::load_a<HD>(ga, gs, qp, h * HD);
      uint32_t oa[H::kA];
      wa_mma::load_a<HD>(oa, os, qp, h * HD);
      wa_mma::row_dots<HD>(dd, ga, oa);                         // D = dO . O
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + g + 8 * r;
        if (t == 0 && row < a.t) delta[srow0 + row] = dd[r];
      }
    }
    const bf16* kt = kvs + buf * KT * kvp;
    const float* bt = bs + buf * KT;
    const uint32_t* ct = cts + buf * kRows * cp;
    const int k0 = it * KT;
#pragma unroll
    for (int kc = 0; kc < KT; kc += 16) {
      if (k0 + kc >= a.t) break;
      float s[2][4], dp[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const bf16* rows = kt + (kc + 8 * nt) * kvp;
        uint32_t b[H::kB];
        wa_mma::load_b_t<HD>(b, rows, kvp, h * HD);
        wa_mma::mma_head<HD>(s[nt], qa, b);                       // S = Q K^T
        wa_mma::load_b_t<HD>(b, rows, kvp, c + h * HD);
        wa_mma::mma_head<HD>(dp[nt], ga, b);                      // dP = dO V^T
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint2 inner = shared_hash(ct, cp, r, kc + 8 * nt + 2 * t);
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int e = 2 * r + x, kj = kc + 8 * nt + 2 * t + x;
            const float p = wa_mma::softmax_weight(s[nt][e] + bt[kj], m[r], il[r]);
            const float dpz = keep_hashed(x ? inner.y : inner.x, key, a.threshold)
                                  ? dp[nt][e] * a.inv_keep : 0.f;
            s[nt][e] = p * (dpz - dd[r]);                         // dS
          }
        }
      uint32_t da[4];
      wa_mma::c_to_a(da, s[0], s[1]);
      wa_mma::mma_rows<HD>(dq, da, kt + kc * kvp, kvp, h * HD);   // dq += dS K
    }
    __syncthreads();
  }

  const float one[2] = {1.f, 1.f};
  wa_mma::store_rows<HD>(dwin + h * HD, c3, r0, a.t, dq, one);
}

// backward, pass 2: dk and dv for 16 key rows, all heads
template <int HD>
__global__ void __launch_bounds__(32 * kMaxHeads)
window_attention_train_dkdv_mma_kernel(const bf16* __restrict__ packed,
                                       const float* __restrict__ bias,
                                       const int* __restrict__ nw, const int* __restrict__ seed,
                                       const bf16* __restrict__ gout,
                                       const float2* __restrict__ stats,
                                       const float* __restrict__ delta,
                                       bf16* __restrict__ dpacked, MmaArgs a) {
  using H = Head<HD>;
  constexpr int QT = stream_tile<HD>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = blockIdx.x, j0 = kRows * blockIdx.y, h = threadIdx.x >> 5;
  const int g = wa_mma::lane_g(), t = wa_mma::lane_t();
  const int c = a.c, nh = a.nhead;
  const size_t c3 = 3 * static_cast<size_t>(c);
  const bf16* win = packed + static_cast<size_t>(n) * a.t * c3;
  bf16* dwin = dpacked + static_cast<size_t>(n) * a.t * c3;

  if (padding_window(n, a.wps, nw)) {
    zero_rows(dwin, c3, j0, a.t, c, 2 * c);
    return;
  }

  const int qp = c + kRowPad, kvp = 2 * c + kRowPad;
  bf16* kvs = reinterpret_cast<bf16*>(smem_raw);                    // [kRows][kvp] k|v
  bf16* qts = kvs + kRows * kvp;                                // [2][QT][qp] q
  bf16* gts = qts + 2 * QT * qp;                                // [2][QT][qp] dO
  float* sts = reinterpret_cast<float*>(gts + 2 * QT * qp);     // [2][3][nh][QT]
  constexpr int cp = QT + 8;
  uint32_t* cts = reinterpret_cast<uint32_t*>(sts + 2 * 3 * nh * QT);   // [2][kRows][cp]
  const bf16* gwin = gout + static_cast<size_t>(n) * a.t * c;
  const size_t srow0 = static_cast<size_t>(n) * nh * a.t;

  // one tile of query rows [i0, i0 + QT): q, dO, and per head m, 1 / l and D
  // (rows past T: m = +inf, so P = 0)
  auto stage_queries = [&](int buf, int i0) {
    wa_mma::stage_rows(qts + buf * QT * qp, qp, win, c3, i0, QT, a.t, c);
    wa_mma::stage_rows(gts + buf * QT * qp, qp, gwin, c, i0, QT, a.t, c);
    float* s = sts + buf * 3 * nh * QT;
    for (int idx = threadIdx.x; idx < nh * QT; idx += blockDim.x) {
      const int hh = idx / QT, q = idx - hh * QT, i = i0 + q;
      const size_t srow = srow0 + static_cast<size_t>(hh) * a.t + i;
      const float2 ml = i < a.t ? stats[srow] : make_float2(INFINITY, 1.f);
      s[idx] = ml.x;
      s[nh * QT + idx] = i < a.t ? 1.f / ml.y : 0.f;
      s[2 * nh * QT + idx] = i < a.t ? delta[srow] : 0.f;
    }
    stage_hash<QT>(cts + buf * kRows * cp, a, j0, i0, false);
    wa_mma::cp_async_commit();
  };

  wa_mma::stage_rows(kvs, kvp, win + c, c3, j0, kRows, a.t, 2 * c);
  stage_queries(0, 0);
  float bj[2];                                    // this thread's key rows' bias
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = j0 + g + 8 * r;
    bj[r] = j < a.t ? bias[static_cast<size_t>(n) * a.t + j] : -INFINITY;
  }
  const int ntiles = (a.t + QT - 1) / QT;
  const uint32_t key = window_head_key(static_cast<uint32_t>(seed[0]), n, nh, h);
  uint32_t ka[H::kA], va[H::kA];
  float dk[H::kN8][4] = {}, dv[H::kN8][4] = {};

  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < ntiles) {
      stage_queries(buf ^ 1, (it + 1) * QT);
      wa_mma::cp_async_wait<1>();
    } else {
      wa_mma::cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
      wa_mma::load_a<HD>(ka, kvs, kvp, h * HD);
      wa_mma::load_a<HD>(va, kvs, kvp, c + h * HD);
    }
    const bf16* qt = qts + buf * QT * qp;
    const bf16* gt = gts + buf * QT * qp;
    const float* mt = sts + buf * 3 * nh * QT + h * QT;
    const float* ilt = mt + nh * QT;
    const float* dt = ilt + nh * QT;
    const uint32_t* ct = cts + buf * kRows * cp;
    const int i0 = it * QT;
#pragma unroll
    for (int qc = 0; qc < QT; qc += 16) {
      if (i0 + qc >= a.t) break;
      float s[2][4], dp[2][4], pz[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        uint32_t b[H::kB];
        wa_mma::load_b_t<HD>(b, qt + (qc + 8 * nt) * qp, qp, h * HD);
        wa_mma::mma_head<HD>(s[nt], ka, b);                       // S^T = K Q^T
        wa_mma::load_b_t<HD>(b, gt + (qc + 8 * nt) * qp, qp, h * HD);
        wa_mma::mma_head<HD>(dp[nt], va, b);                      // dP^T = V dO^T
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint2 inner = shared_hash(ct, cp, r, qc + 8 * nt + 2 * t);
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int e = 2 * r + x, q = qc + 8 * nt + 2 * t + x;
            const float p = wa_mma::softmax_weight(s[nt][e] + bj[r], mt[q], ilt[q]);
            const bool z = keep_hashed(x ? inner.y : inner.x, key, a.threshold);
            pz[nt][e] = z ? p * a.inv_keep : 0.f;
            s[nt][e] = p * ((z ? dp[nt][e] * a.inv_keep : 0.f) - dt[q]);   // dS^T
          }
        }
      uint32_t pa[4], da[4];
      wa_mma::c_to_a(pa, pz[0], pz[1]);
      wa_mma::c_to_a(da, s[0], s[1]);
      wa_mma::mma_rows<HD>(dv, pa, gt + qc * qp, qp, h * HD);   // dv += (P Z)^T dO
      wa_mma::mma_rows<HD>(dk, da, qt + qc * qp, qp, h * HD);   // dk += dS^T Q
    }
    __syncthreads();
  }

  const float one[2] = {1.f, 1.f};
  wa_mma::store_rows<HD>(dwin + c + h * HD, c3, j0, a.t, dk, one);
  wa_mma::store_rows<HD>(dwin + 2 * c + h * HD, c3, j0, a.t, dv, one);
}

// two tiles of the hash's inner half, kRows x (ST + 8) words each
template <int HD>
constexpr size_t hash_smem() { return 2 * kRows * (stream_tile<HD>() + 8) * sizeof(uint32_t); }

template <int HD>
size_t fwd_mma_smem(int c) {
  return wa_mma::attend_smem<HD>(c) + hash_smem<HD>();
}

template <int HD>
size_t dq_mma_smem(int c) {
  return (3 * static_cast<size_t>(kRows) * (c + kRowPad) +
          2 * static_cast<size_t>(stream_tile<HD>()) * (2 * c + kRowPad)) * sizeof(bf16) +
         2 * stream_tile<HD>() * sizeof(float) + hash_smem<HD>();
}

template <int HD>
size_t dkdv_mma_smem(int c, int nhead) {
  return (static_cast<size_t>(kRows) * (2 * c + kRowPad) +
          4 * static_cast<size_t>(stream_tile<HD>()) * (c + kRowPad)) * sizeof(bf16) +
         6 * static_cast<size_t>(nhead) * stream_tile<HD>() * sizeof(float) + hash_smem<HD>();
}

template <int HD>
cudaError_t forward_mma(const bf16* packed, const float* bias, const int* nw, const int* seed,
                        bf16* out, float2* stats, int n, int t, int c, int nhead, int wps,
                        uint32_t threshold, float inv_keep, cudaStream_t stream) {
  const MmaArgs a{t, c, nhead, wps, threshold, inv_keep};
  const dim3 grid(n, (t + kRows - 1) / kRows);
  const size_t smem = fwd_mma_smem<HD>(c);
  auto kernel = window_attention_train_fwd_mma_kernel<HD>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, 32 * nhead, smem, stream>>>(packed, bias, nw, seed, out, stats, a);
  return cudaGetLastError();
}

template <int HD>
cudaError_t backward_mma(const bf16* packed, const float* bias, const int* nw, const int* seed,
                         const bf16* out, const bf16* gout, const float2* stats, float* delta,
                         bf16* dpacked, int n, int t, int c, int nhead, int wps,
                         uint32_t threshold, float inv_keep, cudaStream_t stream) {
  const MmaArgs a{t, c, nhead, wps, threshold, inv_keep};
  const dim3 grid(n, (t + kRows - 1) / kRows);
  const size_t smem_dq = dq_mma_smem<HD>(c), smem_dkdv = dkdv_mma_smem<HD>(c, nhead);
  auto dq_kernel = window_attention_train_dq_mma_kernel<HD>;
  auto dkdv_kernel = window_attention_train_dkdv_mma_kernel<HD>;
  cudaError_t err = set_smem(dq_kernel, smem_dq);
  if (err != cudaSuccess) return err;
  err = set_smem(dkdv_kernel, smem_dkdv);
  if (err != cudaSuccess) return err;
  dq_kernel<<<grid, 32 * nhead, smem_dq, stream>>>(packed, bias, nw, seed, out, gout, stats,
                                                   delta, dpacked, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<<<grid, 32 * nhead, smem_dkdv, stream>>>(packed, bias, nw, seed, gout, stats,
                                                       delta, dpacked, a);
  return cudaGetLastError();
}

bool valid_shape(int n, int t, int c, int nhead, int wps, int dtype) {
  // bf16 stages 16-byte pieces of C-column rows and runs one warp per head
  const bool mma_ok = c % 8 == 0 && nhead <= kMaxHeads;
  return n > 0 && t > 0 && nhead > 0 && c % nhead == 0 && wps > 0 &&
         (dtype == 0 || (dtype == 1 && mma_ok));
}

}  // namespace

extern "C" {

// packed [n, t, 3c] (dtype 0 = float32, 1 = bfloat16), bias [n, t] float32,
// nw [n / windows_per_sample] int32, seed [1] int32; out [n, t, c] of
// packed's dtype, stats [n, nhead, t] float2 (max logit, sum of exp).
// head_dim c / nhead must be 6, 12, 24 or 48; bfloat16 also needs c % 8 == 0,
// nhead <= 8 and 16-byte aligned packed and out. The caller checks shapes.
int window_attention_train_forward(const void* packed, const void* bias, const void* nw,
                                   const void* seed, void* out, void* stats, int n, int t,
                                   int c, int nhead, int windows_per_sample,
                                   unsigned threshold, float inv_keep, int dtype,
                                   void* stream) {
  if (!valid_shape(n, t, c, nhead, windows_per_sample, dtype)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const int* w = static_cast<const int*>(nw);
  const int* sd = static_cast<const int*>(seed);
  float2* st = static_cast<float2*>(stats);
#define FWD(fn, T, HD) fn<HD>(static_cast<const T*>(packed), b, w, sd, static_cast<T*>(out), st, \
                              n, t, c, nhead, windows_per_sample, threshold, inv_keep, s)
#define BY_HEAD_DIM(fn, T)                                      \
  switch (c / nhead) {                                          \
    case 6: return static_cast<int>(FWD(fn, T, 6));             \
    case 12: return static_cast<int>(FWD(fn, T, 12));           \
    case 24: return static_cast<int>(FWD(fn, T, 24));           \
    case 48: return static_cast<int>(FWD(fn, T, 48));           \
    default: return static_cast<int>(cudaErrorInvalidValue);    \
  }
  if (dtype == 0) { BY_HEAD_DIM(forward_f32, float) }
  BY_HEAD_DIM(forward_mma, bf16)
#undef BY_HEAD_DIM
#undef FWD
}

// out, gout [n, t, c] and dpacked [n, t, 3c] of packed's dtype; stats as the
// forward wrote it; delta [n, nhead, t] float32 scratch. bfloat16 also needs
// 16-byte aligned packed, out, gout and dpacked.
int window_attention_train_backward(const void* packed, const void* bias, const void* nw,
                                    const void* seed, const void* out, const void* gout,
                                    const void* stats, void* delta, void* dpacked, int n,
                                    int t, int c, int nhead, int windows_per_sample,
                                    unsigned threshold, float inv_keep, int dtype,
                                    void* stream) {
  if (!valid_shape(n, t, c, nhead, windows_per_sample, dtype)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const int* w = static_cast<const int*>(nw);
  const int* sd = static_cast<const int*>(seed);
  const float2* st = static_cast<const float2*>(stats);
  float* dl = static_cast<float*>(delta);
#define BWD(fn, T, HD) fn<HD>(static_cast<const T*>(packed), b, w, sd,                  \
                              static_cast<const T*>(out), static_cast<const T*>(gout), st, \
                              dl, static_cast<T*>(dpacked), n, t, c, nhead,              \
                              windows_per_sample, threshold, inv_keep, s)
#define BY_HEAD_DIM(fn, T)                                      \
  switch (c / nhead) {                                          \
    case 6: return static_cast<int>(BWD(fn, T, 6));             \
    case 12: return static_cast<int>(BWD(fn, T, 12));           \
    case 24: return static_cast<int>(BWD(fn, T, 24));           \
    case 48: return static_cast<int>(BWD(fn, T, 48));           \
    default: return static_cast<int>(cudaErrorInvalidValue);    \
  }
  if (dtype == 0) { BY_HEAD_DIM(backward_f32, float) }
  BY_HEAD_DIM(backward_mma, bf16)
#undef BY_HEAD_DIM
#undef BWD
}

const char* window_attention_train_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

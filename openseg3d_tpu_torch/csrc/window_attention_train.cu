// Packed window attention for training on Hopper (sm_90a): the forward with
// attention dropout, and its backward.
//
// Replaces the TPU kernels of the custom VJP window_attention_packed_train in
// openseg3d_tpu/ops/attention.py:
//   forward  _train_call -> _kernel_packed_train (B2f: B1 plus dropout on
//            the softmax weights, kept weights scaled by 1/(1-p));
//   backward _train_call -> _kernel_packed_bwd / _kernel_packed_bwd_body
//            (B2b: recomputes the softmax and regenerates the dropout mask,
//            then takes dq, dk and dv from each weight's P, dP and dS,
//            computed once; returns dq|dk|dv packed like the input).
// Semantics per window n and head h of packed q|k|v rows [N, T, 3C]:
//   P = softmax(q_h k_h^T + bias[n]),  Z = keep mask,  O = (P * Z / (1-p)) v_h.
// Windows whose rank within their sample is >= nw[sample] give zero output
// and zero gradients without being computed.
//
// Dropout mask. The keep decision of weight (n, h, i, j) is a pure function
// of (seed, n, h, i, j): bits = mix32(mix32(i*T + j) ^ mix32(mix32(seed) ^
// (n*H + h))), kept iff bits >= threshold (threshold = p * 2^32); the plain
// PyTorch version (ops/attention.py, dropout_keep_mask) computes the same
// bits with integer tensor arithmetic.
//
// Residual. The forward writes O and, per row and head, the softmax's max
// logit m and sum l (float2), from which the backward rebuilds
// P = exp(s - m) / l. (A single log-sum-exp would lose P for a fully padded
// window: its logits sit at -1e9, where the float32 spacing is 64.)
//
// bf16, the production dtype: tensor cores (window_attention_mma.cuh).
//   What bounds it on this card: per window and head the forward does
//   4 T^2 HD flops against T (8C + 4 + 64) bytes, the backward 10 T^2 HD
//   against ~2x the bytes: 100-160 flop/byte at T = 256, below the ridge of
//   the bf16 tensor cores (295) up to T ~ 590, so by its inputs the work is
//   bound by bytes; the stored keep bits add T^2 / 8 bytes a window and
//   head, written once and read once. What holds the PR 4 design far above
//   that bound (PERF.md) is what runs per softmax weight besides the
//   products (exp, and the dropout hash: two mix32, ~12 integer operations,
//   in all three of its kernels), the backward's second computation of
//   every weight, and 16-row blocks, which read a window's k|v rows from L2
//   T / 16 times. The design:
//   - the hash runs once: the forward hashes each weight (the inner
//     mix32(i*T + j), which no head changes, once per block and key tile in
//     shared memory, stage_hash, for the block's heads) and stores the keep
//     bits as its warps' ballots give them, 32 bytes a 16 x 16 tile
//     (bit_tile); the backward reads them and hashes nothing;
//   - forward blocks of 64 query rows (4 row tiles) and 2 heads where
//     ops/attention.py's table chooses them (head_dim 24 and 48), key tiles
//     of 32 rows: k|v leave L2 T/64 times (attend_rows with row_tiles). At
//     head_dim 6 and 12 the hash, shared by a block's heads, sets the time,
//     and the PR 4 block (16 rows, all 8 heads) stays;
//   - one backward pass (T <= 256; 128 at head_dim 6), as the TPU kernel
//     does: a block stages the window's q, k, v and dO rows of its heads
//     once, each warp owns key tiles and computes each weight's logit, P,
//     keep bit, dP and dS once, keeping dk and dv in registers, and dq is
//     summed over the warps in shared memory in a fixed order (no atomics,
//     the same bits every run);
//   - the two-pass backward (a dq pass over 16 query rows, then a dk/dv
//     pass over 16 key rows, each streaming the other side; no T x T
//     buffer) stays for the few-window levels (T = 512, 800) and wherever
//     ops/attention.py's table chooses it; it reads the stored bits too.
//   Per 16 x 16 tile a warp computes its logits with mma_head; in the
//   forward FlashAttention-2's online softmax runs on the accumulator
//   fragments, and keep() and 1/(1-p) are applied before the weights are
//   rounded to bf16 and become the A fragment of P V. In the one-pass
//   backward the logits come transposed, S^T = K Q^T and dP^T = V dO^T, as
//   in the two-pass dk/dv pass; dv += (P Z / (1-p))^T dO and dk += dS^T Q
//   take the bf16 C-to-A fragments, and dq += dS K takes dS^T's fragment
//   transposed in registers (movmatrix, wa_mma::transpose8).
//   Rounding as the TPU kernel's: P and dS are rounded to bf16 before their
//   products (attention.py:429, :626, :636); sums are float32;
//   D = dO . O, which equals the TPU kernel's rowsum(P dP).
//   Keys past T are excluded outright (logit -inf), not biased by -1e9: a
//   fully padded window keeps the uniform softmax over exactly its own T
//   keys.
//   Logits in the backward. The backward computes each logit with the same
//   fragment routine as the forward (mma_head: k16 steps, then a k8 step),
//   from the same bf16 operands in the same k-step order, transposed (K Q^T)
//   in the one-pass kernel and the dk/dv pass: the products of two bf16
//   values are exact in float32 and only the order of the tensor core's
//   float32 sum can differ, so the rebuilt logit is within a few float32 ulps
//   of |s| <~ 100 (the model's q is unit-norm times 1/tau <= 100 and k
//   unit-norm): an error ~1e-5 in the exponent, a relative 1e-5 in P, far
//   below the 2^-8 of P's own bf16 rounding.
// float32 keeps FMA bodies (tensor cores give no float32 that holds the
//   1e-5 gates; TF32 keeps ~3 digits): one thread per row of one head, the
//   other side streamed in 32-row tiles of float, several heads per block at
//   small T, all three kernels in the same operation order and hashing the
//   mask where they need it (nothing stored), so the backward rebuilds the
//   forward's P bit for bit. It serves the small float32 configurations and
//   the float32 references.
//
// Interface: plain C, loaded with ctypes; one entry point per direction,
// dispatching on the dtype; the block shapes come from the caller
// (ops/attention.py). Launches go on the caller's stream; the functions
// return cudaGetLastError() (0 = launched).

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

constexpr int kFwdThreads = 32 * kMaxHeads;   // a forward block's threads, at most
constexpr int kBwdThreads = 512;              // a one-pass backward block's, at most

struct MmaArgs {
  int t, c, nhead, wps;
  uint32_t threshold;
  float inv_keep;
};

// The keep bits, uint32 [N, nhead, TT, TT, 8] with TT = ceil(T / 16): per
// 16 x 16 tile of query rows 16 rt.. and keys 16 kt.., 8 words in the mma
// fragment layout, as the forward's warp ballots give them: bit 4 g + t of
// word (2 nt + r) * 2 + x is keep(query 16 rt + g + 8 r, key 16 kt + 8 nt +
// 2 t + x), and rows and keys past T are 0 (ops/attention.pack_keep_bits).
// A lane (g, t) of a transposed tile (keys as rows, S^T) finds keep(query
// 8 nt + 2 t + x, key g + 8 r) at bit 8 t + 4 x + (g >> 1) of word
// (2 r + nt) * 2 + (g & 1).
__host__ __device__ constexpr int bit_tiles(int t) { return (t + kRows - 1) / kRows; }

__device__ __forceinline__ size_t bit_tile(int n, int nhead, int h, int t, int rt, int kt) {
  const size_t tt = bit_tiles(t);
  return (((static_cast<size_t>(n) * nhead + h) * tt + rt) * tt + kt) * 8;
}

// The dropout hash is mix32(mix32(i * T + j) ^ key(n, h)). Its inner half
// does not depend on the head, so a forward block computes it once for its
// query rows [q0, q0 + rows) and a tile of ST keys from k0, ctr[row][key]
// (pitch ST + 8 words: the 64-bit loads of a half-warp hit distinct banks),
// and the warps of its heads share it.
template <int ST>
__device__ __forceinline__ void stage_hash(uint32_t* ctr, const MmaArgs& a, int q0, int rows,
                                           int k0) {
  if (a.threshold == 0u) return;
  for (int idx = threadIdx.x; idx < rows * ST; idx += blockDim.x) {
    const int r = idx / ST, j = idx - r * ST;
    ctr[r * (ST + 8) + j] = mix32(static_cast<uint32_t>((q0 + r) * a.t + k0 + j));
  }
}

// The shared inner halves of a thread's two elements (row g + 8 r of the
// tile at ctr, keys c0 and c0 + 1); keep_hashed finishes keep().
__device__ __forceinline__ uint2 shared_hash(const uint32_t* ctr, int pitch, int r, int c0) {
  return *reinterpret_cast<const uint2*>(ctr + (wa_mma::lane_g() + 8 * r) * pitch + c0);
}

__device__ __forceinline__ bool keep_hashed(uint32_t inner, uint32_t key, uint32_t threshold) {
  return threshold == 0u || mix32(inner ^ key) >= threshold;
}

// attend_rows' hook for the train forward: per key tile the hash's inner
// half for the block's query rows (cts, [2][rows][KT + 8]); per 16-key chunk
// the keep decision and 1/(1-p) on each weight before it is rounded to
// bf16, and the chunk's keep bits: 8 warp ballots, stored by lane 0.
template <int KT>
struct DropoutWeights {
  uint32_t* cts;
  MmaArgs a;
  int r0, rows;       // the block's first query row and its rows
  uint32_t key;       // window_head_key of the warp's head
  uint32_t* bits;     // the warp's head's keep-bit tiles (null at rate 0)

  __device__ __forceinline__ void stage(int buf, int k0) {
    stage_hash<KT>(cts + buf * rows * (KT + 8), a, r0, rows, k0);
  }

  __device__ __forceinline__ void apply(int buf, int rt, int k0, int kc, float (&s)[2][4]) {
    if (a.threshold == 0u) return;
    const uint32_t* ct = cts + (buf * rows + kRows * rt) * (KT + 8);
    const int t = wa_mma::lane_t(), row0 = r0 + kRows * rt, key0 = k0 + kc;
    const bool whole = row0 + kRows <= a.t && key0 + kRows <= a.t;   // no row or key past T
    uint32_t* dst = bits + (static_cast<size_t>(row0 >> 4) * bit_tiles(a.t) + (key0 >> 4)) * 8;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint2 inner = shared_hash(ct, KT + 8, r, kc + 8 * nt + 2 * t);
        uint32_t w[2];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const bool z = keep_hashed(x ? inner.y : inner.x, key, a.threshold);
          s[nt][2 * r + x] = z ? s[nt][2 * r + x] * a.inv_keep : 0.f;
          w[x] = __ballot_sync(0xffffffffu, z);
          if (!whole)   // the layout's padding: 0
            w[x] &= __ballot_sync(0xffffffffu, row0 + wa_mma::lane_g() + 8 * r < a.t &&
                                                   key0 + 8 * nt + 2 * t + x < a.t);
        }
        if ((threadIdx.x & 31) == 0)
          *reinterpret_cast<uint2*>(dst + (2 * nt + r) * 2) = make_uint2(w[0], w[1]);
      }
  }
};

// forward: O, (m, l) and the keep bits for the query rows [r0, r0 + 16
// row_tiles) of one window and the `heads` heads of head group blockIdx.z;
// warp w serves row tile w / heads of head w % heads (the eval kernel's
// body, wa_mma::attend_rows, with dropout and the statistics). KT: key rows
// per streamed tile.
template <int HD, int KT>
__global__ void __launch_bounds__(kFwdThreads, HD < 48 ? 3 : 2)
window_attention_train_fwd_mma_kernel(const bf16* __restrict__ packed,
                                      const float* __restrict__ bias, const int* __restrict__ nw,
                                      const int* __restrict__ seed, bf16* __restrict__ out,
                                      float2* __restrict__ stats, uint32_t* __restrict__ bits,
                                      MmaArgs a, int heads, int row_tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rows = kRows * row_tiles, n = blockIdx.x, r0 = rows * blockIdx.y;
  const int h0 = heads * blockIdx.z, warp = threadIdx.x >> 5;
  const int rt = warp / heads, h = h0 + warp - rt * heads;
  const int g = wa_mma::lane_g(), t = wa_mma::lane_t();
  const int c = a.c, cols = heads * HD;
  const size_t c3 = 3 * static_cast<size_t>(c);
  const bf16* win = packed + static_cast<size_t>(n) * a.t * c3 + h0 * HD;
  bf16* out_win = out + static_cast<size_t>(n) * a.t * c + h0 * HD;
  float2* st = stats + static_cast<size_t>(n) * a.nhead * a.t;

  if (padding_window(n, a.wps, nw)) {   // the whole block returns
    zero_rows(out_win, c, r0, rows, a.t, 0, cols);
    for (int idx = threadIdx.x; idx < heads * rows; idx += blockDim.x) {
      const int hh = idx / rows, row = r0 + idx - hh * rows;
      if (row < a.t) st[static_cast<size_t>(h0 + hh) * a.t + row] = make_float2(0.f, 1.f);
    }
    return;
  }

  DropoutWeights<KT> weights{
      reinterpret_cast<uint32_t*>(smem_raw + wa_mma::attend_smem<HD, KT>(cols, row_tiles)), a,
      r0, rows, window_head_key(static_cast<uint32_t>(seed[0]), n, a.nhead, h),
      bits == nullptr ? nullptr : bits + bit_tile(n, a.nhead, h, a.t, 0, 0)};
  wa_mma::RowSoftmax sm;
  float l[2];
  wa_mma::attend_rows<HD, KT>(win, win + c, win + 2 * c, c3, bias + static_cast<size_t>(n) * a.t,
                              a.t, r0, row_tiles, cols, out_win, c, smem_raw, weights, sm, l);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + kRows * rt + g + 8 * r;
      if (row < a.t) st[static_cast<size_t>(h) * a.t + row] = make_float2(sm.m[r], l[r]);
    }
  }
}

// Key tiles (16 keys each) a warp of the one-pass backward owns: their dk
// and dv accumulators stay in its registers for the whole window. (4 at
// head width 6, which T = 256 would need within 16 warps of 4 heads,
// spill at the 128 registers of 512 threads: ptxas, chip_smoke phase 2.)
template <int HD>
__host__ __device__ constexpr int key_tiles_per_warp() { return HD <= 12 ? 2 : 1; }

// backward in one pass (T <= 256): dq, dk and dv of one window and the
// `heads` heads of head group blockIdx.y. The block stages the window's q,
// k, v, dO and O rows of its heads (O where the dq sums go later), each
// row's m, 1/l and D = dO . O, the key biases and the keep bits. Warp w
// serves head w / wph and the key tiles w % wph + u wph (u <
// key_tiles_per_warp), its k and v fragments loaded once (or per query tile
// at head widths 6 and 48). For each 16-row query tile in turn, every warp
// computes, per own key tile, S^T = K Q^T and dP^T = V dO^T on the tensor
// cores, then P^T from (m, 1/l), the keep bit, dS^T = P^T (Z dP^T / (1-p)
// - D) once per weight, and
//   dv += (P Z / (1-p))^T dO,  dk += dS^T Q      (its registers),
//   dq_w = sum over its key tiles of dS K        (dS from dS^T: transpose8),
// stores dq_w in shared memory (two buffers, by query tile parity); after a
// barrier the block sums the warps' dq_w of each head (up to 4 lanes a value
// where threads are spare, each over every split-th warp, then a shuffle
// tree) and writes the tile's dq while the other warps go on to the next
// tile: a fixed order, no atomics. P and dS are rounded to bf16 before
// their products.
template <int HD>
__global__ void __launch_bounds__(kBwdThreads, 1)
window_attention_train_onepass_mma_kernel(const bf16* __restrict__ packed,
                                          const float* __restrict__ bias,
                                          const int* __restrict__ nw,
                                          const uint32_t* __restrict__ bits,
                                          const bf16* __restrict__ out,
                                          const bf16* __restrict__ gout,
                                          const float2* __restrict__ stats,
                                          bf16* __restrict__ dpacked, MmaArgs a, int heads,
                                          int wph) {
  using H = Head<HD>;
  constexpr int KPW = key_tiles_per_warp<HD>(), N8 = H::kN8;
  // k and v fragments held in registers, or (head widths 6 and 48, where
  // they would spill: ptxas, chip_smoke phase 2) reloaded per query tile
  constexpr bool kKeepKV = HD == 12 || HD == 24;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = blockIdx.x, h0 = heads * blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hl = warp / wph, kw = warp - hl * wph;
  const int g = wa_mma::lane_g(), t = wa_mma::lane_t();
  const int c = a.c, tt = a.t, cols = heads * HD, col = hl * HD;
  const size_t c3 = 3 * static_cast<size_t>(c);
  const bf16* win = packed + static_cast<size_t>(n) * tt * c3 + h0 * HD;
  const bf16* gwin = gout + static_cast<size_t>(n) * tt * c + h0 * HD;
  const bf16* owin = out + static_cast<size_t>(n) * tt * c + h0 * HD;
  bf16* dwin = dpacked + static_cast<size_t>(n) * tt * c3 + h0 * HD;

  if (padding_window(n, a.wps, nw)) {   // the whole block returns
    for (int part = 0; part < 3; ++part) zero_rows(dwin, c3, 0, tt, tt, part * c, cols);
    return;
  }

  const int tiles = (tt + kRows - 1) / kRows, rows = kRows * tiles, p = wa_mma::row_pitch(cols);
  const int nbits = a.threshold ? heads * tiles * tiles * 8 : 0;   // words
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);                  // [rows][p] q
  bf16* ks = qs + rows * p;                                      // k
  bf16* vs = ks + rows * p;                                      // v
  bf16* gs = vs + rows * p;                                      // dO
  float* ms = reinterpret_cast<float*>(gs + rows * p);           // [heads][rows] max logit
  float* ils = ms + heads * rows;                                // 1 / sum
  float* dds = ils + heads * rows;                               // D = dO . O
  float* bs = dds + heads * rows;                                // [rows] key bias
  uint32_t* bts = reinterpret_cast<uint32_t*>(bs + rows);        // [heads][TT][TT][8] keep bits
  float4* part = reinterpret_cast<float4*>(bts + nbits);         // [2][warps][N8][32] dq_w
  bf16* os = reinterpret_cast<bf16*>(part);                      // [rows][p] O, until D is taken

  wa_mma::stage_rows(qs, p, win, c3, 0, rows, tt, cols);
  wa_mma::stage_rows(ks, p, win + c, c3, 0, rows, tt, cols);
  wa_mma::stage_rows(vs, p, win + 2 * c, c3, 0, rows, tt, cols);
  wa_mma::stage_rows(gs, p, gwin, c, 0, rows, tt, cols);
  wa_mma::stage_rows(os, p, owin, c, 0, rows, tt, cols);
  if (a.threshold != 0u) {   // the heads' bit tiles lie side by side
    const uint32_t* src = bits + bit_tile(n, a.nhead, h0, tt, 0, 0);
    for (int idx = threadIdx.x; idx < nbits / 4; idx += blockDim.x)
      wa_mma::cp_async16(bts + 4 * idx, src + 4 * idx);
  }
  wa_mma::cp_async_commit();
  for (int j = threadIdx.x; j < rows; j += blockDim.x)
    bs[j] = j < tt ? bias[static_cast<size_t>(n) * tt + j] : -INFINITY;
  for (int idx = threadIdx.x; idx < heads * rows; idx += blockDim.x) {
    const int hh = idx / rows, i = idx - hh * rows;
    const float2 ml = i < tt ? stats[(static_cast<size_t>(n) * a.nhead + h0 + hh) * tt + i]
                             : make_float2(INFINITY, INFINITY);   // rows past T: P = 0
    ms[idx] = ml.x;
    ils[idx] = 1.f / ml.y;
  }
  wa_mma::cp_async_wait<0>();
  __syncthreads();
  for (int idx = threadIdx.x; idx < heads * rows; idx += blockDim.x) {   // D = dO . O
    const int hh = idx / rows, i = idx - hh * rows;
    const auto* o2 = reinterpret_cast<const __nv_bfloat162*>(os + i * p + hh * HD);
    const auto* g2 = reinterpret_cast<const __nv_bfloat162*>(gs + i * p + hh * HD);
    float d = 0.f;
#pragma unroll
    for (int e = 0; e < HD / 2; ++e) {
      const float2 x = __bfloat1622float2(o2[e]), y = __bfloat1622float2(g2[e]);
      d = fmaf(x.x, y.x, fmaf(x.y, y.y, d));
    }
    dds[idx] = d;
  }
  __syncthreads();

  const float* mh = ms + hl * rows;
  const float* ilh = ils + hl * rows;
  const float* dh = dds + hl * rows;
  const uint32_t* bh = bts + hl * tiles * tiles * 8;
  uint32_t ka[KPW][H::kA], va[KPW][H::kA];
  float dk[KPW][N8][4] = {}, dv[KPW][N8][4] = {};
  if constexpr (kKeepKV) {
#pragma unroll
    for (int u = 0; u < KPW; ++u) {
      const int kt = kw + u * wph;
      if (kt >= tiles) break;
      wa_mma::load_a<HD>(ka[u], ks + kt * kRows * p, p, col);
      wa_mma::load_a<HD>(va[u], vs + kt * kRows * p, p, col);
    }
  }

  // lanes a dq value is summed by: up to 4 where the block has threads to spare
  int split = 1;
  while (split < 4 && 2 * split <= wph && 2 * split * heads * N8 * 32 <= blockDim.x) split *= 2;
  for (int qt = 0; qt < tiles; ++qt) {
    const int q0 = qt * kRows;
    float dq[N8][4] = {};
#pragma unroll
    for (int u = 0; u < KPW; ++u) {
      const int kt = kw + u * wph;
      if (kt >= tiles) break;
      uint32_t kf[H::kA], vf[H::kA];
      if constexpr (kKeepKV) {
#pragma unroll
        for (int i = 0; i < H::kA; ++i) {
          kf[i] = ka[u][i];
          vf[i] = va[u][i];
        }
      } else {
        wa_mma::load_a<HD>(kf, ks + kt * kRows * p, p, col);
        wa_mma::load_a<HD>(vf, vs + kt * kRows * p, p, col);
      }
      float s[2][4], dp[2][4], pz[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        uint32_t b[H::kB];
        wa_mma::load_b_t<HD>(b, qs + (q0 + 8 * nt) * p, p, col);
        wa_mma::mma_head<HD>(s[nt], kf, b);                       // S^T = K Q^T
        wa_mma::load_b_t<HD>(b, gs + (q0 + 8 * nt) * p, p, col);
        wa_mma::mma_head<HD>(dp[nt], vf, b);                      // dP^T = V dO^T
      }
      const float bj[2] = {bs[kt * kRows + g], bs[kt * kRows + g + 8]};
      uint32_t zw[2][2];                              // [r][nt]: the tile's words
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          zw[r][nt] = a.threshold == 0u ? 0xffffffffu
                                        : bh[((qt * tiles + kt) * 2 + r) * 4 + nt * 2 + (g & 1)];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int q = q0 + 8 * nt + 2 * t + x;      // the thread's 4 query columns
          const float mq = mh[q], ilq = ilh[q], dr = dh[q];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int e = 2 * r + x;
            const float pw = wa_mma::softmax_weight(s[nt][e] + bj[r], mq, ilq);
            const bool z = (zw[r][nt] >> (8 * t + 4 * x + (g >> 1))) & 1u;
            pz[nt][e] = z ? pw * a.inv_keep : 0.f;
            s[nt][e] = pw * ((z ? dp[nt][e] * a.inv_keep : 0.f) - dr);   // dS^T
          }
        }
      uint32_t pa[4], da[4];
      wa_mma::c_to_a(pa, pz[0], pz[1]);
      wa_mma::c_to_a(da, s[0], s[1]);
      wa_mma::mma_rows<HD>(dv[u], pa, gs + q0 * p, p, col);      // dv += (P Z)^T dO
      wa_mma::mma_rows<HD>(dk[u], da, qs + q0 * p, p, col);      // dk += dS^T Q
      const uint32_t dsa[4] = {wa_mma::transpose8(da[0]), wa_mma::transpose8(da[2]),
                               wa_mma::transpose8(da[1]), wa_mma::transpose8(da[3])};
      wa_mma::mma_rows<HD>(dq, dsa, ks + kt * kRows * p, p, col);   // dq_w += dS K
    }
    // buffer qt & 1: a warp writes it again only after the next barrier,
    // which the threads summing it reach after their sums
    float4* buf = part + (qt & 1) * heads * wph * N8 * 32;
#pragma unroll
    for (int nt = 0; nt < N8; ++nt)
      buf[(warp * N8 + nt) * 32 + lane] = make_float4(dq[nt][0], dq[nt][1], dq[nt][2], dq[nt][3]);
    __syncthreads();
    // the tile's dq: per head, the sum of its warps' dq_w in a fixed order:
    // `split` lanes (8 apart) a value each sum every split-th warp, then a
    // shuffle tree joins them
    for (int idx = threadIdx.x; idx < heads * N8 * 32 * split; idx += blockDim.x) {
      const int j = (idx >> 3) % split, o = (idx >> 3) / split * 8 + (idx & 7);
      const int hh = o / (N8 * 32), rest = o - hh * N8 * 32, nt = rest >> 5, ln = rest & 31;
      const float4* src = buf + (hh * wph * N8 + nt) * 32 + ln;
      float4 acc = src[j * N8 * 32];
      for (int w = j + split; w < wph; w += split) {
        const float4 y = src[w * N8 * 32];
        acc.x += y.x;
        acc.y += y.y;
        acc.z += y.z;
        acc.w += y.w;
      }
      for (int m = 8; m < 8 * split; m <<= 1) {
        acc.x += __shfl_xor_sync(0xffffffffu, acc.x, m);
        acc.y += __shfl_xor_sync(0xffffffffu, acc.y, m);
        acc.z += __shfl_xor_sync(0xffffffffu, acc.z, m);
        acc.w += __shfl_xor_sync(0xffffffffu, acc.w, m);
      }
      const int d = 8 * nt + 2 * (ln & 3), row = q0 + (ln >> 2);
      if (j == 0 && d < HD) {
        bf16* dst = dwin + hh * HD + d;
        if (row < tt)
          *reinterpret_cast<__nv_bfloat162*>(dst + static_cast<size_t>(row) * c3) =
              __floats2bfloat162_rn(acc.x, acc.y);
        if (row + 8 < tt)
          *reinterpret_cast<__nv_bfloat162*>(dst + static_cast<size_t>(row + 8) * c3) =
              __floats2bfloat162_rn(acc.z, acc.w);
      }
    }
  }

  const float one[2] = {1.f, 1.f};
#pragma unroll
  for (int u = 0; u < KPW; ++u) {
    const int kt = kw + u * wph;
    if (kt >= tiles) break;
    wa_mma::store_rows<HD>(dwin + c + col, c3, kt * kRows, tt, dk[u], one);
    wa_mma::store_rows<HD>(dwin + 2 * c + col, c3, kt * kRows, tt, dv[u], one);
  }
}

// The two-pass backward (any T; taken at the few-window levels) reads each
// tile's keep bits straight from device memory.

// Stage one tile of key rows [k0, k0 + KT) for the dq pass: their k|v
// columns and biases (-inf past T) as one cp.async group.
template <int KT>
__device__ __forceinline__ void stage_keys(bf16* kvs, float* bs, const bf16* win,
                                           const float* bias_win, const MmaArgs& a, int k0) {
  wa_mma::stage_rows(kvs, 2 * a.c + kRowPad, win + a.c, 3 * static_cast<size_t>(a.c), k0, KT,
                     a.t, 2 * a.c);
  for (int j = threadIdx.x; j < KT; j += blockDim.x)
    bs[j] = k0 + j < a.t ? bias_win[k0 + j] : -INFINITY;
  wa_mma::cp_async_commit();
}

// backward, two passes, pass 1: dq and D for 16 query rows, all heads
template <int HD>
__global__ void __launch_bounds__(32 * kMaxHeads)
window_attention_train_dq_mma_kernel(const bf16* __restrict__ packed,
                                     const float* __restrict__ bias, const int* __restrict__ nw,
                                     const uint32_t* __restrict__ bits,
                                     const bf16* __restrict__ out, const bf16* __restrict__ gout,
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
    zero_rows(dwin, c3, r0, kRows, a.t, 0, c);
    return;
  }

  const int qp = c + kRowPad, kvp = 2 * c + kRowPad;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);                 // [kRows][qp] q
  bf16* gs = qs + kRows * qp;                                   // [kRows][qp] dO
  bf16* os = gs + kRows * qp;                                   // [kRows][qp] O
  bf16* kvs = os + kRows * qp;                                  // [2][KT][kvp]
  float* bs = reinterpret_cast<float*>(kvs + 2 * KT * kvp);     // [2][KT]
  const float* bias_win = bias + static_cast<size_t>(n) * a.t;
  const size_t orow0 = static_cast<size_t>(n) * a.t * c;

  wa_mma::stage_rows(qs, qp, win, c3, r0, kRows, a.t, c);
  wa_mma::stage_rows(gs, qp, gout + orow0, c, r0, kRows, a.t, c);
  wa_mma::stage_rows(os, qp, out + orow0, c, r0, kRows, a.t, c);
  stage_keys<KT>(kvs, bs, win, bias_win, a, 0);

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
  const size_t brow = bit_tile(n, a.nhead, h, a.t, blockIdx.y, 0);   // this row tile's bits
  const int ntiles = (a.t + KT - 1) / KT;
  uint32_t qa[H::kA], ga[H::kA];
  float dq[H::kN8][4] = {};

  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < ntiles) {
      stage_keys<KT>(kvs + (buf ^ 1) * KT * kvp, bs + (buf ^ 1) * KT, win, bias_win, a,
                     (it + 1) * KT);
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
      uint4 zw[2] = {make_uint4(~0u, ~0u, ~0u, ~0u), make_uint4(~0u, ~0u, ~0u, ~0u)};
      if (a.threshold != 0u) {
        const uint4* tile = reinterpret_cast<const uint4*>(bits + brow + ((k0 + kc) >> 4) * 8);
        zw[0] = __ldg(tile);
        zw[1] = __ldg(tile + 1);
      }
      const uint32_t zs[8] = {zw[0].x, zw[0].y, zw[0].z, zw[0].w,
                              zw[1].x, zw[1].y, zw[1].z, zw[1].w};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int e = 2 * r + x, j = 8 * nt + 2 * t + x;
            const float p = wa_mma::softmax_weight(s[nt][e] + bt[kc + j], m[r], il[r]);
            const float dpz = (zs[(2 * nt + r) * 2 + x] >> (4 * g + t)) & 1u
                                  ? dp[nt][e] * a.inv_keep : 0.f;
            s[nt][e] = p * (dpz - dd[r]);                         // dS
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

// backward, two passes, pass 2: dk and dv for 16 key rows, all heads
template <int HD>
__global__ void __launch_bounds__(32 * kMaxHeads)
window_attention_train_dkdv_mma_kernel(const bf16* __restrict__ packed,
                                       const float* __restrict__ bias,
                                       const int* __restrict__ nw,
                                       const uint32_t* __restrict__ bits,
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
    zero_rows(dwin, c3, j0, kRows, a.t, c, 2 * c);
    return;
  }

  const int qp = c + kRowPad, kvp = 2 * c + kRowPad;
  bf16* kvs = reinterpret_cast<bf16*>(smem_raw);                // [kRows][kvp] k|v
  bf16* qts = kvs + kRows * kvp;                                // [2][QT][qp] q
  bf16* gts = qts + 2 * QT * qp;                                // [2][QT][qp] dO
  float* sts = reinterpret_cast<float*>(gts + 2 * QT * qp);     // [2][3][nh][QT]
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
  const size_t bcol = bit_tile(n, nh, h, a.t, 0, blockIdx.y);   // this key tile's bits
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
      uint32_t zw[2][2];                              // [r][nt]: the tile's words
      const uint32_t* tile = bits + bcol + static_cast<size_t>((i0 + qc) >> 4) *
                                               bit_tiles(a.t) * 8;
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          zw[r][nt] = a.threshold == 0u ? 0xffffffffu : __ldg(tile + (2 * r + nt) * 2 + (g & 1));
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int q = qc + 8 * nt + 2 * t + x;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int e = 2 * r + x;
            const float p = wa_mma::softmax_weight(s[nt][e] + bj[r], mt[q], ilt[q]);
            const bool z = (zw[r][nt] >> (8 * t + 4 * x + (g >> 1))) & 1u;
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

template <int HD>
size_t dq_mma_smem(int c) {
  return (3 * static_cast<size_t>(kRows) * (c + kRowPad) +
          2 * static_cast<size_t>(stream_tile<HD>()) * (2 * c + kRowPad)) * sizeof(bf16) +
         2 * stream_tile<HD>() * sizeof(float);
}

template <int HD>
size_t dkdv_mma_smem(int c, int nhead) {
  return (static_cast<size_t>(kRows) * (2 * c + kRowPad) +
          4 * static_cast<size_t>(stream_tile<HD>()) * (c + kRowPad)) * sizeof(bf16) +
         6 * static_cast<size_t>(nhead) * stream_tile<HD>() * sizeof(float);
}

template <int HD>
size_t onepass_mma_smem(int t, int heads, int wph, bool with_bits) {
  const size_t rows = (t + kRows - 1) / kRows * kRows, cols = static_cast<size_t>(heads) * HD;
  const size_t nbits = with_bits ? static_cast<size_t>(heads) * bit_tiles(t) * bit_tiles(t) * 8 : 0;
  const size_t staged = rows * wa_mma::row_pitch(cols) * sizeof(bf16);   // one of q, k, v, dO, O
  const size_t sums = 2 * static_cast<size_t>(heads) * wph * Head<HD>::kN8 * 32 * sizeof(float4);
  return 4 * staged + (3 * heads + 1) * rows * sizeof(float) + nbits * sizeof(uint32_t) +
         (sums > staged ? sums : staged);
}

// The forward for a block of `heads` heads and `row_tiles` 16-row query
// tiles, streaming KT key rows a tile.
template <int HD, int KT>
cudaError_t forward_mma(const bf16* packed, const float* bias, const int* nw, const int* seed,
                        bf16* out, float2* stats, uint32_t* bits, int n, int t, int c, int nhead,
                        int wps, uint32_t threshold, float inv_keep, int heads, int row_tiles,
                        cudaStream_t stream) {
  const int threads = 32 * heads * row_tiles;
  if (heads < 1 || row_tiles < 1 || nhead % heads || (heads * HD) % 8 || threads > kFwdThreads ||
      (threshold != 0u && bits == nullptr))
    return cudaErrorInvalidValue;
  const MmaArgs a{t, c, nhead, wps, threshold, inv_keep};
  const size_t smem = wa_mma::attend_smem<HD, KT>(heads * HD, row_tiles) +
                      2 * static_cast<size_t>(kRows) * row_tiles * (KT + 8) * sizeof(uint32_t);
  auto kernel = window_attention_train_fwd_mma_kernel<HD, KT>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int rows = kRows * row_tiles;
  const dim3 grid(n, (t + rows - 1) / rows, nhead / heads);
  kernel<<<grid, threads, smem, stream>>>(packed, bias, nw, seed, out, stats, bits, a, heads,
                                          row_tiles);
  return cudaGetLastError();
}

// The backward: in one pass with blocks of `heads` heads and `wph` warps a
// head, or (heads == 0) in two passes.
template <int HD>
cudaError_t backward_mma(const bf16* packed, const float* bias, const int* nw,
                         const uint32_t* bits, const bf16* out, const bf16* gout,
                         const float2* stats, float* delta, bf16* dpacked, int n, int t, int c,
                         int nhead, int wps, uint32_t threshold, float inv_keep, int heads,
                         int wph, cudaStream_t stream) {
  if (threshold != 0u && bits == nullptr) return cudaErrorInvalidValue;
  const MmaArgs a{t, c, nhead, wps, threshold, inv_keep};
  if (heads > 0) {
    constexpr int KPW = key_tiles_per_warp<HD>();
    const int tiles = (t + kRows - 1) / kRows, threads = 32 * heads * wph;
    if (nhead % heads || (heads * HD) % 8 || threads > kBwdThreads ||
        wph != (tiles + KPW - 1) / KPW)
      return cudaErrorInvalidValue;
    const size_t smem = onepass_mma_smem<HD>(t, heads, wph, threshold != 0u);
    auto kernel = window_attention_train_onepass_mma_kernel<HD>;
    cudaError_t err = set_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(n, nhead / heads), threads, smem, stream>>>(packed, bias, nw, bits, out, gout,
                                                              stats, dpacked, a, heads, wph);
    return cudaGetLastError();
  }
  if (delta == nullptr) return cudaErrorInvalidValue;
  const dim3 grid(n, (t + kRows - 1) / kRows);
  const size_t smem_dq = dq_mma_smem<HD>(c), smem_dkdv = dkdv_mma_smem<HD>(c, nhead);
  auto dq_kernel = window_attention_train_dq_mma_kernel<HD>;
  auto dkdv_kernel = window_attention_train_dkdv_mma_kernel<HD>;
  cudaError_t err = set_smem(dq_kernel, smem_dq);
  if (err != cudaSuccess) return err;
  err = set_smem(dkdv_kernel, smem_dkdv);
  if (err != cudaSuccess) return err;
  dq_kernel<<<grid, 32 * nhead, smem_dq, stream>>>(packed, bias, nw, bits, out, gout, stats,
                                                   delta, dpacked, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<<<grid, 32 * nhead, smem_dkdv, stream>>>(packed, bias, nw, bits, gout, stats,
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
// bfloat16 only: bits [n, nhead, T', T', 8] uint32 (T' = ceil(t / 16)), the
// keep bits written for the live windows (null at threshold 0); a block
// serves `heads` heads (dividing nhead, heads x head_dim a multiple of 8) and
// `row_tiles` 16-row query tiles (32 x heads x row_tiles <= 256 threads),
// streaming `key_tile` key rows a tile: 64 at head_dim 6 and 12, 32 at 24,
// 16 or 32 at 48. float32 ignores them.
int window_attention_train_forward(const void* packed, const void* bias, const void* nw,
                                   const void* seed, void* out, void* stats, void* bits, int n,
                                   int t, int c, int nhead, int windows_per_sample,
                                   unsigned threshold, float inv_keep, int dtype, int heads,
                                   int row_tiles, int key_tile, void* stream) {
  if (!valid_shape(n, t, c, nhead, windows_per_sample, dtype)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const int* w = static_cast<const int*>(nw);
  const int* sd = static_cast<const int*>(seed);
  float2* st = static_cast<float2*>(stats);
  if (dtype == 0) {
#define FWD(HD) forward_f32<HD>(static_cast<const float*>(packed), b, w, sd,                    \
                                static_cast<float*>(out), st, n, t, c, nhead, windows_per_sample, \
                                threshold, inv_keep, s)
    switch (c / nhead) {
      case 6: return static_cast<int>(FWD(6));
      case 12: return static_cast<int>(FWD(12));
      case 24: return static_cast<int>(FWD(24));
      case 48: return static_cast<int>(FWD(48));
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef FWD
  }
#define FWD(HD, KT) forward_mma<HD, KT>(static_cast<const bf16*>(packed), b, w, sd,             \
                                        static_cast<bf16*>(out), st,                            \
                                        static_cast<uint32_t*>(bits), n, t, c, nhead,           \
                                        windows_per_sample, threshold, inv_keep, heads,         \
                                        row_tiles, s)
  const int hd = c / nhead;
  if (hd == 6 && key_tile == 64) return static_cast<int>(FWD(6, 64));
  if (hd == 12 && key_tile == 64) return static_cast<int>(FWD(12, 64));
  if (hd == 24 && key_tile == 32) return static_cast<int>(FWD(24, 32));
  if (hd == 48 && key_tile == 16) return static_cast<int>(FWD(48, 16));
  if (hd == 48 && key_tile == 32) return static_cast<int>(FWD(48, 32));
  return static_cast<int>(cudaErrorInvalidValue);
#undef FWD
}

// out, gout [n, t, c] and dpacked [n, t, 3c] of packed's dtype; stats as the
// forward wrote it. bfloat16 also needs 16-byte aligned packed, out, gout
// and dpacked. float32 hashes the dropout mask from seed and takes delta
// [n, nhead, t] float32 scratch. bfloat16 reads the forward's keep bits
// (null at threshold 0) and runs in one pass when heads > 0 (blocks of
// `heads` heads, warps_per_head = ceil(ceil(t / 16) / k) warps a head, k =
// 2, 2, 1, 1 key tiles a warp at head_dim 6, 12, 24, 48; 32 x heads x
// warps_per_head <= 512 threads), else in two (dq, then dk and dv; delta
// as for float32).
int window_attention_train_backward(const void* packed, const void* bias, const void* nw,
                                    const void* seed, const void* bits, const void* out,
                                    const void* gout, const void* stats, void* delta,
                                    void* dpacked, int n, int t, int c, int nhead,
                                    int windows_per_sample, unsigned threshold, float inv_keep,
                                    int dtype, int heads, int warps_per_head, void* stream) {
  if (!valid_shape(n, t, c, nhead, windows_per_sample, dtype)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const int* w = static_cast<const int*>(nw);
  const float2* st = static_cast<const float2*>(stats);
  float* dl = static_cast<float*>(delta);
#define BY_HEAD_DIM(CALL)                                       \
  switch (c / nhead) {                                          \
    case 6: return static_cast<int>(CALL(6));                   \
    case 12: return static_cast<int>(CALL(12));                 \
    case 24: return static_cast<int>(CALL(24));                 \
    case 48: return static_cast<int>(CALL(48));                 \
    default: return static_cast<int>(cudaErrorInvalidValue);    \
  }
#define BWD_F32(HD) backward_f32<HD>(static_cast<const float*>(packed), b, w,                     \
                                     static_cast<const int*>(seed),                               \
                                     static_cast<const float*>(out),                              \
                                     static_cast<const float*>(gout), st, dl,                     \
                                     static_cast<float*>(dpacked), n, t, c, nhead,                \
                                     windows_per_sample, threshold, inv_keep, s)
#define BWD_MMA(HD) backward_mma<HD>(static_cast<const bf16*>(packed), b, w,                      \
                                     static_cast<const uint32_t*>(bits),                          \
                                     static_cast<const bf16*>(out),                               \
                                     static_cast<const bf16*>(gout), st, dl,                      \
                                     static_cast<bf16*>(dpacked), n, t, c, nhead,                 \
                                     windows_per_sample, threshold, inv_keep, heads,              \
                                     warps_per_head, s)
  if (dtype == 0) { BY_HEAD_DIM(BWD_F32) }
  BY_HEAD_DIM(BWD_MMA)
#undef BWD_MMA
#undef BWD_F32
#undef BY_HEAD_DIM
}

const char* window_attention_train_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

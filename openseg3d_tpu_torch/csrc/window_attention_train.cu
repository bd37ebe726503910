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
//
// Design. As in window_attention.cu (B1): one thread owns one row of one
// head; k|v (forward, dq pass) or q|dO (dk/dv pass) stream through shared
// memory in tiles of kTile rows, so T = 800 needs no [T, T] buffer, and
// small windows pack several heads into one block (rows * heads <= 128).
//   forward: thread per query row; online softmax over key tiles; writes O
//            and, per row, the softmax's max logit m and sum l (float2), the
//            residual the backward needs to rebuild P = exp(s - m) / l. (A
//            single log-sum-exp would lose P for a fully padded window: its
//            logits sit at -1e9, where the float32 spacing is 64.)
//   dq pass: thread per query row; D_i = dO_i . O_i (equal to
//            sum_j P_ij dP_ij, dropout included); for each key,
//            ds_ij = P_ij (Z_ij dO_i.v_j / (1-p) - D_i), dq_i += ds_ij k_j;
//            writes dq and D.
//   dk/dv pass: thread per key row; for each query,
//            dv_j += P_ij Z_ij / (1-p) dO_i, dk_j += ds_ij q_i. No atomics:
//            each thread owns its key row's dk and dv.
// Logits are computed in the same operation order in all three kernels, so
// the backward rebuilds the forward's P bit for bit.
//
// What bounds it on this card: as B1, head_dim 6..48 is below the MMA K of
// 16, so float32 FMAs, no tensor cores; the backward does about 2.5x the
// forward's FLOPs. Tensor-core tiles (several heads per MMA) are later work.
//
// Interface: plain C, loaded with ctypes. Launches go on the caller's
// stream; the functions return cudaGetLastError() (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // rows (times heads) per block
constexpr int kTile = 32;      // rows staged in shared memory per step

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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
  p.padding = p.n % a.windows_per_sample >= nw[p.n / a.windows_per_sample];
  return p;
}

// Stage rows [r0, r0 + nr) of two column groups (offsets off0, off1 within
// the packed row, heads_per_block * HD columns each, starting at head h0)
// into shared memory as float.
template <typename T, int HD>
__device__ __forceinline__ void stage_rows(const T* win, size_t row_stride, int r0, int nr,
                                           int off0, int off1, int h0, int cols,
                                           float* s0, float* s1) {
  for (int i = threadIdx.x; i < nr * cols; i += kThreads) {
    const int j = i / cols, col = i % cols;
    const T* r = win + static_cast<size_t>(r0 + j) * row_stride + h0 * HD + col;
    s0[j * cols + col] = to_float(r[off0]);
    s1[j * cols + col] = to_float(r[off1]);
  }
}

// ---------------------------------------------------------------------------
// forward: O and (m, l) per query row
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
window_attention_train_fwd_kernel(const T* __restrict__ packed, const float* __restrict__ bias,
                                  const int* __restrict__ nw, const int* __restrict__ seed,
                                  T* __restrict__ out, float2* __restrict__ stats, Args a) {
  extern __shared__ float smem[];
  const Place p = place(a, nw);
  const int col0 = p.h * HD;
  const size_t c3 = 3 * static_cast<size_t>(a.c);
  const T* win = packed + static_cast<size_t>(p.n) * a.t * c3;
  T* out_row = out + (static_cast<size_t>(p.n) * a.t + p.row) * a.c + col0;
  float2* st = stats + (static_cast<size_t>(p.n) * a.nhead + p.h) * a.t + p.row;

  if (p.padding) {  // the whole block takes this branch
    if (p.active) {
#pragma unroll
      for (int d = 0; d < HD; ++d) out_row[d] = from_float<T>(0.f);
      *st = make_float2(0.f, 1.f);
    }
    return;
  }

  const int cols = a.heads_per_block * HD;
  float* ks = smem;                       // [kTile][cols]
  float* vs = ks + kTile * cols;          // [kTile][cols]
  float* bs = vs + kTile * cols;          // [kTile]

  float q[HD], acc[HD];
  const T* q_row = win + static_cast<size_t>(p.row) * c3 + col0;
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    q[d] = to_float(q_row[d]);
    acc[d] = 0.f;
  }
  const uint32_t key = window_head_key(static_cast<uint32_t>(seed[0]), p.n, a.nhead, p.h);
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < a.t; k0 += kTile) {
    const int nk = min(kTile, a.t - k0);
    __syncthreads();
    stage_rows<T, HD>(win, c3, k0, nk, a.c, 2 * a.c, p.h0, cols, ks, vs);
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
    for (int d = 0; d < HD; ++d) out_row[d] = from_float<T>(acc[d] * scale);
    *st = make_float2(m, l);
  }
}

// ---------------------------------------------------------------------------
// backward, pass 1: dq and D per query row
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
window_attention_train_dq_kernel(const T* __restrict__ packed, const float* __restrict__ bias,
                                 const int* __restrict__ nw, const int* __restrict__ seed,
                                 const T* __restrict__ out, const T* __restrict__ gout,
                                 const float2* __restrict__ stats, float* __restrict__ delta,
                                 T* __restrict__ dpacked, Args a) {
  extern __shared__ float smem[];
  const Place p = place(a, nw);
  const int col0 = p.h * HD;
  const size_t c3 = 3 * static_cast<size_t>(a.c);
  const T* win = packed + static_cast<size_t>(p.n) * a.t * c3;
  T* dq_row = dpacked + (static_cast<size_t>(p.n) * a.t + p.row) * c3 + col0;

  if (p.padding) {
    if (p.active) {
#pragma unroll
      for (int d = 0; d < HD; ++d) dq_row[d] = from_float<T>(0.f);
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
  const T* q_row = win + static_cast<size_t>(r) * c3 + col0;
  float dsum = 0.f;
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    q[d] = to_float(q_row[d]);
    g[d] = to_float(gout[orow + d]);
    dsum = fmaf(g[d], to_float(out[orow + d]), dsum);
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
    stage_rows<T, HD>(win, c3, k0, nk, a.c, 2 * a.c, p.h0, cols, ks, vs);
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
    for (int d = 0; d < HD; ++d) dq_row[d] = from_float<T>(dq[d]);
  }
}

// ---------------------------------------------------------------------------
// backward, pass 2: dk and dv per key row
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
window_attention_train_dkdv_kernel(const T* __restrict__ packed, const float* __restrict__ bias,
                                   const int* __restrict__ nw, const int* __restrict__ seed,
                                   const T* __restrict__ gout, const float2* __restrict__ stats,
                                   const float* __restrict__ delta, T* __restrict__ dpacked,
                                   Args a) {
  extern __shared__ float smem[];
  const Place p = place(a, nw);              // p.row is this thread's key row
  const int col0 = p.h * HD;
  const size_t c3 = 3 * static_cast<size_t>(a.c);
  const T* win = packed + static_cast<size_t>(p.n) * a.t * c3;
  T* dk_row = dpacked + (static_cast<size_t>(p.n) * a.t + p.row) * c3 + a.c + col0;
  T* dv_row = dk_row + a.c;

  if (p.padding) {
    if (p.active) {
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        dk_row[d] = from_float<T>(0.f);
        dv_row[d] = from_float<T>(0.f);
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
  const T* kv_row = win + static_cast<size_t>(r) * c3 + col0;
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    k[d] = to_float(kv_row[a.c + d]);
    v[d] = to_float(kv_row[2 * a.c + d]);
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
      qs[rr * cols + col] = to_float(packed[row * c3 + p.h0 * HD + col]);
      gs[rr * cols + col] = to_float(gout[row * a.c + p.h0 * HD + col]);
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
      dk_row[d] = from_float<T>(dk[d]);
      dv_row[d] = from_float<T>(dv[d]);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
  return cudaSuccess;
}

Args make_args(int t, int c, int nhead, int wps, uint32_t threshold, float inv_keep,
               dim3* grid) {
  const Geometry g = geometry(t, nhead);
  *grid = dim3(0, nhead / g.heads, (t + g.rows - 1) / g.rows);
  return Args{t, c, nhead, g.heads, g.rows, wps, threshold, inv_keep};
}

template <typename T, int HD>
cudaError_t forward(const void* packed, const float* bias, const int* nw, const int* seed,
                    void* out, void* stats, int n, int t, int c, int nhead, int wps,
                    uint32_t threshold, float inv_keep, cudaStream_t stream) {
  dim3 grid;
  const Args a = make_args(t, c, nhead, wps, threshold, inv_keep, &grid);
  grid.x = n;
  const size_t smem = (2 * static_cast<size_t>(kTile) * a.heads_per_block * HD + kTile) * sizeof(float);
  auto kernel = window_attention_train_fwd_kernel<T, HD>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(packed), bias, nw, seed,
                                           static_cast<T*>(out), static_cast<float2*>(stats), a);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t backward(const void* packed, const float* bias, const int* nw, const int* seed,
                     const void* out, const void* gout, const void* stats, float* delta,
                     void* dpacked, int n, int t, int c, int nhead, int wps,
                     uint32_t threshold, float inv_keep, cudaStream_t stream) {
  dim3 grid;
  const Args a = make_args(t, c, nhead, wps, threshold, inv_keep, &grid);
  grid.x = n;
  const size_t cols = static_cast<size_t>(a.heads_per_block) * HD;
  const size_t smem_dq = (2 * kTile * cols + kTile) * sizeof(float);
  const size_t smem_dkdv = (2 * kTile * cols + 3 * kTile * a.heads_per_block) * sizeof(float);
  auto dq_kernel = window_attention_train_dq_kernel<T, HD>;
  auto dkdv_kernel = window_attention_train_dkdv_kernel<T, HD>;
  cudaError_t err = set_smem(dq_kernel, smem_dq);
  if (err != cudaSuccess) return err;
  err = set_smem(dkdv_kernel, smem_dkdv);
  if (err != cudaSuccess) return err;
  const T* pk = static_cast<const T*>(packed);
  const T* go = static_cast<const T*>(gout);
  const float2* st = static_cast<const float2*>(stats);
  T* dp = static_cast<T*>(dpacked);
  dq_kernel<<<grid, kThreads, smem_dq, stream>>>(pk, bias, nw, seed, static_cast<const T*>(out),
                                                 go, st, delta, dp, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<<<grid, kThreads, smem_dkdv, stream>>>(pk, bias, nw, seed, go, st, delta, dp, a);
  return cudaGetLastError();
}

bool valid_shape(int n, int t, int c, int nhead, int wps) {
  return n > 0 && t > 0 && nhead > 0 && c % nhead == 0 && wps > 0;
}

}  // namespace

extern "C" {

// packed [n, t, 3c] (dtype 0 = float32, 1 = bfloat16), bias [n, t] float32,
// nw [n / windows_per_sample] int32, seed [1] int32; out [n, t, c] of
// packed's dtype, stats [n, nhead, t] float2 (max logit, sum of exp).
// head_dim c / nhead must be 6, 12, 24 or 48; the caller checks shapes.
int window_attention_train_forward(const void* packed, const void* bias, const void* nw,
                                   const void* seed, void* out, void* stats, int n, int t,
                                   int c, int nhead, int windows_per_sample,
                                   unsigned threshold, float inv_keep, int dtype,
                                   void* stream) {
  if (!valid_shape(n, t, c, nhead, windows_per_sample)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const int* w = static_cast<const int*>(nw);
  const int* sd = static_cast<const int*>(seed);
#define FWD(T, HD) forward<T, HD>(packed, b, w, sd, out, stats, n, t, c, nhead, \
                                  windows_per_sample, threshold, inv_keep, s)
#define BY_HEAD_DIM(T)                                          \
  switch (c / nhead) {                                          \
    case 6: return static_cast<int>(FWD(T, 6));                 \
    case 12: return static_cast<int>(FWD(T, 12));               \
    case 24: return static_cast<int>(FWD(T, 24));               \
    case 48: return static_cast<int>(FWD(T, 48));               \
    default: return static_cast<int>(cudaErrorInvalidValue);    \
  }
  if (dtype == 0) { BY_HEAD_DIM(float) }
  if (dtype == 1) { BY_HEAD_DIM(__nv_bfloat16) }
  return static_cast<int>(cudaErrorInvalidValue);
#undef BY_HEAD_DIM
#undef FWD
}

// out, gout [n, t, c] and dpacked [n, t, 3c] of packed's dtype; stats as the
// forward wrote it; delta [n, nhead, t] float32 scratch.
int window_attention_train_backward(const void* packed, const void* bias, const void* nw,
                                    const void* seed, const void* out, const void* gout,
                                    const void* stats, void* delta, void* dpacked, int n,
                                    int t, int c, int nhead, int windows_per_sample,
                                    unsigned threshold, float inv_keep, int dtype,
                                    void* stream) {
  if (!valid_shape(n, t, c, nhead, windows_per_sample)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const int* w = static_cast<const int*>(nw);
  const int* sd = static_cast<const int*>(seed);
  float* dl = static_cast<float*>(delta);
#define BWD(T, HD) backward<T, HD>(packed, b, w, sd, out, gout, stats, dl, dpacked, n, t, \
                                   c, nhead, windows_per_sample, threshold, inv_keep, s)
#define BY_HEAD_DIM(T)                                          \
  switch (c / nhead) {                                          \
    case 6: return static_cast<int>(BWD(T, 6));                 \
    case 12: return static_cast<int>(BWD(T, 12));               \
    case 24: return static_cast<int>(BWD(T, 24));               \
    case 48: return static_cast<int>(BWD(T, 48));               \
    default: return static_cast<int>(cudaErrorInvalidValue);    \
  }
  if (dtype == 0) { BY_HEAD_DIM(float) }
  if (dtype == 1) { BY_HEAD_DIM(__nv_bfloat16) }
  return static_cast<int>(cudaErrorInvalidValue);
#undef BY_HEAD_DIM
#undef BWD
}

const char* window_attention_train_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

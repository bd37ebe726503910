// Window attention for Hopper (sm_90a): the eval attention core of every
// SWFormer encoder layer (packed q|k|v), and the public unpacked op.
//
// One kernel body serves two TPU kernels of openseg3d_tpu/ops/attention.py:
//   * fused_window_attention_packed -> _kernel_packed (pallas_call at :317),
//     through window_attention_packed below: q, k and v are column blocks
//     0, C and 2C of one packed [N, T, 3C] array (row stride 3C), and
//     windows whose rank within their sample is >= nw[sample] are padding by
//     construction of the window partition and are written as zeros without
//     being computed;
//   * fused_window_attention -> _kernel (:181-220, pallas_call at :256),
//     through window_attention_unpacked below: q, k and v are three [N, T, C]
//     arrays (row stride C) and every window is computed (no nw).
// Same semantics as both: for each window n and head h,
//   out[n, :, h] = softmax(q_h k_h^T + bias[n]) v_h,
// computed in float32 from float32 or bfloat16 inputs, the output rounded
// once to the input dtype. bias is 0 for real tokens and -1e9 for padding.
// A fully padded window has every logit at -1e9 (float32 spacing there is 64,
// so the q.k terms vanish): a uniform softmax over the window's own T keys,
// the mean of its own v rows, as the einsum oracle reference_window_attention
// gives (zero in the model, whose padded rows are zero). The TPU kernel's
// grouped path differs there: its block-diagonal -1e9 spreads the softmax over
// all G windows of its group.
//
// Design. The TPU kernel masks lanes per head and pays nhead times the MXU
// work, because sub-128-lane slicing is costly there. Here each block takes
// its own (window, head group) slice straight from the rows: q at columns
// [h*hd, (h+1)*hd) of the q rows, k and v likewise. One thread owns one query
// row of one head: its q row and its output accumulator live in registers;
// the block streams the window's k and v rows for its heads through shared
// memory in tiles of kKeyTile keys and runs an online softmax (running max and
// sum), so T = 800 needs no [T, T] buffer and no special case. Small windows
// pack several heads into one block (T * heads <= 128 rows) so that blocks
// stay full.
//
// What bounds it on this card: the work is 4*N*T^2*C flops (q.k and p.v),
// and it reads q, k and v once (3*N*T*C elements) and writes out once
// (N*T*C). In bf16, bytes / 3.35 TB/s exceeds flops / 989 TFLOP/s up to
// T ~ 590, so every main-path level but T = 800 is bound by memory. head_dim is 6..48, below the K of 16 that
// mma/wgmma need and often not a multiple of 8, so this kernel uses float32
// FMAs, not tensor cores, and is bound by FMA throughput and latency well above
// either bound. Tiling with wgmma, packing several heads into one MMA, and
// vectorised 16-byte loads are later work.
//
// Interface: plain C, loaded with ctypes. The launch goes on the caller's
// stream; each function returns cudaGetLastError() (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;  // query rows (times heads) per block
constexpr int kKeyTile = 32;   // keys staged in shared memory per step

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// grid: x = window, y = head group, z = query-row chunk.
// Thread i of a block serves head h0 + i / rows and query row r0 + i % rows.
// q, k and v point at column 0 of their rows, `stride` elements apart; nw may
// be null (every window live).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
window_attention_kernel(const T* __restrict__ q_base,
                        const T* __restrict__ k_base,
                        const T* __restrict__ v_base,
                        int stride,
                        const float* __restrict__ bias,
                        const int* __restrict__ nw,
                        T* __restrict__ out,
                        int t, int c, int heads_per_block,
                        int rows_per_block, int windows_per_sample) {
  extern __shared__ float smem[];
  const int n = blockIdx.x;
  const int h0 = blockIdx.y * heads_per_block;
  const int tid = threadIdx.x;
  const int hl = tid / rows_per_block;                      // head within the block
  const int row = blockIdx.z * rows_per_block + tid % rows_per_block;
  const bool active = hl < heads_per_block && row < t;
  const int col0 = (h0 + hl) * HD;                          // this thread's head columns
  const size_t win = static_cast<size_t>(n) * t * stride;   // the window's first row
  T* out_row = out + (static_cast<size_t>(n) * t + row) * c + col0;

  // padding window (rank >= true window count): zeros, nothing to compute.
  // The whole block takes this branch, so returning before the barriers is safe.
  if (nw != nullptr && n % windows_per_sample >= nw[n / windows_per_sample]) {
    if (active) {
#pragma unroll
      for (int d = 0; d < HD; ++d) out_row[d] = from_float<T>(0.f);
    }
    return;
  }

  const int cols = heads_per_block * HD;                    // staged columns per key
  float* ks = smem;                                         // [kKeyTile][cols]
  float* vs = ks + kKeyTile * cols;                         // [kKeyTile][cols]
  float* bs = vs + kKeyTile * cols;                         // [kKeyTile]

  float q[HD], acc[HD];
  const T* q_row = q_base + win + static_cast<size_t>(active ? row : 0) * stride + col0;
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    q[d] = active ? to_float(q_row[d]) : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY;   // running max of the logits seen so far
  float l = 0.f;         // running sum of exp(logit - m)

  for (int k0 = 0; k0 < t; k0 += kKeyTile) {
    const int nk = min(kKeyTile, t - k0);
    __syncthreads();     // the previous tile has been consumed
    for (int i = tid; i < nk * cols; i += kThreads) {
      const int j = i / cols, col = i % cols;
      const size_t off = win + static_cast<size_t>(k0 + j) * stride + h0 * HD + col;
      ks[j * cols + col] = to_float(k_base[off]);
      vs[j * cols + col] = to_float(v_base[off]);
    }
    for (int j = tid; j < nk; j += kThreads) bs[j] = bias[static_cast<size_t>(n) * t + k0 + j];
    __syncthreads();
    if (!active) continue;

    float s[kKeyTile];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kKeyTile; ++j) {
      if (j < nk) {
        const float* kr = ks + j * cols + hl * HD;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) dot = fmaf(q[d], kr[d], dot);
        s[j] = dot + bs[j];
        tile_max = fmaxf(tile_max, s[j]);
      }
    }
    // bias is finite (-1e9 at worst), so m_new is finite and the first
    // correction is exp(-inf) = 0
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] *= corr;
#pragma unroll
    for (int j = 0; j < kKeyTile; ++j) {
      if (j < nk) {
        const float p = expf(s[j] - m_new);
        const float* vr = vs + j * cols + hl * HD;
        l += p;
#pragma unroll
        for (int d = 0; d < HD; ++d) acc[d] = fmaf(p, vr[d], acc[d]);
      }
    }
    m = m_new;
  }

  if (active) {
    const float inv = 1.f / l;
#pragma unroll
    for (int d = 0; d < HD; ++d) out_row[d] = from_float<T>(acc[d] * inv);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, int stride,
                   const float* bias, const int* nw, void* out,
                   int n, int t, int c, int nhead, int windows_per_sample,
                   cudaStream_t stream) {
  // rows of one head per block, and heads per block for small windows
  int rows = t >= kThreads ? kThreads : t;
  int heads = 1;
  if (t < kThreads) {
    for (int g = nhead; g >= 1; --g) {
      if (nhead % g == 0 && g * t <= kThreads) { heads = g; break; }
    }
  }
  const size_t smem = (2 * static_cast<size_t>(kKeyTile) * heads * HD + kKeyTile) * sizeof(float);
  auto kernel = window_attention_kernel<T, HD>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  dim3 grid(n, nhead / heads, (t + rows - 1) / rows);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), stride,
      bias, nw, static_cast<T*>(out), t, c, heads, rows, windows_per_sample);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(const void* q, const void* k, const void* v, int stride,
                              const float* bias, const int* nw, void* out, int n, int t,
                              int c, int nhead, int windows_per_sample, cudaStream_t stream) {
  switch (c / nhead) {
    case 6:  return launch<T, 6>(q, k, v, stride, bias, nw, out, n, t, c, nhead, windows_per_sample, stream);
    case 12: return launch<T, 12>(q, k, v, stride, bias, nw, out, n, t, c, nhead, windows_per_sample, stream);
    case 24: return launch<T, 24>(q, k, v, stride, bias, nw, out, n, t, c, nhead, windows_per_sample, stream);
    case 48: return launch<T, 48>(q, k, v, stride, bias, nw, out, n, t, c, nhead, windows_per_sample, stream);
    default: return cudaErrorInvalidValue;
  }
}

// q, k, v rows `stride` elements apart; dtype 0 = float32, 1 = bfloat16
cudaError_t dispatch(const void* q, const void* k, const void* v, int stride,
                     const void* bias, const void* nw, void* out, int n, int t, int c,
                     int nhead, int windows_per_sample, int dtype, void* stream) {
  if (n <= 0 || t <= 0 || nhead <= 0 || c % nhead != 0 || windows_per_sample <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const int* w = static_cast<const int*>(nw);
  if (dtype == 0)
    return dispatch_head_dim<float>(q, k, v, stride, b, w, out, n, t, c, nhead,
                                    windows_per_sample, s);
  if (dtype == 1)
    return dispatch_head_dim<__nv_bfloat16>(q, k, v, stride, b, w, out, n, t, c, nhead,
                                            windows_per_sample, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// packed [n, t, 3c] = q|k|v (dtype 0 = float32, 1 = bfloat16), bias [n, t]
// float32, nw [n / windows_per_sample] int32, out [n, t, c] of packed's dtype.
// The caller checks shapes; head_dim c / nhead must be 6, 12, 24 or 48.
int window_attention_packed(const void* packed, const void* bias, const void* nw,
                            void* out, int n, int t, int c, int nhead,
                            int windows_per_sample, int dtype, void* stream) {
  const size_t item = dtype == 1 ? sizeof(__nv_bfloat16) : sizeof(float);
  const char* p = static_cast<const char*>(packed);
  return static_cast<int>(dispatch(p, p + c * item, p + 2 * c * item, 3 * c, bias, nw, out,
                                   n, t, c, nhead, windows_per_sample, dtype, stream));
}

// q, k, v [n, t, c] of one dtype (0 = float32, 1 = bfloat16), bias [n, t]
// float32, out [n, t, c] of q's dtype; every window is computed.
// The caller checks shapes; head_dim c / nhead must be 6, 12, 24 or 48.
int window_attention_unpacked(const void* q, const void* k, const void* v, const void* bias,
                              void* out, int n, int t, int c, int nhead, int dtype,
                              void* stream) {
  return static_cast<int>(dispatch(q, k, v, c, bias, nullptr, out, n, t, c, nhead, n, dtype,
                                   stream));
}

const char* window_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

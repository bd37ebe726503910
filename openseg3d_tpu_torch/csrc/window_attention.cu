// Window attention for Hopper (sm_90a): the eval attention core of every
// SWFormer encoder layer (packed q|k|v), and the public unpacked op.
//
// This source serves two TPU kernels of openseg3d_tpu/ops/attention.py:
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
// float32 sums from float32 or bfloat16 inputs, the output rounded once to
// the input dtype. bias is 0 for real tokens and -1e9 for padding. A fully
// padded window has every logit at -1e9 (float32 spacing there is 64, so the
// q.k terms vanish): a uniform softmax over the window's own T keys, the
// mean of its own v rows, as the einsum oracle reference_window_attention
// gives (zero in the model, whose padded rows are zero). The TPU kernel's
// grouped path differs there: its block-diagonal -1e9 spreads the softmax over
// all G windows of its group.
//
// What bounds it on this card: per window 4 T^2 C flops (q.k and p.v)
// against reading q, k, v and the bias once and writing out once,
// T (8C + 4) bytes in bf16. Bytes / 3.35 TB/s exceed flops / 989 TFLOP/s
// (bf16 tensor cores) up to T ~ 590, so every main-path level but T = 800
// is bound by memory on tensor cores; on the CUDA cores' float32 FMAs
// (67 TFLOP/s) every level with T >= 40 would be bound by operations.
//
// Two bodies, chosen by dtype, width and alignment, never on failure:
// bf16 with C % 8 == 0 and 16-byte aligned q, k, v and out (every model
//   shape): tensor cores, window_attention_mma_kernel, the body of the train
//   forward (wa_mma::attend_rows in window_attention_mma.cuh) without dropout
//   and statistics. A block is one window and 16 query rows, one warp per
//   head (up to 8; more heads are split into groups of 8 over grid z), so
//   the window's k and v rows are read once per block for all its heads:
//   q rows staged once, k and v rows streamed through shared memory by
//   16-byte cp.async in double-buffered tiles, logits and P V on mma.sync
//   (bf16 in, float32 sums), FlashAttention-2's online softmax on the
//   accumulator fragments, P rounded to bf16 before P V as the TPU kernel
//   rounds it (attn.astype(v.dtype)), keys past T at -inf.
// float32, and bf16 at other widths or alignments (corners of the public
//   unpacked op that no model reaches): FMA bodies, window_attention_kernel.
//   One thread owns one query row of one head, its q row and output
//   accumulator in registers; the block streams the window's k and v rows
//   for its heads through shared memory in tiles of kKeyTile keys as float
//   and runs an online softmax, several heads per block for small windows
//   (T * heads <= 128 rows). Tensor cores give no float32 that holds the 1e-5 gates (TF32
//   keeps ~3 digits); this body serves the small float32 configurations and
//   the float32 references.
//
// Interface: plain C, loaded with ctypes. The launch goes on the caller's
// stream; each function returns cudaGetLastError() (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "window_attention_mma.cuh"

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
cudaError_t launch_fma(const void* q, const void* k, const void* v, int stride,
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

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
using wa_mma::bf16;

// grid: x = window, y = 16-row chunk, z = head group (8 heads, the last one
// possibly fewer). q, k and v point at column 0 of their rows, `stride`
// elements apart; nw may be null (every window live).
template <int HD>
__global__ void __launch_bounds__(32 * wa_mma::kMaxHeads)
window_attention_mma_kernel(const bf16* __restrict__ q_base, const bf16* __restrict__ k_base,
                            const bf16* __restrict__ v_base, int stride,
                            const float* __restrict__ bias, const int* __restrict__ nw,
                            bf16* __restrict__ out, int t, int c, int windows_per_sample) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = blockIdx.x, r0 = wa_mma::kRows * blockIdx.y;
  const int col0 = wa_mma::kMaxHeads * HD * blockIdx.z;     // the group's first column
  const int cols = min(c - col0, wa_mma::kMaxHeads * HD);
  const size_t win = static_cast<size_t>(n) * t * stride + col0;
  bf16* out_win = out + static_cast<size_t>(n) * t * c + col0;

  // padding window: zeros, nothing to compute (the whole block returns)
  if (nw != nullptr && n % windows_per_sample >= nw[n / windows_per_sample]) {
    wa_mma::zero_rows(out_win, c, r0, wa_mma::kRows, t, 0, cols);
    return;
  }
  wa_mma::PlainWeights weights;
  wa_mma::RowSoftmax sm;
  float l[2];
  wa_mma::attend_rows<HD>(q_base + win, k_base + win, v_base + win, stride,
                          bias + static_cast<size_t>(n) * t, t, r0, 1, cols, out_win, c,
                          smem_raw, weights, sm, l);
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v, int stride,
                       const float* bias, const int* nw, void* out, int n, int t, int c,
                       int nhead, int windows_per_sample, cudaStream_t stream) {
  const int heads = nhead < wa_mma::kMaxHeads ? nhead : wa_mma::kMaxHeads;
  const size_t smem = wa_mma::attend_smem<HD>(heads * HD);
  auto kernel = window_attention_mma_kernel<HD>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(n, (t + wa_mma::kRows - 1) / wa_mma::kRows, (nhead + heads - 1) / heads);
  kernel<<<grid, 32 * heads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      stride, bias, nw, static_cast<bf16*>(out), t, c, windows_per_sample);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// dispatch
// ---------------------------------------------------------------------------
using Launch = cudaError_t (*)(const void*, const void*, const void*, int, const float*,
                               const int*, void*, int, int, int, int, int, cudaStream_t);

// the launch of head width hd (6, 12, 24 or 48; else null)
template <template <int> class Body>
Launch by_head_dim(int hd) {
  switch (hd) {
    case 6: return Body<6>::fn;
    case 12: return Body<12>::fn;
    case 24: return Body<24>::fn;
    case 48: return Body<48>::fn;
    default: return nullptr;
  }
}

template <int HD> struct FmaF32 { static constexpr Launch fn = launch_fma<float, HD>; };
template <int HD> struct FmaBf16 { static constexpr Launch fn = launch_fma<bf16, HD>; };
template <int HD> struct Mma { static constexpr Launch fn = launch_mma<HD>; };

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// q, k, v rows `stride` elements apart; dtype 0 = float32, 1 = bfloat16
cudaError_t dispatch(const void* q, const void* k, const void* v, int stride,
                     const void* bias, const void* nw, void* out, int n, int t, int c,
                     int nhead, int wps, int dtype, void* stream) {
  if (n <= 0 || t <= 0 || nhead <= 0 || c % nhead != 0 || wps <= 0 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  // the tensor-core body stages 16-byte pieces of C-column rows
  const bool mma = dtype == 1 && c % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
                   aligned16(out);
  const Launch fn = dtype == 0 ? by_head_dim<FmaF32>(c / nhead)
                    : mma      ? by_head_dim<Mma>(c / nhead)
                               : by_head_dim<FmaBf16>(c / nhead);
  if (fn == nullptr) return cudaErrorInvalidValue;
  return fn(q, k, v, stride, static_cast<const float*>(bias), static_cast<const int*>(nw), out,
            n, t, c, nhead, wps, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// packed [n, t, 3c] = q|k|v (dtype 0 = float32, 1 = bfloat16), bias [n, t]
// float32, nw [n / windows_per_sample] int32, out [n, t, c] of packed's dtype.
// The caller checks shapes; head_dim c / nhead must be 6, 12, 24 or 48.
// bfloat16 runs on tensor cores when c % 8 == 0 and packed and out are
// 16-byte aligned, else on the FMA body.
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
// bfloat16 runs on tensor cores when c % 8 == 0 and q, k, v and out are
// 16-byte aligned, else on the FMA body.
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

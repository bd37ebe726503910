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
//   and statistics: q rows staged once, k and v rows streamed through shared
//   memory by 16-byte cp.async in double-buffered tiles, logits and P V on
//   mma.sync (bf16 in, float32 sums), FlashAttention-2's online softmax on
//   the accumulator fragments, P rounded to bf16 before P V as the TPU kernel
//   rounds it (attn.astype(v.dtype)), keys past T at -inf. The launch shape
//   comes from the caller (ops/attention.py's eval_shape, a table by head
//   width and T filled from chip_smoke's timing of every shape): a block
//   serves `row_tiles` 16-row query tiles of `heads` heads, one warp per
//   (row tile, head), at most 8 warps: 16 rows of 8 heads (which read a
//   window's k|v rows from L2 T / 16 times), or 32 rows of 4 heads or 64
//   rows of 2, which read them T / 32 or T / 64 times, each block fewer
//   columns of them.
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

constexpr int kMmaThreads = 32 * wa_mma::kMaxHeads;   // 8 warps a block at most

// The bf16 launch shape: `heads` heads (dividing nhead, heads x head width
// a multiple of 8) and `row_tiles` 16-row query tiles a block, key tiles
// of `key_tile` rows. float32 ignores it.
struct Shape {
  int heads, row_tiles, key_tile;
};

// grid: x = window, y = query row block, z = head group. q, k and v point
// at column 0 of their rows, `stride` elements apart; nw may be null (every
// window live). At least 3 blocks an SM, as for the train forward's body:
// without a minimum, ptxas held <24, 32> at 48 registers and spilled.
template <int HD, int KT>
__global__ void __launch_bounds__(kMmaThreads, 3)
window_attention_mma_kernel(const bf16* __restrict__ q_base, const bf16* __restrict__ k_base,
                            const bf16* __restrict__ v_base, int stride,
                            const float* __restrict__ bias, const int* __restrict__ nw,
                            bf16* __restrict__ out, int t, int c, int windows_per_sample,
                            int heads, int row_tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rows = wa_mma::kRows * row_tiles, cols = heads * HD;
  const int n = blockIdx.x, r0 = rows * blockIdx.y;
  const size_t win = static_cast<size_t>(n) * t * stride + cols * blockIdx.z;
  bf16* out_win = out + static_cast<size_t>(n) * t * c + cols * blockIdx.z;

  // padding window: zeros, nothing to compute (the whole block returns)
  if (nw != nullptr && n % windows_per_sample >= nw[n / windows_per_sample]) {
    wa_mma::zero_rows(out_win, c, r0, rows, t, 0, cols);
    return;
  }
  wa_mma::PlainWeights weights;
  wa_mma::RowSoftmax sm;
  float l[2];
  wa_mma::attend_rows<HD, KT>(q_base + win, k_base + win, v_base + win, stride,
                              bias + static_cast<size_t>(n) * t, t, r0, row_tiles, cols, out_win,
                              c, smem_raw, weights, sm, l);
}

// Launches shape `sh` after checking it against the kernel's limits.
template <int HD, int KT>
cudaError_t launch_mma(const void* q, const void* k, const void* v, int stride,
                       const float* bias, const int* nw, void* out, int n, int t, int c,
                       int nhead, int windows_per_sample, Shape sh, cudaStream_t stream) {
  const int threads = 32 * sh.heads * sh.row_tiles;
  if (sh.heads < 1 || sh.row_tiles < 1 || nhead % sh.heads || (sh.heads * HD) % 8 ||
      threads > kMmaThreads || sh.key_tile != KT)
    return cudaErrorInvalidValue;
  const size_t smem = wa_mma::attend_smem<HD, KT>(sh.heads * HD, sh.row_tiles);
  auto kernel = window_attention_mma_kernel<HD, KT>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int rows = wa_mma::kRows * sh.row_tiles;
  const dim3 grid(n, (t + rows - 1) / rows, nhead / sh.heads);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      stride, bias, nw, static_cast<bf16*>(out), t, c, windows_per_sample, sh.heads,
      sh.row_tiles);
  return cudaGetLastError();
}

// returns CALL(HD, KT) for the bf16 kernel's (head width, key tile) pairs
// (hd, kt): 64 at head widths 6 and 12, 32 at 24, 16 (16-row blocks of 8
// heads) or 64 at 48 (ops/attention.py's eval_shape chooses)
#define BY_TILE(CALL)                                                      \
  if (hd == 6 && kt == 64) return CALL(6, 64);                             \
  if (hd == 12 && kt == 64) return CALL(12, 64);                           \
  if (hd == 24 && kt == 32) return CALL(24, 32);                           \
  if (hd == 48 && kt == 16) return CALL(48, 16);                           \
  if (hd == 48 && kt == 64) return CALL(48, 64);                           \
  return cudaErrorInvalidValue;

// ---------------------------------------------------------------------------
// dispatch
// ---------------------------------------------------------------------------
using FmaLaunch = cudaError_t (*)(const void*, const void*, const void*, int, const float*,
                                  const int*, void*, int, int, int, int, int, cudaStream_t);

// the FMA launch of head width hd (6, 12, 24 or 48; else null)
template <template <int> class Body>
FmaLaunch by_head_dim(int hd) {
  switch (hd) {
    case 6: return Body<6>::fn;
    case 12: return Body<12>::fn;
    case 24: return Body<24>::fn;
    case 48: return Body<48>::fn;
    default: return nullptr;
  }
}

template <int HD> struct FmaF32 { static constexpr FmaLaunch fn = launch_fma<float, HD>; };
template <int HD> struct FmaBf16 { static constexpr FmaLaunch fn = launch_fma<bf16, HD>; };

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// q, k, v rows `stride` elements apart; dtype 0 = float32, 1 = bfloat16
cudaError_t dispatch(const void* q, const void* k, const void* v, int stride,
                     const void* bias, const void* nw, void* out, int n, int t, int c,
                     int nhead, int wps, int dtype, Shape sh, void* stream) {
  if (n <= 0 || t <= 0 || nhead <= 0 || c % nhead != 0 || wps <= 0 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const float* b = static_cast<const float*>(bias);
  const int* w = static_cast<const int*>(nw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the tensor-core body stages 16-byte pieces of C-column rows
  if (dtype == 1 && c % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
      aligned16(out)) {
    const int hd = c / nhead, kt = sh.key_tile;
#define LAUNCH(HD, KT) launch_mma<HD, KT>(q, k, v, stride, b, w, out, n, t, c, nhead, wps, sh, s)
    BY_TILE(LAUNCH)
#undef LAUNCH
  }
  const FmaLaunch fn = dtype == 0 ? by_head_dim<FmaF32>(c / nhead)
                                  : by_head_dim<FmaBf16>(c / nhead);
  if (fn == nullptr) return cudaErrorInvalidValue;
  return fn(q, k, v, stride, b, w, out, n, t, c, nhead, wps, s);
}

}  // namespace

extern "C" {

// packed [n, t, 3c] = q|k|v (dtype 0 = float32, 1 = bfloat16), bias [n, t]
// float32, nw [n / windows_per_sample] int32, out [n, t, c] of packed's dtype.
// The caller checks shapes; head_dim c / nhead must be 6, 12, 24 or 48.
// bfloat16 runs on tensor cores when c % 8 == 0 and packed and out are
// 16-byte aligned, in the launch shape (heads, row_tiles, key_tile)
// (struct Shape), else on the FMA body, which ignores the shape.
int window_attention_packed(const void* packed, const void* bias, const void* nw,
                            void* out, int n, int t, int c, int nhead,
                            int windows_per_sample, int dtype, int heads, int row_tiles,
                            int key_tile, void* stream) {
  const size_t item = dtype == 1 ? sizeof(__nv_bfloat16) : sizeof(float);
  const char* p = static_cast<const char*>(packed);
  return static_cast<int>(dispatch(p, p + c * item, p + 2 * c * item, 3 * c, bias, nw, out,
                                   n, t, c, nhead, windows_per_sample, dtype,
                                   Shape{heads, row_tiles, key_tile}, stream));
}

// q, k, v [n, t, c] of one dtype (0 = float32, 1 = bfloat16), bias [n, t]
// float32, out [n, t, c] of q's dtype; every window is computed.
// The caller checks shapes; head_dim c / nhead must be 6, 12, 24 or 48.
// bfloat16 runs on tensor cores when c % 8 == 0 and q, k, v and out are
// 16-byte aligned, in the launch shape as for window_attention_packed, else
// on the FMA body.
int window_attention_unpacked(const void* q, const void* k, const void* v, const void* bias,
                              void* out, int n, int t, int c, int nhead, int dtype, int heads,
                              int row_tiles, int key_tile, void* stream) {
  return static_cast<int>(dispatch(q, k, v, c, bias, nullptr, out, n, t, c, nhead, n, dtype,
                                   Shape{heads, row_tiles, key_tile}, stream));
}

const char* window_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Gather-GEMM sparse 3^3 convolution for Hopper (sm_90a): bf16 operands on
// tensor cores, float32 sums.
//
// Replaces no TPU kernel: the JAX package composes its sparse conv in XLA
// (a row gather into [B, Vo, 27 Cin], then one dot), and the port did the same
// in PyTorch, which wrote the gathered tensor to device memory and read it
// back (1.15 GB a conv at SPNet's stage 2, against 43 MB of input). These
// kernels read the rows through the rulebook straight into shared memory.
//
// gather_gemm_mma_kernel (the forward, and dx through the transposed
// rulebook): out[b, o] = sum_k x[b, idx[b, k, o]] @ W[k], idx -1 = no row.
//   * A block owns BM output rows and BN output columns. It stages its
//     27 x BM slice of idx in shared memory once, with -1 where the output
//     row is masked out (dst_mask) or the gathered row is (src_mask: dx reads
//     the cotangent through its output mask this way). A warp ballot per
//     offset finds the offsets with a live row in the tile, and the block
//     loops only over those: a tile of padding rows does no products and
//     writes zeros. Skipping an offset whose rows are all absent leaves every
//     sum as it was (it would add exact zeros).
//   * The loop runs over (live offset, kBK-column piece of Cin) in ascending
//     order, so every sum is taken in the same order on every run: no
//     atomics, reruns are bit-equal. Each step gathers the tile's rows with
//     16-byte cp.async (zero-filled where the row is absent or past Cin) and
//     the matching kBK x BN piece of W[k] into a ring of kStages buffers,
//     then runs mma.sync m16n8k16 on ldmatrix fragments.
//   * The epilogue zeroes masked rows and rounds once to bf16.
//
// weight_grad_mma_kernel (dW): dW[k] = sum_u x[u]^T g[tr[k, u]], tr -1 = no
// pair, g rows masked by src_mask. A block owns offset k, a BM x BN tile of
// [Cin, Cout] and a run of consecutive row chunks of at most `chunk` (2048)
// rows. It compacts each chunk's rows that have a pair at k (a ballot and a
// running count: ascending order kept) and gathers only those, the x row and
// the cotangent row it pairs with, kBK pairs a step, so no product is spent
// on a row without a pair. Each chunk is summed in fresh tensor-core
// accumulators and added to the block's float32 total, so no tensor-core
// accumulator sums more than 2048 rows (on an H100 one accumulator over
// 166400 rows drifts ~2e-5 of max|dW| from a float32 product; pieces of
// 2048 ~2e-6). Each block writes its total to its own slice of a float32
// partial [splits, 27, Cin, Cout], which the caller reduces in a fixed
// order: deterministic.
//
// What bounds them. The useful work is ~20-200 operations a byte of input
// at the model's widths (32-768 channels), but a tile re-reads its rows
// through L2 once for every live offset (up to 27 times) and the W piece
// once a step. On an H100 (chip_smoke 4c and a dense probe) the gather-GEMM
// moves 2.9-4.5 TB/s from L2 into shared memory and runs ~200 TFLOP/s of
// tensor-core work, whatever the stages (3-6), the step depth (32 or 64),
// the warp tile (32 x 64 or 64 x 64) or the gather (rows in order or at
// random): the L2 traffic, not the gather's latency, sets its time. The
// tile shape trades W's re-reads (BN / BM of the gathered bytes) against
// blocks in flight; the wrapper picks it by (Cin, Cout) from a table timed
// on the card.
//
// Widths: Cin and Cout multiples of 8 take 16-byte cp.async rows; any other
// width (the multi-sweep stem's Cin = 6, SALayer's Cout = 1) takes the
// unaligned instantiation, whose loads are predicated scalar loads.
//
// Interface: plain C, loaded with ctypes. Every launch goes on the caller's
// stream; each function returns cudaGetLastError() (0 = launched).

#include <cuda_runtime.h>
#include <stdint.h>

#include <tuple>
#include <utility>

#include "window_attention_mma.cuh"

namespace {

using wa_mma::bf16;

constexpr int kOffsets = 27;
// the H100's dynamic shared memory a block may opt in to (227 KB)
constexpr size_t kMaxSmem = 227 * 1024;

__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n)
               : "memory");
}

// A fragments (16 x 16) of row-major shared rows: lanes 0-15 address rows
// 0-15 at column 0, lanes 16-31 the same rows at column 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const bf16* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(s));
}

// A block tile: BM rows x BN columns of the product, WM x WN warps, the
// blocks an SM should hold (__launch_bounds__' minimum: without one, ptxas
// held some small tiles at 72 registers and spilled), the stages of the
// ring and the k depth of a step (Cin columns in the gather-GEMM, rows in
// the weight gradient).
template <int BM_, int BN_, int WM_, int WN_, int kMinBlocks_, int kStages_, int kBK_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_, kMinBlocks = kMinBlocks_;
  static constexpr int kStages = kStages_, kBK = kBK_;
  static_assert(kBK % 32 == 0 && kStages >= 2, "step");
  static constexpr int kThreads = 32 * WM * WN;
  static_assert(kThreads <= 256, "at most 256 threads a block");
  static constexpr int kWarpM = BM / WM, kWarpN = BN / WN;
  static constexpr int kMT = kWarpM / 16, kNT = kWarpN / 8;
  static_assert(kWarpM % 16 == 0 && kWarpN % 16 == 0, "warp tile");
};

// ---------------------------------------------------------------------------
// the gather-GEMM (forward and dx)
// ---------------------------------------------------------------------------
template <class T>
struct GemmSmem {
  static constexpr int kPitchA = wa_mma::row_pitch(T::kBK);   // gathered rows [BM][kBK]
  static constexpr int kPitchB = wa_mma::row_pitch(T::BN);  // weight rows [kBK][BN]
  static constexpr int kStageElems = T::BM * kPitchA + T::kBK * kPitchB;
  static constexpr size_t kBytes =
      T::kStages * kStageElems * sizeof(bf16) + kOffsets * T::BM * sizeof(int) + 16;
  static_assert(kPitchA % 8 == 0 && kPitchB % 8 == 0, "16-byte staged rows");
  static_assert(kBytes <= kMaxSmem, "shared memory");
};

// Start loading step (offset k, Cin columns [c0, c0 + 32)) into a stage.
template <class T, bool kAligned>
__device__ __forceinline__ void gemm_load(bf16* sa, const int* sidx, const bf16* x,
                                          const bf16* w, int b, int k, int c0, int n0, int vin,
                                          int cin, int cout) {
  using S = GemmSmem<T>;
  bf16* sb = sa + T::BM * S::kPitchA;
  const int* rows = sidx + k * T::BM;
  if constexpr (kAligned) {
    for (int i = threadIdx.x; i < T::BM * (T::kBK / 8); i += T::kThreads) {
      const int r = i / (T::kBK / 8), col = c0 + 8 * (i % (T::kBK / 8));
      const int u = rows[r];
      const bool ok = u >= 0 && col < cin;
      const bf16* src = ok ? x + (static_cast<size_t>(b) * vin + u) * cin + col : x;
      cp_async16_zfill(sa + r * S::kPitchA + (col - c0), src, ok);
    }
    for (int i = threadIdx.x; i < T::kBK * (T::BN / 8); i += T::kThreads) {
      const int r = i / (T::BN / 8), cc = 8 * (i % (T::BN / 8));
      const bool ok = c0 + r < cin && n0 + cc < cout;
      const bf16* src = ok ? w + (static_cast<size_t>(k) * cin + c0 + r) * cout + n0 + cc : w;
      cp_async16_zfill(sb + r * S::kPitchB + cc, src, ok);
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int i = threadIdx.x; i < T::BM * T::kBK; i += T::kThreads) {
      const int r = i / T::kBK, c = i % T::kBK;
      const int u = rows[r];
      sa[r * S::kPitchA + c] =
          u >= 0 && c0 + c < cin ? x[(static_cast<size_t>(b) * vin + u) * cin + c0 + c] : zero;
    }
    for (int i = threadIdx.x; i < T::kBK * T::BN; i += T::kThreads) {
      const int r = i / T::BN, c = i % T::BN;
      sb[r * S::kPitchB + c] = c0 + r < cin && n0 + c < cout
                                   ? w[(static_cast<size_t>(k) * cin + c0 + r) * cout + n0 + c]
                                   : zero;
    }
  }
}

// The fragments of one k16 slice of a stage: A (row-major rows, ldmatrix)
// for this warp's kMT row tiles, B (ldmatrix.trans of [k][n] rows) for its
// kNT column tiles, two at a time.
template <class T, bool kTransA>
__device__ __forceinline__ void load_frags(uint32_t (&a)[T::kMT][4], uint32_t (&b)[T::kNT / 2][4],
                                           const bf16* sa, int pitch_a, const bf16* sb,
                                           int pitch_b, int kk, int wm, int wn) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int mt = 0; mt < T::kMT; ++mt) {
    const int m = wm * T::kWarpM + 16 * mt;
    if constexpr (kTransA)
      // A[m][k] = sa[k][m]: the transposed load of rows staged k-major
      wa_mma::ldmatrix_x4_trans(
          a[mt], sa + (kk + 8 * (lane >> 4) + (lane & 7)) * pitch_a + m + 8 * ((lane >> 3) & 1));
    else
      ldmatrix_x4(a[mt], sa + (m + (lane & 15)) * pitch_a + kk + 8 * (lane >> 4));
  }
#pragma unroll
  for (int nt = 0; nt < T::kNT; nt += 2)
    wa_mma::ldmatrix_x4_trans(
        b[nt / 2], sb + (kk + (lane & 15)) * pitch_b + wn * T::kWarpN + 8 * nt + 8 * (lane >> 4));
}

// acc += the stage's product over its kBK depth. The fragments of the next
// k16 slice load while the current one's products issue.
template <class T, bool kTransA>
__device__ __forceinline__ void mma_stage(float (&acc)[T::kMT][T::kNT][4], const bf16* sa,
                                          int pitch_a, const bf16* sb, int pitch_b, int wm,
                                          int wn) {
  uint32_t a[2][T::kMT][4], b[2][T::kNT / 2][4];
  load_frags<T, kTransA>(a[0], b[0], sa, pitch_a, sb, pitch_b, 0, wm, wn);
#pragma unroll
  for (int kk = 0; kk < T::kBK / 16; ++kk) {
    const int cur = kk & 1;
    if (kk + 1 < T::kBK / 16)
      load_frags<T, kTransA>(a[cur ^ 1], b[cur ^ 1], sa, pitch_a, sb, pitch_b, 16 * (kk + 1), wm,
                             wn);
#pragma unroll
    for (int nt = 0; nt < T::kNT; nt += 2)
#pragma unroll
      for (int mt = 0; mt < T::kMT; ++mt) {
        wa_mma::mma_k16(acc[mt][nt], a[cur][mt], b[cur][nt / 2][0], b[cur][nt / 2][1]);
        wa_mma::mma_k16(acc[mt][nt + 1], a[cur][mt], b[cur][nt / 2][2], b[cur][nt / 2][3]);
      }
  }
}

template <class T>
__device__ __forceinline__ void gemm_step(float (&acc)[T::kMT][T::kNT][4], const bf16* sa,
                                          int wm, int wn) {
  using S = GemmSmem<T>;
  mma_stage<T, false>(acc, sa, S::kPitchA, sa + T::BM * S::kPitchA, S::kPitchB, wm, wn);
}

// The step after (offset k, Cin piece c): the next piece, else the next
// live offset's first.
template <class T>
__device__ __forceinline__ void next_step(int& k, int& c, uint32_t live, int cin) {
  c += T::kBK;
  if (c >= cin) {
    c = 0;
    const uint32_t rest = live & ~((2u << k) - 1u);
    k = rest ? __ffs(rest) - 1 : k;
  }
}

// x [B, vin, cin], idx [B, 27, vo] (sample b at idx + b * idx_bstride),
// w [27, cin, cout], out [B, vo, cout]; src_mask [B, vin] and dst_mask
// [B, vo] may be null. grid (ceil(cout / BN),
// ceil(vo / BM), B).
template <class T, bool kAligned>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks)
gather_gemm_mma_kernel(const bf16* __restrict__ x, const int* __restrict__ idx,
                       const uint8_t* __restrict__ src_mask, const bf16* __restrict__ w,
                       const uint8_t* __restrict__ dst_mask, bf16* __restrict__ out,
                       long long idx_bstride, int vin, int vo, int cin, int cout) {
  using S = GemmSmem<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* stages = reinterpret_cast<bf16*>(smem);
  int* sidx = reinterpret_cast<int*>(smem + T::kStages * S::kStageElems * sizeof(bf16));
  uint32_t* slive = reinterpret_cast<uint32_t*>(sidx + kOffsets * T::BM);
  const int n0 = blockIdx.x * T::BN, m0 = blockIdx.y * T::BM, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // The tile's 27 x BM indices, each thread's share loaded at once (the
  // loads are independent, so they are in flight together), then masked:
  // the output row (dst_mask), then the gathered row (src_mask).
  constexpr int kIdx = kOffsets * T::BM, kPer = (kIdx + T::kThreads - 1) / T::kThreads;
  int u[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = tid + j * T::kThreads, o = m0 + i % T::BM;
    u[j] = i < kIdx && o < vo ? idx[b * idx_bstride + static_cast<long long>(i / T::BM) * vo + o]
                              : -1;
  }
  if (dst_mask != nullptr) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int o = m0 + (tid + j * T::kThreads) % T::BM;
      if (u[j] >= 0 && !dst_mask[static_cast<size_t>(b) * vo + o]) u[j] = -1;
    }
  }
  if (src_mask != nullptr) {
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if (u[j] >= 0 && !src_mask[static_cast<size_t>(b) * vin + u[j]]) u[j] = -1;
  }
  if (tid == 0) *slive = 0u;
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    if (tid + j * T::kThreads < kIdx) sidx[tid + j * T::kThreads] = u[j];
  __syncthreads();
  for (int k = warp; k < kOffsets; k += T::kThreads / 32) {
    bool any = false;
    for (int r = lane; r < T::BM; r += 32) any |= sidx[k * T::BM + r] >= 0;
    if (__any_sync(0xffffffffu, any) && lane == 0) atomicOr(slive, 1u << k);
  }
  __syncthreads();
  const uint32_t live = *slive;
  const int pieces = (cin + T::kBK - 1) / T::kBK;
  const int steps = __popc(live) * pieces;

  const int wm = warp / T::WN, wn = warp % T::WN;
  float acc[T::kMT][T::kNT][4];
#pragma unroll
  for (int mt = 0; mt < T::kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::kNT; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] =
        acc[mt][nt][3] = 0.f;

  // the loader walks (live offset, Cin piece) in ascending order
  int load_k = live ? __ffs(live) - 1 : 0, load_c = 0;
#pragma unroll
  for (int s = 0; s < T::kStages - 1; ++s) {
    if (s < steps) {
      gemm_load<T, kAligned>(stages + s * S::kStageElems, sidx, x, w, b, load_k, load_c, n0,
                             vin, cin, cout);
      next_step<T>(load_k, load_c, live, cin);
    }
    wa_mma::cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    wa_mma::cp_async_wait<T::kStages - 2>();
    __syncthreads();
    const int next = s + T::kStages - 1;
    if (next < steps) {
      gemm_load<T, kAligned>(stages + (next % T::kStages) * S::kStageElems, sidx, x, w, b,
                             load_k, load_c, n0, vin, cin, cout);
      next_step<T>(load_k, load_c, live, cin);
    }
    wa_mma::cp_async_commit();
    gemm_step<T>(acc, stages + (s % T::kStages) * S::kStageElems, wm, wn);
  }
  wa_mma::cp_async_wait<0>();

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < T::kMT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * T::kWarpM + 16 * mt + g + 8 * h;
      if (row >= vo) continue;
      const bool keep = dst_mask == nullptr || dst_mask[static_cast<size_t>(b) * vo + row];
      bf16* dst = out + (static_cast<size_t>(b) * vo + row) * cout;
#pragma unroll
      for (int nt = 0; nt < T::kNT; ++nt) {
        const int col = n0 + wn * T::kWarpN + 8 * nt + 2 * t;
        const float v0 = keep ? acc[mt][nt][2 * h] : 0.f;
        const float v1 = keep ? acc[mt][nt][2 * h + 1] : 0.f;
        if constexpr (kAligned) {
          // cout is a multiple of 8 and col even: both columns or neither
          if (col < cout)
            *reinterpret_cast<uint32_t*>(dst + col) = wa_mma::pack_bf16(v0, v1);
        } else {
          if (col < cout) dst[col] = __float2bfloat16(v0);
          if (col + 1 < cout) dst[col + 1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the weight gradient
// ---------------------------------------------------------------------------
constexpr int kMaxChunk = 2048;

template <class T>
struct GradSmem {
  static constexpr int kPitchX = wa_mma::row_pitch(T::BM);  // x rows [kBK][BM]
  static constexpr int kPitchG = wa_mma::row_pitch(T::BN);  // gathered g rows [kBK][BN]
  static constexpr int kStageElems = T::kBK * kPitchX + T::kBK * kPitchG;
  // the stages, then a chunk's indices, its rows with a pair (compacted) and
  // the count of each 32-row group's
  static constexpr size_t kBytes = T::kStages * kStageElems * sizeof(bf16) +
                                   kMaxChunk * sizeof(int) + kMaxChunk * sizeof(int16_t) +
                                   (kMaxChunk / 32 + 1) * sizeof(int) + 16;
  static_assert(kPitchX % 8 == 0 && kPitchG % 8 == 0, "16-byte staged rows");
  static_assert(kBytes <= kMaxSmem, "shared memory");
  static_assert(kMaxChunk % T::kThreads == 0, "a chunk's indices in whole rounds");
};

// Start loading entries [j0, j0 + kBK) of the chunk's compacted rows (n of
// them; the rest zero-filled): the x rows (the chunk starts at row u0) and
// the cotangent rows they pair with.
template <class T, bool kAligned>
__device__ __forceinline__ void grad_load(bf16* sx, const int* sidx, const int16_t* srow, int n,
                                          const bf16* x, const bf16* g, int b, int u0, int j0,
                                          int m0, int n0, int vin, int vo, int cin, int cout) {
  using S = GradSmem<T>;
  bf16* sg = sx + T::kBK * S::kPitchX;
  if constexpr (kAligned) {
    for (int i = threadIdx.x; i < T::kBK * (T::BM / 8); i += T::kThreads) {
      const int r = i / (T::BM / 8), cc = 8 * (i % (T::BM / 8));
      const bool ok = j0 + r < n && m0 + cc < cin;
      const bf16* src =
          ok ? x + (static_cast<size_t>(b) * vin + u0 + srow[j0 + r]) * cin + m0 + cc : x;
      cp_async16_zfill(sx + r * S::kPitchX + cc, src, ok);
    }
    for (int i = threadIdx.x; i < T::kBK * (T::BN / 8); i += T::kThreads) {
      const int r = i / (T::BN / 8), cc = 8 * (i % (T::BN / 8));
      const bool ok = j0 + r < n && n0 + cc < cout;
      const bf16* src =
          ok ? g + (static_cast<size_t>(b) * vo + sidx[srow[j0 + r]]) * cout + n0 + cc : g;
      cp_async16_zfill(sg + r * S::kPitchG + cc, src, ok);
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int i = threadIdx.x; i < T::kBK * T::BM; i += T::kThreads) {
      const int r = i / T::BM, c = i % T::BM;
      sx[r * S::kPitchX + c] =
          j0 + r < n && m0 + c < cin
              ? x[(static_cast<size_t>(b) * vin + u0 + srow[j0 + r]) * cin + m0 + c]
              : zero;
    }
    for (int i = threadIdx.x; i < T::kBK * T::BN; i += T::kThreads) {
      const int r = i / T::BN, c = i % T::BN;
      sg[r * S::kPitchG + c] =
          j0 + r < n && n0 + c < cout
              ? g[(static_cast<size_t>(b) * vo + sidx[srow[j0 + r]]) * cout + n0 + c]
              : zero;
    }
  }
}

// acc (BM x BN, this warp's part) += x_rows^T g_rows over one step of kBK rows.
template <class T>
__device__ __forceinline__ void grad_step(float (&acc)[T::kMT][T::kNT][4], const bf16* sx,
                                          int wm, int wn) {
  using S = GradSmem<T>;
  mma_stage<T, true>(acc, sx, S::kPitchX, sx + T::kBK * S::kPitchX, S::kPitchG, wm, wn);
}

// x [B, vin, cin], tr [B, 27, vin] (sample b at tr + b * tr_bstride), g
// [B, vo, cout], src_mask [B, vo] or null; part [splits, 27, cin, cout]
// float32. grid (tiles of [cin, cout], 27, splits); the chunks (of `chunk`
// rows, per sample) are split evenly.
template <class T, bool kAligned>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks)
weight_grad_mma_kernel(const bf16* __restrict__ x, const int* __restrict__ tr,
                       const uint8_t* __restrict__ src_mask, const bf16* __restrict__ g,
                       float* __restrict__ part, long long tr_bstride, int nb, int vin, int vo,
                       int cin, int cout, int chunk) {
  using S = GradSmem<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* stages = reinterpret_cast<bf16*>(smem);
  int* sidx = reinterpret_cast<int*>(smem + T::kStages * S::kStageElems * sizeof(bf16));
  int16_t* srow = reinterpret_cast<int16_t*>(sidx + kMaxChunk);   // rows with a pair
  int* sgroup = reinterpret_cast<int*>(srow + kMaxChunk);           // their count, by 32 rows
  const int tiles_n = (cout + T::BN - 1) / T::BN;
  const int m0 = blockIdx.x / tiles_n * T::BM, n0 = blockIdx.x % tiles_n * T::BN;
  const int k = blockIdx.y, split = blockIdx.z, splits = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per_sample = (vin + chunk - 1) / chunk, chunks = nb * per_sample;
  const int c_begin = static_cast<int>(static_cast<long long>(split) * chunks / splits);
  const int c_end = static_cast<int>(static_cast<long long>(split + 1) * chunks / splits);
  const int wm = warp / T::WN, wn = warp % T::WN;

  float total[T::kMT][T::kNT][4];
#pragma unroll
  for (int mt = 0; mt < T::kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::kNT; ++nt) total[mt][nt][0] = total[mt][nt][1] =
        total[mt][nt][2] = total[mt][nt][3] = 0.f;

  for (int c = c_begin; c < c_end; ++c) {
    const int b = c / per_sample, u0 = c % per_sample * chunk;
    const int rows = min(chunk, vin - u0);
    __syncthreads();   // the previous chunk's indices are no longer read
    // the chunk's indices, each thread's share loaded at once, then masked
    constexpr int kPer = kMaxChunk / T::kThreads;
    int o[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int r = tid + j * T::kThreads;
      o[j] = r < rows ? tr[b * tr_bstride + static_cast<long long>(k) * vin + u0 + r] : -1;
    }
    if (src_mask != nullptr) {
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        if (o[j] >= 0 && !src_mask[static_cast<size_t>(b) * vo + o[j]]) o[j] = -1;
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) sidx[tid + j * T::kThreads] = o[j];
    __syncthreads();
    // the rows with a pair, in ascending order: each 32-row group's count,
    // their running sum, then each live row's place
    for (int grp = warp; grp < kMaxChunk / 32; grp += T::kThreads / 32) {
      const uint32_t live = __ballot_sync(0xffffffffu, sidx[32 * grp + lane] >= 0);
      if (lane == 0) sgroup[grp] = __popc(live);
    }
    __syncthreads();
    if (tid == 0) {
      int n = 0;
      for (int grp = 0; grp < kMaxChunk / 32; ++grp) {
        const int count = sgroup[grp];
        sgroup[grp] = n;
        n += count;
      }
      sgroup[kMaxChunk / 32] = n;
    }
    __syncthreads();
    for (int grp = warp; grp < kMaxChunk / 32; grp += T::kThreads / 32) {
      const bool is_live = sidx[32 * grp + lane] >= 0;
      const uint32_t live = __ballot_sync(0xffffffffu, is_live);
      if (is_live) srow[sgroup[grp] + __popc(live & ((1u << lane) - 1u))] = 32 * grp + lane;
    }
    __syncthreads();
    const int n = sgroup[kMaxChunk / 32];
    const int steps = (n + T::kBK - 1) / T::kBK;
    if (steps == 0) continue;

    float acc[T::kMT][T::kNT][4];
#pragma unroll
    for (int mt = 0; mt < T::kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < T::kNT; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] =
          acc[mt][nt][3] = 0.f;
#pragma unroll
    for (int s = 0; s < T::kStages - 1; ++s) {
      if (s < steps)
        grad_load<T, kAligned>(stages + s * S::kStageElems, sidx, srow, n, x, g, b, u0,
                               T::kBK * s, m0, n0, vin, vo, cin, cout);
      wa_mma::cp_async_commit();
    }
    for (int s = 0; s < steps; ++s) {
      wa_mma::cp_async_wait<T::kStages - 2>();
      __syncthreads();
      const int next = s + T::kStages - 1;
      if (next < steps)
        grad_load<T, kAligned>(stages + (next % T::kStages) * S::kStageElems, sidx, srow, n, x,
                               g, b, u0, T::kBK * next, m0, n0, vin, vo, cin, cout);
      wa_mma::cp_async_commit();
      grad_step<T>(acc, stages + (s % T::kStages) * S::kStageElems, wm, wn);
    }
    wa_mma::cp_async_wait<0>();
#pragma unroll
    for (int mt = 0; mt < T::kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < T::kNT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) total[mt][nt][j] += acc[mt][nt][j];
  }

  const int gq = lane >> 2, t = lane & 3;
  float* dst = part + (static_cast<size_t>(split) * kOffsets + k) * cin * cout;
#pragma unroll
  for (int mt = 0; mt < T::kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * T::kWarpM + 16 * mt + gq + 8 * h;
      if (row >= cin) continue;
#pragma unroll
      for (int nt = 0; nt < T::kNT; ++nt) {
        const int col = n0 + wn * T::kWarpN + 8 * nt + 2 * t;
        if (col < cout) dst[static_cast<size_t>(row) * cout + col] = total[mt][nt][2 * h];
        if (col + 1 < cout)
          dst[static_cast<size_t>(row) * cout + col + 1] = total[mt][nt][2 * h + 1];
      }
    }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
template <class K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <class T, bool kAligned>
cudaError_t launch_gemm(const bf16* x, const int* idx, const uint8_t* src_mask, const bf16* w,
                        const uint8_t* dst_mask, bf16* out, long long idx_bstride, int nb,
                        int vin, int vo, int cin, int cout, cudaStream_t stream) {
  const size_t smem = GemmSmem<T>::kBytes;
  auto kernel = gather_gemm_mma_kernel<T, kAligned>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((cout + T::BN - 1) / T::BN, (vo + T::BM - 1) / T::BM, nb);
  kernel<<<grid, T::kThreads, smem, stream>>>(x, idx, src_mask, w, dst_mask, out, idx_bstride,
                                              vin, vo, cin, cout);
  return cudaGetLastError();
}

template <class T, bool kAligned>
cudaError_t launch_grad(const bf16* x, const int* tr, const uint8_t* src_mask, const bf16* g,
                        float* part, long long tr_bstride, int nb, int vin, int vo, int cin,
                        int cout, int chunk, int splits, cudaStream_t stream) {
  const size_t smem = GradSmem<T>::kBytes;
  auto kernel = weight_grad_mma_kernel<T, kAligned>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int tiles = ((cin + T::BM - 1) / T::BM) * ((cout + T::BN - 1) / T::BN);
  dim3 grid(tiles, kOffsets, splits);
  kernel<<<grid, T::kThreads, smem, stream>>>(x, tr, src_mask, g, part, tr_bstride, nb, vin, vo,
                                              cin, cout, chunk);
  return cudaGetLastError();
}

// The tile shapes, in the order a launch's `tile` indexes them (the tables
// of ops/sparse_conv.py hold indices, and sparse_conv_tiles gives the
// shapes): (rows, columns, warps along rows, warps along columns, blocks an
// SM holds, stages, step depth). The minimum of blocks keeps 128
// registers a thread or more; the weight gradient's larger tiles hold two
// sets of accumulators and take up to 236 registers, so no minimum there.
using GemmTiles = std::tuple<
    Tile<64, 32, 2, 2, 4, 3, 32>, Tile<64, 64, 2, 2, 4, 3, 32>, Tile<64, 128, 2, 2, 4, 3, 32>,
    Tile<128, 128, 4, 2, 2, 3, 32>, Tile<256, 64, 8, 1, 2, 3, 32>, Tile<64, 32, 2, 2, 4, 6, 32>>;
using GradTiles = std::tuple<
    Tile<32, 32, 2, 2, 4, 3, 32>, Tile<64, 64, 2, 2, 4, 3, 32>, Tile<64, 128, 2, 2, 1, 3, 32>,
    Tile<128, 128, 4, 2, 1, 3, 32>, Tile<64, 64, 2, 2, 2, 4, 64>>;

// launch<I>(tile, ...): the launch of the tile-th shape, found at compile
// time's index I onwards.
template <int I, class... A>
cudaError_t gemm_tile(int tile, A... args) {
  if constexpr (I < std::tuple_size_v<GemmTiles>) {
    if (tile == I) return launch_gemm<std::tuple_element_t<I, GemmTiles>, true>(args...);
    return gemm_tile<I + 1>(tile, args...);
  }
  return cudaErrorInvalidValue;
}

template <int I, class... A>
cudaError_t grad_tile(int tile, A... args) {
  if constexpr (I < std::tuple_size_v<GradTiles>) {
    if (tile == I) return launch_grad<std::tuple_element_t<I, GradTiles>, true>(args...);
    return grad_tile<I + 1>(tile, args...);
  }
  return cudaErrorInvalidValue;
}

// (rows, columns) of each tile of Tiles into shape[2 i], shape[2 i + 1], at
// most `cap` tiles; returns the number of tiles.
template <class Tiles, size_t... I>
int tile_shapes(int* shape, int cap, std::index_sequence<I...>) {
  constexpr int n = sizeof...(I);
  constexpr int rows[n] = {std::tuple_element_t<I, Tiles>::BM...};
  constexpr int cols[n] = {std::tuple_element_t<I, Tiles>::BN...};
  for (int i = 0; i < n && i < cap; ++i) {
    shape[2 * i] = rows[i];
    shape[2 * i + 1] = cols[i];
  }
  return n;
}

template <class Tiles>
int tile_shapes(int* shape, int cap) {
  return tile_shapes<Tiles>(shape, cap, std::make_index_sequence<std::tuple_size_v<Tiles>>{});
}

// weight-gradient blocks a multiprocessor is given: the grid splits the row
// chunks into runs until it holds this many
constexpr int kGradBlocksPerSm = 4;

}  // namespace

extern "C" {

// The forward (idx = in_idx, w = W) and dx (idx = the transpose, w = W^T
// [27, cout, cin] of the conv, src_mask = its output mask) of a sparse conv:
// out [nb, vo, cout] = sum_k x[idx[k]] @ w[k]. tile: index into the tile
// shapes, for widths that are multiples of 8; any other width takes the
// unaligned instantiation and ignores it.
int sparse_conv_gather_gemm(const void* x, const int* idx, const uint8_t* src_mask, const void* w,
                            const uint8_t* dst_mask, void* out, long long idx_bstride, int nb,
                            int vin, int vo, int cin, int cout, int tile, cudaStream_t stream) {
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  bf16* ob = static_cast<bf16*>(out);
  if (cin % 8 || cout % 8)
    return launch_gemm<std::tuple_element_t<0, GemmTiles>, false>(
        xb, idx, src_mask, wb, dst_mask, ob, idx_bstride, nb, vin, vo, cin, cout, stream);
  return gemm_tile<0>(tile, xb, idx, src_mask, wb, dst_mask, ob, idx_bstride, nb, vin, vo, cin,
                      cout, stream);
}

// dW partials: part [splits, 27, cin, cout] float32, the caller sums over
// splits (sparse_conv_weight_grad_splits gives them). x [nb, vin, cin], tr
// [nb, 27, vin], g [nb, vo, cout], src_mask [nb, vo] or null. chunk: rows a
// tensor-core accumulator sums, a multiple of 64 and at most 2048.
int sparse_conv_weight_grad(const void* x, const int* tr, const uint8_t* src_mask, const void* g,
                            float* part, long long tr_bstride, int nb, int vin, int vo, int cin,
                            int cout, int chunk, int splits, int tile, cudaStream_t stream) {
  if (chunk <= 0 || chunk > kMaxChunk || chunk % 64 || splits <= 0) return cudaErrorInvalidValue;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* gb = static_cast<const bf16*>(g);
  if (cin % 8 || cout % 8)
    return launch_grad<std::tuple_element_t<0, GradTiles>, false>(
        xb, tr, src_mask, gb, part, tr_bstride, nb, vin, vo, cin, cout, chunk, splits, stream);
  return grad_tile<0>(tile, xb, tr, src_mask, gb, part, tr_bstride, nb, vin, vo, cin, cout, chunk,
                      splits, stream);
}

// The runs of row chunks the weight gradient's grid splits `nchunks` chunks
// into (its `splits`) for a [cin, cout] product in `tile` on `sms`
// multiprocessors: enough blocks for kGradBlocksPerSm a multiprocessor, at
// most one run a chunk. -1 for an unknown tile.
int sparse_conv_weight_grad_splits(int nchunks, int cin, int cout, int tile, int sms) {
  constexpr int n = std::tuple_size_v<GradTiles>;
  int shape[2 * n];
  tile_shapes<GradTiles>(shape, n);
  if (cin % 8 || cout % 8) tile = 0;
  if (tile < 0 || tile >= n || nchunks <= 0 || cin <= 0 || cout <= 0 || sms <= 0) return -1;
  const int tiles = ((cin + shape[2 * tile] - 1) / shape[2 * tile]) *
                    ((cout + shape[2 * tile + 1] - 1) / shape[2 * tile + 1]);
  const int want = (kGradBlocksPerSm * sms + kOffsets * tiles - 1) / (kOffsets * tiles);
  return want < 1 ? 1 : (want < nchunks ? want : nchunks);
}

// The tiles of `kernel` (0: the gather-GEMM, 1: the weight gradient) in the
// order a launch's `tile` indexes them: (rows, columns) of tile i into
// shape[2 i] and shape[2 i + 1], at most `cap` tiles. Returns the number of
// tiles, -1 for an unknown kernel.
int sparse_conv_tiles(int kernel, int* shape, int cap) {
  if (kernel == 0) return tile_shapes<GemmTiles>(shape, cap);
  if (kernel == 1) return tile_shapes<GradTiles>(shape, cap);
  return -1;
}

const char* sparse_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Tensor-core tile routines for window attention on Hopper (sm_90a): bf16
// operands, float32 accumulation, warp-level mma.sync (m16n8k16, and
// m16n8k8 where it saves padding), 16-byte cp.async row staging, and the
// fragment moves between them; and, built from them, the attention forward
// of one block (attend_rows), which the eval kernel (window_attention.cu)
// and the train forward (window_attention_train.cu, with dropout) share.
// The train backward kernels are built from the same routines, and
// transpose8 (movmatrix) turns a warp's dS^T tile into the A fragment of dS.
//
// Staging. A block copies whole rows of one window (the q, k|v or dO columns
// of every head, 96-1536 bytes, always a multiple of 16) into shared memory
// with 16-byte cp.async; rows past the window's T are zero-filled. A staged
// row keeps the global column order (heads side by side) and is padded by 8
// elements, or by 16 where 8 would leave its pitch an even multiple of 8
// elements (row_pitch): a pitch is then 4 x an odd number of 32-bit words,
// and the 8 rows of one fragment load fall on 8 different groups of 4
// banks, free of bank conflicts. (The model's widths C and 2C, C = 48, 96,
// 192 or 384, take the pad of 8; a group of heads 24 columns wide takes 16.)
//
// Heads are not split into arrays of their own. Every A or B register holds
// two adjacent head columns of one row (k = 2t, 2t+1), which sit at an even
// element offset for every head width (6, 12, 24, 48). So fragments are read
// with 32-bit shared loads straight from the staged rows, and the columns of
// head h are those at h * HD; where the k dimension runs down the rows (P V,
// dS K, ...) two 16-bit loads make a register, or, for head widths that are
// multiples of 8 (16-byte aligned columns), ldmatrix.trans. A product over
// the head dimension pads it to the fragment width (6 -> one k8 step,
// 12 -> one k16, 24 -> k16 + k8, 48 -> three k16): the padded columns belong
// to the next head or to the row's pad, so they are zeroed in registers on
// both operands. A product
// whose n dimension is the head dimension (P V, dS K, ...) runs 8-column
// tiles (6 -> 1, 12 -> 2, 24 -> 3, 48 -> 6); the columns past HD read
// neighbouring data into accumulator columns that are never stored.
//
// Fragments (PTX ISA, mma .m16n8k16 / .m16n8k8, .bf16): lane = 4 g + t.
//   A 16x16: a0 = (row g, k 2t, 2t+1), a1 = (row g+8, k 2t..), a2 = (row g,
//            k 2t+8..), a3 = (row g+8, k 2t+8..).   A 16x8: a0, a1.
//   B 16x8:  b0 = (k 2t, 2t+1; col g), b1 = (k 2t+8, 2t+9; col g). B 8x8: b0.
//   C 16x8:  c0, c1 = (row g; cols 2t, 2t+1), c2, c3 = (row g+8; cols 2t..).
// Two C tiles side by side (columns 0-7 and 8-15), rounded to bf16 and
// paired, are the A fragment of a product over those 16 columns: softmax
// weights computed from a QK^T tile feed the P V product without leaving
// registers.

#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace wa_mma {

using bf16 = __nv_bfloat16;

constexpr int kRowPad = 8;   // elements of padding after every staged row

// The pitch (elements) of a staged row of `cols` columns (a multiple of 8).
__host__ __device__ constexpr int row_pitch(int cols) {
  return (cols + kRowPad) / 8 % 2 ? cols + kRowPad : cols + 2 * kRowPad;
}

// How a head of width HD maps onto fragments.
template <int HD>
struct Head {
  static_assert(HD % 2 == 0 && HD <= 64, "head width");
  static constexpr int kPadded = (HD + 7) / 8 * 8;
  static constexpr int kK16 = kPadded / 16;             // k16 steps over the head
  static constexpr bool kK8 = kPadded % 16 != 0;        // then one k8 step
  static constexpr int kN8 = kPadded / 8;               // 8-column tiles of the head
  static constexpr int kA = 4 * kK16 + (kK8 ? 2 : 0);   // A registers over the head
  static constexpr int kB = 2 * kK16 + (kK8 ? 1 : 0);   // B registers over the head
};

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

// ---------------------------------------------------------------------------
// staging
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying rows [r0, r0 + nr) of a row-major bf16 matrix (row stride
// `stride` elements; `src` points at row 0, column 0 of the columns taken;
// ncols * 2 bytes a multiple of 16) into shared memory, `pitch` elements a
// row. Rows at or past rows_end are zero-filled. The whole block calls it;
// the caller commits the group.
__device__ __forceinline__ void stage_rows(bf16* dst, int pitch, const bf16* src, size_t stride,
                                           int r0, int nr, int rows_end, int ncols) {
  const int chunks = ncols / 8;
  for (int i = threadIdx.x; i < nr * chunks; i += blockDim.x) {
    const int r = i / chunks, k = i - r * chunks;
    bf16* d = dst + r * pitch + 8 * k;
    if (r0 + r < rows_end)
      cp_async16(d, src + static_cast<size_t>(r0 + r) * stride + 8 * k);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// ---------------------------------------------------------------------------
// fragments
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 of two rows, lo in the low half
__device__ __forceinline__ uint32_t pack_rows(const bf16* lo, const bf16* hi) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(lo)) |
         (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

__device__ __forceinline__ void mma_k16(float (&d)[4], const uint32_t* a, uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_k8(float (&d)[4], const uint32_t* a, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
}

// A fragment of the 16 staged rows at `rows` (pitch in elements), head
// columns [col, col + HD) as the k dimension, zero past HD.
template <int HD>
__device__ __forceinline__ void load_a(uint32_t (&a)[Head<HD>::kA], const bf16* rows, int pitch,
                                       int col) {
  using H = Head<HD>;
  const int k = 2 * lane_t();
  const bf16* r0 = rows + lane_g() * pitch + col + k;
  const bf16* r1 = r0 + 8 * pitch;
#pragma unroll
  for (int s = 0; s < H::kK16; ++s) {
    a[4 * s + 0] = 16 * s + k < HD ? ld32(r0 + 16 * s) : 0u;
    a[4 * s + 1] = 16 * s + k < HD ? ld32(r1 + 16 * s) : 0u;
    a[4 * s + 2] = 16 * s + 8 + k < HD ? ld32(r0 + 16 * s + 8) : 0u;
    a[4 * s + 3] = 16 * s + 8 + k < HD ? ld32(r1 + 16 * s + 8) : 0u;
  }
  if constexpr (H::kK8) {
    constexpr int s = H::kK16;
    a[4 * s + 0] = 16 * s + k < HD ? ld32(r0 + 16 * s) : 0u;
    a[4 * s + 1] = 16 * s + k < HD ? ld32(r1 + 16 * s) : 0u;
  }
}

// B fragment of a product over the head dimension whose 8 columns are the 8
// staged rows at `rows`: B[k][n] = rows[n][col + k], zero past HD.
template <int HD>
__device__ __forceinline__ void load_b_t(uint32_t (&b)[Head<HD>::kB], const bf16* rows, int pitch,
                                         int col) {
  using H = Head<HD>;
  const int k = 2 * lane_t();
  const bf16* r = rows + lane_g() * pitch + col + k;
#pragma unroll
  for (int s = 0; s < H::kK16; ++s) {
    b[2 * s + 0] = 16 * s + k < HD ? ld32(r + 16 * s) : 0u;
    b[2 * s + 1] = 16 * s + 8 + k < HD ? ld32(r + 16 * s + 8) : 0u;
  }
  if constexpr (H::kK8) {
    constexpr int s = H::kK16;
    b[2 * s] = 16 * s + k < HD ? ld32(r + 16 * s) : 0u;
  }
}

// c (16 x 8) = A (16 x HD) B (HD x 8): the k16 steps in order, then the k8
// step. Every logit of the train kernels comes from this routine.
template <int HD>
__device__ __forceinline__ void mma_head(float (&c)[4], const uint32_t (&a)[Head<HD>::kA],
                                         const uint32_t (&b)[Head<HD>::kB]) {
  using H = Head<HD>;
  c[0] = c[1] = c[2] = c[3] = 0.f;
#pragma unroll
  for (int s = 0; s < H::kK16; ++s) mma_k16(c, a + 4 * s, b[2 * s], b[2 * s + 1]);
  if constexpr (H::kK8) mma_k8(c, a + 4 * H::kK16, b[2 * H::kK16]);
}

// ldmatrix .trans: B fragments (16 x 8) of the 16 rows at the lanes'
// addresses (16-byte aligned 8-column pieces). x4: two 8-column tiles, lanes
// 0-15 the first's rows 0-15 and lanes 16-31 the second's; x2: lanes 0-15.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&b)[4], const bf16* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&b)[2], const bf16* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(s));
}

// acc[nt] (16 x 8 each) += A (16 x 16) B, where the k dimension is the 16
// staged rows at `rows` and the n dimension the head columns from `col`:
// B[k][n] = rows[k][col + 8 nt + n]. For head widths that are multiples of
// 8 (24, 48) the head's columns are 16-byte aligned and ldmatrix.trans reads
// the fragments; for 6 and 12 two 16-bit loads per register.
template <int HD>
__device__ __forceinline__ void mma_rows(float (&acc)[Head<HD>::kN8][4], const uint32_t (&a)[4],
                                         const bf16* rows, int pitch, int col) {
  constexpr int kN8 = Head<HD>::kN8;
  if constexpr (HD % 8 == 0) {
    const int lane = threadIdx.x & 31;
    const bf16* p = rows + (lane & 15) * pitch + col + 8 * (lane >> 4);
#pragma unroll
    for (int nt = 0; nt + 1 < kN8; nt += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, p + 8 * nt);
      mma_k16(acc[nt], a, b[0], b[1]);
      mma_k16(acc[nt + 1], a, b[2], b[3]);
    }
    if constexpr (kN8 % 2) {
      uint32_t b[2];
      ldmatrix_x2_trans(b, rows + (lane & 15) * pitch + col + 8 * (kN8 - 1));
      mma_k16(acc[kN8 - 1], a, b[0], b[1]);
    }
  } else {
    const bf16* p = rows + 2 * lane_t() * pitch + col + lane_g();
#pragma unroll
    for (int nt = 0; nt < kN8; ++nt) {
      const bf16* q = p + 8 * nt;
      mma_k16(acc[nt], a, pack_rows(q, q + pitch), pack_rows(q + 8 * pitch, q + 9 * pitch));
    }
  }
}

// The transpose of an 8 x 8 bf16 matrix held one 32-bit register a lane in
// the fragment layout (lane 4g + t: row g, columns 2t and 2t + 1), in the
// same layout.
__device__ __forceinline__ uint32_t transpose8(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// The A fragment (16 x 16) of two 16 x 8 accumulator tiles side by side,
// rounded to bf16.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The per-row dot products of two A fragments over the head: out[0] for row
// g, out[1] for row g + 8, summed over the quad.
template <int HD>
__device__ __forceinline__ void row_dots(float (&out)[2], const uint32_t (&x)[Head<HD>::kA],
                                         const uint32_t (&y)[Head<HD>::kA]) {
  out[0] = out[1] = 0.f;
#pragma unroll
  for (int i = 0; i < Head<HD>::kA; ++i) {   // odd registers hold row g + 8
    const float2 a = unpack_bf16(x[i]), b = unpack_bf16(y[i]);
    out[i & 1] = fmaf(a.x, b.x, fmaf(a.y, b.y, out[i & 1]));
  }
  out[0] = quad_sum(out[0]);
  out[1] = quad_sum(out[1]);
}

// The softmax weight of logit s for a row with max m and 1 / sum il.
__device__ __forceinline__ float softmax_weight(float s, float m, float il) {
  return __expf(s - m) * il;
}

// Online softmax of the two rows (g, g + 8) a thread holds. update() folds
// in a tile of logits s[NT][4] (bias added, -inf for excluded keys; the
// first tile must hold a finite logit in every row), replaces them by
// exp(s - m) with the new running max m, and returns the factors by which
// sums over earlier tiles must be scaled. l holds this thread's part of each
// row's sum; quad_sum gives the row's.
struct RowSoftmax {
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  template <int NT>
  __device__ __forceinline__ void update(float (&s)[NT][4], float (&corr)[2]) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      mx = quad_max(mx);
      corr[r] = __expf(m[r] - mx);
      m[r] = mx;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = __expf(s[nt][e] - m[e >> 1]);
        l[e >> 1] += s[nt][e];
      }
    }
  }
};

// Write the accumulator tiles of the thread's rows (row0 + g and row0 + g + 8,
// scaled by scale[0] and scale[1]) as bf16 to dst[row * stride + d], d < HD;
// rows at or past rows_end are not written.
template <int HD>
__device__ __forceinline__ void store_rows(bf16* dst, size_t stride, int row0, int rows_end,
                                           const float (&acc)[Head<HD>::kN8][4],
                                           const float (&scale)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + lane_g() + 8 * r;
    if (row >= rows_end) continue;
    bf16* out = dst + static_cast<size_t>(row) * stride;
#pragma unroll
    for (int nt = 0; nt < Head<HD>::kN8; ++nt) {
      const int d = 8 * nt + 2 * lane_t();
      if (d < HD)
        *reinterpret_cast<__nv_bfloat162*>(out + d) =
            __floats2bfloat162_rn(acc[nt][2 * r] * scale[r], acc[nt][2 * r + 1] * scale[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// blocks
// ---------------------------------------------------------------------------
constexpr int kRows = 16;       // rows of one mma tile (a warp's own rows)
constexpr int kMaxHeads = 8;    // one warp per head

// Rows of the streamed side per shared-memory tile, two tiles in flight:
// about 25-50 KB of k|v rows per tile at the model's widths.
template <int HD>
__host__ __device__ constexpr int stream_tile() { return HD <= 12 ? 64 : (HD <= 24 ? 32 : 16); }

// Zero columns [col, col + ncols) of rows [r0, min(r0 + nrows, rows_end))
// of a bf16 matrix with row stride `stride`: a padding window's block.
__device__ __forceinline__ void zero_rows(bf16* base, size_t stride, int r0, int nrows,
                                          int rows_end, int col, int ncols) {
  const int nr = min(nrows, rows_end - r0), words = ncols / 2;
  for (int i = threadIdx.x; i < nr * words; i += blockDim.x) {
    const int r = i / words, w = i - r * words;
    reinterpret_cast<uint32_t*>(base + static_cast<size_t>(r0 + r) * stride + col)[w] = 0u;
  }
}

// Shared memory of attend_rows for `cols` staged columns, `row_tiles`
// 16-row query tiles and KT-row key tiles: the block's q rows, two tiles of
// k|v rows and two of biases; a multiple of 16 bytes.
template <int HD, int KT = stream_tile<HD>()>
__host__ __device__ constexpr size_t attend_smem(int cols, int row_tiles = 1) {
  return (static_cast<size_t>(kRows) * row_tiles * row_pitch(cols) +
          2 * static_cast<size_t>(KT) * row_pitch(2 * cols)) * sizeof(bf16) +
         2 * KT * sizeof(float);
}

// The softmax weights as they are (no dropout): attend_rows' hooks for the
// eval kernels. A hook's stage(buf, k0) runs while key tile k0 is staged
// into buffer buf (before its cp.async group is committed);
// apply(buf, rt, k0, kc, w) gets the weights exp(s - m) of the warp's row
// tile rt and the 16 keys from k0 + kc (C-fragment layout; kc within the
// tile in buffer buf) before they are rounded to bf16 for P V.
struct PlainWeights {
  __device__ __forceinline__ void stage(int, int) {}
  __device__ __forceinline__ void apply(int, int, int, int, float (&)[2][4]) {}
};

// Stage key rows [k0, k0 + KT) of k and v side by side into buffer buf of
// kvs ([2][KT][kvp]) and their biases (-inf past T) into bs ([2][KT]) as one
// cp.async group, with the hook's own staging. Rows past the last 16-key
// chunk holding a key are never read and not staged.
template <int KT, class Weights>
__device__ __forceinline__ void stage_key_tile(bf16* kvs, float* bs, int kvp, const bf16* k,
                                               const bf16* v, size_t stride, const float* bias,
                                               int t, int cols, int buf, int k0,
                                               Weights& weights) {
  bf16* dst = kvs + buf * KT * kvp;
  const int nr = min(KT, (t - k0 + 15) / 16 * 16);
  stage_rows(dst, kvp, k, stride, k0, nr, t, cols);
  stage_rows(dst + cols, kvp, v, stride, k0, nr, t, cols);
  for (int j = threadIdx.x; j < KT; j += blockDim.x)
    bs[buf * KT + j] = k0 + j < t ? bias[k0 + j] : -INFINITY;
  weights.stage(buf, k0);
  cp_async_commit();
}

// softmax(q_h k_h^T + bias) v_h for the query rows [r0, r0 + 16 row_tiles)
// of one window and the heads of a block: with heads = cols / HD, warp w
// takes row tile w / heads and the head at staged columns
// [(w % heads) HD, (w % heads + 1) HD) (warps past the row tiles only help
// to stage). One row tile and one warp per head is the eval kernels' block.
//   q, k, v: row 0 of the window, at the block's first head column, rows
//   `stride` elements apart, 16-byte aligned; bias: the window's T biases;
//   cols: the block's columns (heads x HD, a multiple of 8); out: row 0 and
//   first head column of the window's output, rows out_stride apart.
// The block stages its q rows once, then streams the window's k and v rows
// through shared memory in tiles of KT rows (cp.async, two
// tiles in flight) with their biases, keys past T at -inf (so a fully
// padded window, every bias -1e9, keeps the uniform softmax over exactly its
// own T keys). Per 16-key chunk a warp computes its 16 x 16 logits with
// mma_head, adds the bias, folds them into the online softmax (RowSoftmax),
// rounds the weights to bf16 as the TPU kernel does (attn.astype(v.dtype))
// and accumulates P V with mma_rows. Stores O / l as bf16; returns each of
// the warp's rows' softmax max (sm.m) and sum (l).
template <int HD, int KT = stream_tile<HD>(), class Weights>
__device__ __forceinline__ void attend_rows(const bf16* q, const bf16* k, const bf16* v,
                                            size_t stride, const float* bias, int t, int r0,
                                            int row_tiles, int cols, bf16* out,
                                            size_t out_stride, unsigned char* smem,
                                            Weights& weights, RowSoftmax& sm, float (&l)[2]) {
  using H = Head<HD>;
  const int heads = cols / HD, warp = threadIdx.x >> 5, tq = lane_t();
  const int rt = warp / heads, col = (warp - rt * heads) * HD;
  const bool live = rt < row_tiles && r0 + kRows * rt < t;
  const int qp = row_pitch(cols), kvp = row_pitch(2 * cols);
  bf16* qs = reinterpret_cast<bf16*>(smem);                       // [16 row_tiles][qp]
  bf16* kvs = qs + kRows * row_tiles * qp;                        // [2][KT][kvp]: k | v
  float* bs = reinterpret_cast<float*>(kvs + 2 * KT * kvp);       // [2][KT]

  stage_rows(qs, qp, q, stride, r0, kRows * row_tiles, t, cols);
  stage_key_tile<KT>(kvs, bs, kvp, k, v, stride, bias, t, cols, 0, 0, weights);
  const int ntiles = (t + KT - 1) / KT;
  uint32_t qa[H::kA];
  float o[H::kN8][4] = {};

  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < ntiles) {
      stage_key_tile<KT>(kvs, bs, kvp, k, v, stride, bias, t, cols, buf ^ 1, (it + 1) * KT,
                         weights);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (live) {
      if (it == 0) load_a<HD>(qa, qs + kRows * rt * qp, qp, col);
      const bf16* kt = kvs + buf * KT * kvp;
      const float* bt = bs + buf * KT;
      const int k0 = it * KT;
#pragma unroll
      for (int kc = 0; kc < KT; kc += 16) {
        if (k0 + kc >= t) break;
        float s[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          uint32_t kb[H::kB];
          load_b_t<HD>(kb, kt + (kc + 8 * nt) * kvp, kvp, col);
          mma_head<HD>(s[nt], qa, kb);
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] += bt[kc + 8 * nt + 2 * tq + (e & 1)];
        }
        float corr[2];
        sm.update(s, corr);
#pragma unroll
        for (int nt = 0; nt < H::kN8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[nt][e] *= corr[e >> 1];
        weights.apply(buf, rt, k0, kc, s);
        uint32_t pa[4];                                           // bf16: the A fragment of P V
        c_to_a(pa, s[0], s[1]);
        mma_rows<HD>(o, pa, kt + kc * kvp, kvp, cols + col);
      }
    }
    __syncthreads();
  }

  l[0] = quad_sum(sm.l[0]);
  l[1] = quad_sum(sm.l[1]);
  if (live) {
    const float scale[2] = {1.f / l[0], 1.f / l[1]};
    store_rows<HD>(out + col, out_stride, r0 + kRows * rt, t, o, scale);
  }
}

}  // namespace wa_mma

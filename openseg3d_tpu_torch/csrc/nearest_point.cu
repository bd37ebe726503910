// Fused 1-nearest-neighbour search for Hopper (sm_90a): for every query, the
// index of the nearest valid point. The aux-loss label transfer of the train
// step runs it once per step (engine.compute_loss).
//
// Replaces the TPU kernel openseg3d_tpu/ops/knn.py:
// _nearest_point_pallas_single (its body `kernel`). Same semantics: distance
// is the sum of squared per-axis differences; a running min and argmin over
// point chunks; no [Q, P] distance matrix exists anywhere (at the default
// capacities it would be 28672 x 114688 float32 = 13 GB). Ties go to the
// lowest point index; invalid points never win; a query with no valid point
// (at a finite distance) gets -1.
//
// Ties are systematic on this path, not rare: a stage-4 aux centre sits at
// (8c + 4) voxel sizes and full-resolution centres at (c + 1/2), so up to 8
// full-resolution voxels are equidistant from an aux centre. So the distance
// is computed in exactly the plain version's order and rounding,
// ((qx - px)^2 + (qy - py)^2) + (qz - pz)^2, with the _rn intrinsics, which
// nvcc never contracts into FMAs; kernel and plain version then see the same
// float for every (query, point) and pick the same point. Points are visited
// in ascending index and only a strictly smaller distance replaces the best,
// which keeps the lowest index among equal minima.
//
// What bounds it. Q * P * 8 float operations (2.6e10 at the default
// capacities), all in registers, against a few MB of memory traffic: issue
// rate, not bytes. The _rn rule leaves 8 unfused operations a pair, each a
// whole FMA issue slot, plus a compare and two selects: ~11 warp
// instructions per 32 pairs. The first design (one thread per query, 224
// blocks of 4 warps over the whole of P) left under 2 warps per scheduler
// with one dependent chain each, so the schedulers waited on latency.
//
// Design.
//  * Points are split over blocks: the grid is (query tile, point split,
//    sample), with enough splits for kWaves times the blocks every SM holds
//    at once (nearest_point_plan). Several waves, not one, because the
//    blocks are uneven: those past a sample's last valid point finish at
//    once, and with one wave the SMs that drew more of the others set the
//    time. Each block writes a per-query partial (distance, index) for its
//    point range into scratch that the caller allocates.
//  * kRows queries per thread, kThreads threads a block: each point read from
//    shared memory (one broadcast LDS.128) feeds kRows independent chains, so
//    the schedulers always have independent instructions, and the shared
//    memory reads per pair fall by kRows.
//  * Points stream through shared memory in chunks of kChunk as float4
//    (x, y, z, index bits); an invalid point gets x = NaN, whose distance
//    never compares smaller, so the inner loop has no validity test. A chunk
//    without a valid point (__syncthreads_or) is skipped whole: the padding
//    rows past a sample's last valid voxel cost only their load.
//  * nearest_point_combine_kernel walks each query's partials in ascending
//    split order with a strict <, so the lowest index still wins a tie that
//    straddles a split boundary. No atomics: the result does not depend on
//    the order in which blocks run.
//
// Interface: plain C, loaded with ctypes. Both launches go on the caller's
// stream; the function returns cudaGetLastError() (0 = launched).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 128;                  // threads per block
constexpr int kRows = 4;                       // queries per thread
constexpr int kTile = kThreads * kRows;        // queries per block
constexpr int kChunk = 512;                    // points staged in shared memory per step
constexpr int kWaves = 3;                      // grid blocks per resident block slot

__global__ void __launch_bounds__(kThreads)
nearest_point_kernel(const float* __restrict__ queries, const float* __restrict__ points,
                     const uint8_t* __restrict__ valid, float* __restrict__ part_dist,
                     int* __restrict__ part_idx, int q, int p, int span) {
  __shared__ float4 pts[kChunk];
  const int b = blockIdx.z, split = blockIdx.y, splits = gridDim.y;
  const int q0 = blockIdx.x * kTile + threadIdx.x;
  float qx[kRows], qy[kRows], qz[kRows], best[kRows];
  int best_idx[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const float* qr = queries + (static_cast<size_t>(b) * q + min(q0 + j * kThreads, q - 1)) * 3;
    qx[j] = qr[0];
    qy[j] = qr[1];
    qz[j] = qr[2];
    best[j] = INFINITY;
    best_idx[j] = -1;
  }
  const float* pb = points + static_cast<size_t>(b) * p * 3;
  const uint8_t* vb = valid + static_cast<size_t>(b) * p;
  const int begin = split * span, end = min(p, begin + span);

  for (int p0 = begin; p0 < end; p0 += kChunk) {
    const int np = min(kChunk, end - p0);
    __syncthreads();   // the previous chunk has been consumed
    int any = 0;
    for (int k = threadIdx.x; k < np; k += kThreads) {
      const float* pr = pb + static_cast<size_t>(p0 + k) * 3;
      const bool ok = vb[p0 + k] != 0;
      any |= ok;
      pts[k] = make_float4(ok ? pr[0] : __int_as_float(0x7fc00000),   // NaN
                           pr[1], pr[2], __int_as_float(p0 + k));
    }
    if (!__syncthreads_or(any)) continue;      // no valid point in this chunk
#pragma unroll 4
    for (int k = 0; k < np; ++k) {
      const float4 pt = pts[k];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const float dx = __fsub_rn(qx[j], pt.x);
        const float dy = __fsub_rn(qy[j], pt.y);
        const float dz = __fsub_rn(qz[j], pt.z);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                  __fmul_rn(dz, dz));
        if (d < best[j]) {             // NaN (an invalid point) never compares smaller
          best[j] = d;
          best_idx[j] = __float_as_int(pt.w);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int qi = q0 + j * kThreads;
    if (qi < q) {
      const size_t at = (static_cast<size_t>(b) * splits + split) * q + qi;
      part_dist[at] = best[j];
      part_idx[at] = best_idx[j];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
nearest_point_combine_kernel(const float* __restrict__ part_dist,
                             const int* __restrict__ part_idx, int* __restrict__ out, int b,
                             int q, int splits) {
  const size_t t = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<size_t>(b) * q) return;
  const size_t bi = t / q, qi = t % q;
  float best = INFINITY;
  int best_idx = -1;
  for (int s = 0; s < splits; ++s) {     // ascending split order: lower indices first
    const size_t at = (bi * splits + s) * q + qi;
    const float d = part_dist[at];
    if (d < best) {
      best = d;
      best_idx = part_idx[at];
    }
  }
  out[t] = best_idx;
}

}  // namespace

extern "C" {

// The split of the points over blocks for b samples of q queries and p
// points: *splits ranges of *span points (the last one shorter), enough to
// give every SM of the current device kWaves times the blocks it holds at
// once, at most one split per chunk.
// The caller allocates the partials, [b, *splits, q] float32 and int32.
int nearest_point_plan(int b, int q, int p, int* splits, int* span) {
  if (b <= 0 || q <= 0 || p < 0) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, nearest_point_kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long tiles = static_cast<long>(b) * ((q + kTile - 1) / kTile);
  const long want = (static_cast<long>(kWaves) * sms * per_sm + tiles - 1) / tiles;
  const long most = (static_cast<long>(p) + kChunk - 1) / kChunk;   // one chunk a split
  const long s = std::max(1L, std::min(want, most));
  // whole chunks per split, then as many splits as that span needs
  const long chunks = std::max(1L, ((p + s - 1) / s + kChunk - 1) / kChunk);
  const long width = chunks * kChunk;
  *span = static_cast<int>(width);
  *splits = static_cast<int>(std::max(1L, (p + width - 1) / width));
  return 0;
}

// queries [b, q, 3] float32, points [b, p, 3] float32, valid [b, p] bool
// (one byte each); part_dist / part_idx [b, splits, q] scratch; out [b, q]
// int32. splits and span from nearest_point_plan.
int nearest_point(const void* queries, const void* points, const void* valid, void* part_dist,
                  void* part_idx, void* out, int b, int q, int p, int splits, int span,
                  void* stream) {
  if (b <= 0 || q <= 0 || p < 0 || splits <= 0 || span <= 0 ||
      static_cast<long>(splits) * span < p || splits > 65535 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((q + kTile - 1) / kTile, splits, b);
  nearest_point_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(queries), static_cast<const float*>(points),
      static_cast<const uint8_t*>(valid), static_cast<float*>(part_dist),
      static_cast<int*>(part_idx), q, p, span);
  const long total = static_cast<long>(b) * q;
  nearest_point_combine_kernel<<<static_cast<unsigned>((total + kThreads - 1) / kThreads),
                                 kThreads, 0, st>>>(
      static_cast<const float*>(part_dist), static_cast<const int*>(part_idx),
      static_cast<int*>(out), b, q, splits);
  return static_cast<int>(cudaGetLastError());
}

const char* nearest_point_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

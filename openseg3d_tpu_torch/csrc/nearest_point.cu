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
// Design. One thread per query, kQueries queries per block; points stream
// through shared memory in chunks of kChunk as float4 (x, y, z, valid), read
// by every thread of the block at the same address (a broadcast). The grid's
// y axis is the sample. The work is Q * P * 8 float operations (2.6e10 at
// the default capacities), all in registers; the kernel is bound by issue
// rate, not memory. Splitting P across blocks (more blocks in flight) is
// later work.
//
// Interface: plain C, loaded with ctypes. The launch goes on the caller's
// stream; the function returns cudaGetLastError() (0 = launched).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kQueries = 128;   // threads (queries) per block
constexpr int kChunk = 2048;    // points staged in shared memory per step

__global__ void __launch_bounds__(kQueries)
nearest_point_kernel(const float* __restrict__ queries, const float* __restrict__ points,
                     const uint8_t* __restrict__ valid, int* __restrict__ out, int q, int p) {
  __shared__ float4 pts[kChunk];
  const int b = blockIdx.y;
  const int qi = blockIdx.x * kQueries + threadIdx.x;
  const float* qr = queries + (static_cast<size_t>(b) * q + min(qi, q - 1)) * 3;
  const float qx = qr[0], qy = qr[1], qz = qr[2];
  const float* pb = points + static_cast<size_t>(b) * p * 3;
  const uint8_t* vb = valid + static_cast<size_t>(b) * p;

  float best = INFINITY;
  int best_idx = -1;
  for (int p0 = 0; p0 < p; p0 += kChunk) {
    const int np = min(kChunk, p - p0);
    __syncthreads();   // the previous chunk has been consumed
    for (int k = threadIdx.x; k < np; k += kQueries) {
      const float* pr = pb + static_cast<size_t>(p0 + k) * 3;
      pts[k] = make_float4(pr[0], pr[1], pr[2], vb[p0 + k] ? 1.f : 0.f);
    }
    __syncthreads();
    for (int k = 0; k < np; ++k) {
      const float4 pt = pts[k];
      const float dx = __fsub_rn(qx, pt.x);
      const float dy = __fsub_rn(qy, pt.y);
      const float dz = __fsub_rn(qz, pt.z);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      if (pt.w != 0.f && d < best) {   // NaN never compares smaller
        best = d;
        best_idx = p0 + k;
      }
    }
  }
  if (qi < q) out[static_cast<size_t>(b) * q + qi] = best_idx;
}

}  // namespace

extern "C" {

// queries [b, q, 3] float32, points [b, p, 3] float32, valid [b, p] bool
// (one byte each); out [b, q] int32.
int nearest_point(const void* queries, const void* points, const void* valid, void* out,
                  int b, int q, int p, void* stream) {
  if (b <= 0 || q <= 0 || p < 0) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((q + kQueries - 1) / kQueries, b);
  nearest_point_kernel<<<grid, kQueries, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(queries), static_cast<const float*>(points),
      static_cast<const uint8_t*>(valid), static_cast<int*>(out), q, p);
  return static_cast<int>(cudaGetLastError());
}

const char* nearest_point_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

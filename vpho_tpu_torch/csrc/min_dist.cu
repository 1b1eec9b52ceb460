// Fused nearest-vertex search for the aggregation's physics rankers, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel vpho_tpu/ops/pallas_dist.py::_pallas_min_dist_idx (body ``_kernel``).
// For query points x = fp[b, q] (q over N candidates x P force points) and the sample's
// vertices y = verts[b, v]:
//
//   d2[v] = (|x|^2 + |y|^2) - 2 (x . y)          all in f32, FP32 FMA (no TF32)
//   dist  = sqrt(max(min_v d2, 0)),   idx = first v that attains the minimum
//
// The (B, N, P, V) distance tensor is never built.  One block owns one sample and 256 query
// points (one per thread); the sample's vertices and their |y|^2 are staged through shared
// memory as float4 tiles of 2048 and every thread scans them in index order, so a strict "<"
// keeps the first minimum.  Queries past N*P are masked, so odd N needs no padding.
//
// Bound on an H100 SXM at the blessed stage-4 shapes (B 64, N 100, P 32, V 2048): 4.2e8 pairs
// x 8 flops over the 67 TFLOP/s FP32 peak, ~50 us; bytes are ~6 MB, ~2 us, so the kernel is
// bound by operations.  The scan reads one broadcast float4 from shared memory per pair; a
// later version blocks several queries per thread to cut those reads.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVertTile = 2048;

__global__ void __launch_bounds__(kThreads)
min_dist_kernel(const float* __restrict__ fp,     // (B, Q, 3)
                const float* __restrict__ verts,  // (B, V, 3)
                float* __restrict__ dist,         // (B, Q)
                int* __restrict__ idx,            // (B, Q)
                int Q, int V) {
  __shared__ float4 ys[kVertTile];
  const int b = blockIdx.y;
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const bool active = q < Q;

  float x0 = 0.0f, x1 = 0.0f, x2 = 0.0f;
  if (active) {
    const float* x = fp + ((size_t)b * Q + q) * 3;
    x0 = x[0];
    x1 = x[1];
    x2 = x[2];
  }
  const float xx = x0 * x0 + x1 * x1 + x2 * x2;
  float best = INFINITY;
  int best_i = 0;

  const float* vb = verts + (size_t)b * V * 3;
  for (int v0 = 0; v0 < V; v0 += kVertTile) {
    const int nv = min(kVertTile, V - v0);
    __syncthreads();  // the previous tile has been scanned
    for (int i = threadIdx.x; i < nv; i += kThreads) {
      const float y0 = vb[(size_t)(v0 + i) * 3 + 0];
      const float y1 = vb[(size_t)(v0 + i) * 3 + 1];
      const float y2 = vb[(size_t)(v0 + i) * 3 + 2];
      ys[i] = make_float4(y0, y1, y2, y0 * y0 + y1 * y1 + y2 * y2);
    }
    __syncthreads();
    if (active) {
      for (int i = 0; i < nv; ++i) {
        const float4 y = ys[i];
        const float g = x0 * y.x + x1 * y.y + x2 * y.z;
        const float d2 = (xx + y.w) - 2.0f * g;
        if (d2 < best) {
          best = d2;
          best_i = v0 + i;
        }
      }
    }
  }
  if (active) {
    dist[(size_t)b * Q + q] = sqrtf(fmaxf(best, 0.0f));
    idx[(size_t)b * Q + q] = best_i;
  }
}

}  // namespace

// Launches on ``stream``; returns cudaGetLastError() (0 on success).
extern "C" int vpho_min_dist(const void* fp, const void* verts, void* dist, void* idx, int B,
                             int Q, int V, void* stream) {
  if (B <= 0 || Q <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((Q + kThreads - 1) / kThreads, B);
  min_dist_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(fp), static_cast<const float*>(verts),
      static_cast<float*>(dist), static_cast<int*>(idx), Q, V);
  return (int)cudaGetLastError();
}

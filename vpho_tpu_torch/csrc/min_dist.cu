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
// The (B, N, P, V) distance tensor is never built.  One block of 128 threads owns one sample
// and 512 query points, kQueries per thread in registers, so that one shared-memory vertex read
// serves all of them.  The vertices are staged through shared memory as float4 tiles of
// (-2 y0, -2 y1, -2 y2, |y|^2), which makes the scan's key d2' = |y|^2 - 2 x.y three FFMA per
// pair (|x|^2 is the same for every vertex of a query, so it does not move the argmin).  The
// scan keeps only the minimum of each chunk of 16 vertices (one FMNMX a pair) and the first
// chunk that attains it; the winning chunk is then rescanned for the first vertex whose key
// equals that minimum, so ``idx`` is the first argmin.  ``dist`` is then taken from the chosen
// vertex in the plain order above.  Queries past N*P are masked, so odd N needs no padding.
//
// Bound on an H100 SXM at the blessed stage-4 shapes (B 64, N 100, P 32, V 2048): 4.2e8 pairs
// x 8 flops over the 67 TFLOP/s FP32 peak, ~50 us; bytes are ~6 MB, ~2 us, so the kernel is
// bound by operations.  Stage 4 runs 7 x 64 = 448 blocks and stage 5 (N 31) 2 x 64 = 128.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kQueries = 4;
constexpr int kBlockQueries = kThreads * kQueries;
constexpr int kVertTile = 2048;
constexpr int kChunk = 16;

// the scan's key |y|^2 - 2 x.y, from a staged vertex (-2y, |y|^2)
__device__ __forceinline__ float key(float x0, float x1, float x2, float4 y) {
  return __fmaf_rn(x0, y.x, __fmaf_rn(x1, y.y, __fmaf_rn(x2, y.z, y.w)));
}

__global__ void __launch_bounds__(kThreads)
min_dist_kernel(const float* __restrict__ fp,     // (B, Q, 3)
                const float* __restrict__ verts,  // (B, V, 3)
                float* __restrict__ dist,         // (B, Q)
                int* __restrict__ idx,            // (B, Q)
                int Q, int V) {
  __shared__ float4 ys[kVertTile];
  const int b = blockIdx.y;
  const float* vb = verts + (size_t)b * V * 3;

  // query i of this thread is q0 + i * kThreads: neighbouring threads read neighbouring points
  const int q0 = blockIdx.x * kBlockQueries + threadIdx.x;
  float x0[kQueries], x1[kQueries], x2[kQueries], best[kQueries];
  int best_i[kQueries];
#pragma unroll
  for (int i = 0; i < kQueries; ++i) {
    const int q = q0 + i * kThreads;
    x0[i] = x1[i] = x2[i] = 0.0f;
    if (q < Q) {
      const float* x = fp + ((size_t)b * Q + q) * 3;
      x0[i] = x[0];
      x1[i] = x[1];
      x2[i] = x[2];
    }
    best[i] = INFINITY;
    best_i[i] = 0;
  }

  for (int v0 = 0; v0 < V; v0 += kVertTile) {
    const int nv = min(kVertTile, V - v0);
    __syncthreads();  // the previous tile has been scanned
    for (int i = threadIdx.x; i < nv; i += kThreads) {
      const float y0 = vb[(size_t)(v0 + i) * 3 + 0];
      const float y1 = vb[(size_t)(v0 + i) * 3 + 1];
      const float y2 = vb[(size_t)(v0 + i) * 3 + 2];
      ys[i] = make_float4(-2.0f * y0, -2.0f * y1, -2.0f * y2,
                          __fmaf_rn(y2, y2, __fmaf_rn(y1, y1, __fmul_rn(y0, y0))));
    }
    __syncthreads();
    // pass 1: the minimum of each chunk of kChunk vertices (3 FFMA and 1 FMNMX a pair); a
    // strict "<" between chunks keeps the first chunk that attains the tile's minimum
    float tile_best[kQueries];
    int tile_chunk[kQueries];
#pragma unroll
    for (int i = 0; i < kQueries; ++i) {
      tile_best[i] = INFINITY;
      tile_chunk[i] = 0;
    }
    for (int c0 = 0; c0 < nv; c0 += kChunk) {
      float m[kQueries];
#pragma unroll
      for (int i = 0; i < kQueries; ++i) m[i] = INFINITY;
      if (c0 + kChunk <= nv) {
#pragma unroll
        for (int v = 0; v < kChunk; ++v) {
          const float4 y = ys[c0 + v];
#pragma unroll
          for (int i = 0; i < kQueries; ++i) m[i] = fminf(m[i], key(x0[i], x1[i], x2[i], y));
        }
      } else {
        for (int v = c0; v < nv; ++v) {
          const float4 y = ys[v];
#pragma unroll
          for (int i = 0; i < kQueries; ++i) m[i] = fminf(m[i], key(x0[i], x1[i], x2[i], y));
        }
      }
#pragma unroll
      for (int i = 0; i < kQueries; ++i) {
        if (m[i] < tile_best[i]) {
          tile_best[i] = m[i];
          tile_chunk[i] = c0;
        }
      }
    }
    // pass 2, where the tile beats the earlier ones: the first vertex of the winning chunk
    // whose key equals the minimum (the same arithmetic on the same operands, so exact)
#pragma unroll
    for (int i = 0; i < kQueries; ++i) {
      if (tile_best[i] < best[i]) {
        best[i] = tile_best[i];
        const int c_end = min(tile_chunk[i] + kChunk, nv);
        for (int v = tile_chunk[i]; v < c_end; ++v) {
          if (key(x0[i], x1[i], x2[i], ys[v]) == tile_best[i]) {
            best_i[i] = v0 + v;
            break;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kQueries; ++i) {
    const int q = q0 + i * kThreads;
    if (q < Q) {
      const float* y = vb + (size_t)best_i[i] * 3;
      const float y0 = y[0], y1 = y[1], y2 = y[2];
      const float xx = x0[i] * x0[i] + x1[i] * x1[i] + x2[i] * x2[i];
      const float g = x0[i] * y0 + x1[i] * y1 + x2[i] * y2;
      const float d2 = (xx + (y0 * y0 + y1 * y1 + y2 * y2)) - 2.0f * g;
      dist[(size_t)b * Q + q] = sqrtf(fmaxf(d2, 0.0f));
      idx[(size_t)b * Q + q] = best_i[i];
    }
  }
}

}  // namespace

// Launches on ``stream``; returns cudaGetLastError() (0 on success).
extern "C" int vpho_min_dist(const void* fp, const void* verts, void* dist, void* idx, int B,
                             int Q, int V, void* stream) {
  if (B <= 0 || Q <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((Q + kBlockQueries - 1) / kBlockQueries, B);
  min_dist_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(fp), static_cast<const float*>(verts),
      static_cast<float*>(dist), static_cast<int*>(idx), Q, V);
  return (int)cudaGetLastError();
}

// Fused bank-MLP for the hand denoiser's ODE fast path, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel vpho_tpu/ops/pallas_bank.py::_pallas_bank_mlp (body ``_kernel``).
// For R = B*S hypothesis rows (sample-major) and n banks:
//
//   out[r, k, :] = bf16(relu(p[r] @ W1[k] + add[b(r), k])) @ W2[k] + b2[k]
//
// with p, W1, W2 in bf16 and every sum accumulated in f32.  The (R, n, D) hidden tensor never
// reaches device memory.  One block owns one bank k and kSamplesPerBlock samples.  Each warp
// loads the W1[k] fragments of its 32 hidden columns into registers once and keeps them for
// every row of those samples.  Per sample (up to 128 rows at a time) the block stages the rows
// of p in shared memory, computes the whole hidden tile on the tensor cores (wmma bf16 -> f32)
// into shared memory, then adds ``add``, applies the relu, rounds to bf16 exactly where the TPU
// kernel does, and contracts each row with the bank's own (D, O) W2 slice in a warp reduction.
// No block-diagonal W2 and no padding of S: rows past S are masked.  C = D = 256, the hand
// head's widths, are compile-time constants.
//
// Bound on an H100 SXM at the blessed shapes (R 6400, C 256, D 256, n 32, O 3): ~27 GFLOP per
// launch over the 989 TFLOP/s bf16 tensor-core peak, ~27 us; the bytes (~12 MB) take ~4 us, so
// the kernel is bound by operations.  This version uses the legacy wmma path (not wgmma/TMA),
// runs one block of 8 warps per SM (the resident W1 fragments take most of the registers) and
// does the epilogue on CUDA cores, so it stays well above that bound.  Shared-memory rows are
// padded so that wmma fragment loads and stores do not serialise on one bank group.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kC = 256;
constexpr int kD = 256;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRows = 128;  // rows of one sample staged at once (8 row tiles of 16)
constexpr int kMaxOut = 4;
constexpr int kSamplesPerBlock = 2;
constexpr int kKSteps = kC / 16;
constexpr int kColTilesPerWarp = kD / 16 / kWarps;
// padded row strides: a power-of-two stride puts every row of a wmma fragment in one bank group
constexpr int kPStride = kC + 8;   // bf16 elements (528 B)
constexpr int kHStride = kD + 4;   // floats (1040 B)
constexpr size_t kSmemBytes = (size_t)kMaxRows * kPStride * 2 + (size_t)kMaxRows * kHStride * 4 +
                              (size_t)kD * 4 + (size_t)kD * kMaxOut * 4;

__global__ void __launch_bounds__(kThreads, 1)
bank_mlp_kernel(const __nv_bfloat16* __restrict__ p,   // (B*S, C)
                const __nv_bfloat16* __restrict__ w1,  // (n, C, D)
                const float* __restrict__ add,         // (B, n, D)
                const __nv_bfloat16* __restrict__ w2,  // (n, D, O)
                const float* __restrict__ b2,          // (n, O)
                float* __restrict__ out,               // (B*S, n, O)
                int B, int S, int O, int n_banks) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* p_s = reinterpret_cast<__nv_bfloat16*>(smem);   // kMaxRows x kPStride
  float* h_s = reinterpret_cast<float*>(smem + (size_t)kMaxRows * kPStride * 2);  // x kHStride
  float* a_s = h_s + kMaxRows * kHStride;                                 // D
  float* w2_s = a_s + kD;                                                 // D x O

  const int bank = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int col0 = warp * kColTilesPerWarp;

  // this warp's W1[k] fragments, resident for the whole block
  const __nv_bfloat16* w1_k = w1 + (size_t)bank * kC * kD;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>
      fb[kColTilesPerWarp][kKSteps];
#pragma unroll
  for (int ct = 0; ct < kColTilesPerWarp; ++ct) {
#pragma unroll
    for (int k = 0; k < kKSteps; ++k) {
      wmma::load_matrix_sync(fb[ct][k], w1_k + (size_t)k * 16 * kD + (col0 + ct) * 16, kD);
    }
  }
  const __nv_bfloat16* w2_k = w2 + (size_t)bank * kD * O;
  for (int i = tid; i < kD * O; i += kThreads) w2_s[i] = __bfloat162float(w2_k[i]);
  float bias[kMaxOut];
#pragma unroll
  for (int o = 0; o < kMaxOut; ++o) bias[o] = o < O ? b2[bank * O + o] : 0.0f;

  constexpr int kVecPerRow = kC / 8;  // 8 bf16 values per 16-byte load
  const int b_end = min(B, (int)(blockIdx.y + 1) * kSamplesPerBlock);
  for (int b = blockIdx.y * kSamplesPerBlock; b < b_end; ++b) {
    const float* add_b = add + ((size_t)b * n_banks + bank) * kD;
    for (int s0 = 0; s0 < S; s0 += kMaxRows) {
      const int rows = min(kMaxRows, S - s0);
      const int tiles = (rows + 15) / 16;
      __syncthreads();  // the previous chunk's epilogue is done with p_s, h_s and a_s
      for (int i = tid; i < kD; i += kThreads) a_s[i] = add_b[i];
      for (int i = tid; i < tiles * 16 * kVecPerRow; i += kThreads) {
        const int r = i / kVecPerRow;
        const int v = i % kVecPerRow;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (r < rows) val = reinterpret_cast<const uint4*>(p + ((size_t)b * S + s0 + r) * kC)[v];
        reinterpret_cast<uint4*>(p_s + r * kPStride)[v] = val;
      }
      __syncthreads();

      // layer 1 on the tensor cores, every row tile of the chunk
      for (int rt = 0; rt < tiles; ++rt) {
#pragma unroll
        for (int ct = 0; ct < kColTilesPerWarp; ++ct) {
          wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
          wmma::fill_fragment(acc, 0.0f);
#pragma unroll
          for (int k = 0; k < kKSteps; ++k) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
            wmma::load_matrix_sync(fa, p_s + rt * 16 * kPStride + k * 16, kPStride);
            wmma::mma_sync(acc, fa, fb[ct][k], acc);
          }
          wmma::store_matrix_sync(h_s + rt * 16 * kHStride + (col0 + ct) * 16, acc, kHStride,
                                  wmma::mem_row_major);
        }
      }
      __syncthreads();

      // epilogue: + add, relu, round to bf16, contract with this bank's W2 (one warp per row)
      for (int r = warp; r < rows; r += kWarps) {
        float acc[kMaxOut] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int d = lane; d < kD; d += 32) {
          float v = fmaxf(h_s[r * kHStride + d] + a_s[d], 0.0f);
          v = __bfloat162float(__float2bfloat16(v));
#pragma unroll
          for (int o = 0; o < kMaxOut; ++o) {
            if (o < O) acc[o] = fmaf(v, w2_s[d * O + o], acc[o]);
          }
        }
#pragma unroll
        for (int o = 0; o < kMaxOut; ++o) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) acc[o] += __shfl_xor_sync(0xffffffffu, acc[o], off);
        }
        if (lane == 0) {
          float* dst = out + (((size_t)b * S + s0 + r) * n_banks + bank) * O;
#pragma unroll
          for (int o = 0; o < kMaxOut; ++o) {
            if (o < O) dst[o] = acc[o] + bias[o];
          }
        }
      }
    }
  }
}

}  // namespace

// Launches on ``stream``; returns cudaGetLastError() (0 on success).
extern "C" int vpho_bank_mlp(const void* p, const void* w1, const void* add, const void* w2,
                             const void* b2, void* out, int B, int S, int C, int D, int O,
                             int n_banks, void* stream) {
  if (B <= 0 || S <= 0 || n_banks <= 0 || C != kC || D != kD || O < 1 || O > kMaxOut) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      bank_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_banks, (B + kSamplesPerBlock - 1) / kSamplesPerBlock);
  bank_mlp_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(p), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const float*>(add), static_cast<const __nv_bfloat16*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(out), B, S, O, n_banks);
  return (int)cudaGetLastError();
}

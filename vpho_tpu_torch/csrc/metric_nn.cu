// K3: nearest-point distances both ways for the eval metrics (ADD-S, F-score, Chamfer),
// hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves engine/metrics.py's (P, Q) distance blocks to
// XLA.  The port's plain form (ops/metric_nn.py::nearest_plain) builds each block in memory and
// rounds every 3-term dot product as the JAX package's CPU arithmetic does, emulating float32
// FMAs in float64: ~15 passes over a 64 x 4000 x 4000 block, ~144 ms of an eval batch of 64 on
// an H100.  This kernel does the same arithmetic in registers and never builds the block.  For
// a (N, P, 3), b (N, Q, 3) and an optional mask (N, P == Q) of the real points of both sets:
//
//   d2[i, j]  = (|a_i|^2 + |b_j|^2) - 2 (a_i . b_j),   each dot product x0 y0, then two FMAs
//   d_ab[i]   = min over real j of max(d2, 0),   d_ba[j] = min over real i of max(d2, 0)
//
// written as squared distances; the wrapper takes the square roots.  The arithmetic is spelt
// with intrinsics (__fmul_rn, __fmaf_rn, __fadd_rn), so nvcc's contraction cannot change a
// rounding; (a2 + b2) - 2 ab is one FMA with -2, since 2 ab is exact.  The float64 emulation
// rounds twice (to double, then to float) and differs from a single-rounded FMA by one float32
// ulp where the double lands exactly on a float32 halfway point (~2^-29 of the FMAs whose exact
// result does not fit a double, and none of those that do, as at points near 0.6 m): this
// kernel is the more faithful of the two to the JAX rounding.  Since max(., 0) is monotone,
// each minimum is taken first and clamped once.  NaN inputs are not propagated.
//
// Bound on an H100 SXM at an eval batch (B 64: two testers, each 4000 x 4000 full-mesh and
// 2048 x 2048 sampled pairs a sample): 2.58e9 pairs x 8 flops over the 67 TFLOP/s FP32 peak,
// ~0.31 ms; the points in and minima out are ~8 MB, ~2.5 us, so the kernel is bound by
// operations.  A pair costs 7 instructions (a product, three FMAs, an add, two minima; 9 with a
// mask: the penalty adds), so the design keeps every operand in registers or shared memory and
// reads each input point from device memory about once per block:
//   * a block of 128 threads holds 1024 a-points, 8 a thread in registers with |a|^2 and their
//     row minima;
//   * it streams b-points through shared memory in tiles of 512 as (x, y, z, |b|^2) and, with
//     a mask, a penalty of 0 or +inf for each set's padding;
//   * a column's minimum over a warp's 256 rows is one redux.sync (the float's bits are
//     ordered as unsigned integers once clamped to >= 0, with +inf 0x7f800000 above every
//     finite value), kept by the lane of the column's index; a warp's 32 columns go to a
//     shared-memory minimum with one atomicMin each, and a tile's to the (N, Q) output;
//   * the row minima go to the (N, P) output by atomicMin too, so Q can be split across
//     blocks: when N x P-tiles blocks cannot fill the card for two waves (one frame: N 1,
//     P 4000), each block scans a range of at least 256 b-points.  The output is filled with
//     +inf by the wrapper, and a min does not depend on order, so replays are bit-identical.
// Ragged tiles repeat their last point (a repeat leaves every minimum as it is, and its own
// outputs are not written); offsets are 64-bit.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 8;
constexpr int kBlockRows = kThreads * kRows;
constexpr int kTile = 512;
constexpr int kMinCols = 256;
constexpr unsigned kInfBits = 0x7f800000u;

// x . y rounded as the plain form's dot3: the first product, then two FMAs
__device__ __forceinline__ float dot3(float x0, float x1, float x2, float y0, float y1,
                                      float y2) {
  return __fmaf_rn(x2, y2, __fmaf_rn(x1, y1, __fmul_rn(x0, y0)));
}

// a minimum as ordered bits: clamped at 0 (a -0.0 becomes +0.0, NaN becomes 0)
__device__ __forceinline__ unsigned clamp_bits(float d) {
  return __float_as_uint(d > 0.0f ? d : 0.0f);
}

template <bool kMask>
__global__ void __launch_bounds__(kThreads)
metric_nn_kernel(const float* __restrict__ a,     // (N, P, 3)
                 const float* __restrict__ b,     // (N, Q, 3)
                 const float* __restrict__ mask,  // (N, P == Q) or null
                 unsigned* __restrict__ d_ab,     // (N, P) squared minima, filled with +inf
                 unsigned* __restrict__ d_ba,     // (N, Q) likewise
                 int P, int Q, int cols) {
  __shared__ float4 bs[kTile];
  __shared__ float bpen[kMask ? kTile : 1];
  __shared__ unsigned colmin[kTile];

  const int n = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const float* an = a + (size_t)n * P * 3;
  const float* bn = b + (size_t)n * Q * 3;
  const float* mn = kMask ? mask + (size_t)n * P : nullptr;

  float ax[kRows], ay[kRows], az[kRows], aa[kRows], apen[kRows], rmin[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int p = min((int)blockIdx.x * kBlockRows + r * kThreads + (int)threadIdx.x, P - 1);
    ax[r] = an[(size_t)p * 3 + 0];
    ay[r] = an[(size_t)p * 3 + 1];
    az[r] = an[(size_t)p * 3 + 2];
    aa[r] = dot3(ax[r], ay[r], az[r], ax[r], ay[r], az[r]);
    apen[r] = kMask && !(mn[p] > 0.0f) ? INFINITY : 0.0f;
    rmin[r] = INFINITY;
  }

  const int q_end = min(Q, (int)blockIdx.y * cols + cols);
  for (int t0 = (int)blockIdx.y * cols; t0 < q_end; t0 += kTile) {
    const int nb = min(kTile, q_end - t0);
    const int nb32 = (nb + 31) & ~31;
    __syncthreads();  // the previous tile has been scanned and flushed
    for (int i = threadIdx.x; i < nb32; i += kThreads) {
      const size_t q = (size_t)t0 + min(i, nb - 1);
      const float x = bn[q * 3 + 0], y = bn[q * 3 + 1], z = bn[q * 3 + 2];
      bs[i] = make_float4(x, y, z, dot3(x, y, z, x, y, z));
      if (kMask) bpen[i] = mn[q] > 0.0f ? 0.0f : INFINITY;
      colmin[i] = kInfBits;
    }
    __syncthreads();
    for (int j0 = 0; j0 < nb32; j0 += 32) {
      unsigned mine = kInfBits;
#pragma unroll
      for (int jj = 0; jj < 32; ++jj) {
        const float4 y = bs[j0 + jj];
        const float pen = kMask ? bpen[j0 + jj] : 0.0f;
        float c = INFINITY;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float d = __fmaf_rn(-2.0f, dot3(ax[r], ay[r], az[r], y.x, y.y, y.z),
                                    __fadd_rn(aa[r], y.w));
          if (kMask) {
            rmin[r] = fminf(rmin[r], __fadd_rn(d, pen));
            c = fminf(c, __fadd_rn(d, apen[r]));
          } else {
            rmin[r] = fminf(rmin[r], d);
            c = fminf(c, d);
          }
        }
        const unsigned w = __reduce_min_sync(0xffffffffu, clamp_bits(c));
        if (lane == jj) mine = w;
      }
      atomicMin(&colmin[j0 + lane], mine);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nb; i += kThreads)
      atomicMin(d_ba + (size_t)n * Q + t0 + i, colmin[i]);
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int p = (int)blockIdx.x * kBlockRows + r * kThreads + (int)threadIdx.x;
    if (p < P) atomicMin(d_ab + (size_t)n * P + p, clamp_bits(rmin[r]));
  }
}

// Q's split: one range when N x P-tiles blocks fill the card for two waves, else enough
// ranges of at least kMinCols b-points (a multiple of 32) to do so.  The card's block slots
// are read once, at the first launch (an eager run, before any capture).
template <bool kMask>
int columns_per_block(int N, int P, int Q) {
  static long long slots = 0;
  if (slots == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, metric_nn_kernel<kMask>, kThreads, 0);
    slots = (long long)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  }
  const long long blocks = (long long)N * ((P + kBlockRows - 1) / kBlockRows);
  const long long most = (Q + kMinCols - 1) / kMinCols;
  long long splits = blocks >= 2 * slots ? 1 : (2 * slots + blocks - 1) / blocks;
  splits = splits < most ? splits : most;
  return (int)(((Q + splits - 1) / splits + 31) / 32 * 32);
}

template <bool kMask>
int launch(const float* a, const float* b, const float* mask, unsigned* d_ab, unsigned* d_ba,
           int N, int P, int Q, cudaStream_t stream) {
  const int cols = columns_per_block<kMask>(N, P, Q);
  dim3 grid((P + kBlockRows - 1) / kBlockRows, (Q + cols - 1) / cols, N);
  metric_nn_kernel<kMask><<<grid, kThreads, 0, stream>>>(a, b, mask, d_ab, d_ba, P, Q, cols);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on ``stream``; ``mask`` may be null (then P and Q may differ).  The outputs must be
// filled with +inf (0x7f800000) beforehand.  Returns cudaGetLastError() (0 on success).
extern "C" int vpho_metric_nn(const void* a, const void* b, const void* mask, void* d_ab,
                              void* d_ba, int N, int P, int Q, void* stream) {
  if (N <= 0 || P <= 0 || Q <= 0 || N > 65535 || (mask != nullptr && P != Q))
    return (int)cudaErrorInvalidValue;
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  const float* mf = static_cast<const float*>(mask);
  unsigned* ab = static_cast<unsigned*>(d_ab);
  unsigned* ba = static_cast<unsigned*>(d_ba);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return mf != nullptr ? launch<true>(af, bf, mf, ab, ba, N, P, Q, s)
                       : launch<false>(af, bf, mf, ab, ba, N, P, Q, s);
}

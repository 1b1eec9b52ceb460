// Fused bank-MLP for the hand denoiser's ODE fast path, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel vpho_tpu/ops/pallas_bank.py::_pallas_bank_mlp (body ``_kernel``).
// For R = B*S hypothesis rows (sample-major) and n banks:
//
//   out[r, k, :] = bf16(relu(p[r] @ W1[k] + add[b(r), k])) @ W2[k] + b2[k]
//
// with p, W1, W2 in bf16, every sum accumulated in f32, and h rounded to bf16 (round to
// nearest even) after the relu, where the TPU kernel rounds it.  The (R, n, D) hidden tensor
// never reaches device memory.  C = D = 256 (the hand head's widths) are compile-time
// constants; O <= 4.
//
// Bound on an H100 SXM at the blessed shapes (R 6400, C 256, D 256, n 32, O 3): ~27 GFLOP per
// launch over the 989 TFLOP/s bf16 tensor-core peak, ~27.5 us; the bytes (~12 MB) take ~4 us,
// so the kernel is bound by operations and only wgmma can reach that rate.  The design:
//
//   * Persistent CTAs, about one per SM: CTA (k, r) owns bank k and the r-th contiguous range
//     of 64-row tiles of p (ranges per bank = max(1, SMs / n)), so W1[k] is read from device
//     memory once per CTA.
//   * W1[k], pre-transposed to K-major (D, C) by the wrapper's prepare step, sits in shared
//     memory for the CTA's whole life: 128 KB, loaded by TMA with the 128-byte swizzle that
//     wgmma reads B from.  W2[k], zero-padded to 8 columns and laid out in wgmma's 8x8 core
//     matrices, comes with it (4 KB, one bulk copy).
//   * One producer thread streams 64 x 256 tiles of p by TMA into a 2-stage ring with
//     mbarriers (out-of-bounds rows of the last tile are zero-filled), together with the rows
//     of ``add`` of the samples the tile spans when there are at most kMaxAddRows of them; for
//     more (small S) the consumers read ``add`` from L2.
//   * Two consumer warpgroups take alternate tiles and take turns at layer 1 (named barriers,
//     as in FlashAttention-3's ping-pong).  Layer 1 is 16 x wgmma.m64n256k16 (bf16 in, f32
//     accumulators: 128 registers a thread, which start at the rows' ``add`` values); once
//     they retire the stage goes back to the producer, so the next tile's load overlaps this
//     tile's epilogue and the other consumer's layer 1.  The epilogue applies the relu and
//     packs h to bf16 in registers: the f32 accumulator layout of one wgmma is the A-register
//     layout of the next, so layer 2 runs on the tensor cores as 16 x wgmma.m64n8k16 with A
//     from registers and W2[k] from shared memory.  Only the O <= 4 live output columns,
//     with b2 added, are written to device memory.
//   * 384 threads a CTA start at 168 registers a thread; the producer warpgroup drops to 56
//     (setmaxnreg) and the consumers rise to 224, so the 128 accumulators and the packed h
//     fit without spilling.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 256;
constexpr int kD = 256;
constexpr int kTileRows = 64;
constexpr int kMaxOut = 4;
constexpr int kN2 = 8;            // layer 2's wgmma width: W2 padded to 8 columns
constexpr int kConsumers = 2;
constexpr int kThreads = (kConsumers + 1) * 128;   // consumers, then the producer warpgroup
constexpr int kProducerWarp = kConsumers * 4;
constexpr int kProducerRegs = 56;                    // setmaxnreg: 56 x 128 + 224 x 256 <= 64K
constexpr int kConsumerRegs = 224;
constexpr int kMaxAddRows = 4;    // samples of ``add`` staged with a tile
constexpr int kBoxCols = 64;      // 128 bytes of bf16: the 128-byte swizzle's row

constexpr int kW1Bytes = kD * kC * 2;
constexpr int kABytes = kTileRows * kC * 2;
constexpr int kW2Bytes = kD * kN2 * 2;
constexpr int kAddSlotBytes = kMaxAddRows * kD * 4;
constexpr int kOffW1 = 0;
constexpr int kOffA = kOffW1 + kW1Bytes;
constexpr int kOffW2 = kOffA + 2 * kABytes;
constexpr int kOffAdd = kOffW2 + kW2Bytes;
constexpr int kOffBar = kOffAdd + 2 * kAddSlotBytes;
constexpr int kSmemBytes = kOffBar + 64 + 1024;   // barriers, and slack to align to 1024
static_assert(kSmemBytes <= 232448, "shared memory over the 227 KB a block may use");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// returns once the phase of parity ``parity`` has completed; a wait that never ends (a fault
// in the pipeline) traps after ~2^24 polls instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    if (polls == (1u << 24)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
  }
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptors: start address >> 4 in bits 0-13, leading byte offset >> 4
// in 16-29, stride byte offset >> 4 in 32-45, layout in 62-63.
// K-major with the 128-byte swizzle (TMA's layout): 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// K-major without swizzle: 8x8 core matrices of 128 bytes, K-neighbours 128 bytes apart.  With
// N = 8 there is one core matrix along N, so both offsets are set to 128 bytes.
__device__ __forceinline__ uint64_t desc_core(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) | (static_cast<uint64_t>(128 >> 4) << 32);
}

// The consumers' turns at the tensor cores: consumer c waits on named barrier 1 + c until the
// other consumer's 128 threads have passed it the turn.
__device__ __forceinline__ void turn_wait(int c) {
  asm volatile("bar.sync %0, 256;" ::"r"(1 + c) : "memory");
}
__device__ __forceinline__ void turn_pass(int c) {
  asm volatile("bar.arrive %0, 256;" ::"r"(1 + c) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keeps the compiler from moving reads or writes of ``r`` across a wgmma fence or wait
__device__ __forceinline__ void pin(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void pin(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

// d[64 x 256] (+)= A[64 x 16] B[16 x 256], A and B from shared memory, both K-major
__device__ __forceinline__ void wgmma_m64n256k16(float* d, uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
      "%125, %126, %127}, %128, %129, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
        "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
        "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
        "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),
        "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),
        "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 8] (+)= A[64 x 16] B[16 x 8], A from registers (bf16 pairs), B from shared memory
__device__ __forceinline__ void wgmma_m64n8k16_rs(float* d, const uint32_t* a, uint64_t db,
                                                  int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %9, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16"
      " {%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // round to nearest even; lo in bits 0-15
  return *reinterpret_cast<uint32_t*>(&v);
}

// the samples that rows [row0, row0 + 64) of a sample-major (R, .) tensor span
struct TileSamples {
  int row0, first, count;
  __device__ TileSamples(int tile, int R, int S) {
    row0 = tile * kTileRows;
    first = row0 / S;
    count = min(row0 + kTileRows, R) - 1;
    count = count / S - first + 1;
  }
};

__global__ void __launch_bounds__(kThreads, 1)
bank_mlp_kernel(const __grid_constant__ CUtensorMap p_map,    // (R, C) bf16, box 64 x 64
                const __grid_constant__ CUtensorMap w1_map,   // (n*D, C) bf16, box 256 x 64
                const float* __restrict__ add,                // (B, n, D)
                const __nv_bfloat16* __restrict__ w2p,        // (n, D/8, 8, 8) core matrices
                const float* __restrict__ b2,                 // (n, O)
                float* __restrict__ out,                      // (R, n, O)
                int R, int S, int O, int n_banks, int ranges) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kOffBar);
  uint64_t* w_bar = bars;          // W1[k] and W2[k] have landed
  uint64_t* full = bars + 1;       // [2] stage s holds a tile of p (and its add rows)
  uint64_t* empty = bars + 3;      // [2] the consumer's layer 1 is done with stage s

  const int bank = blockIdx.x / ranges;
  const int range = blockIdx.x % ranges;
  const int tiles = (R + kTileRows - 1) / kTileRows;
  const int t0 = static_cast<int>(static_cast<long long>(tiles) * range / ranges);
  const int ntiles = static_cast<int>(static_cast<long long>(tiles) * (range + 1) / ranges) - t0;
  if (ntiles <= 0) return;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  if (tid == 0) {
    mbar_init(w_bar, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kProducerWarp) {
    // ---- producer warpgroup: hands its registers to the consumers; one thread issues every
    // copy -------------------------------------------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (warp == kProducerWarp && lane == 0) {
      mbar_expect_tx(w_bar, kW1Bytes + kW2Bytes);
      for (int kb = 0; kb < kC / kBoxCols; ++kb) {
        tma_load_2d(smem + kOffW1 + kb * (kD * kBoxCols * 2), &w1_map, kb * kBoxCols,
                    bank * kD, w_bar);
      }
      bulk_load(smem + kOffW2, w2p + static_cast<size_t>(bank) * kD * kN2, kW2Bytes, w_bar);
      for (int j = 0; j < ntiles; ++j) {
        const int s = j & 1;
        // stage s (a tile of p and its add rows) was last used by tile j - 2; its consumer
        // released it after layer 1
        if (j >= 2) mbar_wait(&empty[s], ((j >> 1) & 1) ^ 1);
        const TileSamples ts(t0 + j, R, S);
        const bool staged = ts.count <= kMaxAddRows;
        mbar_expect_tx(&full[s], kABytes + (staged ? ts.count * kD * 4 : 0));
        uint8_t* a_s = smem + kOffA + s * kABytes;
        for (int kb = 0; kb < kC / kBoxCols; ++kb) {
          tma_load_2d(a_s + kb * (kTileRows * kBoxCols * 2), &p_map, kb * kBoxCols, ts.row0,
                      &full[s]);
        }
        if (staged) {
          uint8_t* slot = smem + kOffAdd + s * kAddSlotBytes;
          for (int i = 0; i < ts.count; ++i) {
            bulk_load(slot + i * kD * 4,
                      add + (static_cast<size_t>(ts.first + i) * n_banks + bank) * kD, kD * 4,
                      &full[s]);
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup c takes tiles c, c + 2, ... ---------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int c = warp / 4;
    const int rl = (warp % 4) * 16 + lane / 4;   // this thread's tile rows: rl and rl + 8
    const int cb = 2 * (lane % 4);               // and columns cb, cb + 1 of each 8-block
    const uint64_t dw1 = desc_sw128(smem + kOffW1);
    const uint64_t dw2 = desc_core(smem + kOffW2);
    float bias[2];
    for (int i = 0; i < 2; ++i) bias[i] = cb + i < O ? b2[bank * O + cb + i] : 0.0f;
    mbar_wait(w_bar, 0);

    for (int j = c; j < ntiles; j += kConsumers) {
      const int s = j & 1;
      const TileSamples ts(t0 + j, R, S);
      mbar_wait(&full[s], (j >> 1) & 1);

      // the accumulators start at this thread's ``add`` values, so layer 1 leaves
      // p_tile @ W1[k] + add in them and the epilogue loads nothing
      const int g0 = min(ts.row0 + rl, R - 1);
      const int g1 = min(ts.row0 + rl + 8, R - 1);
      const float* a0;
      const float* a1;
      if (ts.count <= kMaxAddRows) {
        const float* slot = reinterpret_cast<const float*>(smem + kOffAdd + s * kAddSlotBytes);
        a0 = slot + (g0 / S - ts.first) * kD;
        a1 = slot + (g1 / S - ts.first) * kD;
      } else {
        a0 = add + (static_cast<size_t>(g0 / S) * n_banks + bank) * kD;
        a1 = add + (static_cast<size_t>(g1 / S) * n_banks + bank) * kD;
      }
      float acc[128];
#pragma unroll
      for (int nb = 0; nb < kD / 8; ++nb) {
        const float2 x0 = *reinterpret_cast<const float2*>(a0 + nb * 8 + cb);
        const float2 x1 = *reinterpret_cast<const float2*>(a1 + nb * 8 + cb);
        acc[4 * nb] = x0.x;
        acc[4 * nb + 1] = x0.y;
        acc[4 * nb + 2] = x1.x;
        acc[4 * nb + 3] = x1.y;
      }

      // layer 1: acc += p_tile @ W1[k], 16 wgmma over C = 256, once the other consumer's
      // layer 1 of tile j - 1 is done (ping-pong: its epilogue overlaps this layer 1)
      if (j > 0) turn_wait(c);
#pragma unroll
      for (int i = 0; i < 128; ++i) pin(acc[i]);
      wgmma_fence();
      const uint64_t da = desc_sw128(smem + kOffA + s * kABytes);
#pragma unroll
      for (int kb = 0; kb < kC / kBoxCols; ++kb) {
#pragma unroll
        for (int kk = 0; kk < kBoxCols / 16; ++kk) {
          // +32 bytes per k16 step inside a swizzled row; the next box is a separate tile
          wgmma_m64n256k16(acc, da + ((kb * kTileRows * kBoxCols * 2 + kk * 32) >> 4),
                           dw1 + ((kb * kD * kBoxCols * 2 + kk * 32) >> 4), 1);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < 128; ++i) pin(acc[i]);
      if (j + 1 < ntiles) turn_pass(1 - c);
      mbar_arrive(&empty[s]);   // p's tile and its add rows are consumed: the stage is free

      // epilogue: relu, round to bf16, packed as layer 2's A fragments
      uint32_t hp[64];
#pragma unroll
      for (int nb = 0; nb < kD / 8; ++nb) {
        hp[2 * nb] = pack_bf16(fmaxf(acc[4 * nb], 0.0f), fmaxf(acc[4 * nb + 1], 0.0f));
        hp[2 * nb + 1] = pack_bf16(fmaxf(acc[4 * nb + 2], 0.0f), fmaxf(acc[4 * nb + 3], 0.0f));
      }

      // layer 2 on the tensor cores: o = h @ W2[k] (8 padded columns), 16 wgmma over D = 256
      float o[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < 64; ++i) pin(hp[i]);
#pragma unroll
      for (int i = 0; i < 4; ++i) pin(o[i]);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kD / 16; ++ks) {
        // k16 slice ks = 8-blocks 2ks (rows rl, rl+8) and 2ks+1; 256 bytes of W2 per slice
        wgmma_m64n8k16_rs(o, &hp[4 * ks], dw2 + ((ks * 256) >> 4), ks);
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < 4; ++i) pin(o[i]);

      const int r0 = ts.row0 + rl;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (cb + i < O) {
          if (r0 < R) out[(static_cast<size_t>(r0) * n_banks + bank) * O + cb + i] = o[i] + bias[i];
          if (r0 + 8 < R) {
            out[(static_cast<size_t>(r0 + 8) * n_banks + bank) * O + cb + i] = o[2 + i] + bias[i];
          }
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime: nothing extra is linked
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(ptr);
    }
  }
  return fn;
}

// a row-major (rows, 256) bf16 matrix read in boxes of box_rows x 64 with the 128-byte swizzle
bool make_map(CUtensorMap* map, const void* base, int rows, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kC), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(kC) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBoxCols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

constexpr int kMaxDevices = 64;

// p (R, C) bf16; w1t (n, D, C) bf16 (W1 transposed to K-major); add (R/S, n, D) f32;
// w2p (n, D/8, 8, 8) bf16 (W2 padded to 8 columns, 8x8 core matrices); b2 (n, O) f32;
// out (R, n, O) f32.  Launches on ``stream``; returns a cudaError_t (0 on success).
extern "C" int vpho_bank_mlp(const void* p, const void* w1t, const void* add, const void* w2p,
                             const void* b2, void* out, int R, int S, int C, int D, int O,
                             int n_banks, void* stream) {
  if (R <= 0 || S <= 0 || R % S != 0 || n_banks <= 0 || C != kC || D != kD || O < 1 ||
      O > kMaxOut) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap p_map, w1_map;
  if (!make_map(&p_map, p, R, kTileRows) || !make_map(&w1_map, w1t, n_banks * kD, kD)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the SM count and the shared-memory opt-in once per device, not at every launch (a launch
  // may be inside a CUDA graph capture)
  static int sms_of[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms_of[device] == 0) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(bank_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmemBytes);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    sms_of[device] = sms;
  }
  const int sms = sms_of[device];
  const int ranges = sms / n_banks > 1 ? sms / n_banks : 1;
  bank_mlp_kernel<<<n_banks * ranges, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      p_map, w1_map, static_cast<const float*>(add), static_cast<const __nv_bfloat16*>(w2p),
      static_cast<const float*>(b2), static_cast<float*>(out), R, S, O, n_banks, ranges);
  return static_cast<int>(cudaGetLastError());
}

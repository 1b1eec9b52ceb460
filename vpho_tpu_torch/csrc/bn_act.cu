// K4: the eval trunk's batch norm, residual add and activation in one pass, hand-written for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves batch norm to XLA, which fuses it into the
// convolutions' epilogues.  The port's plain form (models/layers.py::bn_act_plain) is a chain of
// 3-6 kernels at each of the trunk's BN sites: x.float(), cuDNN's inference batch norm in
// float32, the cast back, then the call site's residual add and activation, ~24-34 bytes an
// element moved.  This kernel reads x (and the residual) once and writes y once, and gives the
// chain's numbers bit for bit:
//
//   y = round(BN(float(x)))                          BN as cuDNN's inference kernel computes it
//   y = round(float(y) + float(r))                   with a residual (torch's add in x's dtype)
//   y = y > 0 ? y : round(y * 0.01f)                 leaky (torch's leaky_relu, slope 0.01)
//   y = y < 0 ? 0 : y                                relu
//
// where round is round-to-nearest-even to x's dtype (the identity for float32).  BN is spelt
// as cuDNN's inference kernels spell it on an H100 (cuDNN 9.22, found by matching F.batch_norm's
// float32 output bit for bit, tests/test_torch_port_cuda.py), with inv = rsqrtf(var + eps) and
// eps rounded to float32 first.  The two layouts take two kernels and two formulas:
//
//   NCHW            fma((x - mean) * w, inv, b)
//   channels-last   fma(x, s, t),   s = w * inv,   t = fma(-(mean * w), inv, b)
//
// Every operation is spelt with an intrinsic (__fsub_rn, __fmul_rn, __fmaf_rn, __fadd_rn,
// __float2bfloat16_rn), so nvcc's contraction cannot change a rounding.
//
// Bound: bytes, not operations (~6 flops an element against 4-6 bytes in bf16).  At an eval
// batch of 64 the trunk's 147 sites move ~1.65e9 elements: ~8 GB, ~2.4 ms at 3.35 TB/s.  So:
//   * 16-byte loads and stores of 8 bf16 or 4 float32, two vectors a thread and iteration, and
//     bf16 rounded in pairs (one conversion instruction for two values);
//   * a grid-stride loop of 256-thread blocks, at most two waves of the card's block slots;
//   * contiguous NCHW: a vector lies in one channel when H x W is a multiple of its width, and
//     its channel's scale is computed once for the vector; channels-last: the grid's stride is
//     a multiple of C, so each thread's channels stay the same from vector to vector and their
//     scales are computed once, into registers, before the loop;
//   * any other size, or an address not 16-byte aligned: a scalar loop, one element a thread
//     and iteration, the channel computed per element.
// The layout and the size choose the path; nothing else does.  Indices are 32-bit (the wrapper
// refuses 2^31 elements or more), offsets 64-bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
enum Layout { kNchw = 0, kNhwc = 1 };
enum Path { kVecNchw = 0, kVecNhwc = 1, kScalar = 2 };
enum Act { kNone = 0, kLeaky = 1, kRelu = 2 };

struct Stats {
  const float* mean;
  const float* var;
  const float* w;
  const float* b;
  float eps;
};

// One channel's parameters, per layout: NCHW keeps (mean, w, inv, b), channels-last (s, t).
template <int kLayout>
struct Chan;

template <>
struct Chan<kNchw> {
  float mean, w, inv, b;
  __device__ __forceinline__ Chan(const Stats& st, int c) {
    mean = __ldg(st.mean + c);
    w = __ldg(st.w + c);
    inv = rsqrtf(__fadd_rn(__ldg(st.var + c), st.eps));
    b = __ldg(st.b + c);
  }
  __device__ __forceinline__ float operator()(float x) const {
    return __fmaf_rn(__fmul_rn(__fsub_rn(x, mean), w), inv, b);
  }
};

template <>
struct Chan<kNhwc> {
  float s, t;
  Chan() = default;
  __device__ __forceinline__ Chan(const Stats& st, int c) {
    const float inv = rsqrtf(__fadd_rn(__ldg(st.var + c), st.eps));
    const float w = __ldg(st.w + c);
    s = __fmul_rn(w, inv);
    t = __fmaf_rn(-__fmul_rn(__ldg(st.mean + c), w), inv, __ldg(st.b + c));
  }
  __device__ __forceinline__ float operator()(float x) const { return __fmaf_rn(x, s, t); }
};

template <typename T>
struct Io;

template <>
struct Io<float> {
  static constexpr int kVec = 4;
  __device__ __forceinline__ static float load(float v) { return v; }
  __device__ __forceinline__ static float round(float v) { return v; }
  __device__ __forceinline__ static float store(float v) { return v; }
};

template <>
struct Io<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ __forceinline__ static float load(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ __forceinline__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  // v is already a bf16 value, so the conversion is exact
  __device__ __forceinline__ static __nv_bfloat16 store(float v) { return __float2bfloat16_rn(v); }
};

// The chain at one element: normalize, round, add the residual, round, activate.
template <typename T, int kAct, bool kRes, typename P>
__device__ __forceinline__ T apply(T xv, T rv, const P& p) {
  float y = Io<T>::round(p(Io<T>::load(xv)));
  if (kRes) y = Io<T>::round(__fadd_rn(y, Io<T>::load(rv)));
  if (kAct == kLeaky) y = y > 0.0f ? y : Io<T>::round(__fmul_rn(y, 0.01f));
  if (kAct == kRelu) y = y < 0.0f ? 0.0f : y;
  return Io<T>::store(y);
}

// Two bf16 values rounded to bf16 and back with one paired conversion.
__device__ __forceinline__ float2 round2(float a, float b) {
  return __bfloat1622float2(__floats2bfloat162_rn(a, b));
}

// The same chain at a pair of bf16 elements, each rounding one paired conversion.
template <int kAct, bool kRes, typename P>
__device__ __forceinline__ __nv_bfloat162 apply2(__nv_bfloat162 xv, __nv_bfloat162 rv,
                                                 const P& p0, const P& p1) {
  const float2 xf = __bfloat1622float2(xv);
  float2 y = round2(p0(xf.x), p1(xf.y));
  if (kRes) {
    const float2 rf = __bfloat1622float2(rv);
    y = round2(__fadd_rn(y.x, rf.x), __fadd_rn(y.y, rf.y));
  }
  if (kAct == kLeaky) {
    const float2 l = round2(__fmul_rn(y.x, 0.01f), __fmul_rn(y.y, 0.01f));
    y = make_float2(y.x > 0.0f ? y.x : l.x, y.y > 0.0f ? y.y : l.y);
  }
  if (kAct == kRelu) y = make_float2(y.x < 0.0f ? 0.0f : y.x, y.y < 0.0f ? 0.0f : y.y);
  return __floats2bfloat162_rn(y.x, y.y);   // exact: both are bf16 values
}

// One 16-byte vector; chan(k) gives element k's channel parameters.
template <typename T, int kAct, bool kRes, typename F>
__device__ __forceinline__ uint4 apply_vec(const uint4& a, const uint4& b, const F& chan) {
  uint4 o;
  if constexpr (sizeof(T) == 2) {
    const __nv_bfloat162* av = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* bv = reinterpret_cast<const __nv_bfloat162*>(&b);
    __nv_bfloat162* ov = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      ov[k] = apply2<kAct, kRes>(av[k], bv[k], chan(2 * k), chan(2 * k + 1));
  } else {
    const float* av = reinterpret_cast<const float*>(&a);
    const float* bv = reinterpret_cast<const float*>(&b);
    float* ov = reinterpret_cast<float*>(&o);
#pragma unroll
    for (int k = 0; k < 4; ++k) ov[k] = apply<float, kAct, kRes>(av[k], bv[k], chan(k));
  }
  return o;
}

// n elements of a (N, C, H, W) tensor, hw = H x W; kVecNchw needs hw % kVec == 0, kVecNhwc
// needs C % kVec == 0 and (gridDim.x * kThreads * kVec) % C == 0.  The vector paths take two
// vectors a thread and iteration, one grid stride apart, both loads issued before either is
// used.
template <typename T, int kPath, int kLayout, int kAct, bool kRes>
__global__ void __launch_bounds__(kThreads)
bn_act_kernel(const T* __restrict__ x, const T* __restrict__ r, T* __restrict__ y, Stats s,
              unsigned n, unsigned C, unsigned hw) {
  constexpr int kVec = Io<T>::kVec;
  const unsigned g = blockIdx.x * kThreads + threadIdx.x;
  const unsigned stride = gridDim.x * kThreads;
  if constexpr (kPath == kScalar) {
    for (unsigned i = g; i < n; i += stride) {
      const unsigned c = kLayout == kNchw ? (i / hw) % C : i % C;
      y[i] = apply<T, kAct, kRes>(x[i], kRes ? r[i] : x[i], Chan<kLayout>(s, (int)c));
    }
  } else {
    const unsigned nvec = n / kVec;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    const uint4* rv = reinterpret_cast<const uint4*>(r);
    uint4* yv = reinterpret_cast<uint4*>(y);
    Chan<kNhwc> p[kPath == kVecNhwc ? kVec : 1];
    if constexpr (kPath == kVecNhwc) {  // this thread's channels, the same at every step
      const int c0 = (int)((g * (unsigned long long)kVec) % C);
#pragma unroll
      for (int k = 0; k < kVec; ++k) p[k] = Chan<kNhwc>(s, c0 + k);
    }
    const unsigned per_row = hw / kVec;
    for (unsigned v = g; v < nvec; v += 2 * stride) {
      const unsigned w = v + stride;
      const bool second = w < nvec;
      const uint4 a0 = __ldg(xv + v);
      const uint4 a1 = second ? __ldg(xv + w) : a0;
      const uint4 b0 = kRes ? __ldg(rv + v) : a0;
      const uint4 b1 = kRes && second ? __ldg(rv + w) : a1;
      if constexpr (kPath == kVecNchw) {
        const Chan<kNchw> p0(s, (int)((v / per_row) % C));
        const Chan<kNchw> p1(s, (int)((w / per_row) % C));
        yv[v] = apply_vec<T, kAct, kRes>(a0, b0, [&](int) -> const Chan<kNchw>& { return p0; });
        if (second)
          yv[w] = apply_vec<T, kAct, kRes>(a1, b1, [&](int) -> const Chan<kNchw>& { return p1; });
      } else {
        const auto chan = [&](int k) -> const Chan<kNhwc>& { return p[k]; };
        yv[v] = apply_vec<T, kAct, kRes>(a0, b0, chan);
        if (second) yv[w] = apply_vec<T, kAct, kRes>(a1, b1, chan);
      }
    }
  }
}

// The card's resident 256-thread blocks, read once at the first launch (an eager run, before
// any capture).
int block_slots() {
  static int slots = 0;
  if (slots == 0) {
    int dev = 0, sms = 0, threads = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&threads, cudaDevAttrMaxThreadsPerMultiProcessor, dev);
    slots = (sms > 0 ? sms : 1) * (threads > kThreads ? threads / kThreads : 1);
  }
  return slots;
}

unsigned gcd_u(unsigned a, unsigned b) {
  while (b != 0) {
    const unsigned t = a % b;
    a = b;
    b = t;
  }
  return a;
}

template <typename T, int kPath, int kLayout, int kAct, bool kRes>
int launch(const void* x, const void* r, void* y, const Stats& s, unsigned n, unsigned C,
           unsigned hw, cudaStream_t stream) {
  constexpr int kVec = Io<T>::kVec;
  const unsigned work = kPath == kScalar ? n : (n / kVec + 1) / 2;
  unsigned long long blocks = (work + kThreads - 1) / kThreads;
  const unsigned long long most = 2ull * block_slots();
  if (blocks > most) blocks = most;
  if (kPath == kVecNhwc) {  // a stride of a whole number of rows of C
    const unsigned m = C / gcd_u(C, (unsigned)(kThreads * kVec));
    blocks = (blocks + m - 1) / m * m;
  }
  if (blocks == 0 || blocks > 0x7fffffffull) return (int)cudaErrorInvalidValue;
  bn_act_kernel<T, kPath, kLayout, kAct, kRes><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r), static_cast<T*>(y), s, n, C, hw);
  return (int)cudaGetLastError();
}

template <typename T, int kPath, int kLayout>
int by_act(int act, bool res, const void* x, const void* r, void* y, const Stats& s, unsigned n,
           unsigned C, unsigned hw, cudaStream_t stream) {
#define VPHO_BN_ACT(A)                                                                        \
  return res ? launch<T, kPath, kLayout, A, true>(x, r, y, s, n, C, hw, stream)              \
             : launch<T, kPath, kLayout, A, false>(x, r, y, s, n, C, hw, stream)
  switch (act) {
    case kNone: VPHO_BN_ACT(kNone);
    case kLeaky: VPHO_BN_ACT(kLeaky);
    case kRelu: VPHO_BN_ACT(kRelu);
    default: return (int)cudaErrorInvalidValue;
  }
#undef VPHO_BN_ACT
}

template <typename T>
int by_path(int layout, int act, const void* x, const void* r, void* y, const Stats& s,
            unsigned n, unsigned C, unsigned hw, cudaStream_t stream) {
  constexpr int kVec = Io<T>::kVec;
  const bool res = r != nullptr;
  const uintptr_t bits = (uintptr_t)x | (uintptr_t)y | (uintptr_t)r;
  const bool aligned = bits % 16 == 0;
  if (layout == kNchw) {
    if (aligned && hw % kVec == 0)
      return by_act<T, kVecNchw, kNchw>(act, res, x, r, y, s, n, C, hw, stream);
    return by_act<T, kScalar, kNchw>(act, res, x, r, y, s, n, C, hw, stream);
  }
  if (aligned && C % kVec == 0)
    return by_act<T, kVecNhwc, kNhwc>(act, res, x, r, y, s, n, C, hw, stream);
  return by_act<T, kScalar, kNhwc>(act, res, x, r, y, s, n, C, hw, stream);
}

}  // namespace

// x, residual (or null) and y: n elements of a (N, C, H, W) tensor, hw = H x W, contiguous in
// ``layout`` (0 NCHW, 1 channels-last), all three alike; ``dtype`` 0 float32, 1 bfloat16;
// mean, var, w, b: float32 (C); act 0 none, 1 leaky (0.01), 2 relu.  Launches on ``stream``.
// Returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for arguments out of range.
extern "C" int vpho_bn_act(const void* x, const void* residual, void* y, const void* mean,
                           const void* var, const void* w, const void* b, double eps,
                           long long n, int C, long long hw, int layout, int dtype, int act,
                           void* stream) {
  if (n <= 0 || n > 0x7fffffffll || C <= 0 || hw <= 0 || n % ((long long)C * hw) != 0 ||
      (layout != kNchw && layout != kNhwc) || act < kNone || act > kRelu)
    return (int)cudaErrorInvalidValue;
  const Stats s{static_cast<const float*>(mean), static_cast<const float*>(var),
                static_cast<const float*>(w), static_cast<const float*>(b), (float)eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return by_path<float>(layout, act, x, residual, y, s, (unsigned)n, C, (unsigned)hw, st);
  if (dtype == 1)
    return by_path<__nv_bfloat16>(layout, act, x, residual, y, s, (unsigned)n, C, (unsigned)hw, st);
  return (int)cudaErrorInvalidValue;
}

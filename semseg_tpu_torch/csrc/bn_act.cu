// Batch norm in inference, with the residual add and the activation that
// follow it at the call site, in one pass over the map:
//
//   y = act(round(round(x * w + b) + r)),   w = weight * rsqrt(var + eps),
//                                           b = bias - (mean * weight) * rsqrt(var + eps)
//
// It replaces no TPU kernel: the JAX package leaves batch norm, the add
// and the activation to XLA, which fuses them into the convolution's
// epilogue. In the port the plain chain (ops/norm.py::batch_norm_inference,
// then `out + residual` and F.relu) rebuilt the affine in six small
// launches on every call and made four passes over the map (cast to f32,
// multiply, add, cast back), plus two for the add and one for the
// activation: about 28 bytes moved for every bf16 element, where reading x
// (and r) once and writing y once needs 4 (6 with r).
//
// The arithmetic is the plain chain's, op for op: f32 throughout, each
// product, sum and difference rounded on its own (__fmul_rn, __fadd_rn,
// __fsub_rn, which nvcc never contracts into an FMA), the fold from the
// four (C,) vectors in the same order, the BN's result rounded to the map's
// dtype before the residual is added, and that sum rounded again. So the
// output is bit for bit the plain chain's on the card. The activation is
// applied before the last rounding; ReLU and ReLU6 commute with a rounding
// to nearest (0 and 6 are representable, and rounding keeps order and
// sign), and NaN passes through as F.relu and F.relu6 let it.
//
// What bounds it: bytes. A few operations per element, hundreds of times
// below the card's ridge point. The design keeps 16-byte loads in flight
// and spends nothing per element beyond the affine:
// - The map is channels_last (NHWC-dense), the one layout the port's
//   models and engines hold; the wrapper raises for any other.
// - A vector is 16 bytes of one pixel's channels (8 bf16 or 4 f32). The
//   grid has G = PG * CV threads, CV the vectors of a pixel and PG as many
//   pixel groups as the card holds resident at once (one wave, from the
//   occupancy the runtime reports): thread g takes vectors g, g + G,
//   g + 2G, ..., which all lie on the same channels, so it folds w and b
//   for its VEC channels once, in registers from __ldg of the four
//   vectors, and reuses them for every pixel it visits. Neighbouring
//   threads take neighbouring vectors, so each warp instruction moves 512
//   contiguous bytes. A thread issues 4 vector loads (8 with a residual)
//   before it computes any of them.
// - Where C is not a multiple of VEC or a pointer is not 16-byte aligned,
//   the same kernel runs with VEC = 1 (scalar, still coalesced).
// No shared memory, no atomics; every element is computed the same way
// whichever thread takes it, so repeats agree bit for bit.
//
// Built with nvcc into its own shared library with a plain C interface; see
// semseg_tpu_torch/ops/kernels/bn_act.py for the wrapper.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;     // vectors a thread loads before it computes
constexpr int kMaxDevices = 64;

enum Act { kNone = 0, kRelu = 1, kRelu6 = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// One element: the plain chain's roundings, in its order.
template <typename T, bool RES, int ACT>
__device__ __forceinline__ float bn_one(float x, float w, float b, float r) {
  float y = __fadd_rn(__fmul_rn(x, w), b);
  if (RES) y = __fadd_rn(round_to<T>(y), r);
  if (ACT == kRelu) y = y < 0.f ? 0.f : y;
  if (ACT == kRelu6) y = y < 0.f ? 0.f : (y > 6.f ? 6.f : y);
  return y;
}

// The affine of channel c from the running statistics, as
// batch_norm_inference folds it.
__device__ __forceinline__ void fold(const float* __restrict__ weight,
                                     const float* __restrict__ bias,
                                     const float* __restrict__ mean,
                                     const float* __restrict__ var, float eps, int c,
                                     float& w, float& b) {
  const float wc = __ldg(weight + c);
  const float inv = rsqrtf(__fadd_rn(__ldg(var + c), eps));
  w = __fmul_rn(wc, inv);
  b = __fsub_rn(__ldg(bias + c), __fmul_rn(__fmul_rn(__ldg(mean + c), wc), inv));
}

// VEC elements of T as one load or store: 16 bytes (uint4) when VEC > 1.
template <typename T, int VEC>
struct Pack {
  using Raw = uint4;
  static_assert(VEC * sizeof(T) == 16, "a vector is 16 bytes");
  __device__ __forceinline__ static void unpack(Raw q, float (&f)[VEC]) {
    if constexpr (sizeof(T) == 4) {
      f[0] = __uint_as_float(q.x);
      f[1] = __uint_as_float(q.y);
      f[2] = __uint_as_float(q.z);
      f[3] = __uint_as_float(q.w);
    } else {
      const unsigned u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        f[2 * k] = __uint_as_float(u[k] << 16);
        f[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
      }
    }
  }
  __device__ __forceinline__ static Raw pack(const float (&f)[VEC]) {
    if constexpr (sizeof(T) == 4) {
      return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                        __float_as_uint(f[3]));
    } else {
      unsigned u[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        u[k] = (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * k])) |
               ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * k + 1])) << 16);
      return make_uint4(u[0], u[1], u[2], u[3]);
    }
  }
};

template <typename T>
struct Pack<T, 1> {
  using Raw = T;
  __device__ __forceinline__ static void unpack(Raw q, float (&f)[1]) { f[0] = to_f32(q); }
  __device__ __forceinline__ static Raw pack(const float (&f)[1]) {
    if constexpr (sizeof(T) == 4) {
      return f[0];
    } else {
      return __float2bfloat16_rn(f[0]);
    }
  }
};

// `count` vectors at base + i * stride (i < count <= kUnroll) through the
// affine of w, b, with the residual at the same offsets.
template <typename T, int VEC, bool RES, int ACT>
__device__ __forceinline__ void run_vectors(const typename Pack<T, VEC>::Raw* __restrict__ x,
                                            const typename Pack<T, VEC>::Raw* __restrict__ r,
                                            typename Pack<T, VEC>::Raw* __restrict__ y,
                                            long long base, long long stride, int count,
                                            const float (&w)[VEC], const float (&b)[VEC]) {
  using P = Pack<T, VEC>;
  typename P::Raw xq[kUnroll], rq[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (u < count) {
      xq[u] = x[base + u * stride];
      if (RES) rq[u] = r[base + u * stride];
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (u < count) {
      float xf[VEC], rf[VEC], out[VEC];
      P::unpack(xq[u], xf);
      if (RES) P::unpack(rq[u], rf);
#pragma unroll
      for (int k = 0; k < VEC; ++k) out[k] = bn_one<T, RES, ACT>(xf[k], w[k], b[k], RES ? rf[k] : 0.f);
      y[base + u * stride] = P::pack(out);
    }
  }
}

// Thread g of G = groups * cv takes vectors g + k * G of the
// map's pixels * cv, all on channels (g % cv) * VEC ... + VEC - 1.
template <typename T, int VEC, bool RES, int ACT>
__global__ void __launch_bounds__(kThreads)
bn_act_nhwc_kernel(const T* __restrict__ x, const T* __restrict__ r, T* __restrict__ y,
                   const float* __restrict__ weight, const float* __restrict__ bias,
                   const float* __restrict__ mean, const float* __restrict__ var, float eps,
                   long long pixels, int cv, long long groups) {
  using Raw = typename Pack<T, VEC>::Raw;
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long G = groups * cv;
  if (g >= G) return;
  const int c0 = (int)(g % cv) * VEC;
  float w[VEC], b[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) fold(weight, bias, mean, var, eps, c0 + k, w[k], b[k]);
  const Raw* xv = reinterpret_cast<const Raw*>(x);
  const Raw* rv = reinterpret_cast<const Raw*>(r);
  Raw* yv = reinterpret_cast<Raw*>(y);
  const long long total = pixels * cv;
  long long i = g;
  for (; i + (kUnroll - 1) * G < total; i += kUnroll * G)
    run_vectors<T, VEC, RES, ACT>(xv, rv, yv, i, G, kUnroll, w, b);
  if (i < total)
    run_vectors<T, VEC, RES, ACT>(xv, rv, yv, i, G, (int)((total - 1 - i) / G) + 1, w, b);
}

struct Args {
  const void* x;
  const void* r;
  void* y;
  const float* weight;
  const float* bias;
  const float* mean;
  const float* var;
  float eps;
  long long n, hw;
  int c;
  int device;
  cudaStream_t stream;
};

int sm_count(int device) {
  static std::atomic<int> cached[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return 0;
  int n = cached[device].load(std::memory_order_relaxed);
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
      return 0;
    cached[device].store(n, std::memory_order_relaxed);
  }
  return n;
}

template <typename T, int VEC, bool RES, int ACT>
cudaError_t launch_nhwc(const Args& a) {
  // Resident blocks of this instance per SM, asked once (every card of a
  // host is the same model here; the count depends on the kernel only).
  static const int per_sm = [] {
    int blocks = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, bn_act_nhwc_kernel<T, VEC, RES, ACT>, kThreads, 0) != cudaSuccess)
      blocks = 0;
    return blocks > 0 ? blocks : 1;
  }();
  const int sms = sm_count(a.device);
  if (sms == 0) return cudaErrorInvalidDevice;
  const int cv = a.c / VEC;
  const long long pixels = a.n * a.hw;
  const long long resident = (long long)sms * per_sm * kThreads;
  long long groups = resident / cv;
  if (groups < 1) groups = 1;
  if (groups > pixels) groups = pixels;
  const long long threads = groups * cv;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  bn_act_nhwc_kernel<T, VEC, RES, ACT><<<(unsigned)blocks, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.r), static_cast<T*>(a.y), a.weight,
      a.bias, a.mean, a.var, a.eps, pixels, cv, groups);
  return cudaGetLastError();
}

template <typename T, int VEC, bool RES>
cudaError_t by_act(const Args& a, int act) {
  switch (act) {
    case kNone:
      return launch_nhwc<T, VEC, RES, kNone>(a);
    case kRelu:
      return launch_nhwc<T, VEC, RES, kRelu>(a);
    case kRelu6:
      return launch_nhwc<T, VEC, RES, kRelu6>(a);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t by_shape(const Args& a, int act) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = (reinterpret_cast<uintptr_t>(a.x) | reinterpret_cast<uintptr_t>(a.r) |
                        reinterpret_cast<uintptr_t>(a.y)) % 16 == 0;
  const bool vec = aligned && a.c % kVec == 0;
  const bool res = a.r != nullptr;
  if (vec)
    return res ? by_act<T, kVec, true>(a, act) : by_act<T, kVec, false>(a, act);
  return res ? by_act<T, 1, true>(a, act) : by_act<T, 1, false>(a, act);
}

}  // namespace

extern "C" {

// x, residual (NULL for none) and y are (N, C, H, W) maps dense in
// channels_last (N, H, W, C in memory); weight, bias, mean and var are
// (C,) float32, all on `device`. dtype: 0 = float32, 1 = bfloat16. act:
// 0 none, 1 ReLU, 2 ReLU6. Launches on `stream` (on `device`, made current
// for the launch and restored after), synchronises nothing, and returns
// the cudaError_t of the launch (0 on success; an empty map launches
// nothing).
int bn_act_launch(const void* x, const void* residual, void* y, const void* weight,
                  const void* bias, const void* mean, const void* var, float eps, long long n,
                  int c, long long hw, int dtype, int act, int device, void* stream) {
  if (n < 0 || c < 0 || hw < 0 || act < kNone || act > kRelu6) return (int)cudaErrorInvalidValue;
  if (n == 0 || c == 0 || hw == 0) return (int)cudaSuccess;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return (int)err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess) return (int)err;
  const Args a{x,
               residual,
               y,
               static_cast<const float*>(weight),
               static_cast<const float*>(bias),
               static_cast<const float*>(mean),
               static_cast<const float*>(var),
               eps,
               n,
               hw,
               c,
               device,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0)
    err = by_shape<float>(a, act);
  else if (dtype == 1)
    err = by_shape<__nv_bfloat16>(a, act);
  else
    err = cudaErrorInvalidValue;
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}

}  // extern "C"

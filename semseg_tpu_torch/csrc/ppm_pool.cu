// Pyramid pooling for the PPM head: the adaptive-average-pool grids
// 1, 2, 3 and 6 of one NHWC map, from a single read of the map.
//
// Replaces semseg_tpu/ops/pallas/ppm_pool.py::pyramid_pool (body
// _squeeze_kernel, bins _bin_bounds). Bin i of s over H spans
// [floor(i*H/s), ceil((i+1)*H/s)) (PyTorch's adaptive-pool bins; they
// overlap when s does not divide H). Sums are f32; each of the 50 bin
// means per channel is rounded once to the input dtype.
//
// What bounds it: bytes. The map is read once (30.7 MB for a bf16
// (1, 75, 100, 2048) conv5 map) and 50 values per channel are written, so
// the arithmetic is a few adds per element read.
//
// Design. Pass 1 (ppm_partial_kernel): a block covers one sample, 64
// channels (one thread each, so a warp reads 32 neighbouring channels of
// one pixel) and a band of rows. A thread walks its band once; per row it
// sums its channel into the 12 column bins (1 + 2 + 3 + 6), then adds
// those into every row bin of every scale that holds the row. The 50
// partial sums live in registers (every loop is unrolled over the fixed
// scales) and go to an f32 scratch of shape (bands, N, 50, C). The row
// bands exist to fill the card's SMs: one block per (sample, channel
// tile) would give 32 blocks at N = 1, C = 2048. Pass 2
// (ppm_combine_kernel) sums the bands in a fixed order, divides by the
// bin area and writes the four outputs. No atomics, so repeated runs
// agree bit for bit.
//
// Pad-aware form. With a per-sample extents array valid_hw ((N, 2) int32
// on the device), sample n is pooled over [0, vh) x [0, vw) only: the
// bins are those of an unpadded vh x vw map, and no row or column past
// the extent is read. That is semseg_tpu/ops/resize_dynamic.py::
// adaptive_avg_pool2d_valid at the four scales, which the batched engines
// call on padded bucket canvases. Each block reads its sample's extent
// from the device array, so nothing syncs to the host and the grid (bands
// over the padded H) depends on shapes only; a band past vh writes zeros.
// Extents are clamped to the canvas and a bin's area to at least 1, so an
// empty extent pools to 0 as the matrix form does.
//
// Built with nvcc into a shared library with a plain C interface; see
// semseg_tpu_torch/ops/kernels/ppm_pool.py for the wrapper.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;     // channels per block
constexpr int kBins = 50;        // 1 + 4 + 9 + 36
constexpr int kColBins = 12;     // 1 + 2 + 3 + 6
constexpr int kTargetBlocks = 4 * 132;  // about four blocks per SM

// Scale si (0..3) of the fixed pyramid (1, 2, 3, 6), the offset of its
// first bin among the 50, and of its first column bin among the 12. They
// are functions so that unrolled loops see constants and keep every
// partial sum in a register.
__host__ __device__ constexpr int scale_of(int si) {
  return si == 0 ? 1 : si == 1 ? 2 : si == 2 ? 3 : 6;
}
__host__ __device__ constexpr int bin_offset(int si) {
  return si == 0 ? 0 : si == 1 ? 1 : si == 2 ? 5 : 14;
}
__host__ __device__ constexpr int col_offset(int si) {
  return si == 0 ? 0 : si == 1 ? 1 : si == 2 ? 3 : 6;
}

__host__ __device__ inline int bin_start(int i, int size, int s) {
  return (i * size) / s;
}

__host__ __device__ inline int bin_end(int i, int size, int s) {
  return ((i + 1) * size + s - 1) / s;
}

inline int rows_per_band(int n, int h, int c) {
  const int ctiles = (c + kThreads - 1) / kThreads;
  const int per_row = n * ctiles;
  int bands = (kTargetBlocks + per_row - 1) / per_row;
  if (bands > h) bands = h;
  if (bands < 1) bands = 1;
  return (h + bands - 1) / bands;
}

inline int num_bands(int n, int h, int c) {
  const int rows = rows_per_band(n, h, c);
  return (h + rows - 1) / rows;
}

__device__ inline float load_f32(const float* p) { return *p; }
__device__ inline float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ inline void store_from_f32(float* p, float v) { *p = v; }
__device__ inline void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int SI>
__device__ __forceinline__ void col_bounds(int (&cs)[kColBins],
                                           int (&ce)[kColBins], int w) {
  constexpr int s = scale_of(SI);
#pragma unroll
  for (int j = 0; j < s; ++j) {
    cs[col_offset(SI) + j] = bin_start(j, w, s);
    ce[col_offset(SI) + j] = bin_end(j, w, s);
  }
}

// Adds row r's column-bin sums into every bin of scale SI that holds r.
template <int SI>
__device__ __forceinline__ void add_row(float (&acc)[kBins],
                                        const float (&col)[kColBins], int r,
                                        int h) {
  constexpr int s = scale_of(SI);
#pragma unroll
  for (int i = 0; i < s; ++i) {
    if (r >= bin_start(i, h, s) && r < bin_end(i, h, s)) {
#pragma unroll
      for (int j = 0; j < s; ++j) {
        acc[bin_offset(SI) + i * s + j] += col[col_offset(SI) + j];
      }
    }
  }
}

// Sample n's pooled extent: (h, w) for the dense form, else its entry of
// valid_hw clamped to [0, h] x [0, w]. The form is a template argument:
// with a runtime test instead, the dense form ran 25-55% slower than the
// kernel without a valid form (same registers, H100 80GB HBM3).
template <bool kValid>
__device__ __forceinline__ void extent(const int* __restrict__ valid_hw,
                                       int n, int h, int w, int& vh,
                                       int& vw) {
  vh = h;
  vw = w;
  if constexpr (kValid) {
    vh = min(max(valid_hw[2 * n], 0), h);
    vw = min(max(valid_hw[2 * n + 1], 0), w);
  }
}

template <typename T, bool kValid>
__global__ void ppm_partial_kernel(const T* __restrict__ x,
                                   const int* __restrict__ valid_hw,
                                   float* __restrict__ scratch, int n_batch,
                                   int h, int w, int c, int rows) {
  const int ch = blockIdx.x * kThreads + threadIdx.x;
  const int band = blockIdx.y;
  const int n = blockIdx.z;
  if (ch >= c) return;
  int vh, vw;
  extent<kValid>(valid_hw, n, h, w, vh, vw);
  const int r0 = band * rows;
  const int r1 = min(vh, r0 + rows);

  float acc[kBins];
#pragma unroll
  for (int k = 0; k < kBins; ++k) acc[k] = 0.f;

  // Column-bin bounds depend only on the extent's width; the scales are
  // compile-time.
  int cs[kColBins], ce[kColBins];
  col_bounds<0>(cs, ce, vw);
  col_bounds<1>(cs, ce, vw);
  col_bounds<2>(cs, ce, vw);
  col_bounds<3>(cs, ce, vw);

  const size_t row_stride = (size_t)w * c;
  const T* base = x + (size_t)n * h * row_stride + ch;
  for (int r = r0; r < r1; ++r) {
    float col[kColBins];
#pragma unroll
    for (int k = 0; k < kColBins; ++k) col[k] = 0.f;
    const T* row = base + (size_t)r * row_stride;
#pragma unroll 4
    for (int q = 0; q < vw; ++q) {
      const float v = load_f32(row + (size_t)q * c);
#pragma unroll
      for (int k = 0; k < kColBins; ++k) {
        if (q >= cs[k] && q < ce[k]) col[k] += v;
      }
    }
    add_row<0>(acc, col, r, vh);
    add_row<1>(acc, col, r, vh);
    add_row<2>(acc, col, r, vh);
    add_row<3>(acc, col, r, vh);
  }

  float* out = scratch + ((size_t)band * n_batch + n) * kBins * c + ch;
#pragma unroll
  for (int k = 0; k < kBins; ++k) out[(size_t)k * c] = acc[k];
}

template <typename T, bool kValid>
__global__ void ppm_combine_kernel(const float* __restrict__ scratch,
                                   const int* __restrict__ valid_hw,
                                   T* __restrict__ o1, T* __restrict__ o2,
                                   T* __restrict__ o3, T* __restrict__ o6,
                                   int n_batch, int h, int w, int c,
                                   int bands) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)n_batch * kBins * c;
  if (idx >= total) return;
  const int ch = (int)(idx % c);
  const int k = (int)((idx / c) % kBins);
  const int n = (int)(idx / ((size_t)c * kBins));

  float sum = 0.f;
  const size_t band_stride = (size_t)n_batch * kBins * c;
  const float* p = scratch + ((size_t)n * kBins + k) * c + ch;
  for (int b = 0; b < bands; ++b) sum += p[(size_t)b * band_stride];

  int si = 3;
  if (k < bin_offset(1)) si = 0;
  else if (k < bin_offset(2)) si = 1;
  else if (k < bin_offset(3)) si = 2;
  const int s = scale_of(si);
  const int local = k - bin_offset(si);
  const int i = local / s;
  const int j = local % s;
  int vh, vw;
  extent<kValid>(valid_hw, n, h, w, vh, vw);
  const int area = max((bin_end(i, vh, s) - bin_start(i, vh, s)) *
                           (bin_end(j, vw, s) - bin_start(j, vw, s)),
                       1);
  T* out = si == 0 ? o1 : si == 1 ? o2 : si == 2 ? o3 : o6;
  store_from_f32(out + (((size_t)n * s + i) * s + j) * c + ch,
                 sum / (float)area);
}

template <typename T, bool kValid>
cudaError_t launch(const void* x, void* o1, void* o2, void* o3, void* o6,
                   float* scratch, const int* valid_hw, int n, int h, int w,
                   int c, cudaStream_t stream) {
  const int rows = rows_per_band(n, h, c);
  const int bands = num_bands(n, h, c);
  dim3 grid1((c + kThreads - 1) / kThreads, bands, n);
  ppm_partial_kernel<T, kValid><<<grid1, kThreads, 0, stream>>>(
      static_cast<const T*>(x), valid_hw, scratch, n, h, w, c, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = (size_t)n * kBins * c;
  const int threads2 = 256;
  const unsigned blocks2 = (unsigned)((total + threads2 - 1) / threads2);
  ppm_combine_kernel<T, kValid><<<blocks2, threads2, 0, stream>>>(
      scratch, valid_hw, static_cast<T*>(o1), static_cast<T*>(o2),
      static_cast<T*>(o3), static_cast<T*>(o6), n, h, w, c, bands);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// f32 elements of scratch that ppm_pool_launch needs for this shape.
long long ppm_pool_scratch_floats(int n, int h, int w, int c) {
  (void)w;
  return (long long)num_bands(n, h, c) * n * kBins * c;
}

// dtype: 0 = float32, 1 = bfloat16. x is (N, H, W, C) contiguous; the
// outputs are (N, s, s, C) contiguous for s = 1, 2, 3, 6. valid_hw is
// NULL (dense form) or an (N, 2) int32 device array of extents. Returns
// the cudaError_t of the launches (0 on success).
int ppm_pool_launch(const void* x, void* o1, void* o2, void* o3, void* o6,
                    void* scratch, const void* valid_hw, int n, int h, int w,
                    int c, int dtype, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  const int* v = static_cast<const int*>(valid_hw);
  using bf16 = __nv_bfloat16;
  if (dtype == 0 && v == nullptr)
    return (int)launch<float, false>(x, o1, o2, o3, o6, sc, v, n, h, w, c, s);
  if (dtype == 0)
    return (int)launch<float, true>(x, o1, o2, o3, o6, sc, v, n, h, w, c, s);
  if (dtype == 1 && v == nullptr)
    return (int)launch<bf16, false>(x, o1, o2, o3, o6, sc, v, n, h, w, c, s);
  if (dtype == 1)
    return (int)launch<bf16, true>(x, o1, o2, o3, o6, sc, v, n, h, w, c, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

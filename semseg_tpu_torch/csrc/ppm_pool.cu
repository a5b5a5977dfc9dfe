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
// (1, 75, 100, 2048) conv5 map) and 50 values per channel are written.
// It does about one add per element read, hundreds of times below the
// card's ridge point, so tensor cores do not apply: the design is about
// keeping enough 16-byte loads in flight to cover device-memory latency
// on 132 SMs, with as few instructions per element as possible.
//
// Segments. Every bin boundary of the four scales is a boundary of
// scale 6 (floor(i*H/s) = floor((6i/s)*H/6)), so the starts and ends of
// the six scale-6 bins, at most 12 distinct values, cut [0, H) into at
// most 11 row segments; likewise the columns. Inside one row segment
// every row lies in the same bins, inside one column segment every
// column does, so each (row segment, column segment) cell lies wholly
// inside or wholly outside each of the 50 bins. For H = 75 the row
// boundaries are {0, 12, 13, 25, 37, 38, 50, 62, 63, 75}: 9 segments.
//
// Pass 1 (ppm_cells_kernel) sums the cells. A block takes one cell of
// one sample and a tile of 32 * V channels, V = 16 bytes / element (8 in
// bf16, 4 in f32): a warp's lane reads V neighbouring channels with one
// 16-byte load, so a warp reads 512 contiguous bytes of one pixel. The
// block's 8 warps take the cell's pixels in turn (pixel p of the cell in
// row-major order goes to warp p % 8), and each thread issues 8 such
// loads before it adds any of them, which keeps up to 32 KB in flight
// per block. Each element costs one add (bf16 also a shift or a mask to
// widen it). The 8 warps' sums meet in shared memory in a fixed order
// and go to an f32 scratch of shape (N, RS, CS, C), RS and CS the most
// segments any extent of the canvas has. Cells hold at most a few
// hundred pixels, so the grid has many small blocks (720 at a bf16
// (1, 75, 100, 2048) map), which the block scheduler spreads over the
// SMs; no thread walks more than (cell pixels / 8) loads.
//
// Pass 2 (ppm_combine_kernel) gives each bin its cells: the bin's rows
// and columns are whole segments, found by ranking its bounds among the
// segment boundaries. A block takes one sample and 32 channels (a lane
// each). Warp a loads row segment a's cells at once and sums them over
// each of the 12 column bins (1 + 2 + 3 + 6) into shared memory; warp kr
// then sums those over the row segments of row bin kr, divides by the
// bin area and writes the output. Loops run over all 11 possible
// segments with the ones outside a bin adding 0, so every load is issued
// before the adds and each sum has a fixed order. No atomics, so repeated
// runs agree bit for bit. (One thread per bin and channel summing its
// cells from L2 reads each cell about five times, and loops over runtime
// spans leave each warp a long chain of dependent loads; both made the
// combine slower than this.) A single launch with a last-block-done
// combine would leave a channel tile's 50 bins of every cell to one
// block; two launches keep the combine as wide as the card, and pass 2
// goes out as a programmatic dependent launch of pass 1
// (griddepcontrol): its blocks are scheduled while pass 1 drains and
// wait inside the kernel for the scratch, which hides most of the second
// launch.
//
// Plain 16-byte loads rather than a TMA / cp.async ring: a cell's pixels
// are scattered rows of 512-byte pieces, each thread issues all of its
// independent loads before it waits, and a thread's data is never
// reused, so a shared-memory ring would add a copy and barriers without
// adding bytes in flight.
//
// Where C is not a multiple of V or the map's address is not 16-byte
// aligned, the same kernel reads with scalar loads (lane t of a warp on
// channel t + 32 j, so each load instruction is still coalesced).
//
// Pad-aware form. With a per-sample extents array valid_hw ((N, 2) int32
// on the device), sample n is pooled over [0, vh) x [0, vw) only: the
// bins are those of an unpadded vh x vw map, and no row or column past
// the extent is read. That is semseg_tpu/ops/resize_dynamic.py::
// adaptive_avg_pool2d_valid at the four scales, which the batched engines
// call on padded bucket canvases. Each block derives its sample's
// segments from the device array, so nothing syncs to the host: the grid
// holds RS * CS cells per sample and a block whose cell lies past its
// sample's segments exits. Extents are clamped to the canvas and a bin's
// area to at least 1, so an empty extent (no segments) pools to 0.
//
// Built with nvcc into a shared library with a plain C interface; see
// semseg_tpu_torch/ops/kernels/ppm_pool.py for the wrapper.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>

namespace {

constexpr int kCands = 12;      // starts and ends of the six scale-6 bins
constexpr int kMaxSegs = 11;    // at most 12 distinct boundaries
constexpr int kWarps = 8;       // warps of a pass-1 block, on separate pixels
constexpr int kUnroll = 8;      // loads a thread issues before it adds

__host__ __device__ constexpr int scale_of(int si) {
  return si == 0 ? 1 : si == 1 ? 2 : si == 2 ? 3 : 6;
}
// The first of scale si's bins among the 12 bins of one axis (1 + 2 + 3 + 6).
__host__ __device__ constexpr int first_1d_bin(int si) {
  return si == 0 ? 0 : si == 1 ? 1 : si == 2 ? 3 : 6;
}

__host__ __device__ inline int bin_start(int i, int size, int s) {
  return (i * size) / s;
}

__host__ __device__ inline int bin_end(int i, int size, int s) {
  return ((i + 1) * size + s - 1) / s;
}

// Boundary candidate l (0..11) of an extent v: the start (l < 6) or the
// end (l >= 6) of scale-6 bin l % 6.
__host__ __device__ inline int candidate(int l, int v) {
  return l < 6 ? bin_start(l, v, 6) : bin_end(l - 6, v, 6);
}

// Segments of an extent v (0 for an empty one).
int num_segments(int v) {
  int c[kCands];
  for (int l = 0; l < kCands; ++l) c[l] = candidate(l, v);
  std::sort(c, c + kCands);
  return (int)(std::unique(c, c + kCands) - c) - 1;
}

// The most segments any extent v <= size has (11 from v = 11 on).
int max_segments(int size) {
  int m = 0;
  for (int v = 0; v <= std::min(size, kMaxSegs); ++v) m = std::max(m, num_segments(v));
  return m;
}

// One warp: lane l < 12 holds candidate l of v, and `first` says whether
// it is the first lane holding that value.
__device__ __forceinline__ void candidates(int v, int& c, bool& first) {
  const int lane = threadIdx.x & 31;
  c = lane < kCands ? candidate(lane, v) : INT_MAX;
  const unsigned same = __match_any_sync(0xffffffffu, c);
  first = lane < kCands && __ffs(same) - 1 == lane;
}

// One warp: writes the sorted distinct boundaries of v to b[0..n] and
// returns n, the number of segments.
__device__ int segment_bounds(int v, int* b) {
  int c;
  bool first;
  candidates(v, c, first);
  const unsigned firsts = __ballot_sync(0xffffffffu, first);
  int rank = 0;
#pragma unroll
  for (int m = 0; m < kCands; ++m) {
    const int cm = __shfl_sync(0xffffffffu, c, m);
    rank += ((firsts >> m) & 1u) && cm < c;
  }
  if (first) b[rank] = c;
  return __popc(firsts) - 1;
}

// One warp: the segments [span[k][0], span[k][1]) that make up bin k of
// the 12 one-dimensional bins of v (scales 1, 2, 3, 6 in order); returns
// the number of segments. A bound's segment index is its rank among the
// distinct boundaries.
__device__ int bin_spans(int v, int (*span)[2]) {
  int c;
  bool first;
  candidates(v, c, first);
  const unsigned firsts = __ballot_sync(0xffffffffu, first);
#pragma unroll
  for (int k = 0; k < kCands; ++k) {
    const int si = k < 1 ? 0 : k < 3 ? 1 : k < 6 ? 2 : 3;
    const int s = scale_of(si), i = k - first_1d_bin(si);
    const int lo = __popc(__ballot_sync(0xffffffffu, first && c < bin_start(i, v, s)));
    const int hi = __popc(__ballot_sync(0xffffffffu, first && c < bin_end(i, v, s)));
    if ((threadIdx.x & 31) == 0) {
      span[k][0] = lo;
      span[k][1] = hi;
    }
  }
  return __popc(firsts) - 1;
}

__device__ inline float to_f32(float v) { return v; }
__device__ inline float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ inline void store_from_f32(float* p, float v) { *p = v; }
__device__ inline void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Adds the V elements of a 16-byte load to acc.
__device__ __forceinline__ void add16(float (&acc)[4], uint4 q, float) {
  acc[0] += __uint_as_float(q.x);
  acc[1] += __uint_as_float(q.y);
  acc[2] += __uint_as_float(q.z);
  acc[3] += __uint_as_float(q.w);
}
__device__ __forceinline__ void add_pair(float& lo, float& hi, unsigned u) {
  lo += __uint_as_float(u << 16);          // bf16 -> f32 is exact
  hi += __uint_as_float(u & 0xffff0000u);
}
__device__ __forceinline__ void add16(float (&acc)[8], uint4 q, __nv_bfloat16) {
  add_pair(acc[0], acc[1], q.x);
  add_pair(acc[2], acc[3], q.y);
  add_pair(acc[4], acc[5], q.z);
  add_pair(acc[6], acc[7], q.w);
}

// Sample n's pooled extent: (h, w) for the dense form, else its entry of
// valid_hw clamped to [0, h] x [0, w]. The form is a template argument:
// with a runtime test instead, the earlier band kernel ran 25-55% slower
// in the dense form (H100 80GB HBM3).
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

// Pass 1: block (cell, channel tile, sample), 32 x kWarps threads.
template <typename T, bool kValid, bool kVec>
__global__ void __launch_bounds__(32 * kWarps)
ppm_cells_kernel(const T* __restrict__ x, const int* __restrict__ valid_hw,
                 float* __restrict__ scratch, int h, int w, int c,
                 int grid_cs, int rs, int cs) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kTile = 32 * V;
  __shared__ int rb[kCands], cb[kCands], nseg[2];
  __shared__ float red[kWarps][kTile];

  // Pass 2 may start its set-up once every block of this pass runs.
  asm volatile("griddepcontrol.launch_dependents;");
  const int n = blockIdx.z;
  const int tx = threadIdx.x, ty = threadIdx.y;
  int vh, vw;
  extent<kValid>(valid_hw, n, h, w, vh, vw);
  if (ty < 2) {
    const int k = segment_bounds(ty == 0 ? vh : vw, ty == 0 ? rb : cb);
    if (tx == 0) nseg[ty] = k;
  }
  __syncthreads();
  const int a = blockIdx.x / grid_cs, b = blockIdx.x % grid_cs;
  if (a >= nseg[0] || b >= nseg[1]) return;  // the same for the whole block

  const int r0 = rb[a], c0 = cb[b];
  const int cw = cb[b + 1] - c0;
  const int pixels = (rb[a + 1] - r0) * cw;
  const int tile0 = blockIdx.y * kTile;
  const size_t row_stride = (size_t)w * c;
  const T* base = x + ((size_t)n * h + r0) * row_stride + (size_t)c0 * c + tile0 +
                  (kVec ? tx * V : tx);

  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.f;
  bool live[V];  // which of this thread's channels exist
#pragma unroll
  for (int j = 0; j < V; ++j)
    live[j] = kVec ? tile0 + tx * V < c : tile0 + j * 32 + tx < c;

  // This thread's pixels: ty, ty + kWarps, ... of the cell, row-major;
  // (pr, pc) is the next one's row and column inside the cell.
  int pr = ty / cw, pc = ty % cw;
  const int dr = kWarps / cw, dc = kWarps % cw;
  // Pixels per round: kUnroll 16-byte loads, or 16 scalar ones (more
  // scalar loads per round ran slower on the card).
  constexpr int kPix = kVec ? kUnroll : 16 / V;
  for (int p0 = ty; p0 < pixels; p0 += kWarps * kPix) {
    if constexpr (kVec) {
      uint4 q[kPix];
#pragma unroll
      for (int u = 0; u < kPix; ++u) {
        q[u] = make_uint4(0u, 0u, 0u, 0u);
        if (live[0] && p0 + u * kWarps < pixels)
          q[u] = __ldg(reinterpret_cast<const uint4*>(
              base + (size_t)pr * row_stride + (size_t)pc * c));
        pr += dr;
        pc += dc;
        if (pc >= cw) {
          pc -= cw;
          ++pr;
        }
      }
#pragma unroll
      for (int u = 0; u < kPix; ++u) add16(acc, q[u], T());
    } else {
      float q[kPix][V];
#pragma unroll
      for (int u = 0; u < kPix; ++u) {
        const bool in = p0 + u * kWarps < pixels;
        const T* px = base + (size_t)pr * row_stride + (size_t)pc * c;
#pragma unroll
        for (int j = 0; j < V; ++j)
          q[u][j] = in && live[j] ? to_f32(px[j * 32]) : 0.f;
        pr += dr;
        pc += dc;
        if (pc >= cw) {
          pc -= cw;
          ++pr;
        }
      }
#pragma unroll
      for (int u = 0; u < kPix; ++u)
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j] += q[u][j];
    }
  }

#pragma unroll
  for (int j = 0; j < V; ++j) red[ty][kVec ? tx * V + j : j * 32 + tx] = acc[j];
  __syncthreads();
  for (int t = ty * 32 + tx; t < kTile && tile0 + t < c; t += 32 * kWarps) {
    float sum = 0.f;
#pragma unroll
    for (int y = 0; y < kWarps; ++y) sum += red[y][t];
    scratch[(((size_t)n * rs + a) * cs + b) * c + tile0 + t] = sum;
  }
}

// Bin means of one row bin kr (scale S) and 32 channels: the sums over
// the row segments of kr of each column bin of scale S, from shared
// memory, every load issued before the adds.
template <int S, typename T>
__device__ __forceinline__ void row_bin_means(
    float (*colsum)[kCands][32], int (*rspan)[2], int kr, int n,
    int vh, int vw, int c, int ch, T* __restrict__ out) {
  constexpr int si = S == 1 ? 0 : S == 2 ? 1 : S == 3 ? 2 : 3;
  const int i = kr - first_1d_bin(si);
  const int lo = rspan[kr][0], hi = rspan[kr][1];
  float sum[S];
#pragma unroll
  for (int j = 0; j < S; ++j) sum[j] = 0.f;
#pragma unroll
  for (int a = 0; a < kMaxSegs; ++a) {
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const float v = colsum[a][first_1d_bin(si) + j][threadIdx.x];
      sum[j] += a >= lo && a < hi ? v : 0.f;
    }
  }
  if (ch >= c) return;
  const int rows = bin_end(i, vh, S) - bin_start(i, vh, S);
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int area = max(rows * (bin_end(j, vw, S) - bin_start(j, vw, S)), 1);
    store_from_f32(out + (((size_t)n * S + i) * S + j) * c + ch, sum[j] / (float)area);
  }
}

// Pass 2: block (32-channel tile, sample), 12 warps, lane = channel.
// Warp a < (row segments) loads its row's cells, all at once, and sums
// them over each of the 12 column bins; warp kr then sums those over the
// row segments of row bin kr for the column bins of kr's scale. Each sum
// runs in a fixed order over the segments, and every loop is unrolled
// to the most segments, with the ones outside a bin adding 0, so that
// the loads overlap.
template <typename T, bool kValid>
__global__ void __launch_bounds__(32 * kCands)
ppm_combine_kernel(const float* __restrict__ scratch,
                   const int* __restrict__ valid_hw, T* __restrict__ o1,
                   T* __restrict__ o2, T* __restrict__ o3, T* __restrict__ o6,
                   int h, int w, int c, int rs, int cs) {
  __shared__ int rspan[kCands][2], cspan[kCands][2], nseg[2];
  __shared__ float colsum[kMaxSegs][kCands][32];  // (row segment, column bin)
  const int n = blockIdx.y;
  const int lane = threadIdx.x, wy = threadIdx.y;
  const int ch = blockIdx.x * 32 + lane;
  int vh, vw;
  extent<kValid>(valid_hw, n, h, w, vh, vw);
  if (wy < 2) {
    const int k = bin_spans(wy == 0 ? vh : vw, wy == 0 ? rspan : cspan);
    if (lane == 0) nseg[wy] = k;
  }
  __syncthreads();
  const int nr = nseg[0], nc = nseg[1];
  // Pass 1 has finished and its scratch is visible from here on.
  asm volatile("griddepcontrol.wait;" ::: "memory");

  if (wy < kMaxSegs) {
    const int a = wy;
    const float* p = scratch + (((size_t)n * rs + a) * cs) * c + ch;
    float q[kMaxSegs];
#pragma unroll
    for (int b = 0; b < kMaxSegs; ++b)
      q[b] = a < nr && b < nc && ch < c ? p[(size_t)b * c] : 0.f;
#pragma unroll
    for (int k = 0; k < kCands; ++k) {
      const int lo = cspan[k][0], hi = cspan[k][1];
      float sum = 0.f;
#pragma unroll
      for (int b = 0; b < kMaxSegs; ++b) sum += b >= lo && b < hi ? q[b] : 0.f;
      colsum[a][k][lane] = sum;  // 0 for a row past the sample's segments
    }
  }
  __syncthreads();

  const int kr = wy;
  if (kr < 1)
    row_bin_means<1>(colsum, rspan, kr, n, vh, vw, c, ch, static_cast<T*>(o1));
  else if (kr < 3)
    row_bin_means<2>(colsum, rspan, kr, n, vh, vw, c, ch, static_cast<T*>(o2));
  else if (kr < 6)
    row_bin_means<3>(colsum, rspan, kr, n, vh, vw, c, ch, static_cast<T*>(o3));
  else
    row_bin_means<6>(colsum, rspan, kr, n, vh, vw, c, ch, static_cast<T*>(o6));
}

template <typename T, bool kValid, bool kVec>
cudaError_t launch_cells(const T* x, float* scratch, const int* valid_hw,
                         int n, int h, int w, int c, int rs, int cs,
                         cudaStream_t stream) {
  constexpr int kTile = 32 * (16 / sizeof(T));
  // Dense: exactly the map's cells. Valid: room for any extent's cells.
  const int grid_rs = kValid ? rs : num_segments(h);
  const int grid_cs = kValid ? cs : num_segments(w);
  dim3 grid(grid_rs * grid_cs, (c + kTile - 1) / kTile, n);
  ppm_cells_kernel<T, kValid, kVec><<<grid, dim3(32, kWarps), 0, stream>>>(
      x, valid_hw, scratch, h, w, c, grid_cs, rs, cs);
  return cudaGetLastError();
}

template <typename T, bool kValid>
cudaError_t launch(const void* xv, void* o1, void* o2, void* o3, void* o6,
                   float* scratch, const int* valid_hw, int n, int h, int w,
                   int c, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const int rs = max_segments(h), cs = max_segments(w);
  constexpr int V = 16 / sizeof(T);
  const bool vec = c % V == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  cudaError_t err =
      vec ? launch_cells<T, kValid, true>(x, scratch, valid_hw, n, h, w, c, rs, cs, stream)
          : launch_cells<T, kValid, false>(x, scratch, valid_hw, n, h, w, c, rs, cs, stream);
  if (err != cudaSuccess) return err;
  // Pass 2 is launched as a programmatic dependent of pass 1: its blocks
  // may be scheduled while pass 1 drains, and wait inside the kernel
  // (griddepcontrol.wait) before they read the scratch.
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((c + 31) / 32, n);
  cfg.blockDim = dim3(32, kCands);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ppm_combine_kernel<T, kValid>, (const float*)scratch,
                           valid_hw, static_cast<T*>(o1), static_cast<T*>(o2),
                           static_cast<T*>(o3), static_cast<T*>(o6), h, w, c, rs, cs);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" {

// f32 elements of scratch that ppm_pool_launch needs for this shape.
long long ppm_pool_scratch_floats(int n, int h, int w, int c) {
  return (long long)n * max_segments(h) * max_segments(w) * c;
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

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
// Band form (ppm_band_kernel, one launch), for a map whose rows are split
// across devices (cli.eval --spatial; the JAX package lets GSPMD shard the
// pool's input by height): x holds rows [row0, row0 + hb) of an H-row map,
// and the kernel writes, for each of the 50 bins over sample n's valid
// extent, the f32 SUM of the bin's elements that lie in those rows, (N,
// 50, C) in the order scale 1, 2, 3, 6 and (i, j) row-major. The caller
// adds the bands' sums and divides by the bin areas. The segments are the
// whole extent's (from H, not hb, derived on the device from valid_hw) and
// each is clipped to the band's rows, so a bin that straddles bands is
// summed exactly once across them. What bounds it: the band's bytes inside
// the extent, 7.8 MB for a quarter of the bf16 flagship's conv5, 2.4 us
// at 3.35 TB/s, a few DRAM latencies; so the design keeps every byte in
// flight at once, reduces on chip, and overlaps the reduction with the
// copy. The grid is sized by the band and the channels, never by the
// canvas's cells: a block takes 16 channels of one sample (128 blocks at
// C = 2048). Four of its 16 warps copy the channels' 32 (bf16) or 64 (f32)
// bytes of every valid pixel of the band into shared memory with 16-byte
// cp.async, in four row groups, each group's arrival counted on its own
// mbarrier (cp.async.mbarrier.arrive); a band too tall for shared memory
// goes in rounds of rows. The other 12 warps derive the segments and, as
// each group arrives, sum it in two separable steps: each column over a
// row segment's rows (a thread per column and 16-byte vector), then each
// column segment's columns (a warp per segment, a lane per channel and
// half of the columns). The block then adds the cells into the 50 bins as
// pass 2 does. One launch, nothing in device memory but the sums, no
// atomics, every sum in a fixed order: repeats agree bit for bit. Odd C or
// an unaligned map is staged element by element. (A cluster of blocks per
// 128 or 32 channels, adding their cell sums through distributed shared
// memory, and a warp per cell were slower: PERF.md, section 6.)
//
// Backward (ppm_pool_backward_kernel), for training through the dense
// form: grad_x[n, h, w, c] = sum over the scales s and the bins (i, j) of
// s that hold (h, w) of g_s[n, i, j, c] / area_s(i, j), summed in f32 in
// the order scale 1, 2, 3, 6 and (i, j) row-major, rounded once to the
// input dtype. The JAX package has no backward for its Pallas kernel (it
// differentiates XLA's integral-image pool, semseg_tpu/ops/pool.py:55,
// which gives the same sum). Each term is g times the bin's reciprocal
// area, which the host computes and rounds once (50 floats passed with the
// launch; a division per term called the IEEE division's slow path and
// made the scalar f32 form spill). The sum is constant over each of the
// cells above, since a cell lies wholly inside or outside every bin. What
// bounds it: the bytes of grad_x written (N * H * W * C elements; the bin
// gradients are 50 * C per sample); it reads nothing per pixel. On a small
// map (the flagship's batch-2 conv5, (2, 40, 56)) a cell is ~22 pixels,
// and a block per cell spent its time on set-up and dependent gathers,
// not on stores. A block here takes rows of one row segment of one sample
// (at most 128 KB of grad_x, at least two blocks an SM) and a tile of 32 *
// V channels, with the segments from the host. It loads the sample's 50
// bin gradients of its tile into shared memory in one round of loads;
// then each warp forms its cells' vectors from them and at once stores
// each to the cell's pixels with one TMA bulk store (cp.async.bulk) of the
// tile's bytes per pixel from shared memory, so the bytes in flight take
// no registers and a one-pixel cell idles no warp. The terms and their
// order are those of a block per cell, so the result is bit for bit the
// same. No atomics: repeated runs agree bit for bit. Odd C or unaligned
// pointers take scalar stores.
//
// Band backward (ppm_pool_band_backward_launch), for training with each
// image's height split in bands (cli.train TPU.spatial): rows [row0, row0
// + hb) of the backward above, written to an (N, hb, W, C) band. Bins and
// reciprocal areas stay those of the whole H-row map, so each element is
// the same terms in the same order with the same host-rounded reciprocals
// as the dense backward's: its rows, bit for bit. The host cuts the map's
// row segments at the band's edges and the blocks take units of those
// clipped segments, so no block stores outside the band (a clipped
// segment's rows lie in the bins its whole segment lies in); the kernel is
// the dense backward's, which offsets its stores by the band's first row.
// Under the hybrid mesh the JAX package differentiates XLA's pool
// (semseg_tpu/ops/pool.py:55) over the sharded height.
//
// Built with nvcc into a shared library with a plain C interface; see
// semseg_tpu_torch/ops/kernels/ppm_pool.py for the wrapper.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>
#include <type_traits>

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

// The sorted distinct segment boundaries of an extent v into b[0..n];
// returns n, the number of segments.
int host_bounds(int v, int* b) {
  int c[kCands];
  for (int l = 0; l < kCands; ++l) c[l] = candidate(l, v);
  std::sort(c, c + kCands);
  const int m = (int)(std::unique(c, c + kCands) - c);
  std::copy(c, c + m, b);
  return m - 1;
}

// Segments of an extent v (0 for an empty one).
int num_segments(int v) {
  int b[kCands];
  return host_bounds(v, b);
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

// The V elements of a 16-byte load, widened to f32 (bf16 -> f32 is exact).
__device__ __forceinline__ void unpack16(uint4 q, float (&f)[4]) {
  f[0] = __uint_as_float(q.x);
  f[1] = __uint_as_float(q.y);
  f[2] = __uint_as_float(q.z);
  f[3] = __uint_as_float(q.w);
}
__device__ __forceinline__ void unpack16(uint4 q, float (&f)[8]) {
  const unsigned u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = __uint_as_float(u[k] << 16);
    f[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
  }
}

// 1 / area of each of the 50 bins (scale 1, 2, 3, 6; (i, j) row-major).
struct BinInv {
  float v[50];
};
__host__ __device__ constexpr int first_bin(int s) {
  return s == 1 ? 0 : s == 2 ? 1 : s == 3 ? 5 : 14;
}

__device__ __forceinline__ uint4 pack16(const float (&acc)[4]) {
  return make_uint4(__float_as_uint(acc[0]), __float_as_uint(acc[1]),
                    __float_as_uint(acc[2]), __float_as_uint(acc[3]));
}
__device__ __forceinline__ unsigned pack_pair(float lo, float hi) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}
__device__ __forceinline__ uint4 pack16(const float (&acc)[8]) {
  return make_uint4(pack_pair(acc[0], acc[1]), pack_pair(acc[2], acc[3]),
                    pack_pair(acc[4], acc[5]), pack_pair(acc[6], acc[7]));
}

// The V elements p[0], p[32], ... (those below `left`, the others 0) as
// one 16-byte vector in the order of a 16-byte load of V neighbours.
__device__ __forceinline__ uint4 gather16(const unsigned* p, int left) {
  unsigned u[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) u[k] = k * 32 < left ? p[k * 32] : 0u;
  return make_uint4(u[0], u[1], u[2], u[3]);
}
__device__ __forceinline__ uint4 gather16(const unsigned short* p, int left) {
  unsigned u[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    u[k] = (k * 64 < left ? (unsigned)p[k * 64] : 0u) |
           ((k * 64 + 32 < left ? (unsigned)p[k * 64 + 32] : 0u) << 16);
  return make_uint4(u[0], u[1], u[2], u[3]);
}

// The gradient of one cell for this thread's V channels, from scale S's
// bin gradients staged in shared memory (gbin[bin][lane], the lane's V
// channels as they were loaded): the bins (i, j) that hold the cell's
// first pixel (r0, c0), in row-major order, each times 1 / its area.
template <int S, typename T, bool kVec>
__device__ __forceinline__ void add_scale_staged(float (&acc)[16 / sizeof(T)],
                                                 const uint4 (*gbin)[32], const BinInv& inv,
                                                 int r0, int c0, int h, int w,
                                                 const bool (&live)[16 / sizeof(T)]) {
  constexpr int V = 16 / sizeof(T);
#pragma unroll
  for (int i = 0; i < S; ++i) {
    if (r0 < bin_start(i, h, S) || r0 >= bin_end(i, h, S)) continue;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      if (c0 < bin_start(j, w, S) || c0 >= bin_end(j, w, S)) continue;
      const float a = inv.v[first_bin(S) + i * S + j];
      float e[V];
      unpack16(gbin[first_bin(S) + i * S + j][threadIdx.x], e);
      if constexpr (kVec) {
        if (!live[0]) continue;
#pragma unroll
        for (int k = 0; k < V; ++k) acc[k] += e[k] * a;
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k)
          if (live[k]) acc[k] += e[k] * a;
      }
    }
  }
}

// What a backward block needs from the host: the reciprocal areas, the
// map's segment boundaries, and how the row segments are cut into units
// (a block's rows) and the column segments into parts.
struct BackwardPlan {
  BinInv inv;
  int rb[kCands], cb[kCands];  // segment boundaries of h and of w
  int nr, nc;                  // segments
  int row0, rows;              // rows [row0, row0 + rows) of the map are written (the band)
  int unit0[kCands];           // units of a sample before row segment a; unit0[nr] all
  int chunk;                   // rows of a unit, at most
  int parts;                   // groups of column segments
};

// Backward: block (unit of a sample, column part, channel tile), 32 x
// kWarps threads, lane = the channels of pass 1 (16-byte vector, or V
// channels 32 apart). The block loads the sample's 50 bin gradients of
// its tile into shared memory in one round; then warp ty takes the cells
// of segments ty, ty + 8 of its part, forms each one's vector from them
// and at once stores it to the cell's pixels: one TMA bulk store of the
// tile's bytes per pixel from the vector in shared memory (16-byte
// vectors), or scalar stores.
template <typename T, bool kVec>
__global__ void __launch_bounds__(32 * kWarps, 3)
ppm_pool_backward_kernel(const T* __restrict__ g1, const T* __restrict__ g2,
                         const T* __restrict__ g3, const T* __restrict__ g6,
                         T* __restrict__ dx, const __grid_constant__ BackwardPlan p, int h,
                         int w, int c) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kTile = 32 * V;
  using Bits = typename std::conditional<sizeof(T) == 2, unsigned short, unsigned>::type;
  __shared__ uint4 gbin[50][32];        // bin gradients: 25.6 KB
  __shared__ uint4 cell[kMaxSegs][32];  // the cells' gradients, rounded
  const int units = p.unit0[p.nr];
  const int n = blockIdx.x / units, u = blockIdx.x % units;
  const int tx = threadIdx.x, ty = threadIdx.y, t = ty * 32 + tx;
  int a = 0;
  while (a + 1 < p.nr && p.unit0[a + 1] <= u) ++a;
  const int r0 = p.rb[a];
  const int r_lo = r0 + (u - p.unit0[a]) * p.chunk;
  const int r_hi = min(r_lo + p.chunk, p.rb[a + 1]);
  const int b_lo = blockIdx.y * p.nc / p.parts, b_hi = (blockIdx.y + 1) * p.nc / p.parts;
  const int tile0 = blockIdx.z * kTile;
  const int ch0 = tile0 + (kVec ? tx * V : tx);

  // (bin, lane) = (k / 32, k % 32) for k = t + 256 u: every load first.
  constexpr int kRounds = (50 * 32 + 32 * kWarps - 1) / (32 * kWarps);
  uint4 q[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int k = t + r * 32 * kWarps, bin = k / 32, l = k % 32;
    const int si = bin < 1 ? 0 : bin < 5 ? 1 : bin < 14 ? 2 : 3, s = scale_of(si);
    const T* g = si == 0 ? g1 : si == 1 ? g2 : si == 2 ? g3 : g6;
    const T* src = g + ((size_t)n * s * s + bin - first_bin(s)) * c + tile0;
    q[r] = make_uint4(0u, 0u, 0u, 0u);
    if (k >= 50 * 32) continue;
    if constexpr (kVec) {
      if (tile0 + l * V < c) q[r] = __ldg(reinterpret_cast<const uint4*>(src + l * V));
    } else {
      q[r] = gather16(reinterpret_cast<const Bits*>(src) + l, c - tile0 - l);
    }
  }
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int k = t + r * 32 * kWarps;
    if (k < 50 * 32) gbin[k / 32][k % 32] = q[r];
  }
  bool live[V];  // which of this thread's channels exist
#pragma unroll
  for (int k = 0; k < V; ++k) live[k] = kVec ? ch0 < c : ch0 + k * 32 < c;
  __syncthreads();
  const size_t row_stride = (size_t)w * c;
  const unsigned bytes = (unsigned)(min(kTile, c - tile0) * sizeof(T));  // a pixel's tile
  for (int b = b_lo + ty; b < b_hi; b += kWarps) {
    const int c0 = p.cb[b], cw = p.cb[b + 1] - c0;
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.f;
    add_scale_staged<1, T, kVec>(acc, gbin, p.inv, r0, c0, h, w, live);
    add_scale_staged<2, T, kVec>(acc, gbin, p.inv, r0, c0, h, w, live);
    add_scale_staged<3, T, kVec>(acc, gbin, p.inv, r0, c0, h, w, live);
    add_scale_staged<6, T, kVec>(acc, gbin, p.inv, r0, c0, h, w, live);
    const int pixels = (r_hi - r_lo) * cw;
    T* base = dx + ((size_t)n * p.rows + (r_lo - p.row0)) * row_stride + (size_t)c0 * c;
    if constexpr (kVec) {
      cell[b - b_lo][tx] = pack16(acc);
      // The lanes' writes, made by the threads, are read by the bulk copies.
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncwarp();
      // Pixel p of the cell to lane p % 32, one bulk store of the tile each.
      const unsigned src = static_cast<unsigned>(__cvta_generic_to_shared(&cell[b - b_lo][0]));
      int pr = tx / cw, pc = tx % cw;
      const int dr = 32 / cw, dc = 32 % cw;
      for (int pp = tx; pp < pixels; pp += 32) {
        asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
                         base + (size_t)pr * row_stride + (size_t)pc * c + tile0),
                     "r"(src), "r"(bytes)
                     : "memory");
        pr += dr;
        pc += dc;
        if (pc >= cw) {
          pc -= cw;
          ++pr;
        }
      }
    } else {
      T v[V];
#pragma unroll
      for (int k = 0; k < V; ++k) store_from_f32(&v[k], acc[k]);
      for (int pp = 0; pp < pixels; ++pp) {
        T* px = base + (size_t)(pp / cw) * row_stride + (size_t)(pp % cw) * c + ch0;
#pragma unroll
        for (int k = 0; k < V; ++k)
          if (live[k]) px[k * 32] = v[k];
      }
    }
  }
  if constexpr (kVec) {
    // Shared memory stays until the bulk copies have read it.
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;  // an H100's; it only sizes grids
  return sms;
}

// Rows [row0, row0 + hb) of the input gradient of an (n, h, w, c) map
// into dx, (n, hb, w, c); the dense backward is the band [0, h).
template <typename T>
cudaError_t launch_backward(const void* g1, const void* g2, const void* g3,
                            const void* g6, void* dx, int n, int h, int w, int c,
                            int row0, int hb, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kTile = 32 * V;
  const bool vec = c % V == 0 &&
                   ((reinterpret_cast<uintptr_t>(g1) | reinterpret_cast<uintptr_t>(g2) |
                     reinterpret_cast<uintptr_t>(g3) | reinterpret_cast<uintptr_t>(g6) |
                     reinterpret_cast<uintptr_t>(dx)) % 16) == 0;
  BackwardPlan p;
  for (int si = 0; si < 4; ++si) {
    const int sc = scale_of(si);
    for (int i = 0; i < sc; ++i)
      for (int j = 0; j < sc; ++j) {
        const int area = (bin_end(i, h, sc) - bin_start(i, h, sc)) *
                         (bin_end(j, w, sc) - bin_start(j, w, sc));
        p.inv.v[first_bin(sc) + i * sc + j] = (float)(1.0 / area);
      }
  }
  // The map's row segments cut at the band's edges: the band's own.
  int full[kCands];
  const int nfull = host_bounds(h, full);
  p.row0 = row0;
  p.rows = hb;
  p.nr = 0;
  p.rb[0] = row0;
  for (int k = 1; k <= nfull; ++k)
    if (full[k] > row0) {
      p.rb[++p.nr] = std::min(full[k], row0 + hb);
      if (full[k] >= row0 + hb) break;
    }
  p.nc = host_bounds(w, p.cb);
  // A unit is a whole row segment; halve the units' rows while the grid
  // has fewer than two blocks an SM or a unit more than 128 KB (a block
  // stores at a few tens of GB/s), then split the column segments into
  // parts while it still has too few.
  const long long tiles = (c + kTile - 1) / kTile, sms = sm_count();
  auto units = [&](int chunk) {
    int u = 0;
    for (int a = 0; a < p.nr; ++a) u += (p.rb[a + 1] - p.rb[a] + chunk - 1) / chunk;
    return u;
  };
  p.chunk = 1;
  for (int a = 0; a < p.nr; ++a) p.chunk = std::max(p.chunk, p.rb[a + 1] - p.rb[a]);
  while (p.chunk > 1 && (n * tiles * units(p.chunk) < 2 * sms ||
                         (size_t)p.chunk * w * kTile * sizeof(T) > 128 * 1024))
    p.chunk = (p.chunk + 1) / 2;
  const long long blocks = n * tiles * units(p.chunk);
  p.parts = (int)std::min<long long>(p.nc, std::max(1LL, (2 * sms + blocks - 1) / blocks));
  p.unit0[0] = 0;
  for (int a = 0; a < p.nr; ++a)
    p.unit0[a + 1] = p.unit0[a] + (p.rb[a + 1] - p.rb[a] + p.chunk - 1) / p.chunk;
  if ((long long)n * p.unit0[p.nr] >= INT_MAX || tiles > 65535) return cudaErrorInvalidValue;
  dim3 grid(n * p.unit0[p.nr], p.parts, (unsigned)tiles);
  const T *p1 = static_cast<const T*>(g1), *p2 = static_cast<const T*>(g2),
          *p3 = static_cast<const T*>(g3), *p6 = static_cast<const T*>(g6);
  T* out = static_cast<T*>(dx);
  if (vec)
    ppm_pool_backward_kernel<T, true><<<grid, dim3(32, kWarps), 0, stream>>>(
        p1, p2, p3, p6, out, p, h, w, c);
  else
    ppm_pool_backward_kernel<T, false><<<grid, dim3(32, kWarps), 0, stream>>>(
        p1, p2, p3, p6, out, p, h, w, c);
  return cudaGetLastError();
}

// Band form.
constexpr int kBandThreads = 512;
constexpr int kCopyWarps = 4;      // warps that issue the copies; the others sum
constexpr int kSumWarps = kBandThreads / 32 - kCopyWarps;
constexpr int kBandTC = 16;        // channels of a block: 32 bytes a pixel in bf16, 64 in f32
constexpr int kGroups = 4;         // row groups of a stage, each with its barrier
constexpr size_t kBandSmem = 200 * 1024;  // dynamic shared memory of a block, at most

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(smem)), "l"(gmem)
               : "memory");
}

// Copies `rows` rows x columns [0, vw) of the block's kBandTC channels,
// from src (row 0's column 0 of the tile) to dst (pixel p at p * kBandTC),
// by the copy warps (thread t of them): 16-byte cp.async, or with kVec
// false element by element, kUnroll loads before their stores.
template <typename T, bool kVec>
__device__ __forceinline__ void stage_band_rows(T* __restrict__ dst, const T* __restrict__ src,
                                                size_t row_stride, int c, int tile0, int vw,
                                                int rows, int t) {
  constexpr int V = 16 / sizeof(T), kTV = kBandTC / V;  // 16-byte vectors a pixel: 2 or 4
  constexpr int kThreads = 32 * kCopyWarps;
  using Bits = typename std::conditional<sizeof(T) == 2, unsigned short, unsigned>::type;
  const int pixels = rows * vw;
  if (pixels <= 0) return;
  if constexpr (kVec) {
    constexpr int kStep = kThreads / kTV;  // pixels a round of the copy warps copies
    const int v = t % kTV;
    if (tile0 + v * V >= c) return;
    int px = t / kTV, r = px / vw, col = px % vw;
    const int dr = kStep / vw, dc = kStep % vw;
    for (; px < pixels; px += kStep) {
      cp_async16(dst + (size_t)px * kBandTC + v * V,
                 src + (size_t)r * row_stride + (size_t)col * c + v * V);
      r += dr;
      col += dc;
      if (col >= vw) {
        col -= vw;
        ++r;
      }
    }
  } else {
    constexpr int kStep = kThreads / kBandTC;
    const int e = t % kBandTC;
    if (tile0 + e >= c) return;
    const Bits* xb = reinterpret_cast<const Bits*>(src);
    Bits* sb = reinterpret_cast<Bits*>(dst);
    for (int p0 = t / kBandTC; p0 < pixels; p0 += kStep * kUnroll) {
      Bits q[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int px = p0 + u * kStep, r = px / vw;
        q[u] = px < pixels ? xb[(size_t)r * row_stride + (size_t)(px - r * vw) * c + e] : Bits(0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (p0 + u * kStep < pixels) sb[(size_t)(p0 + u * kStep) * kBandTC + e] = q[u];
    }
  }
}

// The band's first row segment and last (A0 > A1 when no row is valid).
__device__ __forceinline__ void band_segments(const int* rb, int nr, int row0, int hv, int& A0,
                                              int& A1) {
  A0 = 0;
  A1 = 0;
  for (int m = 1; m < nr; ++m) {
    A0 += rb[m] <= row0;
    A1 += rb[m] <= row0 + hv - 1;
  }
  if (hv == 0) A1 = A0 - 1;
}

// Block (tile of kBandTC channels, sample), kBandThreads threads. The copy
// warps stage the band's valid rows in dynamic shared memory, stage_rows
// at a time, in up to kGroups row groups, each group's arrival counted on
// its barrier (cp.async.mbarrier.arrive). Meanwhile the sum warps derive
// the segments and then, group by group as the rows arrive, sum each
// staged (row segment, column segment) cell, one warp always on the same
// cell and a lane per (pixel, 16-byte vector), the lanes' sums meeting in
// a fixed butterfly of shuffles. Then the block adds the cells into the
// 50 bins as pass 2 does.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kBandThreads)
ppm_band_kernel(const T* __restrict__ x, const int* __restrict__ valid_hw,
                float* __restrict__ sums, int h, int w, int c, int row0, int hb,
                int stage_rows, int colsum_off) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kTV = kBandTC / V;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int rb[kCands], cb[kCands], rspan[kCands][2], cspan[kCands][2], nseg[2];
  __shared__ float cellsum[kMaxSegs][kMaxSegs][kBandTC];  // (row segment - A0, column segment)
  __shared__ float colbin[kMaxSegs][kCands][kBandTC];     // (row segment - A0, column bin)
  __shared__ __align__(8) unsigned long long arrived[kGroups];
  T* stage = reinterpret_cast<T*>(smem);
  float* colsum = reinterpret_cast<float*>(smem + colsum_off);  // (column, channel)
  const int tile0 = blockIdx.x * kBandTC, n = blockIdx.y;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  int vh, vw;
  extent<true>(valid_hw, n, h, w, vh, vw);
  const int hv = max(0, min(hb, vh - row0));  // the band's rows inside the extent
  if (t < kGroups)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(&arrived[t])),
                 "r"(32 * kCopyWarps)
                 : "memory");
  __syncthreads();

  if (warp < kCopyWarps) {
    const size_t row_stride = (size_t)w * c;
    const T* xn = x + (size_t)n * hb * row_stride + tile0;  // row row0 of sample n
    for (int s0 = 0; s0 < hv; s0 += stage_rows) {
      const int rows = min(stage_rows, hv - s0), groups = min(kGroups, rows);
      if (s0 > 0) asm volatile("bar.sync 1, %0;" ::"n"(kBandThreads) : "memory");
      for (int g = 0; g < groups; ++g) {
        const int g0 = rows * g / groups, g1 = rows * (g + 1) / groups;
        stage_band_rows<T, kVec>(stage + (size_t)g0 * vw * kBandTC,
                                 xn + (size_t)(s0 + g0) * row_stride, row_stride, c, tile0, vw,
                                 g1 - g0, t);
        if constexpr (kVec)
          asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                           smem_addr(&arrived[g]))
                       : "memory");
        else
          asm volatile("{ .reg .b64 st; mbarrier.arrive.shared::cta.b64 st, [%0]; }" ::"r"(
                           smem_addr(&arrived[g]))
                       : "memory");
      }
    }
  } else {
    const int sw = warp - kCopyWarps;  // sum warp
    if (sw < 2) {
      const int m = segment_bounds(sw == 0 ? vh : vw, sw == 0 ? rb : cb);
      if (lane == 0) nseg[sw] = m;
    } else if (sw < 4) {
      bin_spans(sw == 2 ? vh : vw, sw == 2 ? rspan : cspan);
    }
    for (int i = t - 32 * kCopyWarps; i < kMaxSegs * kMaxSegs * kBandTC; i += 32 * kSumWarps)
      (&cellsum[0][0][0])[i] = 0.f;
    asm volatile("bar.sync 2, %0;" ::"n"(32 * kSumWarps) : "memory");
    const int nr = nseg[0], nc = nseg[1];
    int A0, A1;
    band_segments(rb, nr, row0, hv, A0, A1);
    const int st = t - 32 * kCopyWarps;  // sum thread
    for (int s0 = 0, round = 0; s0 < hv; s0 += stage_rows, ++round) {
      const int rows = min(stage_rows, hv - s0), groups = min(kGroups, rows);
      for (int g = 0; g < groups; ++g) {
        const int g0 = s0 + rows * g / groups, g1 = s0 + rows * (g + 1) / groups;
        unsigned done = 0;
        while (!done)
          asm volatile(
              "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
              "selp.u32 %0, 1, 0, p; }"
              : "=r"(done)
              : "r"(smem_addr(&arrived[g])), "r"(round & 1)
              : "memory");
        // Band rows [g0, g1) have arrived: each row segment's part of
        // them, first summed over its rows per (column, 16-byte vector)
        // into colsum, then over each column segment's columns by a warp,
        // lane (channel, half), into the cell sums.
        int aa = A0;
        while (aa + 1 < nr && rb[aa + 1] <= row0 + g0) ++aa;
        int ab = aa;
        while (ab + 1 < nr && rb[ab + 1] < row0 + g1) ++ab;
        for (int a = aa; a <= ab; ++a) {
          const int ra0 = max(rb[a], row0 + g0) - (row0 + s0);  // rows inside the stage
          const int ra1 = min(rb[a + 1], row0 + g1) - (row0 + s0);
          for (int it = st; it < vw * kTV; it += 32 * kSumWarps) {
            const int x = it / kTV, v = it % kTV;
            const T* px = stage + ((size_t)ra0 * vw + x) * kBandTC + v * V;
            float acc[V];
#pragma unroll
            for (int j = 0; j < V; ++j) acc[j] = 0.f;
#pragma unroll 4
            for (int r = ra0; r < ra1; ++r, px += (size_t)vw * kBandTC)
              add16(acc, *reinterpret_cast<const uint4*>(px), T());
            float4* out = reinterpret_cast<float4*>(colsum + (size_t)x * kBandTC + v * V);
#pragma unroll
            for (int j = 0; j < V / 4; ++j)
              out[j] = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
          }
          asm volatile("bar.sync 2, %0;" ::"n"(32 * kSumWarps) : "memory");
          const int ch = lane % kBandTC, hf = lane / kBandTC;
          for (int b = sw; b < nc; b += kSumWarps) {
            float sum = 0.f;
            for (int xx = cb[b] + hf; xx < cb[b + 1]; xx += 2) sum += colsum[xx * kBandTC + ch];
            sum += __shfl_xor_sync(0xffffffffu, sum, 16);
            if (hf == 0) cellsum[a - A0][b][ch] += sum;
          }
          asm volatile("bar.sync 2, %0;" ::"n"(32 * kSumWarps) : "memory");
        }
      }
      // The copy warps may refill the stage once every cell of it is summed.
      if (s0 + stage_rows < hv) asm volatile("bar.sync 1, %0;" ::"n"(kBandThreads) : "memory");
    }
  }
  __syncthreads();

  // Column bins of each of the band's row segments, then the bins.
  const int nr = nseg[0];
  int A0, A1;
  band_segments(rb, nr, row0, hv, A0, A1);
  for (int it = t; it < (A1 - A0 + 1) * kCands * kBandTC; it += kBandThreads) {
    const int ch = it % kBandTC, kc = it / kBandTC % kCands, a = it / (kBandTC * kCands);
    float s = 0.f;
    for (int b = cspan[kc][0]; b < cspan[kc][1]; ++b) s += cellsum[a][b][ch];
    colbin[a][kc][ch] = s;
  }
  __syncthreads();
  for (int it = t; it < kCands * kBandTC; it += kBandThreads) {
    const int ch = it % kBandTC, kr = it / kBandTC, chan = tile0 + ch;
    if (chan >= c) continue;
    const int si = kr < 1 ? 0 : kr < 3 ? 1 : kr < 6 ? 2 : 3;
    const int S = scale_of(si), i = kr - first_1d_bin(si);
    const int alo = max(rspan[kr][0], A0), ahi = min(rspan[kr][1], A1 + 1);
    for (int j = 0; j < S; ++j) {
      float sum = 0.f;
      for (int a = alo; a < ahi; ++a) sum += colbin[a - A0][first_1d_bin(si) + j][ch];
      sums[((size_t)n * 50 + first_bin(S) + i * S + j) * c + chan] = sum;
    }
  }
}

template <typename T>
cudaError_t launch_band(const void* xv, float* sums, const int* valid_hw, int n, int hb,
                        int w, int c, int h, int row0, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const T* x = static_cast<const T*>(xv);
  const bool vec = c % V == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const long long tiles = (c + kBandTC - 1) / kBandTC;
  if (tiles > INT_MAX || n > 65535) return cudaErrorInvalidValue;
  const size_t pixel_bytes = kBandTC * sizeof(T);
  const size_t colsum_bytes = (size_t)w * kBandTC * sizeof(float);
  if (colsum_bytes >= kBandSmem) return cudaErrorInvalidValue;
  const int stage_rows =
      (int)std::min<size_t>(hb, (kBandSmem - colsum_bytes) / ((size_t)w * pixel_bytes));
  if (stage_rows < 1) return cudaErrorInvalidValue;  // a row wider than shared memory
  const size_t stage_bytes = (size_t)stage_rows * w * pixel_bytes;
  const size_t smem = stage_bytes + colsum_bytes;
  void (*kernel)(const T*, const int*, float*, int, int, int, int, int, int, int) =
      vec ? ppm_band_kernel<T, true> : ppm_band_kernel<T, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)tiles, n), kBandThreads, smem, stream>>>(
      x, valid_hw, sums, h, w, c, row0, hb, stage_rows, (int)stage_bytes);
  return cudaGetLastError();
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

// Band form: x is rows [row0, row0 + hb) of an (N, H, W, C) map,
// contiguous; valid_hw the (N, 2) int32 device array of extents; sums the
// (N, 50, C) f32 result. One launch, nothing else allocated. Returns the
// cudaError_t of the launch.
int ppm_pool_band_launch(const void* x, void* sums, const void* valid_hw, int n, int hb,
                         int w, int c, int h, int row0, int dtype, void* stream) {
  if (n <= 0 || hb <= 0 || w <= 0 || c <= 0 || row0 < 0 || row0 + hb > h ||
      valid_hw == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(sums);
  const int* v = static_cast<const int*>(valid_hw);
  if (dtype == 0) return (int)launch_band<float>(x, out, v, n, hb, w, c, h, row0, s);
  if (dtype == 1) return (int)launch_band<__nv_bfloat16>(x, out, v, n, hb, w, c, h, row0, s);
  return (int)cudaErrorInvalidValue;
}

// The signature of ppm_pool_band_launch: 2 for the one above; a source
// without this function takes a scratch pointer after sums.
int ppm_pool_band_abi() { return 2; }

// Input gradient of the dense form: g1, g2, g3, g6 are the (N, s, s, C)
// contiguous output gradients, dx the (N, H, W, C) contiguous result, in
// the dtype's code as above. Returns the cudaError_t of the launch.
int ppm_pool_backward_launch(const void* g1, const void* g2, const void* g3,
                             const void* g6, void* dx, int n, int h, int w, int c,
                             int dtype, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_backward<float>(g1, g2, g3, g6, dx, n, h, w, c, 0, h, s);
  if (dtype == 1)
    return (int)launch_backward<__nv_bfloat16>(g1, g2, g3, g6, dx, n, h, w, c, 0, h, s);
  return (int)cudaErrorInvalidValue;
}

// Band backward: rows [row0, row0 + hb) of the input gradient above, into
// dx, the (N, hb, W, C) contiguous band; the gradients and the dtype's
// code as above. Returns the cudaError_t of the launch.
int ppm_pool_band_backward_launch(const void* g1, const void* g2, const void* g3,
                                  const void* g6, void* dx, int n, int h, int w, int c,
                                  int row0, int hb, int dtype, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || hb <= 0 || row0 < 0 || row0 + hb > h)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_backward<float>(g1, g2, g3, g6, dx, n, h, w, c, row0, hb, s);
  if (dtype == 1)
    return (int)launch_backward<__nv_bfloat16>(g1, g2, g3, g6, dx, n, h, w, c, row0, hb, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

// Sorted segment reductions over dense sorted segment ranks: the three
// Pallas kernels of ndtpu/ops/pallas/segment_moments.py, for sm_90a.
//
//   ndtpu_segment_moments  <- _moments_kernel (entry fused_moments_sorted)
//   ndtpu_segment_tags     <- _tags_kernel    (entry segment_tags_sorted)
//   ndtpu_segment_sum      <- _kernel         (entry segment_sum_sorted)
//
// Precondition (as for the TPU kernels): each cloud's ids are sorted
// (non-decreasing; the pipeline gives dense ranks with unit steps), so
// segment s is the contiguous run that starts at lower_bound(seg, s). Ids
// >= num_segments are dropped and never read past the binary search: the
// callers pass only the rows they keep, so the points of a dropped row (at
// the search's early guesses nearly the whole cloud) cost nothing.
//
// Common design. Each output row (segment) is reduced by one warp (K1) or
// one block (K2, K3) that finds the run by a 33-way warp search. Its
// threads stride the run in a fixed order, and a fixed shfl tree and a
// fixed loop over shared memory combine them. Nothing is shared between
// warps of different rows, there are no atomics, and the summation order
// depends only on the run's length, so results are bit-identical from
// launch to launch. The TPU kernels' one-hot matmuls on the MXU and their
// block/sub-block/sublane windows exist for the TPU's matrix unit and VMEM
// and are not carried over. All three are bound by bytes on an H100
// (3.35 TB/s): each does a few f32 additions per value it reads.
//
// Every entry returns cudaGetLastError() after its launch (0 = success) and
// launches on the stream it is given.

#include <cuda_runtime.h>
#include <stdint.h>

#define NDTPU_MAX_TAGS 8

namespace {

constexpr int kWarpsPerBlock = 8;  // K1: one warp per segment
constexpr int kBlock = 256;        // K2, K3: one block per segment
constexpr int kMoments = 13;

struct TagPtrs {
  const float* p[NDTPU_MAX_TAGS];
};

// First index i in [lo, hi) with sg[i] >= s (hi if none), for sorted sg.
// Called by all 32 lanes of a warp: each round probes 32 evenly spaced
// positions and keeps the gap where the ids cross s (a ballot), so a
// search over N ids takes about log_33(N) dependent loads (4 for a million
// points) instead of log_2(N) (20): the searches, not the sums, set the
// time of a kernel whose runs are a few hundred points long.
__device__ __forceinline__ int warp_lower_bound(const int* __restrict__ sg,
                                                int lo, int hi, long long s) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {
    const long long span = hi - lo;  // >= 33: the probes are distinct
    const int probe = lo + static_cast<int>(span * (lane + 1) / 33);
    const int below = __popc(__ballot_sync(0xffffffffu, __ldg(sg + probe) < s));
    const int new_lo = below > 0 ? lo + static_cast<int>(span * below / 33) + 1 : lo;
    if (below < 32) hi = lo + static_cast<int>(span * (below + 1) / 33);
    lo = new_lo;
  }
  const int i = lo + lane;
  return lo + __popc(__ballot_sync(0xffffffffu, i < hi && __ldg(sg + i) < s));
}

// ---- segment moments (K1) ----
//
// For each cloud b and segment s < num_segments it sums, over the points i
// with seg[b, i] == s, the row
//
//   [v, x, y, z, xx, xy, xz, xy, yy, yz, xz, yz, zz,
//    v * onehot(cls)[0 .. slots), tag_0 .. tag_{T-1}]
//
// (x, y, z = the voxel-center-shifted coordinates xt, yt, zt) into
// out[b, s, :], F = 13 + slots + T columns. The whole batch is one launch
// (the TPU kernel's custom_vmap rule). The row is built in registers from
// the compact inputs; the [N, F] feature matrix never exists in device
// memory.
//
// One warp per (cloud, segment): lane l sums points start + l,
// start + l + 32, ... and a shfl_down tree combines the 32 partial sums.
// The mirrored outer-product entries come from the same accumulators and
// are bit-equal. Class histograms (slots > 0) go to per-lane private
// columns in shared memory, summed over lanes in lane order. Tag columns
// hold at most one nonzero per segment, so their sums are exact.
//
// Bound: each point is read once (seg, xt, yt, zt, v: 20 B, + 4 B cls when
// slots > 0, + 4 B per tag); each output row is written once. At the
// serving shape (B=16, N=70000, num_segments=1209, slots=0, T=3) that is
// 1.12 M points x 32 B + 16 x 1209 x 16 x 4 B ~ 37 MB, about 11 us at
// 3.35 TB/s. The arithmetic (~25 f32 operations a point) is far below the
// card's f32 rate.

__global__ void segment_moments_kernel(
    const int* __restrict__ seg, const float* __restrict__ xt,
    const float* __restrict__ yt, const float* __restrict__ zt,
    const float* __restrict__ v, const int* __restrict__ cls, TagPtrs tags,
    int n_tags, int batch, int n, int num_segments, int slots,
    float* __restrict__ out) {
  extern __shared__ float hist_smem[];  // [warps][slots][32], slots > 0 only
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long task =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + warp;
  if (task >= static_cast<long long>(batch) * num_segments) return;
  const int b = static_cast<int>(task / num_segments);
  const int s = static_cast<int>(task % num_segments);
  const long long base = static_cast<long long>(b) * n;
  const int* sg = seg + base;

  const int start = warp_lower_bound(sg, 0, n, s);

  float acc[kMoments - 3];  // v, x, y, z, xx, xy, xz, yy, yz, zz
#pragma unroll
  for (int j = 0; j < kMoments - 3; ++j) acc[j] = 0.0f;
  float tag_acc[NDTPU_MAX_TAGS];
#pragma unroll
  for (int t = 0; t < NDTPU_MAX_TAGS; ++t) tag_acc[t] = 0.0f;

  float* hist = hist_smem + static_cast<size_t>(warp) * slots * 32;
  for (int c = 0; c < slots; ++c) hist[c * 32 + lane] = 0.0f;

  // the run ends where the id changes; the warp stops at the first chunk
  // of 32 with no point of this segment
  for (int chunk = start;; chunk += 32) {
    const int i = chunk + lane;
    const bool in = i < n && __ldg(sg + i) == s;
    if (!__any_sync(0xffffffffu, in)) break;
    if (in) {
      const long long gi = base + i;
      const float x = __ldg(xt + gi), y = __ldg(yt + gi), z = __ldg(zt + gi);
      const float w = __ldg(v + gi);
      acc[0] += w;
      acc[1] += x;
      acc[2] += y;
      acc[3] += z;
      acc[4] += x * x;
      acc[5] += x * y;
      acc[6] += x * z;
      acc[7] += y * y;
      acc[8] += y * z;
      acc[9] += z * z;
#pragma unroll
      for (int t = 0; t < NDTPU_MAX_TAGS; ++t)
        if (t < n_tags) tag_acc[t] += __ldg(tags.p[t] + gi);
      if (slots > 0) {
        const int c = __ldg(cls + gi);
        if (c >= 0 && c < slots) hist[c * 32 + lane] += w;
      }
    }
  }

  // fixed reduction tree: lane 0 ends with the sum
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int j = 0; j < kMoments - 3; ++j)
      acc[j] += __shfl_down_sync(0xffffffffu, acc[j], off);
#pragma unroll
    for (int t = 0; t < NDTPU_MAX_TAGS; ++t)
      tag_acc[t] += __shfl_down_sync(0xffffffffu, tag_acc[t], off);
  }

  const int f = kMoments + slots + n_tags;
  float* row = out + (static_cast<long long>(b) * num_segments + s) * f;
  if (lane == 0) {
    row[0] = acc[0];
    row[1] = acc[1];
    row[2] = acc[2];
    row[3] = acc[3];
    row[4] = acc[4];   // xx
    row[5] = acc[5];   // xy
    row[6] = acc[6];   // xz
    row[7] = acc[5];   // yx == xy
    row[8] = acc[7];   // yy
    row[9] = acc[8];   // yz
    row[10] = acc[6];  // zx == xz
    row[11] = acc[8];  // zy == yz
    row[12] = acc[9];  // zz
#pragma unroll
    for (int t = 0; t < NDTPU_MAX_TAGS; ++t)
      if (t < n_tags) row[kMoments + slots + t] = tag_acc[t];
  }
  if (slots > 0) {
    __syncwarp();
    for (int c = lane; c < slots; c += 32) {
      float h = 0.0f;
      for (int l = 0; l < 32; ++l) h += hist[c * 32 + l];
      row[kMoments + c] = h;
    }
  }
}

// ---- sparse per-segment tags (K3) ----
//
// out[s, t] = the sum of tags[t][i] over the points i with seg[i] == s, for
// s < num_segments and T <= 8 columns, one cloud (1-D, as the TPU entry).
// The callers put at most one nonzero in a segment (12-bit splits of an
// integer key on each run's first row), so every sum is exact in f32. The
// kernel still sums the whole run in a fixed order, so it computes what
// _tags_kernel computes also where that does not hold.
//
// One block of kBlock threads per segment (a warp per segment leaves the
// longest run, ~1800 points in the giant cloud, to 32 lanes and sets the
// kernel's time): the run is [lower_bound(s), lower_bound(s + 1)) (each
// warp searches; the loads after the first warp's hit L1), thread
// j sums points start + j, start + j + kBlock, ..., a shfl_down tree sums
// each warp, and thread t adds the warps' sums for column t in warp order.
//
// Bound: seg and the T tags of every point of a kept segment read once
// (4 + 4T B), the [num_segments, T] table written once. At the giant
// cloud's accepted size (N = 1,048,576, T = 4, num_segments = 2504) that is
// ~21 MB, about 6.3 us at 3.35 TB/s.
__global__ void __launch_bounds__(kBlock) segment_tags_kernel(
    const int* __restrict__ seg, TagPtrs tags, int n_tags, int n,
    float* __restrict__ out) {
  __shared__ float warp_sums[kBlock / 32][NDTPU_MAX_TAGS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int s = blockIdx.x;
  const int start = warp_lower_bound(seg, 0, n, s);
  const int end = warp_lower_bound(seg, start, n, static_cast<long long>(s) + 1);
  float acc[NDTPU_MAX_TAGS];
#pragma unroll
  for (int t = 0; t < NDTPU_MAX_TAGS; ++t) acc[t] = 0.0f;
  for (int i = start + threadIdx.x; i < end; i += kBlock) {
#pragma unroll
    for (int t = 0; t < NDTPU_MAX_TAGS; ++t)
      if (t < n_tags) acc[t] += __ldg(tags.p[t] + i);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int t = 0; t < NDTPU_MAX_TAGS; ++t)
      acc[t] += __shfl_down_sync(0xffffffffu, acc[t], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int t = 0; t < NDTPU_MAX_TAGS; ++t) warp_sums[warp][t] = acc[t];
  }
  __syncthreads();
  if (threadIdx.x < n_tags) {
    float total = 0.0f;
    for (int w = 0; w < kBlock / 32; ++w) total += warp_sums[w][threadIdx.x];
    out[static_cast<long long>(s) * n_tags + threadIdx.x] = total;
  }
}

// ---- generic sorted segment sum (K2) ----
//
// out[b, s, c] = the sum of feats[b, i, c] over the points i with
// seg[b, i] == s, for s < num_segments, feats row-major [batch, N, F] f32,
// any F (the moments give 13 + slots, up to 42).
//
// One block of kBlock threads per (cloud, segment, tile of up to 32
// columns). In a tile of w columns the threads form g = kBlock / w row
// groups of w: thread (q, c) sums column c of rows start + q,
// start + q + g, ... in order, so each step of the block reads g * w
// consecutive floats (whole rows, coalesced). Then thread (0, c) adds the
// g partial sums in group order from shared memory. The order depends only
// on the run's length: bit-identical from launch to launch, and
// |sum - exact| <= (ceil(L / g) + g) * 2^-24 * sum|terms| to first order
// for a run of L rows. A block (not a warp) per segment keeps the longest
// run's walk short: g = 18 groups for the moments' 14 columns.
//
// Bound: seg and the F floats of every point read once (4 + 4F B), the
// [num_segments, F] rows written once. For the moments of the giant cloud
// (N = 1,048,576, F = 14) that is ~63 MB, about 19 us at 3.35 TB/s.
__global__ void __launch_bounds__(kBlock) segment_sum_kernel(
    const int* __restrict__ seg, const float* __restrict__ feats, int n, int f,
    int num_segments, int col_tiles, float* __restrict__ out) {
  __shared__ float partial[kBlock];
  const int tile = static_cast<int>(blockIdx.x % col_tiles);
  const long long row = blockIdx.x / col_tiles;  // b * num_segments + s
  const int b = static_cast<int>(row / num_segments);
  const int s = static_cast<int>(row % num_segments);
  const int* sg = seg + static_cast<long long>(b) * n;
  const int start = warp_lower_bound(sg, 0, n, s);
  const int end = warp_lower_bound(sg, start, n, static_cast<long long>(s) + 1);

  const int c0 = tile * 32;
  const int width = min(32, f - c0);
  const int groups = kBlock / width;
  const int grp = threadIdx.x / width;
  const int col = threadIdx.x - grp * width;
  float acc = 0.0f;
  if (grp < groups) {
    const float* p = feats + static_cast<long long>(b) * n * f + c0 + col;
#pragma unroll 4
    for (int i = start + grp; i < end; i += groups)
      acc += __ldg(p + static_cast<long long>(i) * f);
  }
  partial[threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.x < width) {
    float total = 0.0f;
    for (int q = 0; q < groups; ++q) total += partial[q * width + threadIdx.x];
    out[row * f + c0 + threadIdx.x] = total;
  }
}

}  // namespace

extern "C" int ndtpu_segment_moments(
    const void* seg, const void* xt, const void* yt, const void* zt,
    const void* v, const void* cls, const void* const* tag_ptrs, int n_tags,
    int batch, int n, int num_segments, int slots, void* out, void* stream) {
  if (n_tags < 0 || n_tags > NDTPU_MAX_TAGS || batch < 0 || n < 0 ||
      num_segments < 0 || slots < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tasks = static_cast<long long>(batch) * num_segments;
  if (tasks == 0) return static_cast<int>(cudaSuccess);
  TagPtrs tags;
  for (int t = 0; t < NDTPU_MAX_TAGS; ++t)
    tags.p[t] = t < n_tags ? static_cast<const float*>(tag_ptrs[t]) : nullptr;
  const size_t smem = static_cast<size_t>(kWarpsPerBlock) * slots * 32 *
                      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        segment_moments_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long blocks = (tasks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  segment_moments_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32,
                           smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(seg), static_cast<const float*>(xt),
      static_cast<const float*>(yt), static_cast<const float*>(zt),
      static_cast<const float*>(v), static_cast<const int*>(cls), tags, n_tags,
      batch, n, num_segments, slots, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ndtpu_segment_tags(const void* seg, const void* const* tag_ptrs,
                                  int n_tags, int n, int num_segments,
                                  void* out, void* stream) {
  if (n_tags < 1 || n_tags > NDTPU_MAX_TAGS || n < 0 || num_segments < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_segments == 0) return static_cast<int>(cudaSuccess);
  TagPtrs tags;
  for (int t = 0; t < NDTPU_MAX_TAGS; ++t)
    tags.p[t] = t < n_tags ? static_cast<const float*>(tag_ptrs[t]) : nullptr;
  segment_tags_kernel<<<static_cast<unsigned>(num_segments), kBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(seg), tags, n_tags, n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ndtpu_segment_sum(const void* seg, const void* feats, int batch,
                                 int n, int f, int num_segments, void* out,
                                 void* stream) {
  if (batch < 0 || n < 0 || f < 1 || num_segments < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int col_tiles = (f + 31) / 32;
  const long long blocks =
      static_cast<long long>(batch) * num_segments * col_tiles;
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  segment_sum_kernel<<<static_cast<unsigned>(blocks), kBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(seg), static_cast<const float*>(feats), n, f,
      num_segments, col_tiles, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

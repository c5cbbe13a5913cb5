// NDT Gaussian-moment accumulation over dense sorted segment ranks.
//
// Replaces the TPU kernel ndtpu/ops/pallas/segment_moments.py::_moments_kernel
// (launched by _call_moments_kernel, entry fused_moments_sorted, batched by
// its custom_vmap rule). For each cloud b and segment s < num_segments it
// sums, over the points i with seg[b, i] == s, the row
//
//   [v, x, y, z, xx, xy, xz, xy, yy, yz, xz, yz, zz,
//    v * onehot(cls)[0 .. slots), tag_0 .. tag_{T-1}]
//
// (x, y, z = the voxel-center-shifted coordinates xt, yt, zt) into
// out[b, s, :], F = 13 + slots + T columns. Ids >= num_segments are dropped.
// The whole batch is one launch. The row is built in registers from the
// compact inputs; the [N, F] feature matrix never exists in device memory.
//
// Precondition (as for the TPU kernel): each cloud's ids are dense sorted
// ranks, non-decreasing with unit steps, so segment s is the contiguous run
// that starts at lower_bound(seg[b], s).
//
// Design. One warp per (cloud, segment): it finds the run's start by a
// binary search, then lane l sums points start + l, start + l + 32, ... in
// that order, and a fixed shfl_down tree combines the 32 partial sums.
// The summation order depends only on the segment's length, so the result
// is bit-identical from launch to launch; there are no atomics at all.
// The mirrored outer-product entries come from the same accumulators and
// are bit-equal. Class histograms (slots > 0) go to per-lane private
// columns in shared memory, summed over lanes in lane order. Tag columns
// hold at most one nonzero per segment, so their sums are exact. The TPU
// kernel's one-hot matmul on the MXU and its block/sub-block/sublane
// windows exist for the TPU's matrix unit and VMEM and are not carried over.
//
// Bound on an H100: bytes. Each point is read once (seg, xt, yt, zt, v:
// 20 B, + 4 B cls when slots > 0, + 4 B per tag); each output row is written
// once. At the serving shape (B=16, N=70000, num_segments=1209, slots=0,
// T=3) that is 1.12 M points x 32 B + 16 x 1209 x 16 x 4 B ~ 37 MB, about
// 11 us at 3.35 TB/s. The arithmetic (~25 f32 operations a point) is far
// below the card's f32 rate.

#include <cuda_runtime.h>
#include <stdint.h>

#define NDTPU_MAX_TAGS 8

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMoments = 13;

struct TagPtrs {
  const float* p[NDTPU_MAX_TAGS];
};

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

  // lower_bound(sg[0..n), s); every lane runs the same search (the loads
  // are broadcasts)
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(sg + mid) < s) lo = mid + 1; else hi = mid;
  }
  const int start = lo;

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

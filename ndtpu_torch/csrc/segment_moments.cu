// Sorted segment reductions over sorted segment ranks: the three Pallas
// kernels of ndtpu/ops/pallas/segment_moments.py, for sm_90a.
//
//   ndtpu_segment_moments  <- _moments_kernel (entry fused_moments_sorted)
//   ndtpu_segment_tags     <- _tags_kernel    (entry segment_tags_sorted)
//   ndtpu_segment_sum      <- _kernel         (entry segment_sum_sorted)
//
// and K1's two cost probes, ports of the probe bodies of the JAX
// repository's scripts/kernel_micro.py (section "K1's cost probes"):
//
//   ndtpu_moments_empty    <- empty_body  (entry ops/moment_probes.py)
//   ndtpu_moments_noflop   <- noflop_body
//
// Precondition (as for the TPU kernels): each cloud's ids are sorted
// (non-decreasing; the pipeline gives dense ranks with unit steps, gaps are
// allowed), so segment s is the contiguous run that starts at
// lower_bound(seg, s). Ids >= num_segments are dropped and never summed:
// the callers pass only the rows they keep, so the points of a dropped row
// (at the search's early guesses nearly the whole cloud) cost nothing.
//
// All three are bound by bytes on an H100 (3.35 TB/s): each does a few f32
// additions per value it reads. A first port gave each segment a warp
// (K1) or a block (K2, K3) that found its run by a search and walked it
// from device memory: a chain of dependent loads per segment, and one warp
// or block walking the longest run (1782 points in the giant cloud) alone.
//
// All three now share one design: chunks of points streamed through shared
// memory (reduce_chunk). The grid has one block per chunk of a cloud's
// points (range_plan sizes the chunks so the call is one wave of resident
// blocks, at most 3 per SM; K2 adds a grid dimension of column groups where
// whole rows do not fit). A block owns the segments whose first point lies in
// its chunk [c0, c1) (an empty segment belongs to the chunk that holds the
// point where it would start), so every segment has one owner whatever the
// run lengths: no carries between blocks, no second pass, no atomics, one
// launch per call. Three ids of the chunk (before it, at its start, at its
// end) give the owned segments [s_lo, s_hi); two warps find their points
// [p0, p1) with one galloping warp search each (p0 is c0 unless the
// previous chunk's last run reaches into the chunk; p1 lies one run past
// c1): two or three dependent loads per block, no search per segment. A
// chunk in the dropped tail owns nothing and reads nothing more. The block
// then streams [p0, p1) through shared memory in tiles (256 to 1024
// points, at most kStageBytes a stage), two stages deep: the next tile's
// copies in flight while the current one is reduced. A staging policy says
// what a tile holds: K1 and K3 stage compact columns (ColumnStage), K2 the
// ids and a row-major block of F floats a point (RowStage). Each tile's run
// starts come from the staged ids, compacted in order by a ballot per
// warp; a gap in the ids writes the empty rows in between. The tiles start
// at p0, after the searches, not speculatively at c0: the previous run's
// tail before p0 is a tenth of a chunk at the giant cloud, and with the L2
// flushed the bytes, not the searches, set the time (PERF.md).
//
// Summation order (all three). The runs of a block go to its warps in
// turn (run r to warp r mod kRangeWarps). Lane l adds the points of its run
// whose offset from the run's first point is l modulo 32, in index order;
// a run that crosses a tile edge keeps its partial sums (K1, K3 in the
// warp's registers, K2 in a shared-memory carry). The lanes are then
// combined by warp_reduce_scatter: 5 additions on every term's path, in a
// fixed pattern. The order depends only on the run: not on the chunks, the
// tiles, the column groups or the launch, so two launches are
// bit-identical. Each lane adds at most ceil(L / 32) terms of a run of L
// points (the error bounds in ops/segment_moments.py follow from that).
// Class histograms (K1, slots > 0) go to per-lane private columns in shared
// memory, summed over lanes in lane order.
//
// Every entry returns cudaGetLastError() after its launch (0 = success) and
// launches on the stream it is given.

#include <cuda_runtime.h>
#include <stdint.h>

#define NDTPU_MAX_TAGS 8

namespace {

// The chunk kernels (the Python mirror is range_plan in
// ops/segment_moments.py). Chosen on the H100 at the serving and giant
// shapes from a sweep of warps per block (4, 8, 16), stage sizes (8 to
// 64 KB) and blocks per call (128 to 1536): about 3 blocks an SM, in one
// wave.
constexpr int kRangeWarps = 4;
constexpr int kRangeThreads = kRangeWarps * 32;
constexpr int kStageBytes = 32 * 1024;  // a stage's columns, at most
constexpr int kMinTile = 256, kMaxTile = 1024;
constexpr int kMinChunk = 512, kChunkStep = 256;
constexpr long long kSMs = 132;  // an H100 SXM's
constexpr long long kBlocksPerSM = 3;  // the most the plan keeps resident
constexpr long long kSmemPerSM = 228 * 1024;  // an SM's shared memory
constexpr long long kSmemReserved = 1024;  // what the card keeps per block
constexpr long long kMaxSmem = 227 * 1024;  // a block's dynamic shared memory
constexpr int kGroupWidth = 32;  // K2: columns of a grid column group
constexpr int kMoments = 13;
// Values a warp's lane holds for one run: K1's 10 moment sums and 8 tags.
constexpr int kLaneValues = kMoments - 3 + NDTPU_MAX_TAGS;

// Column slots of a column-staged kernel: 0 seg (int32), 1-4 xt, yt, zt,
// v, 5-12 the tag columns, 13 cls (int32). A null pointer is a column the
// kernel does not read; only the others take room in shared memory.
constexpr int kSeg = 0, kXt = 1, kV = 4, kTag0 = 5, kCls = 13;
constexpr int kMaxCols = 14;

struct Cols {
  const float* p[kMaxCols];
};

struct RangePlan {
  int chunk;  // points per block
  int tile;   // points per tile
  int groups;  // K2's column groups (the grid's y), else 1
  long long blocks;  // chunks of every cloud x groups
  long long smem;
};

// Tile: the largest power of two in [kMinTile, kMaxTile] whose n_cols
// columns fit kStageBytes. Shared memory: two stages of n_cols columns of
// tile + 8 floats (the point before the tile and the 16-byte edges), each
// warp's per-lane histograms (slots columns of 32), K2's carry (two
// buffers of carry columns of 32), the tile's run starts. Chunk: the grid
// is one wave of the blocks the card keeps resident (kBlocksPerSM on each
// SM, fewer where their shared memory does not fit): each cloud and column
// group gets an equal share of them, the chunk is a cloud's points over
// its share, rounded up to a multiple of kChunkStep, at least kMinChunk. A
// second, partial wave would leave most SMs idle while it runs.
RangePlan range_plan(int batch, int n, long long n_cols, int slots,
                     int carry, int groups) {
  RangePlan plan;
  plan.tile = kMaxTile;
  while (plan.tile > kMinTile && n_cols * plan.tile * 4 > kStageBytes)
    plan.tile /= 2;
  const long long scratch = 32LL * (kRangeWarps * slots + 2LL * carry);
  plan.smem = 4 * (2 * n_cols * (plan.tile + 8) + scratch) + 4LL * plan.tile;
  const long long fit = kSmemPerSM / (plan.smem + kSmemReserved);
  const long long per_sm = fit < 1 ? 1 : fit < kBlocksPerSM ? fit : kBlocksPerSM;
  const long long grids = static_cast<long long>(batch) * groups;
  const long long share = kSMs * per_sm > grids ? kSMs * per_sm / grids : 1;
  const long long per_chunk = (n + share - 1) / share;
  const long long rounded = (per_chunk + kChunkStep - 1) / kChunkStep * kChunkStep;
  plan.chunk = rounded < kMinChunk ? kMinChunk : static_cast<int>(rounded);
  plan.groups = groups;
  plan.blocks = grids * ((n + plan.chunk - 1) / plan.chunk);
  return plan;
}

// K2's layout: columns per block (width), floats between staged rows
// (pitch), column groups. Whole rows where two stages of them fit a block
// at the smallest tile, else groups of kGroupWidth columns. Whole rows of
// F % 4 != 0 floats are staged as the contiguous span they are (pitch F:
// lanes reading one column of 32 consecutive rows meet at most 2-way bank
// conflicts). Any other layout is staged row by row in whole 16-byte units
// (up to 3 floats of lead and 3 of tail) at a pitch of an odd number of
// units: at most 4-way conflicts, where a pitch of F = 32 would put all 32
// lanes on one bank.
struct SumPlan {
  RangePlan range;
  int width, pitch;
};

// Floats a row of w takes staged in 16-byte units: 4 x an odd number of
// units, at least those of w floats after a lead of up to 3.
long long unit_pitch(long long w) { return 4 * (((w + 6) >> 2) | 1); }

SumPlan sum_plan(int batch, int n, int f) {
  SumPlan p;
  p.width = f;
  p.pitch = f % 4 ? f : static_cast<int>(unit_pitch(f));
  p.range = range_plan(batch, n, 1LL + p.pitch, 0, p.width, 1);
  if (p.range.smem > kMaxSmem) {
    p.width = kGroupWidth;
    p.pitch = static_cast<int>(unit_pitch(kGroupWidth));
    p.range = range_plan(batch, n, 1LL + p.pitch, 0, p.width,
                         (f + kGroupWidth - 1) / kGroupWidth);
  }
  return p;
}

// First index i in [lo, hi) with sg[i] >= s (hi if none), for sorted sg.
// Called by all 32 lanes of a warp: each round probes 32 evenly spaced
// positions and keeps the gap where the ids cross s (a ballot), so a
// search over N ids takes about log_33(N) dependent loads (4 for a million
// points) instead of log_2(N) (20).
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

// The same, for an answer expected near lo: lane l probes lo + 2^l - 1, so
// the first round brackets an answer d points away in a window of ~d / 2,
// and warp_lower_bound finishes it (2 to 3 dependent loads for d < 1000).
__device__ __forceinline__ int warp_gallop(const int* __restrict__ sg, int lo,
                                           int hi, long long s) {
  const int lane = threadIdx.x & 31;
  const long long probe = lo + (1LL << lane) - 1;
  const unsigned ge = __ballot_sync(
      0xffffffffu, probe >= hi || __ldg(sg + probe) >= s);  // lane 31 >= hi
  const int f = __ffs(ge) - 1;
  if (f == 0) return lo;
  return warp_lower_bound(sg, lo + (1 << (f - 1)),
                          static_cast<int>(min(static_cast<long long>(hi), lo + (1LL << f) - 1)),
                          s);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// Halving steps of warp_reduce_scatter, from width W down to 1.
template <int W, int S>
__device__ __forceinline__ void halve(float (&v)[S], int lane) {
  if constexpr (W >= 1) {
    const bool upper = lane & W;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const float send = upper ? v[i] : v[i + W];
      v[i] = (upper ? v[i + W] : v[i]) + __shfl_xor_sync(0xffffffffu, send, W);
    }
    halve<W / 2>(v, lane);
  }
}

// Sums each of the S values of v over the warp's 32 lanes; lane l returns
// the sum of value l mod S. The order is fixed: log2(S) halving steps (a
// lane keeps one half of its values and adds its partner's copy of that
// half), then butterfly levels over the lane bits left: 5 additions on
// every term's path, S - 1 + log2(32 / S) shuffles (a tree per value
// takes 5 S).
template <int S>
__device__ __forceinline__ float warp_reduce_scatter(float (&v)[S]) {
  halve<S / 2>(v, threadIdx.x & 31);
  float total = v[0];
#pragma unroll
  for (int w = S; w < 32; w <<= 1)
    total += __shfl_xor_sync(0xffffffffu, total, w);
  return total;
}

// How many floats p lies past its 16-byte unit's start.
__device__ __forceinline__ int lead_of(const void* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// Start the 16-byte copies of the count floats at src into dst, which gets
// them from dst[lead_of(src)] on. The span's ragged edges may bring up to 3
// floats on either side, never outside the 16-byte-aligned unit of a valid
// float (so never on an unmapped page); the readers read only the span.
__device__ __forceinline__ void issue_span(const float* src, int count,
                                           float* dst) {
  const int lead = lead_of(src);
  const float* aligned = src - lead;
  const int chunks = (lead + count + 3) >> 2;
  for (int k = threadIdx.x; k < chunks; k += kRangeThreads)
    cp_async16(dst + 4 * k, aligned + 4 * k);
}

// The rows of a [batch, num_segments, f] output table.
struct Rows {
  float* out;
  int f, num_segments;

  // rows [from, to) of cloud b, zeroed by the threads i, i + stride, ...
  __device__ __forceinline__ void zero(int b, int from, int to, int i,
                                       int stride) const {
    float* row = out + (static_cast<long long>(b) * num_segments + from) * f;
    for (long long k = i; k < static_cast<long long>(to - from) * f; k += stride)
      row[k] = 0.0f;
  }
};

// K2: columns [c0, c0 + w) of the rows (all of them but in column groups).
struct GroupRows {
  float* out;
  int f, num_segments, c0, w;

  __device__ __forceinline__ void zero(int b, int from, int to, int i,
                                       int stride) const {
    if (w == f) return Rows{out, f, num_segments}.zero(b, from, to, i, stride);
    float* row = out + (static_cast<long long>(b) * num_segments + from) * f + c0;
    for (int s = 0; s < to - from; ++s)
      for (int c = i; c < w; c += stride) row[static_cast<long long>(s) * f + c] = 0.0f;
  }
};

// ---- staging policies ----
//
// A policy gives reduce_chunk the ids (seg_ids, for the ownership and the
// searches), the floats a stage takes, the copies of points [lo, hi) of
// cloud b (base = b * n) into a stage, and a view of a landed stage: the
// staged ids (ids[g] for g in [lo, hi)) and what the op reads.

// K1, K3: the non-null columns of cols, each in its own slot of tile + 8
// floats; column c's point g at stage[slot(c) * (tile + 8) + lead + g - lo].
struct ColumnView {
  const float* stage;
  int off[kMaxCols];  // column c of point g at stage[off[c] + g]
  const int* ids;
};

struct ColumnStage {
  Cols cols;

  __device__ __forceinline__ const int* seg_ids() const {
    return reinterpret_cast<const int*>(cols.p[kSeg]);
  }

  __device__ __forceinline__ int floats(int tile) const {
    int n_cols = 0;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) n_cols += cols.p[c] != nullptr;
    return n_cols * (tile + 8);
  }

  __device__ __forceinline__ void issue(long long base, int lo, int hi,
                                        int tile, float* stage) const {
    int slot = 0;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      if (cols.p[c] == nullptr) continue;
      issue_span(cols.p[c] + base + lo, hi - lo, stage + slot++ * (tile + 8));
    }
  }

  __device__ __forceinline__ ColumnView view(const float* stage,
                                             long long base, int lo,
                                             int tile) const {
    ColumnView v;
    v.stage = stage;
    int slot = 0;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      if (cols.p[c] == nullptr) {
        v.off[c] = 0;
        continue;
      }
      v.off[c] = slot++ * (tile + 8) + lead_of(cols.p[c] + base + lo) - lo;
    }
    v.ids = reinterpret_cast<const int*>(stage) + v.off[kSeg];
    return v;
  }
};

// K2: the ids in a slot of tile + 8 floats, then columns [c0, c0 + w) of
// each row of a row-major [N, f] block. Whole rows at pitch f are one
// contiguous span; other rows are staged one by one in the 16-byte units
// that hold their w floats, row r (= g - lo) at r * pitch, its first float
// lead(r) floats into it (a lane a unit, 32 / units rows a warp at once).
struct RowView {
  const int* ids;
  const float* rows;
  int lo, pitch, lead0, step;  // lead(r) = (lead0 + r * step) & 3

  __device__ __forceinline__ const float* row(int g) const {
    const int r = g - lo;
    return rows + r * pitch + ((lead0 + r * step) & 3);
  }
};

struct RowStage {
  const int* seg;
  const float* feats;
  int f, pitch, c0, w;

  __device__ __forceinline__ const int* seg_ids() const { return seg; }

  __device__ __forceinline__ int floats(int tile) const {
    return (1 + pitch) * (tile + 8);
  }

  __device__ __forceinline__ const float* first_row(long long base,
                                                    int lo) const {
    return feats + (base + lo) * f + c0;
  }

  __device__ __forceinline__ void issue(long long base, int lo, int hi,
                                        int tile, float* stage) const {
    issue_span(reinterpret_cast<const float*>(seg) + base + lo, hi - lo, stage);
    float* dst = stage + tile + 8;
    const float* src = first_row(base, lo);
    if (pitch == f) {
      issue_span(src, (hi - lo) * f, dst);
      return;
    }
    const int units = pitch / 4, at_once = 32 / units;
    const int lane = threadIdx.x & 31, q = lane / units, u = lane - q * units;
    if (q >= at_once) return;
    for (int r = (threadIdx.x >> 5) * at_once + q; r < hi - lo;
         r += kRangeWarps * at_once) {
      const float* row = src + static_cast<long long>(r) * f;
      const int lead = lead_of(row);
      if (u < (lead + w + 3) >> 2)
        cp_async16(dst + r * pitch + 4 * u, row - lead + 4 * u);
    }
  }

  __device__ __forceinline__ RowView view(const float* stage, long long base,
                                          int lo, int tile) const {
    return {reinterpret_cast<const int*>(stage) + lead_of(seg + base + lo) - lo,
            stage + tile + 8, lo, pitch, lead_of(first_row(base, lo)),
            pitch == f ? 0 : f & 3};
  }
};

// The chunk kernels' common body (the note at the top of the file). Op:
// run(view, g0, to, t, resume, closes, b, s) adds this lane's points g0,
// g0 + 32, ... below `to` of tile t's part of the run of segment s of
// cloud b (resume: the run began in an earlier tile, whose sums the op
// kept), and if closes, combines the lanes and writes row s; reset()
// clears a warp's sums before its first run. rows is the output (Rows or
// GroupRows). Shared memory: the stages, then the op's scratch, then the
// tile's run starts.
template <class Stage, class Out, class Op>
__device__ __forceinline__ void reduce_chunk(const Stage& in, int n,
                                             int chunk, int tile,
                                             float* stages, int* runs,
                                             const Out& rows, Op& op) {
  __shared__ int interval[2];
  constexpr int kMaxRounds = kMaxTile / kRangeThreads;
  __shared__ int starts_of[kMaxRounds][kRangeWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k = rows.num_segments;
  const int chunks = (n + chunk - 1) / chunk;
  const int b = blockIdx.x / chunks;
  const int c0 = (blockIdx.x % chunks) * chunk;
  const int c1 = min(c0 + chunk, n);
  const long long base = static_cast<long long>(b) * n;
  const int* sg = in.seg_ids() + base;

  // owned segments [s_lo, s_hi): those that start in [c0, c1)
  const int before = c0 > 0 ? __ldg(sg + c0 - 1) : -1;
  const int first = __ldg(sg + c0);
  const int last = __ldg(sg + c1 - 1);
  const int s_lo = c0 > 0 ? min(max(before + 1, 0), k) : 0;
  const int s_hi = c1 < n ? min(max(last + 1, 0), k) : k;
  if (s_lo >= s_hi) return;

  const int stage_floats = in.floats(tile);
  if (warp == 0) {
    const int p = first > before && first >= s_lo ? c0
                                                  : warp_gallop(sg, c0, n, s_lo);
    if (lane == 0) interval[0] = p;
  } else if (warp == 1) {
    const int p = warp_gallop(sg, last < k ? c1 : c0, n, s_hi);
    if (lane == 0) interval[1] = p;
  }
  __syncthreads();
  const int p0 = interval[0], p1 = interval[1];
  const int tiles = (p1 - p0 + tile - 1) / tile;
  if (tiles > 0) in.issue(base, p0, min(p0 + tile, p1), tile, stages);
  cp_async_commit();
  const int rounds = tile / kRangeThreads;

  int run_base = 0;  // runs that started in earlier tiles
  int open_start = 0, open_id = 0;  // this warp's run across the tile edge
  op.reset();
  for (int t = 0; t < tiles; ++t) {
    const int start = p0 + t * tile;
    const int end = min(start + tile, p1);
    if (t + 1 < tiles)  // the next tile, with the point before it
      in.issue(base, end - 1, min(end + tile, p1), tile,
               stages + ((t + 1) & 1) * stage_floats);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile t has landed for every thread

    const int lo = t == 0 ? p0 : start - 1;
    const auto view = in.view(stages + (t & 1) * stage_floats, base, lo, tile);
    const int* ids = view.ids;

    // run starts of this tile, in order: in round i thread x looks at
    // point start + i * kRangeThreads + x (neighbouring lanes, neighbouring
    // words), a ballot per warp and a count per (round, warp) place them;
    // a gap in the ids (from s_lo at p0) writes the empty rows in between
    unsigned found[kMaxRounds];
    int n_runs = 0;
#pragma unroll
    for (int i = 0; i < kMaxRounds; ++i) {
      const int g = start + i * kRangeThreads + threadIdx.x;
      bool first_of_run = false;
      if (i < rounds && g < end) {
        const int prev = g == p0 ? s_lo - 1 : ids[g - 1];
        first_of_run = g == p0 || ids[g] != prev;
        if (first_of_run && ids[g] > prev + 1) rows.zero(b, prev + 1, ids[g], 0, 1);
      }
      found[i] = __ballot_sync(0xffffffffu, first_of_run);
      if (lane == 0 && i < rounds) starts_of[i][warp] = __popc(found[i]);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kMaxRounds; ++i) {
      if (i >= rounds) break;
      int pos = n_runs + __popc(found[i] & ((1u << lane) - 1u));
#pragma unroll
      for (int w = 0; w < kRangeWarps; ++w) {
        pos += w < warp ? starts_of[i][w] : 0;
        n_runs += starts_of[i][w];
      }
      if (found[i] >> lane & 1u) runs[pos] = start + i * kRangeThreads + threadIdx.x;
    }
    __syncthreads();  // the tile's runs are known

    // runs run_base - 1 (open at the last tile's end; it may close here
    // with no point) .. run_base + n_runs - 1
    const int r_end = run_base + n_runs;
    int r = t > 0 ? run_base - 1 : run_base;
    for (r += (warp - r % kRangeWarps + kRangeWarps) % kRangeWarps; r < r_end;
         r += kRangeWarps) {
      const int st = r >= run_base ? runs[r - run_base] : open_start;
      const int id = r >= run_base ? ids[st] : open_id;
      const bool closes = r + 1 < r_end || end == p1;
      const int to = r + 1 < r_end ? runs[r + 1 - run_base] : end;
      const int a = max(st, start);
      op.run(view, a + ((st + lane - a) & 31), to, t, st < start, closes, b, id);
      if (!closes) {
        open_start = st;
        open_id = id;
      }
    }
    run_base = r_end;
    __syncthreads();  // the stage and the runs may be overwritten
  }
  cp_async_wait<0>();
  // the empty rows after the last point (all of them if there is none)
  rows.zero(b, p1 > p0 ? __ldg(sg + p1 - 1) + 1 : s_lo, s_hi, threadIdx.x,
            kRangeThreads);
}

// The run step of an op that keeps a run's sums in its warp's registers
// across tiles (K1, K3): add(view, g) adds point g, finish(b, s) combines
// the lanes and writes row s.
template <class Op, class View>
__device__ __forceinline__ void run_in_registers(Op& op, const View& v, int g0,
                                                 int to, bool closes, int b,
                                                 int s) {
  for (int g = g0; g < to; g += 32) op.add(v, g);
  if (closes) {
    op.finish(b, s);
    op.reset();
  }
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
// the staged compact columns; the [N, F] feature matrix never exists in
// device memory. The mirrored outer-product entries come from the same
// sums and are bit-equal. Tag columns hold at most one nonzero per
// segment, so their sums are exact.
//
// Bound: each kept point is read once (seg, xt, yt, zt, v: 20 B, + 4 B cls
// when slots > 0, + 4 B per tag); each output row is written once. At the
// serving shape (B=16, N=70000, num_segments=1209, slots=0, T=3) that is
// 1.12 M points x 32 B + 16 x 1209 x 16 x 4 B ~ 37 MB, about 11 us at
// 3.35 TB/s; the plan gives 3072-point chunks (368 blocks) and 1024-point
// tiles there. Beyond the bound the kernel reads the point before each tile
// again and the searches' few probes. The arithmetic (~25 f32 operations a
// point) is far below the card's f32 rate.

// K1's row build for point g of a staged view: adds its 10 moment products
// and its tags into acc and tag_acc, and returns its validity w, which the
// class columns take. The cost probe P2 (below) builds its rows with it too.
__device__ __forceinline__ float add_moment_row(const ColumnView& v, int g,
                                                int n_tags,
                                                float (&acc)[kMoments - 3],
                                                float (&tag_acc)[NDTPU_MAX_TAGS]) {
  const float* stage = v.stage;
  const float x = stage[v.off[kXt] + g], y = stage[v.off[kXt + 1] + g],
              z = stage[v.off[kXt + 2] + g], w = stage[v.off[kV] + g];
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
    if (t < n_tags) tag_acc[t] += stage[v.off[kTag0 + t] + g];
  return w;
}

// The class of point g (slots > 0: the cls column is staged).
__device__ __forceinline__ int class_of(const ColumnView& v, int g) {
  return __float_as_int(v.stage[v.off[kCls] + g]);
}

// Output column of K1's moment sum j (v, x, y, z, xx, xy, xz, yy, yz, zz);
// xy, xz and yz also go to their mirrors (mirror_column).
__device__ __forceinline__ int moment_column(int j) {
  return j < 7 ? j : j == 7 ? 8 : j == 8 ? 9 : 12;
}

__device__ __forceinline__ int mirror_column(int j) {
  return j == 5 ? 7 : j == 6 ? 10 : j == 8 ? 11 : -1;
}

struct MomentsOp {
  float acc[kMoments - 3];  // v, x, y, z, xx, xy, xz, yy, yz, zz
  float tag_acc[NDTPU_MAX_TAGS];
  float* hist;  // this warp's [slots][32] lane columns
  int slots, n_tags;
  Rows rows;

  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int j = 0; j < kMoments - 3; ++j) acc[j] = 0.0f;
#pragma unroll
    for (int t = 0; t < NDTPU_MAX_TAGS; ++t) tag_acc[t] = 0.0f;
    const int lane = threadIdx.x & 31;
    for (int c = 0; c < slots; ++c) hist[c * 32 + lane] = 0.0f;
  }

  __device__ __forceinline__ void run(const ColumnView& v, int g0, int to,
                                      int, bool, bool closes, int b, int s) {
    run_in_registers(*this, v, g0, to, closes, b, s);
  }

  __device__ __forceinline__ void add(const ColumnView& v, int g) {
    const float w = add_moment_row(v, g, n_tags, acc, tag_acc);
    if (slots > 0) {
      const int c = class_of(v, g);
      if (c >= 0 && c < slots) hist[c * 32 + (threadIdx.x & 31)] += w;
    }
  }

  __device__ __forceinline__ void finish(int b, int s) {
    if (n_tags <= 6)
      combine<16>(b, s);
    else
      combine<32>(b, s);
    if (slots > 0) {
      const int lane = threadIdx.x & 31;
      float* row = rows.out +
                   (static_cast<long long>(b) * rows.num_segments + s) * rows.f;
      __syncwarp();
      for (int c = lane; c < slots; c += 32) {
        float h = 0.0f;
        for (int l = 0; l < 32; ++l) h += hist[c * 32 + l];
        row[kMoments + c] = h;
      }
      __syncwarp();  // read before the next reset clears it
    }
  }

  // The 10 moment sums and the tags as S values (S = 16 holds 6 tags);
  // lane j < 10 + n_tags writes value j.
  template <int S>
  __device__ __forceinline__ void combine(int b, int s) {
    float v[S];
#pragma unroll
    for (int j = 0; j < S; ++j) {
      if (j < kMoments - 3)
        v[j] = acc[j];
      else if (j < kLaneValues)
        v[j] = tag_acc[j - (kMoments - 3)];
      else
        v[j] = 0.0f;
    }
    const float total = warp_reduce_scatter(v);
    const int j = threadIdx.x & 31;
    float* row = rows.out +
                 (static_cast<long long>(b) * rows.num_segments + s) * rows.f;
    if (j < kMoments - 3) {
      // v, x, y, z, xx, xy, xz, yy, yz, zz -> columns; xy, xz, yz twice
      row[moment_column(j)] = total;
      if (mirror_column(j) >= 0) row[mirror_column(j)] = total;
    } else if (j < kMoments - 3 + n_tags) {
      row[kMoments + slots + j - (kMoments - 3)] = total;
    }
  }
};

__global__ void __launch_bounds__(kRangeThreads) segment_moments_kernel(
    ColumnStage in, int n_tags, int n, int num_segments, int slots, int chunk,
    int tile, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  // [stages][histograms][runs]
  float* hist = smem + 2 * in.floats(tile);
  const int f = kMoments + slots + n_tags;
  const Rows rows = {out, f, num_segments};
  MomentsOp op{{}, {}, hist + (threadIdx.x >> 5) * slots * 32, slots, n_tags, rows};
  reduce_chunk(in, n, chunk, tile, smem,
               reinterpret_cast<int*>(hist + kRangeWarps * slots * 32), rows, op);
}

// ---- K1's cost probes (P1, P2) ----
//
// Ports of the two probe bodies of the JAX repository's
// scripts/kernel_micro.py (empty_body :147, noflop_body :154, both launched
// by probe_call :133 at K1's grid). With K1 they split K1's time: P1 is the
// launch and grid floor, P2 adds the streaming of K1's columns and K1's row
// build, and K1 adds the segmented reduce and the class histograms. Both
// launch with K1's plan (range_plan of K1's staged columns and slots: the
// same blocks, threads and dynamic shared memory), so occupancy matches.
//
// P1 (ndtpu_moments_empty): K1's launch whose body only zeroes the output
// [B, K, F] (the TPU body zeroes it at grid step 0; here every block takes
// a grid-stride share of it); it reads nothing.
//
// P2 (ndtpu_moments_noflop): each block streams its raw chunk [c0, c1) of
// every column through shared memory as K1 does (ColumnStage, cp.async,
// two stages), with no ownership, no searches and no run starts (so it
// reads the bytes K1 reads, but for the point before each tile and the
// searches' probes). Each thread builds K1's row of every point of its
// tile with id >= 0 (add_moment_row; the class columns as v * (cls == c)
// in registers, no histogram) and keeps the F column totals in registers.
// A block then sums its threads' totals in a fixed order (a butterfly over
// each warp's lanes, then the warps in turn) into its row of a [blocks, F]
// scratch, and a second pass sums the blocks in order, writes the totals
// into rows 0-7 of the flat [B K, F] output and zeroes the rest. No atomics,
// bit-identical from launch to launch. Class slots are capped at
// kProbeMaxSlots (registers); the repo's paths use at most 29.

constexpr int kProbeMaxSlots = 32;
constexpr int kProbeRows = 8;  // the TPU body's strip (_SUBLANE rows)

__global__ void __launch_bounds__(kRangeThreads) moments_empty_kernel(
    long long size, float* __restrict__ out) {
  const long long blocks = static_cast<long long>(gridDim.x) * gridDim.y;
  const long long block = static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x;
  for (long long i = block * kRangeThreads + threadIdx.x; i < size;
       i += blocks * kRangeThreads)
    out[i] = 0.0f;
}

// S: the class columns a thread keeps (0, 1 or kProbeMaxSlots, of which
// the first slots are used).
template <int S>
struct NoflopSums {
  float acc[kMoments - 3];
  float tag_acc[NDTPU_MAX_TAGS];
  float slot_acc[S > 0 ? S : 1];
  int slots, n_tags;

  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int j = 0; j < kMoments - 3; ++j) acc[j] = 0.0f;
#pragma unroll
    for (int t = 0; t < NDTPU_MAX_TAGS; ++t) tag_acc[t] = 0.0f;
#pragma unroll
    for (int c = 0; c < S; ++c) slot_acc[c] = 0.0f;
  }

  __device__ __forceinline__ void add(const ColumnView& v, int g) {
    if (v.ids[g] < 0) return;  // the TPU body's mask seg >= 0
    const float w = add_moment_row(v, g, n_tags, acc, tag_acc);
    if constexpr (S > 0) {
      const int c = class_of(v, g);
#pragma unroll
      for (int s = 0; s < S; ++s)
        if (s < slots) slot_acc[s] += c == s ? w : 0.0f;
    }
  }
};

// The sum of x over the warp's lanes, as lane 0 gets it (a fixed butterfly).
__device__ __forceinline__ float warp_total(float x) {
#pragma unroll
  for (int w = 16; w >= 1; w >>= 1) x += __shfl_xor_sync(0xffffffffu, x, w);
  return x;
}

template <int S>
__global__ void __launch_bounds__(kRangeThreads) moments_noflop_kernel(
    ColumnStage in, int n_tags, int n, int slots, int chunk, int tile,
    float* __restrict__ partial) {
  extern __shared__ __align__(16) float smem[];
  // value i of a thread: the 10 moment sums, the 8 tags, the S classes
  constexpr int kValues = kMoments - 3 + NDTPU_MAX_TAGS + S;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int chunks = (n + chunk - 1) / chunk;
  const int b = blockIdx.x / chunks;
  const int c0 = (blockIdx.x % chunks) * chunk;
  const int c1 = min(c0 + chunk, n);
  const long long base = static_cast<long long>(b) * n;
  const int stage_floats = in.floats(tile);

  NoflopSums<S> op;
  op.slots = slots;
  op.n_tags = n_tags;
  op.reset();
  const int tiles = (c1 - c0 + tile - 1) / tile;
  in.issue(base, c0, min(c0 + tile, c1), tile, smem);
  cp_async_commit();
  for (int t = 0; t < tiles; ++t) {
    const int start = c0 + t * tile;
    const int end = min(start + tile, c1);
    if (t + 1 < tiles)
      in.issue(base, end, min(end + tile, c1), tile,
               smem + ((t + 1) & 1) * stage_floats);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile t has landed for every thread
    const auto view = in.view(smem + (t & 1) * stage_floats, base, start, tile);
    for (int g = start + threadIdx.x; g < end; g += kRangeThreads) op.add(view, g);
    __syncthreads();  // the stage may be overwritten
  }
  cp_async_wait<0>();

  // the warps' totals [kRangeWarps][kValues] in the stages, which are free
  float* warp_sums = smem;
#pragma unroll
  for (int i = 0; i < kValues; ++i) {
    float x;
    if (i < kMoments - 3)
      x = op.acc[i];
    else if (i < kMoments - 3 + NDTPU_MAX_TAGS)
      x = op.tag_acc[i - (kMoments - 3)];
    else
      x = op.slot_acc[i - (kMoments - 3 + NDTPU_MAX_TAGS)];
    const float total = warp_total(x);
    if (lane == 0) warp_sums[warp * kValues + i] = total;
  }
  __syncthreads();
  // column c of this block's row: value i summed over the warps in turn
  const int f = kMoments + slots + n_tags;
  for (int c = threadIdx.x; c < f; c += kRangeThreads) {
    int i;
    if (c < kMoments) {
      i = 0;
#pragma unroll
      for (int j = 0; j < kMoments - 3; ++j)
        if (moment_column(j) == c || mirror_column(j) == c) i = j;
    } else if (c < kMoments + slots) {
      i = kMoments - 3 + NDTPU_MAX_TAGS + (c - kMoments);
    } else {
      i = kMoments - 3 + (c - kMoments - slots);
    }
    float total = warp_sums[i];
#pragma unroll
    for (int w = 1; w < kRangeWarps; ++w) total += warp_sums[w * kValues + i];
    partial[static_cast<long long>(blockIdx.x) * f + c] = total;
  }
}

// P2's second pass: out[r, c] for the flat [rows, f] output is the sum of
// partial[0 .. blocks) column c, in block order, for r < kProbeRows, else 0.
__global__ void moments_noflop_finish(const float* __restrict__ partial,
                                      int blocks, int f, long long rows,
                                      float* __restrict__ out) {
  const long long total = rows * f;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float x = 0.0f;
    if (i < static_cast<long long>(kProbeRows) * f) {
      const int c = static_cast<int>(i % f);
      for (int k = 0; k < blocks; ++k) x += partial[static_cast<long long>(k) * f + c];
    }
    out[i] = x;
  }
}

// ---- sparse per-segment tags (K3) ----
//
// out[s, t] = the sum of tags[t][i] over the points i with seg[i] == s, for
// s < num_segments and T <= 8 columns, one cloud (1-D, as the TPU entry).
// The callers put at most one nonzero in a segment (12-bit splits of an
// integer key on each run's first row), so every sum is exact in f32. The
// kernel still sums the whole run in the fixed order above, so it computes
// what _tags_kernel computes also where that does not hold.
//
// Bound: the T tags of every point of a kept segment read once (4T B), the
// [num_segments, T] table written once. At the giant cloud's accepted size
// (N = 1,048,576, T = 4, num_segments = 2504) that is ~16.8 MB, about
// 5.0 us at 3.35 TB/s. This kernel also reads every kept point's id (4 B
// more a point, ~4.2 MB, which the bound does not count): the run starts
// come from the staged ids instead of a search per segment. The plan gives
// 2816-point chunks (373 blocks) and 1024-point tiles there.

struct TagsOp {
  float tag_acc[NDTPU_MAX_TAGS];
  int n_tags;
  Rows rows;

  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int t = 0; t < NDTPU_MAX_TAGS; ++t) tag_acc[t] = 0.0f;
  }

  __device__ __forceinline__ void run(const ColumnView& v, int g0, int to,
                                      int, bool, bool closes, int b, int s) {
    run_in_registers(*this, v, g0, to, closes, b, s);
  }

  __device__ __forceinline__ void add(const ColumnView& v, int g) {
#pragma unroll
    for (int t = 0; t < NDTPU_MAX_TAGS; ++t)
      if (t < n_tags) tag_acc[t] += v.stage[v.off[kTag0 + t] + g];
  }

  __device__ __forceinline__ void finish(int, int s) {
    const float total = warp_reduce_scatter(tag_acc);
    const int t = threadIdx.x & 31;
    if (t < n_tags) rows.out[static_cast<long long>(s) * n_tags + t] = total;
  }
};

__global__ void __launch_bounds__(kRangeThreads) segment_tags_kernel(
    ColumnStage in, int n_tags, int n, int num_segments, int chunk, int tile,
    float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const Rows rows = {out, n_tags, num_segments};
  TagsOp op{{}, n_tags, rows};
  reduce_chunk(in, n, chunk, tile, smem,
               reinterpret_cast<int*>(smem + 2 * in.floats(tile)), rows, op);
}

// ---- generic sorted segment sum (K2) ----
//
// Replaces _kernel (ndtpu/ops/pallas/segment_moments.py:56, entry
// segment_sum_sorted): out[b, s, c] = the sum of feats[b, i, c] over the
// points i with seg[b, i] == s, for s < num_segments, feats row-major
// [batch, N, F] f32, any F >= 1 (the moments give 13 + slots, 14 for the
// giant oracle, 41 with 28 class slots).
//
// The chunk design above with RowStage: each tile stages the ids and the
// rows of its points, the TPU kernel's [block_n, F] VMEM window. sum_plan
// picks whole rows (width F) where two stages fit at the smallest tile
// (F <= 95; F <= 88 for F % 4 == 0), else a grid dimension of column
// groups of kGroupWidth: each block then stages the ids and its slice of
// each row (the layouts at sum_plan). The warp of a run walks the run's
// staged rows once per pass of up to S = 16 or 32 columns (the lane's
// sums in registers): lane l adds the rows at offset l mod 32
// from the run's start, in index order, then warp_reduce_scatter<S> joins
// the lanes and lane j writes column j of the pass. A run open at a tile's
// end parks its lane sums in a shared [width][32] carry and its warp takes
// them back in the next tile. One run at a time is open, but the next
// tile's open run may be parked before they are taken back: the carry has
// two buffers, by the parity of the tile that parks. The order is K1's and
// K3's: (ceil(L / 32) + 5) u sum|terms| for a run of L rows
// (segment_sum_error_bound), whatever F and the grouping.
//
// Bound: the F floats of every kept point read once, the [num_segments, F]
// rows written once. For the giant oracle (N = 1,048,576, F = 14,
// num_segments = 2504) that is 58.86 MB, about 17.6 us at 3.35 TB/s. The
// kernel also reads every kept point's id (4 B a point, 4.19 MB there, not
// in the bound) for its run starts, and the point before each tile again.
// The plan gives 2816-point chunks (373 blocks), 512-point tiles and
// 66.4 KB of shared memory (3 blocks an SM) there.

template <int S>
struct SumOp {
  float* carry;  // [2][w][32]: the lane sums of the run open at a tile's end
  GroupRows rows;

  __device__ __forceinline__ void reset() {}

  __device__ __forceinline__ void run(const RowView& v, int g0, int to, int t,
                                      bool resume, bool closes, int b, int s) {
    const int lane = threadIdx.x & 31;
    const int w = rows.w;
    const float* parked = carry + ((t + 1) & 1) * 32 * w + lane;  // by t - 1
    float* park = carry + (t & 1) * 32 * w + lane;
    for (int q = 0; q < w; q += S) {
      float acc[S];
#pragma unroll
      for (int j = 0; j < S; ++j)
        acc[j] = resume && q + j < w ? parked[(q + j) * 32] : 0.0f;
      for (int g = g0; g < to; g += 32) {
        const float* row = v.row(g) + q;
#pragma unroll
        for (int j = 0; j < S; ++j)
          if (q + j < w) acc[j] += row[j];
      }
      if (closes) {
        const float total = warp_reduce_scatter(acc);
        if (lane < S && q + lane < w)
          rows.out[(static_cast<long long>(b) * rows.num_segments + s) * rows.f +
                   rows.c0 + q + lane] = total;
      } else {
#pragma unroll
        for (int j = 0; j < S; ++j)
          if (q + j < w) park[(q + j) * 32] = acc[j];
      }
    }
  }
};

// A minimum of 4 blocks an SM caps a thread at 128 registers: without it
// ptxas keeps segment_sum_kernel<16> at 80 registers and spills (PERF.md).
template <int S>
__global__ void __launch_bounds__(kRangeThreads, 4) segment_sum_kernel(
    RowStage in, int width, int n, int num_segments, int chunk, int tile,
    float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  in.c0 = blockIdx.y * width;
  in.w = min(width, in.f - in.c0);
  // [stages][carry][runs]
  float* carry = smem + 2 * in.floats(tile);
  const GroupRows rows = {out, in.f, num_segments, in.c0, in.w};
  SumOp<S> op{carry, rows};
  reduce_chunk(in, n, chunk, tile, smem,
               reinterpret_cast<int*>(carry + 2 * 32 * width), rows, op);
}

}  // namespace

namespace {

// Launch a chunk kernel with the plan of its shape (grid: chunks x column
// groups); error codes as the entries return them.
template <class Kernel, class... Args>
int launch_chunks(Kernel kernel, const RangePlan& plan, void* stream,
                  Args... args) {
  const long long x = plan.blocks / plan.groups;
  if (x > 0x7fffffffLL || plan.groups > 65535 || plan.smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  if (plan.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(plan.smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3(static_cast<unsigned>(x), static_cast<unsigned>(plan.groups)),
           kRangeThreads, static_cast<size_t>(plan.smem),
           static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

int column_count(const Cols& cols) {
  int n = 0;
  for (int c = 0; c < kMaxCols; ++c) n += cols.p[c] != nullptr;
  return n;
}

// K1's staged columns of an entry's arguments (as ndtpu_segment_moments).
ColumnStage moment_columns(const void* seg, const void* xt, const void* yt,
                           const void* zt, const void* v, const void* cls,
                           const void* const* tag_ptrs, int n_tags, int slots) {
  ColumnStage in = {};
  in.cols.p[kSeg] = static_cast<const float*>(seg);
  const void* const xyzv[4] = {xt, yt, zt, v};
  for (int c = 0; c < 4; ++c) in.cols.p[kXt + c] = static_cast<const float*>(xyzv[c]);
  for (int t = 0; t < n_tags; ++t)
    in.cols.p[kTag0 + t] = static_cast<const float*>(tag_ptrs[t]);
  if (slots > 0) in.cols.p[kCls] = static_cast<const float*>(cls);
  return in;
}

bool probe_args_ok(int n_tags, int batch, int n, int num_segments, int slots) {
  return n_tags >= 0 && n_tags <= NDTPU_MAX_TAGS && batch >= 0 && n >= 0 &&
         num_segments >= 0 && slots >= 0 && slots <= kProbeMaxSlots;
}

void write_plan(const RangePlan& plan, long long* out) {
  out[0] = plan.chunk;
  out[1] = plan.tile;
  out[2] = plan.blocks;
  out[3] = plan.smem;
}

}  // namespace

extern "C" int ndtpu_segment_moments(
    const void* seg, const void* xt, const void* yt, const void* zt,
    const void* v, const void* cls, const void* const* tag_ptrs, int n_tags,
    int batch, int n, int num_segments, int slots, void* out, void* stream) {
  if (n_tags < 0 || n_tags > NDTPU_MAX_TAGS || batch < 0 || n < 0 ||
      num_segments < 0 || slots < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // nothing to sum, no grid: the wrapper returns zeros without a call
  if (static_cast<long long>(batch) * num_segments == 0 || n == 0)
    return static_cast<int>(cudaSuccess);
  const ColumnStage in = moment_columns(seg, xt, yt, zt, v, cls, tag_ptrs,
                                        n_tags, slots);
  const RangePlan plan = range_plan(batch, n, column_count(in.cols), slots, 0, 1);
  return launch_chunks(segment_moments_kernel, plan, stream, in, n_tags, n,
                       num_segments, slots, plan.chunk, plan.tile,
                       static_cast<float*>(out));
}

// P1: K1's launch (its plan, shared memory and grid) whose body zeroes out
// [batch, num_segments, 13 + slots + n_tags]. The arguments are K1's.
extern "C" int ndtpu_moments_empty(
    const void* seg, const void* xt, const void* yt, const void* zt,
    const void* v, const void* cls, const void* const* tag_ptrs, int n_tags,
    int batch, int n, int num_segments, int slots, void* out, void* stream) {
  if (!probe_args_ok(n_tags, batch, n, num_segments, slots))
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(batch) * num_segments == 0 || n == 0)
    return static_cast<int>(cudaSuccess);
  const long long size =
      static_cast<long long>(batch) * num_segments * (kMoments + slots + n_tags);
  const ColumnStage in = moment_columns(seg, xt, yt, zt, v, cls, tag_ptrs,
                                        n_tags, slots);
  const RangePlan plan = range_plan(batch, n, column_count(in.cols), slots, 0, 1);
  return launch_chunks(moments_empty_kernel, plan, stream, size,
                       static_cast<float*>(out));
}

// P2: the column totals of every point with id >= 0 into rows 0-7 of the
// flat [batch num_segments, 13 + slots + n_tags] out, the rest zeroed.
// partial: the [blocks, F] scratch, blocks = K1's plan's (partial_rows must
// equal it). The other arguments are K1's.
extern "C" int ndtpu_moments_noflop(
    const void* seg, const void* xt, const void* yt, const void* zt,
    const void* v, const void* cls, const void* const* tag_ptrs, int n_tags,
    int batch, int n, int num_segments, int slots, void* partial,
    long long partial_rows, void* out, void* stream) {
  if (!probe_args_ok(n_tags, batch, n, num_segments, slots))
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(batch) * num_segments == 0 || n == 0)
    return static_cast<int>(cudaSuccess);
  const ColumnStage in = moment_columns(seg, xt, yt, zt, v, cls, tag_ptrs,
                                        n_tags, slots);
  const RangePlan plan = range_plan(batch, n, column_count(in.cols), slots, 0, 1);
  if (partial_rows != plan.blocks) return static_cast<int>(cudaErrorInvalidValue);
  float* sums = static_cast<float*>(partial);
  const int err =
      slots == 0 ? launch_chunks(moments_noflop_kernel<0>, plan, stream, in, n_tags,
                                 n, slots, plan.chunk, plan.tile, sums)
      : slots == 1 ? launch_chunks(moments_noflop_kernel<1>, plan, stream, in, n_tags,
                                   n, slots, plan.chunk, plan.tile, sums)
                   : launch_chunks(moments_noflop_kernel<kProbeMaxSlots>, plan, stream,
                                   in, n_tags, n, slots, plan.chunk, plan.tile, sums);
  if (err != 0) return err;
  const int f = kMoments + slots + n_tags;
  const long long rows = static_cast<long long>(batch) * num_segments;
  const long long threads = 256, want = (rows * f + threads - 1) / threads;
  const long long grid = want < kSMs * 4 ? want : kSMs * 4;
  moments_noflop_finish<<<static_cast<unsigned>(grid), static_cast<unsigned>(threads),
                          0, static_cast<cudaStream_t>(stream)>>>(
      sums, static_cast<int>(plan.blocks), f, rows, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ndtpu_segment_tags(const void* seg, const void* const* tag_ptrs,
                                  int n_tags, int n, int num_segments,
                                  void* out, void* stream) {
  if (n_tags < 1 || n_tags > NDTPU_MAX_TAGS || n < 0 || num_segments < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // nothing to sum, no grid: the wrapper returns zeros without a call
  if (num_segments == 0 || n == 0) return static_cast<int>(cudaSuccess);
  ColumnStage in = {};
  in.cols.p[kSeg] = static_cast<const float*>(seg);
  for (int t = 0; t < n_tags; ++t)
    in.cols.p[kTag0 + t] = static_cast<const float*>(tag_ptrs[t]);
  const RangePlan plan = range_plan(1, n, column_count(in.cols), 0, 0, 1);
  return launch_chunks(segment_tags_kernel, plan, stream, in, n_tags, n,
                       num_segments, plan.chunk, plan.tile,
                       static_cast<float*>(out));
}

extern "C" int ndtpu_segment_sum(const void* seg, const void* feats, int batch,
                                 int n, int f, int num_segments, void* out,
                                 void* stream) {
  if (batch < 0 || n < 0 || f < 1 || num_segments < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // nothing to sum, no grid: the wrapper returns zeros without a call
  if (static_cast<long long>(batch) * num_segments == 0 || n == 0)
    return static_cast<int>(cudaSuccess);
  const SumPlan p = sum_plan(batch, n, f);
  const RowStage in = {static_cast<const int*>(seg),
                       static_cast<const float*>(feats), f, p.pitch, 0, 0};
  if (p.width <= 16)
    return launch_chunks(segment_sum_kernel<16>, p.range, stream, in, p.width,
                         n, num_segments, p.range.chunk, p.range.tile,
                         static_cast<float*>(out));
  return launch_chunks(segment_sum_kernel<32>, p.range, stream, in, p.width, n,
                       num_segments, p.range.chunk, p.range.tile,
                       static_cast<float*>(out));
}

// The plans of the launches, for the tests. ndtpu_range_plan (K1, K3):
// out = {points per block, points per tile, blocks, dynamic shared memory
// bytes}; ndtpu_sum_plan (K2): the same, then {width, pitch, column
// groups}.
extern "C" int ndtpu_range_plan(int batch, int n, int n_cols, int slots,
                                long long* out) {
  write_plan(range_plan(batch, n, n_cols, slots, 0, 1), out);
  return 0;
}

extern "C" int ndtpu_sum_plan(int batch, int n, int f, long long* out) {
  const SumPlan p = sum_plan(batch, n, f);
  write_plan(p.range, out);
  out[4] = p.width;
  out[5] = p.pitch;
  out[6] = p.range.groups;
  return 0;
}

// The eval-mode pointwise epilogue of a Dense -> BatchNorm (-> ReLU) site of
// the models, in one pass over the GEMM's output, for sm_90a:
//
//   ndtpu_dense_bn_act  (wrapper ndtpu_torch/ops/epilogue.py::dense_bn_act,
//                        caller ndtpu_torch/models/dense.py::dense_norm)
//
// It replaces no Pallas kernel: on the TPU, XLA fuses the Dense's bias add,
// the inference BatchNorm of ndtpu/models/norm.py and the ReLU into one
// loop. PyTorch runs them eagerly as five or six ops, each broadcasting a
// [C] vector over the [R, C] activation, so each reads and writes all of
// it: at a serving request's 512,000 rows that chain moved about 100 GB a
// request. This pass reads the product once and writes the result once.
//
// Arithmetic: the chain as it ran, element by element, each step rounded
// to f32 in the chain's order, with the round-to-nearest intrinsics, so
// that nvcc cannot contract a multiply and an add into one FMA:
//
//   t = y + bias;  t = t - mean;  t = t / denom;  t = t * weight;
//   t = t + shift;  relu: NaN stays NaN, else fmaxf(t, 0)
//
// where denom = sqrt(running_var + eps) is the [C] torch op the chain runs
// and is passed in, and the ReLU is torch.relu's CUDA functor (clamp_min:
// a NaN returned as it is, else max). Nothing is folded into one scale and
// shift: that rounds differently. So the result is the chain's, bit for bit.
//
// Bound: bytes. Six f32 operations per element against 8 bytes moved (one
// read, one write), under one operation a byte where the H100 does ~20 f32
// operations a byte of its 3.35 TB/s: [512000, 1024] is 4.19 GB, 1.25 ms.
//
// Design: every row is C / 4 float4s, streamed with 16-byte loads and
// stores; the wrapper raises on a C that 4 does not divide. A grid-stride
// loop over the float4 index i walks i, i + S, i + 2S, ... with S the
// threads of the grid, and the plan (epilogue.py::epilogue_plan) makes S a
// multiple of C / 4: each thread then meets one column group for its whole
// life, so it loads its five [C] float4s into registers once, before the
// loop, and the loop moves nothing but the activation (no shared memory,
// no barrier, any C). The grid is one wave of resident blocks (kBlocksPerSM
// an SM of the card's SMs) where the rows fill it. Each thread keeps
// kUnroll independent 16-byte loads in flight before it computes: 1024
// threads an SM x 64 bytes = 64 KB an SM, above what the memory's latency
// times its rate asks of each SM (~15 KB), so the loop runs at the
// memory's pace. Measured on an H100 in turns (PERF.md): read-only loads
// (__ldg) ran 1.5-2 % faster than evict-first ones (__ldcs) at every
// serving width; 8 loads in flight a thread at 3 blocks an SM, 2 loads at
// 4 blocks, 4 loads at 2 blocks and evict-first stores were no faster.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;     // threads a block (THREADS in epilogue.py)
constexpr int kBlocksPerSM = 4;   // resident blocks an SM, at <= 64 registers
constexpr int kUnroll = 4;        // float4 loads in flight a thread

__device__ __forceinline__ float chain(float t, float b, float m, float d,
                                       float w, float s) {
  t = __fadd_rn(t, b);
  t = __fsub_rn(t, m);
  t = __fdiv_rn(t, d);
  t = __fmul_rn(t, w);
  return __fadd_rn(t, s);
}

template <bool kRelu>
__device__ __forceinline__ float act(float t) {
  if (!kRelu) return t;
  return isnan(t) ? t : fmaxf(t, 0.0f);
}

template <bool kRelu>
__device__ __forceinline__ float4 apply(float4 v, float4 b, float4 m, float4 d,
                                        float4 w, float4 s) {
  return make_float4(act<kRelu>(chain(v.x, b.x, m.x, d.x, w.x, s.x)),
                     act<kRelu>(chain(v.y, b.y, m.y, d.y, w.y, s.y)),
                     act<kRelu>(chain(v.z, b.z, m.z, d.z, w.z, s.z)),
                     act<kRelu>(chain(v.w, b.w, m.w, d.w, w.w, s.w)));
}

// y, out: [n4] float4 (the [rows, 4 c4] activation); the vectors: [c4]
// float4. gridDim.x * kThreads is a multiple of c4.
template <bool kRelu>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
dense_bn_act_kernel(const float4* __restrict__ y,
                    const float4* __restrict__ bias,
                    const float4* __restrict__ mean,
                    const float4* __restrict__ denom,
                    const float4* __restrict__ weight,
                    const float4* __restrict__ shift,
                    float4* __restrict__ out, long long n4, int c4) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int col = static_cast<int>(first % c4);
  const float4 b = __ldg(bias + col), m = __ldg(mean + col),
               d = __ldg(denom + col), w = __ldg(weight + col),
               s = __ldg(shift + col);
  for (long long i = first; i < n4; i += kUnroll * stride) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = i + u * stride;
      v[u] = j < n4 ? __ldg(y + j) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = i + u * stride;
      if (j < n4) out[j] = apply<kRelu>(v[u], b, m, d, w, s);
    }
  }
}

}  // namespace

// out[r, c] = the chain of y[r, c] with bias[c], mean[c], denom[c],
// weight[c], shift[c], then the ReLU where relu != 0. Every pointer 16-byte
// aligned, y and out [rows, channels] f32 and not overlapping, the vectors
// [channels] f32; channels a multiple of 4; blocks * kThreads a multiple of
// channels / 4. Returns the launch's CUDA error (0: launched).
extern "C" int ndtpu_dense_bn_act(const void* y, const void* bias,
                                  const void* mean, const void* denom,
                                  const void* weight, const void* shift,
                                  void* out, long long rows, int channels,
                                  int relu, int blocks, void* stream) {
  if (rows < 0 || channels <= 0 || channels % 4 != 0 || blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int c4 = channels / 4;
  if (static_cast<long long>(blocks) * kThreads % c4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n4 = rows * c4;
  if (n4 == 0) return static_cast<int>(cudaSuccess);
  auto launch = relu ? dense_bn_act_kernel<true> : dense_bn_act_kernel<false>;
  launch<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(y), static_cast<const float4*>(bias),
      static_cast<const float4*>(mean), static_cast<const float4*>(denom),
      static_cast<const float4*>(weight), static_cast<const float4*>(shift),
      static_cast<float4*>(out), n4, c4);
  return static_cast<int>(cudaGetLastError());
}

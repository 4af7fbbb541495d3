// The train-mode epilogue of a U-Net ConvBnRelu site, for Hopper (sm_90a):
// conv bias, channel dropout, batch-statistics BatchNorm and ReLU, forward
// and backward, in four passes over the f32 conv output.
//
// Replaces no TPU kernel. On the TPU, XLA fused this chain and its gradient
// into a few loops (rcu_tpu/models/unet.py ConvBnRelu with flax's
// nn.BatchNorm(use_running_average=False)); the port ran it as eager torch
// ops: cuDNN's bias add, dropout's divide, the two sums of the batch
// statistics, three full passes to normalize, the ReLU, and the backward of
// each (about 16 passes forward and 26 backward, 4 bytes an element each).
//
// What it computes, for the bias-free conv output c (N, C, H, W),
// NCHW-contiguous, and each element of the (n, ch) plane:
//   z   = (c + bias[ch]) / divisor[n, ch]   (divisor: the keep probability,
//                                            inf for a dropped channel;
//                                            no division without dropout)
//   t   = z - mean[ch]
//   pre = t * mul[ch] + shift[ch]           (mul = rsqrt(var + eps) * gamma)
//   y   = max(pre, 0), NaN kept             (or pre, without the ReLU)
// The four stages, one launch each:
//   stats       reads c:        the per-channel sums of z and z * z
//   apply       reads c:        writes y
//   grad_sums   reads g, c:     with g' = g where pre > 0 (or NaN), else 0,
//                               the per-channel sums of g' (the shift's
//                               gradient) and g' * t, and gamma's gradient
//                               (sum of g' * t) * rstd
//   grad_apply  reads g, c:     writes dc = gamma * rstd / divisor *
//                               (g' - sum g' / M - t * B), with M = N * H * W
//                               and B = rstd^2 * (sum g' * t) / M, or 0
//                               where the variance was clamped at 0 (inner <
//                               0: clamp_min passes no gradient there); and
//                               the per-channel sums of dc (the conv bias's
//                               gradient), where asked for
// The host computes the per-channel constants between stats and apply with
// the (C)-sized torch ops of the eager chain (flax's mean, fast variance
// and its clamp, the running statistics), so they are bitwise the eager
// chain's for the same sums. z, t, pre and y round every step on its own
// (__fadd_rn, __fdiv_rn, __fsub_rn, __fmul_rn: nvcc contracts nothing into
// an FMA): given the same constants, apply is bitwise the eager ops, and
// the backward recomputes the forward's ReLU mask exactly from c.
//
// Bound on an H100 SXM: memory. 4 + 8 + 8 + 12 = 32 bytes an element
// forward and backward; BraTS's train batch (32 slices, 19 sites, 15.9 M
// elements a slice) moves 16.3 GB a step, 4.9 ms at 3.35 TB/s. The design:
//   - A plane (n, ch) is walked by one group of threads: a block of 256
//     where the plane holds 2048 elements or more, a warp where it holds
//     fewer (BraTS 30 x 30 and 15 x 15), 8 planes a block. The group loads
//     its plane's constants once.
//   - 16-byte loads and stores where H * W % 4 == 0 and every tensor is
//     16-byte aligned, 4 in flight a thread; else one element at a time
//     (15 x 15 = 225).
//   - Sums without float atomics, so that two runs give the same bits:
//     each group sums its plane in a fixed order (a thread's elements in
//     order, then a fixed shuffle tree) and writes the plane's partial;
//     the last group of a channel to finish (an integer ticket taken after
//     a __threadfence; the entry zeroes the tickets before the launch)
//     adds the channel's N partials in a fixed order and writes the
//     channel's result.
#include <cuda_runtime.h>
#include <stdint.h>

// The launch's arguments, as ops/cuda/trainepilogue.py lays them out (outside
// the unnamed namespace: the exported entry takes it).
struct TrainEpilogueArgs {
  const float* c;        // (N, C, H, W) bias-free conv output
  const float* g;        // (N, C, H, W) gradient of y (grad stages)
  float* out;            // y (apply) or dc (grad_apply)
  const float* bias;     // (C)
  const float* divisor;  // (N, C), or null without dropout
  const float* mean;     // (C), with mul and shift: apply and grad stages
  const float* mul;
  const float* shift;
  const float* gamma;    // (C), grad_apply
  const float* rstd;     // (C), grad stages
  const float* inner;    // (C) E[z^2] - E[z]^2 before the clamp, grad_apply
  const float* sg;       // (C) sum g', grad_apply
  const float* sgz;      // (C) sum g' * t, grad_apply
  float* chan[3];        // the per-channel results of the stage
  float* partials;       // (N * C * sums) plane partials
  unsigned* tickets;     // (C), zeroed by the entry before the launch
  long long rows;        // N
  long long channels;    // C
  long long plane;       // H * W
  float inv_count;       // 1 / M
  int relu;
};

namespace {

using Args = TrainEpilogueArgs;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // 16-byte loads in flight a thread and tensor
constexpr long long kBlockPlane = 2048;  // a block a plane from this size
constexpr long long kMaxIndex = 0x7fffffffLL;

enum Stage { kStats = 0, kApply = 1, kGradSums = 2, kGradApply = 3 };


__host__ __device__ constexpr int sums_of(Stage s) {
  return s == kStats || s == kGradSums ? 2 : s == kGradApply ? 1 : 0;
}

// A plane's constants, loaded once by its group.
struct PlaneConstants {
  float bias, divisor, mean, mul, shift;
  float scale, a, b;  // grad_apply: gamma * rstd / divisor, sum g' / M, B
  bool divide;
};

template <Stage S>
__device__ __forceinline__ PlaneConstants plane_constants(const Args& a,
                                                          unsigned p,
                                                          unsigned ch) {
  PlaneConstants k;
  k.bias = __ldg(a.bias + ch);
  k.divide = a.divisor != nullptr;
  k.divisor = k.divide ? __ldg(a.divisor + p) : 1.f;
  k.mean = k.mul = k.shift = k.scale = k.a = k.b = 0.f;
  if (S != kStats) {
    k.mean = __ldg(a.mean + ch);
    k.mul = __ldg(a.mul + ch);
    k.shift = __ldg(a.shift + ch);
  }
  if (S == kGradApply) {
    const float r = __ldg(a.rstd + ch);
    k.scale = __ldg(a.gamma + ch) * r / k.divisor;  // 0 for a dropped plane
    k.a = __ldg(a.sg + ch) * a.inv_count;
    k.b = __ldg(a.inner + ch) >= 0.f ? r * r * __ldg(a.sgz + ch) * a.inv_count
                                     : 0.f;
  }
  return k;
}

// One element: the stage's output (apply, grad_apply) and its terms of the
// plane's sums.
template <Stage S, bool kRelu>
__device__ __forceinline__ float element(const PlaneConstants& k, float c,
                                         float g, float (&acc)[2]) {
  float z = __fadd_rn(c, k.bias);
  if (k.divide) z = __fdiv_rn(z, k.divisor);
  if (S == kStats) {
    acc[0] += z;
    acc[1] = fmaf(z, z, acc[1]);
    return 0.f;
  }
  const float t = __fsub_rn(z, k.mean);
  const float pre = __fadd_rn(__fmul_rn(t, k.mul), k.shift);
  if (S == kApply) {
    return kRelu && !isnan(pre) ? fmaxf(pre, 0.f) : pre;  // torch's relu
  }
  // relu's backward (threshold_backward): no gradient where pre <= 0
  const float gm = kRelu && pre <= 0.f ? 0.f : g;
  if (S == kGradSums) {
    acc[0] += gm;
    acc[1] = fmaf(gm, t, acc[1]);
    return 0.f;
  }
  const float dc = k.scale * (gm - k.a - t * k.b);
  acc[0] += dc;
  return dc;
}

// The group's walk over its plane, `lane` of kLanes, at element `base`.
template <Stage S, int kLanes, bool kVec, bool kRelu>
__device__ __forceinline__ void walk(const Args& a, const PlaneConstants& k,
                                     size_t base, unsigned lane,
                                     float (&acc)[2]) {
  constexpr bool kReadG = S == kGradSums || S == kGradApply;
  constexpr bool kWrite = S == kApply || S == kGradApply;
  const unsigned n = (unsigned)a.plane;
  if (kVec) {
    const float4* c4 = reinterpret_cast<const float4*>(a.c + base);
    const float4* g4 = reinterpret_cast<const float4*>(a.g + base);
    float4* o4 = reinterpret_cast<float4*>(a.out + base);
    const unsigned n4 = n / 4;
    for (unsigned i0 = lane; i0 < n4; i0 += kLanes * kUnroll) {
      float4 cv[kUnroll], gv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const unsigned i = i0 + u * kLanes;
        if (i < n4) {
          cv[u] = __ldg(c4 + i);
          if (kReadG) gv[u] = __ldg(g4 + i);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const unsigned i = i0 + u * kLanes;
        if (i >= n4) continue;
        float4 o;
        o.x = element<S, kRelu>(k, cv[u].x, kReadG ? gv[u].x : 0.f, acc);
        o.y = element<S, kRelu>(k, cv[u].y, kReadG ? gv[u].y : 0.f, acc);
        o.z = element<S, kRelu>(k, cv[u].z, kReadG ? gv[u].z : 0.f, acc);
        o.w = element<S, kRelu>(k, cv[u].w, kReadG ? gv[u].w : 0.f, acc);
        if (kWrite) o4[i] = o;
      }
    }
  } else {
    const float* c1 = a.c + base;
    const float* g1 = a.g + base;
    float* o1 = a.out + base;
    for (unsigned i0 = lane; i0 < n; i0 += kLanes * kUnroll) {
      float cv[kUnroll], gv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const unsigned i = i0 + u * kLanes;
        if (i < n) {
          cv[u] = __ldg(c1 + i);
          if (kReadG) gv[u] = __ldg(g1 + i);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const unsigned i = i0 + u * kLanes;
        if (i >= n) continue;
        const float o = element<S, kRelu>(k, cv[u], kReadG ? gv[u] : 0.f,
                                          acc);
        if (kWrite) o1[i] = o;
      }
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  }
  return v;
}

// The group's sums of `acc` in a fixed order; every lane of the group gets
// them. A block-sized group synchronizes the block.
template <int kSums, int kLanes>
__device__ __forceinline__ void group_sum(float (&acc)[2],
                                          float (*scratch)[kWarps]) {
#pragma unroll
  for (int s = 0; s < kSums; ++s) acc[s] = warp_sum(acc[s]);
  if (kLanes == 32) return;
  const unsigned warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // the scratch's last readers are done
  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < kSums; ++s) scratch[s][warp] = acc[s];
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kSums; ++s) {
    acc[s] = warp_sum(lane < kWarps ? scratch[s][lane] : 0.f);
  }
}

// Whether this group is the last of its channel's N to finish; every lane
// of the group gets the answer.
template <int kLanes>
__device__ __forceinline__ bool last_of_channel(const Args& a, unsigned ch,
                                                bool leader, int* flag) {
  bool last = false;
  if (leader) {
    __threadfence();  // the plane's partial, before the ticket
    last = atomicAdd(a.tickets + ch, 1u) == (unsigned)a.rows - 1u;
  }
  if (kLanes == 32) return __shfl_sync(0xffffffffu, (int)last, 0) != 0;
  if (leader) *flag = last;
  __syncthreads();
  return *flag;
}

template <Stage S>
__device__ __forceinline__ void write_channel(const Args& a, unsigned ch,
                                              const float (&total)[2]) {
  if (S == kStats || S == kGradApply) {
    a.chan[0][ch] = total[0];
    if (S == kStats) a.chan[1][ch] = total[1];
  } else {  // the shift's gradient, sum g' * t, gamma's gradient
    a.chan[0][ch] = total[0];
    a.chan[1][ch] = total[1];
    a.chan[2][ch] = __fmul_rn(total[1], __ldg(a.rstd + ch));
  }
}

template <Stage S, int kLanes, bool kVec, bool kRelu>
__device__ __forceinline__ void run(const Args& a) {
  constexpr int kSums = sums_of(S);
  __shared__ float scratch[2][kWarps];
  __shared__ int flag;
  const unsigned p = blockIdx.x * (kThreads / kLanes) + threadIdx.x / kLanes;
  const unsigned lane = threadIdx.x % kLanes;
  const unsigned planes = (unsigned)(a.rows * a.channels);
  if (kLanes == 32 && p >= planes) return;  // a whole warp without a plane
  const unsigned ch = p % (unsigned)a.channels;
  const PlaneConstants k = plane_constants<S>(a, p, ch);
  float acc[2] = {0.f, 0.f};
  walk<S, kLanes, kVec, kRelu>(a, k, (size_t)p * (size_t)a.plane, lane, acc);
  if (kSums == 0 || a.chan[0] == nullptr) return;
  group_sum<kSums, kLanes>(acc, scratch);
  const bool leader = lane == 0;
  if (leader) {
#pragma unroll
    for (int s = 0; s < kSums; ++s) a.partials[(size_t)p * kSums + s] = acc[s];
  }
  if (!last_of_channel<kLanes>(a, ch, leader, &flag)) return;
  __threadfence();  // the other groups' partials, after their tickets
  float total[2] = {0.f, 0.f};
  const unsigned channels = (unsigned)a.channels;
  for (unsigned n = lane; n < (unsigned)a.rows; n += kLanes) {
    const size_t q = ((size_t)n * channels + ch) * kSums;
#pragma unroll
    for (int s = 0; s < kSums; ++s) total[s] += __ldcg(a.partials + q + s);
  }
  group_sum<kSums, kLanes>(total, scratch);
  if (leader) write_channel<S>(a, ch, total);
}

template <int kLanes, bool kVec, bool kRelu>
__global__ void __launch_bounds__(kThreads)
    rcu_train_epilogue_stats(const Args a) {
  run<kStats, kLanes, kVec, kRelu>(a);
}

template <int kLanes, bool kVec, bool kRelu>
__global__ void __launch_bounds__(kThreads)
    rcu_train_epilogue_apply(const Args a) {
  run<kApply, kLanes, kVec, kRelu>(a);
}

template <int kLanes, bool kVec, bool kRelu>
__global__ void __launch_bounds__(kThreads)
    rcu_train_epilogue_grad_sums(const Args a) {
  run<kGradSums, kLanes, kVec, kRelu>(a);
}

template <int kLanes, bool kVec, bool kRelu>
__global__ void __launch_bounds__(kThreads)
    rcu_train_epilogue_grad_apply(const Args a) {
  run<kGradApply, kLanes, kVec, kRelu>(a);
}

using Kernel = void (*)(Args);

#define RCU_PICK(kernel)                                                    \
  (warp ? (vec ? (relu ? &kernel<32, true, true> : &kernel<32, true, false>) \
              : (relu ? &kernel<32, false, true>                           \
                      : &kernel<32, false, false>))                        \
        : (vec ? (relu ? &kernel<kThreads, true, true>                      \
                       : &kernel<kThreads, true, false>)                    \
               : (relu ? &kernel<kThreads, false, true>                     \
                       : &kernel<kThreads, false, false>)))

Kernel pick(int stage, bool warp, bool vec, bool relu) {
  switch (stage) {
    case kStats: return RCU_PICK(rcu_train_epilogue_stats);
    case kApply: return RCU_PICK(rcu_train_epilogue_apply);
    case kGradSums: return RCU_PICK(rcu_train_epilogue_grad_sums);
    case kGradApply: return RCU_PICK(rcu_train_epilogue_grad_apply);
    default: return nullptr;
  }
}

#undef RCU_PICK

bool aligned(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// One stage (0 stats, 1 apply, 2 grad_sums, 3 grad_apply) of the epilogue
// of `args->rows` x `args->channels` planes of `args->plane` elements, on
// `stream`; returns the cudaError_t of the launch (0 = queued). What each
// stage reads and writes is in the note at the top; the caller hands the
// stage every tensor it names.
extern "C" int rcu_train_epilogue(int stage, const TrainEpilogueArgs* args,
                                  void* stream) {
  if (args == nullptr) return (int)cudaErrorInvalidValue;
  const Args& a = *args;
  const bool grad = stage == kGradSums || stage == kGradApply;
  const bool sums = stage != kApply;
  const bool write = stage == kApply || stage == kGradApply;
  if (stage < kStats || stage > kGradApply || a.rows < 1 || a.channels < 1 ||
      a.plane < 1 || a.plane > kMaxIndex || a.rows * a.channels > kMaxIndex ||
      a.c == nullptr || a.bias == nullptr || (grad && a.g == nullptr) ||
      (write && a.out == nullptr) ||
      (stage != kStats && (a.mean == nullptr || a.mul == nullptr ||
                           a.shift == nullptr)) ||
      (grad && a.rstd == nullptr) ||
      (stage == kGradApply && (a.gamma == nullptr || a.inner == nullptr ||
                               a.sg == nullptr || a.sgz == nullptr)) ||
      (stage != kGradApply && sums && a.chan[0] == nullptr) ||
      (stage == kStats && a.chan[1] == nullptr) ||
      (stage == kGradSums && (a.chan[1] == nullptr || a.chan[2] == nullptr)) ||
      (a.chan[0] != nullptr && (a.partials == nullptr ||
                                a.tickets == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const bool vec = a.plane % 4 == 0 && aligned(a.c) && aligned(a.g) &&
                   aligned(a.out);
  const bool warp = a.plane < kBlockPlane;
  const Kernel kernel = pick(stage, warp, vec, a.relu != 0);
  const long long planes = a.rows * a.channels;
  const long long groups = warp ? kThreads / 32 : 1;
  const unsigned grid = (unsigned)((planes + groups - 1) / groups);
  if (a.chan[0] != nullptr) {
    const cudaError_t err =
        cudaMemsetAsync(a.tickets, 0, sizeof(unsigned) * a.channels,
                        (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

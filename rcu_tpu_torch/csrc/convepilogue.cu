// The epilogue of a U-Net ConvBnRelu site in eval mode, for Hopper (sm_90a):
// conv bias, channel dropout, BatchNorm and ReLU in one pass over the f32
// conv output, in place.
//
// Replaces no TPU kernel. On the TPU, XLA fused this elementwise chain into
// the convolution's output (rcu_tpu/models/unet.py ConvBnRelu); the port ran
// it as four passes: cuDNN's own bias add after the conv, dropout's in-place
// divide, cuDNN's inference BatchNorm (out of place) and the in-place ReLU.
// Each read and wrote the whole activation.
//
// What it computes, for y (N, C, H, W) NCHW-contiguous and each element of
// the (n, c) plane:
//   t = y + bias[c]
//   t = t / divisor[n, c]            (optional: the keep probability, or inf
//                                     for a dropped channel)
//   t = (t - mean[c]) * scale[c] + shift[c]   (optional; the host computes
//                                     scale = weight * rsqrt(var + eps))
//   t = max(t, 0), NaN kept          (optional)
// Every step is an f32 operation rounded on its own (__fadd_rn, __fdiv_rn,
// __fsub_rn, __fmul_rn), so that nvcc contracts nothing into an FMA: the
// result is bitwise that of the same torch ops run one pass each
// (ops/cuda/convepilogue.py:conv_epilogue_reference) on the card.
//
// Bound on an H100 SXM: memory. An element is read once and written once,
// 8 bytes; BraTS level 0 of an MC batch (640 x 32 x 240 x 240) is 9.44 GB,
// 2.82 ms at 3.35 TB/s. The four passes it replaces moved 32 bytes an
// element. The design is for bytes and nothing else:
//   - 16-byte loads and stores over the flat tensor (kUnroll of them in
//     flight a thread), grid-stride, one wave of blocks: the occupancy
//     times the SM count.
//   - The per-channel constants are a few KB a launch, read through the
//     read-only cache (__ldg).
//   - The (n, c) plane of an element: where H * W % 4 == 0 a float4 lies in
//     one plane and takes one division; otherwise (BraTS's 15 x 15 bottom
//     level) each element takes its own. A division is a multiply-high by a
//     magic number fixed per launch (Divider), not an integer divide.
//   - 32-bit indices: the C entry cuts a tensor of 2^31 elements or more
//     into launches of whole rows.
//   - The ragged tail (numel % 4) goes to the first threads, one element
//     each.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kMaxDevices = 64;
constexpr long long kMaxElements = 0x7fffffffLL;  // a launch's n < 2^31

// n / d for n < 2^31 by a multiply-high (the method of PyTorch's
// IntDivider): s = ceil(log2 d), m = 2^32 (2^s - d) / d + 1.
struct Divider {
  unsigned d, m, s;
};

Divider make_divider(unsigned d) {
  unsigned s = 0;
  while (s < 32 && (1ull << s) < d) ++s;
  const unsigned long long m = ((1ull << 32) * ((1ull << s) - d)) / d + 1;
  return Divider{d, (unsigned)m, s};
}

__device__ __forceinline__ unsigned divide(const Divider& v, unsigned n) {
  return (__umulhi(n, v.m) + n) >> v.s;
}

struct Params {
  float* y;
  const float* bias;
  const float* divisor;  // (rows, C), or null
  const float* mean;     // (C), with scale and shift; or null
  const float* scale;
  const float* shift;
  unsigned n;            // elements of this launch
  Divider plane;         // H * W
  Divider plane4;        // H * W / 4 (where H * W % 4 == 0)
  Divider channels;      // C
};

template <bool kDiv, bool kBn, bool kRelu>
__device__ __forceinline__ float apply(const Params& p, unsigned plane,
                                       float v) {
  const unsigned c = plane - divide(p.channels, plane) * p.channels.d;
  float t = __fadd_rn(v, __ldg(p.bias + c));
  if (kDiv) t = __fdiv_rn(t, __ldg(p.divisor + plane));  // row * C + c
  if (kBn) {
    t = __fadd_rn(__fmul_rn(__fsub_rn(t, __ldg(p.mean + c)),
                            __ldg(p.scale + c)),
                  __ldg(p.shift + c));
  }
  if (kRelu) t = isnan(t) ? t : fmaxf(t, 0.f);  // torch's relu (clamp_min)
  return t;
}

template <bool kDiv, bool kBn, bool kRelu, bool kPlaneVec>
__global__ void __launch_bounds__(kThreads)
    rcu_conv_epilogue_kernel(const Params p) {
  const unsigned n4 = p.n / 4;
  const unsigned stride = gridDim.x * kThreads;
  float4* y4 = reinterpret_cast<float4*>(p.y);
  for (unsigned base = blockIdx.x * kThreads + threadIdx.x; base < n4;
       base += stride * kUnroll) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned i = base + u * stride;
      if (i < n4) v[u] = y4[i];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned i = base + u * stride;
      if (i >= n4) continue;
      if (kPlaneVec) {
        const unsigned plane = divide(p.plane4, i);
        v[u].x = apply<kDiv, kBn, kRelu>(p, plane, v[u].x);
        v[u].y = apply<kDiv, kBn, kRelu>(p, plane, v[u].y);
        v[u].z = apply<kDiv, kBn, kRelu>(p, plane, v[u].z);
        v[u].w = apply<kDiv, kBn, kRelu>(p, plane, v[u].w);
      } else {
        const unsigned e = 4 * i;
        v[u].x = apply<kDiv, kBn, kRelu>(p, divide(p.plane, e), v[u].x);
        v[u].y = apply<kDiv, kBn, kRelu>(p, divide(p.plane, e + 1), v[u].y);
        v[u].z = apply<kDiv, kBn, kRelu>(p, divide(p.plane, e + 2), v[u].z);
        v[u].w = apply<kDiv, kBn, kRelu>(p, divide(p.plane, e + 3), v[u].w);
      }
      y4[i] = v[u];
    }
  }
  const unsigned tail = 4 * n4 + blockIdx.x * kThreads + threadIdx.x;
  if (tail < p.n) {
    p.y[tail] = apply<kDiv, kBn, kRelu>(p, divide(p.plane, tail), p.y[tail]);
  }
}

using Kernel = void (*)(Params);

template <bool kDiv, bool kBn, bool kRelu>
Kernel pick(bool plane_vec) {
  return plane_vec ? rcu_conv_epilogue_kernel<kDiv, kBn, kRelu, true>
                   : rcu_conv_epilogue_kernel<kDiv, kBn, kRelu, false>;
}

Kernel pick(bool div, bool bn, bool relu, bool plane_vec) {
  if (div) {
    if (bn) return relu ? pick<true, true, true>(plane_vec)
                        : pick<true, true, false>(plane_vec);
    return relu ? pick<true, false, true>(plane_vec)
                : pick<true, false, false>(plane_vec);
  }
  if (bn) return relu ? pick<false, true, true>(plane_vec)
                      : pick<false, true, false>(plane_vec);
  return relu ? pick<false, false, true>(plane_vec)
              : pick<false, false, false>(plane_vec);
}

// Blocks of one wave of `kernel` on the current device, cached a device and
// instance (the 16 instances have one index each).
cudaError_t wave(Kernel kernel, int instance, int* blocks) {
  static int cache[kMaxDevices][16];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache[device][instance] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
    if (err != cudaSuccess) return err;
    if (sms < 1 || per_sm < 1) return cudaErrorInvalidConfiguration;
    cache[device][instance] = sms * per_sm;
  }
  *blocks = cache[device][instance];
  return cudaSuccess;
}

}  // namespace

// The epilogue of `rows` x `channels` planes of `plane` elements each, in
// place on y (16-byte aligned), on `stream`; returns the cudaError_t of the
// launches (0 = queued). `divisor` (rows, channels) or null; `mean`,
// `scale`, `shift` (channels) all given or all null; `relu` 0 or 1.
extern "C" int rcu_conv_epilogue(float* y, const float* bias,
                                 const float* divisor, const float* mean,
                                 const float* scale, const float* shift,
                                 long long rows, long long channels,
                                 long long plane, int relu, void* stream) {
  const bool bn = mean != nullptr;
  if (rows < 0 || channels < 1 || plane < 1 || y == nullptr ||
      bias == nullptr || (bn && (scale == nullptr || shift == nullptr)) ||
      (!bn && (scale != nullptr || shift != nullptr)) ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0 ||
      channels * plane > kMaxElements) {
    return (int)cudaErrorInvalidValue;
  }
  const bool plane_vec = plane % 4 == 0;
  const bool div = divisor != nullptr;
  const Kernel kernel = pick(div, bn, relu != 0, plane_vec);
  const int instance = (div << 3) | (bn << 2) | ((relu != 0) << 1) | plane_vec;
  int blocks = 0;
  cudaError_t err = wave(kernel, instance, &blocks);
  if (err != cudaSuccess) return (int)err;
  const long long row = channels * plane;
  // whole rows, a multiple of 4 where it can be: the next part's start then
  // keeps the 16-byte alignment whatever the row's size
  const long long fit = kMaxElements / row;  // >= 1
  const long long rows_a_launch = fit >= 4 ? fit & ~3LL : fit;
  Params p;
  p.bias = bias;
  p.mean = mean;
  p.scale = scale;
  p.shift = shift;
  p.plane = make_divider((unsigned)plane);
  p.plane4 = make_divider(plane_vec ? (unsigned)(plane / 4) : 1u);
  p.channels = make_divider((unsigned)channels);
  for (long long r = 0; r < rows; r += rows_a_launch) {
    const long long part = rows - r < rows_a_launch ? rows - r : rows_a_launch;
    p.y = y + r * row;
    p.divisor = div ? divisor + r * channels : nullptr;
    p.n = (unsigned)(part * row);
    if (reinterpret_cast<uintptr_t>(p.y) % 16 != 0) {
      return (int)cudaErrorInvalidValue;
    }
    const long long n4 = p.n / 4;
    const long long want = (n4 + (long long)kThreads * kUnroll - 1) /
                           ((long long)kThreads * kUnroll);
    const int grid = (int)(want < blocks ? (want > 0 ? want : 1) : blocks);
    kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

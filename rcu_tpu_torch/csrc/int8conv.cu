// Int8 x int8 convolution for Hopper (sm_90a): an implicit GEMM on wgmma
// fed by TMA, with the quantized site's dequantize and bias in the
// epilogue.
//
// Replaces rcu_tpu/ops/quant.py:int8_conv, which the JAX package leaves to
// XLA (lax.conv_general_dilated with preferred_element_type=int32; on the
// TPU the MXU's int8 mode), together with the elementwise epilogue of the
// quantized sites of rcu_tpu/models/unet.py (_QuantConv, the int8 branch
// of _SplitInputConv, _compensated_bias_add). No PyTorch call computes it
// on the card: cuDNN's int8 convolutions are not exposed, and
// torch._int_mm over an im2col buffer writes 9x (3x3) the activation
// first.
//
// The function: x NHWC int8 (N, H, W, Cin), w int8 (Cout, KH, KW, Cin),
// stride 1, symmetric zero padding `pad`, an lhs (input) dilation `dil` of
// 1 or 2 (dil 2 spreads the input with a zero between neighbours, as
// lax.conv_general_dilated's lhs_dilation does), out NHWC (N, Hout, Wout,
// Cout) with Hout = (H - 1) * dil + 1 + 2 * pad - KH + 1, either
//   - int32: the exact sums (the widest reduction of the U-Net, the 4x4
//     up-conv from 512 channels, stays below 16 * 512 * 127^2 ~ 1.3e8), or
//   - the site's output in the compute dtype, rounded as the eager chain
//     of rcu_tpu_torch/models/unet.py rounds it, one op at a time:
//       bf16: t = bf16(f32(acc)); t = bf16(t * s); [t = bf16(prior + t)];
//             [t = bf16(t + bias)]; [t = bf16(t + lo)]
//       f32:  t = f32(acc) * s; [t = prior + t]; [t = t + bias]
//     with `s` the per-channel scale in the compute dtype; `prior` is the
//     first term of a split pair (the same function's earlier output,
//     read back and overwritten in place). __fmul_rn and __fadd_rn keep
//     nvcc from contracting a multiply and an add into one rounding.
//
// Bound at the U-Net's shapes: the bytes of the int8 input and the
// compute-dtype output at 120^2 and 60^2, the operations below. Design:
//   - Output tiles of 128 pixels, an 8 x 16 patch of one image (of one
//     phase, below), by BN = 64 or 128 output channels (Cout <= 64 takes
//     64), so A is read once for every site but the 512-channel ones.
//   - The reduction walks tap by tap in steps of BK channels: 128, or 64
//     where Cin <= 64 and 32 where Cin <= 32, whose wider boxes would be
//     half outside the tensor. A tap's A tile is one TMA load of a 4-D box
//     (BK channels, 16 columns, 8 rows, 1 image) over x shifted by the tap:
//     TMA fills coordinates outside the image with zeros, so the padding
//     and the channels past Cin cost no code. B is one TMA load of a 3-D
//     box (BK channels, 1 tap, BN output channels) over w. Both land
//     BK-byte swizzled, as the wgmma descriptors read them (K-major, 8-row
//     groups 8 BK bytes apart).
//   - The fused up-conv (4x4, pad 2, dil 2) is split by output phase: an
//     output row 2i + py meets input rows i + (py + ky - pad) / 2 only
//     through the taps ky of the parity of pad - py, so each of the four
//     phases (py, px) is a 2x2 conv over the undilated input, and only the
//     4 taps an output that carry data go through the tensor cores (an
//     lhs-dilated gather would multiply 16, 12 of them zeros). The phase is
//     part of the block index; a block writes its pixels at stride 2. Any
//     KH, KW and pad work the same way, with a phase's tap count
//     (KH - ky0 + 1) / 2.
//   - A ring of 4 stages (3 of 128-channel steps; two blocks fit an SM)
//     with full/empty mbarriers: one producer warp issues the TMA loads;
//     two consumer warpgroups each run wgmma.mma_async m64nBNk32 s8 x s8 ->
//     s32 on their 64 rows, BK / 32 a stage, and keep one wgmma group in
//     flight while the next stage arrives.
//   - Epilogue: the accumulators go to shared memory (over the ring), then
//     each thread takes 8 channels of a pixel (the same 8 for all its
//     pixels, their scale and bias loaded once), applies the rounding
//     chain (in bf16 as bf16x2 instructions, a pair of channels each) and
//     writes them with 16-byte stores (scalar stores where Cout is no
//     multiple of 8).
// The wrapper (rcu_tpu_torch/ops/cuda/int8conv.py) gives x with Cin a
// multiple of 16 and 16-byte aligned (TMA's stride and address rules),
// padding the channels with zeros where the caller's tensor is not.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBK = 128;  // channels (bytes) of a reduction step, at most
constexpr int kTileH = 8;    // output rows of a tile (of its phase)
constexpr int kTileW = 16;   // output columns of a tile
constexpr int kBM = kTileH * kTileW;  // 128 output pixels
constexpr int kConsumers = 256;       // two warpgroups, 64 rows each
constexpr int kThreads = kConsumers + 32;  // and one producer warp

enum OutKind { kInt32 = 0, kF32 = 1, kBf16 = 2 };

struct Params {
  void* y;
  const void* prior;   // null, or the first term of a split pair (= y)
  const void* scale;  // (Cout,) in the compute dtype (f32 or bf16)
  const void* bias;   // null or (Cout,), the same
  const void* lo;     // null or (Cout,) bf16, a folded site's second term
  int out_kind, vec;
  int chunks, kh, kw, pad, dil, hout, wout, cout;
  int phases, tiles_h, tiles_w, nblk;
};

// BK: channels (bytes) of a reduction step, 128, 64 where Cin <= 64, or 32
// where Cin <= 32; a row of a tile is BK bytes, swizzled by BK bytes. The
// ring holds 4 stages, 3 of 128-channel steps (two blocks an SM either way)
template <int BN, int BK>
struct Layout {
  static constexpr int kStages = BK == 128 ? 3 : 4;
  static constexpr int kATile = kBM * BK;
  static constexpr int kStage = kATile + BN * BK;
  static constexpr int kRowOut = BN * 4 + 32;  // staging row, bank-spread
  static constexpr int kRing = kStages * kStage;
  static constexpr int kStaging = kBM * kRowOut;
  static constexpr int kBars = kRing > kStaging ? kRing : kStaging;
  static constexpr int kSmem = kBars + 16 * kStages + 1024;  // + alignment
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done;
}

// Returns once the barrier's phase of parity `parity` has completed. After
// 2^30 failed tries (seconds) it traps, and the launch fails, instead of
// hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t tries = 0;
  while (!mbar_try_wait(bar, parity))
    if (++tries == (1u << 30)) __trap();
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3) : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
      "r"(c1), "r"(c2) : "memory");
}

// wgmma shared-memory descriptor of a K-major tile of BK-byte rows with the
// BK-byte swizzle (layout type 1 for 128 bytes, 2 for 64, 3 for 32): 8-row
// groups 8 BK bytes apart (stride byte offset); the leading byte offset is
// unused for a swizzled K-major operand.
template <int BK>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(1) << 16)
         | (static_cast<uint64_t>(8 * BK >> 4) << 32)
         | (static_cast<uint64_t>(BK == 128 ? 1 : BK == 64 ? 2 : 3) << 62);
}

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// keeps the compiler from moving accumulator accesses across wgmma
template <int R>
__device__ __forceinline__ void fence_regs(int* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define R4(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define R32 R4(0), R4(4), R4(8), R4(12), R4(16), R4(20), R4(24), R4(28)
#define R64 R4(0), R4(4), R4(8), R4(12), R4(16), R4(20), R4(24), R4(28), \
            R4(32), R4(36), R4(40), R4(44), R4(48), R4(52), R4(56), R4(60)

// d += A (64 x 32, descriptor a) * B (BN x 32, descriptor b)^T, int32
template <int BN>
struct Mma;

template <>
struct Mma<64> {
  static __device__ __forceinline__ void run(int* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31},"
        " %32, %33, p;\n}\n"
        : R32
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<128> {
  static __device__ __forceinline__ void run(int* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63},"
        " %64, %65, p;\n}\n"
        : R64
        : "l"(a), "l"(b), "r"(1));
  }
};

// bf16 pairs in a 32-bit register, element 0 in the low half. A product
// of two bf16 is exact in f32 and a sum of two rounds to the same bf16
// through f32 as directly, so one bf16x2 instruction, rounded to nearest
// even, gives what the eager chain's f32 op and bf16 cast give; being
// inline PTX, no mul and add contract into one fma.
__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t bf16x2_add(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// (bf16(a), bf16(b)) of two f32, rounded to nearest even
__device__ __forceinline__ uint32_t bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The epilogue's terms of 8 consecutive output channels: a thread's
// channels are the same for every pixel it stores, so they load once; in
// the f32 mode as floats, in the bf16 mode as 4 bf16 pairs.
struct Columns {
  float scale[8], bias[8];
  uint32_t scale2[4], bias2[4], lo2[4];
  int n;  // channels of the 8 below Cout
};

// element k of a (Cout,) bf16 vector from c, as the low 16 bits
__device__ __forceinline__ uint32_t bf16_bits(const void* v, int c, int k) {
  return __ldg(static_cast<const unsigned short*>(v) + c + k);
}

__device__ __forceinline__ void load_columns(const Params& p, int c, Columns& cols) {
  cols.n = min(8, p.cout - c);
  if (p.out_kind == kF32) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int cc = c + (k < cols.n ? k : 0);  // columns past Cout are not stored
      cols.scale[k] = __ldg(static_cast<const float*>(p.scale) + cc);
      cols.bias[k] = p.bias ? __ldg(static_cast<const float*>(p.bias) + cc) : 0.0f;
    }
  } else if (p.out_kind == kBf16) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k0 = 2 * j < cols.n ? 2 * j : 0;
      const int k1 = 2 * j + 1 < cols.n ? 2 * j + 1 : 0;
      cols.scale2[j] = bf16_bits(p.scale, c, k0) | bf16_bits(p.scale, c, k1) << 16;
      cols.bias2[j] = p.bias ? bf16_bits(p.bias, c, k0) | bf16_bits(p.bias, c, k1) << 16 : 0u;
      cols.lo2[j] = p.lo ? bf16_bits(p.lo, c, k0) | bf16_bits(p.lo, c, k1) << 16 : 0u;
    }
  }
}

// stores 8 channels [c, c + cols.n) of one pixel at y + o
__device__ __forceinline__ void store8(const Params& p, const Columns& cols,
                                       long long o, const int* acc) {
  const int n = cols.n;
  const bool full = n == 8 && p.vec;
  if (p.out_kind == kInt32) {
    int* y = static_cast<int*>(p.y) + o;
    if (full) {
      reinterpret_cast<int4*>(y)[0] = make_int4(acc[0], acc[1], acc[2], acc[3]);
      reinterpret_cast<int4*>(y)[1] = make_int4(acc[4], acc[5], acc[6], acc[7]);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (k < n) y[k] = acc[k];
    }
  } else if (p.out_kind == kF32) {
    float* y = static_cast<float*>(p.y) + o;
    float prior[8] = {};
    if (p.prior != nullptr) {
      const float* src = static_cast<const float*>(p.prior) + o;
      if (full) {
        const float4 u = reinterpret_cast<const float4*>(src)[0];
        const float4 v = reinterpret_cast<const float4*>(src)[1];
        prior[0] = u.x; prior[1] = u.y; prior[2] = u.z; prior[3] = u.w;
        prior[4] = v.x; prior[5] = v.y; prior[6] = v.z; prior[7] = v.w;
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (k < n) prior[k] = src[k];
      }
    }
    float out[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float t = __fmul_rn(__int2float_rn(acc[k]), cols.scale[k]);
      if (p.prior != nullptr) t = __fadd_rn(prior[k], t);
      if (p.bias != nullptr) t = __fadd_rn(t, cols.bias[k]);
      out[k] = t;
    }
    if (full) {
      reinterpret_cast<float4*>(y)[0] = make_float4(out[0], out[1], out[2], out[3]);
      reinterpret_cast<float4*>(y)[1] = make_float4(out[4], out[5], out[6], out[7]);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (k < n) y[k] = out[k];
    }
  } else {
    __nv_bfloat16* y = static_cast<__nv_bfloat16*>(p.y) + o;
    uint32_t prior[4] = {};
    if (p.prior != nullptr) {
      const __nv_bfloat16* src = static_cast<const __nv_bfloat16*>(p.prior) + o;
      if (full) {
        const uint4 u = *reinterpret_cast<const uint4*>(src);
        prior[0] = u.x; prior[1] = u.y; prior[2] = u.z; prior[3] = u.w;
      } else {
        uint16_t h[8] = {};
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (k < n) h[k] = __bfloat16_as_ushort(src[k]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          prior[j] = h[2 * j] | (static_cast<uint32_t>(h[2 * j + 1]) << 16);
      }
    }
    uint32_t out[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t t = bf16x2(__int2float_rn(acc[2 * j]),
                          __int2float_rn(acc[2 * j + 1]));
      t = bf16x2_mul(t, cols.scale2[j]);
      if (p.prior != nullptr) t = bf16x2_add(prior[j], t);
      if (p.bias != nullptr) t = bf16x2_add(t, cols.bias2[j]);
      if (p.lo != nullptr) t = bf16x2_add(t, cols.lo2[j]);
      out[j] = t;
    }
    if (full) {
      *reinterpret_cast<uint4*>(y) = make_uint4(out[0], out[1], out[2], out[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (k < n)
          y[k] = __ushort_as_bfloat16(static_cast<unsigned short>(
              out[k / 2] >> (16 * (k % 2))));
    }
  }
}

template <int BN, int BK>
__global__ void __launch_bounds__(kThreads, 1)
int8_conv_kernel(const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_w, const Params p) {
  using L = Layout<BN, BK>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms stay aligned
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t full0 = base + L::kBars;
  constexpr int kStages = L::kStages;
  const uint32_t empty0 = full0 + 8 * kStages;

  // the block's tile: output channels fastest, so the blocks that share an
  // A tile run side by side and meet it in L2
  int bid = blockIdx.x;
  const int nb = bid % p.nblk;
  bid /= p.nblk;
  const int tw = bid % p.tiles_w;
  bid /= p.tiles_w;
  const int th = bid % p.tiles_h;
  bid /= p.tiles_h;
  const int phase = bid % p.phases;
  const int img = bid / p.phases;
  const int py = phase >> 1, px = phase & 1;
  const int i0 = th * kTileH, j0 = tw * kTileW;
  const int sh = p.dil - 1;  // output (phase-grid) index i -> row (i << sh) + py
  // the taps of this phase: ky0, ky0 + dil, ... (dil 2: those of the
  // parity of pad - py, which meet input rows, not the zeros between them)
  const int ky0 = sh ? (p.pad - py) & 1 : 0;
  const int kx0 = sh ? (p.pad - px) & 1 : 0;
  const int nty = (p.kh - ky0 + sh) >> sh;
  const int ntx = (p.kw - kx0 + sh) >> sh;
  const int iters = nty * ntx * p.chunks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == kConsumers / 32) {  // the producer warp
    if (lane == 0) {
      int s = 0;
      uint32_t parity = 0;
      for (int it = 0; it < iters; ++it) {
        const int chunk = it % p.chunks, tap = it / p.chunks;
        const int ky = ky0 + ((tap / ntx) << sh);
        const int kx = kx0 + ((tap % ntx) << sh);
        mbar_wait(empty0 + 8 * s, parity ^ 1);
        const uint32_t a = base + s * L::kStage;
        mbar_expect_tx(full0 + 8 * s, L::kStage);
        // input row of output row i: i + (py + ky - pad) / dil (exact)
        tma_load_4d(a, &map_x, full0 + 8 * s, chunk * BK,
                    j0 + ((px + kx - p.pad) >> sh),
                    i0 + ((py + ky - p.pad) >> sh), img);
        tma_load_3d(a + L::kATile, &map_w, full0 + 8 * s, chunk * BK,
                    ky * p.kw + kx, nb * BN);
        if (++s == kStages) {
          s = 0;
          parity ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns tile rows [64 wg, 64 wg + 64)
  const int wg = warp >> 2;
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  int s = 0, prev = -1;
  uint32_t parity = 0;
  for (int it = 0; it < iters; ++it) {
    mbar_wait(full0 + 8 * s, parity);
    const uint32_t a = base + s * L::kStage + wg * 64 * BK;
    const uint32_t b = base + s * L::kStage + L::kATile;
    fence_regs<BN / 2>(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < BK; k += 32)
      Mma<BN>::run(acc, smem_desc<BK>(a + k), smem_desc<BK>(b + k));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    fence_regs<BN / 2>(acc);
    // the previous stage's products are done: hand its buffers back
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    if (prev >= 0 && lane == 0) mbar_arrive(empty0 + 8 * prev);
    prev = s;
    if (++s == kStages) {
      s = 0;
      parity ^= 1;
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_regs<BN / 2>(acc);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_sync(1, kConsumers);  // every wgmma has read the ring: reuse it

  // accumulator fragment -> staging: rows 16 w + lane / 4 (+ 8), columns
  // 8 j + 2 (lane % 4) (+ 1) of the warp's 16-row slice
  const int row = wg * 64 + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = j * 8 + (lane & 3) * 2;
    *reinterpret_cast<int2*>(smem + row * L::kRowOut + col * 4) =
        make_int2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<int2*>(smem + (row + 8) * L::kRowOut + col * 4) =
        make_int2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  named_sync(1, kConsumers);

  const int q = threadIdx.x % (BN / 8);
  const int c = nb * BN + q * 8;
  if (c >= p.cout) return;
  Columns cols;
  load_columns(p, c, cols);
  for (int r = threadIdx.x / (BN / 8); r < kBM; r += kConsumers / (BN / 8)) {
    const int oy = ((i0 + r / kTileW) << sh) + py;
    const int ox = ((j0 + r % kTileW) << sh) + px;
    if (oy >= p.hout || ox >= p.wout) continue;
    const int4* src = reinterpret_cast<const int4*>(smem + r * L::kRowOut + q * 32);
    const int4 u = src[0], v = src[1];
    const int vals[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
    const long long o = (((long long)img * p.hout + oy) * p.wout + ox) * p.cout + c;
    store8(p, cols, o, vals);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, without linking libcuda
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &status) == cudaSuccess &&
        status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

template <int BN, int BK>
int launch(const CUtensorMap& map_x, const CUtensorMap& map_w, const Params& p,
           long long blocks, cudaStream_t stream) {
  const int smem = Layout<BN, BK>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      int8_conv_kernel<BN, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  int8_conv_kernel<BN, BK><<<(unsigned)blocks, kThreads, smem, stream>>>(
      map_x, map_w, p);
  return (int)cudaGetLastError();
}

}  // namespace

// The layout constants, for the wrapper's check: tile rows, tile columns,
// the largest BK, threads, and the channel grain and byte alignment that
// the input must have.
extern "C" int rcu_int8_conv_layout(int* out) {
  out[0] = kTileH;
  out[1] = kTileW;
  out[2] = kMaxBK;
  out[3] = kThreads;
  out[4] = 16;
  out[5] = 16;
  return 0;
}

// Launches the convolution on `stream`. x: (n, h, wd, cin) int8 with cin a
// multiple of 16, w: (cout, kh, kw, cin) int8, both 16-byte aligned; y:
// (n, hout, wout, cout) of out_kind (0 int32, 1 f32, 2 bf16); scale, bias:
// (cout,) arrays of y's dtype or null (scale is required unless int32); lo:
// null, or (cout,) bf16 where y is bf16; prior: null or y. Returns 0, a
// cudaError of the launch, -1 if the driver has no cuTensorMapEncodeTiled,
// or -1000 - CUresult if a tensor map does not encode;
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int rcu_int8_conv(const int8_t* x, const int8_t* w, void* y,
                             const void* prior, const void* scale,
                             const void* bias, const void* lo, int out_kind,
                             int n, int h, int wd, int cin, int cout, int kh,
                             int kw, int pad, int dil, cudaStream_t stream) {
  if (n < 1 || h < 1 || wd < 1 || cin < 16 || cin % 16 || cout < 1 ||
      kh < 1 || kw < 1 || pad < 0 || (dil != 1 && dil != 2) ||
      out_kind < kInt32 || out_kind > kBf16 ||
      (out_kind != kInt32 && scale == nullptr) ||
      (out_kind == kInt32 && (prior || bias)) ||
      (out_kind != kBf16 && lo) ||
      (prior != nullptr && prior != y) ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(y)) % 16)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.y = y;
  p.prior = prior;
  p.scale = scale;
  p.bias = bias;
  p.lo = lo;
  p.out_kind = out_kind;
  p.vec = cout % 8 == 0;
  const int bk = cin <= 32 ? 32 : cin <= 64 ? 64 : kMaxBK;
  p.chunks = (cin + bk - 1) / bk;
  p.kh = kh;
  p.kw = kw;
  p.pad = pad;
  p.dil = dil;
  p.hout = (h - 1) * dil + 1 + 2 * pad - kh + 1;
  p.wout = (wd - 1) * dil + 1 + 2 * pad - kw + 1;
  p.cout = cout;
  if (p.hout < 1 || p.wout < 1) return (int)cudaErrorInvalidValue;
  p.phases = dil * dil;
  p.tiles_h = ((p.hout + dil - 1) / dil + kTileH - 1) / kTileH;
  p.tiles_w = ((p.wout + dil - 1) / dil + kTileW - 1) / kTileW;
  const int bn = cout <= 64 ? 64 : 128;
  p.nblk = (cout + bn - 1) / bn;
  const long long blocks =
      (long long)n * p.phases * p.tiles_h * p.tiles_w * p.nblk;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;

  EncodeTiled encode = encoder();
  if (encode == nullptr) return -1;
  CUtensorMap map_x, map_w;
  const CUtensorMapSwizzle swizzle =
      bk == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : bk == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  // x as (C, W, H, N), a box of BK channels x 16 columns x 8 rows x 1 image
  const cuuint64_t x_dims[4] = {(cuuint64_t)cin, (cuuint64_t)wd, (cuuint64_t)h,
                                (cuuint64_t)n};
  const cuuint64_t x_strides[3] = {(cuuint64_t)cin, (cuuint64_t)wd * cin,
                                   (cuuint64_t)h * wd * cin};
  const cuuint32_t x_box[4] = {(cuuint32_t)bk, kTileW, kTileH, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  CUresult res = encode(&map_x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4,
                        const_cast<int8_t*>(x), x_dims, x_strides, x_box, ones,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return -1000 - (int)res;
  // w as (C, taps, Cout), a box of BK channels x 1 tap x BN output channels
  const cuuint64_t w_dims[3] = {(cuuint64_t)cin, (cuuint64_t)kh * kw,
                                (cuuint64_t)cout};
  const cuuint64_t w_strides[2] = {(cuuint64_t)cin, (cuuint64_t)kh * kw * cin};
  const cuuint32_t w_box[3] = {(cuuint32_t)bk, 1, (cuuint32_t)bn};
  res = encode(&map_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3,
               const_cast<int8_t*>(w), w_dims, w_strides, w_box, ones,
               CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return -1000 - (int)res;
  if (bk == 32)
    return bn == 64 ? launch<64, 32>(map_x, map_w, p, blocks, stream)
                    : launch<128, 32>(map_x, map_w, p, blocks, stream);
  if (bk == 64)
    return bn == 64 ? launch<64, 64>(map_x, map_w, p, blocks, stream)
                    : launch<128, 64>(map_x, map_w, p, blocks, stream);
  return bn == 64 ? launch<64, 128>(map_x, map_w, p, blocks, stream)
                  : launch<128, 128>(map_x, map_w, p, blocks, stream);
}

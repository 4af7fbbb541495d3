// Int8 x int8 -> int32 convolution for Hopper (sm_90a), as an implicit GEMM.
//
// Replaces rcu_tpu/ops/quant.py:int8_conv, which the JAX package leaves to
// XLA (lax.conv_general_dilated with preferred_element_type=int32; on the
// TPU the MXU's int8 mode). No PyTorch call computes it on the card:
// cuDNN's int8 convolutions are not exposed, and torch._int_mm over an
// im2col buffer would write 9x (3x3) or 16x (4x4, lhs-dilated) the
// activation first.
//
// The function: x NHWC int8 (N, H, W, Cin), w int8 (Cout, KH, KW, Cin),
// stride 1, symmetric zero padding `pad`, an lhs (input) dilation `dil` of
// 1 or 2 (dil 2 spreads the input with a zero between neighbours, as
// lax.conv_general_dilated's lhs_dilation does), y NHWC int32 (N, Hout,
// Wout, Cout) with Hout = (H - 1) * dil + 1 + 2 * pad - KH + 1. Sums are
// exact in int32: the widest reduction of the U-Net, the 4x4 up-conv from
// 512 channels, stays below 16 * 512 * 127^2 ~ 1.3e8.
//
// As a GEMM: M = N * Hout * Wout output pixels, N = Cout, K = KH * KW * Cin,
// walked tap by tap in chunks of 32 channels (a chunk past Cin is zero in
// shared memory, so any Cin works; Cin = 4 uses 4/32 of each chunk).
//   - A block computes a 128 x 64 tile of y with 8 warps, each a 32 x 32
//     sub-tile of 2 x 4 mma.sync.aligned.m16n8k32 s8 x s8 -> s32 tiles.
//   - A (128 pixels x 32 bytes) is gathered from NHWC per tap: the pixel's
//     input position is (o + k - pad) / dil, and a position in the padding,
//     or one that falls between two input rows or columns under dil = 2
//     (odd), loads zeros. B (64 output channels x 32 bytes) is read from w,
//     whose reduction dimension is contiguous. With Cin % 16 == 0 (every
//     U-Net site but the first) each thread moves one 16-byte vector of A
//     and one of B; otherwise bytes, with the channel tail zeroed.
//   - Two shared-memory stages with register prefetch: the next chunk's
//     global loads are in flight while the tensor cores work on this one;
//     one barrier a chunk. Rows are padded to 48 bytes, so the fragment
//     reads of a warp hit 32 distinct banks.
//   - The epilogue writes int32 straight from the accumulators.
// Bound on an H100 SXM: at the U-Net's shapes, memory (the int32 output is
// 4 bytes a value: 4x the int8 input for Cout = Cin) over the 1979 TOPS of
// int8 tensor-core work. What this first design leaves (ROADMAP.md): the
// dequantize and bias epilogue in the compute dtype (halving or quartering
// the written bytes), wgmma with TMA and warp specialisation, and the
// 4x4 lhs-dilated case computes all 16 taps of which 4 are non-zero for
// each output (a phase split would skip the other 12).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;      // output pixels per block
constexpr int kBN = 64;       // output channels per block
constexpr int kBK = 32;       // bytes (channels) per reduction chunk
constexpr int kThreads = 256; // 8 warps: 4 along M x 2 along N
constexpr int kRow = 48;      // shared-memory row stride in bytes

struct Conv {
  const int8_t* x;
  const int8_t* w;
  int32_t* y;
  int n, h, wd, cin, cout, kh, kw, pad, dil, hout, wout, chunks;
  long long m;  // output pixels
  int vec;      // 16-byte vector loads (Cin % 16 == 0, aligned pointers)
};

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes of channels [c0, c0 + 16) at src (null: zeros), the tail past
// cin zeroed.
__device__ __forceinline__ uint4 load16(const int8_t* src, int c0, int cin,
                                        int vec) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (src == nullptr || c0 >= cin) return v;
  if (vec) return *reinterpret_cast<const uint4*>(src);
  uint32_t words[4] = {0u, 0u, 0u, 0u};
  for (int j = 0; j < 16 && c0 + j < cin; ++j)
    words[j >> 2] |= (uint32_t)(uint8_t)src[j] << (8 * (j & 3));
  return make_uint4(words[0], words[1], words[2], words[3]);
}

__global__ void __launch_bounds__(kThreads)
int8_conv_kernel(Conv p) {
  __shared__ __align__(16) int8_t sa[2][kBM * kRow];
  __shared__ __align__(16) int8_t sb[2][kBN * kRow];
  const int t = threadIdx.x;
  const int half = t & 1;  // which 16 bytes of a 32-byte row this thread moves

  // this thread's A row: one output pixel, fixed for the whole reduction
  const long long m = (long long)blockIdx.x * kBM + (t >> 1);
  const bool row_ok = m < p.m;
  const long long hw = (long long)p.hout * p.wout;
  const int img = row_ok ? (int)(m / hw) : 0;
  const int rem = row_ok ? (int)(m % hw) : 0;
  const int oy = rem / p.wout, ox = rem % p.wout;
  // this thread's B row (threads 0..127): one output channel
  const int co = blockIdx.y * kBN + (t >> 1);
  const bool col_ok = t < 2 * kBN && co < p.cout;
  const long long k_total = (long long)p.kh * p.kw * p.cin;

  auto load = [&](int step, uint4& va, uint4& vb) {
    const int tap = step / p.chunks;
    const int c0 = (step % p.chunks) * kBK + half * 16;
    const int ky = tap / p.kw, kx = tap % p.kw;
    const int8_t* src = nullptr;
    if (row_ok) {
      int py = oy + ky - p.pad, px = ox + kx - p.pad;
      bool ok = py >= 0 && px >= 0;
      if (p.dil == 2) {
        ok = ok && !(py & 1) && !(px & 1);
        py >>= 1;
        px >>= 1;
      }
      if (ok && py < p.h && px < p.wd)
        src = p.x + (((long long)img * p.h + py) * p.wd + px) * p.cin + c0;
    }
    va = load16(src, c0, p.cin, p.vec);
    vb = load16(col_ok ? p.w + co * k_total + (long long)tap * p.cin + c0
                       : nullptr, c0, p.cin, p.vec);
  };
  auto store = [&](int buf, const uint4& va, const uint4& vb) {
    *reinterpret_cast<uint4*>(&sa[buf][(t >> 1) * kRow + half * 16]) = va;
    if (t < 2 * kBN)
      *reinterpret_cast<uint4*>(&sb[buf][(t >> 1) * kRow + half * 16]) = vb;
  };

  const int warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 32;
  int acc[2][4][4] = {};

  const int steps = p.kh * p.kw * p.chunks;
  uint4 va, vb;
  load(0, va, vb);
  store(0, va, vb);
  int buf = 0;
  for (int s = 0; s < steps; ++s) {
    __syncthreads();
    const bool more = s + 1 < steps;
    if (more) load(s + 1, va, vb);
    const int8_t* a_s = sa[buf];
    const int8_t* b_s = sb[buf];
    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int r = wm + mt * 16 + g;
      a[mt][0] = *reinterpret_cast<const uint32_t*>(&a_s[r * kRow + tig * 4]);
      a[mt][1] = *reinterpret_cast<const uint32_t*>(&a_s[(r + 8) * kRow + tig * 4]);
      a[mt][2] = *reinterpret_cast<const uint32_t*>(&a_s[r * kRow + 16 + tig * 4]);
      a[mt][3] = *reinterpret_cast<const uint32_t*>(&a_s[(r + 8) * kRow + 16 + tig * 4]);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int c = wn + nt * 8 + g;
      b[nt][0] = *reinterpret_cast<const uint32_t*>(&b_s[c * kRow + tig * 4]);
      b[nt][1] = *reinterpret_cast<const uint32_t*>(&b_s[c * kRow + 16 + tig * 4]);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], a[mt], b[nt]);
    if (more) store(buf ^ 1, va, vb);
    buf ^= 1;
  }

  // C fragment: c0, c1 at (row g, cols 2 tig, 2 tig + 1); c2, c3 at row g + 8
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const long long row = (long long)blockIdx.x * kBM + wm + mt * 16 + g + 8 * i;
      if (row >= p.m) continue;
      int32_t* out = p.y + row * p.cout;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = blockIdx.y * kBN + wn + nt * 8 + tig * 2;
        if (col < p.cout) out[col] = acc[mt][nt][2 * i];
        if (col + 1 < p.cout) out[col + 1] = acc[mt][nt][2 * i + 1];
      }
    }
  }
}

}  // namespace

// The tile constants, for the wrapper's check: BM, BN, BK, threads.
extern "C" int rcu_int8_conv_layout(int* out) {
  out[0] = kBM;
  out[1] = kBN;
  out[2] = kBK;
  out[3] = kThreads;
  return 0;
}

// Launches the convolution on `stream`; returns the cudaError of the launch
// (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int rcu_int8_conv(const int8_t* x, const int8_t* w, int32_t* y,
                             int n, int h, int wd, int cin, int cout, int kh,
                             int kw, int pad, int dil, int vec,
                             cudaStream_t stream) {
  if (n < 1 || h < 1 || wd < 1 || cin < 1 || cout < 1 || kh < 1 || kw < 1 ||
      pad < 0 || (dil != 1 && dil != 2))
    return (int)cudaErrorInvalidValue;
  Conv p;
  p.x = x;
  p.w = w;
  p.y = y;
  p.n = n;
  p.h = h;
  p.wd = wd;
  p.cin = cin;
  p.cout = cout;
  p.kh = kh;
  p.kw = kw;
  p.pad = pad;
  p.dil = dil;
  p.hout = (h - 1) * dil + 1 + 2 * pad - kh + 1;
  p.wout = (wd - 1) * dil + 1 + 2 * pad - kw + 1;
  p.chunks = (cin + kBK - 1) / kBK;
  p.vec = vec;
  if (p.hout < 1 || p.wout < 1) return (int)cudaErrorInvalidValue;
  p.m = (long long)n * p.hout * p.wout;
  const long long blocks_m = (p.m + kBM - 1) / kBM;
  const int blocks_n = (cout + kBN - 1) / kBN;
  if (blocks_m > 0x7fffffffLL || blocks_n > 65535)
    return (int)cudaErrorInvalidValue;
  int8_conv_kernel<<<dim3((unsigned)blocks_m, blocks_n), kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

// Fused per-subject eval statistics for Hopper (sm_90a), one pass over the
// five per-voxel planes of a subject, or of each of K images in one launch.
//
// Replaces the TPU kernel rcu_tpu/ops/pallas/evalstats.py:fused_eval_stats
// (Pallas body _make_kernel). It computes the same function, not the same
// block structure:
//   - for each of 10 reliability bins: the weighted voxel count, sum of
//     confidences and sum of targets (the weight applies to bins only);
//   - the unweighted confusion counts tp/tn/fp/fn;
//   - tpu/tnu/fpu/fnu for up to 23 thresholds, uncertainty > threshold.
//
// Bound on an H100 SXM: memory. A voxel is 11 bytes (fg and uncertainty
// f32; target, prediction and weight u8), 98.2 MB for a 155x240x240 BraTS
// volume, 29.3 us at 3.35 TB/s.
//
// The first design (warp ballots) ran at 11x that bound. Its main loop,
// read from `cuobjdump -sass` (scripts/sass_loop.py), holds 4495 warp
// instructions per pass of 4 voxels a lane, 1124 per 32 voxels: 24 ballots
// and 68 predicated popc-and-add chains per 32 voxels, every one issued by
// the whole warp and kept by one lane. That is ~0.30 ms of issue for a
// volume on 132 SMs (4 schedulers each, 1.98 GHz), the time it took. This
// design answers its four limits:
//   1. Issue. No warp votes: every lane counts its own voxels into private
//      counters in dynamic shared memory, laid out [warp][cell][lane], so
//      the 32 lanes of a warp always hit 32 different banks whatever the
//      data (real fg maps pile into bin 0 and tn), and counting needs no
//      atomics. Per voxel: the bin id (9 compares against the edges in
//      `p >= e` form: the host turns a strict edge into the next float up,
//      and passing the top edge keeps the last bin), m = the number of
//      thresholds with u > th (the host sorts them, NaN as +inf), the class
//      c = 2 * target + prediction, and three shared increments:
//        bin cell [2 * id + target] += w, conf cell [id] += w ? p : 0,
//        hist cell [c][m] += 1.
//      Each compare is a predicated add (2 instructions; `m += u > th`
//      compiles to 3). The main loop holds 569 warp instructions per pass
//      of 8 voxels a lane, the threshold loop in it 73 for 4 thresholds;
//      at 11 thresholds that is ~80 issued per 32 voxels, ~21 us of issue
//      for a volume, under the memory time.
//   2. Waves. The grid is the occupancy times the SM count (queried once
//      per device and threshold count), with a grid-stride loop: one wave.
//      The lane counters bound the occupancy (2 blocks of 256 an SM at 11
//      thresholds), not the registers.
//   3. Loads. Chunks of 8 voxels a thread: two float4 of fg, two of u and
//      one 8-byte load of each u8 plane; the ragged tail is one masked
//      chunk, never padded. The kernel streams near the memory rate between
//      half and full size, so these loads in flight suffice and a bulk-copy
//      ring in shared memory (which would also take room from the lane
//      counters) has nothing to add.
//   4. The cross-block sums and the wrapper. One launch: each block writes
//      its row of partial sums; the last block (an atomic ticket after a
//      __threadfence, zeroed by the launcher before the launch) sums the
//      rows in block order and writes the int64 / float64 result row with
//      the threshold rows in the caller's order. The wrapper makes one
//      allocation a call and caches the edge and threshold arguments.
//   5. An image axis. The native-2D eval reduces K same-shape images a
//      chunk (ISIC: 32 images of 192x256, 49,152 voxels each), and its
//      reference vmaps one reduction an image. A launch an image would cost
//      K times the wrapper's host time and the kernel's fixed cost for
//      0.16 us of streaming each. So one launch takes K images: blockIdx.y
//      is the image, and each image has the grid, partial rows, ticket and
//      result row that a launch of that image alone would have. The blocks
//      of an image therefore count the same voxels in the same order as a
//      single launch, and each image's result is bitwise that launch's.
//      One memset zeroes the K tickets. Where K > 1 and an image's size is
//      not a multiple of 8 voxels, the images after the first do not start
//      on a vector boundary: every chunk then takes the masked scalar path.
// Determinism: counts are exact; confidences add in f32 per lane in voxel
// order, in f64 from the block sums on, always in the same order, so two
// runs give bit-identical results. Per-lane counters are int32: the host
// refuses a size at which one lane could see 2^31 voxels.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kBins = 10;
constexpr int kEdges = kBins - 1;  // passing the top edge keeps the last bin
constexpr int kMaxThresholds = 23;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVoxels = 8;  // voxels per thread per iteration: a chunk
constexpr int kQuads = kVoxels / 4;  // float4s of a chunk in an f32 plane,
                                     // 32-bit words in a u8 plane
constexpr int kClasses = 4;  // c = 2 * target + prediction: tn, fp, fn, tp
// result row: int64 bin counts, bin target sums, tp/tn/fp/fn, then
// (tpu, tnu, fpu, fnu) per threshold in the caller's order; then the
// float64 confidence sums
constexpr int kOffTrue = kBins;
constexpr int kOffThresh = 2 * kBins + 4;
constexpr int kIntCols = kOffThresh + 4 * kMaxThresholds;
// per-lane cells for T thresholds: (bin, target) counts, the (class, m)
// histogram with m in 0..T, then the f32 confidence sums
constexpr int kBinCells = 2 * kBins;
__host__ __device__ constexpr int int_cells(int n_thresholds) {
  return kBinCells + kClasses * (n_thresholds + 1);
}
__host__ __device__ constexpr int lane_cells(int n_thresholds) {
  return int_cells(n_thresholds) + kBins;
}
constexpr int kMaxCells = lane_cells(kMaxThresholds);
constexpr size_t shared_bytes(int n_thresholds) {
  return sizeof(int) * 32 * kWarps * lane_cells(n_thresholds);
}

struct Params {
  float edge[kEdges];  // voxel p is above edge k when p >= edge[k]
  float thresholds[kMaxThresholds];  // ascending
  int slot[kMaxThresholds];  // the caller's row of the j-th smallest
  int n_thresholds;
};

__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t x) {
  // bit 7 of each byte: the byte is not 0
  return (((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) & 0x80808080u;
}

// m += 1 where a > b (a >= b), also false for NaN: a compare and a
// predicated add, where `m += a > b` compiles to three instructions
__device__ __forceinline__ void add_gt(int& m, float a, float b) {
  asm("{\n\t.reg .pred p;\n\tsetp.gt.f32 p, %1, %2;\n\t@p add.s32 %0, %0, 1;\n\t}"
      : "+r"(m) : "f"(a), "f"(b));
}
__device__ __forceinline__ void add_ge(int& m, float a, float b) {
  asm("{\n\t.reg .pred p;\n\tsetp.ge.f32 p, %1, %2;\n\t@p add.s32 %0, %0, 1;\n\t}"
      : "+r"(m) : "f"(a), "f"(b));
}

// The words of one u8 plane for chunk q (one 8-byte load), bit 7 of each
// byte set where the byte is not 0.
__device__ __forceinline__ void load_bytes(const uint8_t* __restrict__ plane,
                                           long long q, uint32_t (&w)[kQuads]) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(plane) + q);
  w[0] = nonzero_bytes(v.x);
  w[1] = nonzero_bytes(v.y);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// Counts the voxels of one chunk into this lane's cells (cell k at
// cells[32 * k]); kTail: some lie past the end (bit e of `valid`: voxel e
// exists).
template <bool kTail>
__device__ __forceinline__ void count_chunk(
    const float (&f)[kVoxels], const float (&u)[kVoxels],
    const uint32_t (&tw)[kQuads], const uint32_t (&pw)[kQuads],
    const uint32_t (&ww)[kQuads], unsigned valid, const Params& prm,
    int* cells) {
  const int row = prm.n_thresholds + 1;  // m = 0..T
  int* bin_cell = cells;
  int* hist_cell = cells + 32 * kBinCells;
  float* conf_cell =
      reinterpret_cast<float*>(cells + 32 * int_cells(prm.n_thresholds));
  int m[kVoxels];
#pragma unroll
  for (int e = 0; e < kVoxels; ++e) m[e] = 0;
  for (int j = 0; j < prm.n_thresholds; ++j) {
    const float th = prm.thresholds[j];
#pragma unroll
    for (int e = 0; e < kVoxels; ++e) add_gt(m[e], u[e], th);
  }
#pragma unroll
  for (int e = 0; e < kVoxels; ++e) {
    const float p = f[e];
    int id = 0;
#pragma unroll
    for (int k = 0; k < kEdges; ++k) add_ge(id, p, prm.edge[k]);
    const int bit = 8 * (e & 3) + 7;
    const int t = (tw[e >> 2] >> bit) & 1;
    const int c = 2 * t + ((pw[e >> 2] >> bit) & 1);
    const int w = (ww[e >> 2] >> bit) & 1;
    bin_cell[32 * (2 * id + t)] += w;
    hist_cell[32 * (c * row + m[e])] += kTail ? (valid >> e) & 1 : 1;
    conf_cell[32 * id] += w ? p : 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
fused_eval_stats_kernel(const float* __restrict__ fg,
                        const float* __restrict__ unc,
                        const uint8_t* __restrict__ tgt,
                        const uint8_t* __restrict__ pred,
                        const uint8_t* __restrict__ weight, long long n,
                        bool vector_loads, Params prm,
                        unsigned* __restrict__ tickets,
                        long long* __restrict__ parts,
                        long long* __restrict__ out) {
  const int T = prm.n_thresholds;
  const int n_int = int_cells(T);
  const int n_cells = lane_cells(T);
  extern __shared__ __align__(16) int s_cells[];  // [warp][cell][lane]
  __shared__ long long s_total[int_cells(kMaxThresholds)];
  __shared__ double s_conf[kBins];
  __shared__ bool s_last;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int* mine = s_cells + warp * n_cells * 32 + lane;
  for (int k = 0; k < n_cells; ++k) mine[32 * k] = 0;  // 0.0f has the same bits

  // this block's image: its planes, ticket, partial rows and result row
  const long long image = blockIdx.y;
  fg += image * n;
  unc += image * n;
  tgt += image * n;
  pred += image * n;
  weight += image * n;
  unsigned* ticket = tickets + image;
  long long* part = parts + image * n_cells * (long long)gridDim.x;
  long long* out_int = out + image * (kIntCols + kBins);
  double* out_conf = reinterpret_cast<double*>(out_int + kIntCols);

  // whole chunks by vector loads where the image starts on a vector
  // boundary
  const long long n_full = vector_loads ? n / kVoxels : 0;
  const long long stride = (long long)gridDim.x * kThreads;
  long long q = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (; q < n_full; q += stride) {
    float f[kVoxels], u[kVoxels];
    uint32_t tw[kQuads], pw[kQuads], ww[kQuads];
    const float4* f4 = reinterpret_cast<const float4*>(fg) + kQuads * q;
    const float4* u4 = reinterpret_cast<const float4*>(unc) + kQuads * q;
#pragma unroll
    for (int i = 0; i < kQuads; ++i) {
      const float4 a = __ldg(f4 + i);
      const float4 b = __ldg(u4 + i);
      f[4 * i] = a.x; f[4 * i + 1] = a.y; f[4 * i + 2] = a.z; f[4 * i + 3] = a.w;
      u[4 * i] = b.x; u[4 * i + 1] = b.y; u[4 * i + 2] = b.z; u[4 * i + 3] = b.w;
    }
    load_bytes(tgt, q, tw);
    load_bytes(pred, q, pw);
    load_bytes(weight, q, ww);
    count_chunk<false>(f, u, tw, pw, ww, 0u, prm, mine);
  }
  for (; q * kVoxels < n; q += stride) {
    // masked chunks: the ragged tail (one chunk, counted by the one thread
    // whose stride lands on it), or every chunk without vector loads
    float f[kVoxels], u[kVoxels];
    uint32_t tw[kQuads] = {}, pw[kQuads] = {}, ww[kQuads] = {};
    const long long base = kVoxels * q;
#pragma unroll  // constant indices keep f/u in registers
    for (int e = 0; e < kVoxels; ++e) {
      const bool in = base + e < n;
      f[e] = in ? fg[base + e] : 0.0f;
      u[e] = in ? unc[base + e] : 0.0f;
      const int bit = 8 * (e & 3) + 7;
      tw[e >> 2] |= (uint32_t)(in && tgt[base + e]) << bit;
      pw[e >> 2] |= (uint32_t)(in && pred[base + e]) << bit;
      ww[e >> 2] |= (uint32_t)(in && weight[base + e]) << bit;
    }
    const int left = n - base < kVoxels ? (int)(n - base) : kVoxels;
    count_chunk<true>(f, u, tw, pw, ww, (1u << (unsigned)left) - 1u, prm,
                      mine);
  }
  __syncthreads();

  // The block's row: each warp takes every kWarps-th cell, a lane sums its
  // column over the warps, the warp sums its lanes (a fixed order), lane 0
  // writes part[cell * grid + block]; confidence sums as f64 bits.
  const int grid = gridDim.x;
#pragma unroll  // a constant trip count: the cells' shuffle chains overlap
  for (int k0 = 0; k0 < kMaxCells; k0 += kWarps) {
    const int k = k0 + warp;
    if (k >= n_cells) break;
    long long bits;
    if (k < n_int) {
      long long s = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += s_cells[(w * n_cells + k) * 32 + lane];
      bits = warp_sum(s);
    } else {
      double s = 0.0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        s += (double)__int_as_float(s_cells[(w * n_cells + k) * 32 + lane]);
      }
      bits = __double_as_longlong(warp_sum(s));
    }
    if (lane == 0) part[(long long)k * grid + blockIdx.x] = bits;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(ticket, 1u) == (unsigned)grid - 1u;
  __syncthreads();
  if (!s_last) return;

  // The last block: each column summed over the blocks in a fixed order
  // (lane l takes blocks l, l + 32, ...), read from L2.
  __threadfence();
  for (int k = warp; k < n_cells; k += kWarps) {
    const long long* col = part + (long long)k * grid;
    if (k < n_int) {
      long long s = 0;
#pragma unroll 8
      for (int b = lane; b < grid; b += 32) s += __ldcg(col + b);
      s = warp_sum(s);
      if (lane == 0) s_total[k] = s;
    } else {
      double s = 0.0;
#pragma unroll 8
      for (int b = lane; b < grid; b += 32) s += __longlong_as_double(__ldcg(col + b));
      s = warp_sum(s);
      if (lane == 0) s_conf[k - n_int] = s;
    }
  }
  __syncthreads();
  const int i = threadIdx.x;
  if (i < kBins) {
    out_int[i] = s_total[2 * i] + s_total[2 * i + 1];
    out_int[kOffTrue + i] = s_total[2 * i + 1];
    out_conf[i] = s_conf[i];
  } else if (i < kBins + 4 + 4 * T) {
    // the confusion count of class c sums m >= 0, threshold j's sums m > j
    // (u > th_j <=> m > j, the thresholds ascending); the output order tp,
    // tn, fp, fn is class 3, 0, 1, 2
    const int r = i - kBins - 4;  // -4..-1: the confusion counts
    const int j = r < 0 ? -1 : r / 4;
    const int c = (r + 7) % 4;
    const long long* hist = s_total + kBinCells + c * (T + 1);
    long long s = 0;
    for (int m = j + 1; m <= T; ++m) s += hist[m];
    out_int[r < 0 ? kOffThresh + r : kOffThresh + 4 * prm.slot[j] + r % 4] = s;
  }
}

}  // namespace

// Layout constants for the Python wrapper to check against its own.
extern "C" int rcu_fused_eval_stats_layout(int* out) {
  out[0] = kBins;
  out[1] = kMaxThresholds;
  out[2] = kIntCols;
  out[3] = kThreads;
  out[4] = kVoxels;
  out[5] = kMaxCells;
  return 0;
}

// The kernel's resident blocks per SM for `n_thresholds` on the current
// device (the grid of one wave is that times the SM count) and its dynamic
// shared memory a block; also lifts its dynamic shared memory limit there
// to what the most thresholds need. Returns a cudaError_t.
extern "C" int rcu_fused_eval_stats_occupancy(int n_thresholds, int* blocks,
                                              int* shared) {
  if (n_thresholds < 0 || n_thresholds > kMaxThresholds) {
    return (int)cudaErrorInvalidValue;
  }
  *shared = (int)shared_bytes(n_thresholds);
  cudaError_t err = cudaFuncSetAttribute(
      fused_eval_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shared_bytes(kMaxThresholds));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fused_eval_stats_kernel, kThreads, shared_bytes(n_thresholds));
}

// Zeroes the tickets and launches on `stream`; returns the cudaError_t of
// the two (0 = queued). The planes hold `images` images of `n` voxels each,
// one after another; fg and unc 16-byte aligned, the u8 planes 8-byte
// aligned. `edge` holds the 9 inner bin edges in `p >= edge` form;
// `thresholds` ascending without NaN, `slots[j]` the caller's row of
// thresholds[j] (a permutation of 0..n_thresholds-1). `grid`: the blocks
// of each image. `scratch`: `images` 4-byte tickets in
// ticket_words(images) 8-byte words, then images * grid *
// lane_cells(n_thresholds) 8-byte partials. `out`: a row an image, kIntCols
// int64 then kBins float64.
extern "C" int rcu_fused_eval_stats(const float* fg, const float* unc,
                                    const uint8_t* tgt, const uint8_t* pred,
                                    const uint8_t* weight, long long n,
                                    int images, const float* edge,
                                    const float* thresholds, const int* slots,
                                    int n_thresholds, void* scratch,
                                    long long* out, int grid, void* stream) {
  if (n < 0 || n_thresholds < 0 || n_thresholds > kMaxThresholds || grid <= 0 ||
      images <= 0 || images > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  Params prm;
  memcpy(prm.edge, edge, sizeof(prm.edge));
  unsigned seen = 0;
  for (int j = 0; j < kMaxThresholds; ++j) {
    prm.thresholds[j] = j < n_thresholds ? thresholds[j] : __builtin_inff();
    prm.slot[j] = j < n_thresholds ? slots[j] : 0;
    if (j < n_thresholds) {
      if (j > 0 && !(thresholds[j - 1] <= thresholds[j])) {
        return (int)cudaErrorInvalidValue;  // unsorted, or NaN
      }
      if (slots[j] < 0 || slots[j] >= n_thresholds || (seen >> slots[j]) & 1u) {
        return (int)cudaErrorInvalidValue;  // not a permutation
      }
      seen |= 1u << slots[j];
    }
  }
  prm.n_thresholds = n_thresholds;
  const cudaStream_t s = (cudaStream_t)stream;
  unsigned* tickets = static_cast<unsigned*>(scratch);
  long long* parts = static_cast<long long*>(scratch) + (images + 1) / 2;
  cudaError_t err = cudaMemsetAsync(tickets, 0, sizeof(unsigned) * images, s);
  if (err != cudaSuccess) return (int)err;
  // an image's planes start on a vector boundary where it is the only one
  // or its size is a multiple of a chunk
  const bool vector_loads = images == 1 || n % kVoxels == 0;
  fused_eval_stats_kernel<<<dim3(grid, images), kThreads,
                            shared_bytes(n_thresholds), s>>>(
      fg, unc, tgt, pred, weight, n, vector_loads, prm, tickets, parts, out);
  return (int)cudaGetLastError();
}

// Fused per-subject eval statistics for Hopper (sm_90a), one pass over the
// five per-voxel planes of a subject.
//
// Replaces the TPU kernel rcu_tpu/ops/pallas/evalstats.py:fused_eval_stats
// (Pallas body _make_kernel). It computes the same function, not the same
// block structure:
//   - for each of 10 reliability bins: the weighted voxel count, sum of
//     confidences and sum of targets (the weight applies to bins only);
//   - the unweighted confusion counts tp/tn/fp/fn;
//   - tpu/tnu/fpu/fnu for up to 23 thresholds, uncertainty > threshold.
// Bin ids follow rcu_tpu_torch/ops/calibration.bin_ids: the host passes the
// float32 edge values and, per edge, whether the float64 edge makes the
// comparison '>' or '>='; the kernel only compares.
//
// Bound: memory. A voxel is 11 bytes (fg and uncertainty f32, target,
// prediction and weight u8), 98.2 MB for a 155x240x240 BraTS volume, about
// 29 us at the H100 SXM's 3.35 TB/s. The instructions per voxel (ten
// compares for the bin, ten select-adds for the confidence sums, and per 32
// voxels one ballot for each bin and each threshold) are of the same order
// as that memory time, so this first version may be issue-bound; PERF.md
// holds its measured time.
//
// Design:
//   - grid-stride loop over 4-voxel quads with float4 / 32-bit loads; the
//     ragged tail (n not a multiple of 4) is masked, never padded;
//   - counts come from warp ballots + popc, so a warp counts 32 voxels per
//     predicate in two instructions; each count is owned by one lane (lane k
//     holds bin k, lane j threshold j, lane 0 the confusion counts), which
//     keeps the per-thread registers small;
//   - confidence sums are per-thread float32, then float64 from the warp
//     shuffle reduction on;
//   - each block reduces its warps in shared memory in a fixed order and
//     writes one int32 row and one float64 row of partials. The caller sums
//     the rows (int64 / float64) in a fixed order. No atomics anywhere, so
//     two runs on the same input give bit-identical results.
// Counts are exact: per block they stay int32, which the host guarantees
// by sizing the grid so that no block sees 2^31 voxels.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kBins = 10;
constexpr int kMaxThresholds = 23;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// int32 partial row: bin counts, bin target sums, tp/tn/fp/fn, then
// (tpu, tnu, fpu, fnu) per threshold
constexpr int kOffCount = 0;
constexpr int kOffTrue = kBins;
constexpr int kOffConfusion = 2 * kBins;
constexpr int kOffThresh = 2 * kBins + 4;
constexpr int kIntCols = kOffThresh + 4 * kMaxThresholds;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  float edge_hi[kBins];
  float thresholds[kMaxThresholds];
  int edge_strict;  // bit k: edge k passes with p > hi instead of p >= hi
  int n_thresholds;
};

__device__ __forceinline__ int bin_id(float p, const Params& prm) {
  int id = 0;
#pragma unroll
  for (int k = 0; k < kBins; ++k) {
    const bool strict = (prm.edge_strict >> k) & 1;
    id += strict ? (p > prm.edge_hi[k]) : (p >= prm.edge_hi[k]);
  }
  return id < kBins - 1 ? id : kBins - 1;
}

__global__ void __launch_bounds__(kThreads)
fused_eval_stats_kernel(const float* __restrict__ fg,
                        const float* __restrict__ unc,
                        const uint8_t* __restrict__ tgt,
                        const uint8_t* __restrict__ pred,
                        const uint8_t* __restrict__ weight, long long n,
                        Params prm, int* __restrict__ part_int,
                        double* __restrict__ part_conf) {
  __shared__ int s_int[kWarps][kIntCols];
  __shared__ double s_conf[kWarps][kBins];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int bin_count = 0, bin_true = 0;
  int tpu = 0, tnu = 0, fpu = 0, fnu = 0;
  int tp = 0, tn = 0, fp = 0, fn = 0;
  float conf[kBins];
#pragma unroll
  for (int k = 0; k < kBins; ++k) conf[k] = 0.0f;

  const long long n_quads = (n + 3) / 4;
  const long long stride = (long long)gridDim.x * kThreads;
  // q0 is the same for the whole warp, so every lane runs every iteration
  // and the ballots below always see the full warp
  for (long long q0 = (long long)blockIdx.x * kThreads + warp * 32;
       q0 < n_quads; q0 += stride) {
    const long long q = q0 + lane;
    float f[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float u[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    uint32_t tb = 0, pb = 0, wb = 0;
    unsigned valid = 0;  // bit e: voxel 4q+e exists
    if (4 * q + 3 < n) {
      const float4 f4 = reinterpret_cast<const float4*>(fg)[q];
      const float4 u4 = reinterpret_cast<const float4*>(unc)[q];
      f[0] = f4.x; f[1] = f4.y; f[2] = f4.z; f[3] = f4.w;
      u[0] = u4.x; u[1] = u4.y; u[2] = u4.z; u[3] = u4.w;
      tb = reinterpret_cast<const uint32_t*>(tgt)[q];
      pb = reinterpret_cast<const uint32_t*>(pred)[q];
      wb = reinterpret_cast<const uint32_t*>(weight)[q];
      valid = 0xfu;
    } else if (q < n_quads) {
#pragma unroll  // constant indices keep f/u in registers
      for (int e = 0; e < 4; ++e) {
        const long long i = 4 * q + e;
        if (i < n) {
          f[e] = fg[i];
          u[e] = unc[i];
          tb |= (uint32_t)tgt[i] << (8 * e);
          pb |= (uint32_t)pred[i] << (8 * e);
          wb |= (uint32_t)weight[i] << (8 * e);
          valid |= 1u << e;
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool v = (valid >> e) & 1u;
      const bool ti = v && ((tb >> (8 * e)) & 0xffu);
      const bool pi = v && ((pb >> (8 * e)) & 0xffu);
      const bool wi = v && ((wb >> (8 * e)) & 0xffu);
      const int id = bin_id(f[e], prm);
#pragma unroll
      for (int k = 0; k < kBins; ++k) conf[k] += (wi && id == k) ? f[e] : 0.0f;

      const unsigned T = __ballot_sync(kFull, ti);
      const unsigned P = __ballot_sync(kFull, pi);
      const unsigned V = __ballot_sync(kFull, v);
      if (lane == 0) {
        tp += __popc(T & P);
        fp += __popc(~T & P);
        fn += __popc(T & ~P);
        tn += __popc(~T & ~P & V);
      }
#pragma unroll
      for (int k = 0; k < kBins; ++k) {
        const unsigned B = __ballot_sync(kFull, wi && id == k);
        if (lane == k) {
          bin_count += __popc(B);
          bin_true += __popc(B & T);
        }
      }
#pragma unroll
      for (int j = 0; j < kMaxThresholds; ++j) {
        if (j < prm.n_thresholds) {  // uniform across the grid
          const unsigned U = __ballot_sync(kFull, v && u[e] > prm.thresholds[j]);
          if (lane == j) {
            tpu += __popc(T & P & U);
            tnu += __popc(~T & ~P & U);
            fpu += __popc(~T & P & U);
            fnu += __popc(T & ~P & U);
          }
        }
      }
    }
  }

  int* row = s_int[warp];
  if (lane < kBins) {
    row[kOffCount + lane] = bin_count;
    row[kOffTrue + lane] = bin_true;
  }
  if (lane == 0) {
    row[kOffConfusion + 0] = tp;
    row[kOffConfusion + 1] = tn;
    row[kOffConfusion + 2] = fp;
    row[kOffConfusion + 3] = fn;
  }
  if (lane < kMaxThresholds) {
    row[kOffThresh + 4 * lane + 0] = tpu;
    row[kOffThresh + 4 * lane + 1] = tnu;
    row[kOffThresh + 4 * lane + 2] = fpu;
    row[kOffThresh + 4 * lane + 3] = fnu;
  }
#pragma unroll
  for (int k = 0; k < kBins; ++k) {
    double s = conf[k];
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(kFull, s, off);
    if (lane == 0) s_conf[warp][k] = s;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kIntCols; i += kThreads) {
    int acc = 0;
    for (int w = 0; w < kWarps; ++w) acc += s_int[w][i];
    part_int[(long long)blockIdx.x * kIntCols + i] = acc;
  }
  if (threadIdx.x < kBins) {
    double acc = 0.0;
    for (int w = 0; w < kWarps; ++w) acc += s_conf[w][threadIdx.x];
    part_conf[(long long)blockIdx.x * kBins + threadIdx.x] = acc;
  }
}

}  // namespace

// Layout constants for the Python wrapper to check against its own.
extern "C" int rcu_fused_eval_stats_layout(int* out) {
  out[0] = kBins;
  out[1] = kMaxThresholds;
  out[2] = kIntCols;
  out[3] = kThreads;
  return 0;
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = queued).
// fg/unc must be 16-byte aligned, tgt/pred/weight 4-byte aligned;
// part_int is (grid, kIntCols) int32, part_conf (grid, kBins) float64.
extern "C" int rcu_fused_eval_stats(const float* fg, const float* unc,
                                    const uint8_t* tgt, const uint8_t* pred,
                                    const uint8_t* weight, long long n,
                                    const float* edge_hi, int edge_strict,
                                    const float* thresholds, int n_thresholds,
                                    int* part_int, double* part_conf, int grid,
                                    void* stream) {
  if (n < 0 || n_thresholds < 0 || n_thresholds > kMaxThresholds || grid <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  Params prm;
  memset(&prm, 0, sizeof(prm));
  memcpy(prm.edge_hi, edge_hi, sizeof(prm.edge_hi));
  memcpy(prm.thresholds, thresholds, sizeof(float) * n_thresholds);
  prm.edge_strict = edge_strict;
  prm.n_thresholds = n_thresholds;
  fused_eval_stats_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      fg, unc, tgt, pred, weight, n, prm, part_int, part_conf);
  return (int)cudaGetLastError();
}

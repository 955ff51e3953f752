// Point-to-superpoint pooling for Hopper (sm_90a), G1: the mean of each
// superpoint's points' voxel rows, models/detector.py::pool_superpoints, and
// its gradient, as one segmented row sum run once each way:
//     out[s] = sum over j in [off[s], off[s + 1]) of rows[idx[j]]
// in j order, a j whose idx is outside [0, n_rows) adding nothing; with
// counts given, out[s] is divided by max(off[s + 1] - off[s], 1) and
// counts[s] = off[s + 1] - off[s]. ops/point_pool_cuda.py builds the
// segments with a stable sort of the point slots by key:
//   forward:  key = superpoint, rows = voxel features, idx = each slot's
//             voxel (the sentinel V: a zero row in the plain version, so
//             it counts and adds nothing);
//   backward: key = voxel, rows = the cotangent over the count, idx = each
//             slot's superpoint.
// Padding slots carry the sentinel keys B * S and V, sort past the last
// segment and are never read.
//
// Replaces: no TPU kernel. The JAX package pools with feats.at[pinv].get
// and segment_mean under XLA (unidet3d_tpu/models/detector.py:156-162). The
// port's plain version, the same arithmetic in PyTorch, gathers a
// (B * P, C) fp32 tensor and sums it with index_add_; its backward is aten's
// sorted index_put_ with accumulation, which gives each distinct voxel one
// warp that walks that voxel's rows one at a time. Every padding slot points
// at the one sentinel row, so at the staged training batch (8 x 196,608
// slots, ~0.69 M of them padding) one warp sums ~0.69 M rows serially, for
// a gradient row that is then thrown away: ~178 ms a training step, the
// step's largest kernel. G1 was added for that cost.
//
// What bounds it on the H100: bytes. Each direction reads the segment
// offsets, each valid slot's index and one C-float row (128 B at C = 32;
// ~0.11 GB for ~0.88 M valid points) and writes each output row once; the
// sort before it reads and writes the 1.57 M keys a few times.
//
// Design. One warp per segment, lane = channel (C > 32: 32 channels at a
// time): the warp reads 32 of the segment's indices at once, one a lane,
// broadcasts them with shuffles and starts 8 independent 128-byte row
// loads before it adds them, so a segment of m points costs m / 8 memory
// latencies. Each lane adds its channel in slot order from +0, as the
// plain version's index_add_ does on the CPU, and divides as it does, so
// the results equal the plain version's on the CPU bit for bit and repeat
// bit for bit, in PyTorch's deterministic mode or not: no atomics. (The
// +0 added past a segment's end is exact: a sum from +0 is never -0.) A
// segment's points are summed by one warp, so a superpoint of thousands of
// points is a serial tail of thousands / 8 latencies; the staged cell's
// superpoints hold 64.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;   // segments per block of 256 threads
constexpr int kUnroll = 8;  // row loads in flight per lane

template <bool kMean>
__global__ void __launch_bounds__(kWarps * 32)
segment_rows_kernel(const float* __restrict__ rows, const int32_t* __restrict__ idx,
                    const int64_t* __restrict__ off, long long n_seg, int C,
                    long long n_rows, float* __restrict__ out,
                    float* __restrict__ counts) {
  const int lane = threadIdx.x & 31;
  const long long s = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (s >= n_seg) return;  // the whole warp
  const long long beg = off[s], end = off[s + 1];
  for (int c0 = 0; c0 < C; c0 += 32) {
    const int c = c0 + lane;
    float acc = 0.f;
    for (long long j0 = beg; j0 < end; j0 += 32) {
      const int n = (int)(end - j0 < 32 ? end - j0 : 32);
      const int mine = lane < n ? idx[j0 + lane] : -1;
      for (int k = 0; k < n; k += kUnroll) {
        float x[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int v = __shfl_sync(0xffffffffu, mine, k + u);
          x[u] = (k + u < n && v >= 0 && v < n_rows && c < C) ? rows[(long long)v * C + c]
                                                                : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) acc += x[u];
      }
    }
    if (c < C) out[s * C + c] = kMean ? acc / fmaxf((float)(end - beg), 1.f) : acc;
  }
  if (kMean && lane == 0) counts[s] = (float)(end - beg);
}

}  // namespace

// rows (n_rows, C) fp32, idx (off[n_seg] and more,) int32, off (n_seg + 1,)
// int64 non-decreasing, all contiguous on one device; writes out (n_seg, C)
// fp32: the sums, or with counts (n_seg,) fp32 given (non-null) the means
// and the counts. Returns the launch's CUDA error (0 on success).
extern "C" int segment_rows(const float* rows, const int32_t* idx, const int64_t* off,
                            long long n_seg, int C, long long n_rows, float* out,
                            float* counts, void* stream) {
  if (n_seg < 0 || C <= 0 || n_rows < 0) return cudaErrorInvalidValue;
  if (n_seg == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((n_seg + kWarps - 1) / kWarps);
  if (counts != nullptr)
    segment_rows_kernel<true><<<blocks, kWarps * 32, 0, st>>>(rows, idx, off, n_seg, C,
                                                              n_rows, out, counts);
  else
    segment_rows_kernel<false><<<blocks, kWarps * 32, 0, st>>>(rows, idx, off, n_seg, C,
                                                               n_rows, out, nullptr);
  return cudaGetLastError();
}

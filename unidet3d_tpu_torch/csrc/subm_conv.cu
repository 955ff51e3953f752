// Submanifold 3x3x3 sparse convolution, forward, for Hopper (sm_90a):
//     out[i] = sum_{o < 27} feat[nbr[i, o]] @ W[o]      for i < n_valid
// a gather-GEMM over the (V, 27) neighbor table, with sentinel V (or any id
// outside [0, V)) meaning "no neighbor".
//
// Replaces: unidet3d_tpu/ops/pallas_conv.py::subm_conv_pallas (kernel body
// _make_kernel), the TPU's banded conv. The TPU needed the bands, windows and
// miss lists only because it cannot gather rows quickly; an SM gathers rows
// from L2 and HBM directly, so this kernel reads the neighbor table as the
// host built it and none of that machinery is carried over.
//
// What bounds it on the H100: bytes. Each valid output row reads its 27
// int32 neighbor ids and writes Cout fp32 values; the gathered feature rows
// come mostly from L2 (a level's features are at most ~42 MB). The arithmetic
// of the neighbor pairs that exist (about a third of the 27 taps on surface
// scans) is far below the tensor-core rate.
//
// Design, first version (right and simple; tensor cores come later): one
// block of 256 threads per 64 output rows and one tile of up to 64 output
// channels. For each offset the block loads its rows' neighbor ids and skips
// the offset when none of them exists (__syncthreads_or), then gathers the
// neighbor rows into shared memory (zeros for a missing neighbor) in chunks
// of 32 input channels, stages the matching W[o] slice, and accumulates in
// fp32 registers with FMAs, 4 rows x TN columns per thread. The Cin chunk
// loop takes any Cin (6 for the input conv, 256 in the level-3 tail) with a
// fixed ~17 KB of static shared memory, below the 48 KB that needs an opt-in.
// Rows at or past n_valid are not touched: the wrapper zeroes them.
//
// The kernel is templated on a mode for the bottleneck probe
// (ops/probe_conv.py, the port of scripts/probe_conv_bottleneck.py::
// run_variant); each mode but the conv itself strips one of the candidates
// for what sets the pace:
//   full (0)        the conv (K1, and K1' on mirrored weights)
//   gather_only (1) table read, offset skip and row gathers into shared
//                   memory; no weight staging and no FMAs. Every gathered
//                   element is summed into the output:
//                       out[i, c] = sum_o feat[nbr[i, o], c]   (Cin == Cout)
//   no_gather (2)   table read, offset skip, weight staging and FMAs on the
//                   tile's own (contiguous) rows:
//                       out[i] = sum_o [nbr[i, o] valid] feat[i] @ W[o]
//   no_table (3)    weight staging and FMAs for all 27 offsets on the tile's
//                   own rows; no table read, no skip:
//                       out[i] = sum_o feat[i] @ W[o]
// The per-offset staging and its two barriers stay in every mode, so that
// no_table cannot fold sum_o W[o] into one matrix.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kOffsets = 27;
constexpr int kRows = 64;      // output rows per block
constexpr int kChunk = 32;     // input channels staged at a time
constexpr int kThreads = 256;  // 16 row groups x 16 column groups
constexpr int kRowsPerThread = kRows / 16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

enum Mode : int { kFull = 0, kGatherOnly = 1, kNoGather = 2, kNoTable = 3 };

template <typename T, int TN, int MODE>
__global__ void __launch_bounds__(kThreads)
    subm_conv_kernel(const T* __restrict__ feat, const int* __restrict__ nbr,
                     const T* __restrict__ w, float* __restrict__ out, int V,
                     int n_valid, int cin, int cout) {
  constexpr int kCols = 16 * TN;  // output channels per block
  __shared__ int s_idx[kRows];
  __shared__ float s_a[kChunk][kRows + 1];  // +1: conflict-free stores
  __shared__ float s_b[kChunk][kCols];

  const int tid = threadIdx.x;
  const int tr = tid / 16;
  const int tc = tid % 16;
  const int row0 = blockIdx.x * kRows;
  const int col0 = blockIdx.y * kCols;

  float acc[kRowsPerThread][TN];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  if (MODE == kNoTable) {  // the tile's own rows, set once: no table, no skip
    if (tid < kRows) s_idx[tid] = row0 + tid < n_valid ? row0 + tid : -1;
    __syncthreads();
  }

  for (int o = 0; o < kOffsets; ++o) {
    if (MODE != kNoTable) {
      int has = 0;
      if (tid < kRows) {
        const int r = row0 + tid;
        int j = -1;
        if (r < n_valid) {
          j = nbr[(size_t)r * kOffsets + o];
          if (j < 0 || j >= V) j = -1;
        }
        if (MODE == kNoGather && j >= 0) j = r;  // the row itself, not the neighbor
        s_idx[tid] = j;
        has = j >= 0;
      }
      // Barrier + block-wide OR: s_idx is complete, and the whole block
      // agrees on skipping an offset that no row of the tile has.
      if (!__syncthreads_or(has)) continue;
    }

    for (int k0 = 0; k0 < cin; k0 += kChunk) {
      for (int e = tid; e < kRows * kChunk; e += kThreads) {
        const int r = e / kChunk;
        const int k = e % kChunk;
        const int j = s_idx[r];
        float v = 0.f;
        if (j >= 0 && k0 + k < cin) v = to_f32(feat[(size_t)j * cin + k0 + k]);
        s_a[k][r] = v;
      }
      if (MODE != kGatherOnly) {
        for (int e = tid; e < kChunk * kCols; e += kThreads) {
          const int k = e / kCols;
          const int c = e % kCols;
          float v = 0.f;
          if (k0 + k < cin && col0 + c < cout)
            v = to_f32(w[((size_t)o * cin + k0 + k) * cout + col0 + c]);
          s_b[k][c] = v;
        }
      }
      __syncthreads();
      const int kmax = min(kChunk, cin - k0);
      if (MODE == kGatherOnly) {
        // Output column c is input channel c: each gathered element of this
        // chunk is added by the one thread that owns its (row, column).
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            const int k = col0 + tc + 16 * j - k0;
            if (k >= 0 && k < kmax) acc[i][j] += s_a[k][tr + 16 * i];
          }
      } else {
        for (int k = 0; k < kmax; ++k) {
          float a[kRowsPerThread];
          float b[TN];
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) a[i] = s_a[k][tr + 16 * i];
#pragma unroll
          for (int j = 0; j < TN; ++j) b[j] = s_b[k][tc + 16 * j];
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
      }
      // The next chunk (or the next offset's s_idx) overwrites shared memory.
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = row0 + tr + 16 * i;
    if (r >= n_valid) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tc + 16 * j;
      if (c < cout) out[(size_t)r * cout + c] = acc[i][j];
    }
  }
}

template <typename T, int TN, int MODE>
cudaError_t launch(const void* feat, const int* nbr, const void* w, float* out,
                   int V, int n_valid, int cin, int cout, cudaStream_t stream) {
  const dim3 grid((n_valid + kRows - 1) / kRows, (cout + 16 * TN - 1) / (16 * TN));
  subm_conv_kernel<T, TN, MODE><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(feat), nbr, static_cast<const T*>(w), out, V,
      n_valid, cin, cout);
  return cudaGetLastError();
}

template <typename T, int TN>
cudaError_t launch_mode(int mode, const void* feat, const int* nbr, const void* w,
                        float* out, int V, int n_valid, int cin, int cout,
                        cudaStream_t s) {
  switch (mode) {
    case kFull:
      return launch<T, TN, kFull>(feat, nbr, w, out, V, n_valid, cin, cout, s);
    case kGatherOnly:
      return launch<T, TN, kGatherOnly>(feat, nbr, w, out, V, n_valid, cin, cout, s);
    case kNoGather:
      return launch<T, TN, kNoGather>(feat, nbr, w, out, V, n_valid, cin, cout, s);
    case kNoTable:
      return launch<T, TN, kNoTable>(feat, nbr, w, out, V, n_valid, cin, cout, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// mode: 0 the conv, 1 gather_only (needs cin == cout), 2 no_gather,
// 3 no_table (see above). feat (V, cin) and w (27, cin, cout) are both fp32
// (is_bf16 = 0) or both bf16 (is_bf16 = 1); w is not read by gather_only;
// nbr (V, 27) int32; out (V, cout) fp32. Launches on `stream` without
// synchronising and returns cudaGetLastError().
extern "C" int subm_conv_fwd(int mode, const void* feat, const int* nbr,
                             const void* w, float* out, int V, int n_valid,
                             int cin, int cout, int is_bf16, void* stream) {
  if (n_valid <= 0 || cin <= 0 || cout <= 0) return cudaErrorInvalidValue;
  if (mode == kGatherOnly && cin != cout) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool narrow = cout <= 32;
  if (is_bf16) {
    return narrow
        ? launch_mode<__nv_bfloat16, 2>(mode, feat, nbr, w, out, V, n_valid, cin, cout, s)
        : launch_mode<__nv_bfloat16, 4>(mode, feat, nbr, w, out, V, n_valid, cin, cout, s);
  }
  return narrow ? launch_mode<float, 2>(mode, feat, nbr, w, out, V, n_valid, cin, cout, s)
                : launch_mode<float, 4>(mode, feat, nbr, w, out, V, n_valid, cin, cout, s);
}

// Submanifold 3x3x3 sparse convolution, weight gradient, for Hopper (sm_90a):
//     dW[o] = sum_{i < n_valid} feat[nbr[i, o]]^T g[i]      (27, Cin, Cout)
// over the (V, 27) neighbor table, sentinel V (or any id outside [0, V))
// meaning "no neighbor". fp32 accumulation and output.
//
// Replaces: unidet3d_tpu/ops/pallas_conv.py::subm_conv_dw_pallas (kernel
// _make_dw_burst_kernel), the TPU's banded weight gradient. On the TPU the
// grid runs in order and carries dW in VMEM from one block of voxels to the
// next. Blocks on Hopper run in no order, so the reduction over voxels is
// split: each block sums one range of voxel tiles into its own fp32 partial,
// and a second small kernel adds the partials in a fixed order. No atomics:
// the result is the same from run to run.
//
// What bounds it on the H100: bytes. Each valid row's 27 neighbor ids, its
// gathered feature rows and its gradient row are read once, and dW is small;
// the arithmetic of the neighbor pairs that exist is far below the bf16
// tensor-core rate.
//
// Design, first version (right and simple; tensor cores come later): a grid
// of (27 offsets, Cin tiles x Cout tiles, row splits), 256 threads a block,
// each thread owning TM x TN entries of its block's (16 TM, 16 TN) dW tile in
// fp32 registers. For each 64-row tile of its range, the block loads the
// rows' neighbor ids for its offset and skips the tile when none exists
// (__syncthreads_or), as the forward does; else it stages the gathered
// feature rows (zeros for a missing neighbor) and the gradient rows in shared
// memory as fp32 and accumulates outer products. Rows at or past n_valid are
// never read. Shared memory is at most 33 KB, below the 48 KB opt-in.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kOffsets = 27;
constexpr int kRows = 64;      // voxel rows per staged tile
constexpr int kThreads = 256;  // 16 x 16 thread grid over the dW tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
    subm_conv_wgrad_kernel(const T* __restrict__ feat,
                           const int* __restrict__ nbr,
                           const T* __restrict__ g, float* __restrict__ part,
                           int V, int n_valid, int cin, int cout,
                           int tiles_per_split) {
  constexpr int kTileC = 16 * TM;  // input channels per block
  constexpr int kTileD = 16 * TN;  // output channels per block
  __shared__ int s_idx[kRows];
  __shared__ float s_a[kRows][kTileC];
  __shared__ float s_b[kRows][kTileD];

  const int tid = threadIdx.x;
  const int tr = tid / 16;
  const int tc = tid % 16;
  const int o = blockIdx.x;
  const int tiles_d = (cout + kTileD - 1) / kTileD;
  const int c0 = (blockIdx.y / tiles_d) * kTileC;
  const int d0 = (blockIdx.y % tiles_d) * kTileD;
  const int split = blockIdx.z;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int n_tiles = (n_valid + kRows - 1) / kRows;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  for (int t = t_begin; t < t_end; ++t) {
    const int row0 = t * kRows;
    int has = 0;
    if (tid < kRows) {
      const int r = row0 + tid;
      int j = -1;
      if (r < n_valid) {
        j = nbr[(size_t)r * kOffsets + o];
        if (j < 0 || j >= V) j = -1;
      }
      s_idx[tid] = j;
      has = j >= 0;
    }
    // Barrier + block-wide OR: s_idx is complete, and the block agrees on
    // skipping a tile where no row has a neighbor at this offset.
    if (!__syncthreads_or(has)) continue;

    for (int e = tid; e < kRows * kTileC; e += kThreads) {
      const int r = e / kTileC;
      const int c = e % kTileC;
      const int j = s_idx[r];
      float val = 0.f;
      if (j >= 0 && c0 + c < cin) val = to_f32(feat[(size_t)j * cin + c0 + c]);
      s_a[r][c] = val;
    }
    for (int e = tid; e < kRows * kTileD; e += kThreads) {
      const int r = e / kTileD;
      const int d = e % kTileD;
      const int i = row0 + r;
      float val = 0.f;
      if (s_idx[r] >= 0 && d0 + d < cout) val = to_f32(g[(size_t)i * cout + d0 + d]);
      s_b[r][d] = val;
    }
    __syncthreads();
    for (int r = 0; r < kRows; ++r) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = s_a[r][tr + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = s_b[r][tc + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // The next tile overwrites s_idx, s_a and s_b.
    __syncthreads();
  }

  float* out = part + ((size_t)split * kOffsets + o) * cin * cout;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int c = c0 + tr + 16 * i;
    if (c >= cin) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int d = d0 + tc + 16 * j;
      if (d < cout) out[(size_t)c * cout + d] = acc[i][j];
    }
  }
}

// dw[e] = sum_s part[s, e], in split order.
__global__ void sum_splits_kernel(const float* __restrict__ part,
                                  float* __restrict__ dw, size_t n,
                                  int splits) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(size_t)k * n + e];
  dw[e] = s;
}

template <typename T, int TM, int TN>
cudaError_t launch(const void* feat, const int* nbr, const void* g,
                   float* part, float* dw, int V, int n_valid, int cin,
                   int cout, int splits, cudaStream_t stream) {
  const int n_tiles = (n_valid + kRows - 1) / kRows;
  const int per_split = (n_tiles + splits - 1) / splits;
  const int tiles_c = (cin + 16 * TM - 1) / (16 * TM);
  const int tiles_d = (cout + 16 * TN - 1) / (16 * TN);
  // Offsets vary fastest: the 27 blocks of one row range run side by side
  // and share its gradient rows and neighbor rows in L2.
  const dim3 grid(kOffsets, tiles_c * tiles_d, splits);
  // One split writes dW directly; more write partials that are then summed.
  float* dst = splits == 1 ? dw : part;
  subm_conv_wgrad_kernel<T, TM, TN><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(feat), nbr, static_cast<const T*>(g), dst, V,
      n_valid, cin, cout, per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t n = (size_t)kOffsets * cin * cout;
  sum_splits_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      part, dw, n, splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* feat, const int* nbr, const void* g,
                     float* part, float* dw, int V, int n_valid, int cin,
                     int cout, int splits, cudaStream_t s) {
  if (cin >= 64 && cout >= 64)
    return launch<T, 4, 4>(feat, nbr, g, part, dw, V, n_valid, cin, cout,
                           splits, s);
  return launch<T, 2, 2>(feat, nbr, g, part, dw, V, n_valid, cin, cout,
                         splits, s);
}

}  // namespace

// The dW tile edge (16 * TM) the kernel uses for (cin, cout), so that the
// caller can size its grid and scratch: 64 when both are >= 64, else 32.
extern "C" int subm_conv_wgrad_tile(int cin, int cout) {
  return (cin >= 64 && cout >= 64) ? 64 : 32;
}

// feat (V, cin) and g (V, cout) are both fp32 (is_bf16 = 0) or both bf16
// (is_bf16 = 1); nbr (V, 27) int32; dw (27, cin, cout) fp32; part is fp32
// scratch of splits * 27 * cin * cout floats (unused when splits == 1).
// Launches on `stream` without synchronising and returns cudaGetLastError().
extern "C" int subm_conv_wgrad(const void* feat, const int* nbr, const void* g,
                               float* part, float* dw, int V, int n_valid,
                               int cin, int cout, int splits, int is_bf16,
                               void* stream) {
  if (n_valid <= 0 || cin <= 0 || cout <= 0 || splits <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(feat, nbr, g, part, dw, V, n_valid, cin,
                                   cout, splits, s);
  return dispatch<float>(feat, nbr, g, part, dw, V, n_valid, cin, cout,
                         splits, s);
}

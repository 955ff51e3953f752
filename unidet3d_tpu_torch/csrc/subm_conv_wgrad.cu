// Submanifold 3x3x3 sparse convolution, weight gradient, for Hopper (sm_90a):
//     dW[o] = sum_{i < n_valid} feat[nbr[i, o]]^T g[i]      (27, Cin, Cout)
// over the (V, 27) neighbor table, sentinel V (or any id outside [0, V))
// meaning "no neighbor". fp32 accumulation and output.
//
// Replaces: unidet3d_tpu/ops/pallas_conv.py::subm_conv_dw_pallas (kernel
// _make_dw_burst_kernel), the TPU's banded weight gradient. On the TPU the
// grid runs in order and carries dW in VMEM from one block of voxels to the
// next. Blocks on Hopper run in no order, so the reduction over voxels is
// split: each block sums one range of voxel rows into its own fp32 partial,
// and a second small kernel adds the partials in a fixed order. No atomics:
// the result is the same from run to run.
//
// What bounds it on the H100: bytes. Each valid row's 27 neighbor ids, its
// gathered feature rows and its gradient row are read once, and dW is small;
// the products of the neighbor pairs that exist are far below the bf16
// tensor-core rate. What sets the pace in practice is how often the table
// and the gradient rows are read again and how many gathers are in flight.
// On an NVIDIA H100 80GB HBM3 (700 W) the bf16 route takes 13.8 ms per
// 8-scene training step (bound 0.94 ms; the first version 86-88 ms), 0.48 ms
// at level 0, 32 -> 32 (PERF.md).
//
// Design of the bf16 route (is_bf16 = 1): per offset, dW[o] is one GEMM whose
// k dimension is the voxel rows: A = the gathered feature rows read
// transposed (Cin x rows), B = the gradient rows (rows x Cout), on
// mma.sync.m16n8k16 bf16 -> fp32. A block of 4 warps owns one group of
// `group` consecutive offsets, one Cin tile of TM = 16 MT channels and one
// Cout tile of TN = 16 NT channels (the host's choice,
// ops/subm_conv_cuda.py::wgrad_tile, under a budget of 96 fp32 accumulators
// a thread), for one range of voxel rows (a row split). Warp w takes the
// offsets of parity w / 2 and the Cout half w % 2, so each thread keeps
// ceil(group / 2) x MT x NT x 4 accumulators.
//   1. The rows are walked 32 at a time (one step: two k-steps of 16)
//      through a 3-stage cp.async ring. A step's slot holds the group's slice
//      of the table (32 rows x group ids, read coalesced with 4-byte copies,
//      offset-major in shared memory), the 32 gradient rows (staged once and
//      used by every offset of the group) and, per offset, the 32 gathered
//      feature rows. The table slice of a step is copied two steps before its
//      rows, so that the gathers of the next two steps are in flight while a
//      step is multiplied.
//   2. Offset o's rows are issued by warp o % 4, one row per lane: a warp
//      ballot skips an offset that no row of the step has (and marks the ones
//      it issues in the step's mask, which the products read). A missing
//      neighbor, and every row at or past n_valid, is the zero-fill form of
//      cp.async: nothing is read.
//   3. Both operands come from shared memory through ldmatrix.trans (rows
//      padded to an odd multiple of 16 bytes: conflict-free phases).
//   4. Each thread writes its dW entries of its split; with more than one
//      split, sum_splits_kernel adds the partials in split order.
// Cin = 6 (the input conv): a 12-byte row is not 16-byte aligned, so its
// rows come in 4-byte copies (element loads for odd widths), into a 16-wide
// tile whose pad columns are zeroed once. Shared memory is dynamic (set by
// cudaFuncSetAttribute above the 48 KB default). A bf16 x bf16 product is
// exact in fp32, so this computes the fp32 route's function up to the order
// of the fp32 sums.
//
// The fp32 route (is_bf16 = 0) is a dispatch on dtype, not a fallback: the
// first version's FMA body (a grid of (27 offsets, Cin tiles x Cout tiles,
// row splits), 256 threads a block, each thread owning TM x TN entries of its
// block's (16 TM, 16 TN) dW tile in fp32 registers, fp32 staging of 64-row
// tiles, a tile skipped when no row has a neighbor at the offset). The fp32
// steps (the card-vs-CPU training step, the fp32 card tests) need fp32
// products.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "mma_sm90.cuh"

namespace {

constexpr int kOffsets = 27;

// ------------------------------------------------------------- fp32 route

constexpr int kRows = 64;      // voxel rows per staged tile
constexpr int kThreads = 256;  // 16 x 16 thread grid over the dW tile

template <int TM, int TN>
__global__ void __launch_bounds__(kThreads)
    subm_conv_wgrad_fp32_kernel(const float* __restrict__ feat,
                                const int* __restrict__ nbr,
                                const float* __restrict__ g,
                                float* __restrict__ part, int V, int n_valid,
                                int cin, int cout, int tiles_per_split) {
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
      s_a[r][c] = j >= 0 && c0 + c < cin ? feat[(size_t)j * cin + c0 + c] : 0.f;
    }
    for (int e = tid; e < kRows * kTileD; e += kThreads) {
      const int r = e / kTileD;
      const int d = e % kTileD;
      const int i = row0 + r;
      s_b[r][d] = s_idx[r] >= 0 && d0 + d < cout ? g[(size_t)i * cout + d0 + d] : 0.f;
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

// One split writes dW directly; more write partials that are then summed.
cudaError_t sum_splits(float* part, float* dw, int cin, int cout, int splits,
                       cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t n = (size_t)kOffsets * cin * cout;
  sum_splits_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      part, dw, n, splits);
  return cudaGetLastError();
}

template <int TM, int TN>
cudaError_t launch_fp32(const void* feat, const int* nbr, const void* g,
                        float* part, float* dw, int V, int n_valid, int cin,
                        int cout, int splits, cudaStream_t stream) {
  const int n_tiles = (n_valid + kRows - 1) / kRows;
  const int per_split = (n_tiles + splits - 1) / splits;
  const int tiles_c = (cin + 16 * TM - 1) / (16 * TM);
  const int tiles_d = (cout + 16 * TN - 1) / (16 * TN);
  // Offsets vary fastest: the 27 blocks of one row range run side by side
  // and share its gradient rows and neighbor rows in L2.
  const dim3 grid(kOffsets, tiles_c * tiles_d, splits);
  subm_conv_wgrad_fp32_kernel<TM, TN><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(feat), nbr, static_cast<const float*>(g),
      splits == 1 ? dw : part, V, n_valid, cin, cout, per_split);
  return sum_splits(part, dw, cin, cout, splits, stream);
}

// -------------------------------------------------- bf16 route: tensor cores

using namespace mma_sm90;
constexpr int kWRows = 32;     // voxel rows per pipeline step (two k-steps)
constexpr int kWStages = 3;    // slots of the cp.async ring
constexpr int kWThreads = 128; // 4 warps: offset parity x Cout half

template <int TM, int TN, int GS>
struct WgradSmem {
  bf16 a[kWStages][GS][kWRows][TM + 8];  // gathered feature rows, per offset
  bf16 b[kWStages][kWRows][TN + 8];      // gradient rows
  int tab[kWStages][GS][kWRows];         // the step's table slice
  unsigned mask[kWStages + 1];           // offsets some row of a step has
};

template <int MT, int NT, int GW>
__global__ void __launch_bounds__(kWThreads)
    subm_conv_wgrad_mma_kernel(const bf16* __restrict__ feat,
                               const int* __restrict__ nbr,
                               const bf16* __restrict__ g,
                               float* __restrict__ out, int V, int n_valid,
                               int cin, int cout, int group, int groups,
                               int tiles_c, int steps_per_split, int va,
                               int vb) {
  constexpr int TM = 16 * MT, TN = 16 * NT, GS = 2 * GW;
  constexpr int kWn = TN / 2;  // Cout columns per warp: NT n-tiles of 8
  using Smem = WgradSmem<TM, TN, GS>;
  static_assert(sizeof(Smem) % 16 == 0, "zeroed in 16-byte words");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wo = warp >> 1, wn = warp & 1;

  int p = blockIdx.x;  // groups vary fastest, then Cin tiles, then Cout tiles
  const int o0 = (p % groups) * group;
  p /= groups;
  const int c0 = (p % tiles_c) * TM, d0 = (p / tiles_c) * TN;
  const int n_off = min(group, kOffsets - o0);
  const int kmax = min(TM, cin - c0), nmax = min(TN, cout - d0);
  const int n_steps = (n_valid + kWRows - 1) / kWRows;
  const int s0 = blockIdx.y * steps_per_split;
  const int count = max(0, min(n_steps, s0 + steps_per_split) - s0);

  // Zeros everywhere: the pad columns no copy writes stay zero, and every
  // step's offset mask starts empty.
  for (int e = tid; e < (int)(sizeof(Smem) / 16); e += kWThreads)
    reinterpret_cast<uint4*>(smem_raw)[e] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  // Step k's table slice into tab[k % kWStages]: (row, offset) pairs in row
  // order, so that neighboring threads read neighboring ids.
  auto load_table = [&](int k) {
    const int row0 = (s0 + k) * kWRows;
    for (int e = tid; e < kWRows * n_off; e += kWThreads) {
      const int r = e / n_off, oo = e - r * n_off;
      const bool ok = row0 + r < n_valid;
      cp_async4(&sm.tab[k % kWStages][oo][r],
                ok ? nbr + (size_t)(row0 + r) * kOffsets + o0 + oo : nbr, ok);
    }
  };

  // Step k's gradient rows and, per offset some row has, its gathered rows,
  // into slot k % kWStages; reads the step's table slice (landed).
  auto load_rows = [&](int k) {
    const int slot = k % kWStages, row0 = (s0 + k) * kWRows;
    if (vb) {  // 16-byte copies: TN / 8 per row
      for (int e = tid; e < kWRows * (TN / 8); e += kWThreads) {
        const int r = e / (TN / 8), kk = (e % (TN / 8)) * 8;
        const bool ok = row0 + r < n_valid && kk < nmax;
        cp_async16(&sm.b[slot][r][kk],
                   ok ? g + (size_t)(row0 + r) * cout + d0 + kk : g, ok);
      }
    } else {  // rows not 16-byte aligned: element by element
      for (int e = tid; e < kWRows * nmax; e += kWThreads) {
        const int r = e / nmax, kk = e - r * nmax;
        sm.b[slot][r][kk] = row0 + r < n_valid
                                ? g[(size_t)(row0 + r) * cout + d0 + kk]
                                : __float2bfloat16(0.f);
      }
    }
    for (int gi = warp; gi < n_off; gi += kWThreads / 32) {
      int j = -1;  // lane = row
      if (row0 + lane < n_valid) {
        j = sm.tab[slot][gi][lane];
        if (j < 0 || j >= V) j = -1;
      }
      if (!__any_sync(0xffffffffu, j >= 0)) continue;  // no row has offset gi
      if (lane == 0) atomicOr(&sm.mask[k % (kWStages + 1)], 1u << gi);
      bf16* dst = &sm.a[slot][gi][0][0];
      if (va == 8) {  // 16-byte copies: TM / 8 per row
        for (int e = lane; e < kWRows * (TM / 8); e += 32) {
          const int r = e / (TM / 8), kk = (e % (TM / 8)) * 8;
          const int jr = __shfl_sync(0xffffffffu, j, r);
          const bool ok = jr >= 0 && kk < kmax;
          cp_async16(dst + r * (TM + 8) + kk,
                     ok ? feat + (size_t)jr * cin + c0 + kk : feat, ok);
        }
      } else if (va == 2) {  // 4-byte copies of the live channels (Cin = 6)
        const int pairs = kmax / 2;
        for (int e = lane; e < kWRows * pairs; e += 32) {
          const int r = e / pairs, kk = (e - r * pairs) * 2;
          const int jr = __shfl_sync(0xffffffffu, j, r);
          cp_async4(dst + r * (TM + 8) + kk,
                    jr >= 0 ? feat + (size_t)jr * cin + c0 + kk : feat, jr >= 0);
        }
      } else {  // odd widths: element by element
        for (int e = lane; e < kWRows * kmax; e += 32) {
          const int r = e / kmax, kk = e - r * kmax;
          const int jr = __shfl_sync(0xffffffffu, j, r);
          dst[r * (TM + 8) + kk] =
              jr >= 0 ? feat[(size_t)jr * cin + c0 + kk] : __float2bfloat16(0.f);
        }
      }
    }
  };

  // Prologue: the table slices of steps 0 .. kWStages - 2, then the ring's
  // first groups: group k = step k's rows + step k + kWStages - 1's table.
  for (int k = 0; k < kWStages - 1; ++k)
    if (k < count) load_table(k);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int k = 0; k < kWStages - 1; ++k) {
    if (k < count) load_rows(k);
    if (k + kWStages - 1 < count) load_table(k + kWStages - 1);
    cp_async_commit();
    // Everyone has read table slot k before a later group refills it.
    __syncthreads();
  }

  float acc[GW][MT][NT][4] = {};
  for (int st = 0; st < count; ++st) {
    cp_async_wait<kWStages - 2>();  // this thread's copies of group st landed
    // Everyone's copies of group st landed (step st's rows, step st + 2's
    // table), and everyone is done with step st - 1, whose slots refill now.
    __syncthreads();
    const int nx = st + kWStages - 1;
    if (nx < count) load_rows(nx);
    if (nx + kWStages - 1 < count) load_table(nx + kWStages - 1);
    cp_async_commit();
    // Step st + kWStages's mask slot (step st - 1's, read last step) is
    // cleared for its issue at the next step.
    if (tid == 0) sm.mask[(st + kWStages) % (kWStages + 1)] = 0u;
    const unsigned mask = sm.mask[st % (kWStages + 1)];
    const int slot = st % kWStages;

#pragma unroll
    for (int ks = 0; ks < kWRows / 16; ++ks) {
      // B: this warp's NT n-tiles of the gradient rows (k = voxel rows).
      const int brow = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      uint32_t b[NT][2];
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t t[4];
        ldsm_x4_t(t, &sm.b[slot][brow][wn * kWn + np * 16 + (lane >> 4) * 8]);
        b[2 * np][0] = t[0];
        b[2 * np][1] = t[1];
        b[2 * np + 1][0] = t[2];
        b[2 * np + 1][1] = t[3];
      }
      if (NT & 1) {
        uint32_t t[2];
        ldsm_x2_t(t, &sm.b[slot][brow][wn * kWn + (NT - 1) * 8]);
        b[NT - 1][0] = t[0];
        b[NT - 1][1] = t[1];
      }
      // A: the gathered rows transposed (m = input channels, k = rows).
      const int arow = ks * 16 + (lane & 7) + (lane >> 4) * 8;
      const int acol = ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int q = 0; q < GW; ++q) {
        const int gi = wo + 2 * q;
        if (!(mask >> gi & 1u)) continue;  // also every gi >= n_off
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t a[4];
          ldsm_x4_t(a, &sm.a[slot][gi][arow][mt * 16 + acol]);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma(acc[q][mt][nt], a, b[nt][0], b[nt][1]);
        }
      }
    }
  }

  // Channels mt * 16 + lane / 4 (+ 8) of the Cin tile; columns nt * 8 +
  // 2 (lane % 4) (+ 1) of the warp's Cout half. Every entry of the block's
  // tile is written, zeros included: the split sum reads them all.
  float* dst = out + (size_t)blockIdx.y * kOffsets * cin * cout;
  const bool pair = (cout & 1) == 0;
#pragma unroll
  for (int q = 0; q < GW; ++q) {
    const int gi = wo + 2 * q;
    if (gi >= n_off) continue;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = c0 + mt * 16 + (lane >> 2) + 8 * h;
        if (c >= cin) continue;
        float* row = dst + ((size_t)(o0 + gi) * cin + c) * cout;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int d = d0 + wn * kWn + nt * 8 + 2 * (lane & 3);
          const float x0 = acc[q][mt][nt][2 * h], x1 = acc[q][mt][nt][2 * h + 1];
          if (pair && d + 1 < cout) {
            *reinterpret_cast<float2*>(row + d) = make_float2(x0, x1);
          } else {
            if (d < cout) row[d] = x0;
            if (d + 1 < cout) row[d + 1] = x1;
          }
        }
      }
  }
}

template <int MT, int NT, int GW>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(WgradSmem<16 * MT, 16 * NT, 2 * GW>));
}

template <int MT, int NT, int GW>
cudaError_t launch_mma(const void* feat, const int* nbr, const void* g,
                       float* part, float* dw, int V, int n_valid, int cin,
                       int cout, int group, int splits, cudaStream_t stream) {
  if (group < 1 || group > 2 * GW) return cudaErrorInvalidValue;
  const auto kernel = subm_conv_wgrad_mma_kernel<MT, NT, GW>;
  const int smem = smem_bytes<MT, NT, GW>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int groups = (kOffsets + group - 1) / group;
  const int tiles_c = (cin + 16 * MT - 1) / (16 * MT);
  const int tiles_d = (cout + 16 * NT - 1) / (16 * NT);
  const int n_steps = (n_valid + kWRows - 1) / kWRows;
  const int per_split = (n_steps + splits - 1) / splits;
  const uintptr_t fa = reinterpret_cast<uintptr_t>(feat);
  const int va = cin % 8 == 0 && fa % 16 == 0 ? 8
                 : cin % 2 == 0 && fa % 4 == 0 ? 2
                                                : 1;
  const int vb = cout % 8 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  const dim3 grid(groups * tiles_c * tiles_d, splits);
  kernel<<<grid, kWThreads, smem, stream>>>(
      static_cast<const bf16*>(feat), nbr, static_cast<const bf16*>(g),
      splits == 1 ? dw : part, V, n_valid, cin, cout, group, groups, tiles_c,
      per_split, va, vb);
  return sum_splits(part, dw, cin, cout, splits, stream);
}

// The bf16 route's instances (MT, NT, GW): a Cin tile of 16 MT channels, a
// Cout tile of 16 NT, groups of up to 2 GW offsets. The host's tile chooser
// (ops/subm_conv_cuda.py::WGRAD_INSTANCES) picks among exactly these. GW is
// what measured fastest per tile on the H100 (PERF.md, PR 6): larger groups
// read the gradient rows and the table fewer times but hold more registers
// and shared memory, so fewer blocks share an SM to hide the gathers.
#define K2_INSTANCES(X) \
  X(1, 2, 4)            \
  X(2, 2, 2)            \
  X(4, 2, 2)            \
  X(2, 4, 2)            \
  X(2, 5, 2)            \
  X(2, 6, 2)

}  // namespace

// feat (V, cin) and g (V, cout) are both fp32 (is_bf16 = 0) or both bf16
// (is_bf16 = 1); nbr (V, 27) int32; dw (27, cin, cout) fp32; part is fp32
// scratch of splits * 27 * cin * cout floats (unused when splits == 1).
// tm, tn: the channel tile (bf16: 16 MT and 16 NT of an instance above;
// fp32: 32 or 64, both equal); group: offsets per block (bf16 only).
// Launches on `stream` without synchronising and returns cudaGetLastError().
extern "C" int subm_conv_wgrad(const void* feat, const int* nbr, const void* g,
                               float* part, float* dw, int V, int n_valid,
                               int cin, int cout, int tm, int tn, int group,
                               int splits, int is_bf16, void* stream) {
  if (n_valid <= 0 || cin <= 0 || cout <= 0 || splits <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) {
    if (tm == 32 && tn == 32)
      return launch_fp32<2, 2>(feat, nbr, g, part, dw, V, n_valid, cin, cout, splits, s);
    if (tm == 64 && tn == 64)
      return launch_fp32<4, 4>(feat, nbr, g, part, dw, V, n_valid, cin, cout, splits, s);
    return cudaErrorInvalidValue;
  }
#define K2_LAUNCH(MT, NT, GW)                                                   \
  if (tm == 16 * MT && tn == 16 * NT)                                           \
    return launch_mma<MT, NT, GW>(feat, nbr, g, part, dw, V, n_valid, cin, cout, \
                                  group, splits, s);
  K2_INSTANCES(K2_LAUNCH)
#undef K2_LAUNCH
  return cudaErrorInvalidValue;
}

// The bf16 route's dynamic shared memory per block for the channel tile
// (tm, tn), or -1 for a tile it is not compiled for.
extern "C" int subm_conv_wgrad_smem_bytes(int tm, int tn) {
#define K2_SMEM(MT, NT, GW) \
  if (tm == 16 * MT && tn == 16 * NT) return smem_bytes<MT, NT, GW>();
  K2_INSTANCES(K2_SMEM)
#undef K2_SMEM
  return -1;
}

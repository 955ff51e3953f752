// Submanifold 3x3x3 sparse convolution, forward, for Hopper (sm_90a):
//     out[i] = sum_{o < 27} feat[nbr[i, o]] @ W[o]      for i < n_valid
// a gather-GEMM over the (V, 27) neighbor table, with sentinel V (or any id
// outside [0, V)) meaning "no neighbor". Launched on the cotangent with
// W'[o] = W[26 - o]^T it is also the conv's input gradient
// (ops/subm_conv_cuda.py::subm_conv_dgrad_cuda).
//
// Replaces: unidet3d_tpu/ops/pallas_conv.py::subm_conv_pallas (kernel body
// _make_kernel), the TPU's banded conv, and its reuse for the input gradient
// in _banded_conv_bwd. The TPU needed the bands, windows and miss lists only
// because it cannot gather rows quickly; an SM gathers rows from L2 and HBM
// directly, so this kernel reads the neighbor table as the host built it and
// none of that machinery is carried over.
//
// What bounds it on the H100: bytes. Each valid output row reads its 27
// int32 neighbor ids and writes Cout fp32 values; the gathered feature rows
// come mostly from L2 (a level's features are at most ~42 MB). The products
// of the neighbor pairs that exist (about a fifth of the 27 taps on surface
// scans) are far below the tensor-core rate, so what sets the pace is how
// many row gathers are in flight. On an NVIDIA H100 80GB HBM3 (700 W) the
// bf16 route takes 0.054-0.056 ms at level 0, 32 -> 32 of one 131k-point
// scene (bound 0.0093 ms), and the conv-bottleneck probe puts 76-92 % of
// that in the table read and the gathers (PERF.md).
//
// Design of the bf16 route (is_bf16 = 1): a gather-GEMM on mma.sync.m16n8k16
// bf16 -> fp32. A block of 4 warps owns 64 output rows (16 per warp) and
// BN output columns (the host's choice, ops/subm_conv_cuda.py::conv_tile:
// BN in {32, 64, 96, 128, 160}, Cout split into ceil(Cout / 160) column
// blocks; each warp holds its 16 x BN fp32 accumulators in registers).
//   1. The tile's 64 x 27 table is read once, coalesced, into shared memory
//      (offset-major), ahead of every gather, and the block ORs which
//      offsets any row has; offsets no row has are skipped, the rest listed.
//   2. The GEMM's k-loop is the sequence of (listed offset, 32-channel chunk)
//      steps, run through a 4-stage cp.async ring: while one step's tiles
//      are multiplied, the next three steps' neighbor rows (64 x 32 bf16) and
//      W[o] slices (32 x BN bf16) are in flight. A missing neighbor is the
//      zero-fill form of cp.async (src-size 0): nothing is read. Operands
//      stay bf16 in shared memory (rows padded to an odd multiple of 16
//      bytes, so ldmatrix phases are conflict-free); A by ldmatrix, W[o] as
//      B by ldmatrix.trans.
//   3. Rows at or past n_valid are not written: the wrapper zeroes them.
// Cin = 6 (the input conv; the input gradient never sees it): one step per
// offset with the k tail zero-filled in shared memory to 16, and, since a
// 6-channel row is not 16-byte aligned, plain element loads instead of
// cp.async (the same holds for any Cin or Cout not a multiple of 8). Shared
// memory is dynamic, 37-70 KB by BN (set by cudaFuncSetAttribute above the
// 48 KB default). Deterministic: every output element is one thread's fp32
// sum in a fixed order (offsets ascending, then channels), with no split-K
// and no atomics, so a second launch gives the same bits. A bf16 x bf16
// product is exact in fp32, so this computes the fp32 FMA route's function
// up to the order of the fp32 sums.
//
// The fp32 route (is_bf16 = 0) is a dispatch on dtype, not a fallback: the
// first version's FMA body (256 threads per 64 rows x 32 or 64 columns,
// chunks of 32 input channels staged as fp32, 4 rows x TN columns per
// thread). The fp32 steps (the card-vs-CPU training step, the fp32 card
// tests at 1e-4) need fp32 products.
//
// Both routes are templated on a mode for the bottleneck probe
// (ops/probe_conv.py, the port of scripts/probe_conv_bottleneck.py::
// run_variant); each mode but the conv itself strips one of the candidates
// for what sets the pace:
//   full (0)        the conv (K1, and K1' on mirrored weights)
//   gather_only (1) table read, offset skip and row gathers into shared
//                   memory; no weight staging and no products. Every
//                   gathered element is summed into the output:
//                       out[i, c] = sum_o feat[nbr[i, o], c]   (Cin == Cout)
//   no_gather (2)   table read, offset skip, weight staging and products on
//                   the tile's own (contiguous) rows:
//                       out[i] = sum_o [nbr[i, o] valid] feat[i] @ W[o]
//   no_table (3)    weight staging and products for all 27 offsets on the
//                   tile's own rows; no table read, no skip:
//                       out[i] = sum_o feat[i] @ W[o]
// W[o] is staged per (offset, chunk) in every mode but gather_only, so that
// no_table cannot fold sum_o W[o] into one matrix.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "mma_sm90.cuh"

namespace {

constexpr int kOffsets = 27;
constexpr int kRows = 64;  // output rows per block (both routes)

enum Mode : int { kFull = 0, kGatherOnly = 1, kNoGather = 2, kNoTable = 3 };

// ------------------------------------------------------------- fp32 route

constexpr int kChunk = 32;     // input channels staged at a time
constexpr int kThreads = 256;  // 16 row groups x 16 column groups
constexpr int kRowsPerThread = kRows / 16;

template <int TN, int MODE>
__global__ void __launch_bounds__(kThreads)
    subm_conv_fp32_kernel(const float* __restrict__ feat,
                          const int* __restrict__ nbr,
                          const float* __restrict__ w, float* __restrict__ out,
                          int V, int n_valid, int cin, int cout) {
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
        s_a[k][r] = j >= 0 && k0 + k < cin ? feat[(size_t)j * cin + k0 + k] : 0.f;
      }
      if (MODE != kGatherOnly) {
        for (int e = tid; e < kChunk * kCols; e += kThreads) {
          const int k = e / kCols;
          const int c = e % kCols;
          s_b[k][c] = k0 + k < cin && col0 + c < cout
                          ? w[((size_t)o * cin + k0 + k) * cout + col0 + c]
                          : 0.f;
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

template <int TN, int MODE>
cudaError_t launch_fp32(const void* feat, const int* nbr, const void* w,
                        float* out, int V, int n_valid, int cin, int cout,
                        cudaStream_t stream) {
  const dim3 grid((n_valid + kRows - 1) / kRows, (cout + 16 * TN - 1) / (16 * TN));
  subm_conv_fp32_kernel<TN, MODE><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(feat), nbr, static_cast<const float*>(w), out,
      V, n_valid, cin, cout);
  return cudaGetLastError();
}

// -------------------------------------------------- bf16 route: tensor cores

using namespace mma_sm90;
constexpr int kWarps = 4;
constexpr int kMmaThreads = kWarps * 32;  // 16 output rows per warp
constexpr int kBK = 32;                   // input channels per pipeline step
constexpr int kPipe = 4;                  // stages of the cp.async ring
constexpr int kAStride = kBK + 8;         // 40 bf16 = 80 bytes

template <int BN>
struct ConvSmem {
  bf16 a[kPipe][kRows][kAStride];  // gathered neighbor rows, one chunk
  bf16 b[kPipe][kBK][BN + 8];      // W[o]'s rows of that chunk, BN columns
  int nbr[kOffsets][kRows + 1];    // the tile's table, offset-major; -1: none
  int list[kOffsets];              // the offsets some row of the tile has
  unsigned wmask[kWarps];          // each warp's OR of those offsets' bits
};

template <int BN, int MODE>
__global__ void __launch_bounds__(kMmaThreads)
    subm_conv_mma_kernel(const bf16* __restrict__ feat,
                         const int* __restrict__ nbr,
                         const bf16* __restrict__ w, float* __restrict__ out,
                         int V, int n_valid, int cin, int cout, int vec_a,
                         int vec_b) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ConvSmem<BN>& sm = *reinterpret_cast<ConvSmem<BN>*>(smem_raw);
  constexpr int kNt = BN / 8;  // n-tiles of 8 columns per warp
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int row0 = blockIdx.x * kRows, col0 = blockIdx.y * BN;

  // 1. The tile's table (no_gather: the row itself where a neighbor exists;
  //    no_table: the row itself at every offset, no table read) and the
  //    offsets that some row has.
  unsigned bits = 0;
  for (int e = tid; e < kRows * kOffsets; e += kMmaThreads) {
    const int r = e / kOffsets, o = e - r * kOffsets;
    const int i = row0 + r;
    int j = -1;
    if (i < n_valid) {
      if (MODE == kNoTable) {
        j = i;
      } else {
        j = nbr[(size_t)row0 * kOffsets + e];
        if (j < 0 || j >= V) j = -1;
        else if (MODE == kNoGather) j = i;
      }
    }
    sm.nbr[o][r] = j;
    if (j >= 0) bits |= 1u << o;
  }
  bits = __reduce_or_sync(0xffffffffu, bits);
  if (lane == 0) sm.wmask[warp] = bits;
  __syncthreads();
  unsigned mask = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) mask |= sm.wmask[i];
  if (tid < kOffsets && (mask >> tid & 1u))
    sm.list[__popc(mask & ((1u << tid) - 1u))] = tid;
  __syncthreads();

  const int n_chunks = (cin + kBK - 1) / kBK;
  const int n_steps = __popc(mask) * n_chunks;

  // Issues the copies of step `step` (listed offset step / n_chunks, chunk
  // step % n_chunks) into ring slot `slot`; the caller commits.
  auto load = [&](int step, int slot) {
    const int oi = step / n_chunks, k0 = (step - oi * n_chunks) * kBK;
    const int o = sm.list[oi];
    if (vec_a) {  // 16-byte rows: 4 per row of 32 channels
      for (int e = tid; e < kRows * (kBK / 8); e += kMmaThreads) {
        const int r = e >> 2, kk = (e & 3) * 8;
        const int j = sm.nbr[o][r];
        const bool ok = j >= 0 && k0 + kk < cin;
        cp_async16(&sm.a[slot][r][kk],
                   ok ? feat + (size_t)j * cin + k0 + kk : feat, ok);
      }
    } else {  // rows not 16-byte aligned (Cin = 6): element by element
      for (int e = tid; e < kRows * kBK; e += kMmaThreads) {
        const int r = e / kBK, kk = e % kBK;
        const int j = sm.nbr[o][r];
        sm.a[slot][r][kk] = j >= 0 && k0 + kk < cin
                                ? feat[(size_t)j * cin + k0 + kk]
                                : __float2bfloat16(0.f);
      }
    }
    if (MODE == kGatherOnly) return;
    if (vec_b) {
      for (int e = tid; e < kBK * (BN / 8); e += kMmaThreads) {
        const int kk = e / (BN / 8), cc = (e % (BN / 8)) * 8;
        const bool ok = k0 + kk < cin && col0 + cc < cout;
        cp_async16(&sm.b[slot][kk][cc],
                   ok ? w + ((size_t)o * cin + k0 + kk) * cout + col0 + cc : w,
                   ok);
      }
    } else {
      for (int e = tid; e < kBK * BN; e += kMmaThreads) {
        const int kk = e / BN, cc = e % BN;
        sm.b[slot][kk][cc] = k0 + kk < cin && col0 + cc < cout
                                 ? w[((size_t)o * cin + k0 + kk) * cout + col0 + cc]
                                 : __float2bfloat16(0.f);
      }
    }
  };

  // 2. The k-loop over (offset, chunk) steps through the ring: step st + 3
  //    is issued while step st is multiplied.
  float acc[kNt][4] = {};
#pragma unroll
  for (int st = 0; st < kPipe - 1; ++st) {
    if (st < n_steps) load(st, st);
    cp_async_commit();
  }
  for (int st = 0; st < n_steps; ++st) {
    cp_async_wait<kPipe - 2>();  // this thread's copies of step st landed
    // Everyone's copies of step st landed, and everyone is done with step
    // st - 1, whose slot the next load refills.
    __syncthreads();
    const int nx = st + kPipe - 1;
    if (nx < n_steps) load(nx, nx % kPipe);
    cp_async_commit();

    const int slot = st % kPipe;
    const int k0 = (st % n_chunks) * kBK;
    const int kmax = min(kBK, cin - k0);
    if (MODE == kGatherOnly) {
      // Output column col0 + 8 nt + 2c + i % 2 is input channel k0 + kk: the
      // thread that owns it adds the gathered element.
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kk = col0 + nt * 8 + 2 * c + (i & 1) - k0;
          if (kk >= 0 && kk < kmax)
            acc[nt][i] += __bfloat162float(
                sm.a[slot][warp * 16 + g + 8 * (i >> 1)][kk]);
        }
    } else {
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks) {
        if (ks * 16 >= kmax) break;  // Cin = 6: one k-step of 16
        uint32_t a[4];
        ldsm_x4(a, &sm.a[slot][warp * 16 + (lane & 15)][ks * 16 + (lane >> 4) * 8]);
        const int brow = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int np = 0; np < BN / 16; ++np) {
          uint32_t b[4];
          ldsm_x4_t(b, &sm.b[slot][brow][np * 16 + (lane >> 4) * 8]);
          mma(acc[2 * np], a, b[0], b[1]);
          mma(acc[2 * np + 1], a, b[2], b[3]);
        }
      }
    }
  }

  // 3. Rows g, g + 8 of the warp's 16; columns 8 nt + 2c, + 1.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + warp * 16 + g + 8 * r;
    if (i >= n_valid) continue;
    float* dst = out + (size_t)i * cout;
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
      const int col = col0 + nt * 8 + 2 * c;
      if (col + 1 < cout && (cout & 1) == 0) {
        *reinterpret_cast<float2*>(dst + col) =
            make_float2(acc[nt][2 * r], acc[nt][2 * r + 1]);
      } else {
        if (col < cout) dst[col] = acc[nt][2 * r];
        if (col + 1 < cout) dst[col + 1] = acc[nt][2 * r + 1];
      }
    }
  }
}

template <int BN, int MODE>
cudaError_t launch_mma(const void* feat, const int* nbr, const void* w,
                       float* out, int V, int n_valid, int cin, int cout,
                       cudaStream_t stream) {
  const auto kernel = subm_conv_mma_kernel<BN, MODE>;
  const int smem = static_cast<int>(sizeof(ConvSmem<BN>));
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int vec_a = cin % 8 == 0 && reinterpret_cast<uintptr_t>(feat) % 16 == 0;
  const int vec_b = cout % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const dim3 grid((n_valid + kRows - 1) / kRows, (cout + BN - 1) / BN);
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(feat), nbr, static_cast<const bf16*>(w), out, V,
      n_valid, cin, cout, vec_a, vec_b);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_mode(int bn, int is_bf16, const void* feat, const int* nbr,
                        const void* w, float* out, int V, int n_valid, int cin,
                        int cout, cudaStream_t s) {
  if (!is_bf16)
    return cout <= 32 ? launch_fp32<2, MODE>(feat, nbr, w, out, V, n_valid, cin, cout, s)
                      : launch_fp32<4, MODE>(feat, nbr, w, out, V, n_valid, cin, cout, s);
  switch (bn) {
    case 32:
      return launch_mma<32, MODE>(feat, nbr, w, out, V, n_valid, cin, cout, s);
    case 64:
      return launch_mma<64, MODE>(feat, nbr, w, out, V, n_valid, cin, cout, s);
    case 96:
      return launch_mma<96, MODE>(feat, nbr, w, out, V, n_valid, cin, cout, s);
    case 128:
      return launch_mma<128, MODE>(feat, nbr, w, out, V, n_valid, cin, cout, s);
    case 160:
      return launch_mma<160, MODE>(feat, nbr, w, out, V, n_valid, cin, cout, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int BN>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(ConvSmem<BN>));
}

}  // namespace

// mode: 0 the conv, 1 gather_only (needs cin == cout), 2 no_gather,
// 3 no_table (see above). feat (V, cin) and w (27, cin, cout) are both fp32
// (is_bf16 = 0) or both bf16 (is_bf16 = 1); w is not read by gather_only;
// nbr (V, 27) int32; out (V, cout) fp32. bn: the bf16 route's output
// columns per block (32, 64, 96, 128 or 160; ignored by the fp32 route).
// Launches on `stream` without synchronising and returns cudaGetLastError().
extern "C" int subm_conv_fwd(int mode, const void* feat, const int* nbr,
                             const void* w, float* out, int V, int n_valid,
                             int cin, int cout, int bn, int is_bf16,
                             void* stream) {
  if (n_valid <= 0 || cin <= 0 || cout <= 0) return cudaErrorInvalidValue;
  if (mode == kGatherOnly && cin != cout) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kFull:
      return launch_mode<kFull>(bn, is_bf16, feat, nbr, w, out, V, n_valid, cin, cout, s);
    case kGatherOnly:
      return launch_mode<kGatherOnly>(bn, is_bf16, feat, nbr, w, out, V, n_valid, cin, cout, s);
    case kNoGather:
      return launch_mode<kNoGather>(bn, is_bf16, feat, nbr, w, out, V, n_valid, cin, cout, s);
    case kNoTable:
      return launch_mode<kNoTable>(bn, is_bf16, feat, nbr, w, out, V, n_valid, cin, cout, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The bf16 route's dynamic shared memory per block for `bn` output
// columns, or -1 for a bn it does not take.
extern "C" int subm_conv_smem_bytes(int bn) {
  switch (bn) {
    case 32: return smem_bytes<32>();
    case 64: return smem_bytes<64>();
    case 96: return smem_bytes<96>();
    case 128: return smem_bytes<128>();
    case 160: return smem_bytes<160>();
    default: return -1;
  }
}

// Flash attention forward with segment-id masking, head dim 32, for Hopper
// (sm_90a):
//     o[b, h, i] = softmax_j( q[b,h,i] . k[b,h,j] * scale
//                             masked where seg[b, i] != seg[b, j] ) @ v[b, h]
//
// Replaces: the TPU flash attention that unidet3d_tpu/models/decoder.py
// ::Attention.__call__ calls (jax.experimental.pallas.ops.tpu
// .flash_attention with SegmentIds(q=seg, kv=seg), kernel
// _flash_attention_kernel_single_batch, pallas_call :758). The decoder gives
// valid queries segment 1 and padded ones segment 2, so valid queries attend
// to valid keys only and padded queries to padded keys only. Any length L is
// taken, the ragged last tile masked, not only multiples of 128.
//
// For training the kernel also writes each row's logsumexp of the scaled
// scores, lse = m + log(l) in fp32, (B, H, L): the backward kernels
// (attention_bwd.cu) recompute p = exp(s - lse) from it. The eval path passes
// a null lse and writes nothing.
//
// What bounds it on the H100: operations. Per (query, key) pair of one
// segment it needs two products of width 32 (s and p v) and one exp; at the
// decoder's training shape (8 x 8 heads x 3072, ~5.45e8 pairs) the products
// take 0.07 ms at 989 TFLOP/s bf16 and the exps, at the SFU's 16 per clock
// per SM, 0.13 ms: the exp floor sets the bound. On an NVIDIA H100 80GB HBM3
// (700 W) at that shape the bf16 route takes 0.56-0.57 ms per call, 4.3x
// the bound, as the dq kernel (same layout, one product more) takes
// 0.50-0.52: the pace of mma.sync with 16 rows per warp at head dim 32
// (attention_bwd.cu).
//
// Design of the bf16 route (is_bf16 = 1): mma.sync.m16n8k16 bf16 -> fp32,
// the dq kernel's layout (attention_bwd.cu) and flash_tiles.cuh's tiles. A
// block of 4 warps owns 64 queries, 16 per warp, held as A fragments; the
// block walks the keys in tiles of 64 (K, V, segment ids) through the
// two-stage cp.async ring, and a warp skips a tile none of whose ids falls
// in its queries' [min, max]. Per tile each warp forms S = Q K^T (16 x 64, K
// as B by ldmatrix), masks it per element, takes the tile's row max (across
// the quad that shares a row by __shfl_xor_sync), rescales its O
// accumulators and running sums once by ex2(m_old - m_new), forms
// p = ex2(s * scale * log2e - m) with one FMA and one ex2 per pair (the
// running max m kept in log2 units; scale * log2e is folded into that FMA,
// not into q, so q keeps its bf16 values), adds the fp32 p into the row sum
// and O += bf16(p) V with S's accumulators repacked as P's A fragments and V
// as B by ldmatrix.trans. A masked lane selects p = 0; the running max
// starts at a finite sentinel, so no -inf enters the arithmetic.
//
// Rounding (bf16 inputs): as the TPU kernel, p is rounded to bf16 before
// the p v product (flash_attention.py:470-471, p.astype(v.dtype)) while the
// row sum l takes the unrounded fp32 p (:453); o = (sum_j bf16(p_j) v_j) / l
// is rounded to bf16 once. ops/attention.py::attention_plain rounds at the
// same point. p is relative to the running max, as on the TPU.
//
// The fp32 route (is_bf16 = 0) is a dispatch on dtype, not a fallback: the
// first version's FMA body, one thread per query row, q (pre-scaled), the
// output accumulator, running max and sum in registers, K and V tiles of 64
// staged in shared memory, fp32 throughout. The fp32 steps (the card-vs-CPU
// training step, the fp32 card tests at 1e-4) need fp32 products.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "flash_tiles.cuh"

namespace {

using flash_tiles::kDim;  // head dim (the decoder's 256 / 8 heads)

// ------------------------------------------------------------- fp32 route

constexpr int kQueries = 128;  // queries per block = threads per block
constexpr int kKeys = 64;      // keys per shared-memory tile

__global__ void __launch_bounds__(kQueries)
    flash_fwd_fp32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const int* __restrict__ seg, float* __restrict__ o,
                          float* __restrict__ lse, int H, int L, float scale) {
  __shared__ float s_k[kKeys][kDim];
  __shared__ float s_v[kKeys][kDim];
  __shared__ int s_seg[kKeys];
  __shared__ int s_ok[kKeys];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int qi = blockIdx.x * kQueries + threadIdx.x;
  const bool active = qi < L;
  const size_t base = (size_t)bh * L * kDim;

  float qr[kDim];
  float acc[kDim];
  const int sq = active ? seg[(size_t)b * L + qi] : 0;
#pragma unroll
  for (int d = 0; d < kDim; ++d) {
    qr[d] = active ? q[base + (size_t)qi * kDim + d] * scale : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  for (int k0 = 0; k0 < L; k0 += kKeys) {
    // The previous tile's reads are done before it is overwritten.
    __syncthreads();
    for (int e = threadIdx.x; e < kKeys * kDim; e += kQueries) {
      const int r = e / kDim;
      const int d = e % kDim;
      const int kk = k0 + r;
      s_k[r][d] = kk < L ? k[base + (size_t)kk * kDim + d] : 0.f;
      s_v[r][d] = kk < L ? v[base + (size_t)kk * kDim + d] : 0.f;
    }
    for (int e = threadIdx.x; e < kKeys; e += kQueries) {
      const int kk = k0 + e;
      s_ok[e] = kk < L;
      s_seg[e] = kk < L ? seg[(size_t)b * L + kk] : 0;
    }
    __syncthreads();

    float s[kKeys];
    float mt = m;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < kDim; ++d) dot = fmaf(qr[d], s_k[j][d], dot);
      s[j] = (s_ok[j] && s_seg[j] == sq) ? dot : -INFINITY;
      mt = fmaxf(mt, s[j]);
    }
    if (mt == -INFINITY) continue;  // no key of this row's segment yet

    const float corr = expf(m - mt);  // 0 while m is still -inf
    l *= corr;
#pragma unroll
    for (int d = 0; d < kDim; ++d) acc[d] *= corr;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const float p = s[j] == -INFINITY ? 0.f : expf(s[j] - mt);
      l += p;
#pragma unroll
      for (int d = 0; d < kDim; ++d) acc[d] = fmaf(p, s_v[j][d], acc[d]);
    }
    m = mt;
  }

  if (active) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
    for (int d = 0; d < kDim; ++d)
      o[base + (size_t)qi * kDim + d] = acc[d] * inv;
    if (lse != nullptr)
      lse[(size_t)bh * L + qi] = l > 0.f ? m + logf(l) : -INFINITY;
  }
}

// -------------------------------------------------- bf16 route: tensor cores

using namespace mma_sm90;
using flash_tiles::KvSmem;
using flash_tiles::kBlockRows;
using flash_tiles::kThreads;
using flash_tiles::kTileRows;
using flash_tiles::load_a;
using flash_tiles::stage_kv;
using flash_tiles::tile_meets;
using flash_tiles::warp_seg_range;
constexpr int kNt = kTileRows / 8;   // n-tiles of 8 keys in a tile
constexpr int kKc = kTileRows / 16;  // k-steps of 16 keys in a tile
// The running max before a row has met a key of its segment: finite, so
// ex2(kNoMax - m) is 0 (ftz) and ex2(kNoMax - kNoMax) is 1.
constexpr float kNoMax = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

__global__ void __launch_bounds__(kThreads, 4)
    flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const int* __restrict__ seg, bf16* __restrict__ o,
                         float* __restrict__ lse, int H, int L, float scale) {
  __shared__ __align__(16) KvSmem sm;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int bh = blockIdx.y;
  const size_t base = (size_t)bh * L * kDim;
  const int* seg_b = seg + (size_t)(bh / H) * L;
  const int r0 = blockIdx.x * kBlockRows + warp * 16;  // this warp's queries

  uint32_t qa[2][4];
  load_a(qa, q + base, r0, L, lane);
  const int2 range = warp_seg_range(seg_b, r0, L, lane);
  int sq[2];  // the segment ids of this thread's query rows g, g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r0 + g + 8 * r;
    sq[r] = qi < L ? seg_b[qi] : 0;
  }
  float acc[4][4] = {};                // 16 queries x 4 n-tiles of dims
  float m2[2] = {kNoMax, kNoMax};      // running row max of s * c2
  float l[2] = {0.f, 0.f};             // this thread's part of the row sums
  const float c2 = scale * kLog2e;

  const int n_tiles = (L + kTileRows - 1) / kTileRows;
  stage_kv(sm, 0, 0, k + base, v + base, seg_b, L);
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t & 1, k0 = t * kTileRows;
    if (t + 1 < n_tiles) stage_kv(sm, t + 1, s ^ 1, k + base, v + base, seg_b, L);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const int n = min(kTileRows, L - k0);
    if (tile_meets(sm.seg[s], n, range, lane)) {
      // S = Q K^T: 16 queries x 8 n-tiles of 8 keys.
      float st[kNt][4] = {};
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        const int row = nt * 8 + (lane & 7), col = (lane >> 3) * 8;
        uint32_t b[4];
        ldsm_x4(b, &sm.k[s][row][col]);
        mma(st[nt], qa[0], b[0], b[1]);
        mma(st[nt], qa[1], b[2], b[3]);
      }
      // The mask (bit 4 nt + i: query g + 8 (i / 2), key 8 nt + 2c + i % 2)
      // and the tile's row max over the unmasked scores.
      uint32_t ok = 0;
      float tmax[2] = {kNoMax, kNoMax};
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        const int col = nt * 8 + 2 * c;  // keys col, col + 1
        const int2 s2 = *reinterpret_cast<const int2*>(&sm.seg[s][col]);
        const int sk[2] = {s2.x, s2.y};
        const bool in[2] = {col < n, col + 1 < n};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = i & 1, r = i >> 1;
          if (in[e] && sk[e] == sq[r]) {
            ok |= 1u << (4 * nt + i);
            tmax[r] = fmaxf(tmax[r], st[nt][i]);
          }
        }
      }
      // One rescale per tile: the new max of each row over its quad, then
      // the accumulators and sums scaled by ex2(m_old - m_new) (1 when the
      // tile does not raise the max).
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mt = tmax[r] == kNoMax ? kNoMax : tmax[r] * c2;
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
        const float m_new = fmaxf(m2[r], mt);
        const float corr = ex2(m2[r] - m_new);
        m2[r] = m_new;
        l[r] *= corr;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          acc[nt][2 * r] *= corr;
          acc[nt][2 * r + 1] *= corr;
        }
      }
      // p = ex2(s c2 - m): fp32 into the sums, bf16 as P's A fragments.
      uint32_t pa[kKc][4];
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i >> 1;
          const float p =
              (ok >> (4 * nt + i)) & 1u ? ex2(fmaf(st[nt][i], c2, -m2[r])) : 0.f;
          st[nt][i] = p;
          l[r] += p;
        }
        acc_to_a(pa[nt >> 1], nt, st[nt]);
      }
      // O += bf16(P) V: k-steps of 16 keys, V as B (keys x dims).
#pragma unroll
      for (int kc = 0; kc < kKc; ++kc) {
        const int row = kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t b[4];
          ldsm_x4_t(b, &sm.v[s][row][np * 16 + (lane >> 4) * 8]);
          mma(acc[2 * np], pa[kc], b[0], b[1]);
          mma(acc[2 * np + 1], pa[kc], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // this stage is read before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // The row sum over the quad that shares the row.
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qi = r0 + g + 8 * r;
    if (qi >= L) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      *reinterpret_cast<uint32_t*>(o + base + (size_t)qi * kDim + nt * 8 +
                                   2 * c) =
          pack_bf16(acc[nt][2 * r] * inv, acc[nt][2 * r + 1] * inv);
    if (lse != nullptr && c == 0)
      lse[(size_t)bh * L + qi] =
          l[r] > 0.f ? (m2[r] + log2f(l[r])) * kLn2 : -INFINITY;
  }
}

}  // namespace

// q, k, v, o: (B, H, L, 32), all fp32 (is_bf16 = 0) or all bf16
// (is_bf16 = 1); seg: (B, L) int32; lse: (B, H, L) fp32 or null. Launches on
// `stream` without synchronising and returns cudaGetLastError().
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const int* seg, void* o, float* lse, int B,
                                   int H, int L, float scale, int is_bf16,
                                   void* stream) {
  if (B <= 0 || H <= 0 || L <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const dim3 grid((L + kBlockRows - 1) / kBlockRows, B * H);
    flash_fwd_mma_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), seg, static_cast<bf16*>(o), lse, H, L,
        scale);
  } else {
    const dim3 grid((L + kQueries - 1) / kQueries, B * H);
    flash_fwd_fp32_kernel<<<grid, kQueries, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), seg, static_cast<float*>(o), lse, H, L,
        scale);
  }
  return cudaGetLastError();
}

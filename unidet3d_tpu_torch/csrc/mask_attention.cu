// M1: masked flash cross-attention forward, head dim 32, for Hopper
// (sm_90a):
//     o[b, h, i] = softmax_j( q[b,h,i] . k[b,h,j] * scale
//                             masked where bit (i, j) of bits[b] is 0 ) @ v[b, h]
//
// Replaces no TPU kernel: the JAX package runs no mask attention. It is
// OneFormer3D's cross-attention (models/oneformer3d.py::MaskCrossAttention):
// the queries (every superpoint of a scene and the semantic queries) attend
// to the scene's superpoint features, and query i may attend to key j only
// where the previous prediction set's mask logit (i, j) is >= 0. Unlike K3
// (attention.cu), whose mask is "same segment id", the mask here is an
// arbitrary per-(query, key) bit recomputed from data before every layer:
// the decoder packs it as (B, Lq, W) uint32 words, W = ceil(Lk / 32), bit
// j % 32 of word j / 32 for key j, shared by the heads. Queries and keys
// have their own lengths (Lq != Lk), and per scene q_len[b] / k_len[b]
// bound the rows that hold queries and the keys worth visiting: rows at or
// past q_len[b] get o = 0, tiles at or past k_len[b] are not staged. A row
// with no open bit gets o = 0 (the decoder opens such rows whole before the
// call, so only rows without a query meet this).
//
// What bounds it on the H100: operations, as K3. Per open (query, key) pair
// and head it needs two products of width 32 (s and p v) and one exp; the
// exps, at the SFU's 16 per clock per SM, are the larger bound. At the
// OneFormer3D ScanNet cell's shape (4 scenes x 8 heads x ~3,100 queries x
// ~3,000 keys, about half the bits open) that is ~1.9e8 exps, ~45 us per
// layer; the q, k, v, o and bits bytes (~30 MB) take ~9 us.
//
// Design: K3's bf16 route (attention.cu) with the segment test replaced by
// the bit test. mma.sync.m16n8k16 bf16 -> fp32 and flash_tiles.cuh's tiles:
// a block of 4 warps owns 64 queries, 16 per warp, held as A fragments; the
// block walks the keys in tiles of 64 (K and V) through the two-stage
// cp.async ring. Each thread reads the two bit words of each of its two
// rows for the tile (the four lanes of a quad share a row; the words hit L1
// / L2), and a warp skips a tile in which none of its 16 rows has an open
// bit: where the previous layer's masks are sparse, most tiles cost one
// load and one vote. Per tile each warp forms S = Q K^T (16 x 64), masks it
// per element by its bit, takes the tile's row max across the quad,
// rescales its O accumulators and row sums once by ex2(m_old - m_new),
// forms p = ex2(s * scale * log2e - m) with one FMA and one ex2 per pair,
// adds the fp32 p into the row sum and O += bf16(p) V (S's accumulators
// repacked as P's A fragments, V as B by ldmatrix.trans). A closed lane
// selects p = 0; the running max starts at a finite sentinel, so no -inf
// enters the arithmetic.
//
// Rounding: as K3, p is rounded to bf16 before the p v product while the row
// sum takes the fp32 p; o = (sum_j bf16(p_j) v_j) / l is rounded to bf16
// once. ops/mask_attention.py::mask_attention_plain rounds at the same
// point, relative to the row max where the kernel's p is relative to the
// running max of its 64-key tiles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "flash_tiles.cuh"

namespace {

using namespace mma_sm90;
using flash_tiles::kBlockRows;
using flash_tiles::kDim;
using flash_tiles::kStages;
using flash_tiles::kStride;
using flash_tiles::kThreads;
using flash_tiles::kTileRows;
using flash_tiles::load_a;
using flash_tiles::stage_rows;
constexpr int kNt = kTileRows / 8;   // n-tiles of 8 keys in a tile
constexpr int kKc = kTileRows / 16;  // k-steps of 16 keys in a tile
constexpr int kWordsPerTile = kTileRows / 32;
constexpr float kNoMax = -1e30f;

struct KvTiles {
  bf16 k[kStages][kTileRows][kStride];
  bf16 v[kStages][kTileRows][kStride];
};

__global__ void __launch_bounds__(kThreads, 4)
    mask_attention_mma_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const uint32_t* __restrict__ bits,
                              const int* __restrict__ q_len,
                              const int* __restrict__ k_len,
                              bf16* __restrict__ o, int H, int Lq, int Lk,
                              int W, float scale) {
  __shared__ __align__(16) KvTiles sm;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int bh = blockIdx.y, b = bh / H;
  const size_t qbase = (size_t)bh * Lq * kDim;
  const size_t kbase = (size_t)bh * Lk * kDim;
  const int qn = min(q_len[b], Lq);
  const int kn = min(k_len[b], Lk);
  const int r0 = blockIdx.x * kBlockRows + warp * 16;  // this warp's queries

  if (blockIdx.x * kBlockRows >= qn || kn <= 0) {  // no query here: o = 0
    for (int e = threadIdx.x; e < kBlockRows * kDim / 2; e += kThreads) {
      const int qi = blockIdx.x * kBlockRows + e / (kDim / 2);
      if (qi < Lq)
        reinterpret_cast<uint32_t*>(o + qbase + (size_t)qi * kDim)[e % (kDim / 2)] = 0u;
    }
    return;
  }

  uint32_t qa[2][4];
  load_a(qa, q + qbase, r0, Lq, lane);
  const uint32_t* rows[2];  // the bit words of this thread's rows g, g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r0 + g + 8 * r;
    rows[r] = qi < qn ? bits + ((size_t)b * Lq + qi) * W : nullptr;
  }
  float acc[4][4] = {};            // 16 queries x 4 n-tiles of dims
  float m2[2] = {kNoMax, kNoMax};  // running row max of s * c2
  float l[2] = {0.f, 0.f};         // this thread's part of the row sums
  const float c2 = scale * kLog2e;

  const int n_tiles = (kn + kTileRows - 1) / kTileRows;
  stage_rows(sm.k[0], sm.v[0], k + kbase, v + kbase, 0, kn);
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t & 1, k0 = t * kTileRows;
    if (t + 1 < n_tiles)
      stage_rows(sm.k[s ^ 1], sm.v[s ^ 1], k + kbase, v + kbase, k0 + kTileRows, kn);
    cp_async_commit();
    // This tile's bit words of the thread's two rows (0 past W or qn).
    uint32_t bw[2][kWordsPerTile];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int w = 0; w < kWordsPerTile; ++w) {
        const int word = t * kWordsPerTile + w;
        bw[r][w] = rows[r] != nullptr && word < W ? rows[r][word] : 0u;
      }
    cp_async_wait<1>();
    __syncthreads();

    const int n = min(kTileRows, kn - k0);
    const bool any = (bw[0][0] | bw[0][1] | bw[1][0] | bw[1][1]) != 0u;
    if (__any_sync(0xffffffffu, any)) {
      // S = Q K^T: 16 queries x 8 n-tiles of 8 keys.
      float st[kNt][4] = {};
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        const int row = nt * 8 + (lane & 7), col = (lane >> 3) * 8;
        uint32_t bk[4];
        ldsm_x4(bk, &sm.k[s][row][col]);
        mma(st[nt], qa[0], bk[0], bk[1]);
        mma(st[nt], qa[1], bk[2], bk[3]);
      }
      // The mask (bit 4 nt + i: query g + 8 (i / 2), key 8 nt + 2c + i % 2)
      // and the tile's row max over the open scores.
      uint32_t ok = 0;
      float tmax[2] = {kNoMax, kNoMax};
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // Key col is bit (col % 32) of word col / 32 = nt / 4 (2c + 1 < 8).
          const int col = nt * 8 + 2 * c + (i & 1), r = i >> 1;
          const uint32_t word = bw[r][nt >> 2];
          if (col < n && ((word >> (col & 31)) & 1u)) {
            ok |= 1u << (4 * nt + i);
            tmax[r] = fmaxf(tmax[r], st[nt][i]);
          }
        }
      }
      // One rescale per tile: the new max of each row over its quad.
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
          uint32_t bv[4];
          ldsm_x4_t(bv, &sm.v[s][row][np * 16 + (lane >> 4) * 8]);
          mma(acc[2 * np], pa[kc], bv[0], bv[1]);
          mma(acc[2 * np + 1], pa[kc], bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // this stage is read before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qi = r0 + g + 8 * r;
    if (qi >= Lq) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      *reinterpret_cast<uint32_t*>(o + qbase + (size_t)qi * kDim + nt * 8 + 2 * c) =
          pack_bf16(acc[nt][2 * r] * inv, acc[nt][2 * r + 1] * inv);
  }
}

}  // namespace

// q: (B, H, Lq, 32), k, v: (B, H, Lk, 32), o: (B, H, Lq, 32), all bf16;
// bits: (B, Lq, W) uint32 with W = ceil(Lk / 32); q_len, k_len: (B,) int32
// on the device. Launches on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int mask_attention_fwd(const void* q, const void* k, const void* v,
                                  const uint32_t* bits, const int* q_len,
                                  const int* k_len, void* o, int B, int H,
                                  int Lq, int Lk, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0) return cudaErrorInvalidValue;
  const int W = (Lk + 31) / 32;
  const dim3 grid((Lq + kBlockRows - 1) / kBlockRows, B * H);
  mask_attention_mma_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), bits, q_len, k_len, static_cast<bf16*>(o), H,
      Lq, Lk, W, scale);
  return cudaGetLastError();
}

// Tiles shared by the bf16 tensor-core flash-attention kernels of
// attention.cu (forward) and attention_bwd.cu (dkv, dq), head dim 32:
// a block of 4 warps owns 64 rows of one side (16 per warp, held as mma
// A fragments in registers) and walks the other side's rows in tiles of 64
// through a two-stage cp.async ring in shared memory; a warp skips a tile
// when none of its segment ids falls in the [min, max] of its own rows'.
// Shared rows are 40 bf16 (80 bytes) apart, so the eight 16-byte rows of an
// ldmatrix phase fall in distinct banks.
#pragma once

#include <climits>
#include <cstddef>

#include "mma_sm90.cuh"

namespace flash_tiles {

using mma_sm90::bf16;

constexpr int kDim = 32;  // head dim
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockRows = kWarps * 16;  // rows owned per block
constexpr int kTileRows = 64;            // rows of the other side per stage
constexpr int kStride = 40;              // shared row stride, bf16 (80 bytes)
constexpr int kStages = 2;

// The A fragments (two k-steps of 16 over the head dim) of 16 rows from r0:
// a[kc] = {(g, 2c), (g + 8, 2c), (g, 2c + 8), (g + 8, 2c + 8)} + 16 kc, with
// g = lane / 4, c = lane % 4; rows past L are zero.
__device__ __forceinline__ void load_a(uint32_t (&a)[2][4], const bf16* rows,
                                       int r0, int L, int lane) {
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half;
    const uint32_t* p =
        reinterpret_cast<const uint32_t*>(rows + (size_t)r * kDim);
#pragma unroll
    for (int kc = 0; kc < 2; ++kc) {
      a[kc][half] = r < L ? p[kc * 8 + c] : 0u;
      a[kc][2 + half] = r < L ? p[kc * 8 + 4 + c] : 0u;
    }
  }
}

// [min, max] of the segment ids of a warp's 16 rows from r0 (inside L);
// an empty range (INT_MAX, INT_MIN) when it has none.
__device__ __forceinline__ int2 warp_seg_range(const int* seg_b, int r0,
                                               int L, int lane) {
  const int r = r0 + lane;
  const bool ok = lane < 16 && r < L;
  const int s = ok ? seg_b[r] : 0;
  return make_int2(__reduce_min_sync(0xffffffffu, ok ? s : INT_MAX),
                   __reduce_max_sync(0xffffffffu, ok ? s : INT_MIN));
}

// Whether any of the tile's n ids (shared) falls in the warp's range.
__device__ __forceinline__ bool tile_meets(const int* ids, int n, int2 range,
                                           int lane) {
  bool hit = false;
#pragma unroll
  for (int j = lane; j < kTileRows; j += 32)
    hit |= j < n && ids[j] >= range.x && ids[j] <= range.y;
  return __any_sync(0xffffffffu, hit);
}

// Stages rows [r0, r0 + 64) of two (L, 32) bf16 arrays into padded shared
// tiles, zero past L.
__device__ __forceinline__ void stage_rows(bf16 (*sa)[kStride],
                                           bf16 (*sb)[kStride], const bf16* a,
                                           const bf16* b, int r0, int L) {
  for (int e = threadIdx.x; e < kTileRows * 4; e += kThreads) {
    const int r = e >> 2, chunk = (e & 3) * 8;
    const bool ok = r0 + r < L;
    const size_t off = ok ? (size_t)(r0 + r) * kDim + chunk : 0;
    mma_sm90::cp_async16(&sa[r][chunk], a + off, ok);
    mma_sm90::cp_async16(&sb[r][chunk], b + off, ok);
  }
}

// The ring of key tiles that the forward and the dq kernel walk: K, V and
// the keys' segment ids.
struct KvSmem {
  bf16 k[kStages][kTileRows][kStride];
  bf16 v[kStages][kTileRows][kStride];
  int seg[kStages][kTileRows];
};

// Issues (does not commit) the copies of key tile t into stage s.
__device__ __forceinline__ void stage_kv(KvSmem& sm, int t, int s,
                                         const bf16* k, const bf16* v,
                                         const int* seg_b, int L) {
  const int k0 = t * kTileRows;
  stage_rows(sm.k[s], sm.v[s], k, v, k0, L);
  for (int e = threadIdx.x; e < kTileRows; e += kThreads) {
    const int kk = k0 + e;
    mma_sm90::cp_async4(&sm.seg[s][e], seg_b + (kk < L ? kk : 0), kk < L);
  }
}

}  // namespace flash_tiles

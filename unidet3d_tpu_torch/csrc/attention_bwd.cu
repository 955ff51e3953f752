// Flash attention backward with segment-id masking, head dim 32, for Hopper
// (sm_90a): FlashAttention-2's two-kernel backward from the forward's
// logsumexp.
//     p[i, j]  = exp(q_i . k_j * scale - lse_i)   (0 where seg_i != seg_j)
//     dv_j     = sum_i p[i, j] do_i
//     ds[i, j] = p[i, j] * (do_i . v_j - di_i) * scale,   di_i = o_i . do_i
//     dk_j     = sum_i ds[i, j] q_i
//     dq_i     = sum_j ds[i, j] k_j
// lse is the forward's per-row logsumexp of the scaled scores
// (attention.cu); di is computed by the caller in fp32, as the TPU version
// leaves it to XLA.
//
// Replaces: _flash_attention_bwd_dkv (:941, pallas_call :1121) and
// _flash_attention_bwd_dq (:1287, pallas_call :1456) of the TPU flash
// attention (jax/experimental/pallas/ops/tpu/flash_attention.py, JAX 0.9.0)
// that unidet3d_tpu/models/decoder.py::Attention differentiates through. The
// TPU kernels walk the grid in order and carry dk, dv and dq in scratch;
// here each kernel owns one side of the (query, key) grid per block, so
// neither needs a cross-block reduction or atomics and both are
// deterministic: the dkv kernel loops over all queries for its keys, the dq
// kernel over all keys for its queries.
//
// Rounding (bf16 inputs): as the TPU kernels, p is rounded to bf16 before
// the dv product (flash_attention.py:900) and ds * scale before the dk and
// dq products (:913-918, :1247-1261); every product accumulates in fp32
// and the outputs are rounded to bf16 once. ops/attention.py::
// attention_bwd_plain rounds at the same points.
//
// What bounds it on the H100: operations. Per (query, key) pair of one
// segment the dkv kernel needs four products of width 32 (s, dp, dv, dk)
// and the dq kernel three (s, dp, dq), at 989 TFLOP/s bf16: 0.14 and 0.105
// ms per call at the decoder's training shape (8 x 8 heads x 3072, ~5.45e8
// pairs). Each also needs one exp per pair, and the SFU's ex2 runs at 16
// per clock per SM: 5.45e8 / (132 x 16 x 1.98 GHz) = 0.13 ms per kernel, as
// much as the products. So: one ex2.approx per pair with the scale and
// log2(e) folded into one FMA, no exp for the online max (the lse is
// given), and the products on tensor cores. On an H100 (700 W) at that
// shape this version takes 0.62 (dkv) and 0.50 (dq) ms per call, 4.4x and
// 3.8x the bound: its products run at ~220 TFLOP/s, the pace of mma.sync
// with 16 rows per warp at head dim 32; neither the exp, the sub-tile
// width, the blocks per SM nor 8-warp blocks moved it far. wgmma, with 64
// rows per warpgroup, is the next step.
//
// Design of the bf16 route (is_bf16 = 1): mma.sync.m16n8k16 bf16 -> fp32.
//   dkv: one block of 4 warps owns 64 keys, 16 per warp; each warp keeps
//        its K and V rows as A fragments in registers, and dK, dV as fp32
//        accumulators. The block walks the queries in tiles of 64 (Q, dO
//        bf16; lse, di, segment ids), staged by cp.async into a two-stage
//        ring. Per tile, 16 queries at a time, each warp forms S^T = K Q^T
//        and dP^T = V dO^T (Q, dO as B operands by ldmatrix), P^T and dS^T
//        in registers, then dV += bf16(P^T) dO and dK += bf16(dS^T) Q: the
//        accumulators of two n-tiles are the A fragment of one k-step
//        (FlashAttention-2's register reuse), and dO, Q come in as B by
//        ldmatrix.trans.
//   dq:  the mirror image: a warp owns 16 queries and keeps Q, dO as A
//        fragments, the block walks the keys in tiles of 64 (K, V, segment
//        ids), each warp forms S, dP, bf16(dS) and dQ += bf16(dS) K.
//   The tiles, the ring and the tile skip are flash_tiles.cuh's, shared with
//   the forward (attention.cu); the dq kernel walks the same key ring as it.
//   Shared rows are 40 bf16 (80 bytes) apart, so the eight 16-byte rows of
//   an ldmatrix phase fall in distinct banks. The segment mask is taken per
//   element (seg_q == seg_k and inside L; the ragged last tile is
//   zero-filled); a warp skips a whole tile when none of the tile's ids
//   falls in [min, max] of its own 16 rows' ids, which is right for any ids
//   and, for the decoder's (a run of 1s, then one of 2s), spares the ~10 %
//   of tile pairs between valid and padded rows.
//
// The fp32 route (is_bf16 = 0) is a dispatch on dtype, not a fallback: the
// first version's FMA bodies, one thread per row, fp32 throughout, scale
// applied to the sums. The fp32 steps (the card-vs-CPU training step, the
// fp32 card tests at 1e-4) need fp32 products; TF32 tensor cores (10-bit
// mantissa) would break those bounds.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "flash_tiles.cuh"

namespace {

using flash_tiles::kDim;  // head dim

// ------------------------------------------------------------- fp32 route

constexpr int kRowsBlk = 128;  // rows owned per block = threads per block
constexpr int kTile = 64;      // rows of the other side staged per step

__global__ void __launch_bounds__(kRowsBlk)
    dkv_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const int* __restrict__ seg,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ di, float* __restrict__ dk,
                    float* __restrict__ dv, int H, int L, float scale) {
  __shared__ float s_q[kTile][kDim];
  __shared__ float s_do[kTile][kDim];
  __shared__ float s_lse[kTile];
  __shared__ float s_di[kTile];
  __shared__ int s_seg[kTile];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int kj = blockIdx.x * kRowsBlk + threadIdx.x;
  const bool active = kj < L;
  const size_t base = (size_t)bh * L * kDim;

  float kr[kDim], vr[kDim], dk_acc[kDim], dv_acc[kDim];
  const int sk = active ? seg[(size_t)b * L + kj] : -1;
#pragma unroll
  for (int d = 0; d < kDim; ++d) {
    kr[d] = active ? k[base + (size_t)kj * kDim + d] * scale : 0.f;
    vr[d] = active ? v[base + (size_t)kj * kDim + d] : 0.f;
    dk_acc[d] = 0.f;
    dv_acc[d] = 0.f;
  }

  for (int q0 = 0; q0 < L; q0 += kTile) {
    __syncthreads();  // the previous tile's reads are done
    for (int e = threadIdx.x; e < kTile * kDim; e += kRowsBlk) {
      const int r = e / kDim;
      const int d = e % kDim;
      const int qi = q0 + r;
      s_q[r][d] = qi < L ? q[base + (size_t)qi * kDim + d] : 0.f;
      s_do[r][d] = qi < L ? dout[base + (size_t)qi * kDim + d] : 0.f;
    }
    for (int e = threadIdx.x; e < kTile; e += kRowsBlk) {
      const int qi = q0 + e;
      const bool ok = qi < L;
      s_seg[e] = ok ? seg[(size_t)b * L + qi] : -2;  // -2 matches no key
      s_lse[e] = ok ? lse[(size_t)bh * L + qi] : 0.f;
      s_di[e] = ok ? di[(size_t)bh * L + qi] : 0.f;
    }
    __syncthreads();

    const int n = min(kTile, L - q0);
    for (int i = 0; i < n; ++i) {
      if (s_seg[i] != sk) continue;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < kDim; ++d) {
        s = fmaf(s_q[i][d], kr[d], s);
        dp = fmaf(s_do[i][d], vr[d], dp);
      }
      const float p = expf(s - s_lse[i]);
      const float ds = p * (dp - s_di[i]);
#pragma unroll
      for (int d = 0; d < kDim; ++d) {
        dv_acc[d] = fmaf(p, s_do[i][d], dv_acc[d]);
        dk_acc[d] = fmaf(ds, s_q[i][d], dk_acc[d]);
      }
    }
  }

  if (active) {
#pragma unroll
    for (int d = 0; d < kDim; ++d) {
      dk[base + (size_t)kj * kDim + d] = dk_acc[d] * scale;
      dv[base + (size_t)kj * kDim + d] = dv_acc[d];
    }
  }
}

__global__ void __launch_bounds__(kRowsBlk)
    dq_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const int* __restrict__ seg,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ di, float* __restrict__ dq, int H,
                   int L, float scale) {
  __shared__ float s_k[kTile][kDim];
  __shared__ float s_v[kTile][kDim];
  __shared__ int s_seg[kTile];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int qi = blockIdx.x * kRowsBlk + threadIdx.x;
  const bool active = qi < L;
  const size_t base = (size_t)bh * L * kDim;

  float qr[kDim], dor[kDim], dq_acc[kDim];
  const int sq = active ? seg[(size_t)b * L + qi] : -1;
  const float lse_i = active ? lse[(size_t)bh * L + qi] : 0.f;
  const float di_i = active ? di[(size_t)bh * L + qi] : 0.f;
#pragma unroll
  for (int d = 0; d < kDim; ++d) {
    qr[d] = active ? q[base + (size_t)qi * kDim + d] * scale : 0.f;
    dor[d] = active ? dout[base + (size_t)qi * kDim + d] : 0.f;
    dq_acc[d] = 0.f;
  }

  for (int k0 = 0; k0 < L; k0 += kTile) {
    __syncthreads();
    for (int e = threadIdx.x; e < kTile * kDim; e += kRowsBlk) {
      const int r = e / kDim;
      const int d = e % kDim;
      const int kk = k0 + r;
      s_k[r][d] = kk < L ? k[base + (size_t)kk * kDim + d] : 0.f;
      s_v[r][d] = kk < L ? v[base + (size_t)kk * kDim + d] : 0.f;
    }
    for (int e = threadIdx.x; e < kTile; e += kRowsBlk) {
      const int kk = k0 + e;
      s_seg[e] = kk < L ? seg[(size_t)b * L + kk] : -2;
    }
    __syncthreads();

    const int n = min(kTile, L - k0);
    for (int j = 0; j < n; ++j) {
      if (s_seg[j] != sq) continue;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < kDim; ++d) {
        s = fmaf(qr[d], s_k[j][d], s);
        dp = fmaf(dor[d], s_v[j][d], dp);
      }
      const float ds = expf(s - lse_i) * (dp - di_i);
#pragma unroll
      for (int d = 0; d < kDim; ++d) dq_acc[d] = fmaf(ds, s_k[j][d], dq_acc[d]);
    }
  }

  if (active) {
#pragma unroll
    for (int d = 0; d < kDim; ++d)
      dq[base + (size_t)qi * kDim + d] = dq_acc[d] * scale;
  }
}

// -------------------------------------------------- bf16 route: tensor cores

using namespace mma_sm90;
using flash_tiles::KvSmem;
using flash_tiles::kBlockRows;
using flash_tiles::kStages;
using flash_tiles::kStride;
using flash_tiles::kThreads;
using flash_tiles::kTileRows;
using flash_tiles::load_a;
using flash_tiles::stage_kv;
using flash_tiles::stage_rows;
using flash_tiles::tile_meets;
using flash_tiles::warp_seg_range;
constexpr int kSub = 16;       // rows of a tile a warp takes at a time
constexpr int kNt = kSub / 8;  // n-tiles of 8 in those
constexpr int kKc = kSub / 16;  // k-steps of 16 in those

struct DkvSmem {
  bf16 q[kStages][kTileRows][kStride];
  bf16 dout[kStages][kTileRows][kStride];
  float lse[kStages][kTileRows];
  float di[kStages][kTileRows];
  int seg[kStages][kTileRows];
};

__global__ void __launch_bounds__(kThreads, 4)
    dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const int* __restrict__ seg,
                   const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ di, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int H, int L, float scale) {
  __shared__ __align__(16) DkvSmem sm;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int bh = blockIdx.y;
  const size_t base = (size_t)bh * L * kDim;
  const int* seg_b = seg + (size_t)(bh / H) * L;
  const float* lse_h = lse + (size_t)bh * L;
  const float* di_h = di + (size_t)bh * L;
  const int r0 = blockIdx.x * kBlockRows + warp * 16;  // this warp's keys

  uint32_t ka[2][4], va[2][4];
  load_a(ka, k + base, r0, L, lane);
  load_a(va, v + base, r0, L, lane);
  const int2 range = warp_seg_range(seg_b, r0, L, lane);
  int sk[2];  // the segment ids of this thread's key rows g, g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kk = r0 + g + 8 * r;
    sk[r] = kk < L ? seg_b[kk] : 0;
  }
  float dk_acc[4][4] = {}, dv_acc[4][4] = {};  // 16 keys x 4 n-tiles of dims
  const float c2 = scale * kLog2e;

  auto stage = [&](int t, int s) {
    const int q0 = t * kTileRows;
    stage_rows(sm.q[s], sm.dout[s], q + base, dout + base, q0, L);
    for (int e = threadIdx.x; e < 3 * kTileRows; e += kThreads) {
      const int r = e % kTileRows, qi = q0 + r;
      const bool ok = qi < L;
      const int at = ok ? qi : 0;
      if (e < kTileRows)
        cp_async4(&sm.lse[s][r], lse_h + at, ok);
      else if (e < 2 * kTileRows)
        cp_async4(&sm.di[s][r], di_h + at, ok);
      else
        cp_async4(&sm.seg[s][r], seg_b + at, ok);
    }
  };

  const int n_tiles = (L + kTileRows - 1) / kTileRows;
  stage(0, 0);
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t & 1, q0 = t * kTileRows;
    if (t + 1 < n_tiles) stage(t + 1, s ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const int n = min(kTileRows, L - q0);
    if (tile_meets(sm.seg[s], n, range, lane)) {
#pragma unroll
      for (int h = 0; h < kTileRows / kSub; ++h) {
        const int c0 = h * kSub;
        // S^T = K Q^T and dP^T = V dO^T: 16 keys x 4 n-tiles of 8 queries.
        float st[kNt][4] = {}, dpt[kNt][4] = {};
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt) {
          const int row = c0 + nt * 8 + (lane & 7), col = (lane >> 3) * 8;
          uint32_t b[4];
          ldsm_x4(b, &sm.q[s][row][col]);
          mma(st[nt], ka[0], b[0], b[1]);
          mma(st[nt], ka[1], b[2], b[3]);
          ldsm_x4(b, &sm.dout[s][row][col]);
          mma(dpt[nt], va[0], b[0], b[1]);
          mma(dpt[nt], va[1], b[2], b[3]);
        }
        // P^T and dS^T; the accumulators of n-tiles 2j, 2j + 1 become the
        // A fragment of k-step j over the queries.
        uint32_t pa[kKc][4], dsa[kKc][4];
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt) {
          const int col = c0 + nt * 8 + 2 * c;  // queries col, col + 1
          const float2 l2 = *reinterpret_cast<const float2*>(&sm.lse[s][col]);
          const float2 d2 = *reinterpret_cast<const float2*>(&sm.di[s][col]);
          const int2 s2 = *reinterpret_cast<const int2*>(&sm.seg[s][col]);
          const float lse2[2] = {l2.x * kLog2e, l2.y * kLog2e};
          const float dis[2] = {d2.x * scale, d2.y * scale};
          const int sq[2] = {s2.x, s2.y};
          const bool in[2] = {col < n, col + 1 < n};
#pragma unroll
          for (int i = 0; i < 4; ++i) {  // (key g + 8 (i / 2), query col + i % 2)
            const int e = i & 1;
            const bool ok = in[e] && sq[e] == sk[i >> 1];
            const float p = ok ? ex2(fmaf(st[nt][i], c2, -lse2[e])) : 0.f;
            st[nt][i] = p;
            dpt[nt][i] = p * fmaf(dpt[nt][i], scale, -dis[e]);
          }
          acc_to_a(pa[nt >> 1], nt, st[nt]);
          acc_to_a(dsa[nt >> 1], nt, dpt[nt]);
        }
        // dV += bf16(P^T) dO, dK += bf16(dS^T) Q: k-steps of 16 queries,
        // dO and Q as B (queries x dims) by ldmatrix.trans.
#pragma unroll
        for (int kc = 0; kc < kKc; ++kc) {
          const int row = c0 + kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            const int col = np * 16 + (lane >> 4) * 8;
            uint32_t b[4];
            ldsm_x4_t(b, &sm.dout[s][row][col]);
            mma(dv_acc[2 * np], pa[kc], b[0], b[1]);
            mma(dv_acc[2 * np + 1], pa[kc], b[2], b[3]);
            ldsm_x4_t(b, &sm.q[s][row][col]);
            mma(dk_acc[2 * np], dsa[kc], b[0], b[1]);
            mma(dk_acc[2 * np + 1], dsa[kc], b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();  // this stage is read before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kk = r0 + g + 8 * r;
    if (kk >= L) continue;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const size_t at = base + (size_t)kk * kDim + nt * 8 + 2 * c;
      *reinterpret_cast<uint32_t*>(dk + at) =
          pack_bf16(dk_acc[nt][2 * r], dk_acc[nt][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv + at) =
          pack_bf16(dv_acc[nt][2 * r], dv_acc[nt][2 * r + 1]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 4)
    dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const int* __restrict__ seg,
                  const bf16* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ di, bf16* __restrict__ dq, int H,
                  int L, float scale) {
  __shared__ __align__(16) KvSmem sm;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int bh = blockIdx.y;
  const size_t base = (size_t)bh * L * kDim;
  const int* seg_b = seg + (size_t)(bh / H) * L;
  const int r0 = blockIdx.x * kBlockRows + warp * 16;  // this warp's queries

  uint32_t qa[2][4], doa[2][4];
  load_a(qa, q + base, r0, L, lane);
  load_a(doa, dout + base, r0, L, lane);
  const int2 range = warp_seg_range(seg_b, r0, L, lane);
  int sq[2];
  float lse2[2], dis[2];  // per query row g, g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r0 + g + 8 * r;
    const bool ok = qi < L;
    sq[r] = ok ? seg_b[qi] : 0;
    lse2[r] = ok ? lse[(size_t)bh * L + qi] * kLog2e : 0.f;
    dis[r] = ok ? di[(size_t)bh * L + qi] * scale : 0.f;
  }
  float dq_acc[4][4] = {};  // 16 queries x 4 n-tiles of dims
  const float c2 = scale * kLog2e;

  auto stage = [&](int t, int s) {
    stage_kv(sm, t, s, k + base, v + base, seg_b, L);
  };

  const int n_tiles = (L + kTileRows - 1) / kTileRows;
  stage(0, 0);
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t & 1, k0 = t * kTileRows;
    if (t + 1 < n_tiles) stage(t + 1, s ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const int n = min(kTileRows, L - k0);
    if (tile_meets(sm.seg[s], n, range, lane)) {
#pragma unroll
      for (int h = 0; h < kTileRows / kSub; ++h) {
        const int c0 = h * kSub;
        // S = Q K^T and dP = dO V^T: 16 queries x 4 n-tiles of 8 keys.
        float st[kNt][4] = {}, dp[kNt][4] = {};
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt) {
          const int row = c0 + nt * 8 + (lane & 7), col = (lane >> 3) * 8;
          uint32_t b[4];
          ldsm_x4(b, &sm.k[s][row][col]);
          mma(st[nt], qa[0], b[0], b[1]);
          mma(st[nt], qa[1], b[2], b[3]);
          ldsm_x4(b, &sm.v[s][row][col]);
          mma(dp[nt], doa[0], b[0], b[1]);
          mma(dp[nt], doa[1], b[2], b[3]);
        }
        uint32_t dsa[kKc][4];
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt) {
          const int col = c0 + nt * 8 + 2 * c;  // keys col, col + 1
          const int2 s2 = *reinterpret_cast<const int2*>(&sm.seg[s][col]);
          const int sk[2] = {s2.x, s2.y};
          const bool in[2] = {col < n, col + 1 < n};
#pragma unroll
          for (int i = 0; i < 4; ++i) {  // (query g + 8 (i / 2), key col + i % 2)
            const int e = i & 1, r = i >> 1;
            const bool ok = in[e] && sk[e] == sq[r];
            const float p = ok ? ex2(fmaf(st[nt][i], c2, -lse2[r])) : 0.f;
            dp[nt][i] = p * fmaf(dp[nt][i], scale, -dis[r]);
          }
          acc_to_a(dsa[nt >> 1], nt, dp[nt]);
        }
        // dQ += bf16(dS) K: k-steps of 16 keys, K as B (keys x dims).
#pragma unroll
        for (int kc = 0; kc < kKc; ++kc) {
          const int row = c0 + kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t b[4];
            ldsm_x4_t(b, &sm.k[s][row][np * 16 + (lane >> 4) * 8]);
            mma(dq_acc[2 * np], dsa[kc], b[0], b[1]);
            mma(dq_acc[2 * np + 1], dsa[kc], b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r0 + g + 8 * r;
    if (qi >= L) continue;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      *reinterpret_cast<uint32_t*>(dq + base + (size_t)qi * kDim + nt * 8 +
                                   2 * c) =
          pack_bf16(dq_acc[nt][2 * r], dq_acc[nt][2 * r + 1]);
  }
}

}  // namespace

// q, k, v, dout, dk, dv, dq: (B, H, L, 32), all fp32 (is_bf16 = 0) or all
// bf16 (is_bf16 = 1); seg: (B, L) int32; lse, di: (B, H, L) fp32. Each
// launches on `stream` without synchronising and returns cudaGetLastError().
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const int* seg,
                                       const void* dout, const float* lse,
                                       const float* di, void* dk, void* dv,
                                       int B, int H, int L, float scale,
                                       int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const dim3 grid((L + kBlockRows - 1) / kBlockRows, B * H);
    dkv_mma_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), seg, static_cast<const bf16*>(dout), lse,
        di, static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, L, scale);
  } else {
    const dim3 grid((L + kRowsBlk - 1) / kRowsBlk, B * H);
    dkv_fp32_kernel<<<grid, kRowsBlk, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), seg, static_cast<const float*>(dout),
        lse, di, static_cast<float*>(dk), static_cast<float*>(dv), H, L,
        scale);
  }
  return cudaGetLastError();
}

extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const int* seg,
                                      const void* dout, const float* lse,
                                      const float* di, void* dq, int B, int H,
                                      int L, float scale, int is_bf16,
                                      void* stream) {
  if (B <= 0 || H <= 0 || L <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const dim3 grid((L + kBlockRows - 1) / kBlockRows, B * H);
    dq_mma_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), seg, static_cast<const bf16*>(dout), lse,
        di, static_cast<bf16*>(dq), H, L, scale);
  } else {
    const dim3 grid((L + kRowsBlk - 1) / kRowsBlk, B * H);
    dq_fp32_kernel<<<grid, kRowsBlk, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), seg, static_cast<const float*>(dout),
        lse, di, static_cast<float*>(dq), H, L, scale);
  }
  return cudaGetLastError();
}

// Flash attention backward with segment-id masking, head dim 32, for Hopper
// (sm_90a): FlashAttention-2's two-kernel backward.
//     p[i, j]  = exp(q_i . k_j * scale - lse_i)   (0 where seg_i != seg_j)
//     dv_j     = sum_i p[i, j] do_i
//     ds[i, j] = p[i, j] * (do_i . v_j - di_i)     di_i = o_i . do_i
//     dk_j     = scale * sum_i ds[i, j] q_i
//     dq_i     = scale * sum_j ds[i, j] k_j
// lse is the forward's per-row logsumexp of the scaled scores
// (attention.cu); di is computed by the caller in fp32, as the TPU version
// leaves it to XLA.
//
// Replaces: _flash_attention_bwd_dkv and _flash_attention_bwd_dq of the TPU
// flash attention (jax/experimental/pallas/ops/tpu/flash_attention.py) that
// unidet3d_tpu/models/decoder.py::Attention differentiates through. The TPU
// kernels keep l and m apart and walk the grid in order; here each kernel
// owns one side of the (query, key) grid per block, so neither needs a
// cross-block reduction: the dkv kernel loops over all queries for its keys,
// the dq kernel over all keys for its queries.
//
// What bounds it on the H100: operations. Per (query, key) pair of one
// segment the backward needs five products of width 32 (s, dp, dv, dk, dq:
// 10 * 32 operations) against a few bytes per row, far above the card's
// bytes-to-operations line. This version does seven: both kernels recompute
// s and dp, so that neither has to reduce across blocks.
//
// Design, first version (right and simple; tensor cores come later), one
// thread per row as in the forward:
//   dkv: one block of 128 threads per (batch*head, tile of 128 keys); each
//        thread keeps its k_j, v_j and fp32 dk_j, dv_j accumulators in
//        registers. The block stages 64 queries at a time (q, do, lse, di,
//        segment id) in shared memory as fp32; every thread reads the same
//        query row at a time (a broadcast, no bank conflicts).
//   dq:  one block of 128 threads per (batch*head, tile of 128 queries); each
//        thread keeps q_i, do_i and an fp32 dq_i accumulator; the block stages
//        64 keys at a time (k, v, segment id).
// Pairs across segments are skipped per thread. Any length L is taken; the
// ragged last tile is masked. Outputs are written in the input dtype.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kDim = 32;     // head dim
constexpr int kRowsBlk = 128;  // rows owned per block = threads per block
constexpr int kTile = 64;    // rows of the other side staged per step

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kRowsBlk)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const int* __restrict__ seg,
                         const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ di, T* __restrict__ dk,
                         T* __restrict__ dv, int H, int L, float scale) {
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
    kr[d] = active ? to_f32(k[base + (size_t)kj * kDim + d]) * scale : 0.f;
    vr[d] = active ? to_f32(v[base + (size_t)kj * kDim + d]) : 0.f;
    dk_acc[d] = 0.f;
    dv_acc[d] = 0.f;
  }

  for (int q0 = 0; q0 < L; q0 += kTile) {
    __syncthreads();  // the previous tile's reads are done
    for (int e = threadIdx.x; e < kTile * kDim; e += kRowsBlk) {
      const int r = e / kDim;
      const int d = e % kDim;
      const int qi = q0 + r;
      float qv = 0.f, dov = 0.f;
      if (qi < L) {
        qv = to_f32(q[base + (size_t)qi * kDim + d]);
        dov = to_f32(dout[base + (size_t)qi * kDim + d]);
      }
      s_q[r][d] = qv;
      s_do[r][d] = dov;
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
      dk[base + (size_t)kj * kDim + d] = from_f32<T>(dk_acc[d] * scale);
      dv[base + (size_t)kj * kDim + d] = from_f32<T>(dv_acc[d]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kRowsBlk)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ seg,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ di, T* __restrict__ dq,
                        int H, int L, float scale) {
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
    qr[d] = active ? to_f32(q[base + (size_t)qi * kDim + d]) * scale : 0.f;
    dor[d] = active ? to_f32(dout[base + (size_t)qi * kDim + d]) : 0.f;
    dq_acc[d] = 0.f;
  }

  for (int k0 = 0; k0 < L; k0 += kTile) {
    __syncthreads();
    for (int e = threadIdx.x; e < kTile * kDim; e += kRowsBlk) {
      const int r = e / kDim;
      const int d = e % kDim;
      const int kk = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (kk < L) {
        kv = to_f32(k[base + (size_t)kk * kDim + d]);
        vv = to_f32(v[base + (size_t)kk * kDim + d]);
      }
      s_k[r][d] = kv;
      s_v[r][d] = vv;
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
      dq[base + (size_t)qi * kDim + d] = from_f32<T>(dq_acc[d] * scale);
  }
}

template <typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const int* seg, const void* dout, const float* lse,
                       const float* di, void* dk, void* dv, int B, int H,
                       int L, float scale, cudaStream_t stream) {
  const dim3 grid((L + kRowsBlk - 1) / kRowsBlk, B * H);
  flash_bwd_dkv_kernel<T><<<grid, kRowsBlk, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), seg, static_cast<const T*>(dout), lse, di,
      static_cast<T*>(dk), static_cast<T*>(dv), H, L, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const int* seg, const void* dout, const float* lse,
                      const float* di, void* dq, int B, int H, int L,
                      float scale, cudaStream_t stream) {
  const dim3 grid((L + kRowsBlk - 1) / kRowsBlk, B * H);
  flash_bwd_dq_kernel<T><<<grid, kRowsBlk, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), seg, static_cast<const T*>(dout), lse, di,
      static_cast<T*>(dq), H, L, scale);
  return cudaGetLastError();
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
  if (is_bf16)
    return launch_dkv<__nv_bfloat16>(q, k, v, seg, dout, lse, di, dk, dv, B,
                                     H, L, scale, s);
  return launch_dkv<float>(q, k, v, seg, dout, lse, di, dk, dv, B, H, L,
                           scale, s);
}

extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const int* seg,
                                      const void* dout, const float* lse,
                                      const float* di, void* dq, int B, int H,
                                      int L, float scale, int is_bf16,
                                      void* stream) {
  if (B <= 0 || H <= 0 || L <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_dq<__nv_bfloat16>(q, k, v, seg, dout, lse, di, dq, B, H, L,
                                    scale, s);
  return launch_dq<float>(q, k, v, seg, dout, lse, di, dq, B, H, L, scale, s);
}

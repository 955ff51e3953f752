// Flash attention forward with segment-id masking, head dim 32, for Hopper
// (sm_90a):
//     o[b, h, i] = softmax_j( q[b,h,i] . k[b,h,j] * scale
//                             masked where seg[b, i] != seg[b, j] ) @ v[b, h]
//
// Replaces: the TPU flash attention that unidet3d_tpu/models/decoder.py
// ::Attention.__call__ calls (jax.experimental.pallas.ops.tpu
// .flash_attention with SegmentIds(q=seg, kv=seg)). The decoder gives valid
// queries segment 1 and padded ones segment 2, so valid queries attend to
// valid keys only and padded queries to padded keys only. Any length L is
// taken, the ragged last tile masked, not only multiples of 512.
//
// What bounds it on the H100: operations. 4*B*H*L^2*32 FLOPs against
// 3*B*H*L*32 inputs read and B*H*L*32 outputs written: at L = 3072 that is
// about 770 FLOPs per byte, well above the card's ~295 bf16 FLOPs per byte.
//
// Design, first version (right and simple; tensor cores come later): one
// block of 128 threads per (batch*head, tile of 128 queries); each thread
// owns one query row and keeps its q (pre-scaled), its fp32 output
// accumulator, running max and running sum in registers. The block walks the
// keys in tiles of 64 staged in shared memory as fp32 with their segment
// ids; per tile each thread computes its 64 scores, takes the tile max,
// rescales its accumulator once (online softmax) and adds p @ V. The L x L
// scores never reach device memory. Shared memory is 16.25 KB.
//
// For training the kernel also writes each row's logsumexp of the scaled
// scores, lse = m + log(l) in fp32, (B, H, L): the backward kernels
// (attention_bwd.cu) recompute p = exp(s - lse) from it. The eval path passes
// a null lse and writes nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kDim = 32;       // head dim (the decoder's 256 / 8 heads)
constexpr int kQueries = 128;  // queries per block = threads per block
constexpr int kKeys = 64;      // keys per shared-memory tile

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
__global__ void __launch_bounds__(kQueries)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ seg,
                     T* __restrict__ o, float* __restrict__ lse, int H,
                     int L, float scale) {
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
    qr[d] = active ? to_f32(q[base + (size_t)qi * kDim + d]) * scale : 0.f;
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
      float kv = 0.f;
      float vv = 0.f;
      if (kk < L) {
        kv = to_f32(k[base + (size_t)kk * kDim + d]);
        vv = to_f32(v[base + (size_t)kk * kDim + d]);
      }
      s_k[r][d] = kv;
      s_v[r][d] = vv;
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
      o[base + (size_t)qi * kDim + d] = from_f32<T>(acc[d] * inv);
    if (lse != nullptr)
      lse[(size_t)bh * L + qi] = l > 0.f ? m + logf(l) : -INFINITY;
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const int* seg,
                   void* o, float* lse, int B, int H, int L, float scale,
                   cudaStream_t stream) {
  const dim3 grid((L + kQueries - 1) / kQueries, B * H);
  flash_fwd_kernel<T><<<grid, kQueries, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), seg, static_cast<T*>(o), lse, H, L, scale);
  return cudaGetLastError();
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
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, seg, o, lse, B, H, L, scale, s);
  return launch<float>(q, k, v, seg, o, lse, B, H, L, scale, s);
}

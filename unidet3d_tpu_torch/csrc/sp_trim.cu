// Superpoint box trimming for Hopper (sm_90a): the refit of each detection
// box to the points that the superpoint vote leaves inside it,
// models/postprocess.py::trim_boxes_by_superpoints computed without any
// (point, box) intermediate in device memory. Per scene b and box k:
//     inside0[p]  = valid[p] and p lies strictly inside box k (six faces)
//     frac[s]     = |{p in s : inside0[p]}| / max(|{p in s}|, 1)  (fp32)
//     inside[p]   = (inside0[p] and not frac[s(p)] < low)
//                   or (valid[p] and frac[s(p)] > up)
//     box         = ((max + min) / 2, max - min, 0) over the inside points,
//     has         = any inside point (box all zeros where none is).
// s(p) is the superpoint id clamped to [0, S); invalid points belong to no
// superpoint and are never inside.
//
// Replaces: no TPU kernel. The JAX package trims with plain jnp
// (unidet3d_tpu/models/postprocess.py::trim_boxes_by_superpoints), chunked
// over 128 boxes. The port's plain version, the same arithmetic in PyTorch,
// writes and reads back (P, 128, 3) and (P, 128, 6) fp32 tensors per chunk:
// ~3 GB each way per chunk at P = 196,608, ~190 GB a group of 4 scenes at
// K = 1000 boxes, and eval's largest device cost. This kernel was added for
// that cost.
//
// What bounds it on the H100: operations. The work reads each scene's
// points, ids and validity (17 B a point slot, ~3.3 MB a scene) and keeps a
// few ints per superpoint and per box (~0.2 MB); the (valid point, box)
// pairs it tests are up to 1.9e8 a scene (190k points x 1000 boxes), 15
// fp32 operations each for the inside test (3 subtractions, 6 additions, 6
// comparisons): ~0.22 ms a group of 4 scenes of 52k-190k valid points on
// 132 SMs x 128 lanes at ~2 GHz.
//
// Design. Six launches on the caller's stream, one workspace:
//   1. init: zero the per-superpoint counts, set the extents to +-inf;
//   2. hist: per valid point, its superpoint's count (atomicAdd) and the
//      superpoint's own extents (order-free atomic min / max on an
//      order-preserving int encoding of the floats);
//   3. scan: per scene, the exclusive prefix sum of the counts (CSR offsets);
//   4. scatter: each valid point into its superpoint's run (float4 x, y, z);
//      the order inside a run is whatever the atomics give, and nothing
//      downstream depends on it (counts, min and max are order-free);
//   5. trim: one block of 128 threads per (4 consecutive superpoints, 128
//      boxes, scene), one box a thread held in registers. The block stages
//      its superpoints' points through shared memory, 128 at a time; each
//      thread tests every point against its box, counting and taking the
//      min / max of those inside, and at each superpoint's end takes the
//      vote: frac > up merges the superpoint's whole extent (step 2),
//      frac >= low merges the inside points' extent, else nothing. A box's
//      running extent over the block's superpoints goes to its global slot
//      at the end, by the same order-free atomics;
//   6. finish: per box, the centre / size from its extent, and has.
// Only (P, 4) floats and ints of size S and K reach device memory.
//
// Exactness: the inside test is the plain code's fp32 arithmetic, each op
// rounded on its own (__fsub_rn / __fmul_rn / __fadd_rn: no FMA
// contraction, as PyTorch's separate elementwise kernels): shift = p - c
// rotated by -yaw (x c - y s, x s + y c, z), half = size / 2, and
// shift + half > 0 and half - shift > 0 on each axis. At yaw 0 (every box
// trimming sees: predict_scene zeroes yaw first) cosf(-0) = 1 and
// sinf(-0) = -0 make the rotation exact. The fraction is the integer count
// over the integer size, converted to fp32 and divided in fp32, compared
// with the thresholds cast to fp32, as PyTorch compares an fp32 tensor with
// a Python float. Min and max are exact and order-free, so the result is
// bit-equal to the plain version's and repeats from run to run.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 128;   // boxes per trim block, one a thread
constexpr int kSpPerBlock = 4;  // consecutive superpoints per trim block
constexpr int kScanThreads = 1024;
constexpr int kFlatThreads = 256;
constexpr int kPosInf = 0x7F800000;   // order_key(+inf)
constexpr int kNegInf = ~0x7F800000;  // order_key(-inf): 0xFF800000 ^ 0x7FFFFFFF

// Floats to ints of the same order (no NaN): non-negative floats keep their
// bits, negative ones flip all but the sign.
__device__ __forceinline__ int order_key(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7FFFFFFF;
}

__device__ __forceinline__ float key_float(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7FFFFFFF);
}

__device__ __forceinline__ int clamp_sp(int s, int S) {
  return s < 0 ? 0 : (s > S - 1 ? S - 1 : s);
}

struct Workspace {
  float4* sorted;  // (B, P): each scene's valid points, grouped by superpoint
  int* counts;     // (B, S) points per superpoint
  int* offsets;    // (B, S + 1) CSR offsets into the scene's run
  int* cursor;     // (B, S) scatter cursors
  int* sp_lo;      // (B, S, 3) superpoint extents, order keys
  int* sp_hi;
  int* box_lo;     // (B, K, 3) box extents, order keys
  int* box_hi;
  int* box_has;    // (B, K)
};

size_t workspace_layout(int B, int P, int K, int S, char* base, Workspace* ws) {
  const size_t b = B;
  size_t at = 0;
  auto take = [&](size_t bytes) {
    char* p = base ? base + at : nullptr;
    at += (bytes + 255) / 256 * 256;
    return p;
  };
  Workspace w;
  w.sorted = reinterpret_cast<float4*>(take(b * P * sizeof(float4)));
  w.counts = reinterpret_cast<int*>(take(b * S * sizeof(int)));
  w.offsets = reinterpret_cast<int*>(take(b * (S + 1) * sizeof(int)));
  w.cursor = reinterpret_cast<int*>(take(b * S * sizeof(int)));
  w.sp_lo = reinterpret_cast<int*>(take(b * S * 3 * sizeof(int)));
  w.sp_hi = reinterpret_cast<int*>(take(b * S * 3 * sizeof(int)));
  w.box_lo = reinterpret_cast<int*>(take(b * K * 3 * sizeof(int)));
  w.box_hi = reinterpret_cast<int*>(take(b * K * 3 * sizeof(int)));
  w.box_has = reinterpret_cast<int*>(take(b * K * sizeof(int)));
  if (ws) *ws = w;
  return at;
}

__global__ void init_kernel(Workspace w, int n_sp, int n_box) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_sp) w.counts[i] = 0;
  if (i < 3 * n_sp) {
    w.sp_lo[i] = kPosInf;
    w.sp_hi[i] = kNegInf;
  }
  if (i < n_box) w.box_has[i] = 0;
  if (i < 3 * n_box) {
    w.box_lo[i] = kPosInf;
    w.box_hi[i] = kNegInf;
  }
}

__global__ void hist_kernel(const float* __restrict__ points,
                            const uint8_t* __restrict__ valid,
                            const int* __restrict__ sp_ids, Workspace w, int P,
                            int S, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !valid[i]) return;
  const int s = (i / P) * S + clamp_sp(sp_ids[i], S);
  atomicAdd(&w.counts[s], 1);
  for (int a = 0; a < 3; ++a) {
    const int key = order_key(points[3 * (size_t)i + a]);
    atomicMin(&w.sp_lo[3 * s + a], key);
    atomicMax(&w.sp_hi[3 * s + a], key);
  }
}

// One block per scene: offsets[s] = sum of counts[< s], offsets[S] = total.
__global__ void __launch_bounds__(kScanThreads)
    scan_kernel(Workspace w, int S) {
  const int b = blockIdx.x;
  const int* counts = w.counts + (size_t)b * S;
  int* offsets = w.offsets + (size_t)b * (S + 1);
  int* cursor = w.cursor + (size_t)b * S;
  const int tid = threadIdx.x;
  const int per = (S + kScanThreads - 1) / kScanThreads;
  const int lo = min(tid * per, S), hi = min(lo + per, S);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += counts[i];
  const int lane = tid & 31, warp = tid >> 5;
  int x = sum;  // inclusive scan within the warp
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, x, d);
    if (lane >= d) x += y;
  }
  __shared__ int warp_sum[kScanThreads / 32];
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {  // inclusive scan of the 32 warps' sums
    int t = warp_sum[lane];
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, t, d);
      if (lane >= d) t += y;
    }
    warp_sum[lane] = t;
  }
  __syncthreads();
  int at = x - sum + (warp > 0 ? warp_sum[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    offsets[i] = at;
    cursor[i] = at;
    at += counts[i];
  }
  if (tid == kScanThreads - 1) offsets[S] = at;
}

__global__ void scatter_kernel(const float* __restrict__ points,
                               const uint8_t* __restrict__ valid,
                               const int* __restrict__ sp_ids, Workspace w,
                               int P, int S, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !valid[i]) return;
  const int b = i / P;
  const int pos = atomicAdd(&w.cursor[b * S + clamp_sp(sp_ids[i], S)], 1);
  const float* p = points + 3 * (size_t)i;
  w.sorted[(size_t)b * P + pos] = make_float4(p[0], p[1], p[2], 0.f);
}

struct Extent {
  float lo[3], hi[3];
  __device__ __forceinline__ void reset() {
    for (int a = 0; a < 3; ++a) {
      lo[a] = __int_as_float(0x7F800000);
      hi[a] = -__int_as_float(0x7F800000);
    }
  }
  __device__ __forceinline__ void take(float x, float y, float z) {
    lo[0] = fminf(lo[0], x), lo[1] = fminf(lo[1], y), lo[2] = fminf(lo[2], z);
    hi[0] = fmaxf(hi[0], x), hi[1] = fmaxf(hi[1], y), hi[2] = fmaxf(hi[2], z);
  }
  __device__ __forceinline__ void merge(const Extent& o) {
    for (int a = 0; a < 3; ++a) {
      lo[a] = fminf(lo[a], o.lo[a]);
      hi[a] = fmaxf(hi[a], o.hi[a]);
    }
  }
};

// Grid (ceil(S / kSpPerBlock), ceil(K / kThreads), B).
__global__ void __launch_bounds__(kThreads)
    trim_kernel(const float* __restrict__ boxes, Workspace w, int P, int K,
                int S, float low, float up) {
  __shared__ float4 s_pts[kThreads];
  __shared__ int s_off[kSpPerBlock + 1];
  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int s0 = blockIdx.x * kSpPerBlock;
  const int n_sp = min(kSpPerBlock, S - s0);
  if (tid <= n_sp) s_off[tid] = w.offsets[(size_t)b * (S + 1) + s0 + tid];
  __syncthreads();
  const int begin = s_off[0], end = s_off[n_sp];
  if (begin == end) return;  // the block's superpoints are empty

  const int k = blockIdx.y * kThreads + tid;
  const bool active = k < K;
  float c[3] = {0.f, 0.f, 0.f}, half[3] = {0.f, 0.f, 0.f}, yaw = 0.f;
  if (active) {
    const float* box = boxes + ((size_t)b * K + k) * 7;
    for (int a = 0; a < 3; ++a) {
      c[a] = box[a];
      half[a] = __fmul_rn(box[3 + a], 0.5f);  // size / 2, exact
    }
    yaw = box[6];
  }
  const float cs = cosf(-yaw), sn = sinf(-yaw);

  const float4* pts = w.sorted + (size_t)b * P;
  const int* sp_lo = w.sp_lo + ((size_t)b * S + s0) * 3;
  const int* sp_hi = w.sp_hi + ((size_t)b * S + s0) * 3;
  Extent in, acc;  // this superpoint's inside points; the box's merged extent
  in.reset();
  acc.reset();
  int cnt = 0, cur = 0, run_end = s_off[1];
  bool any = false;
  // The vote of superpoint s0 + cur, whose run ends at run_end; then the
  // next superpoint's run.
  auto vote = [&]() {
    const int n = run_end - s_off[cur];
    if (n > 0) {
      const float frac = __fdiv_rn(static_cast<float>(cnt), static_cast<float>(n));
      if (frac > up) {
        Extent whole;
        for (int a = 0; a < 3; ++a) {
          whole.lo[a] = key_float(sp_lo[3 * cur + a]);
          whole.hi[a] = key_float(sp_hi[3 * cur + a]);
        }
        acc.merge(whole);
        any = true;
      } else if (!(frac < low) && cnt > 0) {
        acc.merge(in);
        any = true;
      }
    }
    cnt = 0;
    in.reset();
    ++cur;
    run_end = cur < n_sp ? s_off[cur + 1] : end;
  };

  for (int base = begin; base < end; base += kThreads) {
    const int m = min(kThreads, end - base);
    if (tid < m) s_pts[tid] = pts[base + tid];
    __syncthreads();
    // Runs of one superpoint inside the chunk; their ends are the same for
    // every thread of the block.
    for (int j = 0; j < m;) {
      if (base + j == run_end) {
        vote();
        continue;
      }
      const int stop = min(m, run_end - base);
      for (; j < stop; ++j) {
        const float4 p = s_pts[j];
        const float dx = __fsub_rn(p.x, c[0]), dy = __fsub_rn(p.y, c[1]);
        const float dz = __fsub_rn(p.z, c[2]);
        const float sx = __fsub_rn(__fmul_rn(dx, cs), __fmul_rn(dy, sn));
        const float sy = __fadd_rn(__fmul_rn(dx, sn), __fmul_rn(dy, cs));
        const bool inside =
            __fadd_rn(sx, half[0]) > 0.f && __fsub_rn(half[0], sx) > 0.f &&
            __fadd_rn(sy, half[1]) > 0.f && __fsub_rn(half[1], sy) > 0.f &&
            __fadd_rn(dz, half[2]) > 0.f && __fsub_rn(half[2], dz) > 0.f;
        if (inside) {
          ++cnt;
          in.take(p.x, p.y, p.z);
        }
      }
    }
    __syncthreads();
  }
  while (cur < n_sp) vote();  // the last superpoint, and empty ones after it

  if (active && any) {
    const size_t at = ((size_t)b * K + k) * 3;
    for (int a = 0; a < 3; ++a) {
      atomicMin(&w.box_lo[at + a], order_key(acc.lo[a]));
      atomicMax(&w.box_hi[at + a], order_key(acc.hi[a]));
    }
    w.box_has[(size_t)b * K + k] = 1;
  }
}

__global__ void finish_kernel(Workspace w, float* __restrict__ out_boxes,
                              uint8_t* __restrict__ out_has, int n_box) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_box) return;
  const bool has = w.box_has[i] != 0;
  float* box = out_boxes + (size_t)i * 7;
  for (int a = 0; a < 3; ++a) {
    const float lo = key_float(w.box_lo[3 * (size_t)i + a]);
    const float hi = key_float(w.box_hi[3 * (size_t)i + a]);
    box[a] = has ? __fdiv_rn(__fadd_rn(hi, lo), 2.f) : 0.f;
    box[3 + a] = has ? __fsub_rn(hi, lo) : 0.f;
  }
  box[6] = 0.f;
  out_has[i] = has;
}

int blocks(long long n, int threads) {
  return static_cast<int>((n + threads - 1) / threads);
}

}  // namespace

// Bytes of workspace sp_trim needs for B scenes of P point slots, K boxes
// and S superpoints.
extern "C" long long sp_trim_workspace_bytes(int B, int P, int K, int S) {
  return static_cast<long long>(workspace_layout(B, P, K, S, nullptr, nullptr));
}

// points (B, P, 3) fp32, valid (B, P) bool, sp_ids (B, P) int32, boxes
// (B, K, 7) fp32, all contiguous; writes out_boxes (B, K, 7) fp32 and
// out_has (B, K) bool. `workspace` holds sp_trim_workspace_bytes bytes,
// 256-byte aligned. Returns the launches' CUDA error (0 on success).
extern "C" int sp_trim(const float* points, const uint8_t* valid,
                       const int* sp_ids, const float* boxes, int B, int P,
                       int K, int S, float low, float up, float* out_boxes,
                       uint8_t* out_has, void* workspace, void* stream) {
  if (B <= 0 || P < 0 || K < 0 || S <= 0) return cudaErrorInvalidValue;
  if (K == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Workspace w;
  workspace_layout(B, P, K, S, static_cast<char*>(workspace), &w);
  const long long n_sp = (long long)B * S, n_box = (long long)B * K;
  const long long n_pts = (long long)B * P;
  const long long n_init = 3 * (n_sp > n_box ? n_sp : n_box);
  init_kernel<<<blocks(n_init, kFlatThreads), kFlatThreads, 0, st>>>(
      w, static_cast<int>(n_sp), static_cast<int>(n_box));
  if (n_pts > 0) {
    hist_kernel<<<blocks(n_pts, kFlatThreads), kFlatThreads, 0, st>>>(
        points, valid, sp_ids, w, P, S, static_cast<int>(n_pts));
    scan_kernel<<<B, kScanThreads, 0, st>>>(w, S);
    scatter_kernel<<<blocks(n_pts, kFlatThreads), kFlatThreads, 0, st>>>(
        points, valid, sp_ids, w, P, S, static_cast<int>(n_pts));
    const dim3 grid(blocks(S, kSpPerBlock), blocks(K, kThreads), B);
    trim_kernel<<<grid, kThreads, 0, st>>>(boxes, w, P, K, S, low, up);
  }
  finish_kernel<<<blocks(n_box, kFlatThreads), kFlatThreads, 0, st>>>(
      w, out_boxes, out_has, static_cast<int>(n_box));
  return cudaGetLastError();
}

// Gradient-selection kernels for Hopper (sm_90a): per-row top-k by
// magnitude with lowest-index ties, optionally fused with the
// error-feedback accumulate, the payload pack and the residual.
//
// Three kernels, built into one shared library with a plain C interface
// (loaded with ctypes by repro_torch/kernels/build.py):
//
//   block_topk          replaces src/repro/kernels/block_topk.py
//                       block_topk_pallas (body _block_topk_kernel)
//   ef_select_pack      replaces src/repro/kernels/ef_sparsify.py
//                       ef_select_pack_pallas (body _ef_pack_kernel,
//                       _topk_emit)
//   ef_block_candidates replaces src/repro/kernels/ef_sparsify.py
//                       ef_block_candidates_pallas (body _ef_cand_kernel)
//
// Design.  One thread block per row.  The row's f32 values (|x| for
// block_topk; acc = e + lr*g and |acc| for the EF kernels) sit in dynamic
// shared memory, so acc never reaches device memory.  Each of the k
// passes is a block-wide (magnitude, index) arg-max with lowest-index
// ties; the winner's slot is then masked (-1, or -2 when it was taken
// past the threshold gate).  Thread t owns the slots j == t (mod
// blockDim): the per-thread scans, the masking and the residual write
// touch only owned slots, so the passes need no barrier beyond the two
// inside the reduction.
//
// Bound on the H100.  Bytes: ef_select_pack reads g and e and writes the
// residual, 12 B per element at f32 g (8 B at bf16 g); ef_block_candidates
// reads g and e, 8 B per element; block_topk reads x, 4 B per element at
// f32.  The k passes cost k*bs shared-memory reads and compares per row
// (k/12 to k/4 compares per byte moved), far below the card's f32 rate
// for the k <= 8 of the training path, so the bound is device-memory
// bandwidth.  The design reads every input once with coalesced loads and
// writes every output once; the k-pass loop is correct for any k in
// [1, bs] but costs k*bs per row, so a large k (ratio near 1) wants a
// radix select instead (later work).
//
// Rounding.  acc = e + lr*g is written as __fadd_rn(e, __fmul_rn(lr, g))
// so nvcc cannot contract it into an fma: the reference rounds the
// product and the sum separately, and so must this kernel for bitwise
// parity at lr != 1.
//
// Every entry point returns cudaGetLastError() after the launch; the
// Python wrapper raises when it is not cudaSuccess.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kMasked = -1.0f;  // picked, below the gate (or no gate use)
constexpr float kTaken = -2.0f;   // picked and emitted with its value

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// (m1, i1) ranks before (m2, i2): larger magnitude, then lower index.
__device__ __forceinline__ bool better(float m1, int i1, float m2, int i2) {
  return m1 > m2 || (m1 == m2 && i1 < i2);
}

__device__ __forceinline__ void warp_argmax(float& m, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_down_sync(0xffffffffu, m, off);
    const int i2 = __shfl_down_sync(0xffffffffu, i, off);
    if (better(m2, i2, m, i)) {
      m = m2;
      i = i2;
    }
  }
}

// Block-wide arg-max of mag[0, bs) with lowest-index ties; every thread
// gets the winner.  red_m/red_i hold kWarps partials plus one broadcast
// slot at [kWarps].
__device__ __forceinline__ void block_argmax(const float* mag, int bs,
                                             float* red_m, int* red_i,
                                             float& out_m, int& out_i) {
  float m = -INFINITY;
  int i = INT_MAX;
  for (int j = threadIdx.x; j < bs; j += kThreads) {
    const float v = mag[j];
    if (v > m) {  // ascending j: strict > keeps the lowest index
      m = v;
      i = j;
    }
  }
  warp_argmax(m, i);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    red_m[warp] = m;
    red_i[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    m = lane < kWarps ? red_m[lane] : -INFINITY;
    i = lane < kWarps ? red_i[lane] : INT_MAX;
    warp_argmax(m, i);
    if (lane == 0) {
      red_m[kWarps] = m;
      red_i[kWarps] = i;
    }
  }
  __syncthreads();
  out_m = red_m[kWarps];
  out_i = red_i[kWarps];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    block_topk_kernel(const T* __restrict__ x, T* __restrict__ vals,
                      int* __restrict__ idx, int bs, int r) {
  extern __shared__ float smem[];
  float* mag = smem;
  __shared__ float red_m[kWarps + 1];
  __shared__ int red_i[kWarps + 1];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * bs;
  for (int j = threadIdx.x; j < bs; j += kThreads) mag[j] = fabsf(to_f32(xr[j]));
  for (int p = 0; p < r; ++p) {
    float m;
    int w;
    block_argmax(mag, bs, red_m, red_i, m, w);
    if (threadIdx.x == w % kThreads) {  // the owner of slot w
      vals[row * r + p] = xr[w];
      idx[row * r + p] = w;
      mag[w] = kMasked;
    }
  }
}

// acc = e + lr*g; k gated passes; residual written when kResidual.
template <typename T, bool kResidual>
__global__ void __launch_bounds__(kThreads)
    ef_select_kernel(const T* __restrict__ g, const float* __restrict__ e,
                     const float* __restrict__ lr_p,
                     const float* __restrict__ thr_p, int thr_group,
                     float* __restrict__ vals, int* __restrict__ idx,
                     float* __restrict__ res, int bs, int k) {
  extern __shared__ float smem[];
  float* acc = smem;
  float* mag = smem + bs;
  __shared__ float red_m[kWarps + 1];
  __shared__ int red_i[kWarps + 1];
  const int64_t row = blockIdx.x;
  const float lr = *lr_p;
  const float thr = thr_p == nullptr ? -INFINITY : thr_p[row / thr_group];
  const T* gr = g + row * bs;
  const float* er = e + row * bs;
  for (int j = threadIdx.x; j < bs; j += kThreads) {
    const float a = __fadd_rn(er[j], __fmul_rn(lr, to_f32(gr[j])));
    acc[j] = a;
    mag[j] = fabsf(a);
  }
  for (int p = 0; p < k; ++p) {
    float m;
    int w;
    block_argmax(mag, bs, red_m, red_i, m, w);
    if (threadIdx.x == w % kThreads) {
      const bool take = m >= thr;
      vals[row * k + p] = take ? acc[w] : 0.0f;
      idx[row * k + p] = w;
      mag[w] = take ? kTaken : kMasked;
    }
  }
  if constexpr (kResidual) {
    float* rr = res + row * bs;
    for (int j = threadIdx.x; j < bs; j += kThreads) {
      const float a = acc[j];
      // residual = acc - selected, selected = 0 + value (scatter-ADD)
      rr[j] = mag[j] == kTaken ? __fsub_rn(a, __fadd_rn(0.0f, a)) : a;
    }
  }
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem_bytes) {
  if (smem_bytes > 48 * 1024) {
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem_bytes));
  }
  return cudaSuccess;
}

template <typename T>
int launch_block_topk(const void* x, void* vals, int* idx, int n, int bs,
                      int r, cudaStream_t stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(bs);
  cudaError_t err = prepare(block_topk_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  block_topk_kernel<T><<<n, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(vals), idx, bs, r);
  return cudaGetLastError();
}

template <typename T, bool kResidual>
int launch_ef_select(const void* g, const float* e, const float* lr,
                     const float* thr, int thr_group, float* vals, int* idx,
                     float* res, int n, int bs, int k, cudaStream_t stream) {
  const size_t smem = 2 * sizeof(float) * static_cast<size_t>(bs);
  cudaError_t err = prepare(ef_select_kernel<T, kResidual>, smem);
  if (err != cudaSuccess) return err;
  ef_select_kernel<T, kResidual><<<n, kThreads, smem, stream>>>(
      static_cast<const T*>(g), e, lr, thr, thr_group, vals, idx, res, bs,
      k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, vals: (n, bs) and (n, r) of f32 (x_bf16 = 0) or bf16 (x_bf16 = 1).
int block_topk(const void* x, int x_bf16, void* vals, void* idx, int n,
               int bs, int r, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* ip = static_cast<int*>(idx);
  return x_bf16 ? launch_block_topk<__nv_bfloat16>(x, vals, ip, n, bs, r, s)
                : launch_block_topk<float>(x, vals, ip, n, bs, r, s);
}

// g: (n, bs) f32 or bf16; e, res: (n, bs) f32; vals, idx: (n, k);
// lr: one f32 on the device; thr: f32 on the device, one per group of
// thr_group consecutive rows, or null for no gate.
int ef_select_pack(const void* g, int g_bf16, const void* e, const void* lr,
                   const void* thr, int thr_group, void* vals, void* idx,
                   void* res, int n, int bs, int k, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* ep = static_cast<const float*>(e);
  auto* lp = static_cast<const float*>(lr);
  auto* tp = static_cast<const float*>(thr);
  auto* vp = static_cast<float*>(vals);
  auto* ip = static_cast<int*>(idx);
  auto* rp = static_cast<float*>(res);
  return g_bf16 ? launch_ef_select<__nv_bfloat16, true>(
                      g, ep, lp, tp, thr_group, vp, ip, rp, n, bs, k, s)
                : launch_ef_select<float, true>(g, ep, lp, tp, thr_group, vp,
                                                ip, rp, n, bs, k, s);
}

// Stage 1 of the hierarchical pack: per-row top-r of acc = e + lr*g.
int ef_block_candidates(const void* g, int g_bf16, const void* e,
                        const void* lr, void* vals, void* idx, int n, int bs,
                        int r, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* ep = static_cast<const float*>(e);
  auto* lp = static_cast<const float*>(lr);
  auto* vp = static_cast<float*>(vals);
  auto* ip = static_cast<int*>(idx);
  return g_bf16 ? launch_ef_select<__nv_bfloat16, false>(
                      g, ep, lp, nullptr, 1, vp, ip, nullptr, n, bs, r, s)
                : launch_ef_select<float, false>(g, ep, lp, nullptr, 1, vp,
                                                 ip, nullptr, n, bs, r, s);
}

}  // extern "C"

// Gradient-selection kernels for Hopper (sm_90a): per-row top-k by
// magnitude with lowest-index ties, optionally fused with the
// error-feedback accumulate, the payload pack and the residual; and the
// elementwise error-feedback threshold sparsify.
//
// Four kernels, built into one shared library with a plain C interface
// (loaded with ctypes by repro_torch/kernels/build.py):
//
//   block_topk          replaces src/repro/kernels/block_topk.py
//                       block_topk_pallas (body _block_topk_kernel)
//   ef_select_pack      replaces src/repro/kernels/ef_sparsify.py
//                       ef_select_pack_pallas (body _ef_pack_kernel,
//                       _topk_emit)
//   ef_block_candidates replaces src/repro/kernels/ef_sparsify.py
//                       ef_block_candidates_pallas (body _ef_cand_kernel)
//   ef_accum_sparsify   replaces src/repro/kernels/ef_sparsify.py
//                       ef_accum_sparsify_pallas (body _ef_kernel); its
//                       design is described above the kernel
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

// ---------------------------------------------------------------------------
// ef_accum_sparsify: acc = e + lr*g; sel = acc * [|acc| >= thr];
// res = acc - sel, over a flat vector of any length d.
//
// Bound on the H100: bytes.  One read of g and e and one write of sel and
// res, 16 B per element at f32 g (14 B at bf16 g), against 4 flops per
// element: far below the f32 rate, so the floor is d * 16 B / 3.35 TB/s.
// The Pallas kernel tiles a (rows, 1024) padded view for the TPU's vector
// registers; here one streaming pass needs no padding.  A grid of one
// full wave of resident blocks strides over the vector; each thread moves
// 16-byte vectors (float4 of e, sel and res; float4 or 4 x bf16 of g)
// when every pointer is aligned for them, and the d % 4 tail (or the
// whole vector, for a misaligned view) element by element.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ef_accum_one(float g, float e, float lr,
                                             float thr, float& sel,
                                             float& res) {
  const float a = __fadd_rn(e, __fmul_rn(lr, g));  // no fma: see Rounding
  sel = fabsf(a) >= thr ? a : 0.0f;
  res = __fsub_rn(a, sel);  // literally acc - sel, as the reference
}

__device__ __forceinline__ void load4(const float* g, int64_t v, float* out) {
  const float4 x = reinterpret_cast<const float4*>(g)[v];
  out[0] = x.x;
  out[1] = x.y;
  out[2] = x.z;
  out[3] = x.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* g, int64_t v,
                                      float* out) {
  const uint2 raw = reinterpret_cast<const uint2*>(g)[v];
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  out[0] = lo.x;
  out[1] = lo.y;
  out[2] = hi.x;
  out[3] = hi.y;
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    ef_accum_kernel(const T* __restrict__ g, const float* __restrict__ e,
                    const float* __restrict__ lr_p,
                    const float* __restrict__ thr_p, float* __restrict__ sel,
                    float* __restrict__ res, int64_t d) {
  const float lr = *lr_p;
  const float thr = *thr_p;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  int64_t tail = 0;
  if constexpr (kVec) {
    const int64_t nv = d / 4;
    for (int64_t v = tid; v < nv; v += stride) {
      float gv[4];
      load4(g, v, gv);
      const float4 ev = reinterpret_cast<const float4*>(e)[v];
      float4 sv, rv;
      ef_accum_one(gv[0], ev.x, lr, thr, sv.x, rv.x);
      ef_accum_one(gv[1], ev.y, lr, thr, sv.y, rv.y);
      ef_accum_one(gv[2], ev.z, lr, thr, sv.z, rv.z);
      ef_accum_one(gv[3], ev.w, lr, thr, sv.w, rv.w);
      reinterpret_cast<float4*>(sel)[v] = sv;
      reinterpret_cast<float4*>(res)[v] = rv;
    }
    tail = nv * 4;
  }
  for (int64_t j = tail + tid; j < d; j += stride) {
    ef_accum_one(to_f32(g[j]), e[j], lr, thr, sel[j], res[j]);
  }
}

template <typename T>
int launch_ef_accum(const void* g, const float* e, const float* lr,
                    const float* thr, float* sel, float* res, int64_t d,
                    cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&per_sm,
                                 cudaDevAttrMaxThreadsPerMultiProcessor, dev);
  if (err != cudaSuccess) return err;
  // 16-byte vectors need every pointer aligned to its vector's width
  const uintptr_t gw = sizeof(T) * 4;
  const bool vec = reinterpret_cast<uintptr_t>(g) % gw == 0 &&
                   reinterpret_cast<uintptr_t>(e) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(sel) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(res) % 16 == 0;
  const int64_t items = vec ? d / 4 + d % 4 : d;
  const int64_t wave = static_cast<int64_t>(sms) * (per_sm / kThreads);
  const int64_t need = (items + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(need < wave ? (need > 0 ? need : 1)
                                                  : wave);
  const T* gp = static_cast<const T*>(g);
  if (vec) {
    ef_accum_kernel<T, true><<<blocks, kThreads, 0, stream>>>(
        gp, e, lr, thr, sel, res, d);
  } else {
    ef_accum_kernel<T, false><<<blocks, kThreads, 0, stream>>>(
        gp, e, lr, thr, sel, res, d);
  }
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

// Elementwise EF threshold sparsify over d elements: g f32 (g_bf16 = 0)
// or bf16 (g_bf16 = 1); e, sel, res f32; lr and thr one f32 each on the
// device.
int ef_accum_sparsify(const void* g, int g_bf16, const void* e,
                      const void* lr, const void* thr, void* sel, void* res,
                      long long d, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* ep = static_cast<const float*>(e);
  auto* lp = static_cast<const float*>(lr);
  auto* tp = static_cast<const float*>(thr);
  auto* sp = static_cast<float*>(sel);
  auto* rp = static_cast<float*>(res);
  return g_bf16 ? launch_ef_accum<__nv_bfloat16>(g, ep, lp, tp, sp, rp, d, s)
                : launch_ef_accum<float>(g, ep, lp, tp, sp, rp, d, s);
}

}  // extern "C"

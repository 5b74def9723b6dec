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
// Design of the three per-row selections.  One thread block per row.
// The row's f32 values (x for block_topk; acc = e + lr*g for the EF
// kernels) sit in dynamic shared memory, so acc never reaches device
// memory.  The selection keys on the magnitude's bits: a non-negative
// float orders as its uint32, so |v| is (bits(v) & 0x7fffffff).  Two
// paths, chosen per launch by k against radix_min_k (an argument: the
// wrapper owns the crossover, since its shared-memory check depends on
// the path):
//
//   arg-max (k < radix_min_k).  Each of the k passes is a block-wide
//   (magnitude, index) arg-max with lowest-index ties over a second row
//   of |v|; the winner's slot is then masked (-1, or -2 when it was
//   taken past the threshold gate).  Thread t owns the slots j == t (mod
//   blockDim), so the passes need no barrier beyond the two inside the
//   reduction.  k*bs shared-memory compares per row: cheap for a small
//   k, linear in k.
//
//   radix (k >= radix_min_k).  Three digit passes over the 31 magnitude
//   bits (11, 10 and 10 bits, a shared-memory histogram each, counting
//   only the entries whose higher digits equal the ones found so far;
//   the first is counted as the row loads) find the k-th largest
//   magnitude as a class of equal top bits, and how many of that class
//   the top k need; they stop early once the whole class is needed.  One sweep then marks the entries above the
//   class and the lowest-index members of the class: each warp walks a
//   contiguous stretch of indices and ranks the class members in index
//   order with ballots, so ties go to the lowest index.  The k picks are
//   compacted into 64-bit keys (magnitude bits << 32 | ~index) and
//   bitonic-sorted in descending order over the next power of two: the
//   reference's order, magnitude descending, index ascending.  The sort's
//   stages of strides below 64 run on 64-key segments in a warp's
//   registers (shuffles, no barrier); only the larger strides pass
//   through shared memory.  About 4*bs shared-memory reads and bs atomics
//   per row for the select, and (log2 n)^2 / 4 * n compare-exchanges for
//   the sort of n = pow2(k).
//
// Both paths emit each pick as the reference does: the value (0 below the
// threshold gate, with its index kept) and the index, in payload order;
// the EF kernels then write the residual, acc at every slot except the
// ones emitted with their value, where it is acc - (0 + acc).
//
// Bound on the H100.  Bytes: ef_select_pack reads g and e and writes the
// residual, 12 B per element at f32 g (8 B at bf16 g); ef_block_candidates
// reads g and e, 8 B per element; block_topk reads x, 4 B per element at
// f32.  The selection itself needs a few operations per entry, far below
// the card's f32 rate, so the bound is device-memory bandwidth.  Both
// paths read every input once with coalesced loads and write every output
// once.  The arg-max path stays under the bound while k is small; the
// radix path's cost is nearly flat in k until the sort of the picks
// grows, so it serves the large budgets an adaptive plan sets.  The
// crossover and its timings are at RADIX_MIN_K in
// repro_torch/kernels/block_topk.py.
//
// Shared memory per block: arg-max 4*bs B (block_topk) or 8*bs B (EF
// kernels, acc and |acc|); radix 4*bs B for the row (rounded up to 16)
// plus max(8*pow2(k), 4*2048) B for the keys, which reuse the room of
// the histogram.  At bs = 4096 and k <= bs that is at most 48 KiB.
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
#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kMasked = -1.0f;  // picked, below the gate (or no gate use)
constexpr float kTaken = -2.0f;   // picked and emitted with its value
constexpr int kHistBins = 2048;   // the first digit's 11 bits

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
    const float m2 = __shfl_down_sync(kFull, m, off);
    const int i2 = __shfl_down_sync(kFull, i, off);
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

// ---------------------------------------------------------------------------
// The radix path's block-wide steps.  Every thread of the block calls each
// of them; sbuf is a shared scratch of kWarps + 3 ints.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t mag_key(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

// Exclusive prefix sum of one int per thread, in thread order.  Writes
// sbuf[0, kWarps); the caller syncs before sbuf is written again.
__device__ __forceinline__ int block_exclusive_sum(int v, int* sbuf) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int n = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += n;
  }
  if (lane == 31) sbuf[warp] = incl;
  __syncthreads();
  int before = incl - v;
  for (int w = 0; w < warp; ++w) before += sbuf[w];
  return before;
}

// The k-th largest magnitude as a class of keys with equal top bits: the
// top k of the row are every entry with (key & mask) > prefix and the
// `need` lowest-index entries of the `n_class` with (key & mask) ==
// prefix.
struct Split {
  uint32_t prefix;
  uint32_t mask;
  int need;
  int n_class;
};

// The first digit's histogram is counted while the row loads: clear it
// (and sync) before the load, count each loaded value, sync after.
__device__ __forceinline__ void clear_first_digits(int* hist) {
  for (int b = threadIdx.x; b < kHistBins; b += kThreads) hist[b] = 0;
  __syncthreads();
}

__device__ __forceinline__ void count_first_digit(int* hist, float v) {
  atomicAdd(&hist[mag_key(v) >> 20], 1);
}

// On entry hist holds the first digit's counts of the whole row.
__device__ Split radix_select(const float* v, int bs, int k, int* hist,
                              int* sbuf) {
  Split s{0u, 0u, k, bs};
#pragma unroll 1
  for (int pass = 0; pass < 3; ++pass) {
    const int shift = pass == 0 ? 20 : 10 * (2 - pass);  // 20, 10, 0
    const int bins = pass == 0 ? kHistBins : 1024;
    if (pass > 0) {
      for (int b = threadIdx.x; b < bins; b += kThreads) hist[b] = 0;
      __syncthreads();
      for (int j = threadIdx.x; j < bs; j += kThreads) {
        const uint32_t key = mag_key(v[j]);
        if ((key & s.mask) == s.prefix) {
          atomicAdd(&hist[(key >> shift) & (bins - 1)], 1);
        }
      }
      __syncthreads();
    }
    // thread t sums the bins [top - per, top), counted from the highest
    // bin down; the one whose bins hold the need-th largest finds it
    const int per = bins / kThreads;
    const int top = bins - static_cast<int>(threadIdx.x) * per;
    int sum = 0;
    for (int b = top - per; b < top; ++b) sum += hist[b];
    int above = block_exclusive_sum(sum, sbuf);
    if (above < s.need && s.need <= above + sum) {
      int b = top - 1;
      while (above + hist[b] < s.need) above += hist[b--];
      sbuf[kWarps] = b;
      sbuf[kWarps + 1] = above;
      sbuf[kWarps + 2] = hist[b];
    }
    __syncthreads();
    s.prefix |= static_cast<uint32_t>(sbuf[kWarps]) << shift;
    s.mask |= static_cast<uint32_t>(bins - 1) << shift;
    s.need -= sbuf[kWarps + 1];
    s.n_class = sbuf[kWarps + 2];
    __syncthreads();  // hist and sbuf are written again by the next pass
    if (s.need == s.n_class) break;  // the whole class is in the top k
  }
  return s;
}

// Writes the top k of v[0, bs) as keys (magnitude bits << 32 | ~index)
// into keys[0, k) in no particular order, and 0 (below every key) into
// keys[k, n_keys).  Each warp walks one contiguous stretch of indices, so
// the class members before a slot in index order are those of the lower
// warps' stretches and the lower lanes of its own.
__device__ void pick_keys(const float* v, int bs, int k, const Split& s,
                          uint64_t* keys, int n_keys, int* sbuf) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int stretch = ((bs + kWarps - 1) / kWarps + 31) & ~31;
  const int lo = min(bs, warp * stretch);
  const int hi = min(bs, lo + stretch);
  const bool whole_class = s.need == s.n_class;
  int before = 0;  // class members at lower indices
  if (!whole_class) {
    int count = 0;
    for (int j0 = lo; j0 < hi; j0 += 32) {
      const int j = j0 + lane;
      const bool eq = j < hi && (mag_key(v[j]) & s.mask) == s.prefix;
      count += __popc(__ballot_sync(kFull, eq));
    }
    if (lane == 0) sbuf[warp] = count;
    __syncthreads();
    for (int w = 0; w < warp; ++w) before += sbuf[w];
  }
  if (threadIdx.x == 0) sbuf[kWarps] = 0;  // keys written so far
  __syncthreads();
  for (int j0 = lo; j0 < hi; j0 += 32) {
    const int j = j0 + lane;
    uint32_t key = 0;
    bool gt = false;
    bool eq = false;
    if (j < hi) {
      key = mag_key(v[j]);
      gt = (key & s.mask) > s.prefix;
      eq = (key & s.mask) == s.prefix;
    }
    const unsigned eqs = __ballot_sync(kFull, eq);
    const bool take =
        gt || (eq && (whole_class || before + __popc(eqs & below) < s.need));
    before += __popc(eqs);
    const unsigned takes = __ballot_sync(kFull, take);
    int base = 0;
    if (lane == 0 && takes != 0u) {
      base = atomicAdd(&sbuf[kWarps], __popc(takes));
    }
    base = __shfl_sync(kFull, base, 0);
    if (take) {
      keys[base + __popc(takes & below)] =
          (static_cast<uint64_t>(key) << 32) |
          (0xffffffffu - static_cast<uint32_t>(j));
    }
  }
  for (int p = k + threadIdx.x; p < n_keys; p += kThreads) keys[p] = 0;
  __syncthreads();
}

// One compare-exchange stage of a bitonic sort (merge blocks of `size`,
// partners `stride` apart), pairs ordered descending where the element
// index & size is 0, ascending elsewhere.  In shared memory: one pair
// per thread and pass.
__device__ __forceinline__ void smem_stage(uint64_t* keys, int n, int size,
                                           int stride) {
  for (int t = threadIdx.x; t < n / 2; t += kThreads) {
    const int i = 2 * t - (t & (stride - 1));
    const int j = i + stride;
    const uint64_t a = keys[i];
    const uint64_t b = keys[j];
    if ((a < b) == ((i & size) == 0)) {
      keys[i] = b;
      keys[j] = a;
    }
  }
}

// The same stage at a stride of at most 32 on one 64-key segment held in
// a warp's registers: lane l holds the keys base + 2l and base + 2l + 1
// in v[0], v[1]; its partners are its own other key (stride 1) or lane
// l ^ stride/2's key of the same parity.
__device__ __forceinline__ void warp_stage(uint64_t (&v)[2], int base,
                                           int size, int stride) {
  const int e = base + 2 * (threadIdx.x & 31);
  if (stride == 1) {
    if ((v[0] < v[1]) == ((e & size) == 0)) {
      const uint64_t t = v[0];
      v[0] = v[1];
      v[1] = t;
    }
    return;
  }
  const bool lower = (e & stride) == 0;  // for both keys: stride is even
  const bool keep_max = lower == ((e & size) == 0);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint64_t other = __shfl_xor_sync(kFull, v[h], stride >> 1);
    v[h] = keep_max ? (v[h] > other ? v[h] : other)
                    : (v[h] < other ? v[h] : other);
  }
}

// Every stage of strides 32 down to 1 of a merge of `size` (sizes up to
// 64 with all of theirs, when `size` is 0), per 64-key segment in
// registers: no barrier between the stages.
__device__ __forceinline__ void warp_stages(uint64_t* keys, int n, int size) {
  auto* pairs = reinterpret_cast<ulonglong2*>(keys);
  for (int base = (threadIdx.x >> 5) * 64; base < n; base += kWarps * 64) {
    const ulonglong2 p = pairs[base / 2 + (threadIdx.x & 31)];
    uint64_t v[2] = {p.x, p.y};
    if (size == 0) {
#pragma unroll
      for (int sz = 2; sz <= 64; sz <<= 1) {
#pragma unroll
        for (int stride = sz >> 1; stride > 0; stride >>= 1) {
          warp_stage(v, base, sz, stride);
        }
      }
    } else {
#pragma unroll
      for (int stride = 32; stride > 0; stride >>= 1) {
        warp_stage(v, base, size, stride);
      }
    }
    pairs[base / 2 + (threadIdx.x & 31)] = make_ulonglong2(v[0], v[1]);
  }
}

// Sorts keys[0, n) into descending order; n is a power of two.  From 64
// keys on, the stages of strides below 64 run in registers, so only the
// stages of larger strides cost a pass through shared memory and a
// barrier each.
__device__ void bitonic_sort_desc(uint64_t* keys, int n) {
  if (n < 64) {
    for (int size = 2; size <= n; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        smem_stage(keys, n, size, stride);
        __syncthreads();
      }
    }
    return;
  }
  warp_stages(keys, n, 0);
  __syncthreads();
  for (int size = 128; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride >= 64; stride >>= 1) {
      smem_stage(keys, n, size, stride);
      __syncthreads();
    }
    warp_stages(keys, n, size);
    __syncthreads();
  }
}

__device__ __forceinline__ int key_index(uint64_t key) {
  return static_cast<int>(0xffffffffu - static_cast<uint32_t>(key));
}

__device__ __forceinline__ float key_magnitude(uint64_t key) {
  return __uint_as_float(static_cast<uint32_t>(key >> 32));
}

// the room of the row in the radix kernels' dynamic shared memory
__host__ __device__ __forceinline__ size_t radix_row_bytes(int bs) {
  return (sizeof(float) * static_cast<size_t>(bs) + 15) / 16 * 16;
}

// ---------------------------------------------------------------------------
// The kernels.
// ---------------------------------------------------------------------------

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    block_topk_radix_kernel(const T* __restrict__ x, T* __restrict__ vals,
                            int* __restrict__ idx, int bs, int r,
                            int n_keys) {
  extern __shared__ __align__(16) unsigned char radix_smem[];
  float* row_v = reinterpret_cast<float*>(radix_smem);
  auto* keys = reinterpret_cast<uint64_t*>(radix_smem + radix_row_bytes(bs));
  int* hist = reinterpret_cast<int*>(keys);  // shares the keys' room
  __shared__ int sbuf[kWarps + 3];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * bs;
  clear_first_digits(hist);
  for (int j = threadIdx.x; j < bs; j += kThreads) {
    const float v = to_f32(xr[j]);
    row_v[j] = v;
    count_first_digit(hist, v);
  }
  __syncthreads();
  const Split s = radix_select(row_v, bs, r, hist, sbuf);
  pick_keys(row_v, bs, r, s, keys, n_keys, sbuf);
  bitonic_sort_desc(keys, n_keys);
  for (int p = threadIdx.x; p < r; p += kThreads) {
    const int w = key_index(keys[p]);
    vals[row * r + p] = xr[w];
    idx[row * r + p] = w;
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

// The same function by radix select: acc stays in shared memory, and a
// slot emitted with its value holds its residual there before the write.
template <typename T, bool kResidual>
__global__ void __launch_bounds__(kThreads)
    ef_select_radix_kernel(const T* __restrict__ g,
                           const float* __restrict__ e,
                           const float* __restrict__ lr_p,
                           const float* __restrict__ thr_p, int thr_group,
                           float* __restrict__ vals, int* __restrict__ idx,
                           float* __restrict__ res, int bs, int k,
                           int n_keys) {
  extern __shared__ __align__(16) unsigned char radix_smem[];
  float* acc = reinterpret_cast<float*>(radix_smem);
  auto* keys = reinterpret_cast<uint64_t*>(radix_smem + radix_row_bytes(bs));
  int* hist = reinterpret_cast<int*>(keys);  // shares the keys' room
  __shared__ int sbuf[kWarps + 3];
  const int64_t row = blockIdx.x;
  const float lr = *lr_p;
  const float thr = thr_p == nullptr ? -INFINITY : thr_p[row / thr_group];
  const T* gr = g + row * bs;
  const float* er = e + row * bs;
  clear_first_digits(hist);
  for (int j = threadIdx.x; j < bs; j += kThreads) {
    const float a = __fadd_rn(er[j], __fmul_rn(lr, to_f32(gr[j])));
    acc[j] = a;
    count_first_digit(hist, a);
  }
  __syncthreads();
  const Split s = radix_select(acc, bs, k, hist, sbuf);
  pick_keys(acc, bs, k, s, keys, n_keys, sbuf);
  bitonic_sort_desc(keys, n_keys);
  for (int p = threadIdx.x; p < k; p += kThreads) {
    const uint64_t key = keys[p];
    const int w = key_index(key);
    const float a = acc[w];
    const bool take = key_magnitude(key) >= thr;
    vals[row * k + p] = take ? a : 0.0f;
    idx[row * k + p] = w;
    if (kResidual && take) acc[w] = __fsub_rn(a, __fadd_rn(0.0f, a));
  }
  if constexpr (kResidual) {
    __syncthreads();
    float* rr = res + row * bs;
    for (int j = threadIdx.x; j < bs; j += kThreads) rr[j] = acc[j];
  }
}

// Above 48 KiB of shared memory a block needs the opt-in attribute; the
// kernel's static shared memory counts toward the 48 KiB too.  Querying
// the attributes and opting in cost host time on every launch (the paper
// CNN's narrow rows launch ~50 times a step), so each (kernel, device)
// remembers the largest dynamic size it was prepared for: a launch at or
// below it skips both calls.  A full table prepares again every time.
struct Prepared {
  const void* kernel;
  int device;
  size_t smem;
};
constexpr int kMaxPrepared = 64;
std::mutex g_prepared_mu;
Prepared g_prepared[kMaxPrepared];
int g_n_prepared = 0;

template <typename K>
cudaError_t prepare(K kernel, size_t smem_bytes) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const void* key = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(g_prepared_mu);
  Prepared* slot = nullptr;
  for (int i = 0; i < g_n_prepared; ++i) {
    if (g_prepared[i].kernel == key && g_prepared[i].device == device) {
      slot = &g_prepared[i];
      break;
    }
  }
  if (slot != nullptr && smem_bytes <= slot->smem) return cudaSuccess;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (attr.sharedSizeBytes + smem_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_bytes));
    if (err != cudaSuccess) return err;
  }
  if (slot == nullptr) {
    if (g_n_prepared == kMaxPrepared) return cudaSuccess;
    slot = &g_prepared[g_n_prepared++];
    slot->kernel = key;
    slot->device = device;
  }
  slot->smem = smem_bytes;
  return cudaSuccess;
}

// The radix kernels' dynamic shared memory for a row of bs and k picks,
// and the keys it sorts (k rounded up to a power of two).
size_t radix_smem_bytes(int bs, int k, int* n_keys) {
  int n = 1;
  while (n < k) n <<= 1;
  *n_keys = n;
  const size_t keys = sizeof(uint64_t) * static_cast<size_t>(n);
  const size_t hist = sizeof(int) * static_cast<size_t>(kHistBins);
  return radix_row_bytes(bs) + (keys > hist ? keys : hist);
}

template <typename T>
int launch_block_topk(const void* x, void* vals, int* idx, int n, int bs,
                      int r, int radix_min_k, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  T* vp = static_cast<T*>(vals);
  cudaError_t err;
  if (r >= radix_min_k) {
    int n_keys = 0;
    const size_t smem = radix_smem_bytes(bs, r, &n_keys);
    err = prepare(block_topk_radix_kernel<T>, smem);
    if (err != cudaSuccess) return err;
    block_topk_radix_kernel<T><<<n, kThreads, smem, stream>>>(xp, vp, idx,
                                                             bs, r, n_keys);
  } else {
    const size_t smem = sizeof(float) * static_cast<size_t>(bs);
    err = prepare(block_topk_kernel<T>, smem);
    if (err != cudaSuccess) return err;
    block_topk_kernel<T><<<n, kThreads, smem, stream>>>(xp, vp, idx, bs, r);
  }
  return cudaGetLastError();
}

template <typename T, bool kResidual>
int launch_ef_select(const void* g, const float* e, const float* lr,
                     const float* thr, int thr_group, float* vals, int* idx,
                     float* res, int n, int bs, int k, int radix_min_k,
                     cudaStream_t stream) {
  const T* gp = static_cast<const T*>(g);
  cudaError_t err;
  if (k >= radix_min_k) {
    int n_keys = 0;
    const size_t smem = radix_smem_bytes(bs, k, &n_keys);
    err = prepare(ef_select_radix_kernel<T, kResidual>, smem);
    if (err != cudaSuccess) return err;
    ef_select_radix_kernel<T, kResidual><<<n, kThreads, smem, stream>>>(
        gp, e, lr, thr, thr_group, vals, idx, res, bs, k, n_keys);
  } else {
    const size_t smem = 2 * sizeof(float) * static_cast<size_t>(bs);
    err = prepare(ef_select_kernel<T, kResidual>, smem);
    if (err != cudaSuccess) return err;
    ef_select_kernel<T, kResidual><<<n, kThreads, smem, stream>>>(
        gp, e, lr, thr, thr_group, vals, idx, res, bs, k);
  }
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
// In this and the next two entry points, r (or k) >= radix_min_k selects
// by radix select, a smaller one by r arg-max passes.
int block_topk(const void* x, int x_bf16, void* vals, void* idx, int n,
               int bs, int r, int radix_min_k, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* ip = static_cast<int*>(idx);
  return x_bf16 ? launch_block_topk<__nv_bfloat16>(x, vals, ip, n, bs, r,
                                                   radix_min_k, s)
                : launch_block_topk<float>(x, vals, ip, n, bs, r,
                                           radix_min_k, s);
}

// g: (n, bs) f32 or bf16; e, res: (n, bs) f32; vals, idx: (n, k);
// lr: one f32 on the device; thr: f32 on the device, one per group of
// thr_group consecutive rows, or null for no gate.
int ef_select_pack(const void* g, int g_bf16, const void* e, const void* lr,
                   const void* thr, int thr_group, void* vals, void* idx,
                   void* res, int n, int bs, int k, int radix_min_k,
                   void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* ep = static_cast<const float*>(e);
  auto* lp = static_cast<const float*>(lr);
  auto* tp = static_cast<const float*>(thr);
  auto* vp = static_cast<float*>(vals);
  auto* ip = static_cast<int*>(idx);
  auto* rp = static_cast<float*>(res);
  return g_bf16 ? launch_ef_select<__nv_bfloat16, true>(
                      g, ep, lp, tp, thr_group, vp, ip, rp, n, bs, k,
                      radix_min_k, s)
                : launch_ef_select<float, true>(g, ep, lp, tp, thr_group, vp,
                                                ip, rp, n, bs, k, radix_min_k,
                                                s);
}

// Stage 1 of the hierarchical pack: per-row top-r of acc = e + lr*g.
int ef_block_candidates(const void* g, int g_bf16, const void* e,
                        const void* lr, void* vals, void* idx, int n, int bs,
                        int r, int radix_min_k, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* ep = static_cast<const float*>(e);
  auto* lp = static_cast<const float*>(lr);
  auto* vp = static_cast<float*>(vals);
  auto* ip = static_cast<int*>(idx);
  return g_bf16 ? launch_ef_select<__nv_bfloat16, false>(
                      g, ep, lp, nullptr, 1, vp, ip, nullptr, n, bs, r,
                      radix_min_k, s)
                : launch_ef_select<float, false>(g, ep, lp, nullptr, 1, vp,
                                                 ip, nullptr, n, bs, r,
                                                 radix_min_k, s);
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

// K1 on Hopper: fused softmax cross-entropy and argmax-correct, forward
// and backward, for sm_90a.
//
// The forward replaces tritonk8ssupervisor_tpu/ops/cross_entropy.py::
// _ce_kernel (:56, launched by `_forward` :115). Per row of the (B, C)
// logits, in f32 whatever their dtype:
//
//   m      = max_j x[j]
//   s      = sum_j exp(x[j] - m)
//   picked = x[label] - m          one f32 subtraction, so the row max reads
//                                  exactly 0 and `correct` is exact, ties included;
//            -inf for a label in [C, ceil(C / 128) * 128) (the TPU kernel's
//            padding lanes), 0 for any other label outside [0, C)
//   loss   = log(s) - picked
//   correct = picked >= 0 and 0 <= label < C
//   lse    = m + log(s)            the row's logsumexp, which the backward reads
//
// The backward replaces the reference's `_dlogits` (:237-241), which the
// TPU leaves to XLA's fusion: for the (B,) cotangent g of the losses,
//
//   dlogits[j] = (exp(x[j] - lse) - [j == label]) * g
//
// in f32, stored in the logits' dtype; [j == label] is 0 for a label
// outside [0, C), as jax.nn.one_hot gives.
//
// What bounds them on an H100: bytes. The forward reads the logits once and
// writes 9 bytes a row; the backward reads them once and writes as many.
// At the LM's (8192, 32768) bf16 that is 537 MB, 0.160 ms at 3.35 TB/s, and
// 1.07 GB, 0.320 ms. At the byte LM's (32768, 256) the forward reads 16.8 MB
// (5 us), and at ResNet-50's (256, 1000) f32 1 MB (0.3 us): there the
// chain of dependent steps in a row, and the launch, set the time.
//
// Design. Every load moves 16 bytes (8 bf16 or f16, 4 f32) when each row
// starts on a 16-byte boundary, else one element (a scalar path chosen at
// launch, for C * elem not a multiple of 16). The host chooses the regime
// from the shape (ops/cross_entropy_cuda.py):
//
// - Narrow rows (at most 16 loads a lane, C * elem <= 8 KB vectorised):
//   one warp a row, 4 rows a CTA. Each lane issues all of its loads at once
//   and keeps them in registers; the row max and then the sum are warp
//   shuffles. No shared memory, no barrier. The label's logit is picked
//   from the registers of the lane that holds it and shuffled to the others,
//   so no load waits on the label's.
// - Wide rows: one CTA of 256 threads a row. Each thread keeps its own
//   online (max, sum) over 4 loads in flight an iteration, rescaling once an
//   iteration; one block reduction of the (max, sum) pairs at the end, where
//   a reduction a tile would cost a barrier a tile. Thread 0 loads the
//   label's logit once at the start.
// - The backward: one pass, read once and written once, over a grid of row
//   groups x column chunks of 1024 loads (256 threads x 4 in flight), a chunk
//   as wide as the row up to that, so narrow and wide rows alike fill the 132
//   SMs. g is read by its stride (0 when it comes from a mean).
//
// Plain C interface, loaded with ctypes (ops/cross_entropy_cuda.py). Each
// entry launches on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() after its launch. The
// wrapper (ops/cross_entropy.py) checks devices, dtypes, shapes and
// contiguity and allocates the outputs.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNarrowWarps = 4;    // rows (one a warp) a CTA, narrow forward
constexpr int kMaxPerLane = 16;    // loads a lane holds, narrow forward
constexpr int kWideThreads = 256;  // one CTA a row, wide forward
constexpr int kWideUnroll = 4;     // loads in flight a thread, wide forward
constexpr int kBwdThreads = 256;
constexpr int kBwdUnroll = 4;      // loads in flight a thread, backward
constexpr int kBwdItemsLog2 = 10;  // loads a backward CTA: 256 x 4
constexpr int kLane = 128;         // the TPU kernel's class padding

static_assert(kBwdThreads * kBwdUnroll == 1 << kBwdItemsLog2, "backward tile");

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) { return __bfloat162float(x); }
template <>
__device__ __forceinline__ float to_f32<__half>(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }

// element i of a 32-bit word holding 32 / (8 sizeof(T)) elements, low first
template <typename T>
__device__ __forceinline__ float word_elem(uint32_t w, int i);
template <>
__device__ __forceinline__ float word_elem<float>(uint32_t w, int) { return __uint_as_float(w); }
template <>
__device__ __forceinline__ float word_elem<__nv_bfloat16>(uint32_t w, int i) {
  return __uint_as_float(i ? w & 0xffff0000u : w << 16);  // exact
}
template <>
__device__ __forceinline__ float word_elem<__half>(uint32_t w, int i) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(i ? w >> 16 : w)));
}

template <typename T>
__device__ __forceinline__ uint32_t elem_bits(float x);
template <>
__device__ __forceinline__ uint32_t elem_bits<float>(float x) { return __float_as_uint(x); }
template <>
__device__ __forceinline__ uint32_t elem_bits<__nv_bfloat16>(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
template <>
__device__ __forceinline__ uint32_t elem_bits<__half>(float x) {
  return __half_as_ushort(__float2half_rn(x));
}

// K elements of T moved by one load: 16 bytes, or one element (K = 1).
template <typename T, int K>
struct Pack {
  static_assert(K * sizeof(T) == 16, "a vector load moves 16 bytes");
  static constexpr int kPerWord = 4 / sizeof(T);
  uint4 raw;

  __device__ __forceinline__ void load(const T* p) {
    raw = __ldg(reinterpret_cast<const uint4*>(p));
  }
  // k is a constant once the caller's loop is unrolled
  __device__ __forceinline__ float get(int k) const {
    const int w = k / kPerWord;
    const uint32_t word = w == 0 ? raw.x : w == 1 ? raw.y : w == 2 ? raw.z : raw.w;
    return word_elem<T>(word, k % kPerWord);
  }
  static __device__ __forceinline__ void store(T* p, const float (&y)[K]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = 0;
#pragma unroll
      for (int j = 0; j < kPerWord; ++j) {
        w[i] |= elem_bits<T>(y[i * kPerWord + j]) << (j * 8 * sizeof(T));
      }
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <typename T>
struct Pack<T, 1> {
  T raw;
  __device__ __forceinline__ void load(const T* p) { raw = p[0]; }
  __device__ __forceinline__ float get(int) const { return to_f32(raw); }
  static __device__ __forceinline__ void store(T* p, const float (&y)[1]) {
    p[0] = from_f32<T>(y[0]);
  }
};

__device__ __forceinline__ long long load_label(const void* labels, int label_64, long long row) {
  return label_64 ? static_cast<const long long*>(labels)[row]
                  : static_cast<const int*>(labels)[row];
}

// (max, sum of exp(x - max)) of two parts; an empty part is (-inf, 0)
__device__ __forceinline__ void combine(float& m, float& s, float m2, float s2) {
  const float mx = fmaxf(m, m2);
  if (mx == -INFINITY) return;
  s = s * __expf(m - mx) + s2 * __expf(m2 - mx);
  m = mx;
}

// the row's outputs from its max m, sum s and the label's logit
__device__ __forceinline__ void write_row(long long row, long long label, int classes, float m,
                                          float s, float label_x, float* __restrict__ loss,
                                          uint8_t* __restrict__ correct,
                                          float* __restrict__ lse) {
  const bool valid = label >= 0 && label < classes;
  const long long padded = (static_cast<long long>(classes) + kLane - 1) / kLane * kLane;
  const float picked = valid ? label_x - m : (label >= classes && label < padded ? -INFINITY : 0.f);
  const float log_s = logf(s);
  loss[row] = log_s - picked;
  correct[row] = valid && picked >= 0.f;
  lse[row] = m + log_s;
}

template <typename T, int K, int N>
__global__ void __launch_bounds__(kNarrowWarps * kWarp)
    ce_fwd_narrow(const T* __restrict__ logits, const void* __restrict__ labels, int label_64,
                  float* __restrict__ loss, uint8_t* __restrict__ correct,
                  float* __restrict__ lse, long long batch, int classes) {
  const int lane = threadIdx.x % kWarp;
  const long long row = static_cast<long long>(blockIdx.x) * kNarrowWarps + threadIdx.x / kWarp;
  if (row >= batch) return;  // the whole warp
  const T* x = logits + row * classes;
  const long long label = load_label(labels, label_64, row);  // one broadcast load
  Pack<T, K> pk[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int col = (n * kWarp + lane) * K;
    if (col < classes) pk[n].load(x + col);  // C % K == 0: a load is whole or absent
  }
  float m = -INFINITY;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    if ((n * kWarp + lane) * K < classes) {
#pragma unroll
      for (int k = 0; k < K; ++k) m = fmaxf(m, pk[n].get(k));
    }
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2) m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  float s = 0.f;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    if ((n * kWarp + lane) * K < classes) {
#pragma unroll
      for (int k = 0; k < K; ++k) s += __expf(pk[n].get(k) - m);
    }
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2) s += __shfl_xor_sync(kFull, s, off);
  // the label's logit from the registers of its lane; label is warp-uniform
  float label_x = 0.f;
  if (label >= 0 && label < classes) {
    const int load = static_cast<int>(label) / K;
    const int at_n = load / kWarp, at_k = static_cast<int>(label) % K;
    Pack<T, K> sel = pk[0];
#pragma unroll
    for (int n = 1; n < N; ++n) {
      if (n == at_n) sel = pk[n];
    }
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k == at_k) v = sel.get(k);
    }
    label_x = __shfl_sync(kFull, v, load % kWarp);
  }
  if (lane == 0) write_row(row, label, classes, m, s, label_x, loss, correct, lse);
}

template <typename T, int K>
__global__ void __launch_bounds__(kWideThreads)
    ce_fwd_wide(const T* __restrict__ logits, const void* __restrict__ labels, int label_64,
                float* __restrict__ loss, uint8_t* __restrict__ correct,
                float* __restrict__ lse, int classes) {
  __shared__ float part_m[kWideThreads / kWarp], part_s[kWideThreads / kWarp];
  const long long row = blockIdx.x;
  const T* x = logits + row * classes;
  long long label = 0;
  float label_x = 0.f;
  if (threadIdx.x == 0) {
    label = load_label(labels, label_64, row);
    if (label >= 0 && label < classes) label_x = to_f32(x[label]);
  }
  const int n_loads = classes / K;
  float m = -INFINITY, s = 0.f;
  for (int base = threadIdx.x; base < n_loads; base += kWideThreads * kWideUnroll) {
    Pack<T, K> pk[kWideUnroll];
#pragma unroll
    for (int u = 0; u < kWideUnroll; ++u) {
      const int at = base + u * kWideThreads;
      if (at < n_loads) pk[u].load(x + static_cast<long long>(at) * K);
    }
    float mx = m;
#pragma unroll
    for (int u = 0; u < kWideUnroll; ++u) {
      if (base + u * kWideThreads < n_loads) {
#pragma unroll
        for (int k = 0; k < K; ++k) mx = fmaxf(mx, pk[u].get(k));
      }
    }
    if (mx == -INFINITY) continue;  // nothing but -inf so far: s stays 0
    s *= __expf(m - mx);
#pragma unroll
    for (int u = 0; u < kWideUnroll; ++u) {
      if (base + u * kWideThreads < n_loads) {
#pragma unroll
        for (int k = 0; k < K; ++k) s += __expf(pk[u].get(k) - mx);
      }
    }
    m = mx;
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2) {
    const float m2 = __shfl_xor_sync(kFull, m, off), s2 = __shfl_xor_sync(kFull, s, off);
    combine(m, s, m2, s2);
  }
  const int warp = threadIdx.x / kWarp;
  if (threadIdx.x % kWarp == 0) {
    part_m[warp] = m;
    part_s[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWideThreads / kWarp; ++w) combine(m, s, part_m[w], part_s[w]);
    write_row(row, label, classes, m, s, label_x, loss, correct, lse);
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(kBwdThreads)
    ce_bwd(const T* __restrict__ logits, const void* __restrict__ labels, int label_64,
           const float* __restrict__ lse, const float* __restrict__ g, long long g_stride,
           T* __restrict__ dlogits, long long batch, int classes, int chunk_shift,
           long long n_chunks) {
  const int n_loads = classes / K;
  const long long group = blockIdx.x / n_chunks;
  const long long chunk = blockIdx.x - group * n_chunks;
  const int chunk_mask = (1 << chunk_shift) - 1;
  Pack<T, K> pk[kBwdUnroll];
  long long row[kBwdUnroll], col[kBwdUnroll];
  bool ok[kBwdUnroll];
#pragma unroll
  for (int u = 0; u < kBwdUnroll; ++u) {
    const int local = threadIdx.x + u * kBwdThreads;
    row[u] = (group << (kBwdItemsLog2 - chunk_shift)) + (local >> chunk_shift);
    const long long at = (chunk << chunk_shift) + (local & chunk_mask);
    ok[u] = row[u] < batch && at < n_loads;
    col[u] = at * K;
    if (ok[u]) pk[u].load(logits + row[u] * classes + col[u]);
  }
#pragma unroll
  for (int u = 0; u < kBwdUnroll; ++u) {
    if (!ok[u]) continue;
    const long long label = load_label(labels, label_64, row[u]);
    const float l = lse[row[u]], gr = g[row[u] * g_stride];
    float y[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float p = __expf(pk[u].get(k) - l);
      y[k] = (p - (col[u] + k == label ? 1.f : 0.f)) * gr;
    }
    Pack<T, K>::store(dlogits + row[u] * classes + col[u], y);
  }
}

template <typename T, int K>
cudaError_t launch_fwd(const void* logits, const void* labels, int label_64, float* loss,
                       uint8_t* correct, float* lse, long long batch, int classes, int per_lane,
                       cudaStream_t st) {
  const T* x = static_cast<const T*>(logits);
  const dim3 narrow_grid(static_cast<unsigned>((batch + kNarrowWarps - 1) / kNarrowWarps));
  const dim3 narrow_block(kNarrowWarps * kWarp);
  switch (per_lane) {
    case 0:
      ce_fwd_wide<T, K><<<static_cast<unsigned>(batch), kWideThreads, 0, st>>>(
          x, labels, label_64, loss, correct, lse, classes);
      break;
    case 1:
      ce_fwd_narrow<T, K, 1><<<narrow_grid, narrow_block, 0, st>>>(
          x, labels, label_64, loss, correct, lse, batch, classes);
      break;
    case 2:
      ce_fwd_narrow<T, K, 2><<<narrow_grid, narrow_block, 0, st>>>(
          x, labels, label_64, loss, correct, lse, batch, classes);
      break;
    case 4:
      ce_fwd_narrow<T, K, 4><<<narrow_grid, narrow_block, 0, st>>>(
          x, labels, label_64, loss, correct, lse, batch, classes);
      break;
    case 8:
      ce_fwd_narrow<T, K, 8><<<narrow_grid, narrow_block, 0, st>>>(
          x, labels, label_64, loss, correct, lse, batch, classes);
      break;
    case 16:
      ce_fwd_narrow<T, K, 16><<<narrow_grid, narrow_block, 0, st>>>(
          x, labels, label_64, loss, correct, lse, batch, classes);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd_for(int vec, const void* logits, const void* labels, int label_64, float* loss,
                    uint8_t* correct, float* lse, long long batch, int classes, int per_lane,
                    cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec == kVec) {
    return launch_fwd<T, kVec>(logits, labels, label_64, loss, correct, lse, batch, classes,
                               per_lane, st);
  }
  if (vec == 1) {
    return launch_fwd<T, 1>(logits, labels, label_64, loss, correct, lse, batch, classes,
                            per_lane, st);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t bwd_for(int vec, const void* logits, const void* labels, int label_64,
                    const float* lse, const float* g, long long g_stride, void* dlogits,
                    long long batch, int classes, int chunk_shift, cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec != kVec && vec != 1) return cudaErrorInvalidValue;
  const long long n_loads = classes / vec;
  const long long n_chunks = (n_loads + (1 << chunk_shift) - 1) >> chunk_shift;
  const long long rows_per_cta = 1LL << (kBwdItemsLog2 - chunk_shift);
  const long long ctas = (batch + rows_per_cta - 1) / rows_per_cta * n_chunks;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  const T* x = static_cast<const T*>(logits);
  T* out = static_cast<T*>(dlogits);
  if (vec == kVec) {
    ce_bwd<T, kVec><<<static_cast<unsigned>(ctas), kBwdThreads, 0, st>>>(
        x, labels, label_64, lse, g, g_stride, out, batch, classes, chunk_shift, n_chunks);
  } else {
    ce_bwd<T, 1><<<static_cast<unsigned>(ctas), kBwdThreads, 0, st>>>(
        x, labels, label_64, lse, g, g_stride, out, batch, classes, chunk_shift, n_chunks);
  }
  return cudaGetLastError();
}

size_t elem_size(int dtype) { return dtype == 2 ? 4 : 2; }

bool aligned_rows(int dtype, int vec, int classes, const void* a, const void* b) {
  if (vec == 1) return true;
  if (static_cast<size_t>(vec) * elem_size(dtype) != 16 || classes % vec) return false;
  return reinterpret_cast<uintptr_t>(a) % 16 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

}  // namespace

extern "C" {

// dtype 0 = bf16, 1 = fp16, 2 = f32 (the logits); labels int32, or int64
// when label_64. Contiguous (batch, classes) logits; loss, correct (one
// byte 0/1) and lse hold batch values each. `vec` elements a load: 16 /
// element size when each row starts on a 16-byte boundary, else 1.
// `per_lane`: loads a lane for one warp a row (1, 2, 4, 8 or 16, at least
// ceil(classes / vec / 32)), or 0 for one CTA a row.
int tk8s_cross_entropy_fwd(int dtype, const void* logits, const void* labels, int label_64,
                           float* loss, uint8_t* correct, float* lse, long long batch,
                           int classes, int vec, int per_lane, void* stream) {
  const long long narrow_ctas = (batch + kNarrowWarps - 1) / kNarrowWarps;
  if (batch <= 0 || classes <= 0 || dtype < 0 || dtype > 2 ||
      !aligned_rows(dtype, vec, classes, logits, logits) ||
      per_lane < 0 || per_lane > kMaxPerLane ||
      (per_lane > 0 && static_cast<long long>(per_lane) * kWarp * vec < classes) ||
      (per_lane == 0 ? batch : narrow_ctas) > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return fwd_for<__nv_bfloat16>(vec, logits, labels, label_64, loss, correct, lse, batch,
                                  classes, per_lane, st);
  }
  if (dtype == 1) {
    return fwd_for<__half>(vec, logits, labels, label_64, loss, correct, lse, batch, classes,
                           per_lane, st);
  }
  return fwd_for<float>(vec, logits, labels, label_64, loss, correct, lse, batch, classes,
                        per_lane, st);
}

// dlogits (contiguous, the logits' dtype and shape) from the logits, the
// labels, the forward's lse (batch f32) and g (batch f32 at a stride of
// g_stride elements, 0 included). `vec` as for the forward, for both the
// logits and dlogits; `chunk_shift` = log2 of the loads a chunk of a row,
// 0 to 10.
int tk8s_cross_entropy_bwd(int dtype, const void* logits, const void* labels, int label_64,
                           const float* lse, const float* g, long long g_stride, void* dlogits,
                           long long batch, int classes, int vec, int chunk_shift,
                           void* stream) {
  if (batch <= 0 || classes <= 0 || dtype < 0 || dtype > 2 || g_stride < 0 ||
      chunk_shift < 0 || chunk_shift > kBwdItemsLog2 ||
      !aligned_rows(dtype, vec, classes, logits, dlogits)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return bwd_for<__nv_bfloat16>(vec, logits, labels, label_64, lse, g, g_stride, dlogits,
                                  batch, classes, chunk_shift, st);
  }
  if (dtype == 1) {
    return bwd_for<__half>(vec, logits, labels, label_64, lse, g, g_stride, dlogits, batch,
                           classes, chunk_shift, st);
  }
  return bwd_for<float>(vec, logits, labels, label_64, lse, g, g_stride, dlogits, batch,
                        classes, chunk_shift, st);
}

const char* tk8s_cross_entropy_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// K3 on Hopper: decode attention over an int8 KV cache, for sm_90a.
//
// Replaces tritonk8ssupervisor_tpu/ops/decode_attention.py::_kernel (the
// Pallas kernel behind `decode_attention_int8`). For each batch row b, head
// h and query w of a window of W queries (W = 1 for a decode step), with
// int8 keys and values k8, v8 and their per-(token, head) f32 scales ks, vs:
//
//   s[j] = (sum_d q[d] k8[j, d]) * ks[j] * (1 / sqrt(D))   in f32
//   s[j] = -1e30 where j > pos[b, w]
//   p    = exp(s - max s) / sum exp(s - max s)            exact softmax in f32
//   out  = sum_j (p[j] * vs[j]) v8[j, :]                   in f32, stored in q's dtype
//
// so positions past pos are masked before the softmax; when pos < 0 every
// score is -1e30 and the softmax is uniform over all L positions, as in the
// reference. A position past pos contributes exp(-1e30 - max) = 0 exactly
// in f32, so the kernel stops reading at pos + 1 (at L when pos >= L - 1 or
// pos < 0): skipped positions equal masked ones.
//
// What bounds it on an H100: the bytes. Two int8 rows and two f32 scales
// per position up to pos, against 4 D operations per position per query;
// at the LM's decode shape (B 8, H 12, L 640, D 64) one call reads ~8.4 MB,
// ~2.5 us at 3.35 TB/s.
//
// Design: the simple version. One CTA of 256 threads per (b, h), holding all
// W queries of the row so that they share one read of the cache:
//
//   0. pos[b, w] and q[b, w, h, :] (as f32) into shared memory;
//   1. scores: lanes in groups of D/16 (rounded up to a power of two) read
//      one 16-byte vector of a key row each, four rows in flight per group;
//      each lane dots its 16 values with each query, the group sums by warp
//      shuffles, and the scaled, masked score goes to shared memory (W x L
//      f32);
//   2. softmax per query: block max, exp, block sum, then p / sum * vs in
//      place (division rounded as IEEE, exp by the fast unit: __expf);
//   3. values: the same row mapping over v8, each lane accumulating p * v
//      for up to 8 queries at a time in registers, then a fixed-order
//      reduction over groups (warp shuffles, then the 8 warps in shared
//      memory).
//
// All sums run in a fixed order: two calls on the same inputs are bit-equal.
// Split-K over L (flash-decoding), reading pages through the page table
// instead of a gathered view, and fusing the quantising cache write are
// later levers.
//
// Takes q in bf16, fp16 or f32 with unit stride on D; k8/v8 int8 with unit
// stride on D and 16-byte aligned rows; f32 scales and an int32 pos (a
// pointer with (b, w) strides, or one scalar for every row) with any
// strides; D a multiple of 16 up to 256. The wrapper
// (ops/decode_attention.py) checks all of it.
//
// Plain C interface, loaded with ctypes (ops/decode_attention_cuda.py). The
// entry point launches on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsInFlight = 4;  // key/value rows a group loads before using them
constexpr int kMaxHeadDim = 256;
constexpr float kNegInf = -1e30f;  // the reference's mask value

struct Params {
  const void* q;
  const int8_t* k8;
  const float* ks;
  const int8_t* v8;
  const float* vs;
  const int* pos;  // null: every row uses pos_scalar
  int pos_scalar;
  void* out;
  // strides in elements: q, k8, ks, v8, vs, out over (b, w or l, h); pos over (b, w)
  long long sq_b, sq_w, sq_h;
  long long sk_b, sk_l, sk_h;
  long long sks_b, sks_l, sks_h;
  long long sv_b, sv_l, sv_h;
  long long svs_b, svs_l, svs_h;
  long long sp_b, sp_w;
  long long so_b, so_w, so_h;
  int b, w, h, l, d;
  float inv_sqrt_d;
};

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
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }

__device__ __forceinline__ void int8x16_to_f32(const int4& v, float f[16]) {
  const int words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      f[4 * i + j] = static_cast<float>(static_cast<int8_t>((words[i] >> (8 * j)) & 0xff));
    }
  }
}

// Block-wide max or sum in a fixed order; `red` holds kWarps floats. Every
// thread gets the result.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float x, float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, off);
    x = kMax ? fmaxf(x, y) : x + y;
  }
  __syncthreads();  // red may still be read from the previous reduction
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) x = kMax ? fmaxf(x, red[i]) : x + red[i];
  return x;
}

// Dynamic shared memory: q (W x D), scores then p (W x L), the value
// reduction (kWarps x kChunk x D), the block reduction (kWarps), all f32;
// then pos and the row count of each query (W int each).
template <typename T, int kChunk>
__global__ void __launch_bounds__(kThreads) decode_attn(const Params p) {
  extern __shared__ float smem[];
  const int W = p.w, L = p.l, D = p.d;
  float* q_s = smem;
  float* s_s = q_s + W * D;
  float* acc_s = s_s + static_cast<long long>(W) * L;
  float* red_s = acc_s + kWarps * kChunk * D;
  int* pos_s = reinterpret_cast<int*>(red_s + kWarps);
  int* n_s = pos_s + W;

  const int b = blockIdx.x / p.h, h = blockIdx.x % p.h;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int groups16 = D / 16;  // 16-byte vectors in a row
  int gp = 1;                   // lanes a row, a power of two >= groups16
  while (gp < groups16) gp <<= 1;
  const int c = t % gp, g = t / gp, n_groups = kThreads / gp;
  const bool lane_on = c < groups16;

  // 0. positions, row counts and queries
  for (int w = t; w < W; w += kThreads) {
    const int pos = p.pos ? p.pos[b * p.sp_b + w * p.sp_w] : p.pos_scalar;
    pos_s[w] = pos;
    n_s[w] = (pos < 0 || pos >= L) ? L : pos + 1;
  }
  const T* q = static_cast<const T*>(p.q) + b * p.sq_b + h * p.sq_h;
  for (int i = t; i < W * D; i += kThreads) {
    q_s[i] = to_f32<T>(q[(i / D) * p.sq_w + i % D]);
  }
  __syncthreads();
  int n_max = 0;
  for (int w = 0; w < W; ++w) n_max = max(n_max, n_s[w]);

  // 1. scores
  const int8_t* k8 = p.k8 + b * p.sk_b + h * p.sk_h + c * 16;
  const float* ks = p.ks + b * p.sks_b + h * p.sks_h;
  for (int j0 = 0; j0 < n_max; j0 += n_groups * kRowsInFlight) {
    int4 kv[kRowsInFlight];
    float kscale[kRowsInFlight];
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      const int j = j0 + u * n_groups + g;
      const bool on = j < n_max;
      kv[u] = (on && lane_on) ? __ldg(reinterpret_cast<const int4*>(k8 + j * p.sk_l))
                              : make_int4(0, 0, 0, 0);
      kscale[u] = (on && c == 0) ? __ldg(ks + j * p.sks_l) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      const int j = j0 + u * n_groups + g;
      float kf[16];
      int8x16_to_f32(kv[u], kf);
      for (int w = 0; w < W; ++w) {
        float s = 0.f;
        if (lane_on) {
          const float* qw = q_s + w * D + c * 16;
#pragma unroll
          for (int i = 0; i < 16; ++i) s = fmaf(kf[i], qw[i], s);
        }
        for (int off = gp / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        if (c == 0 && j < n_max) {
          const float score = s * kscale[u] * p.inv_sqrt_d;
          s_s[w * L + j] = j <= pos_s[w] ? score : kNegInf;
        }
      }
    }
  }
  __syncthreads();

  // 2. softmax of each query's scores, times the value scales, in place
  const float* vs = p.vs + b * p.svs_b + h * p.svs_h;
  for (int w = 0; w < W; ++w) {
    float* s = s_s + w * L;
    float m = -FLT_MAX;
    for (int j = t; j < n_max; j += kThreads) m = fmaxf(m, s[j]);
    m = block_reduce<true>(m, red_s);
    float sum = 0.f;
    for (int j = t; j < n_max; j += kThreads) {
      const float e = __expf(s[j] - m);
      s[j] = e;
      sum += e;
    }
    sum = block_reduce<false>(sum, red_s);
    for (int j = t; j < n_max; j += kThreads) s[j] = __fdiv_rn(s[j], sum) * __ldg(vs + j * p.svs_l);
  }
  __syncthreads();

  // 3. out = sum_j p[j] v8[j, :], up to kChunk queries a pass over the values
  const int8_t* v8 = p.v8 + b * p.sv_b + h * p.sv_h + c * 16;
  T* out = static_cast<T*>(p.out) + b * p.so_b + h * p.so_h;
  for (int w0 = 0; w0 < W; w0 += kChunk) {
    const int nw = min(kChunk, W - w0);
    int n = 0;
    for (int w = 0; w < nw; ++w) n = max(n, n_s[w0 + w]);
    float acc[kChunk][16];
#pragma unroll
    for (int w = 0; w < kChunk; ++w) {
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[w][i] = 0.f;
    }
    for (int j0 = 0; j0 < n; j0 += n_groups * kRowsInFlight) {
      int4 vv[kRowsInFlight];
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) {
        const int j = j0 + u * n_groups + g;
        vv[u] = (j < n && lane_on) ? __ldg(reinterpret_cast<const int4*>(v8 + j * p.sv_l))
                                   : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) {
        const int j = j0 + u * n_groups + g;
        if (j >= n) continue;
        float vf[16];
        int8x16_to_f32(vv[u], vf);
#pragma unroll
        for (int w = 0; w < kChunk; ++w) {
          if (w < nw) {
            const float pj = s_s[(w0 + w) * L + j];
#pragma unroll
            for (int i = 0; i < 16; ++i) acc[w][i] = fmaf(pj, vf[i], acc[w][i]);
          }
        }
      }
    }
    // the groups of a warp: lanes c, c + gp, c + 2 gp, ... hold the same dims
#pragma unroll
    for (int w = 0; w < kChunk; ++w) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        for (int off = gp; off < 32; off <<= 1) acc[w][i] += __shfl_xor_sync(0xffffffffu, acc[w][i], off);
      }
    }
    if (lane < gp && lane_on) {
#pragma unroll
      for (int w = 0; w < kChunk; ++w) {
        if (w < nw) {
#pragma unroll
          for (int i = 0; i < 16; ++i) acc_s[(warp * kChunk + w) * D + c * 16 + i] = acc[w][i];
        }
      }
    }
    __syncthreads();
    for (int i = t; i < nw * D; i += kThreads) {
      const int w = i / D, d = i % D;
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) sum += acc_s[(k * kChunk + w) * D + d];
      out[(w0 + w) * p.so_w + d] = from_f32<T>(sum);
    }
    __syncthreads();
  }
}

__host__ __device__ constexpr int chunk_for(int w) { return w >= 8 ? 8 : w >= 4 ? 4 : w >= 2 ? 2 : 1; }

}  // namespace

extern "C" {

// Dynamic shared memory one launch needs, in bytes (the wrapper checks it
// against the card's 227 KB before launching).
long long tk8s_decode_attn_smem_bytes(int w, int l, int d) {
  return 4LL * (static_cast<long long>(w) * d + static_cast<long long>(w) * l +
                static_cast<long long>(kWarps) * chunk_for(w) * d + kWarps) +
         8LL * w;
}

// dtype 0 = bf16, 1 = fp16, 2 = f32 (q and out). `strides` holds 20 values:
// q (b, w, h), k8 (b, l, h), k scale (b, l, h), v8 (b, l, h), v scale
// (b, l, h), pos (b, w), out (b, w, h), in elements. `pos` may be null, and
// then every row reads `pos_scalar`.
int tk8s_decode_attn_int8(int dtype, const void* q, const int8_t* k8, const float* ks,
                          const int8_t* v8, const float* vs, const int* pos, int pos_scalar,
                          void* out, const long long* strides, int b, int w, int h, int l, int d,
                          float inv_sqrt_d, void* stream) {
  if (b <= 0 || w <= 0 || h <= 0 || l <= 0 || d <= 0 || d % 16 || d > kMaxHeadDim ||
      static_cast<long long>(b) * h > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  const long long* s = strides;
  const Params prm = {q, k8, ks, v8, vs, pos, pos_scalar, out,
                      s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9],
                      s[10], s[11], s[12], s[13], s[14], s[15], s[16], s[17], s[18], s[19],
                      b, w, h, l, d, inv_sqrt_d};
  const long long smem = tk8s_decode_attn_smem_bytes(w, l, d);
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunk = chunk_for(w);
  const int grid = b * h;

#define TK8S_LAUNCH(T, C)                                                                     \
  do {                                                                                        \
    if (smem > 48 * 1024) {                                                                   \
      const cudaError_t e = cudaFuncSetAttribute(decode_attn<T, C>,                          \
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, \
                                                 static_cast<int>(smem));                     \
      if (e != cudaSuccess) return e;                                                         \
    }                                                                                         \
    decode_attn<T, C><<<grid, kThreads, smem, st>>>(prm);                                     \
  } while (0)
#define TK8S_DISPATCH(T)                    \
  do {                                      \
    if (chunk == 1) TK8S_LAUNCH(T, 1);      \
    else if (chunk == 2) TK8S_LAUNCH(T, 2); \
    else if (chunk == 4) TK8S_LAUNCH(T, 4); \
    else TK8S_LAUNCH(T, 8);                 \
  } while (0)

  if (dtype == 0) TK8S_DISPATCH(__nv_bfloat16);
  else if (dtype == 1) TK8S_DISPATCH(__half);
  else if (dtype == 2) TK8S_DISPATCH(float);
  else return cudaErrorInvalidValue;
#undef TK8S_DISPATCH
#undef TK8S_LAUNCH
  return cudaGetLastError();
}

const char* tk8s_decode_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

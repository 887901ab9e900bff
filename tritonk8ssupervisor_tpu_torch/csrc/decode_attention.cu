// K3 on Hopper: decode attention over an int8 KV cache, for sm_90a.
//
// Replaces tritonk8ssupervisor_tpu/ops/decode_attention.py::_kernel (:58,
// the Pallas kernel behind `decode_attention_int8`). For each batch row b,
// head h and query w of a window of W queries (W = 1 for a decode step),
// with int8 keys and values k8, v8 and their per-(token, head) f32 scales
// ks, vs:
//
//   s[j] = (sum_d q[d] k8[j, d]) * ks[j] * (1 / sqrt(D))   in f32
//   s[j] = -1e30 where j > pos[b, w]
//   p    = exp(s - max s) / sum exp(s - max s)            exact softmax in f32
//   out  = sum_j (p[j] * vs[j]) v8[j, :]                   in f32, stored in q's dtype
//
// so positions past pos are masked before the softmax; when pos < 0 every
// score is -1e30 and the softmax is uniform over all L positions, as in the
// reference. A position past pos contributes exp(-1e30 - max) = 0 exactly
// in f32, so a row reads only [0, n) with n = pos + 1 (n = L when pos < 0
// or pos >= L): skipped positions equal masked ones.
//
// The cache is dense (row b's position j at b * s_b + j * s_l) or paged:
// position j of row b lies on page tables[b, j / page_size] at offset
// j % page_size of a (P, page_size, H, D) pool, which is how the serving
// engine keeps it. Reading the pages here replaces the engine's gather of
// each slot's logical view.
//
// What bounds it on an H100: bytes and latency, not operations. Two int8
// rows and two f32 scales a position against 4 D operations a position a
// query, with W <= 9 on every path: ~10 operations a byte, far below the
// ~295 at which the tensor cores would matter, so they are not used. At
// the LM's decode shape (B 8, H 12, L 640, D 64) one call reads ~8.4 MB,
// ~2.5 us at 3.35 TB/s. The design puts the whole card's memory
// parallelism on that read and takes the serial phases out of each CTA:
//
// 1. Split-K over positions (flash-decoding). [0, L) is cut into chunks of
//    C = 64 positions whose boundaries sit at multiples of C, whatever W
//    and the other queries' positions are. Each (b, h, chunk) is one CTA
//    of 128 threads; a chunk past its row's largest n exits at once. The
//    host sizes the grid from L, or from pos when it is a Python int; it
//    never reads a device pos.
// 2. One DRAM round trip a chunk. The CTA issues all of the chunk's K and
//    V rows (16-byte cp.async, one copy a row, so a page run never crosses
//    a page) and both scale vectors (4-byte cp.async) before it waits:
//    V does not depend on the softmax. Then everything runs from shared
//    memory, for up to 8 queries a pass (a longer window takes more
//    passes over the same chunk). int8 becomes f32 by a byte permute and
//    one subtraction (exact), which spares the card's quarter-rate
//    integer-to-float conversions.
// 3. A partial result per (query, chunk) in f32: the chunk's max m_c, the
//    sum l_c of exp(s - m_c), and o_c = sum exp(s - m_c) * vs * v over D,
//    in the reference's order of scaling (scores scaled by ks and 1/sqrt(D)
//    and masked to -1e30 before the max; the V scale folded into p). A row
//    with one chunk writes o_c / l_c, which is what the combine of one
//    chunk gives, and is done.
// 4. The last CTA of each (b, h) to finish, found with a counter that the
//    wrapper keeps zeroed (an acquire-release atomic add after a barrier;
//    the last one resets it), combines the chunks of each query of the
//    row: M = max m_c, then l and o as sums of exp(m_c - M) * (l_c, o_c),
//    each over a fixed partition of the chunks met in a fixed tree, and
//    out = o / l (IEEE division); a warp a query up to 32 chunks, the CTA
//    beyond. A query reads only the chunks [0, ceil(n / C)) of its own n.
//    One launch a call. At decode lengths the chain of dependent round
//    trips (the chunk from DRAM, the counter, the partials in L2), not the
//    bytes, sets the time.
//
// A query's result depends on nothing but its own pos and the cache:
// chunk boundaries are fixed, every sum runs over a fixed tree of C slots
// (an absent or masked slot adds an exact zero), and the combine order is
// fixed. So a query gives the same bits alone (W = 1) as inside a verify
// window, in the dense and the paged layout, and two calls are bit-equal.
// When every score of a query is masked, every m_c is -1e30 and
// exp(m_c - M) = 1, which gives the uniform softmax over all L; the mask
// value stays -1e30, not -inf, whose rescale would be exp(-inf + inf).
//
// Shared memory holds one chunk, not the scores of all positions, so L is
// limited only by int32 positions. Takes q in bf16, fp16 or f32 with unit
// stride on D; k8/v8 int8 with unit stride on D and 16-byte aligned rows;
// f32 scales, an int32 pos (a pointer with (b, w) strides, or one scalar
// for every row) and int32 page tables, with any strides; D a multiple of
// 16 up to 256. The wrapper (ops/decode_attention.py) checks all of it,
// allocates the f32 scratch of the partial results and keeps the
// counters.
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

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;  // positions a chunk (a CTA)
constexpr int kGroup = 8;   // queries a pass over a chunk in shared memory
constexpr int kMaxHeadDim = 256;
constexpr int kStrides = 26;
constexpr float kNegInf = -1e30f;  // the reference's mask value

struct Params {
  const void* q;
  const int8_t* k8;
  const float* ks;
  const int8_t* v8;
  const float* vs;
  const int* tables;  // null: the dense layout
  const int* pos;     // null: every row uses pos_scalar
  int pos_scalar;
  int page_size;
  void* out;
  float* part_o;    // (B, H, W, n_chunks, D) f32
  float2* part_ml;  // (B, H, W, n_chunks): (m_c, l_c)
  int* counters;    // (B, H), zero before and after a launch
  // strides in elements: q (b, w, h); k8, ks, v8, vs (b, page, l, h);
  // tables (b, column); pos (b, w); out (b, w, h)
  long long sq_b, sq_w, sq_h;
  long long sk_b, sk_p, sk_l, sk_h;
  long long sks_b, sks_p, sks_l, sks_h;
  long long sv_b, sv_p, sv_l, sv_h;
  long long svs_b, svs_p, svs_l, svs_h;
  long long st_b, st_c;
  long long sp_b, sp_w;
  long long so_b, so_w, so_h;
  int b, w, h, l, d;
  int n_chunks;
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

// The four int8 values of a 32-bit word, low byte first, as exact f32:
// byte ^ 0x80 is the value + 128 unsigned; 0x4B000000 | u is the float
// 2^23 + u; less 2^23 + 128 it is the value.
__device__ __forceinline__ void int8x4_to_f32(int word, float f[4]) {
  const unsigned u = static_cast<unsigned>(word) ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[i] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | i)), 8388736.f);
  }
}

// positions a query reads: [0, pos], all L when pos < 0 or pos >= L
__host__ __device__ __forceinline__ int row_len(int pos, int L) { return (pos < 0 || pos >= L) ? L : pos + 1; }

__device__ __forceinline__ int query_pos(const Params& p, int b, int w) {
  return p.pos ? p.pos[b * p.sp_b + w * p.sp_w] : p.pos_scalar;
}

__host__ __device__ constexpr int pow2_at_least(int x) {
  int y = 1;
  while (y < x) y <<= 1;
  return y;
}

// Row stride of a chunk's K and V rows in shared memory: D + 16 bytes, so
// that neighbouring rows start on other banks.
__host__ __device__ constexpr int smem_row(int d) { return d + 16; }

// Dynamic shared memory of a CTA, in bytes: K and V rows (C rows of D + 16
// bytes each), their scales (C f32 each), q and the scores of a group of
// up to g = min(W, kGroup) queries (g x D and g x C f32), the value
// reduction (g x 128 x 4 f32, which the combine reuses) and the group's
// positions (g int).
__host__ __device__ constexpr int group_of(int w) { return w < kGroup ? w : kGroup; }
__host__ __device__ constexpr long long smem_bytes(int c, int d, int w) {
  return 2LL * c * smem_row(d) + 8LL * c + 4LL * group_of(w) * (d + c) +
         16LL * group_of(w) * kThreads + 4LL * group_of(w);
}

// Block-wide max or sum in a fixed order (warp shuffles, then the warps in
// index order); `red` holds kWarps floats. Every thread gets the result.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float x, float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, off);
    x = kMax ? fmaxf(x, y) : __fadd_rn(x, y);
  }
  __syncthreads();  // red may still be read from the previous reduction
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) x = kMax ? fmaxf(x, red[i]) : __fadd_rn(x, red[i]);
  return x;
}

// The partials of one query's chunks in global memory, read past L1
// (ld.global.cg): other CTAs wrote them.
struct GlobalPartials {
  const float2* ml;  // (m_c, l_c) of chunk c at ml[c]
  const float4* o;   // float4 group g of o_c at o[c * groups + g]
  int groups;
  __device__ float2 ml_at(int c) const { return __ldcg(ml + c); }
  __device__ float4 o_at(int c, int g) const { return __ldcg(o + c * groups + g); }
};

// The combine of one query from at most 32 chunks by one warp, with no
// block barrier: lane c holds (m_c, l_c); M and l meet in a fixed shuffle
// tree; for o, lane (s, g) of slices = 32 / (D / 4) (at least 1) sums
// the float4 group g of the chunks c = s (mod slices) in turn, and the
// slices meet in order. A lane's first kPrefetch terms of o are loaded
// together with (m_c, l_c), so a short row takes one round trip to L2.
// `f_s` holds 32 floats and `o_s` 128, the warp's own.
constexpr int kPrefetch = 6;

template <typename T>
__device__ void combine_warp(const Params& p, int b, int h, int w, int nc,
                             const GlobalPartials& src, float* f_s, float* o_s) {
  const int D = p.d, lane = threadIdx.x % 32;
  const int groups = D / 4;
  const int slices = groups < 32 ? 32 / groups : 1;
  const int sl = lane / groups, g0 = lane % groups;
  const bool on = sl < slices;
  float4 pre[kPrefetch];
#pragma unroll
  for (int k = 0; k < kPrefetch; ++k) {
    const int c = sl + k * slices;
    pre[k] = on && c < nc ? src.o_at(c, g0) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float2 e = lane < nc ? src.ml_at(lane) : make_float2(-FLT_MAX, 0.f);
  float m = e.x;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  const float f = lane < nc ? __expf(__fsub_rn(e.x, m)) : 0.f;
  float l = __fmul_rn(f, e.y);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) l = __fadd_rn(l, __shfl_xor_sync(0xffffffffu, l, off));
  f_s[lane] = f;
  __syncwarp();
  T* out = static_cast<T*>(p.out) + b * p.so_b + w * p.so_w + h * p.so_h;
  for (int g = g0; g < groups; g += 32) {  // more than one pass only when D > 128
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    if (on) {
      int c = sl;
#pragma unroll
      for (int k = 0; k < kPrefetch; ++k, c += slices) {
        if (c < nc) {
          const float4 v = g == g0 ? pre[k] : src.o_at(c, g);
          const float fc = f_s[c];
          o = make_float4(__fmaf_rn(fc, v.x, o.x), __fmaf_rn(fc, v.y, o.y),
                          __fmaf_rn(fc, v.z, o.z), __fmaf_rn(fc, v.w, o.w));
        }
      }
      for (; c < nc; c += slices) {
        const float4 v = src.o_at(c, g);
        const float fc = f_s[c];
        o = make_float4(__fmaf_rn(fc, v.x, o.x), __fmaf_rn(fc, v.y, o.y), __fmaf_rn(fc, v.z, o.z),
                        __fmaf_rn(fc, v.w, o.w));
      }
    }
    if (slices > 1) {  // then groups < 32: one pass for every lane
      if (on) reinterpret_cast<float4*>(o_s)[lane] = o;
      __syncwarp();
      if (lane < groups) {
        o = reinterpret_cast<const float4*>(o_s)[lane];
        for (int k = 1; k < slices; ++k) {
          const float4 v = reinterpret_cast<const float4*>(o_s)[k * groups + lane];
          o = make_float4(__fadd_rn(o.x, v.x), __fadd_rn(o.y, v.y), __fadd_rn(o.z, v.z),
                          __fadd_rn(o.w, v.w));
        }
      }
    }
    if (lane < groups || slices == 1) {
      out[4 * g] = from_f32<T>(__fdiv_rn(o.x, l));
      out[4 * g + 1] = from_f32<T>(__fdiv_rn(o.y, l));
      out[4 * g + 2] = from_f32<T>(__fdiv_rn(o.z, l));
      out[4 * g + 3] = from_f32<T>(__fdiv_rn(o.w, l));
    }
  }
  __syncwarp();  // f_s and o_s are free again
}

// The combine of one query from more than 32 chunks (global partials) by
// the whole CTA, in a fixed order: thread t takes chunks t, t + 128, ...
// for M and l; for o, thread (s, g) of slices = 128 / (D / 4) sums the
// float4 group g of the chunks c = s (mod slices) in turn, and the slices
// meet in order. exp(m_c - M) is kept in `f_s` for the first `f_cap`
// chunks; `red` holds 512 floats.
template <typename T>
__device__ void combine_block(const Params& p, int b, int h, int w, int nc,
                              const GlobalPartials& src, float* red, float* f_s, int f_cap) {
  const int D = p.d, t = threadIdx.x;
  const int groups = D / 4, slices = kThreads / groups;  // D <= 256: at least 2 slices
  const int sl = t / groups, g0 = t % groups;
  float m = -FLT_MAX;
  for (int c = t; c < nc; c += kThreads) m = fmaxf(m, src.ml_at(c).x);
  m = block_reduce<true>(m, red);
  float l = 0.f;
  for (int c = t; c < nc; c += kThreads) {
    const float2 e = src.ml_at(c);
    const float f = __expf(__fsub_rn(e.x, m));
    if (c < f_cap) f_s[c] = f;
    l = __fmaf_rn(f, e.y, l);
  }
  l = block_reduce<false>(l, red);  // its barriers also publish f_s
  __syncthreads();                  // every thread has read red
  if (sl < slices) {
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int c = sl; c < nc; c += slices) {
      const float4 v = src.o_at(c, g0);
      const float fc = c < f_cap ? f_s[c] : __expf(__fsub_rn(src.ml_at(c).x, m));
      o = make_float4(__fmaf_rn(fc, v.x, o.x), __fmaf_rn(fc, v.y, o.y), __fmaf_rn(fc, v.z, o.z),
                      __fmaf_rn(fc, v.w, o.w));
    }
    reinterpret_cast<float4*>(red)[sl * groups + g0] = o;
  }
  __syncthreads();
  T* out = static_cast<T*>(p.out) + b * p.so_b + w * p.so_w + h * p.so_h;
  for (int g = t; g < groups; g += kThreads) {
    float4 o = reinterpret_cast<const float4*>(red)[g];
    for (int k = 1; k < slices; ++k) {
      const float4 v = reinterpret_cast<const float4*>(red)[k * groups + g];
      o = make_float4(__fadd_rn(o.x, v.x), __fadd_rn(o.y, v.y), __fadd_rn(o.z, v.z),
                      __fadd_rn(o.w, v.w));
    }
    out[4 * g] = from_f32<T>(__fdiv_rn(o.x, l));
    out[4 * g + 1] = from_f32<T>(__fdiv_rn(o.y, l));
    out[4 * g + 2] = from_f32<T>(__fdiv_rn(o.z, l));
    out[4 * g + 3] = from_f32<T>(__fdiv_rn(o.w, l));
  }
  __syncthreads();  // red and f_s are free again
}

// One CTA per (b, h, chunk): the chunk's partial results for every query
// of the row, and for the last CTA of the row to finish, their combine.
// kC positions a chunk (kThreads / kC threads a position for the scores);
// kG queries a pass (1 for W = 1, else kGroup). Every query's arithmetic
// is the same code in every instance, so the bits do not depend on them.
template <typename T, int kC, int kG>
__global__ void __launch_bounds__(kThreads, kG == 1 ? 8 : 4) decode_attn(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last_s;
  __shared__ long long page_s[kC];  // the chunk's page ids (paged layout)
  __shared__ float m_s[kG], l_s[kG];        // the chunk's m and l of each query of a group
  __shared__ float wmax_s[kG][kWarps], wsum_s[kG][kWarps];  // each warp's max and sum
  __shared__ __align__(16) float cmb_s[kWarps][32 + 128];  // each warp's combine scratch
  const int W = p.w, L = p.l, D = p.d, H = p.h;
  const int rs = smem_row(D);
  const int gw = group_of(W);
  int8_t* k_s = reinterpret_cast<int8_t*>(smem);
  int8_t* v_s = k_s + kC * rs;
  float* ks_s = reinterpret_cast<float*>(v_s + kC * rs);
  float* vs_s = ks_s + kC;
  float* q_s = vs_s + kC;
  float* s_s = q_s + gw * D;
  float* red_s = s_s + gw * kC;
  int* pos_s = reinterpret_cast<int*>(red_s + gw * 4 * kThreads);

  const long long blk = blockIdx.x;
  const int c = static_cast<int>(blk % p.n_chunks);
  const int bh = static_cast<int>(blk / p.n_chunks);
  const int b = bh / H, h = bh % H;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;

  // the chunk's page ids and the row's largest n, read together (every
  // thread reads the W positions); the chunks past n hold nothing any
  // query reads
  const int j0 = c * kC;
  if (p.tables && t < kC && j0 + t < L) {
    page_s[t] = p.tables[b * p.st_b + ((j0 + t) / p.page_size) * p.st_c];
  }
  int n_row = 0;
  for (int w = 0; w < W; ++w) n_row = max(n_row, row_len(query_pos(p, b, w), L));
  if (j0 >= n_row) return;
  const int cnt = min(kC, n_row - j0);  // positions present in this chunk
  const bool single = n_row <= kC;      // the row's only chunk: no combine
  if (p.tables) __syncthreads();

  // all of the chunk's bytes in flight at once: K and V rows, then scales
  const int vecs = D / 16;
  const int8_t* k8 = p.k8 + h * p.sk_h;
  const int8_t* v8 = p.v8 + h * p.sv_h;
  // thread t copies 16-byte vector u of rows j, j + kThreads / vecs, ...
  // when vecs divides kThreads (D = 16, 32, 64, 128, 256), else walks i
  const bool even = kThreads % vecs == 0;
  const int rows_step = even ? kThreads / vecs : 0;
  for (int i = t, j = t / vecs, u = t % vecs; i < cnt * vecs;
       i += kThreads, j = even ? j + rows_step : i / vecs, u = even ? u : i % vecs) {
    const int pj = j0 + j;
    long long ko, vo;
    if (p.tables) {
      const long long page = page_s[j];
      const int off = pj % p.page_size;
      ko = page * p.sk_p + off * p.sk_l;
      vo = page * p.sv_p + off * p.sv_l;
    } else {
      ko = b * p.sk_b + pj * p.sk_l;
      vo = b * p.sv_b + pj * p.sv_l;
    }
    cp_async16(k_s + j * rs + u * 16, k8 + ko + u * 16);
    cp_async16(v_s + j * rs + u * 16, v8 + vo + u * 16);
  }
  const float* ks = p.ks + h * p.sks_h;
  const float* vs = p.vs + h * p.svs_h;
  for (int j = t; j < cnt; j += kThreads) {
    const int pj = j0 + j;
    long long kso, vso;
    if (p.tables) {
      const long long page = page_s[j];
      const int off = pj % p.page_size;
      kso = page * p.sks_p + off * p.sks_l;
      vso = page * p.svs_p + off * p.svs_l;
    } else {
      kso = b * p.sks_b + pj * p.sks_l;
      vso = b * p.svs_b + pj * p.svs_l;
    }
    cp_async4(ks_s + j, ks + kso);
    cp_async4(vs_s + j, vs + vso);
  }

  const T* q = static_cast<const T*>(p.q) + b * p.sq_b + h * p.sq_h;
  constexpr int G = kThreads / kC;  // threads a position for the scores
  const int js = t / G, part = t % G;
  const int lanes = pow2_at_least(D / 4);  // threads a value row, 4 dims each
  const int pg = kThreads / lanes;         // position groups for the values
  const int r = t % lanes, g = t / lanes;
  const bool r_on = r < D / 4;

  for (int w0 = 0; w0 < W; w0 += kG) {
    const int nw = min(kG, W - w0);
    if (w0) __syncthreads();  // the previous group is done with q_s, s_s, red_s
    for (int i = t; i < nw * D; i += kThreads) {
      q_s[i] = to_f32<T>(q[(w0 + i / D) * p.sq_w + i % D]);
    }
    for (int i = t; i < nw; i += kThreads) pos_s[i] = query_pos(p, b, w0 + i);
    if (!w0) cp_async_wait_all();
    __syncthreads();

    // scores and the chunk's softmax terms. G threads a position, D / G
    // dims each, in 8-byte runs (every thread computes: the shuffles need
    // the whole warp). The chunk's max m_c meets over the warps; then
    // exp(s - m_c) * vs replaces the score, and each warp's sum of
    // exp(s - m_c) goes to wsum_s (l_c adds them up in warp order).
    float sc[kG];
    {
      const int dims = D / G;
      const int8_t* krow = k_s + js * rs + part * dims;
      const float kscale = ks_s[js];
#pragma unroll
      for (int wi = 0; wi < kG; ++wi) {
        if (wi < nw) {
          const float* qw = q_s + wi * D + part * dims;
          float dot = 0.f;
          for (int e = 0; e < dims; e += 8) {
            const int2 kv = *reinterpret_cast<const int2*>(krow + e);
            const float4 qa = *reinterpret_cast<const float4*>(qw + e);
            const float4 qb = *reinterpret_cast<const float4*>(qw + e + 4);
            float kf[8];
            int8x4_to_f32(kv.x, kf);
            int8x4_to_f32(kv.y, kf + 4);
            dot = __fmaf_rn(kf[0], qa.x, dot);
            dot = __fmaf_rn(kf[1], qa.y, dot);
            dot = __fmaf_rn(kf[2], qa.z, dot);
            dot = __fmaf_rn(kf[3], qa.w, dot);
            dot = __fmaf_rn(kf[4], qb.x, dot);
            dot = __fmaf_rn(kf[5], qb.y, dot);
            dot = __fmaf_rn(kf[6], qb.z, dot);
            dot = __fmaf_rn(kf[7], qb.w, dot);
          }
#pragma unroll
          for (int off = G / 2; off > 0; off >>= 1) dot = __fadd_rn(dot, __shfl_xor_sync(0xffffffffu, dot, off));
          const float score = __fmul_rn(__fmul_rn(dot, kscale), p.inv_sqrt_d);
          // an absent position takes no part in the max
          sc[wi] = js >= cnt ? -FLT_MAX : j0 + js <= pos_s[wi] ? score : kNegInf;
          float m = sc[wi];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
          if (lane == 0) wmax_s[wi][warp] = m;
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int wi = 0; wi < kG; ++wi) {
      if (wi < nw) {
        float m = wmax_s[wi][0];
#pragma unroll
        for (int k = 1; k < kWarps; ++k) m = fmaxf(m, wmax_s[wi][k]);
        const float e = js < cnt ? __expf(__fsub_rn(sc[wi], m)) : 0.f;
        if (part == 0) s_s[wi * kC + js] = js < cnt ? __fmul_rn(e, vs_s[js]) : 0.f;
        float l = part == 0 ? e : 0.f;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) l = __fadd_rn(l, __shfl_xor_sync(0xffffffffu, l, off));
        if (lane == 0) wsum_s[wi][warp] = l;
        if (t == 0) m_s[wi] = m;
      }
    }
    __syncthreads();
    if (t < nw) {
      float l = wsum_s[t][0];
#pragma unroll
      for (int k = 1; k < kWarps; ++k) l = __fadd_rn(l, wsum_s[t][k]);
      l_s[t] = l;
      if (!single) {
        const long long idx = ((static_cast<long long>(bh) * W + w0 + t) * p.n_chunks + c);
        p.part_ml[idx] = make_float2(m_s[t], l);
      }
    }

    // values: `lanes` threads a row, 4 dims each; position group g takes
    // positions g, g + pg, g + 2 pg, ... of the chunk
    float acc[kG][4];
#pragma unroll
    for (int wi = 0; wi < kG; ++wi) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[wi][i] = 0.f;
    }
    if (r_on) {
      for (int j = g; j < cnt; j += pg) {
        float vf[4];
        int8x4_to_f32(*reinterpret_cast<const int*>(v_s + j * rs + 4 * r), vf);
#pragma unroll
        for (int wi = 0; wi < kG; ++wi) {
          if (wi < nw) {
            const float pj = s_s[wi * kC + j];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[wi][i] = __fmaf_rn(pj, vf[i], acc[wi][i]);
          }
        }
      }
#pragma unroll
      for (int wi = 0; wi < kG; ++wi) {
        if (wi < nw) {
          *reinterpret_cast<float4*>(red_s + (wi * pg + g) * D + 4 * r) =
              make_float4(acc[wi][0], acc[wi][1], acc[wi][2], acc[wi][3]);
        }
      }
    }
    __syncthreads();
    for (int i = t; i < nw * D; i += kThreads) {
      const int wi = i / D, d = i % D;
      float o = 0.f;
      for (int k = 0; k < pg; ++k) o = __fadd_rn(o, red_s[(wi * pg + k) * D + d]);
      if (single) {
        // the combine of one chunk: M = m_0, l = l_0, o = o_0 exactly
        static_cast<T*>(p.out)[b * p.so_b + (w0 + wi) * p.so_w + h * p.so_h + d] =
            from_f32<T>(__fdiv_rn(o, l_s[wi]));
      } else {
        const long long idx = ((static_cast<long long>(bh) * W + w0 + wi) * p.n_chunks + c);
        p.part_o[idx * D + d] = o;
      }
    }
  }
  if (single) return;

  // the last CTA of the row to finish combines. The barrier orders every
  // thread's partials before thread 0's count, an acquire-release atomic
  // (as in a grid-wide barrier), and the last resets the counter
  __syncthreads();
  if (t == 0) {
    int done;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
                 : "=r"(done) : "l"(p.counters + bh) : "memory");
    last_s = done + 1 == (n_row + kC - 1) / kC;
    if (last_s) p.counters[bh] = 0;
  }
  __syncthreads();
  if (!last_s) return;
  // queries of at most 32 chunks a warp each, then the others by the CTA
  for (int w = warp; w < W; w += kWarps) {
    const int nc = (row_len(query_pos(p, b, w), L) + kC - 1) / kC;
    const long long idx = static_cast<long long>(bh) * W + w;
    const GlobalPartials src = {p.part_ml + idx * p.n_chunks,
                                reinterpret_cast<const float4*>(p.part_o + idx * p.n_chunks * D),
                                D / 4};
    if (nc <= 32) combine_warp<T>(p, b, h, w, nc, src, cmb_s[warp], cmb_s[warp] + 32);
  }
  for (int w = 0; w < W; ++w) {
    const int nc = (row_len(query_pos(p, b, w), L) + kC - 1) / kC;
    if (nc > 32) {
      const long long idx = static_cast<long long>(bh) * W + w;
      const GlobalPartials src = {p.part_ml + idx * p.n_chunks,
                                  reinterpret_cast<const float4*>(p.part_o + idx * p.n_chunks * D),
                                  D / 4};
      __syncthreads();
      // exp(m_c - M) of the first chunks in the spent K/V rows
      combine_block<T>(p, b, h, w, nc, src, red_s, reinterpret_cast<float*>(smem),
                       2 * kC * rs / 4);
    }
  }
}

template <typename T, int kC, int kG>
cudaError_t launch(const Params& prm, cudaStream_t st) {
  const long long smem = smem_bytes(kC, prm.d, prm.w);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_attn<T, kC, kG>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const long long grid = static_cast<long long>(prm.b) * prm.h * prm.n_chunks;
  decode_attn<T, kC, kG><<<static_cast<unsigned>(grid), kThreads, smem, st>>>(prm);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_for(const Params& prm, cudaStream_t st) {
  return prm.w == 1 ? launch<T, kChunk, 1>(prm, st) : launch<T, kChunk, kGroup>(prm, st);
}

}  // namespace

extern "C" {

// dtype 0 = bf16, 1 = fp16, 2 = f32 (q and out). `strides` holds
// `n_strides` = 26 values, in elements: q (b, w, h); k8, k scale, v8,
// v scale (b, page, l, h) each; tables (b, column); pos (b, w); out
// (b, w, h). `tables` null: the dense layout (the page strides unused);
// else the paged one (the b strides of the cache unused), with
// `page_size` positions a page. `pos` null: every row reads `pos_scalar`.
// `chunk` is kChunk = 64 positions and `n_chunks` at least
// ceil(n / chunk) for the largest n any query reads; `part_o` holds
// b * h * w * n_chunks * d f32, `part_ml` b * h * w * n_chunks pairs, and
// `counters` b * h int32 zeros, which the launch leaves zero.
int tk8s_decode_attn_int8(int dtype, const void* q, const int8_t* k8, const float* ks,
                          const int8_t* v8, const float* vs, const int* tables, int page_size,
                          const int* pos, int pos_scalar, void* out, float* part_o,
                          float* part_ml, int* counters, const long long* strides, int n_strides,
                          int b, int w, int h, int l, int d, int chunk, int n_chunks,
                          float inv_sqrt_d, void* stream) {
  if (n_strides != kStrides || b <= 0 || w <= 0 || h <= 0 || l <= 0 || d <= 0 || d % 16 ||
      d > kMaxHeadDim || chunk != kChunk || n_chunks <= 0 ||
      static_cast<long long>(n_chunks) * chunk < (pos ? l : row_len(pos_scalar, l)) ||
      (tables != nullptr && page_size <= 0) ||
      static_cast<long long>(b) * h * n_chunks > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  const long long* s = strides;
  const Params prm = {q, k8, ks, v8, vs, tables, pos, pos_scalar, page_size, out, part_o,
                      reinterpret_cast<float2*>(part_ml), counters,
                      s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11],
                      s[12], s[13], s[14], s[15], s[16], s[17], s[18], s[19], s[20], s[21], s[22],
                      s[23], s[24], s[25],
                      b, w, h, l, d, n_chunks, inv_sqrt_d};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_for<__nv_bfloat16>(prm, st);
  if (dtype == 1) return launch_for<__half>(prm, st);
  if (dtype == 2) return launch_for<float>(prm, st);
  return cudaErrorInvalidValue;
}

const char* tk8s_decode_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// K2 on Hopper: exact softmax attention, forward and backward, in the
// manner of FlashAttention-2, for sm_90a.
//
// Replaces the TPU kernels reached from
// tritonk8ssupervisor_tpu/ops/flash_attention.py: `_splash_kernel`
// (jax's splash Pallas kernel, mask-partitioned, fused dq/dk/dv backward)
// and `_tuned_library_flash` (jax's older flash Pallas kernel). Both
// compute softmax(q k^T / sqrt(d)) v, causal or full, and never write the
// (seq, seq) score matrix to device memory; so does this file.
//
// What bounds it on an H100: at the LM's shape (8, 1024, 12, 64) causal
// bf16 the forward does 12.9 GFLOP on the tensor cores (13 us at 989
// TFLOP/s) and moves ~50 MB (15 us at 3.35 TB/s); the backward does 2.5x
// the products and moves ~101 MB. So both sides matter, and the design
// keeps the scores in registers, reads every q/k/v/dO tile from device
// memory once per CTA that needs it, and skips the tiles above the causal
// diagonal (what splash's mask partition does).
//
// Design. Four __global__ functions, one CTA of four warps each, every
// product a bf16/fp16 `mma.sync.m16n8k16` with f32 accumulation:
//
//   attn_fwd        one CTA per (64-row q tile, batch*head); loops over
//                   64-row k/v tiles staged in shared memory, with a running
//                   max and a rescaled sum in f32 (online softmax). Writes O
//                   in q's dtype and the logsumexp (B, H, S) in f32.
//   attn_bwd_delta  the pre-pass D = rowsum(dO * O), f32 (B, H, S).
//   attn_bwd_dkdv   one CTA per 64-row k tile; loops over the q tiles at
//                   and below the diagonal, recomputes P^T from the saved
//                   logsumexp and accumulates dV = P^T dO, dK = dS^T Q.
//   attn_bwd_dq     one CTA per 64-row q tile; loops over the k tiles at
//                   and left of the diagonal and accumulates dQ = dS K.
//
// The backward is deterministic: no atomics, every output row is owned by
// one CTA. Each warp owns 16 rows; a score tile's mma accumulator layout is
// exactly the A-operand layout of the next product, so P and dS go from
// one product to the next in registers. Operands that the next product
// reads along the other axis (V, dO, Q, K) are also staged transposed in
// shared memory. Rows of shared tiles are padded by 8 elements so that the
// 32 lanes of a fragment load hit 32 distinct banks.
//
// The scale 1/sqrt(d) is applied to the f32 scores (the splash kernel
// folds it into bf16 q instead). q, k, v, O and dO are taken by their
// (batch, seq, head) strides with a unit head_dim stride, so the (B, S, H,
// D) and (B, H, S, D) layouts both run without a copy; a ragged last tile
// is masked. Template instances: head_dim 64 and 128, bf16 and fp16.
//
// Plain C interface, loaded with ctypes (ops/flash_attention_cuda.py).
// Each entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // four warps
constexpr int kRows = 64;      // a CTA's own rows: 16 per warp
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// strides[t] = (batch, seq, head) strides in elements of tensor t
enum Tensor { kQ, kK, kV, kO, kDO, kDQ, kDK, kDV, kTensors };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;           // written by the forward, read by the backward
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* lse;        // (B, H, S) natural-log logsumexp of the scaled scores
  float* delta;      // (B, H, S) rowsum(dO * O)
  long long strides[kTensors][3];
  int batch, heads, seq, causal;
  float scale;       // 1/sqrt(head_dim)
};

__host__ __device__ constexpr int cdiv(long long a, int b) { return (int)((a + b - 1) / b); }

template <typename T>
struct Num;

template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t x) {
    return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
  }
  static __device__ __forceinline__ void mma(float c[4], const uint32_t a[4], const uint32_t b[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

template <>
struct Num<__half> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t x) {
    return __half22float2(*reinterpret_cast<__half2*>(&x));
  }
  static __device__ __forceinline__ void mma(float c[4], const uint32_t a[4], const uint32_t b[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

template <typename T>
__device__ __forceinline__ const T* head(const Params& p, const void* base, Tensor t, int b, int h) {
  return static_cast<const T*>(base) + b * p.strides[t][0] + h * p.strides[t][2];
}

// Rows [r0, r0 + ROWS) of one head's (seq, D) slice, row stride `ld` in
// device memory, into shared memory row-major with row stride D + 8.
// Rows at or past `seq` read as zeros. 16 bytes per thread per load.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long ld, int r0, int seq) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (r0 + r < seq) x = *reinterpret_cast<const uint4*>(src + (r0 + r) * ld + c);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) = x;
  }
}

// The same rows stored transposed, dst[c][r] with row stride ROWS + 8, for
// a product that contracts over the rows. Neighbouring lanes take
// neighbouring rows, so the 2-byte stores of a warp fall in distinct banks.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_rows_t(T* dst, const T* src, long long ld, int r0, int seq) {
  constexpr int kChunks = D / 8;
  uint16_t* out = reinterpret_cast<uint16_t*>(dst);
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i % ROWS, c = (i / ROWS) * 8;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (r0 + r < seq) x = *reinterpret_cast<const uint4*>(src + (r0 + r) * ld + c);
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      out[(c + j) * (ROWS + 8) + r] = static_cast<uint16_t>(w[j / 2] >> (16 * (j % 2)));
    }
  }
}

// A operand of m16n8k16: the 16 x 16 block at (row0, k0) of a row-major
// shared tile with row stride `ld`.
template <typename T>
__device__ __forceinline__ void frag_a(uint32_t a[4], const T* s, int ld, int row0, int k0) {
  const int lane = threadIdx.x & 31;
  const T* p = s + (row0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * ld);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * ld + 8);
}

// B operand of m16n8k16 (16 deep, 8 wide) at (k0, n0), from a shared tile
// that holds B transposed: its rows are B's columns n, contiguous in k.
template <typename T>
__device__ __forceinline__ void frag_b(uint32_t b[2], const T* s, int ld, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  const T* p = s + (n0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  b[0] = *reinterpret_cast<const uint32_t*>(p);
  b[1] = *reinterpret_cast<const uint32_t*>(p + 8);
}

// Two 16 x 8 accumulators side by side, rounded to T, as the A operand of
// the next product: the accumulator layout is the A layout, register for
// register.
template <typename T>
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float c0[4], const float c1[4]) {
  a[0] = Num<T>::pack(c0[0], c0[1]);
  a[1] = Num<T>::pack(c0[2], c0[3]);
  a[2] = Num<T>::pack(c1[0], c1[1]);
  a[3] = Num<T>::pack(c1[2], c1[3]);
}

// rows = a warp's 16 rows x 8 columns per accumulator; lane (g, t) holds
// rows g and g + 8, columns 2t and 2t + 1 of each
template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) attn_fwd(Params p) {
  constexpr int BN = 64, LD = D + 8, LDT = BN + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + kRows * LD;
  T* sVt = sK + BN * LD;

  // the longest causal rows first, so the short ones fill the tail
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads, seq = p.seq;
  const T* q = head<T>(p, p.q, kQ, b, h);
  const T* k = head<T>(p, p.k, kK, b, h);
  const T* v = head<T>(p, p.v, kV, b, h);

  load_rows<T, D, kRows>(sQ, q, p.strides[kQ][1], q0, seq);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int row[2] = {q0 + warp * 16 + (lane >> 2), q0 + warp * 16 + (lane >> 2) + 8};
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) frag_a(qf[kk], sQ, LD, warp * 16, kk * 16);

  float acc[D / 8][4];
  zero(acc);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float sl2 = p.scale * kLog2e;  // exp(x * scale) = exp2(x * sl2)
  const int k_tiles = p.causal ? min(cdiv(seq, BN), cdiv(q0 + kRows, BN)) : cdiv(seq, BN);
  for (int j = 0; j < k_tiles; ++j) {
    const int k0 = j * BN;
    __syncthreads();  // the previous tile's readers are done
    load_rows<T, D, BN>(sK, k, p.strides[kK][1], k0, seq);
    load_rows_t<T, D, BN>(sVt, v, p.strides[kV][1], k0, seq);
    __syncthreads();

    float s[BN / 8][4];
    zero(s);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nb = 0; nb < BN / 8; ++nb) {
        uint32_t bf[2];
        frag_b(bf, sK, LD, nb * 8, kk * 16);
        Num<T>::mma(s[nb], qf[kk], bf);
      }
    }
    // only a tile that crosses the diagonal or the sequence's end masks
    const bool edge = k0 + BN > seq || (p.causal && k0 + BN - 1 > q0);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[nb][i] * sl2;
        if (edge) {
          const int col = k0 + nb * 8 + 2 * t + (i & 1);
          if (col >= seq || (p.causal && col > row[i >> 1])) x = -INFINITY;
        }
        s[nb][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    }
    float alpha[2], rowsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // a row's 64 columns sit in the 4 lanes of its group
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);  // 0 on the first tile: column 0 is never masked
      m[r] = mx[r];
    }
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[nb][i] = exp2f(s[nb][i] - m[i >> 1]);
        rowsum[i >> 1] += s[nb][i];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rowsum[r];
#pragma unroll
    for (int db = 0; db < D / 8; ++db) {
      acc[db][0] *= alpha[0];
      acc[db][1] *= alpha[0];
      acc[db][2] *= alpha[1];
      acc[db][3] *= alpha[1];
    }
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
      uint32_t pa[4];
      acc_to_a<T>(pa, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int db = 0; db < D / 8; ++db) {
        uint32_t bf[2];
        frag_b(bf, sVt, LDT, db * 8, kc * 16);
        Num<T>::mma(acc[db], pa, bf);
      }
    }
  }

  T* o = static_cast<T*>(p.o) + b * p.strides[kO][0] + h * p.strides[kO][2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (row[r] >= seq) continue;
    const float inv = 1.f / l[r];
    T* dst = o + row[r] * p.strides[kO][1] + 2 * t;
#pragma unroll
    for (int db = 0; db < D / 8; ++db) {
      *reinterpret_cast<uint32_t*>(dst + db * 8) =
          Num<T>::pack(acc[db][2 * r] * inv, acc[db][2 * r + 1] * inv);
    }
    if (t == 0) p.lse[(long long)bh * seq + row[r]] = (m[r] + log2f(l[r])) * kLn2;
  }
}

// D = rowsum(dO * O) in f32: D / 8 threads per row, 16 bytes each
template <typename T, int D>
__global__ void __launch_bounds__(256) attn_bwd_delta(Params p) {
  constexpr int kPer = D / 8;
  const long long id = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = id / kPer, rows = (long long)p.batch * p.heads * p.seq;
  const int part = (int)(id % kPer);
  float acc = 0.f;
  if (row < rows) {
    const int s = (int)(row % p.seq), bh = (int)(row / p.seq);
    const int b = bh / p.heads, h = bh % p.heads;
    const T* o = head<T>(p, p.o, kO, b, h) + s * p.strides[kO][1] + part * 8;
    const T* d = head<T>(p, p.dout, kDO, b, h) + s * p.strides[kDO][1] + part * 8;
    const uint4 x = *reinterpret_cast<const uint4*>(o), y = *reinterpret_cast<const uint4*>(d);
    const uint32_t xw[4] = {x.x, x.y, x.z, x.w}, yw[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float2 a = Num<T>::unpack(xw[w]), c = Num<T>::unpack(yw[w]);
      acc += a.x * c.x + a.y * c.y;
    }
  }
#pragma unroll
  for (int off = kPer / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && part == 0) p.delta[row] = acc;
}

// width of the inner loop's tiles in the backward: the warp holds two
// (16 x BN) f32 tiles beside two (16 x D) accumulators
template <int D>
__host__ __device__ constexpr int bwd_block() { return D == 64 ? 64 : 32; }

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) attn_bwd_dkdv(Params p) {
  constexpr int BN = bwd_block<D>(), LD = D + 8, LDT = BN + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + kRows * LD;
  T* sQ = sV + kRows * LD;
  T* sQt = sQ + BN * LD;
  T* sdO = sQt + D * LDT;
  T* sdOt = sdO + BN * LD;
  float* sL = reinterpret_cast<float*>(sdOt + D * LDT);
  float* sDelta = sL + BN;

  const int k0 = blockIdx.x * kRows;
  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads, seq = p.seq;
  const T* q = head<T>(p, p.q, kQ, b, h);
  const T* dout = head<T>(p, p.dout, kDO, b, h);
  const float* lse = p.lse + (long long)bh * seq;
  const float* delta = p.delta + (long long)bh * seq;
  load_rows<T, D, kRows>(sK, head<T>(p, p.k, kK, b, h), p.strides[kK][1], k0, seq);
  load_rows<T, D, kRows>(sV, head<T>(p, p.v, kV, b, h), p.strides[kV][1], k0, seq);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int key[2] = {k0 + warp * 16 + (lane >> 2), k0 + warp * 16 + (lane >> 2) + 8};
  float dk[D / 8][4], dv[D / 8][4];
  zero(dk);
  zero(dv);
  const float sl2 = p.scale * kLog2e;
  // causal: the first q tile holding a row at or after k0
  for (int i = p.causal ? k0 / BN : 0; i < cdiv(seq, BN); ++i) {
    const int q0 = i * BN;
    __syncthreads();
    load_rows<T, D, BN>(sQ, q, p.strides[kQ][1], q0, seq);
    load_rows_t<T, D, BN>(sQt, q, p.strides[kQ][1], q0, seq);
    load_rows<T, D, BN>(sdO, dout, p.strides[kDO][1], q0, seq);
    load_rows_t<T, D, BN>(sdOt, dout, p.strides[kDO][1], q0, seq);
    for (int r = threadIdx.x; r < BN; r += kThreads) {
      const bool ok = q0 + r < seq;
      sL[r] = ok ? lse[q0 + r] * kLog2e : 0.f;
      sDelta[r] = ok ? delta[q0 + r] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T for the warp's 16 keys, then P^T = exp(S^T * scale - lse)
    float st[BN / 8][4];
    zero(st);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      frag_a(a, sK, LD, warp * 16, kk * 16);
#pragma unroll
      for (int nb = 0; nb < BN / 8; ++nb) {
        uint32_t bf[2];
        frag_b(bf, sQ, LD, nb * 8, kk * 16);
        Num<T>::mma(st[nb], a, bf);
      }
    }
    const bool edge = q0 + BN > seq || (p.causal && q0 < k0 + kRows - 1);
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = nb * 8 + 2 * t + (i & 1);
        float x = exp2f(st[nb][i] * sl2 - sL[c]);
        if (edge && (q0 + c >= seq || (p.causal && q0 + c < key[i >> 1]))) x = 0.f;
        st[nb][i] = x;
      }
    }
    // dV += P^T dO
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
      uint32_t pa[4];
      acc_to_a<T>(pa, st[2 * kc], st[2 * kc + 1]);
#pragma unroll
      for (int db = 0; db < D / 8; ++db) {
        uint32_t bf[2];
        frag_b(bf, sdOt, LDT, db * 8, kc * 16);
        Num<T>::mma(dv[db], pa, bf);
      }
    }
    // dP^T = V dO^T, then dS^T = P^T (dP^T - D)
    float dpt[BN / 8][4];
    zero(dpt);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      frag_a(a, sV, LD, warp * 16, kk * 16);
#pragma unroll
      for (int nb = 0; nb < BN / 8; ++nb) {
        uint32_t bf[2];
        frag_b(bf, sdO, LD, nb * 8, kk * 16);
        Num<T>::mma(dpt[nb], a, bf);
      }
    }
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dpt[nb][i] = st[nb][i] * (dpt[nb][i] - sDelta[nb * 8 + 2 * t + (i & 1)]);
      }
    }
    // dK += dS^T Q
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
      uint32_t pa[4];
      acc_to_a<T>(pa, dpt[2 * kc], dpt[2 * kc + 1]);
#pragma unroll
      for (int db = 0; db < D / 8; ++db) {
        uint32_t bf[2];
        frag_b(bf, sQt, LDT, db * 8, kc * 16);
        Num<T>::mma(dk[db], pa, bf);
      }
    }
  }

  T* dkp = static_cast<T*>(p.dk) + b * p.strides[kDK][0] + h * p.strides[kDK][2];
  T* dvp = static_cast<T*>(p.dv) + b * p.strides[kDV][0] + h * p.strides[kDV][2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= seq) continue;
    T* dkr = dkp + key[r] * p.strides[kDK][1] + 2 * t;
    T* dvr = dvp + key[r] * p.strides[kDV][1] + 2 * t;
#pragma unroll
    for (int db = 0; db < D / 8; ++db) {
      *reinterpret_cast<uint32_t*>(dkr + db * 8) =
          Num<T>::pack(dk[db][2 * r] * p.scale, dk[db][2 * r + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dvr + db * 8) = Num<T>::pack(dv[db][2 * r], dv[db][2 * r + 1]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) attn_bwd_dq(Params p) {
  constexpr int BN = bwd_block<D>(), LD = D + 8, LDT = BN + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sdO = sQ + kRows * LD;
  T* sK = sdO + kRows * LD;
  T* sKt = sK + BN * LD;
  T* sV = sKt + D * LDT;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads, seq = p.seq;
  const T* k = head<T>(p, p.k, kK, b, h);
  const T* v = head<T>(p, p.v, kV, b, h);
  load_rows<T, D, kRows>(sQ, head<T>(p, p.q, kQ, b, h), p.strides[kQ][1], q0, seq);
  load_rows<T, D, kRows>(sdO, head<T>(p, p.dout, kDO, b, h), p.strides[kDO][1], q0, seq);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int row[2] = {q0 + warp * 16 + (lane >> 2), q0 + warp * 16 + (lane >> 2) + 8};
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = row[r] < seq;
    lse2[r] = ok ? p.lse[(long long)bh * seq + row[r]] * kLog2e : 0.f;
    dl[r] = ok ? p.delta[(long long)bh * seq + row[r]] : 0.f;
  }
  float dq[D / 8][4];
  zero(dq);
  const float sl2 = p.scale * kLog2e;
  const int k_tiles = p.causal ? min(cdiv(seq, BN), cdiv(q0 + kRows, BN)) : cdiv(seq, BN);
  for (int j = 0; j < k_tiles; ++j) {
    const int k0 = j * BN;
    __syncthreads();
    load_rows<T, D, BN>(sK, k, p.strides[kK][1], k0, seq);
    load_rows_t<T, D, BN>(sKt, k, p.strides[kK][1], k0, seq);
    load_rows<T, D, BN>(sV, v, p.strides[kV][1], k0, seq);
    __syncthreads();

    // S = Q K^T, P = exp(S * scale - lse)
    float s[BN / 8][4];
    zero(s);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      frag_a(a, sQ, LD, warp * 16, kk * 16);
#pragma unroll
      for (int nb = 0; nb < BN / 8; ++nb) {
        uint32_t bf[2];
        frag_b(bf, sK, LD, nb * 8, kk * 16);
        Num<T>::mma(s[nb], a, bf);
      }
    }
    const bool edge = k0 + BN > seq || (p.causal && k0 + BN - 1 > q0);
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + nb * 8 + 2 * t + (i & 1);
        float x = exp2f(s[nb][i] * sl2 - lse2[i >> 1]);
        if (edge && (col >= seq || (p.causal && col > row[i >> 1]))) x = 0.f;
        s[nb][i] = x;
      }
    }
    // dP = dO V^T, then dS = P (dP - D)
    float dp[BN / 8][4];
    zero(dp);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      frag_a(a, sdO, LD, warp * 16, kk * 16);
#pragma unroll
      for (int nb = 0; nb < BN / 8; ++nb) {
        uint32_t bf[2];
        frag_b(bf, sV, LD, nb * 8, kk * 16);
        Num<T>::mma(dp[nb], a, bf);
      }
    }
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb) {
#pragma unroll
      for (int i = 0; i < 4; ++i) dp[nb][i] = s[nb][i] * (dp[nb][i] - dl[i >> 1]);
    }
    // dQ += dS K
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
      uint32_t pa[4];
      acc_to_a<T>(pa, dp[2 * kc], dp[2 * kc + 1]);
#pragma unroll
      for (int db = 0; db < D / 8; ++db) {
        uint32_t bf[2];
        frag_b(bf, sKt, LDT, db * 8, kc * 16);
        Num<T>::mma(dq[db], pa, bf);
      }
    }
  }

  T* dqp = static_cast<T*>(p.dq) + b * p.strides[kDQ][0] + h * p.strides[kDQ][2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= seq) continue;
    T* dst = dqp + row[r] * p.strides[kDQ][1] + 2 * t;
#pragma unroll
    for (int db = 0; db < D / 8; ++db) {
      *reinterpret_cast<uint32_t*>(dst + db * 8) =
          Num<T>::pack(dq[db][2 * r] * p.scale, dq[db][2 * r + 1] * p.scale);
    }
  }
}

// Kernels whose shared tiles pass the 48 KB default need the opt-in,
// once per instance.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int D>
cudaError_t forward(const Params& p, cudaStream_t stream) {
  constexpr int BN = 64;
  constexpr int smem = (kRows * (D + 8) + BN * (D + 8) + D * (BN + 8)) * sizeof(T);
  static const cudaError_t attr = allow_smem(attn_fwd<T, D>, smem);
  if (attr != cudaSuccess) return attr;
  attn_fwd<T, D><<<dim3(cdiv(p.seq, kRows), p.batch * p.heads), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t backward(const Params& p, cudaStream_t stream) {
  constexpr int BN = bwd_block<D>();
  constexpr int smem_kv =
      (2 * kRows * (D + 8) + 2 * BN * (D + 8) + 2 * D * (BN + 8)) * sizeof(T) + 2 * BN * sizeof(float);
  constexpr int smem_q = (2 * kRows * (D + 8) + 2 * BN * (D + 8) + D * (BN + 8)) * sizeof(T);
  static const cudaError_t attr_kv = allow_smem(attn_bwd_dkdv<T, D>, smem_kv);
  static const cudaError_t attr_q = allow_smem(attn_bwd_dq<T, D>, smem_q);
  if (attr_kv != cudaSuccess) return attr_kv;
  if (attr_q != cudaSuccess) return attr_q;
  const long long rows = (long long)p.batch * p.heads * p.seq;
  attn_bwd_delta<T, D><<<cdiv(rows * (D / 8), 256), 256, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(p.seq, kRows), p.batch * p.heads);
  attn_bwd_dkdv<T, D><<<grid, kThreads, smem_kv, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_dq<T, D><<<grid, kThreads, smem_q, stream>>>(p);
  return cudaGetLastError();
}

// dtype 0 = bf16, 1 = fp16
int dispatch(int dtype, int head_dim, bool fwd, const Params& p, cudaStream_t s) {
  if (dtype == 0 && head_dim == 64) return fwd ? forward<__nv_bfloat16, 64>(p, s) : backward<__nv_bfloat16, 64>(p, s);
  if (dtype == 0 && head_dim == 128) return fwd ? forward<__nv_bfloat16, 128>(p, s) : backward<__nv_bfloat16, 128>(p, s);
  if (dtype == 1 && head_dim == 64) return fwd ? forward<__half, 64>(p, s) : backward<__half, 64>(p, s);
  if (dtype == 1 && head_dim == 128) return fwd ? forward<__half, 128>(p, s) : backward<__half, 128>(p, s);
  return cudaErrorInvalidValue;
}

Params make_params(const long long* strides, int n_tensors, int batch, int heads, int seq, int causal,
                   float scale) {
  Params p = {};
  for (int t = 0; t < n_tensors; ++t) {
    for (int d = 0; d < 3; ++d) p.strides[t][d] = strides[3 * t + d];
  }
  p.batch = batch;
  p.heads = heads;
  p.seq = seq;
  p.causal = causal;
  p.scale = scale;
  return p;
}

}  // namespace

extern "C" {

// strides: (batch, seq, head) of q, k, v, o (12 values)
int tk8s_attn_fwd(int dtype, int head_dim, const void* q, const void* k, const void* v, void* o, float* lse,
                  const long long* strides, int batch, int heads, int seq, int causal, float scale,
                  void* stream) {
  Params p = make_params(strides, 4, batch, heads, seq, causal, scale);
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
  return dispatch(dtype, head_dim, true, p, static_cast<cudaStream_t>(stream));
}

// strides: (batch, seq, head) of q, k, v, o, dout, dq, dk, dv (24 values);
// delta is (B, H, S) f32 scratch
int tk8s_attn_bwd(int dtype, int head_dim, const void* q, const void* k, const void* v, const void* o,
                  const void* dout, const float* lse, float* delta, void* dq, void* dk, void* dv,
                  const long long* strides, int batch, int heads, int seq, int causal, float scale,
                  void* stream) {
  Params p = make_params(strides, kTensors, batch, heads, seq, causal, scale);
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = const_cast<void*>(o);
  p.dout = dout;
  p.lse = const_cast<float*>(lse);
  p.delta = delta;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  return dispatch(dtype, head_dim, false, p, static_cast<cudaStream_t>(stream));
}

const char* tk8s_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"

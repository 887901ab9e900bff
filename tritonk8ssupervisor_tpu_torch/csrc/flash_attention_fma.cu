// K2's f32 instance on Hopper: exact softmax attention, forward and
// backward, for sm_90a, with every product and sum an f32 fused
// multiply-add on the CUDA cores.
//
// Replaces, for float32 q, k and v, the same TPU kernels as
// csrc/flash_attention.cu: `_splash_kernel` and `_tuned_library_flash`,
// reached from tritonk8ssupervisor_tpu/ops/flash_attention.py's
// `flash_attention`, which takes any float dtype. The bf16 and fp16
// instances there run their products on the tensor cores; this file is
// the f32 one. It uses no TF32 in any form: TF32 keeps 10 bits of a
// product's inputs, and the f32 contract is an error bound against a
// float64 evaluation that only f32 products meet (tests/test_torch_kernels.py).
//
// What bounds it on an H100: f32 has no tensor-core path here, so the
// 67 TFLOP/s of the CUDA cores. The LM's (8, 1024, 12, 64) causal
// forward is 12.9 GFLOP (0.19 ms at that rate) against ~100 MB of
// traffic (0.03 ms at 3.35 TB/s): the operations bound it, and the
// backward's five products a pair more so. The design therefore keeps
// the scores out of device memory, reads every tile from shared memory
// with no bank conflicts, and gives each thread a register tile of
// products.
//
// Three CTA shapes, one per tile width D (the head_dim rounded up to 64,
// 128 or 256; columns past head_dim read as zeros and are never
// written): a CTA of 256 threads owns kRows rows of one (batch, head) and
// streams the other side in steps of kStep. Thread (ty, tx) = (tid / 16,
// tid % 16) holds rows ty + 16 i, columns tx + 16 j of every score tile
// and columns tx + 16 c of the head_dim, so a row's 16 threads are one
// half-warp and its max and sum are four shuffles. Every tile lies in
// shared memory transposed, (D, rows + 1) in f32: loads from device
// memory are coalesced along the head_dim, the transposed store and the
// column reads hit 32 banks, the row reads broadcast.
//
//   attn_fma_fwd    items of (kRows q rows, batch*head), the longest
//                   causal items first: S = Q K^T, the online softmax in
//                   f32 registers (exp2 with the scale folded in), P
//                   through shared memory, O += P V; O and the (B, H, S)
//                   f32 logsumexp written.
//   attn_fma_rows   per q row, D = rowsum(dO * O), one thread a row, as
//                   one FMA chain over the head_dim in the order the
//                   score products take: where a row's O is one value
//                   row (a causal row 0, a one-key sequence) dP - D is
//                   then exactly 0, so are its dS, dq and dk, as the
//                   exact function's.
//   attn_fma_dkdv   items of (kRows keys, batch*head): K and V once, then
//                   the q steps at and below the diagonal: S^T and dP^T
//                   recomputed, P^T = exp2(S^T scale log2e - lse log2e),
//                   dS^T = P^T (dP^T - D), dV += P^T dO, dK += dS^T Q.
//   attn_fma_dq     items of (kRows q rows, batch*head): Q and dO once,
//                   the key steps at and left of the diagonal: S, dP, dS
//                   as above, dQ += dS K.
//
// dK and dQ are scaled once at the end. Determinism: no atomics; every
// output row is written by the one CTA that owns it, after sums in a
// fixed order, so two calls on the same inputs are bit-equal.
//
// q, k, v, O, dO, dq, dk and dv are read and written through their four
// strides (batch, seq, head, head_dim) in elements, so the (B, S, H, D)
// and (B, H, S, D) layouts and any view run in place. Sums are explicit
// __fmaf_rn, so --use_fast_math cannot reassociate them; exp2f and log2f
// are the card's fast units (about 2 ulp), well inside the bound.
//
// Plain C interface, loaded with ctypes (ops/flash_attention_cuda.py).
// The entry points launch on the caller's stream, allocate nothing, do
// not synchronise, and return cudaGetLastError() after their launches.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSide = 16;  // the 16 x 16 thread grid
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

enum Tensor { kQ, kK, kV, kO, kDO, kDQ, kDK, kDV, kTensors };

struct Params {
  const void* ptr[kTensors];
  long long st[kTensors][4];  // (batch, seq, head, head_dim) strides in elements
  float* lse;                 // (batch, heads, seq)
  float* rows;                // (batch, heads, seq): rowsum(dO * O)
  int batch, heads, seq, dim, causal;
  float scale;
};

// rows a CTA owns and rows of the other side a step, by tile width: the
// smem of a CTA then holds 2 or 3 of them on an SM
template <int D>
struct Tile {
  static constexpr int kRows = D == 256 ? 32 : 64;
  static constexpr int kStep = D == 64 ? 64 : 32;
};

__host__ __device__ constexpr int cdiv(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }

template <typename T>
__device__ __forceinline__ float to_f32(T x) { return static_cast<float>(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x) { return static_cast<T>(x); }

__device__ __forceinline__ long long offset(const Params& p, Tensor t, int b, int h, long long s, int d) {
  return b * p.st[t][0] + s * p.st[t][1] + h * p.st[t][2] + d * p.st[t][3];
}

// rows [r0, r0 + R) of tensor t at (b, h) into dst (D, R + 1), transposed,
// in f32; rows past seq and columns past dim read as zeros
template <typename T, int R, int D>
__device__ void load_tile(float* dst, const Params& p, Tensor t, int b, int h, long long r0) {
  const T* src = static_cast<const T*>(p.ptr[t]);
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const long long row = r0 + r;
    float x = 0.f;
    if (row < p.seq && d < p.dim) x = to_f32(src[offset(p, t, b, h, row, d)]);
    dst[d * (R + 1) + r] = x;
  }
}

// acc[i][j] += sum_d a[d][ty + 16 i] b[d][tx + 16 j] over d < D: a (D, RA
// + 1) and b (D, RB + 1) transposed tiles
template <int D, int RA, int RB>
__device__ __forceinline__ void scores(float (&acc)[RA / kSide][RB / kSide], const float* a, const float* b,
                                       int ty, int tx) {
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float x[RA / kSide], y[RB / kSide];
#pragma unroll
    for (int i = 0; i < RA / kSide; ++i) x[i] = a[d * (RA + 1) + ty + kSide * i];
#pragma unroll
    for (int j = 0; j < RB / kSide; ++j) y[j] = b[d * (RB + 1) + tx + kSide * j];
#pragma unroll
    for (int i = 0; i < RA / kSide; ++i) {
#pragma unroll
      for (int j = 0; j < RB / kSide; ++j) acc[i][j] = __fmaf_rn(x[i], y[j], acc[i][j]);
    }
  }
}

// acc[i][c] += sum_k w[k][ty + 16 i] m[tx + 16 c][k] over k < K: w (K, RW
// + 2) row-major weights (P, P^T or dS), m (D, K + 1) a transposed tile
template <int D, int K, int RW>
__device__ __forceinline__ void accumulate(float (&acc)[RW / kSide][D / kSide], const float* w, const float* m,
                                           int ty, int tx) {
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    float x[RW / kSide], y[D / kSide];
#pragma unroll
    for (int i = 0; i < RW / kSide; ++i) x[i] = w[k * (RW + 2) + ty + kSide * i];
#pragma unroll
    for (int c = 0; c < D / kSide; ++c) y[c] = m[(tx + kSide * c) * (K + 1) + k];
#pragma unroll
    for (int i = 0; i < RW / kSide; ++i) {
#pragma unroll
      for (int c = 0; c < D / kSide; ++c) acc[i][c] = __fmaf_rn(x[i], y[c], acc[i][c]);
    }
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 1; o < kSide; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 1; o < kSide; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// whether (query row, key) is masked: past the sequence or, causal, above
// the diagonal
__device__ __forceinline__ bool masked(const Params& p, long long row, long long key) {
  return key >= p.seq || (p.causal && key > row);
}

// rows ty + 16 i of an (R, D) output tile: acc * factor into tensor t
template <typename T, int R, int D>
__device__ void store_rows(const Params& p, Tensor t, int b, int h, long long r0,
                           const float (&acc)[R / kSide][D / kSide], const float (&factor)[R / kSide], int ty,
                           int tx) {
  T* dst = static_cast<T*>(const_cast<void*>(p.ptr[t]));
#pragma unroll
  for (int i = 0; i < R / kSide; ++i) {
    const long long row = r0 + ty + kSide * i;
    if (row >= p.seq) continue;
#pragma unroll
    for (int c = 0; c < D / kSide; ++c) {
      const int d = tx + kSide * c;
      if (d < p.dim) dst[offset(p, t, b, h, row, d)] = from_f32<T>(acc[i][c] * factor[i]);
    }
  }
}

template <typename T, int D>
struct Fwd {
  static constexpr int R = Tile<D>::kRows, S = Tile<D>::kStep;
  static constexpr int kQTile = D * (R + 1), kKVTile = D * (S + 1), kPTile = S * (R + 2);
  static constexpr int kSmem = (kQTile + 2 * kKVTile + kPTile) * 4;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) attn_fma_fwd(Params p) {
  using F = Fwd<T, D>;
  constexpr int R = F::R, S = F::S, RI = R / kSide, SJ = S / kSide, DC = D / kSide;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + F::kQTile;
  float* vs = ks + F::kKVTile;
  float* ps = vs + F::kKVTile;  // P^T: (S, R + 2)
  const int bhs = p.batch * p.heads, tiles = cdiv(p.seq, R);
  const int tile = tiles - 1 - static_cast<int>(blockIdx.x / bhs);  // the longest causal items first
  const int bh = static_cast<int>(blockIdx.x % bhs), b = bh / p.heads, h = bh % p.heads;
  const int ty = threadIdx.x / kSide, tx = threadIdx.x % kSide;
  const long long q0 = static_cast<long long>(tile) * R;
  const float scale2 = p.scale * kLog2e;

  load_tile<T, R, D>(qs, p, kQ, b, h, q0);
  float m[RI], l[RI], acc[RI][DC];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }
  const long long last_key = p.causal ? (q0 + R < p.seq ? q0 + R : p.seq) : p.seq;
  for (long long k0 = 0; k0 < last_key; k0 += S) {
    __syncthreads();  // the last step's K, V and P are read
    load_tile<T, S, D>(ks, p, kK, b, h, k0);
    load_tile<T, S, D>(vs, p, kV, b, h, k0);
    __syncthreads();
    float s[RI][SJ] = {};
    scores<D, R, S>(s, qs, ks, ty, tx);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const long long row = q0 + ty + kSide * i;
      float top = -INFINITY;
#pragma unroll
      for (int j = 0; j < SJ; ++j) {
        s[i][j] = masked(p, row, k0 + tx + kSide * j) ? -INFINITY : s[i][j] * scale2;
        top = fmaxf(top, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(top));
      const float base = m_new == -INFINITY ? 0.f : m_new;  // a row with no key yet
      const float alpha = exp2f(m[i] - base);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < SJ; ++j) {
        s[i][j] = exp2f(s[i][j] - base);
        sum += s[i][j];
      }
      l[i] = __fmaf_rn(l[i], alpha, half_warp_sum(sum));
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < SJ; ++j) ps[(tx + kSide * j) * (R + 2) + ty + kSide * i] = s[i][j];
    }
    __syncthreads();
    accumulate<D, S, R>(acc, ps, vs, ty, tx);
  }
  float inv[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) inv[i] = 1.f / l[i];
  store_rows<T, R, D>(p, kO, b, h, q0, acc, inv, ty, tx);
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const long long row = q0 + ty + kSide * i;
      if (row < p.seq) p.lse[static_cast<long long>(bh) * p.seq + row] = (m[i] + log2f(l[i])) * kLn2;
    }
  }
}

// D = rowsum(dO * O) per q row: one thread a row, the FMA chain of
// `scores` (d ascending from a zero sum; its columns past dim add 0)
template <typename T>
__global__ void __launch_bounds__(kThreads) attn_fma_rows(Params p) {
  const long long row = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= static_cast<long long>(p.batch) * p.heads * p.seq) return;
  const int bh = static_cast<int>(row / p.seq), b = bh / p.heads, h = bh % p.heads;
  const long long s = row % p.seq;
  const T* o = static_cast<const T*>(p.ptr[kO]);
  const T* dout = static_cast<const T*>(p.ptr[kDO]);
  float sum = 0.f;
  for (int d = 0; d < p.dim; ++d) {
    sum = __fmaf_rn(to_f32(dout[offset(p, kDO, b, h, s, d)]), to_f32(o[offset(p, kO, b, h, s, d)]), sum);
  }
  p.rows[row] = sum;
}

template <typename T, int D>
struct DkDv {
  static constexpr int R = Tile<D>::kRows, S = Tile<D>::kStep;
  static constexpr int kKVTile = D * (R + 1), kQTile = D * (S + 1), kPTile = S * (R + 2);
  static constexpr int kSmem = (2 * kKVTile + 2 * kQTile + 2 * kPTile + 2 * S) * 4;
};

// the q step's lse * log2(e) and D rows into shared memory: +inf and 0
// past the sequence, so those rows' P and dS are 0 without a mask
template <int S>
__device__ void load_rows(float* lse2, float* dsum, const Params& p, int bh, long long r0) {
  for (int r = threadIdx.x; r < S; r += kThreads) {
    const long long row = r0 + r;
    const bool in = row < p.seq;
    lse2[r] = in ? p.lse[static_cast<long long>(bh) * p.seq + row] * kLog2e : INFINITY;
    dsum[r] = in ? p.rows[static_cast<long long>(bh) * p.seq + row] : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) attn_fma_dkdv(Params p) {
  using F = DkDv<T, D>;
  constexpr int R = F::R, S = F::S, RI = R / kSide, SJ = S / kSide, DC = D / kSide;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + F::kKVTile;
  float* qs = vs + F::kKVTile;
  float* dos = qs + F::kQTile;
  float* pt = dos + F::kQTile;   // P^T by q: (S, R + 2)
  float* dst = pt + F::kPTile;   // dS^T by q
  float* lse2 = dst + F::kPTile;
  float* dsum = lse2 + S;
  const int bhs = p.batch * p.heads;
  const int tile = static_cast<int>(blockIdx.x / bhs);  // the first keys see the most q rows
  const int bh = static_cast<int>(blockIdx.x % bhs), b = bh / p.heads, h = bh % p.heads;
  const int ty = threadIdx.x / kSide, tx = threadIdx.x % kSide;
  const long long k0 = static_cast<long long>(tile) * R;
  const float scale2 = p.scale * kLog2e;

  load_tile<T, R, D>(ks, p, kK, b, h, k0);
  load_tile<T, R, D>(vs, p, kV, b, h, k0);
  float dk[RI][DC] = {}, dv[RI][DC] = {};
  for (long long q0 = p.causal ? k0 / S * S : 0; q0 < p.seq; q0 += S) {
    __syncthreads();  // the last step's Q, dO, P^T and dS^T are read
    load_tile<T, S, D>(qs, p, kQ, b, h, q0);
    load_tile<T, S, D>(dos, p, kDO, b, h, q0);
    load_rows<S>(lse2, dsum, p, bh, q0);
    __syncthreads();
    float s[RI][SJ] = {}, dp[RI][SJ] = {};
    scores<D, R, S>(s, ks, qs, ty, tx);
    scores<D, R, S>(dp, vs, dos, ty, tx);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const long long key = k0 + ty + kSide * i;
#pragma unroll
      for (int j = 0; j < SJ; ++j) {
        const int q = tx + kSide * j;
        const float prob = masked(p, q0 + q, key) ? 0.f : exp2f(s[i][j] * scale2 - lse2[q]);
        pt[q * (R + 2) + ty + kSide * i] = prob;
        dst[q * (R + 2) + ty + kSide * i] = prob * (dp[i][j] - dsum[q]);
      }
    }
    __syncthreads();
    accumulate<D, S, R>(dv, pt, dos, ty, tx);
    accumulate<D, S, R>(dk, dst, qs, ty, tx);
  }
  float one[RI], scale[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    one[i] = 1.f;
    scale[i] = p.scale;
  }
  store_rows<T, R, D>(p, kDV, b, h, k0, dv, one, ty, tx);
  store_rows<T, R, D>(p, kDK, b, h, k0, dk, scale, ty, tx);
}

template <typename T, int D>
struct Dq {
  static constexpr int R = Tile<D>::kRows, S = Tile<D>::kStep;
  static constexpr int kQTile = D * (R + 1), kKVTile = D * (S + 1), kPTile = S * (R + 2);
  static constexpr int kSmem = (2 * kQTile + 2 * kKVTile + kPTile + 2 * R) * 4;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) attn_fma_dq(Params p) {
  using F = Dq<T, D>;
  constexpr int R = F::R, S = F::S, RI = R / kSide, SJ = S / kSide, DC = D / kSide;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + F::kQTile;
  float* ks = dos + F::kQTile;
  float* vs = ks + F::kKVTile;
  float* ds = vs + F::kKVTile;  // dS^T by key: (S, R + 2)
  float* lse2 = ds + F::kPTile;
  float* dsum = lse2 + R;
  const int bhs = p.batch * p.heads, tiles = cdiv(p.seq, R);
  const int tile = tiles - 1 - static_cast<int>(blockIdx.x / bhs);
  const int bh = static_cast<int>(blockIdx.x % bhs), b = bh / p.heads, h = bh % p.heads;
  const int ty = threadIdx.x / kSide, tx = threadIdx.x % kSide;
  const long long q0 = static_cast<long long>(tile) * R;
  const float scale2 = p.scale * kLog2e;

  load_tile<T, R, D>(qs, p, kQ, b, h, q0);
  load_tile<T, R, D>(dos, p, kDO, b, h, q0);
  load_rows<R>(lse2, dsum, p, bh, q0);
  float dq[RI][DC] = {};
  const long long last_key = p.causal ? (q0 + R < p.seq ? q0 + R : p.seq) : p.seq;
  for (long long k0 = 0; k0 < last_key; k0 += S) {
    __syncthreads();  // the last step's K, V and dS are read
    load_tile<T, S, D>(ks, p, kK, b, h, k0);
    load_tile<T, S, D>(vs, p, kV, b, h, k0);
    __syncthreads();
    float s[RI][SJ] = {}, dp[RI][SJ] = {};
    scores<D, R, S>(s, qs, ks, ty, tx);
    scores<D, R, S>(dp, dos, vs, ty, tx);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int q = ty + kSide * i;
#pragma unroll
      for (int j = 0; j < SJ; ++j) {
        const long long key = k0 + tx + kSide * j;
        const float prob = masked(p, q0 + q, key) ? 0.f : exp2f(s[i][j] * scale2 - lse2[q]);
        ds[(tx + kSide * j) * (R + 2) + q] = prob * (dp[i][j] - dsum[q]);
      }
    }
    __syncthreads();
    accumulate<D, S, R>(dq, ds, ks, ty, tx);
  }
  float scale[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) scale[i] = p.scale;
  store_rows<T, R, D>(p, kDQ, b, h, q0, dq, scale, ty, tx);
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// one CTA an item: (tiles of the owned side) x batch x heads, at most
// INT_MAX
bool grid_of(const Params& p, int rows, int* grid) {
  const long long items = static_cast<long long>(cdiv(p.seq, rows)) * p.batch * p.heads;
  if (items <= 0 || items > 0x7fffffffLL) return false;
  *grid = static_cast<int>(items);
  return true;
}

template <typename T, int D>
cudaError_t forward(const Params& p, cudaStream_t stream) {
  using F = Fwd<T, D>;
  static const cudaError_t attr = allow_smem(attn_fma_fwd<T, D>, F::kSmem);
  if (attr != cudaSuccess) return attr;
  int grid = 0;
  if (!grid_of(p, F::R, &grid)) return cudaErrorInvalidValue;
  attn_fma_fwd<T, D><<<grid, kThreads, F::kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t backward(const Params& p, cudaStream_t stream) {
  using KV = DkDv<T, D>;
  using Q = Dq<T, D>;
  static const cudaError_t attr_kv = allow_smem(attn_fma_dkdv<T, D>, KV::kSmem);
  static const cudaError_t attr_q = allow_smem(attn_fma_dq<T, D>, Q::kSmem);
  if (attr_kv != cudaSuccess) return attr_kv;
  if (attr_q != cudaSuccess) return attr_q;
  int grid_kv = 0, grid_q = 0;
  if (!grid_of(p, KV::R, &grid_kv) || !grid_of(p, Q::R, &grid_q)) return cudaErrorInvalidValue;
  const long long rows = static_cast<long long>(p.batch) * p.heads * p.seq;
  const long long row_blocks = (rows + kThreads - 1) / kThreads;
  if (row_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  attn_fma_rows<T><<<static_cast<int>(row_blocks), kThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_fma_dkdv<T, D><<<grid_kv, kThreads, KV::kSmem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_fma_dq<T, D><<<grid_q, kThreads, Q::kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
int dispatch_width(bool fwd, const Params& p, cudaStream_t s) {
  if (p.dim <= 64) return fwd ? forward<T, 64>(p, s) : backward<T, 64>(p, s);
  if (p.dim <= 128) return fwd ? forward<T, 128>(p, s) : backward<T, 128>(p, s);
  return fwd ? forward<T, 256>(p, s) : backward<T, 256>(p, s);
}

// dtype 0 = float32, the one instance; head_dim 1-256
int dispatch(int dtype, bool fwd, const Params& p, cudaStream_t s) {
  if (p.dim <= 0 || p.dim > 256 || p.batch <= 0 || p.heads <= 0 || p.seq <= 0) return cudaErrorInvalidValue;
  if (dtype == 0) return dispatch_width<float>(fwd, p, s);
  return cudaErrorInvalidValue;
}

Params make_params(const void* const* ptrs, const long long* strides, int n_tensors, int batch, int heads, int seq,
                   int causal, int head_dim, float scale) {
  Params p = {};
  for (int t = 0; t < n_tensors; ++t) {
    p.ptr[t] = ptrs[t];
    for (int d = 0; d < 4; ++d) p.st[t][d] = strides[4 * t + d];
  }
  p.batch = batch;
  p.heads = heads;
  p.seq = seq;
  p.causal = causal;
  p.dim = head_dim;
  p.scale = scale;
  return p;
}

}  // namespace

extern "C" {

// strides: (batch, seq, head, head_dim) of q, k, v, o in elements (16
// values); lse: (batch, heads, seq) f32
int tk8s_attn_fma_fwd(int dtype, int head_dim, const void* q, const void* k, const void* v, void* o, float* lse,
                      const long long* strides, int batch, int heads, int seq, int causal, float scale,
                      void* stream) {
  const void* ptrs[4] = {q, k, v, o};
  Params p = make_params(ptrs, strides, 4, batch, heads, seq, causal, head_dim, scale);
  p.lse = lse;
  return dispatch(dtype, true, p, static_cast<cudaStream_t>(stream));
}

// strides: (batch, seq, head, head_dim) of q, k, v, o, dout, dq, dk, dv
// (32 values); rows: f32 scratch of batch * heads * seq values
int tk8s_attn_fma_bwd(int dtype, int head_dim, const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const float* lse, float* rows, void* dq, void* dk, void* dv,
                      const long long* strides, int batch, int heads, int seq, int causal, float scale,
                      void* stream) {
  const void* ptrs[kTensors] = {q, k, v, o, dout, dq, dk, dv};
  Params p = make_params(ptrs, strides, kTensors, batch, heads, seq, causal, head_dim, scale);
  p.lse = const_cast<float*>(lse);
  p.rows = rows;
  return dispatch(dtype, false, p, static_cast<cudaStream_t>(stream));
}

const char* tk8s_attn_fma_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"

// K2 on Hopper: exact softmax attention, forward and backward, for
// sm_90a.
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
// The forward, `attn_fwd`, is built from csrc/hopper.cuh in the manner of
// FlashAttention-3. Its work items are (128-row q tile, batch*head), the
// longest causal rows first; one persistent CTA per SM walks them. TMA
// brings each q tile once (two buffers, so the next item's q loads while
// this item's O leaves) and 64-wide (head_dim 128) or 128-wide (head_dim
// 64) k and v tiles through a 4-stage ring, each over a 4-d tensor map of
// (head_dim, seq, head, batch) with the tensor's real strides, so a tile
// never leaves its head and the ragged end of the sequence reads as zeros.
// One producer thread keeps the ring full across items; two consumer
// warpgroups own 64 rows each:
//
//   S = Q K^T       wgmma, both operands K-major in shared memory;
//   softmax         online, in f32 registers: a running max and a
//                   rescaled sum (exp2 with the scale folded in); only a
//                   tile that crosses the diagonal or the sequence's end
//                   masks;
//   O += P V        wgmma with P in registers (the accumulator layout of S
//                   is the A-fragment layout, so P is rounded in place) and
//                   V read MN-major from the ring, no transposed copy.
//
// O is rounded to q's dtype in the q tile's shared memory and stored by
// TMA (which clips the ragged end); the logsumexp (B, H, S) in f32 goes
// out directly.
//
// The backward: three __global__ functions of four warps each, every
// product a bf16/fp16 `mma.sync.m16n8k16` with f32 accumulation:
//
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
// reads along the other axis (dO, Q, K) are also staged transposed in
// shared memory. Rows of shared tiles are padded by 8 elements so that the
// 32 lanes of a fragment load hit 32 distinct banks.
//
// The scale 1/sqrt(d) is applied to the f32 scores (the splash kernel
// folds it into bf16 q instead). q, k, v, O and dO are taken by their
// (batch, seq, head) strides with a unit head_dim stride, so the (B, S, H,
// D) and (B, H, S, D) layouts and views of one fused qkv projection all
// run without a copy; the forward's TMA needs those strides in multiples
// of 8 elements and 16-byte aligned starts (the wrapper checks both).
// Template instances: head_dim 64 and 128, bf16 and fp16.
//
// Plain C interface, loaded with ctypes (ops/flash_attention_cuda.py).
// Each entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() after its launches.

#include <math.h>

#include "hopper.cuh"

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
  a[0] = tk8s::pack2<T>(c0[0], c0[1]);
  a[1] = tk8s::pack2<T>(c0[2], c0[3]);
  a[2] = tk8s::pack2<T>(c1[0], c1[1]);
  a[3] = tk8s::pack2<T>(c1[2], c1[3]);
}

// rows = a warp's 16 rows x 8 columns per accumulator; lane (g, t) holds
// rows g and g + 8, columns 2t and 2t + 1 of each
template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
}

// ----- the forward (csrc/hopper.cuh)

constexpr int kFwdThreads = 384;  // warpgroup 0 the producer, 1 and 2 consumers
constexpr int kFwdConsumers = 256;
constexpr int kFwdRows = 128;     // q rows a work item: 64 per consumer warpgroup
constexpr int kStages = 4;        // k/v ring

template <int D>
struct Fwd {
  static constexpr int kBN = D == 64 ? 128 : 64;  // keys a tile
  static constexpr int kQ = kFwdRows * D * 2;     // D / 64 chunks of 128 lines
  static constexpr int kKV = kBN * D * 2;         // one k or v tile
  // two q buffers (the next item's q loads while this item's O leaves
  // through the other), the ring of k and v tiles
  static constexpr int kSmem = 2 * kQ + 2 * kStages * kKV + tk8s::kAtom;
};

struct FwdMaps {
  CUtensorMap q;  // boxes 64 x 128 rows
  CUtensorMap k;  // boxes 64 x kBN rows
  CUtensorMap v;  // boxes 64 x kBN rows
  CUtensorMap o;  // boxes 64 x 64 rows, stored
};

// Work item i of a call: a 128-row q tile of one (batch, head), the
// longest causal rows first; (q0, bh, k/v tiles).
struct Item {
  int q0, bh, tiles;
  __device__ Item(const Params& p, int i, int bn) {
    const int bhs = p.batch * p.heads;
    q0 = (cdiv(p.seq, kFwdRows) - 1 - i / bhs) * kFwdRows;
    bh = i % bhs;
    tiles = p.causal ? min(cdiv(p.seq, bn), cdiv(q0 + kFwdRows, bn)) : cdiv(p.seq, bn);
  }
};

// Persistent: each CTA walks the work items blockIdx.x, + gridDim.x, ...
// The producer thread runs ahead across items (the ring and the two q
// buffers carry over), so one item's loads overlap the last one's tiles
// and epilogue.
template <typename T, int D>
__global__ void __launch_bounds__(kFwdThreads, 1) attn_fwd(const __grid_constant__ FwdMaps maps, Params p) {
  using F = Fwd<D>;
  constexpr int BN = F::kBN;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full[2], q_empty[2], k_full[kStages], v_full[kStages], empty[kStages];
  uint8_t* sQ = tk8s::align_atom(smem_raw);  // two buffers of F::kQ
  uint8_t* sK = sQ + 2 * F::kQ;
  uint8_t* sV = sK + kStages * F::kKV;
  const int items = cdiv(p.seq, kFwdRows) * p.batch * p.heads;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      tk8s::mbar_init(&q_full[i], 1);
      tk8s::mbar_init(&q_empty[i], 2);  // one arrival per consumer warpgroup
    }
    for (int s = 0; s < kStages; ++s) {
      tk8s::mbar_init(&k_full[s], 1);
      tk8s::mbar_init(&v_full[s], 1);
      tk8s::mbar_init(&empty[s], kFwdConsumers);
    }
    tk8s::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    if (threadIdx.x == 0) {
      tk8s::prefetch_map(&maps.q);
      tk8s::prefetch_map(&maps.k);
      tk8s::prefetch_map(&maps.v);
      int t = 0;  // k/v tiles loaded so far: the ring position
      for (int i = blockIdx.x, n = 0; i < items; i += gridDim.x, ++n) {
        const Item it(p, i, BN);
        const int b = it.bh / p.heads, h = it.bh % p.heads, qb = n & 1;
        tk8s::mbar_wait(&q_empty[qb], ((n >> 1) & 1) ^ 1);
        tk8s::mbar_expect_tx(&q_full[qb], F::kQ);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tk8s::tma_load_4d(sQ + qb * F::kQ + c * kFwdRows * tk8s::kLine, &maps.q, &q_full[qb], 64 * c, it.q0,
                            h, b);
        }
        for (int j = 0; j < it.tiles; ++j, ++t) {
          const int s = t % kStages;
          tk8s::mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
          tk8s::mbar_expect_tx(&k_full[s], F::kKV);
#pragma unroll
          for (int c = 0; c < D / 64; ++c) {
            tk8s::tma_load_4d(sK + s * F::kKV + c * BN * tk8s::kLine, &maps.k, &k_full[s], 64 * c, j * BN, h, b);
          }
          tk8s::mbar_expect_tx(&v_full[s], F::kKV);
#pragma unroll
          for (int c = 0; c < D / 64; ++c) {
            tk8s::tma_load_4d(sV + s * F::kKV + c * BN * tk8s::kLine, &maps.v, &v_full[s], 64 * c, j * BN, h, b);
          }
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128 - 1, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int t4 = lane & 3, seq = p.seq;
  const float sl2 = p.scale * kLog2e;  // exp(x * scale) = exp2(x * sl2)
  int t = 0;
  for (int i = blockIdx.x, n = 0; i < items; i += gridDim.x, ++n) {
    const Item it(p, i, BN);
    const int b = it.bh / p.heads, h = it.bh % p.heads, qb = n & 1, wg_row0 = it.q0 + wg * 64;
    const int row[2] = {wg_row0 + warp * 16 + (lane >> 2), wg_row0 + warp * 16 + (lane >> 2) + 8};
    uint8_t* q_tile = sQ + qb * F::kQ + wg * 64 * tk8s::kLine;  // this warpgroup's rows
    const uint32_t q_addr = tk8s::smem_addr(q_tile);

    float o[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
    // running max of the scaled scores (log2 units) and this thread's
    // share of the running sum
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    tk8s::mbar_wait(&q_full[qb], (n >> 1) & 1);
    for (int j = 0; j < it.tiles; ++j, ++t) {
      const int s = t % kStages, k0 = j * BN;
      const uint32_t parity = (t / kStages) & 1;
      tk8s::mbar_wait(&k_full[s], parity);
      // a tile wholly above the diagonal for this warpgroup's rows is
      // waited for (the ring stays in step) and skipped
      if (!(p.causal && k0 > wg_row0 + 63)) {
        float sc[BN / 2];
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) sc[e] = 0.f;
        const uint32_t k_addr = tk8s::smem_addr(sK + s * F::kKV);
        tk8s::fence_regs(sc);
        tk8s::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int c = kk / 4, in = 32 * (kk % 4);
          tk8s::wgmma_ss<T, 0, 0>(sc, tk8s::desc_k_major(q_addr + c * kFwdRows * tk8s::kLine + in),
                                  tk8s::desc_k_major(k_addr + c * BN * tk8s::kLine + in), 1);
        }
        tk8s::wgmma_commit();
        tk8s::wgmma_wait<0>();
        tk8s::fence_regs(sc);

        // only a tile that crosses the diagonal or the sequence's end masks
        if (k0 + BN > seq || (p.causal && k0 + BN - 1 > wg_row0)) {
#pragma unroll
          for (int e = 0; e < BN / 2; ++e) {
            const int col = k0 + 8 * (e >> 2) + 2 * t4 + (e & 1);
            if (col >= seq || (p.causal && col > row[(e >> 1) & 1])) sc[e] = -INFINITY;
          }
        }
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
        float alpha[2], neg_m[2], rowsum[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          // a row's columns sit in the 4 lanes of its group
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m[r], mx[r] * sl2);
          alpha[r] = exp2f(m[r] - m_new);  // 0 on the first tile: column 0 is never masked
          m[r] = m_new;
          neg_m[r] = -m_new;
        }
        uint32_t pa[BN / 16][4];
#pragma unroll
        for (int kc = 0; kc < BN / 16; ++kc) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e & 1;
            const float lo = exp2f(fmaf(sc[8 * kc + 2 * e], sl2, neg_m[r]));
            const float hi = exp2f(fmaf(sc[8 * kc + 2 * e + 1], sl2, neg_m[r]));
            rowsum[r] += lo + hi;
            pa[kc][e] = tk8s::pack2<T>(lo, hi);
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rowsum[r];
#pragma unroll
        for (int e = 0; e < D / 2; ++e) o[e] *= alpha[(e >> 1) & 1];

        tk8s::mbar_wait(&v_full[s], parity);
        const uint32_t v_addr = tk8s::smem_addr(sV + s * F::kKV);
        tk8s::fence_regs(o);
        tk8s::wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < BN / 16; ++kc) {
          tk8s::wgmma_rs<T, 1>(o, pa[kc], tk8s::desc_mn_major(v_addr + kc * 16 * tk8s::kLine, BN * tk8s::kLine),
                               1);
        }
        tk8s::wgmma_commit();
        tk8s::wgmma_wait<0>();
        tk8s::fence_regs(o);
      } else {
        tk8s::mbar_wait(&v_full[s], parity);
      }
      tk8s::mbar_arrive(&empty[s]);
    }

    // O / l in q's dtype, staged in this warpgroup's rows of its q buffer
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
    for (int e = 0; e < D / 2; e += 2) {
      const int r = (e >> 1) & 1, lr = warp * 16 + (lane >> 2) + 8 * r, col = 8 * (e >> 2) + 2 * t4;
      // chunks of the q buffer are kFwdRows lines apart; the swizzle runs
      // over the warpgroup's 64 lines
      const uint32_t off = (col >> 6) * kFwdRows * tk8s::kLine + tk8s::swizzled(lr, col & 63, 64);
      *reinterpret_cast<uint32_t*>(q_tile + off) = tk8s::pack2<T>(o[e] * inv[r], o[e + 1] * inv[r]);
    }
    tk8s::fence_proxy_async();
    tk8s::named_sync(1 + wg, 128);
    if (threadIdx.x % 128 == 0) {
      if (wg_row0 < seq) {
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tk8s::tma_store_4d(&maps.o, q_tile + c * kFwdRows * tk8s::kLine, 64 * c, wg_row0, h, b);
        }
        tk8s::tma_store_commit();
        tk8s::tma_store_wait_read();
      }
      tk8s::mbar_arrive(&q_empty[qb]);  // the q buffer may take the item after next
    }
    if (t4 == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (row[r] < seq) p.lse[(long long)it.bh * seq + row[r]] = (m[r] + log2f(l[r])) * kLn2;
      }
    }
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
          tk8s::pack2<T>(dk[db][2 * r] * p.scale, dk[db][2 * r + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dvr + db * 8) = tk8s::pack2<T>(dv[db][2 * r], dv[db][2 * r + 1]);
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
          tk8s::pack2<T>(dq[db][2 * r] * p.scale, dq[db][2 * r + 1] * p.scale);
    }
  }
}

template <typename T, int D>
cudaError_t forward(const Params& p, cudaStream_t stream) {
  using F = Fwd<D>;
  // q, k, v, o as (head_dim, seq, head, batch) with their own strides
  FwdMaps maps;
  CUtensorMap* out[4] = {&maps.q, &maps.k, &maps.v, &maps.o};
  const void* base[4] = {p.q, p.k, p.v, p.o};
  const int rows[4] = {kFwdRows, F::kBN, F::kBN, 64};
  const long long b = p.batch, h = p.heads, s = p.seq;
  for (int i = 0; i < 4; ++i) {
    const long long* st = p.strides[i];
    const cudaError_t err =
        tk8s::make_map<T>(out[i], base[i], {D, s, h, b}, {st[1], st[2], st[0]}, {64, rows[i], 1, 1});
    if (err != cudaSuccess) return err;
  }
  static const cudaError_t attr = tk8s::allow_smem(attn_fwd<T, D>, F::kSmem);
  if (attr != cudaSuccess) return attr;
  static const int sms = [] {
    int device = 0, count = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
    return count;
  }();
  const int items = cdiv(p.seq, kFwdRows) * p.batch * p.heads;
  attn_fwd<T, D><<<(items < sms ? items : sms), kFwdThreads, F::kSmem, stream>>>(maps, p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t backward(const Params& p, cudaStream_t stream) {
  constexpr int BN = bwd_block<D>();
  constexpr int smem_kv =
      (2 * kRows * (D + 8) + 2 * BN * (D + 8) + 2 * D * (BN + 8)) * sizeof(T) + 2 * BN * sizeof(float);
  constexpr int smem_q = (2 * kRows * (D + 8) + 2 * BN * (D + 8) + D * (BN + 8)) * sizeof(T);
  static const cudaError_t attr_kv = tk8s::allow_smem(attn_bwd_dkdv<T, D>, smem_kv);
  static const cudaError_t attr_q = tk8s::allow_smem(attn_bwd_dq<T, D>, smem_q);
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

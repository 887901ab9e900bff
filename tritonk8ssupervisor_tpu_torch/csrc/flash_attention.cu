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
// Every kernel here is built from csrc/hopper.cuh in the manner of
// FlashAttention-3: 384 threads, warpgroup 0 the producer (one thread
// issues every TMA load into an mbarrier ring), warpgroups 1 and 2
// consumers of 64 rows each; one persistent CTA per SM walks the work
// items, the longest causal items first. Tiles come through 4-d tensor
// maps of (head_dim, seq, head, batch) with the tensors' real strides, so
// a tile never leaves its head, the ragged end of the sequence reads as
// zeros, and the (B, S, H, D) and (B, H, S, D) layouts and views of one
// fused qkv projection run without a copy. Every operand is read from its
// one TMA copy, K-major or MN-major by its wgmma descriptor: no transposed
// copies.
//
// The forward, `attn_fwd`: items of (128-row q tile, batch*head). q comes
// once (two buffers, so the next item's q loads while this item's O
// leaves), k and v 64-wide (tile 128 or 256) or 128-wide (tile 64)
// through a 4-stage ring (2 stages at tile 256, below):
//
//   S = Q K^T       wgmma, both operands K-major in shared memory;
//   softmax         online, in f32 registers: a running max and a
//                   rescaled sum (exp2 with the scale folded in); only a
//                   tile that crosses the diagonal or the sequence's end
//                   masks;
//   O += P V        wgmma with P in registers (the accumulator layout of S
//                   is the A-fragment layout, so P is rounded in place) and
//                   V read MN-major from the ring.
//
// O is rounded to q's dtype in the q tile's shared memory and stored by
// TMA (which clips the ragged end); the logsumexp (B, H, S) in f32 goes
// out directly.
//
// The backward recomputes P from that logsumexp, in three launches:
//
//   attn_bwd_rows   a pre-pass: per q row, lse2 = logsumexp * log2(e) and
//                   D = rowsum(dO * O) in f32, in 64-row blocks, over the
//                   sequence padded to whole 128-row items; a padded row
//                   has lse2 = +inf and D = 0, so its P and dS are 0
//                   without a mask.
//   attn_bwd_dkdv   items of (128-key tile, batch*head): K and V once (two
//                   buffers, as the forward's q), then the 64-row q tiles
//                   at and below the diagonal through the ring, each with
//                   Q, dO and its lse2 and D rows (a bulk copy). A step:
//                     S^T = K Q^T    wgmma SS, both K-major;
//                     P^T            exp2(S^T scale log2e - lse2), f32;
//                     dP^T = V dO^T  wgmma SS, both K-major;
//                     dS^T           P^T (dP^T - D), f32;
//                     dV += P^T dO, dK += dS^T Q   wgmma RS, P^T and dS^T
//                                    rounded in registers, dO and Q read
//                                    MN-major.
//   attn_bwd_dq     items of (128-row q tile, batch*head), as the forward:
//                   Q and dO once (two buffers), 64-row k and v tiles at
//                   and left of the diagonal through the ring:
//                     S = Q K^T, dP = dO V^T   wgmma SS;
//                     dS             P (dP - D), f32;
//                     dQ += dS K     wgmma RS, K read MN-major.
//
// dK (times the scale), dV and dQ (times the scale) are rounded to the
// input dtype in the shared memory of the item's own input tiles and
// stored by TMA. Determinism: no atomics; every output row is written by
// the one CTA that owns its item, in a fixed order, so two calls on the
// same inputs are bit-equal. The two kernels recompute S and dP each (7
// products for the function's 5) to keep it so. The consumers hold the
// dK and dV accumulators beside two score tiles, so the producer's
// warpgroup gives its registers to them (`setmaxnreg`).
//
// Any head_dim d from 1 to 256. The kernels are instantiated for three
// tile widths D, 64, 128 and 256, in bf16 and fp16; d runs on the narrowest
// tile that holds it (the wrapper picks it). The tensor maps give TMA the
// real d as the innermost dimension, so every load fills the columns [d,
// D) of a tile with zeros and every store of O, dQ, dK and dV clips them:
// zero columns add nothing to Q K^T or dO V^T, and the columns of O, dQ,
// dK and dV they give are never stored. The row pre-pass masks them. The
// scale 1/sqrt(d) of the real d comes from the wrapper.
//
// At D = 256 the plan above does not fit: two 128-row q buffers and a
// 4-stage ring of 64-key k/v tiles need ~384 KB of shared memory against a
// block's 227 KB, and a warpgroup's 64 x 256 f32 accumulator is 128
// registers a thread for O, twice that for dK and dV together. So at that
// width an item is 64 rows (q rows, or keys for dK/dV) that both consumer
// warpgroups share, and each accumulates one half of the output's columns
// (warpgroup w the columns [128 w, 128 w + 128)). Both compute the item's
// whole 64 x 64 score (and dP) tiles over all 256 columns, which is the
// price of the split: 3 units of tensor-core work for the forward's 2, and
// 11 for the backward's 7. Every accumulator is then the D = 128 one, in
// the same registers. Shared memory at D = 256: forward two 64-row q
// buffers (64 KB) and a 2-stage ring of k and v (128 KB); dK/dV one K and
// V buffer (64 KB) and a 2-stage ring of Q, dO and their rows (130 KB);
// dQ one Q and dO buffer (64 KB) and a 2-stage ring of K and V (128 KB).
// The two warpgroups meet at a named barrier before either stages its
// half of the output in the item's shared input tiles.
//
// The scale is applied to the f32 scores (the splash kernel folds it into
// bf16 q instead). TMA needs the (batch, seq, head) strides in multiples
// of 8 elements with a unit head_dim stride, and 16-byte aligned starts
// (the wrapper copies anything else, and pads a d that is not a multiple
// of 8 to one).
//
// Plain C interface, loaded with ctypes (ops/flash_attention_cuda.py).
// Each entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() after its launches.

#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 384;    // warpgroup 0 the producer, 1 and 2 consumers
constexpr int kConsumers = 256;
constexpr int kItemRows = 128;   // q rows or keys a work item: 64 per consumer warpgroup
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
  float* rows;       // the backward's lse2 and D rows (attn_bwd_rows)
  long long strides[kTensors][3];
  int batch, heads, seq, causal;
  int dim;           // the tensors' head_dim, at most the tile's width D
  float scale;       // 1/sqrt(head_dim)
};

__host__ __device__ constexpr int cdiv(long long a, int b) { return (int)((a + b - 1) / b); }

template <typename T>
__device__ __forceinline__ float2 unpack(uint32_t x) {
  if constexpr (tk8s::kHalf<T>) {
    return __half22float2(*reinterpret_cast<__half2*>(&x));
  } else {
    return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
  }
}

template <typename T>
__device__ __forceinline__ const T* head(const Params& p, const void* base, Tensor t, int b, int h) {
  return static_cast<const T*>(base) + b * p.strides[t][0] + h * p.strides[t][2];
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) c[i] = 0.f;
}

// ----- the forward (csrc/hopper.cuh)

// At tile width D > 128 an item's 64 rows are shared by both consumer
// warpgroups, each accumulating half of the output's columns (the header)
template <int D>
struct Split {
  static constexpr bool kOn = D > 128;
  static constexpr int kRows = kOn ? 64 : kItemRows;  // rows an item
  static constexpr int kCols = kOn ? D / 2 : D;       // output columns a warpgroup
  // this warpgroup's first row of the item, and its first 64-column chunk
  __device__ static int row0(int wg) { return kOn ? 0 : wg * 64; }
  __device__ static int chunk0(int wg) { return kOn ? wg * (kCols / 64) : 0; }
};

template <int D>
struct Fwd : Split<D> {
  static constexpr int kBN = D == 64 ? 128 : 64;     // keys a tile
  static constexpr int kStages = D > 128 ? 2 : 4;    // the k/v ring
  static constexpr int kQ = Split<D>::kRows * D * 2;  // D / 64 chunks of kRows lines
  static constexpr int kKV = kBN * D * 2;            // one k or v tile
  // two q buffers (the next item's q loads while this item's O leaves
  // through the other), the ring of k and v tiles
  static constexpr int kSmem = 2 * kQ + 2 * kStages * kKV + tk8s::kAtom;
  static_assert(kSmem <= 227 * 1024, "a CTA's shared memory");
};

struct FwdMaps {
  CUtensorMap q;  // boxes 64 x kRows
  CUtensorMap k;  // boxes 64 x kBN rows
  CUtensorMap v;  // boxes 64 x kBN rows
  CUtensorMap o;  // boxes 64 x 64 rows, stored
};

// Work item i of a call: a `rows`-row q tile of one (batch, head), the
// longest causal rows first; (q0, bh, k/v tiles).
struct Item {
  int q0, bh, tiles;
  __device__ Item(const Params& p, int i, int bn, int rows) {
    const int bhs = p.batch * p.heads;
    q0 = (cdiv(p.seq, rows) - 1 - i / bhs) * rows;
    bh = i % bhs;
    tiles = p.causal ? min(cdiv(p.seq, bn), cdiv(q0 + rows, bn)) : cdiv(p.seq, bn);
  }
};

// Persistent: each CTA walks the work items blockIdx.x, + gridDim.x, ...
// The producer thread runs ahead across items (the ring and the two q
// buffers carry over), so one item's loads overlap the last one's tiles
// and epilogue.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1) attn_fwd(const __grid_constant__ FwdMaps maps, Params p) {
  using F = Fwd<D>;
  constexpr int BN = F::kBN, kStages = F::kStages, R = F::kRows, N = F::kCols;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full[2], q_empty[2], k_full[kStages], v_full[kStages], empty[kStages];
  uint8_t* sQ = tk8s::align_atom(smem_raw);  // two buffers of F::kQ
  uint8_t* sK = sQ + 2 * F::kQ;
  uint8_t* sV = sK + kStages * F::kKV;
  const int items = cdiv(p.seq, R) * p.batch * p.heads;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      tk8s::mbar_init(&q_full[i], 1);
      tk8s::mbar_init(&q_empty[i], 2);  // one arrival per consumer warpgroup
    }
    for (int s = 0; s < kStages; ++s) {
      tk8s::mbar_init(&k_full[s], 1);
      tk8s::mbar_init(&v_full[s], 1);
      tk8s::mbar_init(&empty[s], kConsumers);
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
        const Item it(p, i, BN, R);
        const int b = it.bh / p.heads, h = it.bh % p.heads, qb = n & 1;
        tk8s::mbar_wait(&q_empty[qb], ((n >> 1) & 1) ^ 1);
        tk8s::mbar_expect_tx(&q_full[qb], F::kQ);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tk8s::tma_load_4d(sQ + qb * F::kQ + c * R * tk8s::kLine, &maps.q, &q_full[qb], 64 * c, it.q0, h, b);
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
  const int c0 = F::chunk0(wg);  // this warpgroup's first column chunk of O
  for (int i = blockIdx.x, n = 0; i < items; i += gridDim.x, ++n) {
    const Item it(p, i, BN, R);
    const int b = it.bh / p.heads, h = it.bh % p.heads, qb = n & 1, wg_row0 = it.q0 + F::row0(wg);
    const int row[2] = {wg_row0 + warp * 16 + (lane >> 2), wg_row0 + warp * 16 + (lane >> 2) + 8};
    uint8_t* q_tile = sQ + qb * F::kQ + F::row0(wg) * tk8s::kLine;  // this warpgroup's rows
    const uint32_t q_addr = tk8s::smem_addr(q_tile);

    float o[N / 2];
#pragma unroll
    for (int e = 0; e < N / 2; ++e) o[e] = 0.f;
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
          tk8s::wgmma_ss<T, 0, 0>(sc, tk8s::desc_k_major(q_addr + c * R * tk8s::kLine + in),
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
        for (int e = 0; e < N / 2; ++e) o[e] *= alpha[(e >> 1) & 1];

        tk8s::mbar_wait(&v_full[s], parity);
        // this warpgroup's columns of V
        const uint32_t v_addr = tk8s::smem_addr(sV + s * F::kKV) + c0 * BN * tk8s::kLine;
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
    // split: the other warpgroup may still read these q rows
    if (F::kOn) tk8s::named_sync(3, kConsumers);
    uint8_t* o_tile = q_tile + c0 * R * tk8s::kLine;  // this warpgroup's first chunk
#pragma unroll
    for (int e = 0; e < N / 2; e += 2) {
      const int r = (e >> 1) & 1, lr = warp * 16 + (lane >> 2) + 8 * r, col = 8 * (e >> 2) + 2 * t4;
      // chunks of the q buffer are R lines apart; the swizzle runs over
      // the warpgroup's 64 lines
      const uint32_t off = (col >> 6) * R * tk8s::kLine + tk8s::swizzled(lr, col & 63, 64);
      *reinterpret_cast<uint32_t*>(o_tile + off) = tk8s::pack2<T>(o[e] * inv[r], o[e + 1] * inv[r]);
    }
    tk8s::fence_proxy_async();
    tk8s::named_sync(1 + wg, 128);
    if (threadIdx.x % 128 == 0) {
      if (wg_row0 < seq) {
#pragma unroll
        for (int c = 0; c < N / 64; ++c) {
          tk8s::tma_store_4d(&maps.o, o_tile + c * R * tk8s::kLine, 64 * (c0 + c), wg_row0, h, b);
        }
        tk8s::tma_store_commit();
        tk8s::tma_store_wait_read();
      }
      tk8s::mbar_arrive(&q_empty[qb]);  // the q buffer may take the item after next
    }
    // split: both warpgroups hold the same rows' logsumexp; one writes it
    if (t4 == 0 && (!F::kOn || wg == 0)) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (row[r] < seq) p.lse[(long long)it.bh * seq + row[r]] = (m[r] + log2f(l[r])) * kLn2;
      }
    }
  }
}

int sm_count() {
  static const int count = [] {
    int device = 0, n = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    return n;
  }();
  return count;
}

// ----- the backward (csrc/hopper.cuh)

constexpr int kStep = 64;  // q rows (dK/dV) or keys (dQ) a ring stage
// registers a thread: the producer's warpgroup gives its own to the two
// consumer warpgroups (128 x 40 + 256 x 232 <= 65,536)
constexpr int kRegsProducer = 40, kRegsConsumer = 232;

// 64-row blocks of the rows buffer a (batch, head) holds: the sequence
// padded to whole items
__host__ __device__ constexpr int row_blocks(int seq) { return cdiv(seq, kItemRows) * (kItemRows / kStep); }

// offset of q row r's lse2 in the rows buffer; its D lies kStep floats on
__device__ __forceinline__ long long row_at(int bh, int seq, int r) {
  return ((long long)bh * row_blocks(seq) + r / kStep) * 2 * kStep + r % kStep;
}

template <int D>
struct Bwd : Split<D> {
  static constexpr int kStages = D == 64 ? 4 : 2;
  static constexpr int kBufs = D > 128 ? 1 : 2;          // buffers of the item's own tiles
  static constexpr int kTile = Split<D>::kRows * D * 2;  // an item's tile: D / 64 chunks of kRows lines
  static constexpr int kRing = kStep * D * 2;            // a 64-row tile: D / 64 chunks of 64 lines
  static constexpr int kRowBytes = 2 * kStep * 4;        // a q tile's lse2 and D
  // dK/dV: kBufs buffers of (K, V), a ring of (Q, dO, lse2 and D) with
  // each stage padded to whole atoms
  static constexpr int kKVStage = 2 * kRing + tk8s::kAtom;
  static constexpr int kKVSmem = 2 * kBufs * kTile + kStages * kKVStage + tk8s::kAtom;
  // dQ: kBufs buffers of (Q, dO), a ring of (K, V)
  static constexpr int kQSmem = 2 * kBufs * kTile + kStages * 2 * kRing + tk8s::kAtom;
  static_assert(kKVSmem <= 227 * 1024 && kQSmem <= 227 * 1024, "a CTA's shared memory");
};

// q, k, v and dO loaded, dQ, dK and dV stored, all in boxes of 64 x 64 rows
struct BwdMaps {
  CUtensorMap q, k, v, dout, dq, dk, dv;
};

// rows [r0, r0 + ROWS) of one head as D / 64 chunks of ROWS swizzled
// lines, in 64-row boxes
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map, uint64_t* bar, int r0, int h,
                                          int b) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c) {
#pragma unroll
    for (int r = 0; r < ROWS / kStep; ++r) {
      tk8s::tma_load_4d(dst + (c * ROWS + r * kStep) * tk8s::kLine, map, bar, 64 * c, r0 + r * kStep, h, b);
    }
  }
}

// A warpgroup's 64 x N f32 accumulator times `scale`, rounded to T, into
// its 64 `rows` of a tile whose chunks are R lines apart, laid out as TMA
// reads them
template <typename T, int N, int R>
__device__ __forceinline__ void stage_rows(uint8_t* rows, const float (&acc)[N / 2], float scale) {
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
#pragma unroll
  for (int e = 0; e < N / 2; e += 2) {
    const int lr = warp * 16 + (lane >> 2) + 8 * ((e >> 1) & 1), col = 8 * (e >> 2) + 2 * (lane & 3);
    const uint32_t off = (col >> 6) * R * tk8s::kLine + tk8s::swizzled(lr, col & 63, 64);
    *reinterpret_cast<uint32_t*>(rows + off) = tk8s::pack2<T>(acc[e] * scale, acc[e + 1] * scale);
  }
}

// those rows to device memory at row r0 and column col0 (the box clips
// the ragged end and the columns past head_dim)
template <int N, int R>
__device__ __forceinline__ void store_rows(const CUtensorMap* map, const uint8_t* rows, int col0, int r0, int h,
                                           int b) {
#pragma unroll
  for (int c = 0; c < N / 64; ++c) tk8s::tma_store_4d(map, rows + c * R * tk8s::kLine, col0 + 64 * c, r0, h, b);
}

// acc (64 x 64) = A B^T over head_dim: A a warpgroup's 64 rows of a tile
// whose chunks are R lines apart, B a 64-row tile of the ring, both K-major
template <typename T, int D, int R>
__device__ __forceinline__ void product_ss(float (&acc)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk / 4, in = 32 * (kk % 4);
    tk8s::wgmma_ss<T, 0, 0>(acc, tk8s::desc_k_major(a + c * R * tk8s::kLine + in),
                            tk8s::desc_k_major(b + c * kStep * tk8s::kLine + in), 1);
  }
}

// acc (64 x D) += A B: A (64 x 64) as four A fragments in registers, B a
// 64-row tile of the ring read MN-major
template <typename T, int D>
__device__ __forceinline__ void product_rs(float (&acc)[D / 2], const uint32_t (&a)[4][4], uint32_t b) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    tk8s::wgmma_rs<T, 1>(acc, a[kc], tk8s::desc_mn_major(b + kc * 16 * tk8s::kLine, kStep * tk8s::kLine), 1);
  }
}

// lse2 = logsumexp * log2(e) and D = rowsum(dO * O) in f32 for every row
// of the padded sequence: D / 8 threads a row, 16 bytes each; the threads
// past head_dim (a multiple of 8) add nothing
template <typename T, int D>
__global__ void __launch_bounds__(256) attn_bwd_rows(Params p) {
  constexpr int kPer = D / 8;
  const int padded = row_blocks(p.seq) * kStep;
  const long long id = (long long)blockIdx.x * blockDim.x + threadIdx.x, row = id / kPer;
  const int part = (int)(id % kPer), s = (int)(row % padded), bh = (int)(row / padded);
  const bool in = row < (long long)p.batch * p.heads * padded, real = in && s < p.seq;
  float acc = 0.f;
  if (real && part * 8 < p.dim) {
    const int b = bh / p.heads, h = bh % p.heads;
    const T* o = head<T>(p, p.o, kO, b, h) + s * p.strides[kO][1] + part * 8;
    const T* d = head<T>(p, p.dout, kDO, b, h) + s * p.strides[kDO][1] + part * 8;
    const uint4 x = *reinterpret_cast<const uint4*>(o), y = *reinterpret_cast<const uint4*>(d);
    const uint32_t xw[4] = {x.x, x.y, x.z, x.w}, yw[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float2 a = unpack<T>(xw[w]), c = unpack<T>(yw[w]);
      acc += a.x * c.x + a.y * c.y;
    }
  }
#pragma unroll
  for (int off = kPer / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (in && part == 0) {
    float* out = p.rows + row_at(bh, p.seq, s);
    out[0] = real ? p.lse[(long long)bh * p.seq + s] * kLog2e : INFINITY;
    out[kStep] = acc;
  }
}

// Work item i of the dK/dV kernel: a `rows`-key tile of one (batch,
// head), the first keys (the most q tiles under a causal mask) first, and
// its 64-row q tiles [first, last)
struct KVItem {
  int k0, bh, first, last;
  __device__ KVItem(const Params& p, int i, int rows) {
    const int bhs = p.batch * p.heads;
    k0 = i / bhs * rows;
    bh = i % bhs;
    first = p.causal ? k0 / kStep : 0;
    last = cdiv(p.seq, kStep);
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1) attn_bwd_dkdv(const __grid_constant__ BwdMaps maps, Params p) {
  using B = Bwd<D>;
  constexpr int S = B::kStages, NB = B::kBufs, R = B::kRows, N = B::kCols;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t kv_full[NB], kv_empty[NB], full[S], empty[S];
  uint8_t* sKV = tk8s::align_atom(smem_raw);  // buffer kb: K at 2 kb kTile, V after it
  uint8_t* sRing = sKV + 2 * NB * B::kTile;   // stage s: Q, dO, then the lse2 and D rows
  const int items = cdiv(p.seq, R) * p.batch * p.heads;
  if (threadIdx.x == 0) {
    for (int i = 0; i < NB; ++i) {
      tk8s::mbar_init(&kv_full[i], 1);
      tk8s::mbar_init(&kv_empty[i], 2);  // one arrival per consumer warpgroup
    }
    for (int s = 0; s < S; ++s) {
      tk8s::mbar_init(&full[s], 1);
      tk8s::mbar_init(&empty[s], kConsumers);
    }
    tk8s::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    tk8s::regs_dec<kRegsProducer>();
    if (threadIdx.x == 0) {
      tk8s::prefetch_map(&maps.q);
      tk8s::prefetch_map(&maps.k);
      tk8s::prefetch_map(&maps.v);
      tk8s::prefetch_map(&maps.dout);
      int t = 0;  // q tiles loaded so far: the ring position
      for (int i = blockIdx.x, n = 0; i < items; i += gridDim.x, ++n) {
        const KVItem it(p, i, R);
        const int b = it.bh / p.heads, h = it.bh % p.heads, kb = n % NB;
        uint8_t* kv = sKV + 2 * kb * B::kTile;
        tk8s::mbar_wait(&kv_empty[kb], ((n / NB) & 1) ^ 1);
        tk8s::mbar_expect_tx(&kv_full[kb], 2 * B::kTile);
        load_tile<D, R>(kv, &maps.k, &kv_full[kb], it.k0, h, b);
        load_tile<D, R>(kv + B::kTile, &maps.v, &kv_full[kb], it.k0, h, b);
        for (int j = it.first; j < it.last; ++j, ++t) {
          const int s = t % S;
          uint8_t* stage = sRing + s * B::kKVStage;
          tk8s::mbar_wait(&empty[s], ((t / S) & 1) ^ 1);
          tk8s::mbar_expect_tx(&full[s], 2 * B::kRing + B::kRowBytes);
          load_tile<D, kStep>(stage, &maps.q, &full[s], j * kStep, h, b);
          load_tile<D, kStep>(stage + B::kRing, &maps.dout, &full[s], j * kStep, h, b);
          tk8s::bulk_load(stage + 2 * B::kRing, p.rows + row_at(it.bh, p.seq, j * kStep), B::kRowBytes,
                          &full[s]);
        }
      }
    }
  } else {
    tk8s::regs_inc<kRegsConsumer>();
    const int wg = threadIdx.x / 128 - 1, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int t4 = lane & 3;
    const float sl2 = p.scale * kLog2e;  // exp(x * scale) = exp2(x * sl2)
    const int c0 = B::chunk0(wg);  // this warpgroup's first column chunk of dK and dV
    int t = 0;
    for (int i = blockIdx.x, n = 0; i < items; i += gridDim.x, ++n) {
      const KVItem it(p, i, R);
      const int b = it.bh / p.heads, h = it.bh % p.heads, kb = n % NB, key0 = it.k0 + B::row0(wg);
      const int key[2] = {key0 + warp * 16 + (lane >> 2), key0 + warp * 16 + (lane >> 2) + 8};
      // this warpgroup's keys
      uint8_t* k_rows = sKV + 2 * kb * B::kTile + B::row0(wg) * tk8s::kLine;
      uint8_t* v_rows = k_rows + B::kTile;
      const uint32_t k_addr = tk8s::smem_addr(k_rows), v_addr = tk8s::smem_addr(v_rows);
      float dk[N / 2], dv[N / 2];
      zero(dk);
      zero(dv);
      tk8s::mbar_wait(&kv_full[kb], (n / NB) & 1);
      for (int j = it.first; j < it.last; ++j, ++t) {
        const int s = t % S, q0 = j * kStep;
        tk8s::mbar_wait(&full[s], (t / S) & 1);
        // a q tile wholly before this warpgroup's keys, or keys wholly past
        // the sequence, is waited for (the ring stays in step) and skipped
        if (key0 < p.seq && !(p.causal && q0 + kStep <= key0)) {
          const uint8_t* stage = sRing + s * B::kKVStage;
          const uint32_t q_addr = tk8s::smem_addr(stage), do_addr = q_addr + B::kRing;
          const float* lse2 = reinterpret_cast<const float*>(stage + 2 * B::kRing);
          const float* dd = lse2 + kStep;
          // S^T = K Q^T and dP^T = V dO^T: row = key, column c = q row q0 + c
          float st[32], dpt[32];
          zero(st);
          zero(dpt);
          tk8s::fence_regs(st);
          tk8s::fence_regs(dpt);
          tk8s::wgmma_fence();
          product_ss<T, D, R>(st, k_addr, q_addr);
          product_ss<T, D, R>(dpt, v_addr, do_addr);
          tk8s::wgmma_commit();
          tk8s::wgmma_wait<0>();
          tk8s::fence_regs(st);
          tk8s::fence_regs(dpt);

          // P^T = exp2(S^T sl2 - lse2), 0 where the key comes after the q
          // row (only the diagonal tile masks; q rows past the end have
          // lse2 = +inf), and dS^T = P^T (dP^T - D), both rounded to A
          // fragments: accumulator e is register (e / 2) % 4 of fragment e / 8
          const bool diag = p.causal && q0 < key0 + 63;
          uint32_t pa[4][4], da[4][4];
#pragma unroll
          for (int cb = 0; cb < 8; ++cb) {
            const int c = 8 * cb + 2 * t4;
            const float2 l = *reinterpret_cast<const float2*>(lse2 + c);
            const float2 d = *reinterpret_cast<const float2*>(dd + c);
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int e = 4 * cb + 2 * r;
              float p0 = exp2f(fmaf(st[e], sl2, -l.x)), p1 = exp2f(fmaf(st[e + 1], sl2, -l.y));
              if (diag) {
                if (q0 + c < key[r]) p0 = 0.f;
                if (q0 + c + 1 < key[r]) p1 = 0.f;
              }
              pa[cb / 2][2 * (cb & 1) + r] = tk8s::pack2<T>(p0, p1);
              da[cb / 2][2 * (cb & 1) + r] = tk8s::pack2<T>(p0 * (dpt[e] - d.x), p1 * (dpt[e + 1] - d.y));
            }
          }

          // dV += P^T dO and dK += dS^T Q over this warpgroup's columns,
          // dO and Q read MN-major
          const uint32_t cols = c0 * kStep * tk8s::kLine;
          tk8s::fence_regs(dk);
          tk8s::fence_regs(dv);
          tk8s::wgmma_fence();
          product_rs<T, N>(dv, pa, do_addr + cols);
          product_rs<T, N>(dk, da, q_addr + cols);
          tk8s::wgmma_commit();
          tk8s::wgmma_wait<0>();
          tk8s::fence_regs(dk);
          tk8s::fence_regs(dv);
        }
        tk8s::mbar_arrive(&empty[s]);
      }

      // dK (times the scale) and dV in the input dtype, staged in this
      // warpgroup's rows and columns of the K and V tiles (split: once the
      // other warpgroup has read them too)
      if (B::kOn) tk8s::named_sync(3, kConsumers);
      uint8_t* dk_rows = k_rows + c0 * R * tk8s::kLine;
      uint8_t* dv_rows = v_rows + c0 * R * tk8s::kLine;
      stage_rows<T, N, R>(dk_rows, dk, p.scale);
      stage_rows<T, N, R>(dv_rows, dv, 1.f);
      tk8s::fence_proxy_async();
      tk8s::named_sync(1 + wg, 128);
      if (threadIdx.x % 128 == 0) {
        if (key0 < p.seq) {
          store_rows<N, R>(&maps.dk, dk_rows, 64 * c0, key0, h, b);
          store_rows<N, R>(&maps.dv, dv_rows, 64 * c0, key0, h, b);
          tk8s::tma_store_commit();
          tk8s::tma_store_wait_read();
        }
        tk8s::mbar_arrive(&kv_empty[kb]);  // the buffers may take the item after next
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1) attn_bwd_dq(const __grid_constant__ BwdMaps maps, Params p) {
  using B = Bwd<D>;
  constexpr int S = B::kStages, NB = B::kBufs, R = B::kRows, N = B::kCols;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full[NB], q_empty[NB], full[S], empty[S];
  uint8_t* sQ = tk8s::align_atom(smem_raw);  // buffer qb: Q at 2 qb kTile, dO after it
  uint8_t* sRing = sQ + 2 * NB * B::kTile;   // stage s: K, then V
  const int items = cdiv(p.seq, R) * p.batch * p.heads;
  if (threadIdx.x == 0) {
    for (int i = 0; i < NB; ++i) {
      tk8s::mbar_init(&q_full[i], 1);
      tk8s::mbar_init(&q_empty[i], 2);  // one arrival per consumer warpgroup
    }
    for (int s = 0; s < S; ++s) {
      tk8s::mbar_init(&full[s], 1);
      tk8s::mbar_init(&empty[s], kConsumers);
    }
    tk8s::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    tk8s::regs_dec<kRegsProducer>();
    if (threadIdx.x == 0) {
      tk8s::prefetch_map(&maps.q);
      tk8s::prefetch_map(&maps.k);
      tk8s::prefetch_map(&maps.v);
      tk8s::prefetch_map(&maps.dout);
      int t = 0;  // k/v tiles loaded so far: the ring position
      for (int i = blockIdx.x, n = 0; i < items; i += gridDim.x, ++n) {
        const Item it(p, i, kStep, R);
        const int b = it.bh / p.heads, h = it.bh % p.heads, qb = n % NB;
        uint8_t* qd = sQ + 2 * qb * B::kTile;
        tk8s::mbar_wait(&q_empty[qb], ((n / NB) & 1) ^ 1);
        tk8s::mbar_expect_tx(&q_full[qb], 2 * B::kTile);
        load_tile<D, R>(qd, &maps.q, &q_full[qb], it.q0, h, b);
        load_tile<D, R>(qd + B::kTile, &maps.dout, &q_full[qb], it.q0, h, b);
        for (int j = 0; j < it.tiles; ++j, ++t) {
          const int s = t % S;
          uint8_t* stage = sRing + s * 2 * B::kRing;
          tk8s::mbar_wait(&empty[s], ((t / S) & 1) ^ 1);
          tk8s::mbar_expect_tx(&full[s], 2 * B::kRing);
          load_tile<D, kStep>(stage, &maps.k, &full[s], j * kStep, h, b);
          load_tile<D, kStep>(stage + B::kRing, &maps.v, &full[s], j * kStep, h, b);
        }
      }
    }
  } else {
    tk8s::regs_inc<kRegsConsumer>();
    const int wg = threadIdx.x / 128 - 1, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int t4 = lane & 3;
    const float sl2 = p.scale * kLog2e;
    const int c0 = B::chunk0(wg);  // this warpgroup's first column chunk of dQ
    int t = 0;
    for (int i = blockIdx.x, n = 0; i < items; i += gridDim.x, ++n) {
      const Item it(p, i, kStep, R);
      const int b = it.bh / p.heads, h = it.bh % p.heads, qb = n % NB, row0 = it.q0 + B::row0(wg);
      const int row[2] = {row0 + warp * 16 + (lane >> 2), row0 + warp * 16 + (lane >> 2) + 8};
      // this warpgroup's rows
      uint8_t* q_rows = sQ + 2 * qb * B::kTile + B::row0(wg) * tk8s::kLine;
      const uint32_t q_addr = tk8s::smem_addr(q_rows), do_addr = q_addr + B::kTile;
      float lse2[2], dd[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float* at = p.rows + row_at(it.bh, p.seq, row[r]);
        lse2[r] = at[0];
        dd[r] = at[kStep];
      }
      float dq[N / 2];
      zero(dq);
      tk8s::mbar_wait(&q_full[qb], (n / NB) & 1);
      for (int j = 0; j < it.tiles; ++j, ++t) {
        const int s = t % S, k0 = j * kStep;
        tk8s::mbar_wait(&full[s], (t / S) & 1);
        // a k tile wholly above the diagonal for this warpgroup's rows, or
        // rows wholly past the sequence: waited for and skipped
        if (row0 < p.seq && !(p.causal && k0 > row0 + 63)) {
          const uint32_t k_addr = tk8s::smem_addr(sRing + s * 2 * B::kRing), v_addr = k_addr + B::kRing;
          // S = Q K^T and dP = dO V^T: row = q row, column c = key k0 + c
          float sc[32], dp[32];
          zero(sc);
          zero(dp);
          tk8s::fence_regs(sc);
          tk8s::fence_regs(dp);
          tk8s::wgmma_fence();
          product_ss<T, D, R>(sc, q_addr, k_addr);
          product_ss<T, D, R>(dp, do_addr, v_addr);
          tk8s::wgmma_commit();
          tk8s::wgmma_wait<0>();
          tk8s::fence_regs(sc);
          tk8s::fence_regs(dp);

          // dS = P (dP - D) with P = exp2(S sl2 - lse2), 0 for a key after
          // the row or past the end (a tile that crosses either masks)
          const bool edge = k0 + kStep > p.seq || (p.causal && k0 + kStep - 1 > row0);
          uint32_t da[4][4];
#pragma unroll
          for (int cb = 0; cb < 8; ++cb) {
            const int c = k0 + 8 * cb + 2 * t4;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int e = 4 * cb + 2 * r;
              float p0 = exp2f(fmaf(sc[e], sl2, -lse2[r])), p1 = exp2f(fmaf(sc[e + 1], sl2, -lse2[r]));
              if (edge) {
                const int last = p.causal ? min(row[r], p.seq - 1) : p.seq - 1;
                if (c > last) p0 = 0.f;
                if (c + 1 > last) p1 = 0.f;
              }
              da[cb / 2][2 * (cb & 1) + r] = tk8s::pack2<T>(p0 * (dp[e] - dd[r]), p1 * (dp[e + 1] - dd[r]));
            }
          }

          // dQ += dS K over this warpgroup's columns, K read MN-major
          tk8s::fence_regs(dq);
          tk8s::wgmma_fence();
          product_rs<T, N>(dq, da, k_addr + c0 * kStep * tk8s::kLine);
          tk8s::wgmma_commit();
          tk8s::wgmma_wait<0>();
          tk8s::fence_regs(dq);
        }
        tk8s::mbar_arrive(&empty[s]);
      }

      // dQ (times the scale) in q's dtype, staged in this warpgroup's rows
      // and columns of its Q tile (split: once the other warpgroup has read
      // them too)
      if (B::kOn) tk8s::named_sync(3, kConsumers);
      uint8_t* dq_rows = q_rows + c0 * R * tk8s::kLine;
      stage_rows<T, N, R>(dq_rows, dq, p.scale);
      tk8s::fence_proxy_async();
      tk8s::named_sync(1 + wg, 128);
      if (threadIdx.x % 128 == 0) {
        if (row0 < p.seq) {
          store_rows<N, R>(&maps.dq, dq_rows, 64 * c0, row0, h, b);
          tk8s::tma_store_commit();
          tk8s::tma_store_wait_read();
        }
        tk8s::mbar_arrive(&q_empty[qb]);  // the buffer may take the item after next
      }
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
  const int rows[4] = {F::kRows, F::kBN, F::kBN, 64};
  const long long b = p.batch, h = p.heads, s = p.seq;
  for (int i = 0; i < 4; ++i) {
    const long long* st = p.strides[i];
    const cudaError_t err =
        tk8s::make_map<T>(out[i], base[i], {p.dim, s, h, b}, {st[1], st[2], st[0]}, {64, rows[i], 1, 1});
    if (err != cudaSuccess) return err;
  }
  static const cudaError_t attr = tk8s::allow_smem(attn_fwd<T, D>, F::kSmem);
  if (attr != cudaSuccess) return attr;
  const int items = cdiv(p.seq, F::kRows) * p.batch * p.heads;
  attn_fwd<T, D><<<(items < sm_count() ? items : sm_count()), kThreads, F::kSmem, stream>>>(maps, p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t backward(const Params& p, cudaStream_t stream) {
  using B = Bwd<D>;
  // every map of the backward, encoded once a call, for both kernels:
  // (head_dim, seq, head, batch) with the tensor's own strides
  BwdMaps maps;
  CUtensorMap* out[7] = {&maps.q, &maps.k, &maps.v, &maps.dout, &maps.dq, &maps.dk, &maps.dv};
  const Tensor which[7] = {kQ, kK, kV, kDO, kDQ, kDK, kDV};
  const void* base[7] = {p.q, p.k, p.v, p.dout, p.dq, p.dk, p.dv};
  const long long b = p.batch, h = p.heads, s = p.seq;
  for (int i = 0; i < 7; ++i) {
    const long long* st = p.strides[which[i]];
    const cudaError_t err =
        tk8s::make_map<T>(out[i], base[i], {p.dim, s, h, b}, {st[1], st[2], st[0]}, {64, kStep, 1, 1});
    if (err != cudaSuccess) return err;
  }
  static const cudaError_t attr_kv = tk8s::allow_smem(attn_bwd_dkdv<T, D>, B::kKVSmem);
  static const cudaError_t attr_q = tk8s::allow_smem(attn_bwd_dq<T, D>, B::kQSmem);
  if (attr_kv != cudaSuccess) return attr_kv;
  if (attr_q != cudaSuccess) return attr_q;
  const long long rows = b * h * row_blocks(p.seq) * kStep;
  attn_bwd_rows<T, D><<<cdiv(rows * (D / 8), 256), 256, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int items = cdiv(p.seq, B::kRows) * p.batch * p.heads;
  const int grid = items < sm_count() ? items : sm_count();
  attn_bwd_dkdv<T, D><<<grid, kThreads, B::kKVSmem, stream>>>(maps, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_dq<T, D><<<grid, kThreads, B::kQSmem, stream>>>(maps, p);
  return cudaGetLastError();
}

template <typename T>
int dispatch_tile(int tile, bool fwd, const Params& p, cudaStream_t s) {
  if (tile == 64) return fwd ? forward<T, 64>(p, s) : backward<T, 64>(p, s);
  if (tile == 128) return fwd ? forward<T, 128>(p, s) : backward<T, 128>(p, s);
  if (tile == 256) return fwd ? forward<T, 256>(p, s) : backward<T, 256>(p, s);
  return cudaErrorInvalidValue;
}

// dtype 0 = bf16, 1 = fp16; the tile width holds head_dim, a multiple of 8
int dispatch(int dtype, int tile, bool fwd, const Params& p, cudaStream_t s) {
  if (p.dim <= 0 || p.dim > tile || p.dim % 8) return cudaErrorInvalidValue;
  if (dtype == 0) return dispatch_tile<__nv_bfloat16>(tile, fwd, p, s);
  if (dtype == 1) return dispatch_tile<__half>(tile, fwd, p, s);
  return cudaErrorInvalidValue;
}

Params make_params(const long long* strides, int n_tensors, int batch, int heads, int seq, int causal,
                   int head_dim, float scale) {
  Params p = {};
  for (int t = 0; t < n_tensors; ++t) {
    for (int d = 0; d < 3; ++d) p.strides[t][d] = strides[3 * t + d];
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

// tile: the kernels' width, 64, 128 or 256, at least head_dim (a
// multiple of 8); scale: 1/sqrt(head_dim) of the caller's own head_dim;
// strides: (batch, seq, head) of q, k, v, o (12 values)
int tk8s_attn_fwd(int dtype, int tile, int head_dim, const void* q, const void* k, const void* v, void* o,
                  float* lse, const long long* strides, int batch, int heads, int seq, int causal, float scale,
                  void* stream) {
  Params p = make_params(strides, 4, batch, heads, seq, causal, head_dim, scale);
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
  return dispatch(dtype, tile, true, p, static_cast<cudaStream_t>(stream));
}

// tile, head_dim and scale as the forward's; strides: (batch, seq, head)
// of q, k, v, o, dout, dq, dk, dv (24 values); rows is f32 scratch of
// batch * heads * 2 * (seq rounded up to 128) values, 16-byte aligned
int tk8s_attn_bwd(int dtype, int tile, int head_dim, const void* q, const void* k, const void* v,
                  const void* o, const void* dout, const float* lse, float* rows, void* dq, void* dk, void* dv,
                  const long long* strides, int batch, int heads, int seq, int causal, float scale,
                  void* stream) {
  Params p = make_params(strides, kTensors, batch, heads, seq, causal, head_dim, scale);
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = const_cast<void*>(o);
  p.dout = dout;
  p.lse = const_cast<float*>(lse);
  p.rows = rows;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  return dispatch(dtype, tile, false, p, static_cast<cudaStream_t>(stream));
}

const char* tk8s_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"

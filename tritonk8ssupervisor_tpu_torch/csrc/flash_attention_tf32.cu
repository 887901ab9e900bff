// K2's float32 instance on Hopper: exact softmax attention, forward and
// backward, for sm_90a, with every product a 3xTF32 product on the tensor
// cores.
//
// Replaces, for float32 q, k and v, the same TPU kernels as
// csrc/flash_attention.cu: `_splash_kernel` and `_tuned_library_flash`,
// reached from tritonk8ssupervisor_tpu/ops/flash_attention.py's
// `flash_attention`, which takes any float dtype. The bf16 and fp16
// instances live there; this file is the f32 one.
//
// The split. One TF32 product keeps 11 of an operand's 24 significand
// bits and misses the f32 contract, an error bound against a float64
// evaluation (tests/test_torch_kernels.py), by more than 10x. So every
// f32 operand x is split into hi = tf32(x) (cvt.rna) and lo = x - hi,
// and every product a b is taken as lo(a) hi(b) + hi(a) lo(b) +
// hi(a) hi(b), the small terms first, into one f32 accumulator: about 22
// bits of each operand; the lo lo term, below 2^-22 of the product, is
// dropped (tests/test_torch_tf32x3.py holds this plan against float64).
// lo is x - hi exactly; the tensor cores read its top 19 bits.
//
// What bounds it on an H100: 495 TFLOP/s of dense TF32 and three TF32
// products for each f32 one, so 165 TFLOP/s of f32-accurate products
// (`utils/roofline.PEAK_F32_PRODUCT_FLOPS`). The LM's (8, 1024, 12, 64)
// causal forward is 12.9 GFLOP (0.078 ms at that rate) against ~101 MB
// (0.030 ms at 3.35 TB/s); the backward 32.2 GFLOP (0.195 ms) against
// ~202 MB. The operations bound both, so the design keeps the tensor
// cores fed: the scores stay in registers, every streamed tile is split
// once where it arrives, and the tiles above the causal diagonal are
// skipped.
//
// Structure, as csrc/flash_attention.cu's (FlashAttention-3): 384
// threads, warpgroup 0 the producer feeding an mbarrier ring, warpgroups
// 1 and 2 consumers of 64 rows each; one persistent CTA per SM walks the
// work items, the longest causal items first; the producer's registers
// go to the consumers (`setmaxnreg`: 120 and 192 a thread, 56 and 224 in
// dK/dV, below which ptxas serializes its wgmmas). What differs is forced
// by TF32:
//
//   - wgmma takes TF32 operands K-major only (no transposed descriptor),
//     and both parts of each. So O += P V, dV += P^T dO, dK += dS^T Q and
//     dQ += dS K need V, dO, Q and K with the sequence contiguous, which
//     no copy of the tensors has. The producer is therefore the whole
//     warpgroup, not one thread issuing TMA loads: it reads each tile
//     with plain 16-byte loads (any strides, so every f32 view runs in
//     place and nothing is copied; rows past the sequence and columns past
//     head_dim read as zeros), splits it in registers and writes hi and lo
//     in the 128-byte-swizzled K-major layout each product needs, as rows
//     or transposed. A stage's loads are all issued before its slot is
//     free (the forward's one stage ahead, while the stage before is
//     stored); a backward step's rows are loaded once and stored both as
//     rows and transposed. TMA could deliver the f32 tile, but the split
//     would then need a second copy of it in shared memory.
//   - Shared memory: an f32 tile is twice a bf16 one and hi and lo double
//     it again, so a 64 x 256 operand is 128 KB. The streamed operands
//     therefore come in 64-column chunks of the head_dim, one chunk a
//     ring stage of 32 KB (stage order per step: the chunks the score
//     products reduce over, then those the output products write).
//   - The item's own tiles (q in the forward, K and V for dK/dV, Q and dO
//     for dQ) are held raw (copied by cp.async), and the consumers split
//     their A fragments from them at every step: split tiles would take
//     twice the shared memory and leave two ring stages, and at the
//     backward's 32-row steps a product with both operands in shared
//     memory is bound by shared-memory reads (the tensor cores' 32 x 8
//     TF32 B tile a clock needs 64 bytes, the 64 x 8 A tile 128 more).
//   - A from registers: P and dS are split in registers as A fragments.
//     The accumulator holds columns (2t, 2t + 1) of each 8-column block
//     where a TF32 A fragment wants (t, t + 4), so the producer writes
//     every transposed tile with its sequence positions permuted within
//     each block of 8 (`permuted`): logical k = t is position 2t, t + 4
//     is 2t + 1. The product is the same sum in another order.
//
// Per head_dim width D (the head_dim rounded up to 64, 128 or 256;
// columns past it read as zeros and are never written): an item is 128
// rows, each consumer warpgroup 64 of them over all columns, or, where
// the accumulators would not fit (the forward at D = 256, the backward at
// D = 128 and 256), 64 rows that both consumer warpgroups share, each
// accumulating half of the output's 64-column chunks (both compute the
// item's whole score tiles: 3 units of tensor work for 2). Shared memory
// a CTA (D = 64, 128, 256): the forward, q raw (34, 66 or 65 KB) and a
// ring of 5, 4 or 4 stages; dK/dV and dQ, the item's two raw tiles (68, 66
// or 130 KB) and 4, 4 or 2 stages.
//
//   attn_tf32_fwd   items of (rows, batch*head); per 64-key tile: S = Q
//                   K^T chunk by chunk (K as rows), the online softmax in
//                   f32 registers (exp2 with the scale folded in), P
//                   split, O += P V chunk by chunk (V transposed); O / l
//                   and the (B, H, S) f32 logsumexp written.
//   attn_tf32_rows  D = rowsum(dO * O) per q row, a warp a row.
//   attn_tf32_dkdv  items of (keys, batch*head); per 32-row q step at and
//                   below the diagonal: S^T = K Q^T and dP^T = V dO^T
//                   (Q, dO as rows; the step's lse and D rows ride in its
//                   last row stage), P^T and dS^T = P^T (dP^T - D) split,
//                   dV += P^T dO and dK += dS^T Q (dO, Q transposed).
//   attn_tf32_dq    items of (rows, batch*head); per 32-key step at and
//                   left of the diagonal: S = Q K^T, dP = dO V^T (K, V as
//                   rows), dS split, dQ += dS K (K transposed).
//
// A row with a single key (a causal row 0, every row of a one-token
// sequence) has P = 1 and D = dP, so its dS is exactly 0 in the
// function; here D and dP come from different units (the CUDA cores'
// sum and the tensor cores' products) and need not cancel bit for bit,
// so both backward kernels set dS of such rows to 0, which is the exact
// value, and dq and dk of a one-token sequence come out exactly 0.
//
// dK and dQ are scaled once at the end. Outputs are stored from the
// accumulators with their strides. Determinism: no atomics; every output
// row is written by the one CTA that owns its item, after sums in a fixed
// order, so two calls on the same inputs are bit-equal.
//
// Plain C interface, loaded with ctypes (ops/flash_attention_cuda.py).
// Each entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() after its launches.

#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 384;   // warpgroup 0 the producer, 1 and 2 consumers
constexpr int kProducer = 128;
constexpr int kConsumers = 256;
constexpr int kStep = 32;       // q rows (dK/dV) or keys (dQ) a backward step
constexpr int kPart = kStep * 256;  // a split part of a backward stage: 32 rows x 64 columns
constexpr int kKeys = 64;       // keys a forward step
constexpr int kStage = 32768 + tk8s::kAtom;  // a ring stage: 32 KB of tiles, a tail for rows
constexpr int kMaxSmem = 227 * 1024;
// registers a thread: the producer's warpgroup gives its own to the two
// consumer warpgroups (the kernels are launched with 168 a thread: 128 x 120
// + 256 x 192 = 384 x 168); the producer holds a stage's loads in flight
constexpr int kRegsProducer = 120, kRegsConsumer = 192;
// dK/dV holds both accumulators beside its score tiles: below 224 ptxas
// serializes its wgmmas; its producer loads one stage at a time
constexpr int kRegsProducerDkDv = 56, kRegsConsumerDkDv = 224;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

enum Tensor { kQ, kK, kV, kO, kDO, kDQ, kDK, kDV, kTensors };

struct Params {
  const float* ptr[kTensors];
  long long st[kTensors][4];  // (batch, seq, head, head_dim) strides in elements
  int vec[kTensors];          // 16-byte loads: unit head_dim stride, strides and start 16-byte aligned
  float* lse;                 // (batch, heads, seq) natural-log logsumexp of the scaled scores
  float* rows;                // (batch, heads, seq): rowsum(dO * O)
  int batch, heads, seq, dim, causal;
  float scale;                // 1/sqrt(head_dim)
};

__host__ __device__ constexpr int cdiv(long long a, int b) { return static_cast<int>((a + b - 1) / b); }

// Per tile width D: rows an item holds and how the two consumer
// warpgroups share them, split above a width of kSplitAbove (the header)
template <int D, int kSplitAbove = 64>
struct Cfg {
  static constexpr int kChunks = D / 64;  // 64-column chunks of the head_dim
  static constexpr bool kSplit = D > kSplitAbove;
  static constexpr int kRows = kSplit ? 64 : 128;
  static constexpr int kOwn = kSplit ? kChunks / 2 : kChunks;  // output chunks a warpgroup accumulates
  static constexpr int kRawStride = D + 4;  // floats a raw row: conflict-free fragment reads
  static constexpr int kRaw = kRows * kRawStride * 4;
  // k-steps of raw tiles split into A fragments at once (8 registers a
  // k-step and tile), as many as leave the wgmmas unserialized: dK/dV holds
  // both accumulators beside its two tiles' fragments
  static constexpr int kGroupDkDv = D == 256 ? 1 : 2;
  static constexpr int kGroupDq = D == 256 ? 2 : 4;
  static constexpr int kGroupFwd = D == 64 ? 4 : 2;  // the forward's q, one tile
  __device__ static int row0(int wg) { return kSplit ? 0 : 64 * wg; }
  __device__ static int chunk0(int wg) { return kSplit ? wg * kOwn : 0; }
};

// ----- the split and the layouts

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo: hi rounded to TF32, lo the exact rest (the tensor cores
// read its top 19 bits)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// Byte offset of element (line r, k) in a K-major tile of `lines` lines
// per 32-element chunk of K: 128-byte lines (32 f32), 16-byte unit u of
// line r at u ^ (r & 7), as the wgmma descriptor reads it.
__device__ __forceinline__ uint32_t kmajor(int r, int k, int lines) {
  return (k >> 5) * lines * tk8s::kLine + r * tk8s::kLine + ((((k >> 2) & 7) ^ (r & 7)) << 4) + ((k & 3) << 2);
}

// The k-th position (of a step) of a transposed tile: within each 8, the
// A fragment's column t holds position 2t and column t + 4 position 2t + 1
__device__ __forceinline__ int permuted(int s) { return (s & ~7) | ((s & 6) >> 1) | ((s & 1) << 2); }

// Descriptor of k-step kk (8 f32, 32 bytes) of a K-major tile
__device__ __forceinline__ uint64_t desc(uint32_t tile, int lines, int kk) {
  return tk8s::desc_k_major(tile + (kk >> 2) * lines * tk8s::kLine + (kk & 3) * 32);
}

// The TF32 A fragment of warp w's 16 rows and a k-step's 8 columns:
// register e holds (row g + frag_row(e), column t + frag_col(e)) for lane
// 4 g + t (mma.sync's m16n8k8 TF32 A layout)
__host__ __device__ constexpr int frag_row(int e) { return 8 * (e & 1); }
__host__ __device__ constexpr int frag_col(int e) { return 4 * (e >> 1); }

// ----- wgmma, TF32 inputs, A in registers, B K-major in shared memory

#define TK8S_TF32_REGS16 "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15}"
#define TK8S_TF32_ACC16 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])

// D (64 x 32) += A (64 x 8) B (8 x 32)
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " TK8S_TF32_REGS16
               ", {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
               : TK8S_TF32_ACC16
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 64) += A (64 x 8) B (8 x 64)
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " TK8S_WGMMA_REGS32
               ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
               : TK8S_WGMMA_ACC32
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int G>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[G][4]) {
#pragma unroll
  for (int j = 0; j < G; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[j][e])::"memory");
  }
}

// Issue acc (64 x N) += A B over KS k-steps, A split fragments in
// registers, B hi and lo tiles of N lines at their k-steps kk0 + [0, KS).
// The caller fences the accumulator and the fragments, commits and waits.
template <int N, int KS>
__device__ __forceinline__ void issue_rs(float (&acc)[N / 2], uint32_t (&ahi)[KS][4], uint32_t (&alo)[KS][4],
                                         uint32_t b_hi, uint32_t b_lo, int kk0 = 0) {
#pragma unroll
  for (int j = 0; j < KS; ++j) wgmma_tf32(acc, alo[j], desc(b_hi, N, kk0 + j));
#pragma unroll
  for (int j = 0; j < KS; ++j) wgmma_tf32(acc, ahi[j], desc(b_lo, N, kk0 + j));
#pragma unroll
  for (int j = 0; j < KS; ++j) wgmma_tf32(acc, ahi[j], desc(b_hi, N, kk0 + j));
}

// the end of a group of issued products
__device__ __forceinline__ void settle() {
  tk8s::wgmma_commit();
  tk8s::wgmma_wait<0>();
}

// k-steps [kk0, kk0 + G) of a warpgroup's 64 rows of a raw tile (`raw` at
// its first row) as split A fragments
template <int D, int G>
__device__ __forceinline__ void raw_frags(uint32_t (&hi)[G][4], uint32_t (&lo)[G][4], const float* raw, int kk0) {
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const float* base = raw + (16 * warp + (lane >> 2)) * Cfg<D>::kRawStride + (lane & 3);
#pragma unroll
  for (int j = 0; j < G; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      split(base[frag_row(e) * Cfg<D>::kRawStride + 8 * (kk0 + j) + frag_col(e)], hi[j][e], lo[j][e]);
    }
  }
}

// An accumulator of 64 x (8 KS) scores as the split A fragments of its KS
// k-steps: fragment register e of k-step kc is accumulator element 4 kc +
// 2 (row half) + (column 2t + 1), the positions the transposed tiles permute
template <int KS>
__device__ __forceinline__ void acc_frags(uint32_t (&hi)[KS][4], uint32_t (&lo)[KS][4], const float (&acc)[4 * KS]) {
#pragma unroll
  for (int kc = 0; kc < KS; ++kc) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      split(acc[4 * kc + (frag_row(e) ? 2 : 0) + (frag_col(e) ? 1 : 0)], hi[kc][e], lo[kc][e]);
    }
  }
}

// ----- tensors in device memory

__device__ __forceinline__ const float* row_ptr(const Params& p, Tensor t, int b, int h, int s) {
  return p.ptr[t] + b * p.st[t][0] + s * p.st[t][1] + h * p.st[t][2];
}

// elements (s, d .. d + 3) of tensor t at (b, h), one at a time; zeros
// past the sequence and past head_dim
__device__ __forceinline__ float4 load4_slow(const Params& p, Tensor t, int b, int h, int s, int d) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (s >= p.seq || d >= p.dim) return v;
  const float* x = row_ptr(p, t, b, h, s);
  const long long ds = p.st[t][3];
  v.x = __ldg(x + d * ds);
  if (d + 1 < p.dim) v.y = __ldg(x + (d + 1) * ds);
  if (d + 2 < p.dim) v.z = __ldg(x + (d + 2) * ds);
  if (d + 3 < p.dim) v.w = __ldg(x + (d + 3) * ds);
  return v;
}

__device__ const float4 kZero4 = {0.f, 0.f, 0.f, 0.f};

// The same four elements as one 16-byte load, issued whatever the case
// (zeros come from kZero4) so that a thread's loads are all in flight at
// once; `slow` is set where the one load cannot take them (a head_dim
// stride other than 1, an unaligned row, the last partial four) and
// load4_slow must fetch them.
__device__ __forceinline__ float4 fetch4(const Params& p, Tensor t, const float* head, int s, int d, bool& slow) {
  const bool in = s < p.seq && d < p.dim, fast = in && p.vec[t] && d + 4 <= p.dim;
  slow = in && !fast;
  const float* x = fast ? head + s * p.st[t][1] + d : reinterpret_cast<const float*>(&kZero4);
  return __ldg(reinterpret_cast<const float4*>(x));
}

// tensor t's (b, h) at sequence position 0
__device__ __forceinline__ const float* head_ptr(const Params& p, Tensor t, int b, int h) {
  return p.ptr[t] + b * p.st[t][0] + h * p.st[t][2];
}

// (row s, columns d and d + 1) of output t, clipped to the sequence and
// head_dim
__device__ __forceinline__ void store2(const Params& p, Tensor t, int b, int h, int s, int d, float x0, float x1) {
  if (s >= p.seq || d >= p.dim) return;
  float* y = const_cast<float*>(row_ptr(p, t, b, h, s));
  if (p.vec[t] && d + 2 <= p.dim) {
    *reinterpret_cast<float2*>(y + d) = make_float2(x0, x1);
    return;
  }
  const long long ds = p.st[t][3];
  y[d * ds] = x0;
  if (d + 1 < p.dim) y[(d + 1) * ds] = x1;
}

// ----- the producer's fills (all 128 producer threads)

// What a ring stage holds: `blocks` (1 or 2) blocks of ROWS rows x 64
// columns, of tensors t[0] and t[1], from row r0 and column c0; block i's
// hi part at 2 i ROWS 256 bytes into the stage, its lo part after it.
// Stored as ROWS lines of 64 k (K-major over the head_dim), or transposed:
// 64 lines (the columns) of ROWS k, the rows permuted within each 8
// (`permuted`).
struct Job {
  Tensor t[2];
  int blocks, r0, c0;
  bool transposed;
  bool gathered_transposed;  // the pieces were gathered in the transposed mapping (below)
};

// A producer thread's share of a stage between loading and storing: ROWS
// / 8 16-byte pieces of each of B blocks. As rows, piece u of thread x is
// row x / 16 + 8 u, columns 4 (x % 16) + [0, 4); transposed, row x % ROWS,
// columns 4 (x / ROWS) + (512 / ROWS) u + [0, 4), so that a warp's lanes
// take 32 rows of one column group and each scalar store fills a whole
// line. Either way a piece's line differs from piece 0's by a multiple of
// 8, so its swizzled offset is piece 0's plus a constant.
template <int ROWS, int B>
struct Pieces {
  static constexpr int kN = ROWS / 8;
  float4 v[B][kN];
  bool slow[B][kN];
};

template <int ROWS>
__device__ __forceinline__ void piece_at(bool transposed, int u, int& r, int& k) {
  const int x = threadIdx.x;
  r = transposed ? x % ROWS : x / 16 + 8 * u;
  k = transposed ? 4 * (x / ROWS) + (512 / ROWS) * u : 4 * (x % 16);
}

// issue a stage's loads (all in flight at once)
template <int ROWS, int B>
__device__ __forceinline__ void gather(Pieces<ROWS, B>& d, const Job& job, const Params& p, int b, int h) {
#pragma unroll
  for (int i = 0; i < B; ++i) {
    if (i < job.blocks) {
      const float* head = head_ptr(p, job.t[i], b, h);
#pragma unroll
      for (int u = 0; u < Pieces<ROWS, B>::kN; ++u) {
        int r, k;
        piece_at<ROWS>(job.gathered_transposed, u, r, k);
        d.v[i][u] = fetch4(p, job.t[i], head, job.r0 + r, job.c0 + k, d.slow[i][u]);
      }
    }
  }
}

// split a stage's loads and store them into `stage`: block i's hi part at
// 2 i ROWS 256 bytes, its lo part after it
template <int ROWS, int B>
__device__ __forceinline__ void scatter(const Pieces<ROWS, B>& d, const Job& job, uint8_t* stage, const Params& p,
                                        int b, int h) {
  constexpr int kN = Pieces<ROWS, B>::kN, kBlock = ROWS * 256;
  const int x = threadIdx.x;
#pragma unroll
  for (int i = 0; i < B; ++i) {
    if (i >= job.blocks) continue;
    uint8_t* hi = stage + 2 * i * kBlock;
    uint8_t* lo = hi + kBlock;
    if (!job.transposed) {
      // gathered as rows, piece u's line is piece 0's plus 8 u
      const uint32_t off = kmajor(x / 16, 4 * (x % 16), ROWS);
#pragma unroll
      for (int u = 0; u < kN; ++u) {
        int r, k;
        piece_at<ROWS>(job.gathered_transposed, u, r, k);
        const float4 v = d.slow[i][u] ? load4_slow(p, job.t[i], b, h, job.r0 + r, job.c0 + k) : d.v[i][u];
        uint4 vh, vl;
        split(v.x, vh.x, vl.x);
        split(v.y, vh.y, vl.y);
        split(v.z, vh.z, vl.z);
        split(v.w, vh.w, vl.w);
        const uint32_t at = job.gathered_transposed ? kmajor(r, k, ROWS) : off + u * 8 * tk8s::kLine;
        *reinterpret_cast<uint4*>(hi + at) = vh;
        *reinterpret_cast<uint4*>(lo + at) = vl;
      }
    } else {
      const int kq = permuted(x % ROWS), k4 = 4 * (x / ROWS);
      uint32_t off[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) off[e] = kmajor(k4 + e, kq, 64);
#pragma unroll
      for (int u = 0; u < kN; ++u) {
        int r, k;
        piece_at<ROWS>(true, u, r, k);
        const float4 v = d.slow[i][u] ? load4_slow(p, job.t[i], b, h, job.r0 + r, job.c0 + k) : d.v[i][u];
        const float e4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          uint32_t vh, vl;
          split(e4[e], vh, vl);
          const uint32_t at = off[e] + u * (512 / ROWS) * tk8s::kLine;
          *reinterpret_cast<uint32_t*>(hi + at) = vh;
          *reinterpret_cast<uint32_t*>(lo + at) = vl;
        }
      }
    }
  }
}

// a stage the producer has filled, for the async proxy (wgmma) to read
__device__ __forceinline__ void publish(uint64_t* full) {
  tk8s::fence_proxy_async();
  tk8s::mbar_arrive(full);
}

// The producer's side of one backward step of kStep rows from r0: per
// 64-column chunk c, the rows of tensors t0 and t1 (`blocks` of them, as
// rows) go to stage t + c and their transposes (of t0 alone when
// `tr_blocks` is 1) to stage t + C + c, the order the consumers take them
// in. Each chunk is loaded once and stored twice while the ring has more
// than C stages; otherwise each stage is loaded in the consumers' order.
// `tail(stage, c)` adds to a row stage after its tiles.
template <int C, int S, typename Tail>
__device__ __forceinline__ void produce_step(uint8_t* ring, uint64_t* full, uint64_t* empty, int t, Tensor t0,
                                             Tensor t1, int tr_blocks, int r0, const Params& p, int b, int h,
                                             const Tail& tail) {
  const auto put = [&](const Pieces<kStep, 2>& d, int z, bool transposed, bool gathered_transposed) {
    const int s = (t + z) % S;
    uint8_t* stage = ring + s * kStage;
    const Job job{{t0, t1}, transposed ? tr_blocks : 2, r0, 64 * (z % C), transposed, gathered_transposed};
    tk8s::mbar_wait(&empty[s], (((t + z) / S) & 1) ^ 1);
    scatter(d, job, stage, p, b, h);
    if (!transposed) tail(stage, z);
    publish(&full[s]);
  };
  if constexpr (S > C) {
#pragma unroll 1
    for (int c = 0; c < C; ++c) {
      // gathered in the transposed mapping, which the row stores also take
      // at full width
      Pieces<kStep, 2> d;
      gather(d, Job{{t0, t1}, 2, r0, 64 * c, true, true}, p, b, h);
      put(d, c, false, true);
      put(d, C + c, true, true);
    }
  } else {
#pragma unroll 1
    for (int z = 0; z < 2 * C; ++z) {
      Pieces<kStep, 2> d;
      gather(d, Job{{t0, t1}, z < C ? 2 : tr_blocks, r0, 64 * (z % C), z >= C, z >= C}, p, b, h);
      put(d, z, z >= C, z >= C);
    }
  }
}

// rows [r0, r0 + ROWS) of tensor t, raw f32, rows kRawStride apart: every
// 16-byte piece an asynchronous copy (cp.async, all in flight at once;
// zeros where the piece lies wholly outside the tensor), and the pieces
// one load cannot take element by element; the caller then waits with
// `raw_wait`
template <int D, int ROWS>
__device__ __forceinline__ void put_raw(float* dst, const Params& p, Tensor t, int b, int h, int r0) {
  constexpr int kPer = ROWS * D / 4 / kProducer;
  const float* head = head_ptr(p, t, b, h);
#pragma unroll 4
  for (int u = 0; u < kPer; ++u) {
    const int i = threadIdx.x + kProducer * u, r = i / (D / 4), k = (i % (D / 4)) * 4, s = r0 + r;
    float* to = dst + r * Cfg<D>::kRawStride + k;
    const bool in = s < p.seq && k < p.dim, fast = in && p.vec[t] && k + 4 <= p.dim;
    if (in && !fast) {
      *reinterpret_cast<float4*>(to) = load4_slow(p, t, b, h, s, k);
    } else {
      const float* from = fast ? head + s * p.st[t][1] + k : reinterpret_cast<const float*>(&kZero4);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(tk8s::smem_addr(to)), "l"(from),
                   "r"(fast ? 16 : 0)
                   : "memory");
    }
  }
}

// until this thread's raw-tile copies have landed
__device__ __forceinline__ void raw_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Work item i of a call over items of `rows` rows: the longest causal
// rows first; (q0, bh, the other side's steps of `step`)
struct Item {
  int q0, bh, steps;
  __device__ Item(const Params& p, int i, int step, int rows) {
    const int bhs = p.batch * p.heads;
    q0 = (cdiv(p.seq, rows) - 1 - i / bhs) * rows;
    bh = i % bhs;
    steps = p.causal ? min(cdiv(p.seq, step), cdiv(q0 + rows, step)) : cdiv(p.seq, step);
  }
};

// Work item i of the dK/dV kernel: `rows` keys, the first keys (the most
// q steps under a causal mask) first, and its q steps [first, last)
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

template <int NB, int S>
__device__ __forceinline__ void init_barriers(uint64_t* item_full, uint64_t* item_empty, uint64_t* full,
                                              uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < NB; ++i) {
      tk8s::mbar_init(&item_full[i], kProducer);
      tk8s::mbar_init(&item_empty[i], kConsumers);
    }
    for (int s = 0; s < S; ++s) {
      tk8s::mbar_init(&full[s], kProducer);
      tk8s::mbar_init(&empty[s], kConsumers);
    }
    tk8s::mbar_init_fence();
  }
  __syncthreads();
}

// ----- the forward

// q held raw (its rows kRawStride apart), the consumers splitting their A
// fragments at every step; items of 128 rows up to D = 128
template <int D>
struct Fwd : Cfg<D, 128> {
  static constexpr int kStages = (kMaxSmem - tk8s::kAtom - Fwd::kRaw) / kStage;
  static constexpr int kSmem = kStages * kStage + Fwd::kRaw + tk8s::kAtom;
  static_assert(kStages >= 2 && kSmem <= kMaxSmem, "a CTA's shared memory");
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1) attn_tf32_fwd(const __grid_constant__ Params p) {
  using F = Fwd<D>;
  constexpr int R = F::kRows, S = F::kStages, C = F::kChunks, CW = F::kOwn, G = F::kGroupFwd;
  constexpr int kTile = kKeys * 256;  // a split part of a stage: 64 keys x 64 columns
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t item_full[1], item_empty[1], full[S], empty[S];
  uint8_t* ring = tk8s::align_atom(smem_raw);
  float* q_raw = reinterpret_cast<float*>(ring + S * kStage);
  const int items = cdiv(p.seq, R) * p.batch * p.heads;
  init_barriers<1, S>(item_full, item_empty, full, empty);

  if (threadIdx.x < kProducer) {
    tk8s::regs_dec<kRegsProducer>();
    int t = 0;  // stages filled so far: the ring position
    for (int i = blockIdx.x, n = 0; i < items; i += gridDim.x, ++n) {
      const Item it(p, i, kKeys, R);
      const int b = it.bh / p.heads, h = it.bh % p.heads;
      tk8s::mbar_wait(&item_empty[0], (n & 1) ^ 1);
      put_raw<D, R>(q_raw, p, kQ, b, h, it.q0);
      raw_wait();
      tk8s::mbar_arrive(&item_full[0]);
      // per key step, K's chunks as rows, then V's transposed; each
      // stage's loads are issued while the one before is split and stored
      const auto job = [&](int z) {
        const int c = z % (2 * C);
        const Tensor x = c < C ? kK : kV;
        return Job{{x, x}, 1, z / (2 * C) * kKeys, 64 * (c % C), c >= C, c >= C};
      };
      const int stages = it.steps * 2 * C;
      Pieces<kKeys, 1> cur, next;
      Job at = job(0);
      gather(cur, at, p, b, h);
      for (int z = 0; z < stages; ++z, ++t) {
        const Job now = at;
        if (z + 1 < stages) {
          at = job(z + 1);
          gather(next, at, p, b, h);
        }
        const int s = t % S;
        tk8s::mbar_wait(&empty[s], ((t / S) & 1) ^ 1);
        scatter(cur, now, ring + s * kStage, p, b, h);
        publish(&full[s]);
        cur = next;
      }
    }
    return;
  }

  tk8s::regs_inc<kRegsConsumer>();
  const int wg = threadIdx.x / 128 - 1, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int t4 = lane & 3, seq = p.seq, c0 = F::chunk0(wg);
  const float sl2 = p.scale * kLog2e;  // exp(x * scale) = exp2(x * sl2)
  const float* q_rows = q_raw + F::row0(wg) * F::kRawStride;  // this warpgroup's rows
  int t = 0;
  for (int i = blockIdx.x, n = 0; i < items; i += gridDim.x, ++n) {
    const Item it(p, i, kKeys, R);
    const int b = it.bh / p.heads, h = it.bh % p.heads, wg_row0 = it.q0 + F::row0(wg);
    const int row[2] = {wg_row0 + warp * 16 + (lane >> 2), wg_row0 + warp * 16 + (lane >> 2) + 8};
    float o[CW][32];
#pragma unroll
    for (int cc = 0; cc < CW; ++cc) {
#pragma unroll
      for (int e = 0; e < 32; ++e) o[cc][e] = 0.f;
    }
    // running max of the scaled scores (log2 units) and this thread's
    // share of the running sum
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    tk8s::mbar_wait(&item_full[0], n & 1);
    for (int j = 0; j < it.steps; ++j) {
      const int k0 = j * kKeys;
      // a tile wholly above the diagonal for this warpgroup's rows: its
      // stages are waited for (the ring stays in step) and skipped
      const bool active = !(p.causal && k0 > wg_row0 + 63);
      float sc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c, ++t) {  // S = Q K^T, chunk c of the head_dim
        const int s = t % S;
        tk8s::mbar_wait(&full[s], (t / S) & 1);
        if (active) {
          // q's fragments of this chunk, split G k-steps at a time (more
          // would serialize the wgmmas), against K's
          const uint32_t k_hi = tk8s::smem_addr(ring + s * kStage);
#pragma unroll
          for (int g = 0; g < 8; g += G) {
            uint32_t qhi[G][4], qlo[G][4];
            raw_frags<D, G>(qhi, qlo, q_rows, 8 * c + g);
            tk8s::fence_regs(sc);
            fence_frags(qhi);
            fence_frags(qlo);
            tk8s::wgmma_fence();
            issue_rs<kKeys, G>(sc, qhi, qlo, k_hi, k_hi + kTile, g);
            settle();
            tk8s::fence_regs(sc);
            fence_frags(qhi);
            fence_frags(qlo);
          }
        }
        tk8s::mbar_arrive(&empty[s]);
      }
      uint32_t phi[8][4], plo[8][4];
      if (active) {
        // only a tile that crosses the diagonal or the sequence's end masks
        if (k0 + kKeys > seq || (p.causal && k0 + kKeys - 1 > wg_row0)) {
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            const int col = k0 + 8 * (e >> 2) + 2 * t4 + (e & 1);
            if (col >= seq || (p.causal && col > row[(e >> 1) & 1])) sc[e] = -INFINITY;
          }
        }
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int e = 0; e < 32; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
        float alpha[2], rowsum[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          // a row's columns sit in the 4 lanes of its group
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m[r], mx[r] * sl2);
          alpha[r] = exp2f(m[r] - m_new);  // 0 on the first tile: column 0 is never masked
          m[r] = m_new;
        }
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int r = (e >> 1) & 1;
          sc[e] = exp2f(fmaf(sc[e], sl2, -m[r]));
          rowsum[r] += sc[e];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rowsum[r];
#pragma unroll
        for (int cc = 0; cc < CW; ++cc) {
#pragma unroll
          for (int e = 0; e < 32; ++e) o[cc][e] *= alpha[(e >> 1) & 1];
        }
        acc_frags<8>(phi, plo, sc);
      }
#pragma unroll
      for (int c = 0; c < C; ++c, ++t) {  // O += P V, chunk c of the output
        const int s = t % S;
        tk8s::mbar_wait(&full[s], (t / S) & 1);
        const uint32_t v_hi = tk8s::smem_addr(ring + s * kStage);
#pragma unroll
        for (int cc = 0; cc < CW; ++cc) {
          if (active && c == c0 + cc) {
            tk8s::fence_regs(o[cc]);
            fence_frags(phi);
            fence_frags(plo);
            tk8s::wgmma_fence();
            issue_rs<64, 8>(o[cc], phi, plo, v_hi, v_hi + kTile);
            settle();
            tk8s::fence_regs(o[cc]);
            fence_frags(phi);
            fence_frags(plo);
          }
        }
        tk8s::mbar_arrive(&empty[s]);
      }
    }
    tk8s::mbar_arrive(&item_empty[0]);  // q's buffer may take the next item

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
    for (int cc = 0; cc < CW; ++cc) {
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int r = (e >> 1) & 1, col = 64 * (c0 + cc) + 8 * (e >> 2) + 2 * t4;
        store2(p, kO, b, h, row[r], col, o[cc][e] * inv[r], o[cc][e + 1] * inv[r]);
      }
    }
    // split: both warpgroups hold the same rows' logsumexp; one writes it
    if (t4 == 0 && (!F::kSplit || wg == 0)) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (row[r] < seq) p.lse[(long long)it.bh * seq + row[r]] = (m[r] + log2f(l[r])) * kLn2;
      }
    }
  }
}

// ----- the backward

// D = rowsum(dO * O) per q row: a warp a row, lanes over the head_dim
__global__ void __launch_bounds__(256) attn_tf32_rows(Params p) {
  const long long row = static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<long long>(p.batch) * p.heads * p.seq) return;
  const int bh = static_cast<int>(row / p.seq), s = static_cast<int>(row % p.seq);
  const int b = bh / p.heads, h = bh % p.heads;
  const float* o = row_ptr(p, kO, b, h, s);
  const float* d = row_ptr(p, kDO, b, h, s);
  const long long so = p.st[kO][3], sd = p.st[kDO][3];
  float acc = 0.f;
  for (int k = lane; k < p.dim; k += 32) acc = fmaf(__ldg(d + k * sd), __ldg(o + k * so), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.rows[row] = acc;
}

// The item's two own tiles (K and V for dK/dV, Q and dO for dQ) are held
// raw (f32 rows kRawStride apart), one after the other, and the consumers
// split their A fragments at every step: split in shared memory they
// would leave two stages of ring, and a product with both operands in
// shared memory at the steps' N = 32 is bound by shared-memory reads
template <int D>
struct Bwd : Cfg<D> {
  static constexpr int kItems = 2 * Cfg<D>::kRaw;
  static constexpr int kStages = (kMaxSmem - tk8s::kAtom - kItems) / kStage;
  static constexpr int kSmem = kStages * kStage + kItems + tk8s::kAtom;
  static_assert(kStages >= 2 && kSmem <= kMaxSmem, "a CTA's shared memory");
};


// whether q row `row`, alone in its row, has a single key: then dS = 0
__device__ __forceinline__ bool single_key(const Params& p, int row) {
  return p.seq == 1 || (p.causal && row == 0);
}

// the item's own tiles of tensors t0 and t1, rows [r0, r0 + R), as Bwd lays
// them out at `items`
template <int D>
__device__ __forceinline__ void put_items(uint8_t* items, Tensor t0, Tensor t1, const Params& p, int b, int h,
                                          int r0) {
  using B = Bwd<D>;
  float* raw = reinterpret_cast<float*>(items);
  put_raw<D, B::kRows>(raw, p, t0, b, h, r0);
  put_raw<D, B::kRows>(raw + B::kRows * B::kRawStride, p, t1, b, h, r0);
  raw_wait();
}

// acc0 += X0 B0 and acc1 += X1 B1 over chunk c (N = kStep lines of B): X0
// and X1 a warpgroup's 64 rows of the item's two raw tiles, split into A
// fragments G k-steps at a time (registers: 16 G), B0 and B1 the chunk's
// hi and lo tiles at b0 and b1 (lo kPart after hi); both products of a
// group in flight at once
template <int D, int G>
__device__ __forceinline__ void item_products(float (&acc0)[16], float (&acc1)[16], const uint8_t* items, int wg,
                                              int c, uint32_t b0, uint32_t b1) {
  using B = Bwd<D>;
  const float* x0 = reinterpret_cast<const float*>(items) + B::row0(wg) * B::kRawStride;
  const float* x1 = x0 + B::kRows * B::kRawStride;
#pragma unroll
  for (int g = 0; g < 8; g += G) {
    uint32_t hi0[G][4], lo0[G][4], hi1[G][4], lo1[G][4];
    raw_frags<D, G>(hi0, lo0, x0, 8 * c + g);
    raw_frags<D, G>(hi1, lo1, x1, 8 * c + g);
    tk8s::fence_regs(acc0);
    tk8s::fence_regs(acc1);
    fence_frags(hi0);
    fence_frags(lo0);
    fence_frags(hi1);
    fence_frags(lo1);
    tk8s::wgmma_fence();
    issue_rs<kStep, G>(acc0, hi0, lo0, b0, b0 + kPart, g);
    issue_rs<kStep, G>(acc1, hi1, lo1, b1, b1 + kPart, g);
    settle();
    tk8s::fence_regs(acc0);
    tk8s::fence_regs(acc1);
    fence_frags(hi0);
    fence_frags(lo0);
    fence_frags(hi1);
    fence_frags(lo1);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) attn_tf32_dkdv(const __grid_constant__ Params p) {
  using B = Bwd<D>;
  constexpr int R = B::kRows, S = B::kStages, C = B::kChunks, CW = B::kOwn;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t item_full[1], item_empty[1], full[S], empty[S];
  uint8_t* ring = tk8s::align_atom(smem_raw);
  uint8_t* kv = ring + S * kStage;  // K and V raw
  const int items = cdiv(p.seq, R) * p.batch * p.heads;
  init_barriers<1, S>(item_full, item_empty, full, empty);

  if (threadIdx.x < kProducer) {
    tk8s::regs_dec<kRegsProducerDkDv>();
    int t = 0;
    for (int i = blockIdx.x, n = 0; i < items; i += gridDim.x, ++n) {
      const KVItem it(p, i, R);
      const int b = it.bh / p.heads, h = it.bh % p.heads;
      tk8s::mbar_wait(&item_empty[0], (n & 1) ^ 1);
      put_items<D>(kv, kK, kV, p, b, h, it.k0);
      publish(&item_full[0]);
      // per q step, Q's and dO's chunks as rows (the last with the step's
      // lse2 and D rows), then both transposed
      for (int j = it.first; j < it.last; ++j, t += 2 * C) {
        const int q0 = j * kStep;
        const auto rows = [&](uint8_t* stage, int c) {
          if (c == C - 1 && threadIdx.x < kStep) {
            // lse * log2(e) and D; +inf and 0 past the sequence, so those
            // rows' P and dS are 0 without a mask
            float* tail = reinterpret_cast<float*>(stage + 4 * kPart);
            const int r = q0 + threadIdx.x;
            const long long row = (long long)it.bh * p.seq + r;
            tail[threadIdx.x] = r < p.seq ? p.lse[row] * kLog2e : INFINITY;
            tail[kStep + threadIdx.x] = r < p.seq ? p.rows[row] : 0.f;
          }
        };
        produce_step<C, S>(ring, full, empty, t, kQ, kDO, 2, q0, p, b, h, rows);
      }
    }
    return;
  }

  tk8s::regs_inc<kRegsConsumerDkDv>();
  const int wg = threadIdx.x / 128 - 1, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int t4 = lane & 3, c0 = B::chunk0(wg);
  const float sl2 = p.scale * kLog2e;
  int t = 0;
  for (int i = blockIdx.x, n = 0; i < items; i += gridDim.x, ++n) {
    const KVItem it(p, i, R);
    const int b = it.bh / p.heads, h = it.bh % p.heads, key0 = it.k0 + B::row0(wg);
    const int key[2] = {key0 + warp * 16 + (lane >> 2), key0 + warp * 16 + (lane >> 2) + 8};
    float dk[CW][32], dv[CW][32];
#pragma unroll
    for (int cc = 0; cc < CW; ++cc) {
#pragma unroll
      for (int e = 0; e < 32; ++e) dk[cc][e] = dv[cc][e] = 0.f;
    }
    tk8s::mbar_wait(&item_full[0], n & 1);
    for (int j = it.first; j < it.last; ++j) {
      const int q0 = j * kStep;
      // a q step wholly before this warpgroup's keys, or keys wholly past
      // the sequence: its stages are waited for and skipped
      const bool active = key0 < p.seq && !(p.causal && q0 + kStep <= key0);
      // S^T = K Q^T and dP^T = V dO^T: row = key, column c = q row q0 + c
      float st[16], dpt[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) st[e] = dpt[e] = 0.f;
      const int last = (t + C - 1) % S;  // the step's last row stage: its tail holds lse2 and D
#pragma unroll
      for (int c = 0; c < C; ++c, ++t) {
        const int s = t % S;
        tk8s::mbar_wait(&full[s], (t / S) & 1);
        if (active) {
          const uint32_t q_hi = tk8s::smem_addr(ring + s * kStage);
          item_products<D, B::kGroupDkDv>(st, dpt, kv, wg, c, q_hi, q_hi + 2 * kPart);
        }
        if (c < C - 1) tk8s::mbar_arrive(&empty[s]);  // the last is released once its rows are read
      }
      uint32_t phi[4][4], plo[4][4], dhi[4][4], dlo[4][4];
      if (active) {
        // P^T = exp2(S^T sl2 - lse2), 0 where the key comes after the q
        // row; dS^T = P^T (dP^T - D), 0 in a single-key row
        const float* lse2 = reinterpret_cast<const float*>(ring + last * kStage + 4 * kPart);
        const float* dd = lse2 + kStep;
        const bool diag = p.causal && q0 < key0 + 63;
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const int q = 8 * (e >> 2) + 2 * t4 + (e & 1);
          float prob = exp2f(fmaf(st[e], sl2, -lse2[q]));
          if (diag && q0 + q < key[(e >> 1) & 1]) prob = 0.f;
          dpt[e] = single_key(p, q0 + q) ? 0.f : prob * (dpt[e] - dd[q]);
          st[e] = prob;
        }
        acc_frags<4>(phi, plo, st);
        acc_frags<4>(dhi, dlo, dpt);
      }
      tk8s::mbar_arrive(&empty[last]);
#pragma unroll
      for (int c = 0; c < C; ++c, ++t) {  // dV += P^T dO, dK += dS^T Q, chunk c
        const int s = t % S;
        tk8s::mbar_wait(&full[s], (t / S) & 1);
        const uint32_t qt_hi = tk8s::smem_addr(ring + s * kStage);
#pragma unroll
        for (int cc = 0; cc < CW; ++cc) {
          if (active && c == c0 + cc) {
            tk8s::fence_regs(dv[cc]);
            tk8s::fence_regs(dk[cc]);
            fence_frags(phi);
            fence_frags(plo);
            fence_frags(dhi);
            fence_frags(dlo);
            tk8s::wgmma_fence();
            issue_rs<64, 4>(dv[cc], phi, plo, qt_hi + 2 * kPart, qt_hi + 3 * kPart);
            issue_rs<64, 4>(dk[cc], dhi, dlo, qt_hi, qt_hi + kPart);
            settle();
            tk8s::fence_regs(dv[cc]);
            tk8s::fence_regs(dk[cc]);
            fence_frags(phi);
            fence_frags(plo);
            fence_frags(dhi);
            fence_frags(dlo);
          }
        }
        tk8s::mbar_arrive(&empty[s]);
      }
    }
    tk8s::mbar_arrive(&item_empty[0]);  // K and V may take the next item

    // dK (times the scale) and dV
#pragma unroll
    for (int cc = 0; cc < CW; ++cc) {
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int r = (e >> 1) & 1, col = 64 * (c0 + cc) + 8 * (e >> 2) + 2 * t4;
        store2(p, kDK, b, h, key[r], col, dk[cc][e] * p.scale, dk[cc][e + 1] * p.scale);
        store2(p, kDV, b, h, key[r], col, dv[cc][e], dv[cc][e + 1]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) attn_tf32_dq(const __grid_constant__ Params p) {
  using B = Bwd<D>;
  constexpr int R = B::kRows, S = B::kStages, C = B::kChunks, CW = B::kOwn;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t item_full[1], item_empty[1], full[S], empty[S];
  uint8_t* ring = tk8s::align_atom(smem_raw);
  uint8_t* qdo = ring + S * kStage;  // Q and dO raw
  const int items = cdiv(p.seq, R) * p.batch * p.heads;
  init_barriers<1, S>(item_full, item_empty, full, empty);

  if (threadIdx.x < kProducer) {
    tk8s::regs_dec<kRegsProducer>();
    int t = 0;
    for (int i = blockIdx.x, n = 0; i < items; i += gridDim.x, ++n) {
      const Item it(p, i, kStep, R);
      const int b = it.bh / p.heads, h = it.bh % p.heads;
      tk8s::mbar_wait(&item_empty[0], (n & 1) ^ 1);
      put_items<D>(qdo, kQ, kDO, p, b, h, it.q0);
      publish(&item_full[0]);
      // per key step, K's and V's chunks as rows, then K's transposed
      for (int j = 0; j < it.steps; ++j, t += 2 * C) {
        produce_step<C, S>(ring, full, empty, t, kK, kV, 1, j * kStep, p, b, h, [](uint8_t*, int) {});
      }
    }
    return;
  }

  tk8s::regs_inc<kRegsConsumer>();
  const int wg = threadIdx.x / 128 - 1, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int t4 = lane & 3, c0 = B::chunk0(wg);
  const float sl2 = p.scale * kLog2e;
  int t = 0;
  for (int i = blockIdx.x, n = 0; i < items; i += gridDim.x, ++n) {
    const Item it(p, i, kStep, R);
    const int b = it.bh / p.heads, h = it.bh % p.heads, row0 = it.q0 + B::row0(wg);
    const int row[2] = {row0 + warp * 16 + (lane >> 2), row0 + warp * 16 + (lane >> 2) + 8};
    float lse2[2], dd[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long at = (long long)it.bh * p.seq + row[r];
      lse2[r] = row[r] < p.seq ? p.lse[at] * kLog2e : INFINITY;
      dd[r] = row[r] < p.seq ? p.rows[at] : 0.f;
    }
    float dq[CW][32];
#pragma unroll
    for (int cc = 0; cc < CW; ++cc) {
#pragma unroll
      for (int e = 0; e < 32; ++e) dq[cc][e] = 0.f;
    }
    tk8s::mbar_wait(&item_full[0], n & 1);
    for (int j = 0; j < it.steps; ++j) {
      const int k0 = j * kStep;
      // a key step wholly above the diagonal for this warpgroup's rows, or
      // rows wholly past the sequence: waited for and skipped
      const bool active = row0 < p.seq && !(p.causal && k0 > row0 + 63);
      // S = Q K^T and dP = dO V^T: row = q row, column c = key k0 + c
      float sc[16], dp[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) sc[e] = dp[e] = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c, ++t) {
        const int s = t % S;
        tk8s::mbar_wait(&full[s], (t / S) & 1);
        if (active) {
          const uint32_t k_hi = tk8s::smem_addr(ring + s * kStage);
          item_products<D, B::kGroupDq>(sc, dp, qdo, wg, c, k_hi, k_hi + 2 * kPart);
        }
        tk8s::mbar_arrive(&empty[s]);
      }
      uint32_t dhi[4][4], dlo[4][4];
      if (active) {
        // dS = P (dP - D) with P = exp2(S sl2 - lse2), 0 for a key after
        // the row or past the end, and in a single-key row
        const bool edge = k0 + kStep > p.seq || (p.causal && k0 + kStep - 1 > row0);
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const int r = (e >> 1) & 1, col = k0 + 8 * (e >> 2) + 2 * t4 + (e & 1);
          float prob = exp2f(fmaf(sc[e], sl2, -lse2[r]));
          if (edge && (col >= p.seq || (p.causal && col > row[r]))) prob = 0.f;
          dp[e] = single_key(p, row[r]) ? 0.f : prob * (dp[e] - dd[r]);
        }
        acc_frags<4>(dhi, dlo, dp);
      }
#pragma unroll
      for (int c = 0; c < C; ++c, ++t) {  // dQ += dS K, chunk c
        const int s = t % S;
        tk8s::mbar_wait(&full[s], (t / S) & 1);
        const uint32_t kt_hi = tk8s::smem_addr(ring + s * kStage);
#pragma unroll
        for (int cc = 0; cc < CW; ++cc) {
          if (active && c == c0 + cc) {
            tk8s::fence_regs(dq[cc]);
            fence_frags(dhi);
            fence_frags(dlo);
            tk8s::wgmma_fence();
            issue_rs<64, 4>(dq[cc], dhi, dlo, kt_hi, kt_hi + kPart);
            settle();
            tk8s::fence_regs(dq[cc]);
            fence_frags(dhi);
            fence_frags(dlo);
          }
        }
        tk8s::mbar_arrive(&empty[s]);
      }
    }
    tk8s::mbar_arrive(&item_empty[0]);  // Q and dO may take the next item

    // dQ (times the scale)
#pragma unroll
    for (int cc = 0; cc < CW; ++cc) {
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int r = (e >> 1) & 1, col = 64 * (c0 + cc) + 8 * (e >> 2) + 2 * t4;
        store2(p, kDQ, b, h, row[r], col, dq[cc][e] * p.scale, dq[cc][e + 1] * p.scale);
      }
    }
  }
}

// ----- launches

int sm_count() {
  static const int count = [] {
    int device = 0, n = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    return n;
  }();
  return count;
}

// persistent: one CTA per SM, or one per item when there are fewer
bool grid_of(const Params& p, int rows, int* grid) {
  const long long items = static_cast<long long>(cdiv(p.seq, rows)) * p.batch * p.heads;
  if (items <= 0 || items > 0x7fffffffLL) return false;
  *grid = static_cast<int>(items < sm_count() ? items : sm_count());
  return true;
}

template <int D>
cudaError_t forward(const Params& p, cudaStream_t stream) {
  using F = Fwd<D>;
  static const cudaError_t attr = tk8s::allow_smem(attn_tf32_fwd<D>, F::kSmem);
  if (attr != cudaSuccess) return attr;
  int grid = 0;
  if (!grid_of(p, F::kRows, &grid)) return cudaErrorInvalidValue;
  attn_tf32_fwd<D><<<grid, kThreads, F::kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t backward(const Params& p, cudaStream_t stream) {
  using B = Bwd<D>;
  static const cudaError_t attr_kv = tk8s::allow_smem(attn_tf32_dkdv<D>, B::kSmem);
  static const cudaError_t attr_q = tk8s::allow_smem(attn_tf32_dq<D>, B::kSmem);
  if (attr_kv != cudaSuccess) return attr_kv;
  if (attr_q != cudaSuccess) return attr_q;
  int grid = 0;
  if (!grid_of(p, B::kRows, &grid)) return cudaErrorInvalidValue;
  const long long rows = static_cast<long long>(p.batch) * p.heads * p.seq;
  if ((rows + 7) / 8 > 0x7fffffffLL) return cudaErrorInvalidValue;
  attn_tf32_rows<<<static_cast<int>((rows + 7) / 8), 256, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_tf32_dkdv<D><<<grid, kThreads, B::kSmem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_tf32_dq<D><<<grid, kThreads, B::kSmem, stream>>>(p);
  return cudaGetLastError();
}

// head_dim 1-256, on the narrowest width that holds it
int dispatch(bool fwd, const Params& p, cudaStream_t s) {
  if (p.dim <= 0 || p.dim > 256 || p.batch <= 0 || p.heads <= 0 || p.seq <= 0) return cudaErrorInvalidValue;
  if (p.dim <= 64) return fwd ? forward<64>(p, s) : backward<64>(p, s);
  if (p.dim <= 128) return fwd ? forward<128>(p, s) : backward<128>(p, s);
  return fwd ? forward<256>(p, s) : backward<256>(p, s);
}

Params make_params(const void* const* ptrs, const long long* strides, int n_tensors, int batch, int heads, int seq,
                   int causal, int head_dim, float scale) {
  Params p = {};
  for (int t = 0; t < n_tensors; ++t) {
    p.ptr[t] = static_cast<const float*>(ptrs[t]);
    bool vec = reinterpret_cast<uintptr_t>(ptrs[t]) % 16 == 0;
    for (int d = 0; d < 4; ++d) {
      p.st[t][d] = strides[4 * t + d];
      vec = vec && (d == 3 ? p.st[t][d] == 1 : p.st[t][d] % 4 == 0);
    }
    p.vec[t] = vec;
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
// values); lse: (batch, heads, seq) f32; scale: 1/sqrt(head_dim)
int tk8s_attn_tf32_fwd(int head_dim, const void* q, const void* k, const void* v, void* o, float* lse,
                       const long long* strides, int batch, int heads, int seq, int causal, float scale,
                       void* stream) {
  const void* ptrs[4] = {q, k, v, o};
  Params p = make_params(ptrs, strides, 4, batch, heads, seq, causal, head_dim, scale);
  p.lse = lse;
  return dispatch(true, p, static_cast<cudaStream_t>(stream));
}

// strides: (batch, seq, head, head_dim) of q, k, v, o, dout, dq, dk, dv
// (32 values); rows: f32 scratch of at least batch * heads * seq values
int tk8s_attn_tf32_bwd(int head_dim, const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, float* rows, void* dq, void* dk, void* dv,
                       const long long* strides, int batch, int heads, int seq, int causal, float scale,
                       void* stream) {
  const void* ptrs[kTensors] = {q, k, v, o, dout, dq, dk, dv};
  Params p = make_params(ptrs, strides, kTensors, batch, heads, seq, causal, head_dim, scale);
  p.lse = const_cast<float*>(lse);
  p.rows = rows;
  return dispatch(false, p, static_cast<cudaStream_t>(stream));
}

const char* tk8s_attn_tf32_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"

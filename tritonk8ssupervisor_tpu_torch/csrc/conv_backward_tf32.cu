// K4's TF32 instance on Hopper: the backward of a stride-1 1x1
// convolution, for sm_90a, with every product that can take them on the
// tensor cores as TF32 wgmma.
//
// Replaces, for the inputs csrc/conv_backward.cu does not take, the same
// TPU kernel: tritonk8ssupervisor_tpu/ops/conv_backward.py::_fused_kernel,
// reached through `_fused_backward_2d` from `conv1x1`'s custom VJP, which
// takes any compute dtype and any channel widths. Those inputs are an f32
// compute dtype (`ResNet(dtype=float32, fused_1x1_bwd=True)`), and bf16 or
// fp16 rows whose widths are not multiples of 8, which TMA cannot
// address. With X (M, C), dY (M, N) and W (N, C) in the compute dtype:
//
//   dX = dY W     (M, C): f32 sums, rounded to the compute dtype (no
//                 rounding in f32)
//   dW = dY^T X   (N, C) in f32, summed over all M rows
//
// The routes (ops/conv_backward_cuda.instance):
//
//   tf32x3   float32. One TF32 product keeps 11 of an operand's 24
//            significand bits and misses the f32 contract, the error bound
//            of an f32 FMA sum against a float64 evaluation
//            (tests/test_torch_kernels.py), by more than 10x. So every
//            operand x is split into hi = tf32(x) (cvt.rna) and lo = x - hi,
//            and every product a b is taken as lo(a) hi(b) + hi(a) lo(b) +
//            hi(a) hi(b), the small terms first, into one f32 accumulator;
//            lo lo, below 2^-22 of the product, is dropped. As in
//            csrc/flash_attention_tf32.cu (tests/test_torch_k4_tf32.py holds
//            this plan against float64).
//   tf32x1   bf16 and fp16: their values are exact in TF32 (7 and 10
//            explicit significand bits of TF32's 10, a narrower exponent),
//            so one TF32 product is the exact product, summed in f32.
//
// Short contractions. A 3xTF32 product errs by ~2^-21 of |a||b| whatever
// the contraction length K, where the f32 bound shrinks to K 2^-24, and the
// tensor cores' f32 sums truncate where an FMA rounds to nearest. Emulated
// on the CPU with a truncating sum after each k8 product, the plan reads
// 8.7 of the bound at K = 1, 0.82 at K = 8 and 0.39 at K = 16. So a product
// whose contraction is shorter than K_MIN = 16 is summed with exact f32
// FMAs (`short_dgrad` when N < 16, `short_wgrad` when M < 16), on either
// route: a function of the shape alone, not a fallback. That work is a
// few FMAs an output and bound by its bytes.
//
// What bounds it on an H100: 495 TFLOP/s of dense TF32 and three TF32
// products for each f32 one, so 165 TFLOP/s of f32-accurate products
// (`utils/roofline.PEAK_F32_PRODUCT_FLOPS`), against X, dY and W read once
// and dX and dW written once at 3.35 TB/s. At ResNet-50's f32 shapes the
// operations bound most calls and the bytes the three of stage 1 with a
// width of 64 (12.0082 ms a step in all).
//
// Structure, as csrc/flash_attention_tf32.cu's: 384 threads, warpgroup 0 the
// producer feeding an mbarrier ring, warpgroups 1 and 2 the consumers, each
// owning 64 of a work item's 128 output rows; persistent CTAs walk the
// items; the producer's registers go to the consumers (`setmaxnreg`: 136
// and 184 a thread, of the 168 the kernel is launched with). Each product
// is out (P, Q) = A (P, K) B (K, Q) over items of 128 rows of P by BQ
// columns of Q and a range of K, in stages of 32 k:
//
//   dgrad   P = M, Q = C, K = N: A = dY (rows, N contiguous), B = W;
//           items over (row tile, column tile), K whole; dX stored from
//           the accumulators in the compute dtype.
//   wgrad   P = the wider of N and C, Q = the narrower (the sum is the
//           same; so a width of 64 is never a 128-row tile half masked
//           unless both are 64), K = M: A and B are dY and X read across
//           their storage; items over (row tile, column tile, split of M),
//           one f32 partial a split (dW itself with one split), stored in
//           dW's layout.
//   reduce  sums the partials in split order into dW.
//
// TF32 wgmma takes both operands K-major only, and in wgrad K = M is the
// strided dimension of both dY and X (in dgrad, W's). Two kernels:
//
//   gemm_tma   f32 rows whose width is a multiple of 4 at 16-byte aligned
//              starts (every ResNet-50 shape). Thread 0 of the producer
//              keeps S - 1 stages of TMA loads in flight: raw f32 boxes,
//              128-byte swizzled, zeros past every edge (a stage never
//              crosses a split of M: splits are whole stages). The
//              producer warpgroup splits B from its raw boxes into hi and
//              lo K-major tiles; the consumers split their A fragments from
//              the raw tile in registers (conflict-free: the swizzle spreads
//              a fragment's rows over the banks) and issue m64nBQk8 with A
//              from registers, so A is never written back; B is split in
//              place of its raw boxes. A stage is 16 KB of raw A and BQ x
//              256 bytes of B: 32 or 48 KB, 6 or 4 stages.
//   gemm_tf32  any dtype, width and start. The producer warpgroup loads a
//              stage with plain loads (16 bytes a load, 8 for 16-bit
//              values, where the rows allow it; else one element a load;
//              zeros past each edge and the item's range of K), all in
//              flight before it waits for its slot, splits each value once
//              and writes hi and lo (at one term the value) into the
//              swizzled K-major layout the descriptor reads: as rows (dgrad's
//              dY) or transposed, a warp's lanes over 16 k of two 16-byte
//              pieces so that the loads fill whole 32-byte sectors and each
//              scalar store fills two lines' disjoint banks. Both operands
//              are read by the wgmmas from shared memory. Its load latency
//              is exposed once a stage (a register-staged stage cannot stay
//              in flight across the proxy fence that publishes the one
//              before), which is why the TMA kernel takes every f32 row it
//              can.
//
// Tiles that fit the widths: BQ is 64 where Q is at most 64 (so a width of
// 64 is a 128 x 64 tile), else 128; columns past Q read as zeros and are
// never written.
//
// The split of M for dW is a fixed function of the shape
// (ops/conv_backward_cuda.tf32_split): one wave of items, whole 32-row
// stages, no empty split; partials are summed in split order with no
// atomics, so two calls on the same inputs are bit-equal. --use_fast_math
// is in the build: the split's subtraction and the short products are
// explicit __fsub_rn and __fmaf_rn.
//
// Plain C interface, loaded with ctypes (ops/conv_backward_cuda.py). The
// entry point launches on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() after its launches.

#include "hopper.cuh"

namespace {

using tk8s::cdiv;
using tk8s::kAtom;
using tk8s::kLine;

constexpr int kThreads = 384;  // warpgroup 0 the producer, 1 and 2 consumers
constexpr int kProducer = 128;
constexpr int kConsumers = 256;
constexpr int kRows = 128;   // output rows (P) of a work item: 64 a consumer warpgroup
constexpr int kDepth = 32;   // k a ring stage: one 128-byte line of f32
constexpr int kMinK = 16;    // K_MIN: shorter contractions are summed with f32 FMAs
constexpr int kMaxSmem = 227 * 1024;
// registers a thread: the producer holds a stage's loads (up to 16 16-byte
// pieces), a consumer up to 64 accumulators and 32 fragment registers;
// 128 x 136 + 256 x 184 = 384 x 168
constexpr int kRegsProducer = 136, kRegsConsumer = 184;

// Per column tile BQ and terms a product (3 or 1): a ring stage is A's
// 128 lines and B's BQ, each as hi (and lo)
template <int BQ, int TERMS>
struct Cfg {
  static constexpr int kParts = TERMS == 3 ? 2 : 1;  // hi and lo, or the value
  static constexpr int kA = kRows * kLine;  // one part of A: 16 KB
  static constexpr int kB = BQ * kLine;
  static constexpr int kBOff = kParts * kA;  // B's hi part in a stage
  static constexpr int kStage = kParts * (kA + kB);
  static constexpr int kFit = (kMaxSmem - kAtom) / kStage;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kSmem = kStages * kStage + kAtom;
  static_assert(kStages >= 2, "a CTA's shared memory");
};

// ----- values

template <typename T>
__device__ __forceinline__ float to_f32(T x) { return static_cast<float>(x); }
template <>
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <>
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }

// two neighbouring outputs, one store (y 2-element aligned)
__device__ __forceinline__ void store_pair(float* y, float a, float b) {
  *reinterpret_cast<float2*>(y) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* y, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(y) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(__half* y, float a, float b) {
  *reinterpret_cast<__half2*>(y) = __floats2half2_rn(a, b);
}

__device__ __forceinline__ float2 unpack2(uint32_t v, __nv_bfloat16) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}
__device__ __forceinline__ float2 unpack2(uint32_t v, __half) {
  return __half22float2(*reinterpret_cast<__half2*>(&v));
}

// four consecutive elements at p, one aligned load
template <typename T>
__device__ __forceinline__ float4 load4(const T* p) {
  if constexpr (std::is_same_v<T, float>) {
    return __ldg(reinterpret_cast<const float4*>(p));
  } else {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = unpack2(u.x, T{}), b = unpack2(u.y, T{});
    return make_float4(a.x, a.y, b.x, b.y);
  }
}

__device__ const float4 kZero4 = {0.f, 0.f, 0.f, 0.f};

// Elements (row, col .. col + 3) of a row-major source of row stride ld,
// zeros where the row is out (!row_ok) and past col_end. With `vec` (ld a
// multiple of 4, the start aligned for one load) one load, issued whatever
// the case (zeros come from kZero4), so a thread's loads fly together; a
// piece is then wholly in or out, since col and col_end are multiples of 4.
template <typename T>
__device__ __forceinline__ float4 fetch4(const T* src, long long ld, int vec, long long row, long long col,
                                         bool row_ok, long long col_end) {
  if (vec) {
    const bool in = row_ok && col < col_end;
    return load4(in ? src + row * ld + col : reinterpret_cast<const T*>(&kZero4));
  }
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row_ok) {
    const T* p = src + row * ld + col;
    if (col < col_end) v.x = to_f32(p[0]);
    if (col + 1 < col_end) v.y = to_f32(p[1]);
    if (col + 2 < col_end) v.z = to_f32(p[2]);
    if (col + 3 < col_end) v.w = to_f32(p[3]);
  }
  return v;
}

// ----- the split and the layout

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo: hi rounded to TF32, lo the exact rest (the tensor cores
// read its top 19 bits)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

// Byte offset of element (line r, k < 32) in a K-major tile of 128-byte
// lines (32 f32): 16-byte unit u of line r at u ^ (r & 7), as the wgmma
// descriptor reads it
__device__ __forceinline__ uint32_t kmajor(int r, int k) {
  return r * kLine + (((k >> 2) ^ (r & 7)) << 4) + ((k & 3) << 2);
}

// ----- the producer's stage (all 128 producer threads)

// A thread's pieces of an L-line operand tile, 4 values each: piece u is
// i = threadIdx.x + 128 u of the tile's L * 32 / 4. As rows (the source's
// rows are the lines), line i / 8 at k 4 (i % 8): 8 lanes a 128-byte row.
// Transposed (the source's columns are the lines), k (i / 2) % 32 at lines
// 4 lg .. 4 lg + 3, lg = 2 (i / 64) + i % 2: a warp's lanes take 16 rows of
// 32 contiguous bytes.
template <bool TR>
__device__ __forceinline__ void piece_at(int i, int& line, int& k) {
  line = TR ? 4 * (((i >> 6) << 1) | (i & 1)) : i >> 3;
  k = TR ? (i >> 1) & 31 : 4 * (i & 7);
}

// issue the loads of the tile's lines [line0, line0 + L) (of `lines`) at
// k [k, k + 32) (of k_end)
template <typename T, int L, bool TR>
__device__ __forceinline__ void gather(float4 (&v)[L / 16], const T* src, long long ld, int vec, long long line0,
                                       long long lines, long long k, long long k_end) {
#pragma unroll
  for (int u = 0; u < L / 16; ++u) {
    int line, kk;
    piece_at<TR>(threadIdx.x + kProducer * u, line, kk);
    v[u] = TR ? fetch4(src, ld, vec, k + kk, line0 + line, k + kk < k_end, lines)
              : fetch4(src, ld, vec, line0 + line, k + kk, line0 + line < lines, k_end);
  }
}

// split the pieces and store them: hi at `hi`, lo at `lo` (TERMS == 3);
// at one term the value itself, exact in TF32
template <int L, bool TR, int TERMS>
__device__ __forceinline__ void scatter(const float4 (&v)[L / 16], uint8_t* hi, uint8_t* lo) {
#pragma unroll
  for (int u = 0; u < L / 16; ++u) {
    int line, kk;
    piece_at<TR>(threadIdx.x + kProducer * u, line, kk);
    const float e4[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
    uint32_t h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (TERMS == 3) {
        split(e4[e], h[e], l[e]);
      } else {
        h[e] = __float_as_uint(e4[e]);
      }
    }
    if (TR) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t at = kmajor(line + e, kk);
        *reinterpret_cast<uint32_t*>(hi + at) = h[e];
        if constexpr (TERMS == 3) *reinterpret_cast<uint32_t*>(lo + at) = l[e];
      }
    } else {
      const uint32_t at = kmajor(line, kk);
      *reinterpret_cast<uint4*>(hi + at) = make_uint4(h[0], h[1], h[2], h[3]);
      if constexpr (TERMS == 3) *reinterpret_cast<uint4*>(lo + at) = make_uint4(l[0], l[1], l[2], l[3]);
    }
  }
}

// ----- wgmma, TF32 inputs, both operands K-major in shared memory

__device__ __forceinline__ uint64_t desc(uint32_t tile, int kk) { return tk8s::desc_k_major(tile + 32 * kk); }

// D (64 x 64) += A (64 x 8) B (8 x 64)
__device__ __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " TK8S_WGMMA_REGS32 ", %32, %33, p, 1, 1;\n}\n"
               : TK8S_WGMMA_ACC32
               : "l"(a), "l"(b), "r"(1));
}

// D (64 x 128) += A (64 x 8) B (8 x 128)
__device__ __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " TK8S_WGMMA_REGS64 ", %64, %65, p, 1, 1;\n}\n"
               : TK8S_WGMMA_ACC64
               : "l"(a), "l"(b), "r"(1));
}

// D (64 x 64) += A (64 x 8, registers) B (8 x 64): register e of lane 4 g
// + t holds A's (row g + 8 (e & 1), column t + 4 (e >> 1)) of the warp's
// 16 rows (mma.sync's m16n8k8 TF32 A fragment)
__device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " TK8S_WGMMA_REGS32
               ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
               : TK8S_WGMMA_ACC32
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 128) += A (64 x 8, registers) B (8 x 128)
__device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " TK8S_WGMMA_REGS64
               ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
               : TK8S_WGMMA_ACC64
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

// a stage's products for warpgroup wg's 64 rows: lo hi, hi lo, then hi hi
template <int BQ, int TERMS>
__device__ __forceinline__ void products(float (&acc)[BQ / 2], uint32_t stage, int wg) {
  using C = Cfg<BQ, TERMS>;
  const uint32_t a_hi = stage + wg * 64 * kLine, b_hi = stage + C::kBOff;
  if constexpr (TERMS == 3) {
    const uint32_t a_lo = a_hi + C::kA, b_lo = b_hi + C::kB;
#pragma unroll
    for (int kk = 0; kk < kDepth / 8; ++kk) mma(acc, desc(a_lo, kk), desc(b_hi, kk));
#pragma unroll
    for (int kk = 0; kk < kDepth / 8; ++kk) mma(acc, desc(a_hi, kk), desc(b_lo, kk));
  }
#pragma unroll
  for (int kk = 0; kk < kDepth / 8; ++kk) mma(acc, desc(a_hi, kk), desc(b_hi, kk));
}

// ----- the products

// out (P, Q) = A (P, K) B (K, Q). A's lines are the rows of a row-major
// source (`DGRAD`: dY) or its columns (dY or X); B's lines are always its
// source's columns (W, or X or dY). Output element (p, q) lies at out[p ldo
// + q], or at out[q ldo + p] with out_t; split s's at out + s P Q.
struct Gemm {
  const void* a;
  const void* b;
  void* out;
  long long lda, ldb, ldo;
  long long p, k, per_split;  // rows of out, the contraction, k a split
  int q;
  int a_vec, b_vec, out_t, out_vec;
  int p_tiles, q_tiles, items;
};

// Work item i: column tile fastest (items that read the same A lines run
// together), then row tile, then split of K
struct Item {
  long long p0, q0, k0, k1;
  __device__ Item(const Gemm& g, int i, int bq) {
    const int rest = i / g.q_tiles;
    q0 = static_cast<long long>(i % g.q_tiles) * bq;
    p0 = static_cast<long long>(rest % g.p_tiles) * kRows;
    k0 = (rest / g.p_tiles) * g.per_split;
    k1 = k0 + g.per_split < g.k ? k0 + g.per_split : g.k;
  }
};

// the ring's barriers (`loaded` only in the TMA kernel)
__device__ __forceinline__ void init_barriers(uint64_t* full, uint64_t* empty, uint64_t* loaded, int stages) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      tk8s::mbar_init(&full[s], kProducer);
      tk8s::mbar_init(&empty[s], kConsumers);
      if (loaded != nullptr) tk8s::mbar_init(&loaded[s], 1);
    }
    tk8s::mbar_init_fence();
  }
  __syncthreads();
}

// A consumer warpgroup's 64 rows of an item's tile from the accumulators:
// element e of lane 4 g + t4 is row 16 warp + g + 8 ((e >> 1) & 1), column
// 8 (e >> 2) + 2 t4 + (e & 1); clipped to P and Q
template <typename Out, int BQ>
__device__ __forceinline__ void store_tile(const float (&acc)[BQ / 2], const Gemm& g, const Item& it, int wg) {
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  Out* dst = static_cast<Out*>(g.out) + (it.k0 / g.per_split) * g.p * g.q;
  const long long row0 = it.p0 + 64 * wg + 16 * warp + (lane >> 2);
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j) {
    const long long col = it.q0 + 8 * j + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = row0 + 8 * h;
      const float x0 = acc[4 * j + 2 * h], x1 = acc[4 * j + 2 * h + 1];
      if (row >= g.p || col >= g.q) continue;
      if (g.out_t) {
        dst[col * g.ldo + row] = from_f32<Out>(x0);
        if (col + 1 < g.q) dst[(col + 1) * g.ldo + row] = from_f32<Out>(x1);
      } else if (g.out_vec && col + 1 < g.q) {
        store_pair(dst + row * g.ldo + col, x0, x1);
      } else {
        dst[row * g.ldo + col] = from_f32<Out>(x0);
        if (col + 1 < g.q) dst[row * g.ldo + col + 1] = from_f32<Out>(x1);
      }
    }
  }
}

// The plain-load kernel: any width and start, any dtype. The producer
// loads a stage into registers and splits it into the ring; both operands
// are read by the wgmmas from shared memory.
template <typename T, typename Out, int BQ, int TERMS, bool DGRAD>
__global__ void __launch_bounds__(kThreads, 1) gemm_tf32(const __grid_constant__ Gemm g) {
  using C = Cfg<BQ, TERMS>;
  constexpr int S = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[S], empty[S];
  uint8_t* smem = tk8s::align_atom(smem_raw);
  init_barriers(full, empty, nullptr, S);

  if (threadIdx.x < kProducer) {
    tk8s::regs_dec<kRegsProducer>();
    const T* a = static_cast<const T*>(g.a);
    const T* b = static_cast<const T*>(g.b);
    int t = 0;  // stages filled so far: the ring position
    for (int i = blockIdx.x; i < g.items; i += gridDim.x) {
      const Item it(g, i, BQ);
      for (long long k = it.k0; k < it.k1; k += kDepth, ++t) {
        float4 va[kRows / 16], vb[BQ / 16];
        gather<T, kRows, !DGRAD>(va, a, g.lda, g.a_vec, it.p0, g.p, k, it.k1);
        gather<T, BQ, true>(vb, b, g.ldb, g.b_vec, it.q0, g.q, k, it.k1);
        const int s = t % S;
        tk8s::mbar_wait(&empty[s], ((t / S) & 1) ^ 1);
        uint8_t* stage = smem + s * C::kStage;
        scatter<kRows, !DGRAD, TERMS>(va, stage, stage + C::kA);
        scatter<BQ, true, TERMS>(vb, stage + C::kBOff, stage + C::kBOff + C::kB);
        tk8s::fence_proxy_async();  // the stores, for wgmma to read
        tk8s::mbar_arrive(&full[s]);
      }
    }
    return;
  }

  tk8s::regs_inc<kRegsConsumer>();
  const int wg = threadIdx.x / 128 - 1;
  int t = 0;
  for (int i = blockIdx.x; i < g.items; i += gridDim.x) {
    const Item it(g, i, BQ);
    float acc[BQ / 2];
#pragma unroll
    for (int e = 0; e < BQ / 2; ++e) acc[e] = 0.f;
    int j = 0;
    for (long long k = it.k0; k < it.k1; k += kDepth, ++t, ++j) {
      const int s = t % S;
      tk8s::mbar_wait(&full[s], (t / S) & 1);
      tk8s::fence_regs(acc);
      tk8s::wgmma_fence();
      products<BQ, TERMS>(acc, tk8s::smem_addr(smem + s * C::kStage), wg);
      tk8s::wgmma_commit();
      tk8s::wgmma_wait<1>();  // the previous stage's products are done with its slot
      tk8s::fence_regs(acc);
      if (j > 0) tk8s::mbar_arrive(&empty[(t - 1) % S]);
    }
    tk8s::wgmma_wait<0>();
    tk8s::fence_regs(acc);
    tk8s::mbar_arrive(&empty[(t - 1) % S]);
    store_tile<Out, BQ>(acc, g, it, wg);
  }
}

// ----- the TMA kernel: f32 rows whose width and start TMA can address

// A stage: B's raw f32 boxes as TMA lands them, 128-byte swizzled (every
// transposed operand, W, dY or X, comes in boxes of 32 k rows x 32 lines,
// 4 KB each), split in place into B's hi tile (K-major, the same size) and
// its lo tile after it, for the wgmmas; then A's raw f32, kept for the
// consumers to split their fragments from: dgrad's dY one box of 128 rows
// x 32 k (a K-major tile as the split ones), else boxes as B's.
template <int BQ, bool DGRAD>
struct Tma {
  static constexpr int kB = BQ * kLine;  // raw B, then B's hi; B's lo after it
  static constexpr int kRawA = kRows * kLine;  // 16 KB either way
  static constexpr int kStage = 2 * kB + kRawA;
  static constexpr int kFit = (kMaxSmem - kAtom) / kStage;
  static constexpr int kStages = kFit < 6 ? kFit : 6;
  static constexpr int kSmem = kStages * kStage + kAtom;
  static_assert(kStages >= 2, "a CTA's shared memory");
};

struct Maps {
  CUtensorMap a, b;  // boxes of 32 elements x 128 rows (dgrad's A) or 32 rows
};

// Byte offset of (line r, k c) in a raw transposed operand: box r / 32,
// row c of 128 bytes, 16-byte unit ((r % 32) / 4) ^ (c % 8)
__device__ __forceinline__ uint32_t transposed(int r, int c) { return (r >> 5) * 32 * kLine + kmajor(c, r & 31); }

// thread 0 of the producer: stage (it, k)'s raw operands into `stage`
template <int BQ, bool DGRAD>
__device__ __forceinline__ void issue(const Maps& m, const Item& it, long long k, uint8_t* stage, uint64_t* bar) {
  using M = Tma<BQ, DGRAD>;
  uint8_t* raw_a = stage + 2 * M::kB;
  uint8_t* raw_b = stage;
  tk8s::mbar_expect_tx(bar, M::kRawA + M::kB);
  const int kk = static_cast<int>(k), p0 = static_cast<int>(it.p0), q0 = static_cast<int>(it.q0);
  if (DGRAD) {
    tk8s::tma_load_2d(raw_a, &m.a, bar, kk, p0);
  } else {
#pragma unroll
    for (int j = 0; j < kRows / 32; ++j) tk8s::tma_load_2d(raw_a + j * 32 * kLine, &m.a, bar, p0 + 32 * j, kk);
  }
#pragma unroll
  for (int j = 0; j < BQ / 32; ++j) tk8s::tma_load_2d(raw_b + j * 32 * kLine, &m.b, bar, q0 + 32 * j, kk);
}

// The stages of a CTA's items in order, for the producer's thread 0 to
// issue ahead of the conversion
template <int BQ>
struct Walker {
  int i;
  Item it;
  long long k;
  __device__ Walker(const Gemm& g) : i(blockIdx.x), it(g, blockIdx.x, BQ), k(it.k0) {}
  __device__ bool done(const Gemm& g) const { return i >= g.items; }
  __device__ void next(const Gemm& g) {
    k += kDepth;
    if (k < it.k1) return;
    i += gridDim.x;
    it = Item(g, i, BQ);
    k = it.k0;
  }
};

// TMA lands each stage's raw rows (zeros past every edge; a stage never
// crosses a split of M, whose rows are whole stages); the producer
// warpgroup splits B into the stage's hi and lo tiles; the consumers split
// their A fragments from the raw tile and take A from registers. A ring of
// S stages: `loaded` when TMA's bytes land, `full` when B is split, `empty`
// when the consumers are done with the slot.
template <int BQ, bool DGRAD>
__global__ void __launch_bounds__(kThreads, 1) gemm_tma(const __grid_constant__ Gemm g,
                                                        const __grid_constant__ Maps maps) {
  using M = Tma<BQ, DGRAD>;
  constexpr int S = M::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[S], empty[S], loaded[S];
  uint8_t* smem = tk8s::align_atom(smem_raw);
  init_barriers(full, empty, loaded, S);

  if (threadIdx.x < kProducer) {
    tk8s::regs_dec<kRegsProducer>();
    const bool issuer = threadIdx.x == 0;
    Walker<BQ> ahead(g);  // thread 0's next stage to issue
    int t_issue = 0;
    if (issuer) {
      tk8s::prefetch_map(&maps.a);
      tk8s::prefetch_map(&maps.b);
      // the first S - 1 stages: every slot is free
      for (; t_issue < S - 1 && !ahead.done(g); ++t_issue, ahead.next(g)) {
        issue<BQ, DGRAD>(maps, ahead.it, ahead.k, smem + t_issue * M::kStage, &loaded[t_issue]);
      }
    }
    int t = 0;
    for (int i = blockIdx.x; i < g.items; i += gridDim.x) {
      const Item it(g, i, BQ);
      for (long long k = it.k0; k < it.k1; k += kDepth, ++t) {
        const int s = t % S;
        uint8_t* stage = smem + s * M::kStage;
        tk8s::mbar_wait(&loaded[s], (t / S) & 1);
        float4 vb[BQ / 16];
#pragma unroll
        for (int u = 0; u < BQ / 16; ++u) {
          int line, kk;
          piece_at<true>(threadIdx.x + kProducer * u, line, kk);
          vb[u] = *reinterpret_cast<const float4*>(stage + transposed(line, kk));
        }
        tk8s::named_sync(1, kProducer);  // raw B read whole: hi takes its place
        scatter<BQ, true, 3>(vb, stage, stage + M::kB);
        tk8s::fence_proxy_async();  // the stores, for wgmma to read
        tk8s::mbar_arrive(&full[s]);
        if (issuer && !ahead.done(g)) {
          const int si = t_issue % S;
          tk8s::mbar_wait(&empty[si], ((t_issue / S) & 1) ^ 1);
          issue<BQ, DGRAD>(maps, ahead.it, ahead.k, smem + si * M::kStage, &loaded[si]);
          ++t_issue;
          ahead.next(g);
        }
      }
    }
    return;
  }

  tk8s::regs_inc<kRegsConsumer>();
  const int wg = threadIdx.x / 128 - 1, lane = threadIdx.x % 32;
  // this thread's A fragment rows and columns (register e: row + 8 (e & 1),
  // column + 4 (e >> 1) of each k-step)
  const int row = 64 * wg + 16 * ((threadIdx.x / 32) % 4) + (lane >> 2), col = lane & 3;
  int t = 0;
  for (int i = blockIdx.x; i < g.items; i += gridDim.x) {
    const Item it(g, i, BQ);
    float acc[BQ / 2];
#pragma unroll
    for (int e = 0; e < BQ / 2; ++e) acc[e] = 0.f;
    for (long long k = it.k0; k < it.k1; k += kDepth, ++t) {
      const int s = t % S;
      uint8_t* stage = smem + s * M::kStage;
      tk8s::mbar_wait(&loaded[s], (t / S) & 1);
      tk8s::mbar_wait(&full[s], (t / S) & 1);
      const uint8_t* raw_a = stage + 2 * M::kB;
      uint32_t hi[kDepth / 8][4], lo[kDepth / 8][4];
#pragma unroll
      for (int kk = 0; kk < kDepth / 8; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = row + 8 * (e & 1), c = 8 * kk + col + 4 * (e >> 1);
          const float x = *reinterpret_cast<const float*>(raw_a + (DGRAD ? kmajor(r, c) : transposed(r, c)));
          split(x, hi[kk][e], lo[kk][e]);
        }
      }
      const uint32_t b_hi = tk8s::smem_addr(stage), b_lo = b_hi + M::kB;
      tk8s::fence_regs(acc);
      fence_frags(hi);
      fence_frags(lo);
      tk8s::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDepth / 8; ++kk) mma(acc, lo[kk], desc(b_hi, kk));
#pragma unroll
      for (int kk = 0; kk < kDepth / 8; ++kk) mma(acc, hi[kk], desc(b_lo, kk));
#pragma unroll
      for (int kk = 0; kk < kDepth / 8; ++kk) mma(acc, hi[kk], desc(b_hi, kk));
      tk8s::wgmma_commit();
      tk8s::wgmma_wait<0>();  // the fragments' registers are read until then
      tk8s::fence_regs(acc);
      fence_frags(hi);
      fence_frags(lo);
      tk8s::mbar_arrive(&empty[s]);
    }
    store_tile<float, BQ>(acc, g, it, wg);
  }
}

// ----- short contractions: exact f32 FMAs, one output a thread

// dX = dY W with N < K_MIN
template <typename T>
__global__ void __launch_bounds__(256) short_dgrad(const T* __restrict__ dy, const T* __restrict__ w, T* dx,
                                                   long long m, int c, int n) {
  const long long total = m * c;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < total; i += gridDim.x * 256LL) {
    const long long row = i / c;
    const int col = static_cast<int>(i % c);
    float acc = 0.f;
    for (int k = 0; k < n; ++k) {
      acc = __fmaf_rn(to_f32(dy[row * n + k]), to_f32(w[static_cast<long long>(k) * c + col]), acc);
    }
    dx[i] = from_f32<T>(acc);
  }
}

// dW = dY^T X with M < K_MIN
template <typename T>
__global__ void __launch_bounds__(256) short_wgrad(const T* __restrict__ dy, const T* __restrict__ x, float* dw,
                                                   long long m, int c, int n) {
  const long long total = static_cast<long long>(n) * c;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < total; i += gridDim.x * 256LL) {
    const long long row = i / c, col = i % c;
    float acc = 0.f;
    for (long long k = 0; k < m; ++k) acc = __fmaf_rn(to_f32(dy[k * n + row]), to_f32(x[k * c + col]), acc);
    dw[i] = acc;
  }
}

// dW = the partials summed in split order (unrolled so that eight loads
// are in flight; the adds keep the order)
__global__ void __launch_bounds__(256) reduce(float* dw, const float* partial, long long size, int splits) {
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= size) return;
  float sum = partial[i];
#pragma unroll 8
  for (int s = 1; s < splits; ++s) sum = __fadd_rn(sum, partial[s * size + i]);
  dw[i] = sum;
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

// a grid of at most a few waves of 256-thread blocks over `total` outputs
unsigned elementwise_grid(long long total) {
  const long long blocks = cdiv(total, 256), cap = 16LL * sm_count();
  return static_cast<unsigned>(blocks < cap ? blocks : cap);
}

template <typename T>
int vec_ok(const void* p, long long ld) {
  return ld % 4 == 0 && reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)) == 0;
}

// An f32 (rows, cols) row-major tensor as a tensor map of boxes of 32
// columns x `box_rows` rows, 128-byte swizzled; zeros past its edges
cudaError_t f32_map(CUtensorMap* map, const void* base, long long rows, long long cols, int box_rows) {
  const tk8s::EncodeTiled encode = tk8s::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 4};
  const cuuint32_t box[2] = {32, static_cast<cuuint32_t>(box_rows)}, step[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims, strides, box,
                            step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// fills the grid fields and returns the CTAs to launch: one per SM at most
cudaError_t plan(Gemm& g, long long splits, int bq, int& grid) {
  const long long p_tiles = cdiv(g.p, kRows), q_tiles = cdiv(g.q, bq), items = p_tiles * q_tiles * splits;
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  g.p_tiles = static_cast<int>(p_tiles);
  g.q_tiles = static_cast<int>(q_tiles);
  g.items = static_cast<int>(items);
  grid = static_cast<int>(items < sm_count() ? items : sm_count());
  return cudaSuccess;
}

template <typename T, typename Out, int BQ, int TERMS, bool DGRAD>
cudaError_t run(Gemm g, long long splits, cudaStream_t stream) {
  using C = Cfg<BQ, TERMS>;
  static const cudaError_t attr = tk8s::allow_smem(gemm_tf32<T, Out, BQ, TERMS, DGRAD>, C::kSmem);
  if (attr != cudaSuccess) return attr;
  int grid;
  const cudaError_t err = plan(g, splits, BQ, grid);
  if (err != cudaSuccess) return err;
  gemm_tf32<T, Out, BQ, TERMS, DGRAD><<<grid, kThreads, C::kSmem, stream>>>(g);
  return cudaGetLastError();
}

template <int BQ, bool DGRAD>
cudaError_t run_tma(Gemm g, long long splits, cudaStream_t stream) {
  using M = Tma<BQ, DGRAD>;
  static const cudaError_t attr = tk8s::allow_smem(gemm_tma<BQ, DGRAD>, M::kSmem);
  if (attr != cudaSuccess) return attr;
  // A's source is (K, P) for a transposed A, (P, K) for dgrad's dY; B's (K, Q)
  Maps maps;
  cudaError_t err = DGRAD ? f32_map(&maps.a, g.a, g.p, g.k, kRows) : f32_map(&maps.a, g.a, g.k, g.p, 32);
  if (err == cudaSuccess) err = f32_map(&maps.b, g.b, g.k, g.q, 32);
  int grid;
  if (err == cudaSuccess) err = plan(g, splits, BQ, grid);
  if (err != cudaSuccess) return err;
  gemm_tma<BQ, DGRAD><<<grid, kThreads, M::kSmem, stream>>>(g, maps);
  return cudaGetLastError();
}

// The column tile that holds Q (64 or 128; wider Q takes several), on the
// TMA kernel where T is f32 and both operands' rows are whole 16-byte
// units at 16-byte aligned starts, else on the plain-load kernel
template <typename T, typename Out, int TERMS, bool DGRAD>
cudaError_t launch(const Gemm& g, long long splits, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, float>) {
    if (g.a_vec && g.b_vec) {
      return g.q <= 64 ? run_tma<64, DGRAD>(g, splits, stream) : run_tma<128, DGRAD>(g, splits, stream);
    }
  }
  return g.q <= 64 ? run<T, Out, 64, TERMS, DGRAD>(g, splits, stream)
                   : run<T, Out, 128, TERMS, DGRAD>(g, splits, stream);
}

template <typename T, int TERMS>
cudaError_t backward(const void* x, const void* dy, const void* w, void* dx, float* dw, float* partial, long long m,
                     int c, int n, int splits, long long rows_per_split, cudaStream_t stream) {
  cudaError_t err;
  // dX (M, C) = dY (M, N) W (N, C): P = M, Q = C, K = N
  if (n < kMinK) {
    short_dgrad<T><<<elementwise_grid(m * c), 256, 0, stream>>>(static_cast<const T*>(dy), static_cast<const T*>(w),
                                                                static_cast<T*>(dx), m, c, n);
    err = cudaGetLastError();
  } else {
    Gemm d = {};
    d.a = dy;
    d.lda = n;
    d.a_vec = vec_ok<T>(dy, n);
    d.b = w;
    d.ldb = c;
    d.b_vec = vec_ok<T>(w, c);
    d.out = dx;
    d.ldo = c;
    d.out_vec = c % 2 == 0 && reinterpret_cast<uintptr_t>(dx) % (2 * sizeof(T)) == 0;
    d.p = m;
    d.q = c;
    d.k = n;
    d.per_split = n;
    err = launch<T, T, TERMS, true>(d, 1, stream);
  }
  if (err != cudaSuccess) return err;

  // dW (N, C) = dY^T (N, M) X (M, C): K = M
  if (m < kMinK) {
    short_wgrad<T><<<elementwise_grid(static_cast<long long>(n) * c), 256, 0, stream>>>(
        static_cast<const T*>(dy), static_cast<const T*>(x), dw, m, c, n);
    return cudaGetLastError();
  }
  const bool swap = c > n;  // A's lines the wider of the two
  Gemm g = {};
  g.a = swap ? x : dy;
  g.lda = swap ? c : n;
  g.a_vec = vec_ok<T>(g.a, g.lda);
  g.b = swap ? dy : x;
  g.ldb = swap ? n : c;
  g.b_vec = vec_ok<T>(g.b, g.ldb);
  g.out = splits == 1 ? dw : partial;
  g.ldo = c;
  g.out_t = swap;
  g.out_vec = !swap && c % 2 == 0;
  g.p = swap ? c : n;
  g.q = swap ? n : c;
  g.k = m;
  g.per_split = rows_per_split;
  err = launch<T, float, TERMS, false>(g, splits, stream);
  if (err != cudaSuccess || splits == 1) return err;
  const long long size = static_cast<long long>(n) * c;
  reduce<<<static_cast<unsigned>(cdiv(size, 256)), 256, 0, stream>>>(dw, partial, size, splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype 0 = float32 (3xTF32), 1 = bf16, 2 = fp16 (one TF32 product). x (m,
// c), dy (m, n), w (n, c) and dx (m, c) dense row-major at any start; dw
// (n, c) f32. `partial` is (splits, n, c) f32 scratch, unused (may be null)
// when splits == 1; rows_per_split is a multiple of 32, splits of it cover
// m with none empty. m >= 1: the caller launches nothing for an empty batch.
int tk8s_conv1x1_tf32_bwd(int dtype, const void* x, const void* dy, const void* w, void* dx, float* dw,
                          float* partial, long long m, int c, int n, int splits, long long rows_per_split,
                          void* stream) {
  if (m <= 0 || c <= 0 || n <= 0 || m > 0x7fffffffLL || splits < 1 || splits > 65535 || rows_per_split <= 0 ||
      rows_per_split % kDepth || rows_per_split * splits < m || (splits - 1) * rows_per_split >= m ||
      (splits > 1 && partial == nullptr)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return backward<float, 3>(x, dy, w, dx, dw, partial, m, c, n, splits, rows_per_split, s);
  if (dtype == 1) return backward<__nv_bfloat16, 1>(x, dy, w, dx, dw, partial, m, c, n, splits, rows_per_split, s);
  if (dtype == 2) return backward<__half, 1>(x, dy, w, dx, dw, partial, m, c, n, splits, rows_per_split, s);
  return cudaErrorInvalidValue;
}

const char* tk8s_conv1x1_tf32_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"

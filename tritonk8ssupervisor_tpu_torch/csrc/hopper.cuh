// Hopper building blocks shared by the port's CUDA kernels (sm_90a).
//
// The kernels that include this header (csrc/conv_backward.cu, K4;
// csrc/flash_attention.cu, K2's forward and backward) share one shape: a ring of
// shared-memory stages that the Tensor Memory Accelerator (TMA) fills, one
// producer thread that keeps the loads in flight, and consumer warpgroups
// that multiply the tiles that have arrived with `wgmma`, accumulating in
// f32 registers. This header holds the pieces, as plain PTX:
//
//   host     tensor maps (`make_map`): cuTensorMapEncodeTiled, reached
//            through the runtime's driver entry point, so the libraries
//            link no -lcuda; every map is 16-bit, 128-byte swizzled, with
//            boxes 64 elements (128 bytes) wide;
//   mbarrier init, arrive, arrive with expected bytes, wait on a phase
//            parity;
//   TMA      2-d and 4-d tile loads that complete on an mbarrier, tile
//            stores from shared memory, the proxy fence between them, and
//            plain bulk copies (no tensor map: f32 rows) on the same
//            mbarriers;
//   regs     `setmaxnreg`, which moves registers from the producer's
//            warpgroup to the consumers';
//   wgmma    shared-memory descriptors for K-major and MN-major tiles, the
//            fence / commit / wait of a warpgroup, and m64nNk16 products
//            in bf16 and fp16, both operands in shared memory (`wgmma_ss`)
//            or A in registers (`wgmma_rs`).
//
// The tile layout everything here assumes: a box of 64 16-bit elements by
// R rows lands as R lines of 128 bytes, swizzled by TMA in 1024-byte atoms
// of 8 lines (16-byte unit u of line r at u ^ (r & 7)); a tile wider than
// 64 elements is several boxes ("chunks") one after the other. Every chunk
// starts on a 1024-byte boundary. For a K-major operand (rows of M or N,
// K contiguous) a 16-deep step moves 32 bytes along the lines; for an
// MN-major operand (lines of 64 M or N elements, one line per k) it moves
// 16 lines, 2048 bytes.
//
// Tensor maps go to kernels inside a `const __grid_constant__` struct.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; no driver call is linked
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace tk8s {

template <typename T>
inline constexpr bool kHalf = std::is_same_v<T, __half>;

__host__ __device__ constexpr long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// ----------------------------------------------------------------- host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded; null
// where the driver has none
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                     : nullptr;
  }();
  return fn;
}

// A tensor of T (bf16 or fp16) of rank R at `base` as a tensor map: dims
// innermost first, strides of dims 1..R-1 in elements, boxes of `box`
// elements (box[0] = 64). Elements outside the tensor read as zeros and
// are not written. TMA takes a 16-byte aligned base and strides that are
// multiples of 16 bytes; the callers check both.
template <typename T, int R>
cudaError_t make_map(CUtensorMap* map, const void* base, const long long (&dims)[R],
                     const long long (&strides)[R - 1], const int (&box)[R]) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  cuuint64_t d[R], s[R - 1];
  cuuint32_t b[R], e[R];
  for (int i = 0; i < R; ++i) {
    d[i] = static_cast<cuuint64_t>(dims[i]);
    b[i] = static_cast<cuuint32_t>(box[i]);
    e[i] = 1;
  }
  for (int i = 0; i < R - 1; ++i) s[i] = static_cast<cuuint64_t>(strides[i]) * sizeof(T);
  const CUresult r = encode(map, kHalf<T> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, R,
                            const_cast<void*>(base), d, s, b, e, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A kernel whose shared memory passes the 48 KB default needs the opt-in,
// once per instance.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// --------------------------------------------------------------- device

constexpr int kLine = 128;       // bytes in a swizzled line: 64 16-bit elements
constexpr int kAtom = 8 * kLine;  // a swizzle atom, and the alignment of every chunk

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte boundary at or after p (dynamic shared memory is
// declared with 1024 bytes of slack for this).
__device__ __forceinline__ uint8_t* align_atom(uint8_t* p) {
  return p + ((kAtom - (smem_addr(p) & (kAtom - 1))) & (kAtom - 1));
}

// Byte offset of 16-bit element (row, col) in a tile of `rows` swizzled
// lines per 64-column chunk, as TMA lays it out and reads it back.
__device__ __forceinline__ uint32_t swizzled(int row, int col, int rows) {
  const int byte = (col & 63) * 2;
  return (col >> 6) * rows * kLine + row * kLine + ((((byte >> 4) ^ row) & 7) << 4) + (byte & 15);
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (kHalf<T>) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// bar.sync on a named barrier (1..15; 0 is __syncthreads) of `threads`
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ----- mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

// after the inits, before any thread uses the barriers (then __syncthreads)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of TMA transactions
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed. A fresh barrier
// is in phase 0: waiting on parity 0 blocks until its first completion,
// waiting on parity 1 returns at once (how a producer finds every ring
// slot free on its first round).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// ----- TMA

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::
          "r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_addr(src)), "r"(c0), "r"(c1)
               : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0, int c1, int c2,
                                             int c3) {
  asm volatile("cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
               : "memory");
}

// close the group of stores issued so far
__device__ __forceinline__ void tma_store_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }

// wait until every committed store has read its shared memory
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// `bytes` (a multiple of 16) from 16-byte aligned global memory at `src`
// into shared memory, completing on `bar` as a tile load does
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// makes this thread's generic shared-memory writes visible to TMA and wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ----- registers

// Lower or raise the registers of every thread of the calling warpgroup
// to N (a multiple of 8 in [24, 256]); all of its threads execute it. The
// kernel splits producer and consumer warpgroups in one if / else that
// never rejoins, or ptxas ignores the request.
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ----- wgmma

// Descriptor of a K-major tile at shared address `addr`: M or N rows of
// 128-byte lines, 8-line atoms 1024 bytes apart (SBO; LBO unused).
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (static_cast<uint64_t>(kAtom >> 4) << 32) |
         (1ull << 62);
}

// Descriptor of an MN-major tile: lines of 64 M or N elements, one per k,
// 8-line atoms 1024 bytes apart along K (SBO), 64-element chunks
// `chunk_bytes` apart along M or N (LBO).
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr, uint32_t chunk_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(chunk_bytes >> 4) << 16) |
         (static_cast<uint64_t>(kAtom >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across an
// asynchronous wgmma.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The products. Accumulator register i of thread (warp w of the
// warpgroup, lane 4 g + t) holds row 16 w + g + 8 ((i >> 1) & 1), column
// 8 (i >> 2) + 2 t + (i & 1): per 8 columns, the m16n8 accumulator layout
// of mma.sync. The A registers of `wgmma_rs` are mma.sync's m16n8k16 A
// fragment of the warp's 16 rows. TA / TB = 1 reads A / B MN-major
// (16-bit types only). scale_d = 0 ignores the accumulator's old value.

#define TK8S_WGMMA_REGS32 "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31}"
#define TK8S_WGMMA_ACC32 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

#define TK8S_WGMMA_REGS64 "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, " \
  "%40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63}"
#define TK8S_WGMMA_ACC64 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

#define TK8S_WGMMA_REGS128 "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, " \
  "%40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, " \
  "%72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, " \
  "%88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, " \
  "%104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, " \
  "%120, %121, %122, %123, %124, %125, %126, %127}"
#define TK8S_WGMMA_ACC128 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
  "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
  "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
  "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
  "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
  "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
  "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
  "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
  "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])

// D (64 x 64) += A (64 x 16, shared) B (16 x 64, shared)
template <typename T, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (kHalf<T>) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " TK8S_WGMMA_REGS32
                 ", %32, %33, p, 1, 1, %35, %36;\n}\n"
                 : TK8S_WGMMA_ACC32
                 : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  } else {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TK8S_WGMMA_REGS32
                 ", %32, %33, p, 1, 1, %35, %36;\n}\n"
                 : TK8S_WGMMA_ACC32
                 : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  }
}

// D (64 x 64) += A (64 x 16, registers) B (16 x 64, shared)
template <typename T, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  if constexpr (kHalf<T>) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " TK8S_WGMMA_REGS32
                 ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
                 : TK8S_WGMMA_ACC32
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
  } else {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TK8S_WGMMA_REGS32
                 ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
                 : TK8S_WGMMA_ACC32
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
  }
}

// D (64 x 128) += A (64 x 16, shared) B (16 x 128, shared)
template <typename T, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (kHalf<T>) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 " TK8S_WGMMA_REGS64
                 ", %64, %65, p, 1, 1, %67, %68;\n}\n"
                 : TK8S_WGMMA_ACC64
                 : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  } else {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " TK8S_WGMMA_REGS64
                 ", %64, %65, p, 1, 1, %67, %68;\n}\n"
                 : TK8S_WGMMA_ACC64
                 : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  }
}

// D (64 x 128) += A (64 x 16, registers) B (16 x 128, shared)
template <typename T, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  if constexpr (kHalf<T>) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 " TK8S_WGMMA_REGS64
                 ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
                 : TK8S_WGMMA_ACC64
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
  } else {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " TK8S_WGMMA_REGS64
                 ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
                 : TK8S_WGMMA_ACC64
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
  }
}

// D (64 x 256) += A (64 x 16, shared) B (16 x 256, shared)
template <typename T, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[128], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (kHalf<T>) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n256k16.f32.f16.f16 " TK8S_WGMMA_REGS128
                 ", %128, %129, p, 1, 1, %131, %132;\n}\n"
                 : TK8S_WGMMA_ACC128
                 : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  } else {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " TK8S_WGMMA_REGS128
                 ", %128, %129, p, 1, 1, %131, %132;\n}\n"
                 : TK8S_WGMMA_ACC128
                 : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  }
}

}  // namespace tk8s

// K4 on Hopper: the backward of a stride-1 1x1 convolution, for sm_90a.
//
// Replaces tritonk8ssupervisor_tpu/ops/conv_backward.py::_fused_kernel
// (called from `_fused_backward_2d` through `conv1x1`'s custom VJP). With
// the activations viewed as rows, X (M, C) and dY (M, N), and the port's
// weight W (N, C) (its (N, C, 1, 1) parameter, cast to the compute dtype):
//
//   dX = dY W           (M, C) in the compute dtype, f32 accumulation
//   dW = dY^T X         (N, C) in f32, summed over all M rows
//
// What bounds it on an H100: 4 M C N operations against reading X, dY and
// W once and writing dX and the f32 dW. At ResNet-50's stage-0 and stage-1
// shapes (C, N <= 512) the bytes bound it; at stage 3 (C or N = 2048) the
// tensor cores do.
//
// Design: the simple version. Three __global__ functions, every product a
// bf16/fp16 `mma.sync.m16n8k16` with f32 accumulation, no library call:
//
//   dgrad   one CTA of four warps per (64-column C tile, 128-row M tile):
//           loops over N in 32-deep steps staged in shared memory. The C
//           tile is the fastest grid axis, so the CTAs that read the same
//           dY rows run together and share them through L2.
//   wgrad   one CTA per (64-column C tile, 64-row N tile, split of M):
//           loops over its split's rows in 64-deep steps and writes an f32
//           partial. Grid axes in the same order: CTAs of one split read
//           the same X and dY rows.
//   reduce  sums the partials over the splits in split order into dW.
//
// dY is read twice (once by dgrad, once by wgrad): the TPU kernel's reason
// to exist is reading it once, which is a later lever, as are cp.async,
// wgmma and TMA. dW is deterministic: no atomics, a fixed split of M, and
// a fixed order of summation; with one split wgrad writes dW itself.
// Operands that a product reads along the other axis (W for dgrad, dY and X
// for wgrad) are staged as they lie in device memory and their fragments
// gathered with 16-bit shared loads; rows of shared tiles are padded by 8
// elements so that a fragment load hits distinct banks.
//
// Takes any M (a ragged last tile is masked), C and N multiples of 8 (rows
// of whole 16-byte vectors), dense row-major X, dY, W and dX with 16-byte
// aligned starts; the wrapper (ops/conv_backward.py) checks all of it.
//
// Plain C interface, loaded with ctypes (ops/conv_backward_cuda.py). The
// entry point launches on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // four warps
// dgrad tile: 128 rows of M x 64 columns of C, 32 deep in N
constexpr int kDgM = 128, kDgC = 64, kDgK = 32;
// wgrad tile: 64 rows of N x 64 columns of C, 64 deep in M
constexpr int kWgN = 64, kWgC = 64, kWgK = 64;
constexpr int kPad = 8;

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float c[4], const uint32_t a[4], const uint32_t b[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

template <>
struct Mma<__half> {
  static __device__ __forceinline__ void run(float c[4], const uint32_t a[4], const uint32_t b[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

__host__ __device__ constexpr long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// ROWS x COLS elements of a dense row-major matrix (row stride `ld`), from
// (r0, c0), into shared memory with row stride COLS + kPad; elements at or
// past (rows, cols) read as zeros. `cols` is a multiple of 8, so a 16-byte
// chunk is all in or all out.
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long ld, long long r0, long long rows,
                                          int c0, int cols) {
  constexpr int kChunks = COLS / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < rows && c0 + c < cols) v = *reinterpret_cast<const uint4*>(src + (r0 + r) * ld + c0 + c);
    *reinterpret_cast<uint4*>(dst + r * (COLS + kPad) + c) = v;
  }
}

__device__ __forceinline__ uint32_t pair(const uint16_t* s, int i, int j) {
  return static_cast<uint32_t>(s[i]) | (static_cast<uint32_t>(s[j]) << 16);
}

// A operand of m16n8k16 (16 rows x 16 deep) at (row0, k0) from a shared
// tile laid out [row][k] with row stride `ld`.
template <typename T>
__device__ __forceinline__ void frag_a(uint32_t a[4], const T* s, int ld, int row0, int k0) {
  const int lane = threadIdx.x & 31;
  const T* p = s + (row0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * ld);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * ld + 8);
}

// The same A operand from a tile laid out [k][row]: each register pairs
// two k-neighbours, which lie a row of the tile apart.
template <typename T>
__device__ __forceinline__ void frag_a_t(uint32_t a[4], const T* s, int ld, int row0, int k0) {
  const int lane = threadIdx.x & 31;
  const uint16_t* u = reinterpret_cast<const uint16_t*>(s);
  const int r = row0 + (lane >> 2), k = k0 + 2 * (lane & 3);
  a[0] = pair(u, k * ld + r, (k + 1) * ld + r);
  a[1] = pair(u, k * ld + r + 8, (k + 1) * ld + r + 8);
  a[2] = pair(u, (k + 8) * ld + r, (k + 9) * ld + r);
  a[3] = pair(u, (k + 8) * ld + r + 8, (k + 9) * ld + r + 8);
}

// B operand of m16n8k16 (16 deep x 8 wide) at (k0, n0) from a tile laid
// out [k][n], as B lies in memory.
template <typename T>
__device__ __forceinline__ void frag_b_t(uint32_t b[2], const T* s, int ld, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  const uint16_t* u = reinterpret_cast<const uint16_t*>(s);
  const int n = n0 + (lane >> 2), k = k0 + 2 * (lane & 3);
  b[0] = pair(u, k * ld + n, (k + 1) * ld + n);
  b[1] = pair(u, (k + 8) * ld + n, (k + 9) * ld + n);
}

struct Params {
  const void* x;   // (m, c)
  const void* dy;  // (m, n)
  const void* w;   // (n, c)
  void* dx;        // (m, c), compute dtype
  float* dw;       // (n, c)
  float* partial;  // (splits, n, c): dw itself when splits == 1
  long long m, rows_per_split;
  int c, n, splits;
};

// dX = dY W. Warp w owns rows [32 w, 32 w + 32) of the tile and all 64
// columns: 2 x 8 accumulators of 16 x 8.
template <typename T>
__global__ void __launch_bounds__(kThreads) dgrad(Params p) {
  constexpr int LDY = kDgK + kPad, LDW = kDgC + kPad;
  // raw storage: a __shared__ array may not have a class type with constructors
  __shared__ __align__(16) uint16_t smem[kDgM * LDY + kDgK * LDW];
  T* sDy = reinterpret_cast<T*>(smem);
  T* sW = sDy + kDgM * LDY;
  const int c0 = blockIdx.x * kDgC;
  const long long m0 = (long long)blockIdx.y * kDgM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const T* dy = static_cast<const T*>(p.dy);
  const T* w = static_cast<const T*>(p.w);

  float acc[2][kDgC / 8][4] = {};
  for (int k0 = 0; k0 < p.n; k0 += kDgK) {
    __syncthreads();  // the previous step's readers are done
    load_tile<T, kDgM, kDgK>(sDy, dy, p.n, m0, p.m, k0, p.n);
    load_tile<T, kDgK, kDgC>(sW, w, p.c, k0, p.n, c0, p.c);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDgK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) frag_a(a[mt], sDy, LDY, warp * 32 + mt * 16, kk);
#pragma unroll
      for (int nb = 0; nb < kDgC / 8; ++nb) {
        uint32_t b[2];
        frag_b_t(b, sW, LDW, nb * 8, kk);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) Mma<T>::run(acc[mt][nb], a[mt], b);
      }
    }
  }

  T* dx = static_cast<T*>(p.dx);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = m0 + warp * 32 + mt * 16 + g + 8 * h;
      if (row >= p.m) continue;
#pragma unroll
      for (int nb = 0; nb < kDgC / 8; ++nb) {
        const int col = c0 + nb * 8 + 2 * t;
        if (col >= p.c) continue;
        *reinterpret_cast<uint32_t*>(dx + row * p.c + col) =
            Mma<T>::pack(acc[mt][nb][2 * h], acc[mt][nb][2 * h + 1]);
      }
    }
  }
}

// dW partial of one split = dY[rows]^T X[rows]. Warps as 2 x 2, each 32 N
// rows x 32 C columns: 2 x 4 accumulators.
template <typename T>
__global__ void __launch_bounds__(kThreads) wgrad(Params p) {
  constexpr int LD = kWgC + kPad;
  static_assert(kWgN == kWgC, "one padded row stride serves both tiles");
  __shared__ __align__(16) uint16_t smem[2 * kWgK * LD];
  T* sDy = reinterpret_cast<T*>(smem);  // [m][n]
  T* sX = sDy + kWgK * LD;              // [m][c]
  const int c0 = blockIdx.x * kWgC, n0 = blockIdx.y * kWgN, split = blockIdx.z;
  const long long r_begin = (long long)split * p.rows_per_split;
  const long long r_end = r_begin + p.rows_per_split < p.m ? r_begin + p.rows_per_split : p.m;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wn = warp >> 1, wc = warp & 1;
  const T* dy = static_cast<const T*>(p.dy);
  const T* x = static_cast<const T*>(p.x);

  float acc[2][4][4] = {};
  for (long long r0 = r_begin; r0 < r_end; r0 += kWgK) {
    __syncthreads();
    load_tile<T, kWgK, kWgN>(sDy, dy, p.n, r0, r_end, n0, p.n);
    load_tile<T, kWgK, kWgC>(sX, x, p.c, r0, r_end, c0, p.c);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kWgK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) frag_a_t(a[mt], sDy, LD, wn * 32 + mt * 16, kk);
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        uint32_t b[2];
        frag_b_t(b, sX, LD, wc * 32 + nb * 8, kk);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) Mma<T>::run(acc[mt][nb], a[mt], b);
      }
    }
  }

  float* out = p.partial + (long long)split * p.n * p.c;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = n0 + wn * 32 + mt * 16 + g + 8 * h;
      if (row >= p.n) continue;
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        const int col = c0 + wc * 32 + nb * 8 + 2 * t;
        if (col >= p.c) continue;
        *reinterpret_cast<float2*>(out + (long long)row * p.c + col) =
            make_float2(acc[mt][nb][2 * h], acc[mt][nb][2 * h + 1]);
      }
    }
  }
}

// dW = the partials summed in split order
__global__ void __launch_bounds__(256) reduce(Params p) {
  const long long size = (long long)p.n * p.c;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  float sum = 0.f;
  for (int s = 0; s < p.splits; ++s) sum += p.partial[s * size + i];
  p.dw[i] = sum;
}

template <typename T>
cudaError_t backward(const Params& p, cudaStream_t stream) {
  dgrad<T><<<dim3(cdiv(p.c, kDgC), cdiv(p.m, kDgM)), kThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wgrad<T><<<dim3(cdiv(p.c, kWgC), cdiv(p.n, kWgN), p.splits), kThreads, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  reduce<<<cdiv((long long)p.n * p.c, 256), 256, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype 0 = bf16, 1 = fp16. `partial` is (splits, n, c) f32 scratch, unused
// (may be null) when splits == 1; rows_per_split * splits covers m.
int tk8s_conv1x1_bwd(int dtype, const void* x, const void* dy, const void* w, void* dx, float* dw,
                     float* partial, long long m, int c, int n, int splits, long long rows_per_split,
                     void* stream) {
  if (m <= 0 || c <= 0 || n <= 0 || c % 8 || n % 8 || splits < 1 || splits > 65535 ||
      rows_per_split <= 0 || rows_per_split * splits < m || cdiv(m, kDgM) > 65535 ||
      (splits > 1 && partial == nullptr)) {
    return cudaErrorInvalidValue;
  }
  Params prm = {x, dy, w, dx, dw, splits == 1 ? dw : partial, m, rows_per_split, c, n, splits};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return backward<__nv_bfloat16>(prm, s);
  if (dtype == 1) return backward<__half>(prm, s);
  return cudaErrorInvalidValue;
}

const char* tk8s_conv1x1_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"

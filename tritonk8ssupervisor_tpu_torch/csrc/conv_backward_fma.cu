// K4's FMA instance on Hopper: the backward of a stride-1 1x1
// convolution, for sm_90a, with every product and sum an f32 fused
// multiply-add on the CUDA cores.
//
// Replaces, for the inputs csrc/conv_backward.cu does not take, the same
// TPU kernel: tritonk8ssupervisor_tpu/ops/conv_backward.py::_fused_kernel,
// reached through `_fused_backward_2d` from `conv1x1`'s custom VJP, which
// takes any compute dtype and any channel widths. Those inputs are an f32
// compute dtype (`ResNet(dtype=float32, fused_1x1_bwd=True)`), and bf16 or
// fp16 rows whose widths are not multiples of 8, which TMA cannot
// address. With X (M, C), dY (M, N) and W (N, C) in the compute dtype:
//
//   dX = dY W     (M, C): f32 sums of compute-dtype values, rounded to the
//                 compute dtype (no rounding in f32)
//   dW = dY^T X   (N, C) in f32, summed over all M rows
//
// No TF32 in any form: the f32 contract is the error bound of an f32 FMA
// sum against a float64 evaluation (tests/test_torch_kernels.py).
//
// What bounds it on an H100: 4 M C N operations at the CUDA cores' 67
// TFLOP/s in f32, against X, dY and W read once and dX and dW written
// once at 3.35 TB/s; at ResNet-50's shapes the operations bound it (20
// operations a byte are the crossover). So it is one register-tiled
// product, the classic SIMT GEMM: a CTA of 256 threads computes a 128 x
// 128 output tile, each thread 8 x 8 of it from float4 reads of two
// k-major shared tiles of depth 8, double-buffered, the next depth's
// values loaded into registers while the current one is multiplied.
//
//   gemm<.., dX>   P = M rows, Q = C, K = N: A = dY (k contiguous), B = W
//   gemm<.., dW>   P = N, Q = C, K = M: A = dY^T (p contiguous), B = X;
//                  a fixed split of M, one f32 partial a split
//   reduce         sums the partials in split order into dW
//
// Rows are read element by element through their strides, so any M
// (0 launches nothing), any C and N, and any alignment of the rows'
// starts. dW is deterministic: no atomics, a split of M that is a fixed
// function of the shape (ops/conv_backward_cuda.fma_split), a fixed order
// of summation.
//
// Plain C interface, loaded with ctypes (ops/conv_backward_cuda.py). The
// entry point launches on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;       // output rows and columns of a CTA
constexpr int kDepth = 8;        // k a shared-memory stage
constexpr int kLd = kTile + 4;   // a stage's row: float4-aligned, 4k + p over the banks
constexpr int kLoads = kTile * kDepth / kThreads;  // elements a thread stages

template <typename T>
__device__ __forceinline__ float to_f32(T x) { return static_cast<float>(x); }
template <>
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <>
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x) { return static_cast<T>(x); }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }

// out (P, Q) row-major = sum over k in [k0, k1) of A(p, k) B(k, q)
template <typename T>
struct Gemm {
  const T* a;
  long long a_p, a_k;  // A's strides
  const T* b;
  long long b_k;       // B's k stride; its q stride is 1
  void* out;           // (splits, P, Q): T for dX, f32 for dW and its partials
  long long p, q, k;
  long long per_split;  // k of one split (blockIdx.z)
};

// a stage's k-major tile of A: (kDepth, kTile) from rows p0.., depth k..
template <typename T>
__device__ __forceinline__ void fetch_a(float (&r)[kLoads], const Gemm<T>& g, long long p0, long long k, long long k1) {
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int e = threadIdx.x + kThreads * i;
    // k contiguous (dX's dY rows): 8 threads a row; else the rows contiguous
    const int pp = g.a_k == 1 ? e / kDepth : e % kTile, kk = g.a_k == 1 ? e % kDepth : e / kTile;
    const long long row = p0 + pp, depth = k + kk;
    r[i] = row < g.p && depth < k1 ? to_f32(g.a[row * g.a_p + depth * g.a_k]) : 0.f;
  }
}

template <typename T>
__device__ __forceinline__ void fetch_b(float (&r)[kLoads], const Gemm<T>& g, long long q0, long long k, long long k1) {
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int e = threadIdx.x + kThreads * i;
    const long long col = q0 + e % kTile, depth = k + e / kTile;
    r[i] = col < g.q && depth < k1 ? to_f32(g.b[depth * g.b_k + col]) : 0.f;
  }
}

template <typename T>
__device__ __forceinline__ void stage(float* as, float* bs, const float (&ra)[kLoads], const float (&rb)[kLoads],
                                     const Gemm<T>& g) {
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int e = threadIdx.x + kThreads * i;
    const int pp = g.a_k == 1 ? e / kDepth : e % kTile, kk = g.a_k == 1 ? e % kDepth : e / kTile;
    as[kk * kLd + pp] = ra[i];
    bs[(e / kTile) * kLd + e % kTile] = rb[i];
  }
}

// grid (P tiles, Q tiles, splits); thread (ty, tx) owns rows ty*4 + {0..3}
// and 64 + ty*4 + {0..3}, columns likewise by tx
template <typename T, typename Out>
__global__ void __launch_bounds__(kThreads) gemm(Gemm<T> g) {
  __shared__ __align__(16) float as[2][kDepth * kLd];
  __shared__ __align__(16) float bs[2][kDepth * kLd];
  const long long p0 = static_cast<long long>(blockIdx.x) * kTile, q0 = static_cast<long long>(blockIdx.y) * kTile;
  const long long k0 = blockIdx.z * g.per_split;
  const long long k1 = k0 + g.per_split < g.k ? k0 + g.per_split : g.k;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[8][8] = {};
  float ra[kLoads], rb[kLoads];
  fetch_a(ra, g, p0, k0, k1);
  fetch_b(rb, g, q0, k0, k1);
  stage(as[0], bs[0], ra, rb, g);
  __syncthreads();
  int buf = 0;
  for (long long k = k0; k < k1; k += kDepth) {
    const bool more = k + kDepth < k1;
    if (more) {
      fetch_a(ra, g, p0, k + kDepth, k1);
      fetch_b(rb, g, q0, k + kDepth, k1);
    }
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      const float* a = as[buf] + kk * kLd;
      const float* b = bs[buf] + kk * kLd;
      const float4 a0 = *reinterpret_cast<const float4*>(a + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(a + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(b + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(b + 64 + tx * 4);
      const float x[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float y[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(x[i], y[j], acc[i][j]);
      }
    }
    if (more) stage(as[buf ^ 1], bs[buf ^ 1], ra, rb, g);
    __syncthreads();  // the other buffer is staged, this one read
    buf ^= 1;
  }
  Out* out = static_cast<Out*>(g.out) + blockIdx.z * g.p * g.q;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long row = p0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= g.p) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long col = q0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (col < g.q) out[row * g.q + col] = from_f32<Out>(acc[i][j]);
    }
  }
}

// dW = the partials summed in split order
__global__ void __launch_bounds__(kThreads) reduce(float* dw, const float* partial, long long size, int splits) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= size) return;
  float sum = partial[i];
  for (int s = 1; s < splits; ++s) sum += partial[s * size + i];
  dw[i] = sum;
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

template <typename T>
cudaError_t backward(const void* x, const void* dy, const void* w, void* dx, float* dw, float* partial, long long m,
                     int c, int n, int splits, long long rows_per_split, cudaStream_t stream) {
  const T* x_ = static_cast<const T*>(x);
  const T* dy_ = static_cast<const T*>(dy);
  const T* w_ = static_cast<const T*>(w);
  // dX (M, C) = dY (M, N) W (N, C)
  const Gemm<T> dgrad = {dy_, n, 1, w_, c, dx, m, c, n, n};
  gemm<T, T><<<dim3(static_cast<unsigned>(cdiv(m, kTile)), static_cast<unsigned>(cdiv(c, kTile)), 1), kThreads, 0,
               stream>>>(dgrad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // dW (N, C) = dY^T (N, M) X (M, C), over splits of M
  const Gemm<T> wgrad = {dy_, 1, n, x_, c, splits == 1 ? static_cast<void*>(dw) : partial, n, c, m, rows_per_split};
  gemm<T, float><<<dim3(static_cast<unsigned>(cdiv(n, kTile)), static_cast<unsigned>(cdiv(c, kTile)), splits),
                   kThreads, 0, stream>>>(wgrad);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long size = static_cast<long long>(n) * c;
  reduce<<<static_cast<unsigned>(cdiv(size, kThreads)), kThreads, 0, stream>>>(dw, partial, size, splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype 0 = float32, 1 = bf16, 2 = fp16. x (m, c), dy (m, n), w (n, c) and
// dx (m, c) dense row-major at any start; dw (n, c) f32. `partial` is
// (splits, n, c) f32 scratch, unused (may be null) when splits == 1;
// rows_per_split * splits covers m. m >= 1: the caller launches nothing
// for an empty batch.
int tk8s_conv1x1_fma_bwd(int dtype, const void* x, const void* dy, const void* w, void* dx, float* dw,
                         float* partial, long long m, int c, int n, int splits, long long rows_per_split,
                         void* stream) {
  if (m <= 0 || c <= 0 || n <= 0 || splits < 1 || splits > 65535 || rows_per_split <= 0 ||
      rows_per_split * splits < m || cdiv(m, kTile) > 0x7fffffffLL || cdiv(c, kTile) > 65535 ||
      cdiv(n, kTile) > 0x7fffffffLL || (splits > 1 && partial == nullptr)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return backward<float>(x, dy, w, dx, dw, partial, m, c, n, splits, rows_per_split, s);
  if (dtype == 1) return backward<__nv_bfloat16>(x, dy, w, dx, dw, partial, m, c, n, splits, rows_per_split, s);
  if (dtype == 2) return backward<__half>(x, dy, w, dx, dw, partial, m, c, n, splits, rows_per_split, s);
  return cudaErrorInvalidValue;
}

const char* tk8s_conv1x1_fma_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"

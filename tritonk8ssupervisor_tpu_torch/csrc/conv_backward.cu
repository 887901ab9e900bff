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
// tensor cores do. So the design keeps the memory system and the tensor
// cores busy at once (csrc/hopper.cuh): every tile arrives by TMA into a
// ring of shared-memory stages, one producer thread keeps the ring full,
// and two consumer warpgroups multiply the tiles that have arrived with
// `wgmma`, 64 rows each, in f32 registers. Operands read across their
// storage order (W for dgrad, dY and X for wgrad) are read MN-major by the
// descriptor: no transposed copy, no gather.
//
//   dgrad   dX = dY W. A work item is 128 rows of M by BC columns of C
//           (BC = 64, 128 or 256: all of C up to 256, so dY is read once
//           there); persistent CTAs (one per SM, two for BC = 64) walk
//           the items, N in 64-deep steps through a 3- or 4-stage ring:
//           A = dY (128 x 64, K-major), B = W (64 x BC, MN-major). The
//           epilogue rounds to the compute dtype into a staging tile and
//           stores it with TMA (which clips the ragged edges) while the
//           producer already loads the next item.
//   wgrad   one CTA per (128 N x 128 C tile, split of M): walks its split
//           in 64-row steps through a 4-stage ring, A = dY^T and B = X
//           both MN-major, and writes an f32 partial (dW itself with one
//           split).
//   reduce  sums the partials in split order into dW.
//
// dY is read twice (once by dgrad, once by wgrad): the TPU kernel's one
// read of dY for both products is a later lever. dW is deterministic: no
// atomics, a fixed split of M in whole 64-row steps, a fixed order of
// summation.
//
// Takes any M (TMA zero-fills past the last row and clips the store), C
// and N multiples of 8 (rows of whole 16-byte vectors), dense row-major X,
// dY, W and dX with 16-byte aligned starts: what TMA needs. The wrapper
// (ops/conv_backward.py) checks all of it.
//
// Plain C interface, loaded with ctypes (ops/conv_backward_cuda.py). The
// entry point launches on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() after its launches.

#include "hopper.cuh"

namespace {

using namespace tk8s;

constexpr int kThreads = 384;   // warpgroup 0 the producer, 1 and 2 consumers
constexpr int kConsumers = 256;
constexpr int kStages = 4;       // wgrad's ring
constexpr int kStep = 64;       // depth of a k-step: one 128-byte line
constexpr int kBox = 64 * kLine;  // a 64-line chunk, 8 KB
// dgrad: 128 rows of M a work item; wgrad: 128 x 128 of (N, C) a CTA
constexpr int kDgRows = 128;
constexpr int kWgTile = 128;

struct Maps {
  CUtensorMap dy_rows;  // dY (M, N), boxes 64 x 128 rows: dgrad's A
  CUtensorMap w;        // W (N, C), boxes 64 x 64: dgrad's B
  CUtensorMap dx;       // dX (M, C), boxes 64 x 128 rows: dgrad's store
  CUtensorMap dy;       // dY (M, N), boxes 64 x 64 rows: wgrad's A
  CUtensorMap x;        // X (M, C), boxes 64 x 64 rows: wgrad's B
};

struct Shape {
  float* dw;       // (n, c)
  float* partial;  // (splits, n, c): dw itself when splits == 1
  long long m, rows_per_split;
  int c, n, splits;
};

template <int BC>
struct Dgrad {
  // 3 stages at BC = 64 so that two CTAs fit an SM, and at BC = 256 so
  // that the staging tile fits beside the ring
  static constexpr int kStages = BC == 128 ? 4 : 3;
  static constexpr int kA = kDgRows * kLine;          // 16 KB of dY
  static constexpr int kStage = kA + BC / 64 * kBox;  // and W, BC / 64 chunks
  static constexpr int kOut = kDgRows * BC * 2;       // the dX tile being stored
  static constexpr int kSmem = kStages * kStage + kOut + kAtom;
  static constexpr int kCtasPerSm = BC == 64 ? 2 : 1;
};

struct Wgrad {
  static constexpr int kA = 2 * kBox;  // dY, 128 N columns
  static constexpr int kB = 2 * kBox;  // X, 128 C columns
  static constexpr int kStage = kA + kB;
  static constexpr int kSmem = kStages * kStage + kAtom;
};

// consumer thread's warpgroup (0, 1), warp in it, and lane coordinates
struct Lane {
  int wg, warp, g, t;
  __device__ Lane()
      : wg(threadIdx.x / 128 - 1), warp((threadIdx.x / 32) % 4), g((threadIdx.x % 32) / 4), t(threadIdx.x % 4) {}
};

// A ring of S shared-memory stages, counted by step t (slot t % S):
// full[slot] completes when TMA has landed the slot's bytes, empty[slot]
// when every consumer thread is done with them.
template <int S>
struct Ring {
  uint64_t full[S], empty[S];

  __device__ void init() {
    if (threadIdx.x == 0) {
      for (int s = 0; s < S; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], kConsumers);
      }
      mbar_init_fence();
    }
    __syncthreads();
  }
  // the producer: waits for step t's slot to be free and announces its
  // bytes; the loads complete on the barrier returned
  __device__ uint64_t* acquire(int t, uint32_t bytes) {
    mbar_wait(&empty[t % S], ((t / S) & 1) ^ 1);
    mbar_expect_tx(&full[t % S], bytes);
    return &full[t % S];
  }
  __device__ void wait_full(int t) { mbar_wait(&full[t % S], (t / S) & 1); }
  __device__ void release(int t) { mbar_arrive(&empty[t % S]); }
};

// dX = dY W, 128 rows x BC columns a work item. Persistent: each CTA walks
// the items blockIdx.x, + gridDim.x, ... (C tiles fastest, so CTAs that
// read the same dY rows run together); the producer runs ahead across
// items, so one item's loads overlap the last one's epilogue.
template <typename T, int BC>
__global__ void __launch_bounds__(kThreads, Dgrad<BC>::kCtasPerSm) dgrad(const __grid_constant__ Maps maps, Shape p) {
  using G = Dgrad<BC>;
  constexpr int S = G::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ Ring<S> ring;
  uint8_t* smem = align_atom(smem_raw);
  uint8_t* out = smem + S * G::kStage;
  const int c_tiles = static_cast<int>(cdiv(p.c, BC));
  const int items = c_tiles * static_cast<int>(cdiv(p.m, kDgRows));
  const int steps = static_cast<int>(cdiv(p.n, kStep));
  ring.init();

  if (threadIdx.x < 128) {
    if (threadIdx.x == 0) {
      prefetch_map(&maps.dy_rows);
      prefetch_map(&maps.w);
      int t = 0;  // k-steps loaded so far: the ring position
      for (int i = blockIdx.x; i < items; i += gridDim.x) {
        const int c0 = (i % c_tiles) * BC, m0 = (i / c_tiles) * kDgRows;
        for (int k = 0; k < steps; ++k, ++t) {
          uint8_t* stage = smem + (t % S) * G::kStage;
          uint64_t* bar = ring.acquire(t, G::kStage);
          tma_load_2d(stage, &maps.dy_rows, bar, k * kStep, m0);
#pragma unroll
          for (int j = 0; j < BC / 64; ++j) {
            tma_load_2d(stage + G::kA + j * kBox, &maps.w, bar, c0 + 64 * j, k * kStep);
          }
        }
      }
    }
    return;
  }

  const Lane ln;
  const bool leader = threadIdx.x == 128;  // issues the stores
  int t = 0;
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    const int c0 = (i % c_tiles) * BC, m0 = (i / c_tiles) * kDgRows;
    float acc[BC / 2];
#pragma unroll
    for (int e = 0; e < BC / 2; ++e) acc[e] = 0.f;
    for (int k = 0; k < steps; ++k, ++t) {
      ring.wait_full(t);
      const uint32_t a = smem_addr(smem + (t % S) * G::kStage) + ln.wg * 64 * kLine;
      const uint32_t b = smem_addr(smem + (t % S) * G::kStage + G::kA);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kStep / 16; ++kk) {
        wgmma_ss<T, 0, 1>(acc, desc_k_major(a + 32 * kk), desc_mn_major(b + 2048 * kk, kBox), 1);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's products are done with its slot
      fence_regs(acc);
      if (k > 0) ring.release(t - 1);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    ring.release(t - 1);

    // the last item's store has read the staging tile: write this one's
    if (leader) tma_store_wait_read();
    named_sync(1, kConsumers);
#pragma unroll
    for (int j = 0; j < BC / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = ln.wg * 64 + ln.warp * 16 + ln.g + 8 * h;
        *reinterpret_cast<uint32_t*>(out + swizzled(row, j * 8 + 2 * ln.t, kDgRows)) =
            pack2<T>(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
    fence_proxy_async();
    named_sync(1, kConsumers);
    if (leader) {
#pragma unroll
      for (int j = 0; j < BC / 64; ++j) {
        if (c0 + 64 * j < p.c) tma_store_2d(&maps.dx, out + j * kDgRows * kLine, c0 + 64 * j, m0);
      }
      tma_store_commit();
    }
  }
  if (leader) tma_store_wait_read();
}

// dW partial of one split = dY[rows]^T X[rows], 128 N x 128 C
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) wgrad(const __grid_constant__ Maps maps, Shape p) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ Ring<kStages> ring;
  uint8_t* smem = align_atom(smem_raw);
  const int c0 = blockIdx.x * kWgTile, n0 = blockIdx.y * kWgTile, split = blockIdx.z;
  const long long r_begin = split * p.rows_per_split;
  const long long r_end = r_begin + p.rows_per_split < p.m ? r_begin + p.rows_per_split : p.m;
  const int steps = static_cast<int>(cdiv(r_end - r_begin, kStep));
  ring.init();

  if (threadIdx.x < 128) {
    if (threadIdx.x == 0) {
      prefetch_map(&maps.dy);
      prefetch_map(&maps.x);
      for (int k = 0; k < steps; ++k) {
        uint8_t* stage = smem + (k % kStages) * Wgrad::kStage;
        uint64_t* bar = ring.acquire(k, Wgrad::kStage);
        const int r = static_cast<int>(r_begin) + k * kStep;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          tma_load_2d(stage + j * kBox, &maps.dy, bar, n0 + 64 * j, r);
          tma_load_2d(stage + Wgrad::kA + j * kBox, &maps.x, bar, c0 + 64 * j, r);
        }
      }
    }
    return;
  }

  const Lane ln;
  float acc[kWgTile / 2];
#pragma unroll
  for (int i = 0; i < kWgTile / 2; ++i) acc[i] = 0.f;
  for (int k = 0; k < steps; ++k) {
    ring.wait_full(k);
    const uint32_t a = smem_addr(smem + (k % kStages) * Wgrad::kStage) + ln.wg * kBox;
    const uint32_t b = smem_addr(smem + (k % kStages) * Wgrad::kStage + Wgrad::kA);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kStep / 16; ++kk) {
      wgmma_ss<T, 1, 1>(acc, desc_mn_major(a + 2048 * kk, kBox), desc_mn_major(b + 2048 * kk, kBox), 1);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(acc);
    if (k > 0) ring.release(k - 1);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  float* out = p.partial + static_cast<long long>(split) * p.n * p.c;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = n0 + ln.wg * 64 + ln.warp * 16 + ln.g + 8 * h;
    if (row >= p.n) continue;
#pragma unroll
    for (int j = 0; j < kWgTile / 8; ++j) {
      const int col = c0 + j * 8 + 2 * ln.t;
      if (col < p.c) {
        *reinterpret_cast<float2*>(out + static_cast<long long>(row) * p.c + col) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// dW = the partials summed in split order, four columns a thread
__global__ void __launch_bounds__(256) reduce(Shape p) {
  const long long quads = static_cast<long long>(p.n) * p.c / 4;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= quads) return;
  const float4* src = reinterpret_cast<const float4*>(p.partial);
  float4 sum = src[i];
  // unrolled so that eight loads are in flight; the adds keep split order
#pragma unroll 8
  for (int s = 1; s < p.splits; ++s) {
    const float4 v = src[s * quads + i];
    sum.x += v.x;
    sum.y += v.y;
    sum.z += v.z;
    sum.w += v.w;
  }
  reinterpret_cast<float4*>(p.dw)[i] = sum;
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

template <typename T, int BC>
cudaError_t launch_dgrad(const Maps& maps, const Shape& p, cudaStream_t stream) {
  using G = Dgrad<BC>;
  static const cudaError_t attr = allow_smem(dgrad<T, BC>, G::kSmem);
  if (attr != cudaSuccess) return attr;
  const long long items = cdiv(p.c, BC) * cdiv(p.m, kDgRows), ctas = sm_count() * G::kCtasPerSm;
  dgrad<T, BC><<<static_cast<int>(items < ctas ? items : ctas), kThreads, G::kSmem, stream>>>(maps, p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t backward(const void* x, const void* dy, const void* w, void* dx, const Shape& p, cudaStream_t stream) {
  Maps maps;
  cudaError_t err;
  const long long m = p.m, c = p.c, n = p.n;
  if ((err = make_map<T>(&maps.dy_rows, dy, {n, m}, {n}, {64, kDgRows})) != cudaSuccess ||
      (err = make_map<T>(&maps.w, w, {c, n}, {c}, {64, kStep})) != cudaSuccess ||
      (err = make_map<T>(&maps.dx, dx, {c, m}, {c}, {64, kDgRows})) != cudaSuccess ||
      (err = make_map<T>(&maps.dy, dy, {n, m}, {n}, {64, kStep})) != cudaSuccess ||
      (err = make_map<T>(&maps.x, x, {c, m}, {c}, {64, kStep})) != cudaSuccess) {
    return err;
  }
  err = p.c <= 64 ? launch_dgrad<T, 64>(maps, p, stream)
        : p.c <= 128 ? launch_dgrad<T, 128>(maps, p, stream)
                     : launch_dgrad<T, 256>(maps, p, stream);
  if (err != cudaSuccess) return err;
  static const cudaError_t attr = allow_smem(wgrad<T>, Wgrad::kSmem);
  if (attr != cudaSuccess) return attr;
  wgrad<T><<<dim3(cdiv(p.c, kWgTile), cdiv(p.n, kWgTile), p.splits), kThreads, Wgrad::kSmem, stream>>>(maps, p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  reduce<<<cdiv(n * c / 4, 256), 256, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype 0 = bf16, 1 = fp16. `partial` is (splits, n, c) f32 scratch, unused
// (may be null) when splits == 1; rows_per_split is a multiple of 64 and
// rows_per_split * splits covers m.
int tk8s_conv1x1_bwd(int dtype, const void* x, const void* dy, const void* w, void* dx, float* dw,
                     float* partial, long long m, int c, int n, int splits, long long rows_per_split,
                     void* stream) {
  if (m <= 0 || c <= 0 || n <= 0 || c % 8 || n % 8 || splits < 1 || splits > 65535 ||
      rows_per_split <= 0 || rows_per_split % kStep || rows_per_split * splits < m ||
      cdiv(m, kDgRows) > 65535 || m > 0x7fffffffLL || (splits > 1 && partial == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const Shape p = {dw, splits == 1 ? dw : partial, m, rows_per_split, c, n, splits};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return backward<__nv_bfloat16>(x, dy, w, dx, p, s);
  if (dtype == 1) return backward<__half>(x, dy, w, dx, p, s);
  return cudaErrorInvalidValue;
}

const char* tk8s_conv1x1_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"

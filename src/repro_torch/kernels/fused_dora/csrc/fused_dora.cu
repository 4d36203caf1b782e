// Hand-written Hopper (sm_90a) fused DoRA-decomposed LoRA linear.
//
// Replaces the Pallas TPU kernel fused_dora_matmul (body _kernel) of
// src/repro/kernels/fused_dora/fused_dora.py.  It computes what the Pallas
// body computes, with its cast points:
//
//   acc = x . W0                                  (f32 accumulation)
//   h   = (x * T(a_mag)) . a_eff                  (x * a_mag rounded to T, f32 accumulation)
//   y   = T(acc + scale * (T(h * b_eff_mag) . b_dir))   (the magnitude in f32,
//                                                         the expand summed in f32)
//
// where T is x's type, a_eff = T(A_dir + dA_dir) and b_eff_mag = f32(B_mag +
// dB_mag) are formed by the dispatcher as the Pallas wrapper forms them, and
// W0, a_eff and b_dir arrive in T.  The Pallas grid carries the two f32
// accumulators in VMEM scratch across its sequential K axis; here a loop over
// K inside each block carries them in registers.  h is accumulated in the same
// K loop as the base product, from the same staged x, so x is read once.  Each
// block recomputes the whole (rows x r) h for its rows: h depends only on the
// rows and K, so that is right, and it is at most N / (block columns) times
// redundant work on a rank-r side product (r = 8 against 32 or 64 columns).
//
// What bounds it.  At decode (M = 8, K = N = 4096, r = 8, bf16): bytes,
// 33.6 MB of W0 over 3.35 TB/s, about 10 us.  At prefill (M = 512):
// operations, 17.2 GFLOP, about 17 us at the bf16 tensor-core rate.  This
// first version runs on the CUDA cores in f32 (exact products of bf16
// operands, as the MXU's), so its ceiling at prefill is the 67 TFLOP/s f32
// rate; a tensor-core mainloop is later work.
//
// Design (a simple first version that is right):
//   * M <= 16: the skinny path.  A block owns 8 rows and 32 columns, one per
//     lane; its 8 warps split each 256-row chunk of K, 32 consecutive rows a
//     warp, with the lane's 32 W0 loads issued before they are used.  The
//     chunk of x is staged in shared memory twice, as f32 and as the rounded
//     x * a_mag, and read back as broadcasts.  Each warp also accumulates its
//     rows' share of h (8 x r entries over 32 lanes).  At the end the warps'
//     partial sums of the base tile and of h are added in shared memory in a
//     fixed order, and the epilogue runs.  N / 32 = 128 blocks at N = 4096.
//   * larger M: a shared-memory tiled product, 64 x 64 output tiles, 256
//     threads of 4 x 4 outputs, K in tiles of 32, with the x, x * a_mag, W0
//     and a_eff tiles staged as f32 and each thread also keeping r / 4 of
//     the tile's (64 x r) h entries in registers.
// Ragged M, N and K are masked in the kernel; nothing is padded.  The rank is
// a runtime argument up to a compiled bucket RT in {8, 16, 32, 64}.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRank = 64;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// round an f32 value to T and back (an .astype(x.dtype) point)
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// ---------------------------------------------------------------------------
// skinny path (decode)
// ---------------------------------------------------------------------------

constexpr int kSkinnyRows = 8;
constexpr int kSkinnyBN = 32;
constexpr int kChunk = 256;
constexpr int kWarpRows = kChunk / kWarps;

template <typename T, int RT>
__global__ void __launch_bounds__(kThreads)
fused_dora_skinny(const T* __restrict__ x,        // (M, K)
                  const T* __restrict__ w0,       // (K, N)
                  const T* __restrict__ a,        // (K, r) a_eff
                  const float* __restrict__ a_mag,// (K,)
                  const T* __restrict__ b_dir,    // (r, N)
                  const float* __restrict__ b_mag,// (r,) b_eff_mag
                  T* __restrict__ y,              // (M, N)
                  int M, int K, int N, int r, float scale) {
  constexpr int kHE = kSkinnyRows * RT / 32;      // h entries per lane
  __shared__ __align__(16) float xs[kChunk][kSkinnyRows];   // x
  __shared__ __align__(16) float xm[kChunk][kSkinnyRows];   // T(x * T(a_mag))
  __shared__ float red[kWarps][kSkinnyRows][kSkinnyBN];
  __shared__ float hred[kWarps][kSkinnyRows * RT];
  __shared__ float hf[kSkinnyRows][RT];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * kSkinnyBN + lane;
  const int m0 = blockIdx.y * kSkinnyRows;

  float acc[kSkinnyRows];
#pragma unroll
  for (int m = 0; m < kSkinnyRows; ++m) acc[m] = 0.f;
  float hacc[kHE];
#pragma unroll
  for (int e = 0; e < kHE; ++e) hacc[e] = 0.f;

  for (int c0 = 0; c0 < K; c0 += kChunk) {
    for (int i = threadIdx.x; i < kChunk * kSkinnyRows; i += kThreads) {
      const int m = i / kChunk, kk = i % kChunk;
      const int k = c0 + kk;
      float v = 0.f, vm = 0.f;
      if (m0 + m < M && k < K) {
        v = to_f(x[static_cast<size_t>(m0 + m) * K + k]);
        vm = round_to<T>(v * round_to<T>(a_mag[k]));
      }
      xs[kk][m] = v;
      xm[kk][m] = vm;
    }
    __syncthreads();
    const int w_begin = c0 + warp * kWarpRows;
    const int w_end = min(K, w_begin + kWarpRows);
    float wv[kWarpRows];
#pragma unroll
    for (int u = 0; u < kWarpRows; ++u) {
      const int k = w_begin + u;
      wv[u] = (k < w_end && n < N) ? to_f(w0[static_cast<size_t>(k) * N + n]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kWarpRows; ++u) {
      const int k = w_begin + u;
      if (k >= w_end) break;
      const int kk = k - c0;
      const float4 xa = *reinterpret_cast<const float4*>(&xs[kk][0]);
      const float4 xb = *reinterpret_cast<const float4*>(&xs[kk][4]);
      const float xv[kSkinnyRows] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
      for (int m = 0; m < kSkinnyRows; ++m) acc[m] = fmaf(xv[m], wv[u], acc[m]);
#pragma unroll
      for (int e = 0; e < kHE; ++e) {
        const int idx = lane + 32 * e;
        const int m = idx / RT, j = idx % RT;
        const float av = (j < r) ? to_f(a[static_cast<size_t>(k) * r + j]) : 0.f;
        hacc[e] = fmaf(xm[kk][m], av, hacc[e]);
      }
    }
    __syncthreads();
  }

  // add the warps' partial sums in a fixed order
#pragma unroll
  for (int m = 0; m < kSkinnyRows; ++m) red[warp][m][lane] = acc[m];
#pragma unroll
  for (int e = 0; e < kHE; ++e) hred[warp][lane + 32 * e] = hacc[e];
  __syncthreads();
  for (int idx = threadIdx.x; idx < kSkinnyRows * RT; idx += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += hred[w][idx];
    const int m = idx / RT, j = idx % RT;
    hf[m][j] = (j < r) ? round_to<T>(s * b_mag[j]) : 0.f;
  }
  __syncthreads();

  // epilogue: one output per thread
  const int m = threadIdx.x / kSkinnyBN, c = threadIdx.x % kSkinnyBN;
  const int gm = m0 + m, gn = blockIdx.x * kSkinnyBN + c;
  if (gm >= M || gn >= N) return;
  float base = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) base += red[w][m][c];
  float delta = 0.f;
#pragma unroll
  for (int j = 0; j < RT; ++j)
    if (j < r) delta = fmaf(hf[m][j], to_f(b_dir[static_cast<size_t>(j) * N + gn]), delta);
  y[static_cast<size_t>(gm) * N + gn] = from_f<T>(base + scale * delta);
}

// ---------------------------------------------------------------------------
// tiled path (prefill)
// ---------------------------------------------------------------------------

constexpr int kBM = 64, kBN = 64, kBK = 32, kTM = 4, kTN = 4;
constexpr int kTX = kBN / kTN;          // 16 threads across columns
constexpr int kTY = kBM / kTM;          // 16 threads down rows

template <typename T, int RT>
__global__ void __launch_bounds__(kThreads)
fused_dora_tiled(const T* __restrict__ x, const T* __restrict__ w0, const T* __restrict__ a,
                 const float* __restrict__ a_mag, const T* __restrict__ b_dir,
                 const float* __restrict__ b_mag, T* __restrict__ y,
                 int M, int K, int N, int r, float scale) {
  constexpr int kHE = kBM * RT / kThreads;        // h entries per thread
  // x tile and x * a_mag tile, k-major; after the K loop the same memory
  // holds the finished (kBM x RT) h
  __shared__ float xbuf[2][kBK][kBM + 1];
  __shared__ float wt[kBK][kBN];
  __shared__ float at[kBK][RT];
  static_assert(kBM * RT <= 2 * kBK * (kBM + 1), "h does not fit the x tiles");
  float (*xt)[kBM + 1] = xbuf[0];
  float (*xm)[kBM + 1] = xbuf[1];
  float* hf = &xbuf[0][0][0];                     // [kBM][RT] after the loop

  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  float hacc[kHE];
#pragma unroll
  for (int e = 0; e < kHE; ++e) hacc[e] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = threadIdx.x; i < kBM * kBK; i += kThreads) {
      const int m = i / kBK, kk = i % kBK;
      const int gm = m0 + m, k = k0 + kk;
      float v = 0.f, vm = 0.f;
      if (gm < M && k < K) {
        v = to_f(x[static_cast<size_t>(gm) * K + k]);
        vm = round_to<T>(v * round_to<T>(a_mag[k]));
      }
      xt[kk][m] = v;
      xm[kk][m] = vm;
    }
    for (int i = threadIdx.x; i < kBK * kBN; i += kThreads) {
      const int kk = i / kBN, nn = i % kBN;
      const int k = k0 + kk, gn = n0 + nn;
      wt[kk][nn] = (k < K && gn < N) ? to_f(w0[static_cast<size_t>(k) * N + gn]) : 0.f;
    }
    for (int i = threadIdx.x; i < kBK * RT; i += kThreads) {
      const int kk = i / RT, j = i % RT;
      const int k = k0 + kk;
      at[kk][j] = (k < K && j < r) ? to_f(a[static_cast<size_t>(k) * r + j]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float av[kTM], bv[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) av[i] = xt[kk][ty + i * kTY];
#pragma unroll
      for (int j = 0; j < kTN; ++j) bv[j] = wt[kk][tx + j * kTX];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
#pragma unroll
      for (int e = 0; e < kHE; ++e) {
        const int idx = threadIdx.x + kThreads * e;
        hacc[e] = fmaf(xm[kk][idx / RT], at[kk][idx % RT], hacc[e]);
      }
    }
    __syncthreads();
  }

  // finished h: T(h * b_eff_mag), zero past the rank
#pragma unroll
  for (int e = 0; e < kHE; ++e) {
    const int idx = threadIdx.x + kThreads * e;
    const int j = idx % RT;
    hf[idx] = (j < r) ? round_to<T>(hacc[e] * b_mag[j]) : 0.f;
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = ty + i * kTY;
    const int gm = m0 + m;
    if (gm >= M) continue;
#pragma unroll
    for (int jn = 0; jn < kTN; ++jn) {
      const int gn = n0 + tx + jn * kTX;
      if (gn >= N) continue;
      float delta = 0.f;
#pragma unroll
      for (int j = 0; j < RT; ++j)
        if (j < r) delta = fmaf(hf[m * RT + j], to_f(b_dir[static_cast<size_t>(j) * N + gn]), delta);
      y[static_cast<size_t>(gm) * N + gn] = from_f<T>(acc[i][jn] + scale * delta);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w0, const void* a, const float* a_mag,
           const void* b_dir, const float* b_mag, void* y, int M, int K, int N,
           int r, float scale, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || r < 1 || r > kMaxRank)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w0);
  const T* at = static_cast<const T*>(a);
  const T* bt = static_cast<const T*>(b_dir);
  T* yt = static_cast<T*>(y);
  const bool skinny = M <= 2 * kSkinnyRows;
  const dim3 grid = skinny
      ? dim3((N + kSkinnyBN - 1) / kSkinnyBN, (M + kSkinnyRows - 1) / kSkinnyRows)
      : dim3((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
#define FD_LAUNCH(RT)                                                                  \
  do {                                                                                 \
    if (skinny)                                                                        \
      fused_dora_skinny<T, RT><<<grid, kThreads, 0, st>>>(xt, wt, at, a_mag, bt,       \
                                                          b_mag, yt, M, K, N, r, scale); \
    else                                                                               \
      fused_dora_tiled<T, RT><<<grid, kThreads, 0, st>>>(xt, wt, at, a_mag, bt, b_mag, \
                                                         yt, M, K, N, r, scale);       \
  } while (0)
  if (r <= 8) FD_LAUNCH(8);
  else if (r <= 16) FD_LAUNCH(16);
  else if (r <= 32) FD_LAUNCH(32);
  else FD_LAUNCH(64);
#undef FD_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* fused_dora_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int fused_dora_f32(const void* x, const void* w0, const void* a_eff, const float* a_mag,
                   const void* b_dir, const float* b_eff_mag, void* y, int M, int K,
                   int N, int r, float scale, void* stream) {
  return launch<float>(x, w0, a_eff, a_mag, b_dir, b_eff_mag, y, M, K, N, r, scale, stream);
}

int fused_dora_bf16(const void* x, const void* w0, const void* a_eff, const float* a_mag,
                    const void* b_dir, const float* b_eff_mag, void* y, int M, int K,
                    int N, int r, float scale, void* stream) {
  return launch<__nv_bfloat16>(x, w0, a_eff, a_mag, b_dir, b_eff_mag, y, M, K, N, r,
                               scale, stream);
}

}  // extern "C"

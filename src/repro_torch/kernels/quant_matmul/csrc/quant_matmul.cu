// Hand-written Hopper (sm_90a) dequant-fused weight-only quantized matmul.
//
// Replaces the Pallas TPU kernel quant_matmul_kernel (body _qmm_kernel) of
// src/repro/kernels/quant_matmul/quant_matmul.py.  It computes what the
// Pallas body computes:
//
//   y[m, n] = sum_k f32(x[m, k]) * (f32(code[k, n]) * scale[k / (K / G), n])
//
// with the weight dequantized in f32 inside the tile, the products summed in
// f32, and y stored in x's type.  Codes are int8 (K, N), or int4 packed two
// per byte along K (K/2, N): row 2j in the low nibble, row 2j+1 in the high
// one, each stored +8.  No f32 or bf16 copy of the weight ever exists in
// device memory: each code is widened and scaled in registers.
//
// What bounds it.  At decode (M = 8) bytes: the codes (16.8 MB for a
// 4096 x 4096 int8 matrix) are read once, 2 operations per code and row, so
// 16 operations per byte of int8 codes, far below the card's ~295; the floor
// is the codes over 3.35 TB/s (5.0 us).  At prefill (M = 512) operations:
// 17.2 GFLOP for 4096 x 4096.  The math stays in f32 on the CUDA cores, as
// the Pallas body's f32 dot does, so its ceiling is the 67 TFLOP/s f32 rate,
// not the tensor cores' bf16 rate (a tensor-core version would round the
// dequantized weight to bf16 and change the numbers).
//
// Design (a simple first version that is right):
//   * M <= 16: the skinny path, for decode.  A block owns 8 rows and
//     128 columns, 4 per lane, so one 32-bit load brings 4 int8 codes or 4
//     columns of two int4 rows.  To occupy the card at M = 8 (N / 128 = 32
//     blocks for N = 4096), K is split across blocks: each writes an f32
//     partial, and a second pass sums the partials in a fixed order and
//     casts (deterministic, no atomics).  Inside a block K is walked in
//     chunks of 256 rows: the chunk of x is staged in shared memory as f32
//     (read back as broadcasts), and each warp takes 32 consecutive rows of
//     it with its loads unrolled, so each lane keeps several code loads in
//     flight; the warps' partial sums are added in shared memory at the end.
//     The row's group scale is reloaded only when the group changes.
//   * larger M: a shared-memory tiled product, 64 x 64 output tiles, 256
//     threads of 4 x 4 outputs, K in tiles of 32: the x tile is staged as f32,
//     the code tile is dequantized into shared memory as f32 on the way in.
// Ragged M, N and K are masked in the kernel; nothing is padded.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// the code of weight row k, column n, as f32
template <bool INT4>
__device__ __forceinline__ float code_at(const uint8_t* __restrict__ q, int k, int n, int N) {
  if (INT4) {
    const unsigned b = q[static_cast<size_t>(k >> 1) * N + n];
    return static_cast<float>(static_cast<int>((k & 1) ? (b >> 4) : (b & 15u)) - 8);
  }
  return static_cast<float>(static_cast<int8_t>(q[static_cast<size_t>(k) * N + n]));
}

// ---------------------------------------------------------------------------
// skinny path (decode): split-K partials
// ---------------------------------------------------------------------------

constexpr int kSkinnyRows = 8;            // rows of x per block
constexpr int kCols = 4;                  // columns per lane
constexpr int kSkinnyBN = 32 * kCols;     // columns per block
constexpr int kChunk = 256;               // rows of K staged at a time
constexpr int kWarpRows = kChunk / kWarps;

// 4 bytes of a code row at columns n0..n0+3 (zero past N)
template <bool VEC>
__device__ __forceinline__ uint32_t load4(const uint8_t* __restrict__ row, int n0, int N) {
  if (VEC) return __ldg(reinterpret_cast<const unsigned int*>(row + n0));
  uint32_t v = 0;
#pragma unroll
  for (int c = 0; c < kCols; ++c)
    if (n0 + c < N) v |= static_cast<uint32_t>(__ldg(row + n0 + c)) << (8 * c);
  return v;
}

template <typename T, bool INT4, bool VEC>
__global__ void __launch_bounds__(kThreads)
qmm_skinny(const T* __restrict__ x,          // (M, K)
           const uint8_t* __restrict__ q,    // (K, N) int8 or (K/2, N) packed
           const float* __restrict__ scale,  // (G, N)
           float* __restrict__ part,         // (splits, M, N) or nullptr
           T* __restrict__ y,                // (M, N), written when part is null
           int M, int K, int N, int G, int split_len) {
  __shared__ __align__(16) float xs[kChunk][kSkinnyRows];
  __shared__ __align__(16) float red[kWarps][kSkinnyRows][kSkinnyBN];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * kSkinnyBN + lane * kCols;
  const int m0 = blockIdx.z * kSkinnyRows;
  const int k_begin = blockIdx.y * split_len;
  const int k_end = min(K, k_begin + split_len);
  const int gsz = K / G;

  float acc[kSkinnyRows][kCols];
#pragma unroll
  for (int m = 0; m < kSkinnyRows; ++m)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[m][c] = 0.f;

  int cur_g = -1;
  float s[kCols];

  for (int c0 = k_begin; c0 < k_end; c0 += kChunk) {
    // stage x[m0:m0+8, c0:c0+kChunk] as f32, k-major
    for (int i = threadIdx.x; i < kChunk * kSkinnyRows; i += kThreads) {
      const int m = i / kChunk, kk = i % kChunk;
      const int k = c0 + kk;
      xs[kk][m] = (m0 + m < M && k < k_end)
                      ? to_f(x[static_cast<size_t>(m0 + m) * K + k]) : 0.f;
    }
    __syncthreads();
    if (n0 < N) {
      const int w_begin = c0 + warp * kWarpRows;
      const int w_end = min(k_end, w_begin + kWarpRows);
      // each step takes one 32-bit load: one int8 row, or two int4 rows
      constexpr int kStep = INT4 ? 2 : 1;
      constexpr int kUnroll = kWarpRows / kStep;
      uint32_t raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = w_begin + u * kStep;
        raw[u] = (k < w_end) ? load4<VEC>(q + static_cast<size_t>(INT4 ? (k >> 1) : k) * N, n0, N) : 0u;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int h = 0; h < kStep; ++h) {
          const int k = w_begin + u * kStep + h;
          if (k < w_end) {
            const int g = k / gsz;
            if (g != cur_g) {
              cur_g = g;
#pragma unroll
              for (int c = 0; c < kCols; ++c)
                s[c] = (n0 + c < N) ? __ldg(scale + static_cast<size_t>(g) * N + n0 + c) : 0.f;
            }
            const float4 xa = *reinterpret_cast<const float4*>(&xs[k - c0][0]);
            const float4 xb = *reinterpret_cast<const float4*>(&xs[k - c0][4]);
            const float xv[kSkinnyRows] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
              const unsigned byte = (raw[u] >> (8 * c)) & 0xffu;
              float code;
              if (INT4) code = static_cast<float>(static_cast<int>(h ? (byte >> 4) : (byte & 15u)) - 8);
              else code = static_cast<float>(static_cast<int8_t>(byte));
              const float w = code * s[c];
#pragma unroll
              for (int m = 0; m < kSkinnyRows; ++m) acc[m][c] = fmaf(xv[m], w, acc[m][c]);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  // add the warps' partial sums (each warp took its own rows of K) in a
  // fixed order
#pragma unroll
  for (int m = 0; m < kSkinnyRows; ++m)
    *reinterpret_cast<float4*>(&red[warp][m][lane * kCols]) =
        make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  __syncthreads();
  const int nb = blockIdx.x * kSkinnyBN;
  for (int i = threadIdx.x; i < kSkinnyRows * kSkinnyBN; i += kThreads) {
    const int m = i / kSkinnyBN, c = i % kSkinnyBN;
    if (m0 + m >= M || nb + c >= N) continue;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red[w][m][c];
    const size_t o = static_cast<size_t>(m0 + m) * N + nb + c;
    if (part) part[static_cast<size_t>(blockIdx.y) * M * N + o] = sum;
    else y[o] = from_f<T>(sum);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
qmm_reduce(const float* __restrict__ part, T* __restrict__ y, long long MN, int splits) {
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < MN;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    float s = 0.f;
    for (int p = 0; p < splits; ++p) s += part[p * MN + i];
    y[i] = from_f<T>(s);
  }
}

// ---------------------------------------------------------------------------
// tiled path (prefill)
// ---------------------------------------------------------------------------

constexpr int kBM = 64, kBN = 64, kBK = 32, kTM = 4, kTN = 4;
constexpr int kTX = kBN / kTN;            // 16 threads across columns

template <typename T, bool INT4>
__global__ void __launch_bounds__(kThreads)
qmm_tiled(const T* __restrict__ x, const uint8_t* __restrict__ q,
          const float* __restrict__ scale, T* __restrict__ y,
          int M, int K, int N, int G) {
  __shared__ float xt[kBK][kBM + 1];     // x tile, k-major
  __shared__ float wt[kBK][kBN];         // dequantized weight tile

  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int gsz = K / G;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = threadIdx.x; i < kBM * kBK; i += kThreads) {
      const int m = i / kBK, kk = i % kBK;
      const int gm = m0 + m, k = k0 + kk;
      xt[kk][m] = (gm < M && k < K) ? to_f(x[static_cast<size_t>(gm) * K + k]) : 0.f;
    }
    for (int i = threadIdx.x; i < kBK * kBN; i += kThreads) {
      const int kk = i / kBN, n = i % kBN;
      const int k = k0 + kk, gn = n0 + n;
      wt[kk][n] = (k < K && gn < N)
                      ? code_at<INT4>(q, k, gn, N) * __ldg(scale + static_cast<size_t>(k / gsz) * N + gn)
                      : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = xt[kk][ty + i * (kBM / kTM)];
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = wt[kk][tx + j * kTX];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gm = m0 + ty + i * (kBM / kTM);
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gn = n0 + tx + j * kTX;
      if (gn < N) y[static_cast<size_t>(gm) * N + gn] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T, bool INT4>
int launch(const void* x, const void* q, const float* scale, float* part, void* y,
           int M, int K, int N, int G, int splits, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || G <= 0 || K % G || (INT4 && K % 2) || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  const uint8_t* qt = static_cast<const uint8_t*>(q);
  T* yt = static_cast<T*>(y);
  if (M > kSkinnyRows * 2) {
    const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
    qmm_tiled<T, INT4><<<grid, kThreads, 0, st>>>(xt, qt, scale, yt, M, K, N, G);
    return static_cast<int>(cudaGetLastError());
  }
  if (splits > 1 && part == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  // split length: a whole number of int4 row pairs
  int split_len = (K + splits - 1) / splits;
  split_len += split_len & 1;
  const dim3 grid((N + kSkinnyBN - 1) / kSkinnyBN, splits, (M + kSkinnyRows - 1) / kSkinnyRows);
  const bool vec = (N % kCols == 0) && (reinterpret_cast<uintptr_t>(q) % 4 == 0);
  float* p = splits > 1 ? part : nullptr;
  if (vec)
    qmm_skinny<T, INT4, true><<<grid, kThreads, 0, st>>>(xt, qt, scale, p, yt, M, K, N, G, split_len);
  else
    qmm_skinny<T, INT4, false><<<grid, kThreads, 0, st>>>(xt, qt, scale, p, yt, M, K, N, G, split_len);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long MN = static_cast<long long>(M) * N;
  const long long want = (MN + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  qmm_reduce<T><<<blocks, kThreads, 0, st>>>(part, yt, MN, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* quant_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K splits of the skinny path for an (M, K) x (K, N) call on a card with
// `sm_count` SMs: enough blocks for two a SM, at least 256 rows of K each;
// 1 on the tiled path.  The caller allocates `part` as (splits, M, N) f32
// when this is above 1.
int quant_matmul_splits(int M, int K, int N, int sm_count) {
  if (M > 2 * kSkinnyRows) return 1;
  const int blocks = ((N + kSkinnyBN - 1) / kSkinnyBN) * ((M + kSkinnyRows - 1) / kSkinnyRows);
  int s = (2 * sm_count + blocks - 1) / blocks;
  const int most = (K + kChunk - 1) / kChunk;
  s = s < most ? s : most;
  return s < 1 ? 1 : s;
}

#define QMM_ENTRY(NAME, T, INT4)                                                    \
  int NAME(const void* x, const void* q, const float* scale, float* part, void* y,  \
           int M, int K, int N, int G, int splits, void* stream) {                  \
    return launch<T, INT4>(x, q, scale, part, y, M, K, N, G, splits, stream);       \
  }

QMM_ENTRY(quant_matmul_int8_f32, float, false)
QMM_ENTRY(quant_matmul_int8_bf16, __nv_bfloat16, false)
QMM_ENTRY(quant_matmul_int4_f32, float, true)
QMM_ENTRY(quant_matmul_int4_bf16, __nv_bfloat16, true)

#undef QMM_ENTRY

}  // extern "C"

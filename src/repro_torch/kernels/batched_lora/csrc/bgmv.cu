// Hand-written Hopper (sm_90a) BGMV kernels for mixed-tenant LoRA serving.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/batched_lora/bgmv.py:
//   bgmv_matmul     (_bgmv_kernel, _bgmv_ranked_kernel)          -> bgmv_kernel<T, RT, false>
//   bgmv_mag_matmul (_bgmv_mag_kernel, _bgmv_mag_ranked_kernel)  -> bgmv_kernel<T, RT, true>
// One kernel covers both Pallas variants of each: a null `ranks` pointer
// means full rank.
//
// Per token row (b, s) of x (B, S, d_in), with slot = idx[b]:
//   pairs      y = scale * ((x . A[slot]) . B[slot])
//   magnitude  y = scale * ((((x * a_mag) . a_dir) * (b_mag + dmag[slot])) . b_dir)
// and, with ranks, the rank-r intermediate zeroed at columns >= ranks[slot]
// (after the magnitude product), so a rank-0 slot gives exactly 0.
// Cast points follow the Pallas bodies: the f32 factors are rounded to the
// activation type before each product, x * a_mag is taken in the activation
// type, the shrink and the expand accumulate in f32, the magnitude multiplies
// the f32 intermediate, h is rounded to the activation type before the
// expand, and y is scaled in f32 and stored in the activation type.
//
// What bounds it: bytes.  Per call it does 2 * B * S * r * (d_in + d_out)
// operations on x, the gathered factors and y, which it reads and writes
// once each: at decode (B=8, S=1, d=4096, r=8) that is about 1 MFLOP against
// x + y (128 KB in bf16) plus one (d_in, r) + (r, d_out) f32 pair per distinct
// slot (256 KB each, 2 MB for 8 slots) -- far below the card's ~295
// operations per byte, so the floor is bytes over the memory rate.
//
// Design (a simple first version that is right): one block per token row.
// The block loads its own slot index and rank; its threads stride over d_in
// (coalesced x reads, each thread reading its r contiguous factor values) and
// keep r partial sums in registers (r is a runtime argument up to a compiled
// bucket RT in {8, 16, 32, 64}), reduced by warp shuffles and then across
// warps in shared memory into h[r].  After a barrier the threads stride over
// d_out for the expand (coalesced factor reads and y writes).  Each byte of x,
// y and the factors crosses device memory once per row; rows of one slot
// re-read its factors from L2.  At decode this fills only B of the 132 SMs
// (8 blocks at 8 rows): split-K shrink and a tiled expand are the next step.

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

// round an f32 value to the activation type and back (an .astype(x.dtype) point)
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

template <typename T, int RT, bool MAG>
__global__ void __launch_bounds__(kThreads)
bgmv_kernel(const T* __restrict__ x,         // (B, S, d_in)
            const float* __restrict__ a,     // pairs: (L, d_in, r); mag: a_dir (d_in, r)
            const float* __restrict__ b,     // pairs: (L, r, d_out); mag: b_dir (r, d_out)
            const float* __restrict__ a_mag, // mag: (d_in,)
            const float* __restrict__ b_mag, // mag: (r,)
            const float* __restrict__ dmag,  // mag: (L, r)
            const int* __restrict__ idx,     // (B,)
            const int* __restrict__ ranks,   // (L,) or nullptr: full rank
            T* __restrict__ y,               // (B, S, d_out)
            int S, int d_in, int d_out, int r, int L, float scale) {
  __shared__ float part[kWarps][RT];
  __shared__ float h[RT];

  const int token = blockIdx.x;
  const int slot = idx[token / S];
  const T* xr = x + static_cast<size_t>(token) * d_in;
  T* yr = y + static_cast<size_t>(token) * d_out;
  if (slot < 0 || slot >= L) {
    // an out-of-range slot reads nothing: the row comes out NaN, so every
    // finiteness check downstream sees it
    for (int o = threadIdx.x; o < d_out; o += kThreads) yr[o] = from_f<T>(__int_as_float(0x7fc00000));
    return;
  }
  const int keep = ranks ? min(ranks[slot], r) : r;
  const float* A = MAG ? a : a + static_cast<size_t>(slot) * d_in * r;
  const float* Bf = MAG ? b : b + static_cast<size_t>(slot) * r * d_out;

  // shrink: h = x . A, partial sums over this thread's d_in stride
  float acc[RT];
#pragma unroll
  for (int j = 0; j < RT; ++j) acc[j] = 0.f;
  for (int k = threadIdx.x; k < d_in; k += kThreads) {
    float xv = to_f(xr[k]);
    if (MAG) xv = round_to<T>(xv * round_to<T>(a_mag[k]));
    const float* ak = A + static_cast<size_t>(k) * r;
#pragma unroll
    for (int j = 0; j < RT; ++j)
      if (j < r) acc[j] = fmaf(xv, round_to<T>(ak[j]), acc[j]);
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < RT; ++j) {
    float v = acc[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) part[warp][j] = v;
  }
  __syncthreads();
  if (threadIdx.x < RT) {
    const int j = threadIdx.x;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += part[w][j];
    if (MAG && j < r) v *= b_mag[j] + dmag[static_cast<size_t>(slot) * r + j];
    h[j] = (j < keep) ? round_to<T>(v) : 0.f;
  }
  __syncthreads();

  // expand: y = scale * (h . B)
  for (int o = threadIdx.x; o < d_out; o += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < RT; ++j)
      if (j < r) s = fmaf(h[j], round_to<T>(Bf[static_cast<size_t>(j) * d_out + o]), s);
    yr[o] = from_f<T>(s * scale);
  }
}

template <typename T, bool MAG>
int launch(const void* x, const float* a, const float* b, const float* a_mag,
           const float* b_mag, const float* dmag, const int* idx,
           const int* ranks, void* y, int B, int S, int d_in, int d_out,
           int r, int L, float scale, void* stream) {
  if (B <= 0 || S <= 0 || d_in <= 0 || d_out <= 0 || r < 1 || r > kMaxRank || L < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(B) * static_cast<unsigned>(S));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
#define BGMV_LAUNCH(RT)                                                         \
  bgmv_kernel<T, RT, MAG><<<grid, kThreads, 0, st>>>(xt, a, b, a_mag, b_mag,   \
                                                      dmag, idx, ranks, yt, S, \
                                                      d_in, d_out, r, L, scale)
  if (r <= 8) BGMV_LAUNCH(8);
  else if (r <= 16) BGMV_LAUNCH(16);
  else if (r <= 32) BGMV_LAUNCH(32);
  else BGMV_LAUNCH(64);
#undef BGMV_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* bgmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int bgmv_f32(const void* x, const float* a_pool, const float* b_pool,
             const int* idx, const int* ranks, void* y, int B, int S,
             int d_in, int d_out, int r, int L, float scale, void* stream) {
  return launch<float, false>(x, a_pool, b_pool, nullptr, nullptr, nullptr,
                              idx, ranks, y, B, S, d_in, d_out, r, L, scale,
                              stream);
}

int bgmv_bf16(const void* x, const float* a_pool, const float* b_pool,
              const int* idx, const int* ranks, void* y, int B, int S,
              int d_in, int d_out, int r, int L, float scale, void* stream) {
  return launch<__nv_bfloat16, false>(x, a_pool, b_pool, nullptr, nullptr,
                                      nullptr, idx, ranks, y, B, S, d_in,
                                      d_out, r, L, scale, stream);
}

int bgmv_mag_f32(const void* x, const float* a_dir, const float* a_mag,
                 const float* b_mag, const float* dmag_pool,
                 const float* b_dir, const int* idx, const int* ranks,
                 void* y, int B, int S, int d_in, int d_out, int r, int L,
                 float scale, void* stream) {
  return launch<float, true>(x, a_dir, b_dir, a_mag, b_mag, dmag_pool, idx,
                             ranks, y, B, S, d_in, d_out, r, L, scale,
                             stream);
}

int bgmv_mag_bf16(const void* x, const float* a_dir, const float* a_mag,
                  const float* b_mag, const float* dmag_pool,
                  const float* b_dir, const int* idx, const int* ranks,
                  void* y, int B, int S, int d_in, int d_out, int r, int L,
                  float scale, void* stream) {
  return launch<__nv_bfloat16, true>(x, a_dir, b_dir, a_mag, b_mag,
                                     dmag_pool, idx, ranks, y, B, S, d_in,
                                     d_out, r, L, scale, stream);
}

}  // extern "C"

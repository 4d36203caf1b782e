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
// block recomputes the (rows x r) h for its rows: h depends only on the rows
// and K, so that is right, and it is a rank-r side product beside the base
// tile's columns (r = 8 against 128 columns on the tensor-core variants).
//
// In bf16 every operand of the three products is a bf16 value at those cast
// points (x * T(a_mag) is an exact f32 product rounded once), so mma.sync with
// bf16 operands and f32 sums computes the same exact products with f32 sums:
// only the order of the sums differs from the Pallas body.
//
// Four kernels; launch() below is the one place that picks one, by dtype
// and M:
//
//   skinny       f32, M <= 16.  CUDA cores.  A block owns 8 rows and 32
//                   columns, one per lane; its 8 warps split each 256-row
//                   chunk of K, 32 consecutive rows a warp.  The chunk of x is
//                   staged in shared memory as f32 and as the rounded
//                   x * a_mag; each warp also accumulates its rows' share of
//                   h.  The warps' partial sums are added in a fixed order.
//   tiled        f32, M > 16.  CUDA cores: 64 x 64 output tiles, 256 threads
//                   of 4 x 4 outputs, K in tiles of 32 staged as f32, each
//                   thread keeping r / 4 of the tile's (64 x r) h entries.
//                   The Pallas f32 dot is a full f32 product, and TF32 would
//                   keep about three decimal digits, so f32 stays off the
//                   tensor cores.
//   mma          bf16, M > 16.  Tensor cores: mma.sync m16n8k16, bf16
//                   operands, f32 sums.  A block of 8 warps owns a 128 x 128
//                   output tile (a warp 64 rows x 32 columns); K comes in
//                   steps of 64 through a 4-stage cp.async ring of
//                   XOR-swizzled tiles: x (the A operand, ldmatrix), W0 (the
//                   B operand, ldmatrix.trans, as flash_attention's v tile),
//                   the a_eff tile and the a_mag slice.  h takes the warp's x
//                   fragment already in registers, multiplied by T(a_mag[k])
//                   for the fragment's own k and rounded to bf16, against
//                   a_eff: the 4 warp columns split h's (k step, 8 columns of
//                   r) pairs, so no warp computes h twice, and add their
//                   shares in shared memory in a fixed order.  Epilogue:
//                   T(h * b_eff_mag) in shared memory, delta = that . b_dir as
//                   one more mma with k = max(16, r bucket) (zero columns past
//                   r), y = T(acc + scale * delta).
//   mma_decode   bf16, M <= 16.  Bound by the bytes of W0.  Split K over
//                   blocks: grid (128-column tiles, splits) with about 4
//                   blocks a SM, each split a whole number of 64-row stages.
//                   W0 streams in 16-byte cp.async rows through a 4-stage
//                   ring.  The operands are swapped, y^T = W0^T . x^T: W0's
//                   tile is the A operand through ldmatrix.trans (a warp 16
//                   columns) and the <= 16 rows of x are mma's n (one n-tile
//                   of 8, two above 8 rows).  Only the first column tile of
//                   each split computes the split's h.  Each block writes f32
//                   partials of its base tile and of h to a workspace the
//                   wrapper allocates; fused_dora_decode_reduce then adds the
//                   splits in a fixed order and runs the epilogue, so the
//                   result does not depend on the order blocks run in.
//
// What bounds it.  At decode (M = 8, K = N = 4096, r = 8, bf16): bytes,
// 33.6 MB of W0 over 3.35 TB/s, about 10 us.  At prefill (M = 512):
// operations, 17.2 GFLOP, about 17 us at the bf16 tensor-core rate; mma.sync
// reaches a fraction of the rate wgmma reaches.  The f32 kernels are bound by
// the 67 TFLOP/s of the CUDA cores at prefill.
//
// Ragged M, N and K are masked in the kernels; nothing is padded in memory.
// Rows that are not a whole number of 16-byte chunks, or at pointers that are
// not 16-byte aligned, are loaded with guarded plain loads that fill zeros
// instead of cp.async.  The rank is a runtime argument up to a compiled
// bucket RT in {8, 16, 32, 64}.

#include <algorithm>

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (mma and mma_decode)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// cp_async16, ldmatrix_x4, ldmatrix_x4_trans, mma_bf16 and pack_bf16 are
// copied from src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu
// (each source builds alone); swz there is swz<CH> here for rows of any
// number of 16-byte chunks.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// the B fragment of one n-tile (k 16 x n 8) from a k-major tile; lanes 0-15
// give the addresses of rows k0 .. k0 + 15
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// d += a . b, a 16 x 16 row-major, b 16 x 8 column-major, bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// T(x * m) for two pairs of bf16 values: fma.rn of x * m + (-0) rounds the
// exact product once, as the Pallas body's bf16 x * T(a_mag) does
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t x, uint32_t m) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(x), "r"(m), "r"(0x80008000u));
  return d;
}

// byte offset of 16-byte chunk c of row r in a tile of CH chunks a row.  The
// chunk index is XORed with a function of the row, so the 8 rows one
// ldmatrix phase reads at one logical chunk fall in 8 different 16-byte bank
// groups: with r % 8 for rows of 8 chunks or more (flash_attention's swz),
// with r / (8 / CH) for shorter rows (which already spread 8 / CH rows over
// the banks)
template <int CH>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  if constexpr (CH >= 8)
    return static_cast<uint32_t>(r * CH * 16 + ((c ^ (r & 7)) << 4));
  else
    return static_cast<uint32_t>(r * CH * 16 + ((c ^ ((r / (8 / CH)) & (CH - 1))) << 4));
}

// one 16-byte chunk into shared memory at dst: the elements src[0 .. n - 1]
// of a row and zeros after them (src null or n <= 0: all zeros).  vec: the
// row is a whole number of 16-byte chunks at a 16-byte aligned address, so a
// full chunk goes by cp.async (the caller commits); otherwise plain loads.
template <typename E>
__device__ __forceinline__ void load_chunk(unsigned char* dst, const E* src, int n, bool vec) {
  constexpr int W = 16 / sizeof(E);
  if (vec && src != nullptr && n >= W) {
    cp_async16(smem_addr(dst), src);
    return;
  }
  uint4 out = make_uint4(0, 0, 0, 0);
  E* o = reinterpret_cast<E*>(&out);
  if (src != nullptr) {
#pragma unroll
    for (int i = 0; i < W; ++i)
      if (i < n) o[i] = src[i];
  }
  *reinterpret_cast<uint4*>(dst) = out;
}

// which operand rows may go by cp.async (see load_chunk)
struct Vec {
  bool x, w, a, m, b;
};

// COLS columns (a multiple of 8) of ROWS rows into the swizzled tile at
// tile: row i is row row0 + i of a (rows, ld) bf16 matrix at src, columns
// col0 .. col0 + COLS - 1; rows past `rows` and columns past ld are zero.
// A tile wholly inside the matrix with vec rows takes one cp.async a chunk
// and nothing else (the loop's trip count known at compile time).
template <int ROWS, int COLS, int NT>
__device__ __forceinline__ void load_bf16_tile(unsigned char* tile, const bf16* src, int row0,
                                               int rows, int col0, int ld, bool vec) {
  constexpr int CH = COLS / 8, CHUNKS = ROWS * CH;
  const uint16_t* s = reinterpret_cast<const uint16_t*>(src);
  if (vec && row0 + ROWS <= rows && col0 + COLS <= ld) {
    const uint16_t* base = s + static_cast<size_t>(row0) * ld + col0;
#pragma unroll
    for (int u = 0; u < (CHUNKS + NT - 1) / NT; ++u) {
      const int e = threadIdx.x + u * NT;
      if (CHUNKS % NT == 0 || e < CHUNKS)
        cp_async16(smem_addr(tile + swz<CH>(e / CH, e % CH)),
                   base + static_cast<size_t>(e / CH) * ld + 8 * (e % CH));
    }
    return;
  }
  for (int e = threadIdx.x; e < CHUNKS; e += NT) {
    const int i = e / CH, c = e % CH;
    const int row = row0 + i, col = col0 + 8 * c;
    const uint16_t* p =
        row < rows && col < ld ? s + static_cast<size_t>(row) * ld + col : nullptr;
    load_chunk(tile + swz<CH>(i, c), p, ld - col, vec);
  }
}

// a_mag[k0 .. k0 + n - 1] as f32 into dst, zero past K
template <int NT>
__device__ __forceinline__ void load_mag(unsigned char* dst, const float* a_mag, int k0, int n,
                                         int K, bool vec) {
  for (int c = threadIdx.x; c < n / 4; c += NT) {
    const int k = k0 + 4 * c;
    if (vec && k + 4 <= K)
      cp_async16(smem_addr(dst + 16 * c), a_mag + k);
    else
      load_chunk(dst + 16 * c, k < K ? a_mag + k : nullptr, K - k, vec);
  }
}

// the T(a_mag) factors of an A fragment's k columns at k step ks, as bf16
// pairs: m[0] for columns 2t, 2t + 1 and m[1] for 2t + 8, 2t + 9 of the 16
__device__ __forceinline__ void mag_factors(uint32_t (&m)[2], const float* ms, int ks, int t) {
  const float2 lo = *reinterpret_cast<const float2*>(ms + 16 * ks + 2 * t);
  const float2 hi = *reinterpret_cast<const float2*>(ms + 16 * ks + 2 * t + 8);
  m[0] = pack_bf16(lo.x, lo.y);
  m[1] = pack_bf16(hi.x, hi.y);
}

// an A fragment of x times T(a_mag) (rows g and g + 8 share the k columns)
__device__ __forceinline__ void scaled_fragment(uint32_t (&d)[4], const uint32_t (&a)[4],
                                                const uint32_t (&m)[2]) {
  d[0] = mul_bf16x2(a[0], m[0]);
  d[1] = mul_bf16x2(a[1], m[0]);
  d[2] = mul_bf16x2(a[2], m[1]);
  d[3] = mul_bf16x2(a[3], m[1]);
}

// ---------------------------------------------------------------------------
// mma: bf16, M > 16
// ---------------------------------------------------------------------------

constexpr int kMBM = 128, kMBN = 128, kMBK = 64, kMStages = 4;
constexpr int kMWarpsN = 4;                       // warp columns of 32; 2 warp rows of 64

template <int RT>
struct MmaSmem {
  static constexpr int X = kMBM * kMBK * 2;       // x tile, 8 chunks a row
  static constexpr int W = kMBK * kMBN * 2;       // W0 tile, 16 chunks a row
  static constexpr int A = kMBK * RT * 2;         // a_eff tile, RT / 8 chunks a row
  static constexpr int M = kMBK * 4;              // a_mag slice, f32
  static constexpr int STAGE = X + W + A + M;
  static constexpr int KR = RT < 16 ? 16 : RT;    // the epilogue product's k
  static constexpr int HS = kMBM * RT * 4;        // h sums, f32
  static constexpr int HF = kMBM * KR * 2;        // T(h * b_eff_mag), swizzled
  static constexpr int BD = KR * kMBN * 2;        // b_dir tile
  static constexpr int BYTES = kMStages * STAGE;
  static_assert(HS + HF + BD <= BYTES, "the epilogue fits the ring");
};

// a warp's fragments at k step ks of a stage: x rows 64 wm .. 64 wm + 63 as
// four A fragments, W0 columns 32 wn .. 32 wn + 31 as two pairs of B
// fragments (b[p][0..1] for n-tile 2p, b[p][2..3] for 2p + 1)
__device__ __forceinline__ void mma_fragments(uint32_t (&a)[4][4], uint32_t (&b)[2][4],
                                              uint32_t xa, uint32_t wa, int ks, int wm, int wn,
                                              int lane) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    ldmatrix_x4(a[i], xa + swz<kMBK / 8>(64 * wm + 16 * i + (lane & 15), 2 * ks + (lane >> 4)));
#pragma unroll
  for (int p = 0; p < 2; ++p)
    ldmatrix_x4_trans(b[p], wa + swz<kMBN / 8>(16 * ks + (lane & 15), 4 * wn + 2 * p + (lane >> 4)));
}

template <int RT>
__global__ void __launch_bounds__(kThreads)
fused_dora_mma(const bf16* __restrict__ x, const bf16* __restrict__ w0,
               const bf16* __restrict__ a, const float* __restrict__ a_mag,
               const bf16* __restrict__ b_dir, const float* __restrict__ b_mag,
               bf16* __restrict__ y, int M, int K, int N, int r, float scale, Vec vec) {
  using S = MmaSmem<RT>;
  constexpr int NT = RT / 8;                      // n-tiles of h
  constexpr int P = NT < kMWarpsN ? NT : kMWarpsN;   // warp columns that split h's n-tiles
  constexpr int Q = kMWarpsN / P;                 // ... and its k steps
  constexpr int HJ = NT / P;                      // h n-tiles a warp
  constexpr int KS = kMBK / 16;                   // k steps a stage
  static_assert(KS % Q == 0, "h's k steps split evenly");
  extern __shared__ __align__(128) unsigned char fd_smem[];
  auto xs = [&](int st) { return fd_smem + st * S::STAGE; };
  auto ws = [&](int st) { return fd_smem + st * S::STAGE + S::X; };
  auto as = [&](int st) { return fd_smem + st * S::STAGE + S::X + S::W; };
  auto ms = [&](int st) { return fd_smem + st * S::STAGE + S::X + S::W + S::A; };

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / kMWarpsN, wn = warp % kMWarpsN;
  const int jg = wn % P, kq = wn / P;             // this warp's share of h
  const int m0 = blockIdx.y * kMBM, n0 = blockIdx.x * kMBN;
  const int nk = (K + kMBK - 1) / kMBK;

  auto load_stage = [&](int kt, int st) {
    const int k0 = kt * kMBK;
    load_bf16_tile<kMBM, kMBK, kThreads>(xs(st), x, m0, M, k0, K, vec.x);
    load_bf16_tile<kMBK, kMBN, kThreads>(ws(st), w0, k0, K, n0, N, vec.w);
    load_bf16_tile<kMBK, RT, kThreads>(as(st), a, k0, K, 0, r, vec.a);
    load_mag<kThreads>(ms(st), a_mag, k0, kMBK, K, vec.m);
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  float hacc[4][HJ][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < HJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) hacc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kMStages - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kMStages - 2>();
    __syncthreads();   // tile kt is in; every warp is done with tile kt - 1's stage
    const int st = kt % kMStages;
    const uint32_t xa = smem_addr(xs(st)), wa = smem_addr(ws(st)), aa = smem_addr(as(st));
    const float* mf = reinterpret_cast<const float*>(ms(st));
    // fragments of k step ks + 1 load while k step ks multiplies
    uint32_t af[2][4][4], bf[2][2][4];
    mma_fragments(af[0], bf[0], xa, wa, 0, wm, wn, lane);
    if (kt + kMStages - 1 < nk) load_stage(kt + kMStages - 1, (kt + kMStages - 1) % kMStages);
    cp_async_commit();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int cur = ks & 1;
      if (ks + 1 < KS) mma_fragments(af[cur ^ 1], bf[cur ^ 1], xa, wa, ks + 1, wm, wn, lane);
      const bool mine = ks % Q == kq;     // this warp's share of h
      uint32_t mg[2], bh[HJ][2];
      if (mine) {
        mag_factors(mg, mf, ks, t);
#pragma unroll
        for (int jj = 0; jj < HJ; ++jj)
          ldmatrix_x2_trans(bh[jj], aa + swz<NT>(16 * ks + (lane & 15), jg + jj * P));
      }
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          mma_bf16(acc[i][2 * p], af[cur][i], bf[cur][p][0], bf[cur][p][1]);
          mma_bf16(acc[i][2 * p + 1], af[cur][i], bf[cur][p][2], bf[cur][p][3]);
        }
      if (mine) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          uint32_t xm[4];
          scaled_fragment(xm, af[cur][i], mg);
#pragma unroll
          for (int jj = 0; jj < HJ; ++jj) mma_bf16(hacc[i][jj], xm, bh[jj][0], bh[jj][1]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free for the epilogue

  // the b_dir tile (zero rows past r) comes while h is summed
  float* hs = reinterpret_cast<float*>(fd_smem);                  // [kMBM][RT]
  unsigned char* hf = fd_smem + S::HS;                            // [kMBM][KR] bf16
  unsigned char* bd = fd_smem + S::HS + S::HF;                    // [KR][kMBN] bf16
  load_bf16_tile<S::KR, kMBN, kThreads>(bd, b_dir, 0, r, n0, N, vec.b);
  cp_async_commit();
  // h: the Q warps that share n-tiles add their sums in the order kq = 0, 1, ...
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    if (kq == q) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < HJ; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = 64 * wm + 16 * i + g + 8 * (e >> 1);
            const int col = 8 * (jg + jj * P) + 2 * t + (e & 1);
            float* dst = hs + row * RT + col;
            *dst = q == 0 ? hacc[i][jj][e] : *dst + hacc[i][jj][e];
          }
    }
    __syncthreads();
  }
  // T(h * b_eff_mag), zero past the rank
  for (int e = threadIdx.x; e < kMBM * S::KR; e += kThreads) {
    const int row = e / S::KR, c = e % S::KR;
    const float v = c < r ? hs[row * RT + c] * b_mag[c] : 0.f;
    *reinterpret_cast<bf16*>(hf + swz<S::KR / 8>(row, c / 8) + 2 * (c % 8)) = __float2bfloat16(v);
  }
  cp_async_wait<0>();
  __syncthreads();

  // delta = T(h * b_eff_mag) . b_dir; y = T(acc + scale * delta)
  const uint32_t hfa = smem_addr(hf), bda = smem_addr(bd);
  const bool pairs = (N % 2) == 0 && (reinterpret_cast<uintptr_t>(y) & 3) == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float d[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < S::KR / 16; ++kk) {
      uint32_t ha[4];
      ldmatrix_x4(ha, hfa + swz<S::KR / 8>(64 * wm + 16 * i + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, bda + swz<kMBN / 8>(16 * kk + (lane & 15), 4 * wn + 2 * p + (lane >> 4)));
        mma_bf16(d[2 * p], ha, b[0], b[1]);
        mma_bf16(d[2 * p + 1], ha, b[2], b[3]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + 64 * wm + 16 * i + g + 8 * h;
      if (row >= M) continue;
      bf16* yr = y + static_cast<size_t>(row) * N;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + 32 * wn + 8 * j + 2 * t;
        const float v0 = acc[i][j][2 * h] + scale * d[j][2 * h];
        const float v1 = acc[i][j][2 * h + 1] + scale * d[j][2 * h + 1];
        if (pairs) {
          if (col < N) *reinterpret_cast<__nv_bfloat162*>(yr + col) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (col < N) yr[col] = __float2bfloat16(v0);
          if (col + 1 < N) yr[col + 1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// mma_decode: bf16, M <= 16
// ---------------------------------------------------------------------------

constexpr int kDBN = 128, kDBK = 64, kDStages = 4, kDRows = 16;
constexpr int kDecodeMaxM = 16;
constexpr int kDBlocksPerSM = 4;

template <int RT>
struct DecodeSmem {
  static constexpr int W = kDBK * kDBN * 2;       // W0 tile, 16 chunks a row
  static constexpr int X = kDRows * kDBK * 2;     // x tile, 8 chunks a row
  static constexpr int A = kDBK * RT * 2;         // a_eff tile
  static constexpr int M = kDBK * 4;              // a_mag slice
  static constexpr int STAGE = W + X + A + M;
  static constexpr int BYTES = kDStages * STAGE;
};

// rows of K a split takes for `splits` splits: a whole number of stages
__host__ __device__ inline int split_len(int K, int splits) {
  const int per = (K + splits - 1) / splits;
  return (per + kDBK - 1) / kDBK * kDBK;
}

// grid (column tiles of 128, splits).  part: (splits, M, N) f32 partial
// base products; hpart: (splits, M, kMaxRank) f32 partial h, written by the
// blocks of column tile 0.
template <int RT>
__global__ void __launch_bounds__(kThreads, 1)
fused_dora_mma_decode(const bf16* __restrict__ x, const bf16* __restrict__ w0,
                      const bf16* __restrict__ a, const float* __restrict__ a_mag,
                      float* __restrict__ part, float* __restrict__ hpart, int M, int K, int N,
                      int r, int klen, Vec vec) {
  using S = DecodeSmem<RT>;
  constexpr int NT = RT / 8;
  extern __shared__ __align__(128) unsigned char fd_smem[];
  auto ws = [&](int st) { return fd_smem + st * S::STAGE; };
  auto xs = [&](int st) { return fd_smem + st * S::STAGE + S::W; };
  auto as = [&](int st) { return fd_smem + st * S::STAGE + S::W + S::X; };
  auto ms = [&](int st) { return fd_smem + st * S::STAGE + S::W + S::X + S::A; };

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kDBN, split = blockIdx.y;
  const int k_begin = split * klen, k_end = min(K, k_begin + klen);
  const int nk = (k_end - k_begin + kDBK - 1) / kDBK;
  const bool with_h = blockIdx.x == 0;            // uniform over the block
  const bool two = M > 8;

  // rows past k_end are zero in both x and W0
  auto load_stage = [&](int kt, int st) {
    const int k0 = k_begin + kt * kDBK;
    load_bf16_tile<kDBK, kDBN, kThreads>(ws(st), w0, k0, k_end, n0, N, vec.w);
    for (int e = threadIdx.x; e < kDRows * (kDBK / 8); e += kThreads) {
      const int i = e / (kDBK / 8), c = e % (kDBK / 8);
      const int k = k0 + 8 * c;
      const uint16_t* p = i < M && k < k_end
          ? reinterpret_cast<const uint16_t*>(x) + static_cast<size_t>(i) * K + k : nullptr;
      load_chunk(xs(st) + swz<kDBK / 8>(i, c), p, k_end - k, vec.x);
    }
    if (with_h) {
      load_bf16_tile<kDBK, RT, kThreads>(as(st), a, k0, k_end, 0, r, vec.a);
      load_mag<kThreads>(ms(st), a_mag, k0, kDBK, k_end, vec.m);
    }
  };

  float d[2][4];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[q][e] = 0.f;
  float hacc[4] = {0.f, 0.f, 0.f, 0.f};           // warp w < NT: h's n-tile w

#pragma unroll
  for (int s = 0; s < kDStages - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kDStages - 2>();
    __syncthreads();
    if (kt + kDStages - 1 < nk) load_stage(kt + kDStages - 1, (kt + kDStages - 1) % kDStages);
    cp_async_commit();
    const int st = kt % kDStages;
    const uint32_t wa = smem_addr(ws(st)), xa = smem_addr(xs(st));
#pragma unroll
    for (int ks = 0; ks < kDBK / 16; ++ks) {
      // y^T = W0^T . x^T: W0's 16 columns of this warp as A, x's rows as n
      uint32_t wf[4], xf[4];
      ldmatrix_x4_trans(wf, wa + swz<kDBN / 8>(16 * ks + (lane & 7) + ((lane >> 4) << 3),
                                               2 * warp + ((lane >> 3) & 1)));
      ldmatrix_x4(xf, xa + swz<kDBK / 8>((lane & 7) + ((lane >> 4) << 3),
                                         2 * ks + ((lane >> 3) & 1)));
      mma_bf16(d[0], wf, xf[0], xf[1]);
      if (two) mma_bf16(d[1], wf, xf[2], xf[3]);
    }
    if (with_h && warp < NT) {
      const float* mf = reinterpret_cast<const float*>(ms(st));
      const uint32_t aa = smem_addr(as(st));
#pragma unroll
      for (int ks = 0; ks < kDBK / 16; ++ks) {
        uint32_t xf[4], xm[4], bh[2], mg[2];
        ldmatrix_x4(xf, xa + swz<kDBK / 8>(lane & 15, 2 * ks + (lane >> 4)));
        mag_factors(mg, mf, ks, t);
        scaled_fragment(xm, xf, mg);
        ldmatrix_x2_trans(bh, aa + swz<NT>(16 * ks + (lane & 15), warp));
        mma_bf16(hacc, xm, bh[0], bh[1]);
      }
    }
  }

  // d[q]: rows (W0 columns) n0 + 16 warp + g (+ 8), columns (x rows) 8q + 2t (+ 1)
  float* pp = part + static_cast<size_t>(split) * M * N;
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = 8 * q + 2 * t + (e & 1);
      const int n = n0 + 16 * warp + g + 8 * (e >> 1);
      if (m < M && n < N) pp[static_cast<size_t>(m) * N + n] = d[q][e];
    }
  if (with_h && warp < NT) {
    float* hp = hpart + static_cast<size_t>(split) * M * kMaxRank;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = g + 8 * (e >> 1);
      if (m < M) hp[m * kMaxRank + 8 * warp + 2 * t + (e & 1)] = hacc[e];
    }
  }
}

// the splits added in a fixed order, then the epilogue: grid (N / 32),
// a thread a column and every eighth row
template <int RT>
__global__ void __launch_bounds__(kThreads)
fused_dora_decode_reduce(const float* __restrict__ part, const float* __restrict__ hpart,
                         const bf16* __restrict__ b_dir, const float* __restrict__ b_mag,
                         bf16* __restrict__ y, int M, int N, int r, int splits, float scale) {
  __shared__ float hf[kDecodeMaxM][RT];
  for (int e = threadIdx.x; e < M * RT; e += kThreads) {
    const int m = e / RT, j = e % RT;
    float s = 0.f;
    for (int p = 0; p < splits; ++p) s += hpart[(static_cast<size_t>(p) * M + m) * kMaxRank + j];
    hf[m][j] = j < r ? round_to<bf16>(s * b_mag[j]) : 0.f;
  }
  __syncthreads();
  const int n = blockIdx.x * 32 + (threadIdx.x & 31);
  if (n >= N) return;
  const size_t MN = static_cast<size_t>(M) * N;
  for (int m = threadIdx.x >> 5; m < M; m += kThreads / 32) {
    float base = 0.f;
    for (int p = 0; p < splits; ++p) base += part[p * MN + static_cast<size_t>(m) * N + n];
    float delta = 0.f;
#pragma unroll
    for (int j = 0; j < RT; ++j)
      if (j < r) delta = fmaf(hf[m][j], __bfloat162float(b_dir[static_cast<size_t>(j) * N + n]), delta);
    y[static_cast<size_t>(m) * N + n] = __float2bfloat16(base + scale * delta);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int RT>
int launch_mma(const bf16* x, const bf16* w0, const bf16* a, const float* a_mag,
               const bf16* b_dir, const float* b_mag, bf16* y, int M, int K, int N, int r,
               float scale, Vec vec, cudaStream_t st) {
  constexpr int bytes = MmaSmem<RT>::BYTES;
  cudaError_t err = allow_smem(fused_dora_mma<RT>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kMBN - 1) / kMBN, (M + kMBM - 1) / kMBM);
  fused_dora_mma<RT><<<grid, kThreads, bytes, st>>>(x, w0, a, a_mag, b_dir, b_mag, y, M, K, N,
                                                     r, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int RT>
int launch_decode(const bf16* x, const bf16* w0, const bf16* a, const float* a_mag,
                  const bf16* b_dir, const float* b_mag, bf16* y, float* part, int M, int K,
                  int N, int r, float scale, int splits, Vec vec, cudaStream_t st) {
  constexpr int bytes = DecodeSmem<RT>::BYTES;
  cudaError_t err = allow_smem(fused_dora_mma_decode<RT>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* hpart = part + static_cast<size_t>(splits) * M * N;
  const dim3 grid((N + kDBN - 1) / kDBN, splits);
  fused_dora_mma_decode<RT><<<grid, kThreads, bytes, st>>>(x, w0, a, a_mag, part, hpart, M, K,
                                                            N, r, split_len(K, splits), vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_dora_decode_reduce<RT><<<(N + 31) / 32, kThreads, 0, st>>>(part, hpart, b_dir, b_mag, y,
                                                                   M, N, r, splits, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* w0, const void* a, const float* a_mag,
           const void* b_dir, const float* b_mag, void* y, float* part, int M, int K, int N,
           int r, float scale, int splits, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || r < 1 || r > kMaxRank)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (sizeof(T) == 2) {
    const bf16* xt = static_cast<const bf16*>(x);
    const bf16* wt = static_cast<const bf16*>(w0);
    const bf16* at = static_cast<const bf16*>(a);
    const bf16* bt = static_cast<const bf16*>(b_dir);
    bf16* yt = static_cast<bf16*>(y);
    const Vec vec{K % 8 == 0 && aligned16(x), N % 8 == 0 && aligned16(w0),
                  r % 8 == 0 && aligned16(a), aligned16(a_mag), N % 8 == 0 && aligned16(b_dir)};
    if (M > kDecodeMaxM) {
      if ((M + kMBM - 1) / kMBM > 65535) return static_cast<int>(cudaErrorInvalidValue);
#define FD_MMA(RT) launch_mma<RT>(xt, wt, at, a_mag, bt, b_mag, yt, M, K, N, r, scale, vec, st)
      if (r <= 8) return FD_MMA(8);
      if (r <= 16) return FD_MMA(16);
      if (r <= 32) return FD_MMA(32);
      return FD_MMA(64);
#undef FD_MMA
    }
    // the workspace of fused_dora_splits(M, K, N, 1, ...) splits
    if (part == nullptr || splits < 1 || splits > 65535 ||
        (K + split_len(K, splits) - 1) / split_len(K, splits) != splits)
      return static_cast<int>(cudaErrorInvalidValue);
#define FD_DEC(RT)                                                                        \
  launch_decode<RT>(xt, wt, at, a_mag, bt, b_mag, yt, part, M, K, N, r, scale, splits, vec, st)
    if (r <= 8) return FD_DEC(8);
    if (r <= 16) return FD_DEC(16);
    if (r <= 32) return FD_DEC(32);
    return FD_DEC(64);
#undef FD_DEC
  } else {
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
}

}  // namespace

extern "C" {

const char* fused_dora_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K splits of the bf16 decode variant (M <= 16) for an (M, K) x (K, N) call
// on a card with `sm_count` SMs: about kDBlocksPerSM blocks a SM, each split
// a whole number of 64-row stages, none empty.  0 when the call takes no
// workspace (f32, or M > 16); else the caller allocates `part` as
// splits x M x (N + 64) f32 (the base partials, then h's).
int fused_dora_splits(int M, int K, int N, int is_bf16, int sm_count) {
  if (!is_bf16 || M <= 0 || M > kDecodeMaxM || K <= 0 || N <= 0) return 0;
  const int tiles = (N + kDBN - 1) / kDBN;
  int s = (kDBlocksPerSM * sm_count + tiles - 1) / tiles;
  s = std::max(1, std::min(s, (K + kDBK - 1) / kDBK));
  for (;;) {
    const int s2 = (K + split_len(K, s) - 1) / split_len(K, s);
    if (s2 == s) return s;
    s = s2;
  }
}

int fused_dora_f32(const void* x, const void* w0, const void* a_eff, const float* a_mag,
                   const void* b_dir, const float* b_eff_mag, void* y, float* part, int M,
                   int K, int N, int r, float scale, int splits, void* stream) {
  return launch<float>(x, w0, a_eff, a_mag, b_dir, b_eff_mag, y, part, M, K, N, r, scale,
                       splits, stream);
}

int fused_dora_bf16(const void* x, const void* w0, const void* a_eff, const float* a_mag,
                    const void* b_dir, const float* b_eff_mag, void* y, float* part, int M,
                    int K, int N, int r, float scale, int splits, void* stream) {
  return launch<__nv_bfloat16>(x, w0, a_eff, a_mag, b_dir, b_eff_mag, y, part, M, K, N, r,
                               scale, splits, stream);
}

}  // extern "C"

// Hand-written Hopper (sm_90a) dequant-fused weight-only quantized matmul.
//
// Replaces the Pallas TPU kernel quant_matmul_kernel (body _qmm_kernel) of
// src/repro/kernels/quant_matmul/quant_matmul.py.  It computes what the
// Pallas body computes:
//
//   y[m, n] = sum_k f32(x[m, k]) * (f32(code[k, n]) * scale[k / (K / G), n])
//
// where the Pallas body dequantizes the weight in f32 inside its tile, sums
// the products in f32 and stores y in x's type.  Codes are int8 (K, N), or
// int4 packed two per byte along K (K/2, N): row 2j in the low nibble, row
// 2j+1 in the high one, each stored +8.  No f32 or bf16 copy of the weight
// ever exists in device memory: each code is widened in registers.
//
// In bf16 the codes go to the tensor cores as they are.  They are integers
// in [-127, 127] (int8) or [-7, 7] (int4), exact in bf16, and a bf16 x times
// such a code is exact in f32.  So mma.sync with x and the raw codes as bf16
// operands forms the exact products x * code and sums them in f32; the f32
// scale then multiplies each group's f32 partial sum (or, per channel, the
// output).  No weight is rounded to bf16: against the Pallas body only the
// order of the f32 sums and where the scale multiplies change.  An f32 x is
// not exact in bf16, so f32 stays on the CUDA cores.
//
// Six kernels; launch() below is the one place that picks one, by dtype, M
// and group size (quant_matmul_variant reports its choice):
//
//   qmm_skinny      f32 (and bf16 with a group size that is not a multiple
//                   of 16), M <= 16.  CUDA cores.  A block owns 8 rows and
//                   128 columns, 4 per lane, so one 32-bit load brings 4 int8
//                   codes or 4 columns of two int4 rows.  K is split across
//                   blocks to occupy the card; each writes an f32 partial and
//                   qmm_reduce sums them in a fixed order and casts.  Inside a
//                   block K is walked in chunks of 256 rows staged in shared
//                   memory as f32, each warp taking 32 consecutive rows; the
//                   warps' partial sums are added in shared memory.
//   qmm_tiled       f32 (and bf16 with such a group size), M > 16.  CUDA
//                   cores: 64 x 64 output tiles, 256 threads of 4 x 4
//                   outputs, K in tiles of 32: the x tile staged as f32, the
//                   code tile dequantized into shared memory as f32.
//   qmm_mma         bf16, M > 16.  Tensor cores: mma.sync m16n8k16, bf16
//                   operands, f32 sums.  A block of 8 warps owns a 128 x 128
//                   output tile (a warp 64 rows x 32 columns); K comes in
//                   steps of 64 through a 4-stage cp.async ring of an
//                   XOR-swizzled x tile (the A operand, ldmatrix) and a code
//                   tile, a quarter (int8) or an eighth (int4) of a bf16
//                   weight tile's bytes.  Each lane reads its codes with
//                   32-bit shared loads and widens them to bf16 in registers
//                   (int8_pairs, int4_pairs): mma's 8 columns of B are
//                   strided 4 apart in the warp's 32, so one 32-bit load
//                   gives a code row for all 4 n-tiles and each lane ends up
//                   owning 8 adjacent output columns.  Per channel, the scale
//                   multiplies in the epilogue; in groups (a multiple of 16
//                   rows), a second accumulator takes the group's products
//                   and, at the group's last k step of 16, is added into the
//                   main one times the group's scale with one f32 FMA.
//   qmm_mma_decode  bf16, M <= 16.  Bound by the bytes of the codes.  y^T =
//                   W^T . x^T: the code tile is the A operand (a warp 16
//                   columns) and the <= 16 rows of x are mma's n.  K is split
//                   over blocks, grid (128-column tiles, splits), about 4
//                   blocks a SM, each split a whole number of stages of 64
//                   code rows (64 k rows int8, 128 int4) through a 4-stage
//                   cp.async ring.  Group scales apply per group as above,
//                   and at the split's end to its share of a group; with more
//                   than one split each block writes f32 partials to a
//                   workspace the wrapper allocates and qmm_reduce adds them
//                   in a fixed order (deterministic, no atomics).
//
// What bounds it.  At decode (M = 8) bytes: 16.8 MB of int8 codes for a
// 4096 x 4096 matrix (8.4 MB int4) over 3.35 TB/s, 5.0 us (2.5 us).  At
// prefill (M = 512) operations: 17.2 GFLOP, about 17 us at the bf16
// tensor-core rate, which mma.sync reaches a fraction of; the f32 kernels
// are bound by the 67 TFLOP/s of the CUDA cores.
//
// Ragged M, N and K are masked in the kernels; nothing is padded in memory.
// Rows that are not a whole number of 16-byte chunks, or at pointers that are
// not 16-byte aligned, are loaded with guarded plain loads that fill zeros
// instead of cp.async.

#include <algorithm>

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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (qmm_mma and qmm_mma_decode)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// smem_addr, cp_async16, cp_async_commit, cp_async_wait, ldmatrix_x4,
// mma_bf16, pack_bf16, swz, load_chunk and load_bf16_tile are copied from
// src/repro_torch/kernels/fused_dora/csrc/fused_dora.cu (each source builds
// alone).

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

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ uint32_t lds16(uint32_t addr) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(addr));
  return v;
}

// byte offset of 16-byte chunk c of row r in a bf16 tile of CH chunks a row,
// the chunk index XORed with a function of the row so the 8 rows one
// ldmatrix phase reads fall in 8 different 16-byte bank groups
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

// which operands may go by cp.async (see load_chunk)
struct Vec {
  bool x, q;
};

// COLS columns (a multiple of 8) of ROWS rows into the swizzled tile at
// tile: row i is row row0 + i of a (rows, ld) bf16 matrix at src, columns
// col0 .. col0 + COLS - 1; rows past `rows` and columns past ld are zero.
// A tile wholly inside the matrix with vec rows takes one cp.async a chunk
// and nothing else.
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

// The code tile: rows of 128 bytes (8 chunks: 128 columns of int8 codes, or
// of int4 row pairs).  The chunk index is XORed with 2 * ((r / 2) mod 4)
// (int8) or 2 * (r mod 4) (int4): the 4 code rows one shared load reads (the
// lanes' k pairs 2t, or packed rows t) then fall in 4 different pairs of
// chunks, so the 32 lanes' loads hit 32 different banks.
template <bool INT4>
__device__ __forceinline__ uint32_t code_swz(int r, int c) {
  const int s = INT4 ? (r & 3) : ((r >> 1) & 3);
  return static_cast<uint32_t>(r * 128 + ((c ^ (s << 1)) << 4));
}

// ROWS code rows row0 .. row0 + ROWS - 1 of a (rows, N) byte matrix at q,
// columns col0 .. col0 + 127, into the swizzled tile (zero past rows and N)
template <bool INT4, int ROWS, int NT>
__device__ __forceinline__ void load_code_tile(unsigned char* tile, const uint8_t* q, int row0,
                                               int rows, int col0, int N, bool vec) {
  constexpr int CHUNKS = ROWS * 8;
  if (vec && row0 + ROWS <= rows && col0 + 128 <= N) {
    const uint8_t* base = q + static_cast<size_t>(row0) * N + col0;
#pragma unroll
    for (int u = 0; u < (CHUNKS + NT - 1) / NT; ++u) {
      const int e = threadIdx.x + u * NT;
      if (CHUNKS % NT == 0 || e < CHUNKS)
        cp_async16(smem_addr(tile + code_swz<INT4>(e / 8, e % 8)),
                   base + static_cast<size_t>(e / 8) * N + 16 * (e % 8));
    }
    return;
  }
  for (int e = threadIdx.x; e < CHUNKS; e += NT) {
    const int i = e / 8, c = e % 8;
    const int row = row0 + i, col = col0 + 16 * c;
    const uint8_t* p = row < rows && col < N ? q + static_cast<size_t>(row) * N + col : nullptr;
    load_chunk(tile + code_swz<INT4>(i, c), p, N - col, vec);
  }
}

// Widening codes to bf16 operands, exactly.  out[j] is a bf16x2 register
// (low half: the smaller k) for byte j of the 32-bit words.
//
// int8: out[j] = (byte j of a, byte j of b).  The byte with its sign bit
// flipped, u = code + 128 in [1, 255], goes into the low byte of the f32 bit
// pattern 0x4B000000, which is then exactly 2^23 + u; one f32 add of
// -(2^23 + 128) leaves the code exactly.  An integer of magnitude at most 128
// has at most 8 significant bits, so its f32's low 16 bits are zero and its
// high half is its bf16 value; one byte permute packs the two high halves.
__device__ __forceinline__ void int8_pairs(uint32_t (&out)[4], uint32_t a, uint32_t b) {
  a ^= 0x80808080u;
  b ^= 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float fa = __uint_as_float(__byte_perm(a, 0x4B000000u, 0x7440 + j)) - 8388736.f;
    const float fb = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7440 + j)) - 8388736.f;
    out[j] = __byte_perm(__float_as_uint(fa), __float_as_uint(fb), 0x7632);
  }
}

// int4: out[j] = (low nibble - 8, high nibble - 8) of byte j of w, the k
// pair (2i, 2i + 1) the packing keeps in one byte.  A nibble v under the bf16
// bit pattern 0x4300 is exactly 128 + v; one bf16x2 fma of that times 1 minus
// 136 gives v - 8, a small integer, exactly.
__device__ __forceinline__ uint32_t minus136(uint32_t v) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(v), "r"(0x3F803F80u), "r"(0xC308C308u));
  return d;
}

__device__ __forceinline__ void int4_pairs(uint32_t (&out)[4], uint32_t w) {
  const uint32_t lo = w & 0x0F0F0F0Fu, hi = (w >> 4) & 0x0F0F0F0Fu;
  const uint32_t p01 = __byte_perm(lo, hi, 0x5140);   // lo0 hi0 lo1 hi1
  const uint32_t p23 = __byte_perm(lo, hi, 0x7362);   // lo2 hi2 lo3 hi3
  out[0] = minus136(__byte_perm(p01, 0x43434343u, 0x4140));
  out[1] = minus136(__byte_perm(p01, 0x43434343u, 0x4342));
  out[2] = minus136(__byte_perm(p23, 0x43434343u, 0x4140));
  out[3] = minus136(__byte_perm(p23, 0x43434343u, 0x4342));
}

// ---------------------------------------------------------------------------
// qmm_mma: bf16, M > 16
// ---------------------------------------------------------------------------

constexpr int kQBM = 128, kQBN = 128, kQBK = 64, kQStages = 4;
constexpr int kQWarpsN = 4;                       // warp columns of 32; 2 warp rows of 64

template <bool INT4>
struct MmaSmem {
  static constexpr int QR = INT4 ? kQBK / 2 : kQBK;  // code rows a stage
  static constexpr int X = kQBM * kQBK * 2;          // x tile, 8 chunks a row
  static constexpr int Q = QR * kQBN;                // code tile, 8 chunks a row
  static constexpr int STAGE = X + Q;
  static constexpr int BYTES = kQStages * STAGE;
};

// a warp's x fragments at k step ks: rows 64 wm .. 64 wm + 63 as four A
// fragments
__device__ __forceinline__ void x_fragments(uint32_t (&a)[4][4], uint32_t xa, int ks, int wm,
                                            int lane) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    ldmatrix_x4(a[i], xa + swz<kQBK / 8>(64 * wm + 16 * i + (lane & 15), 2 * ks + (lane >> 4)));
}

// a lane's code words at k step ks: columns 32 wn + 4g .. 32 wn + 4g + 3 of
// code rows 16 ks + 2t, + 1, + 8, + 9 (int8), or of packed rows 8 ks + t and
// + 4 (int4: k rows 16 ks + 2t, + 1 and 16 ks + 2t + 8, + 9)
template <bool INT4>
__device__ __forceinline__ void code_words(uint32_t (&w)[4], uint32_t qa, int ks, int wn, int g,
                                           int t) {
  const int c = 2 * wn + (g >> 2), b = 4 * (g & 3);
  if (INT4) {
    w[0] = lds32(qa + code_swz<true>(8 * ks + t, c) + b);
    w[1] = lds32(qa + code_swz<true>(8 * ks + t + 4, c) + b);
  } else {
    const int r = 16 * ks + 2 * t;
    w[0] = lds32(qa + code_swz<false>(r, c) + b);
    w[1] = lds32(qa + code_swz<false>(r + 1, c) + b);
    w[2] = lds32(qa + code_swz<false>(r + 8, c) + b);
    w[3] = lds32(qa + code_swz<false>(r + 9, c) + b);
  }
}

// the B fragments of the warp's 4 n-tiles from its code words: n-tile j's
// column g is code column 32 wn + 4g + j
template <bool INT4>
__device__ __forceinline__ void code_fragments(uint32_t (&b0)[4], uint32_t (&b1)[4],
                                               const uint32_t (&w)[4]) {
  if (INT4) {
    int4_pairs(b0, w[0]);
    int4_pairs(b1, w[1]);
  } else {
    int8_pairs(b0, w[0], w[1]);
    int8_pairs(b1, w[2], w[3]);
  }
}

// scale[grp, c0 .. c0 + 7], zero past N and past the last group
__device__ __forceinline__ void load_scales(float (&s)[8], const float* __restrict__ scale,
                                            int grp, int G, int c0, int N) {
#pragma unroll
  for (int c = 0; c < 8; ++c)
    s[c] = (grp < G && c0 + c < N) ? __ldg(scale + static_cast<size_t>(grp) * N + c0 + c) : 0.f;
}

// Accumulator acc[i][j][e] of a lane (g, t) of warp (wm, wn) holds row
// 64 wm + 16 i + g + 8 (e / 2) and column 32 wn + 8t + 4 (e % 2) + j of the
// block's tile: a lane owns 8 adjacent columns, 32 wn + 8t .. + 7, whose
// scale is s[4 (e % 2) + j].
template <bool INT4, bool GROUPED>
__global__ void __launch_bounds__(kThreads)
qmm_mma(const bf16* __restrict__ x, const uint8_t* __restrict__ q,
        const float* __restrict__ scale, bf16* __restrict__ y, int M, int K, int N, int G,
        Vec vec) {
  using S = MmaSmem<INT4>;
  constexpr int KS = kQBK / 16;                   // k steps a stage
  extern __shared__ __align__(128) unsigned char qm_smem[];
  auto xs = [&](int st) { return qm_smem + st * S::STAGE; };
  auto qs = [&](int st) { return qm_smem + st * S::STAGE + S::X; };

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / kQWarpsN, wn = warp % kQWarpsN;
  const int m0 = blockIdx.y * kQBM, n0 = blockIdx.x * kQBN;
  const int c0 = n0 + 32 * wn + 8 * t;            // this lane's first column
  const int nk = (K + kQBK - 1) / kQBK;
  const int qrows = INT4 ? K / 2 : K;

  auto load_stage = [&](int kt, int st) {
    const int k0 = kt * kQBK;
    load_bf16_tile<kQBM, kQBK, kThreads>(xs(st), x, m0, M, k0, K, vec.x);
    load_code_tile<INT4, S::QR, kThreads>(qs(st), q, INT4 ? k0 / 2 : k0, qrows, n0, N, vec.q);
  };

  // accg: the products of the current group (all of K per channel); acc:
  // the scaled groups so far (GROUPED only)
  float accg[4][4][4], acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) accg[i][j][e] = acc[i][j][e] = 0.f;
  float s[8];
  const int gsteps = K / G / 16;                  // k steps a group (GROUPED)
  int grp = 0, left = gsteps;
  if (GROUPED) load_scales(s, scale, 0, G, c0, N);

#pragma unroll
  for (int st = 0; st < kQStages - 1; ++st) {
    if (st < nk) load_stage(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kQStages - 2>();
    __syncthreads();   // tile kt is in; every warp is done with tile kt - 1's stage
    const int st = kt % kQStages;
    const uint32_t xa = smem_addr(xs(st)), qa = smem_addr(qs(st));
    // fragments of k step ks + 1 load while k step ks multiplies
    uint32_t af[2][4][4], qw[2][4];
    x_fragments(af[0], xa, 0, wm, lane);
    code_words<INT4>(qw[0], qa, 0, wn, g, t);
    if (kt + kQStages - 1 < nk) load_stage(kt + kQStages - 1, (kt + kQStages - 1) % kQStages);
    cp_async_commit();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int cur = ks & 1;
      if (ks + 1 < KS) {
        x_fragments(af[cur ^ 1], xa, ks + 1, wm, lane);
        code_words<INT4>(qw[cur ^ 1], qa, ks + 1, wn, g, t);
      }
      uint32_t b0[4], b1[4];
      code_fragments<INT4>(b0, b1, qw[cur]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) mma_bf16(accg[i][j], af[cur][i], b0[j], b1[j]);
      if (GROUPED && --left == 0) {
        // the group's last k step: acc += scale * accg, then a new group
        // (k steps past K add zeros, and past group G - 1 the scales are 0)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[i][j][e] = fmaf(s[4 * (e & 1) + j], accg[i][j][e], acc[i][j][e]);
              accg[i][j][e] = 0.f;
            }
        left = gsteps;
        load_scales(s, scale, ++grp, G, c0, N);
      }
    }
  }
  cp_async_wait<0>();

  if (!GROUPED) load_scales(s, scale, 0, G, c0, N);
  const bool wide = (N % 8) == 0 && (reinterpret_cast<uintptr_t>(y) & 15) == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + 64 * wm + 16 * i + g + 8 * h;
      if (row >= M) continue;
      float v[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int j = c & 3, e = 2 * h + (c >> 2);
        v[c] = GROUPED ? acc[i][j][e] : s[c] * accg[i][j][e];
      }
      bf16* yr = y + static_cast<size_t>(row) * N;
      if (wide && c0 + 8 <= N) {
        *reinterpret_cast<uint4*>(yr + c0) =
            make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                       pack_bf16(v[6], v[7]));
      } else {
#pragma unroll
        for (int c = 0; c < 8; ++c)
          if (c0 + c < N) yr[c0 + c] = __float2bfloat16(v[c]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// qmm_mma_decode: bf16, M <= 16
// ---------------------------------------------------------------------------

constexpr int kQDBN = 128, kQDStages = 4, kQDRows = 16, kQDCodeRows = 64;
constexpr int kDecodeMaxM = 16;
constexpr int kQDBlocksPerSM = 4;

template <bool INT4>
struct DecodeSmem {
  static constexpr int KB = INT4 ? 2 * kQDCodeRows : kQDCodeRows;   // k rows a stage
  static constexpr int Q = kQDCodeRows * kQDBN;   // code tile, 8 chunks a row
  static constexpr int X = kQDRows * KB * 2;      // x tile, KB / 8 chunks a row
  static constexpr int STAGE = Q + X;
  static constexpr int BYTES = kQDStages * STAGE;
};

// rows of K a split takes for `splits` splits: a whole number of stages of
// kb rows
__host__ __device__ inline int split_len(int K, int splits, int kb) {
  const int per = (K + splits - 1) / splits;
  return (per + kb - 1) / kb * kb;
}

// grid (column tiles of 128, splits).  Lane (g, t) of warp w owns code
// columns n0 + 16w + 2g (A row g) and + 1 (A row g + 8).  part: (splits, M, N)
// f32 partials when splits > 1; else y is written.
template <bool INT4>
__global__ void __launch_bounds__(kThreads)
qmm_mma_decode(const bf16* __restrict__ x, const uint8_t* __restrict__ q,
               const float* __restrict__ scale, float* __restrict__ part, bf16* __restrict__ y,
               int M, int K, int N, int G, int klen, Vec vec) {
  using S = DecodeSmem<INT4>;
  constexpr int KB = S::KB, CH = KB / 8, KS = KB / 16;
  extern __shared__ __align__(128) unsigned char qd_smem[];
  auto qs = [&](int st) { return qd_smem + st * S::STAGE; };
  auto xs = [&](int st) { return qd_smem + st * S::STAGE + S::Q; };

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kQDBN, split = blockIdx.y;
  const int k_begin = split * klen, k_end = min(K, k_begin + klen);
  const int nk = (k_end - k_begin + KB - 1) / KB;
  const int gsz = K / G;
  const int col = n0 + 16 * warp + 2 * g;
  const bool two = M > 8;

  // rows past k_end are zero in both x and the codes
  auto load_stage = [&](int kt, int st) {
    const int k0 = k_begin + kt * KB;
    load_code_tile<INT4, kQDCodeRows, kThreads>(qs(st), q, INT4 ? k0 / 2 : k0,
                                                INT4 ? k_end / 2 : k_end, n0, N, vec.q);
    for (int e = threadIdx.x; e < kQDRows * CH; e += kThreads) {
      const int i = e / CH, c = e % CH;
      const int k = k0 + 8 * c;
      const uint16_t* p = i < M && k < k_end
          ? reinterpret_cast<const uint16_t*>(x) + static_cast<size_t>(i) * K + k : nullptr;
      load_chunk(xs(st) + swz<CH>(i, c), p, k_end - k, vec.x);
    }
  };

  float d[2][4], dg[2][4];
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[n][e] = dg[n][e] = 0.f;
  int grp = k_begin / gsz, rem = gsz - k_begin % gsz;
  auto col_scale = [&](int c) {
    return c < N ? __ldg(scale + static_cast<size_t>(grp) * N + c) : 0.f;
  };
  float s0 = col_scale(col), s1 = col_scale(col + 1);
  // d += scale * dg (A rows g: column col, g + 8: col + 1), dg = 0
  auto flush = [&]() {
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        d[n][e] = fmaf(e < 2 ? s0 : s1, dg[n][e], d[n][e]);
        dg[n][e] = 0.f;
      }
  };

#pragma unroll
  for (int st = 0; st < kQDStages - 1; ++st) {
    if (st < nk) load_stage(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kQDStages - 2>();
    __syncthreads();
    if (kt + kQDStages - 1 < nk) load_stage(kt + kQDStages - 1, (kt + kQDStages - 1) % kQDStages);
    cp_async_commit();
    const int st = kt % kQDStages;
    const uint32_t qa = smem_addr(qs(st)), xa = smem_addr(xs(st));
    const int k0 = k_begin + kt * KB;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      if (k0 + 16 * ks >= k_end) break;
      // A = W^T: rows g, g + 8 are code columns col, col + 1; k pairs 2t, 8 + 2t
      uint32_t a[4], xf[4];
      if (INT4) {
        const int p = 8 * ks + t;
        const uint32_t w = lds16(qa + code_swz<true>(p, warp) + 2 * g) |
                           (lds16(qa + code_swz<true>(p + 4, warp) + 2 * g) << 16);
        int4_pairs(a, w);
      } else {
        const int r = 16 * ks + 2 * t;
        const uint32_t lo = lds16(qa + code_swz<false>(r, warp) + 2 * g) |
                            (lds16(qa + code_swz<false>(r + 8, warp) + 2 * g) << 16);
        const uint32_t hi = lds16(qa + code_swz<false>(r + 1, warp) + 2 * g) |
                            (lds16(qa + code_swz<false>(r + 9, warp) + 2 * g) << 16);
        int8_pairs(a, lo, hi);
      }
      ldmatrix_x4(xf, xa + swz<CH>((lane & 7) + ((lane >> 4) << 3), 2 * ks + ((lane >> 3) & 1)));
      mma_bf16(dg[0], a, xf[0], xf[1]);
      if (two) mma_bf16(dg[1], a, xf[2], xf[3]);
      rem -= 16;
      if (rem == 0) {   // the group's last k step
        flush();
        ++grp;
        rem = gsz;
        s0 = grp < G ? col_scale(col) : 0.f;
        s1 = grp < G ? col_scale(col + 1) : 0.f;
      }
    }
  }
  cp_async_wait<0>();
  flush();   // the split's share of its last group

  // d[n]: rows (code columns) col + e / 2, columns (x rows) 8n + 2t + e % 2
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = 8 * n + 2 * t + (e & 1), c = col + (e >> 1);
      if (m >= M || c >= N) continue;
      const size_t o = static_cast<size_t>(m) * N + c;
      if (part) part[static_cast<size_t>(split) * M * N + o] = d[n][e];
      else y[o] = __float2bfloat16(d[n][e]);
    }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

enum Variant { kVSkinny = 0, kVTiled = 1, kVMma = 2, kVMmaDecode = 3 };

// The kernel an (M, K) x (K, N) call with G scale groups takes: bf16 on the
// tensor cores when a group is a whole number of k steps of 16 (or the scales
// are per channel), else the CUDA-core kernels.
int variant(int M, int K, int G, bool is_bf16) {
  const bool mma = is_bf16 && (G == 1 || (K / G) % 16 == 0);
  if (M > kDecodeMaxM) return mma ? kVMma : kVTiled;
  return mma ? kVMmaDecode : kVSkinny;
}

// the decode variant's splits: about kQDBlocksPerSM blocks a SM, each split a
// whole number of stages, none empty
int decode_splits(int K, int N, bool int4, int sm_count) {
  const int kb = int4 ? 2 * kQDCodeRows : kQDCodeRows;
  const int tiles = (N + kQDBN - 1) / kQDBN;
  int s = (kQDBlocksPerSM * sm_count + tiles - 1) / tiles;
  s = std::max(1, std::min(s, (K + kb - 1) / kb));
  for (;;) {
    const int s2 = (K + split_len(K, s, kb) - 1) / split_len(K, s, kb);
    if (s2 == s) return s;
    s = s2;
  }
}

// the skinny path's splits: enough blocks for two a SM, at least 256 rows of
// K each
int skinny_splits(int M, int K, int N, int sm_count) {
  const int blocks = ((N + kSkinnyBN - 1) / kSkinnyBN) * ((M + kSkinnyRows - 1) / kSkinnyRows);
  int s = (2 * sm_count + blocks - 1) / blocks;
  const int most = (K + kChunk - 1) / kChunk;
  s = s < most ? s : most;
  return s < 1 ? 1 : s;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename Kern>
cudaError_t allow_smem(Kern kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <bool INT4, bool GROUPED>
int launch_mma(const bf16* x, const uint8_t* q, const float* scale, bf16* y, int M, int K, int N,
               int G, Vec vec, cudaStream_t st) {
  constexpr int bytes = MmaSmem<INT4>::BYTES;
  cudaError_t err = allow_smem(qmm_mma<INT4, GROUPED>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kQBN - 1) / kQBN, (M + kQBM - 1) / kQBM);
  qmm_mma<INT4, GROUPED><<<grid, kThreads, bytes, st>>>(x, q, scale, y, M, K, N, G, vec);
  return static_cast<int>(cudaGetLastError());
}

template <bool INT4>
int launch_decode(const bf16* x, const uint8_t* q, const float* scale, float* part, bf16* y,
                  int M, int K, int N, int G, int splits, Vec vec, cudaStream_t st) {
  constexpr int bytes = DecodeSmem<INT4>::BYTES;
  const int len = split_len(K, splits, DecodeSmem<INT4>::KB);
  if ((K + len - 1) / len != splits || (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(qmm_mma_decode<INT4>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kQDBN - 1) / kQDBN, splits);
  float* p = splits > 1 ? part : nullptr;
  qmm_mma_decode<INT4><<<grid, kThreads, bytes, st>>>(x, q, scale, p, y, M, K, N, G, len, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long MN = static_cast<long long>(M) * N;
  const long long want = (MN + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  qmm_reduce<bf16><<<blocks, kThreads, 0, st>>>(part, y, MN, splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool INT4>
int launch(const void* x, const void* q, const float* scale, float* part, void* y,
           int M, int K, int N, int G, int splits, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || G <= 0 || K % G || (INT4 && K % 2) || splits < 1 ||
      splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* qt = static_cast<const uint8_t*>(q);
  const int v = variant(M, K, G, sizeof(T) == 2);
  if constexpr (sizeof(T) == 2) {
    const bf16* xt = static_cast<const bf16*>(x);
    bf16* yt = static_cast<bf16*>(y);
    const Vec vec{K % 8 == 0 && aligned16(x), N % 16 == 0 && aligned16(q)};
    if (v == kVMma) {
      if ((M + kQBM - 1) / kQBM > 65535) return static_cast<int>(cudaErrorInvalidValue);
      return G == 1 ? launch_mma<INT4, false>(xt, qt, scale, yt, M, K, N, G, vec, st)
                    : launch_mma<INT4, true>(xt, qt, scale, yt, M, K, N, G, vec, st);
    }
    if (v == kVMmaDecode)
      return launch_decode<INT4>(xt, qt, scale, part, yt, M, K, N, G, splits, vec, st);
  }
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (v == kVTiled) {
    const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
    qmm_tiled<T, INT4><<<grid, kThreads, 0, st>>>(xt, qt, scale, yt, M, K, N, G);
    return static_cast<int>(cudaGetLastError());
  }
  if (splits > 1 && part == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  // split length: a whole number of int4 row pairs
  int len = (K + splits - 1) / splits;
  len += len & 1;
  const dim3 grid((N + kSkinnyBN - 1) / kSkinnyBN, splits, (M + kSkinnyRows - 1) / kSkinnyRows);
  const bool vec = (N % kCols == 0) && (reinterpret_cast<uintptr_t>(q) % 4 == 0);
  float* p = splits > 1 ? part : nullptr;
  if (vec)
    qmm_skinny<T, INT4, true><<<grid, kThreads, 0, st>>>(xt, qt, scale, p, yt, M, K, N, G, len);
  else
    qmm_skinny<T, INT4, false><<<grid, kThreads, 0, st>>>(xt, qt, scale, p, yt, M, K, N, G, len);
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

// The kernel an (M, K) x (K, N) call with G scale groups takes, as launch()
// picks it: 0 qmm_skinny, 1 qmm_tiled, 2 qmm_mma, 3 qmm_mma_decode.
int quant_matmul_variant(int M, int K, int G, int is_bf16) {
  return variant(M, K, G, is_bf16 != 0);
}

// K splits of that call on a card with `sm_count` SMs: 1 on qmm_tiled and
// qmm_mma; the caller allocates `part` as (splits, M, N) f32 when this is
// above 1 (qmm_skinny and qmm_mma_decode).
int quant_matmul_splits(int M, int K, int N, int G, int is_bf16, int is_int4, int sm_count) {
  if (M <= 0 || K <= 0 || N <= 0 || G <= 0) return 1;
  switch (variant(M, K, G, is_bf16 != 0)) {
    case kVSkinny: return skinny_splits(M, K, N, sm_count);
    case kVMmaDecode: return decode_splits(K, N, is_int4 != 0, sm_count);
    default: return 1;
  }
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

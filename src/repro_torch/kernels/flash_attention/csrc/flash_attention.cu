// Hand-written Hopper (sm_90a) flash attention: online softmax, GQA, causal
// offset, sliding window and a valid-key limit.
//
// Replaces the Pallas TPU kernel flash_attention_bhsd (body _kernel) of
// src/repro/kernels/flash_attention/flash_attention.py.  It computes what the
// Pallas body computes, with its cast points, for query head h (of BH) and
// kv head h / rep:
//
//   s = (q . k^T) * scale                       f32 accumulation, then scaled
//   s = -1e30 where not (kj < sk_valid, and kj <= qi if causal, and
//                        kj > qi - window if windowed), qi = row + q_offset
//   m' = max(m, rowmax s);  p = exp(s - m');  alpha = exp(m - m')
//   l = l * alpha + rowsum p                    p in f32
//   acc = acc * alpha + T(p) . v                p rounded to v's type T, f32 sums
//   out = T(acc / max(l, 1e-30))
//
// The mask value is -1e30, not -inf, as in the Pallas body: a key block with
// no valid key for a row gives that row p = exp(0) = 1 while its running max
// is still -1e30, and the first valid key wipes that out (alpha = exp(-1e30 -
// m) = 0); a row with no valid key at all ends as the plain average of v over
// all Sk keys, which is also what the reference's softmax gives it (with -inf
// it would be NaN).  That makes skipping a key block exact for every row that
// has a valid key somewhere, so a query tile walks only the key range its
// rows can see (causal: up to its last row; window: from its first row's
// window start; sk_valid), unless one of its rows has no valid key at all:
// then it walks all Sk keys, as the Pallas grid does.  Keys past Sk (the
// ragged last block, which the Pallas grid never has) are -inf and give 0.
//
// Three variants; launch() below is the one place that picks one, by dtype
// and Sq:
//
//   simt         f32 inputs.  CUDA cores in f32: one block owns 64 query
//                   rows of one head and loops over key blocks of 64 (32 at
//                   dh 256) staged in shared memory as f32; 4 x 4 register
//                   tiles per thread.  The Pallas f32 dot is a full f32
//                   product, and TF32 would keep about three decimal digits,
//                   so f32 stays off the tensor cores.
//   mma          bf16, Sq > 16.  Tensor cores: mma.sync m16n8k16 with
//                   bf16 operands and f32 sums.  A block of 8 warps owns 128
//                   query rows (16 a warp) of one head; K and V tiles of 64
//                   keys (32 at dh 256) are copied to shared memory as bf16
//                   by cp.async, double-buffered (tile j + 1 loads while tile
//                   j is used), rows XOR-swizzled in 16-byte chunks so that
//                   ldmatrix meets no bank conflict.  q . k^T takes q's
//                   fragment from registers (dh <= 128; at dh 256 the 128 f32
//                   accumulator registers leave no room, and q is re-read
//                   from shared memory with ldmatrix), k^T with ldmatrix and
//                   v with ldmatrix.trans.  The score fragment, rounded to
//                   bf16, is the A fragment of the PV product in registers.
//                   A row's max and sum are spread over a quad of threads:
//                   two __shfl_xor_sync steps.  exp is taken as exp2 of the
//                   score times scale * log2(e) (one MUFU.EX2).  Only key
//                   blocks that straddle a mask boundary are masked.  Grid
//                   (BH, query tiles of 128 rows, longest first): the
//                   rep query heads of one kv head run side by side, so
//                   their K/V tiles come from L2.
//   mma_decode   bf16, Sq <= 16.  One block of 4 warps takes 16 rows that
//                   pack the rep query heads of one kv head times Sq; the
//                   keys are split over the warps (16 each a stage of 64),
//                   each warp with its own m, l and acc on the same mma path,
//                   merged through shared memory at the end (weights
//                   exp(m_w - M), as alpha rescales a running sum).  When
//                   those blocks (BK x ceil(rep * Sq / 16)) leave SMs idle,
//                   a cluster of up to 8 blocks splits each one's keys in
//                   runs of whole stages and merges the same way through
//                   distributed shared memory.
//
// Every variant keeps the Pallas body's cast points: s and p in f32, p
// rounded to bf16 once for PV, f32 sums, the output rounded once.  Columns
// past dh are zero-filled in shared memory (buckets 64, 128, 256); rows of
// a width that is not a multiple of 16 bytes (dh % 8 != 0) or at a pointer
// that is not 16-byte aligned are loaded with plain loads instead of cp.async.
//
// What bounds it.  At llama2-7b prefill (32 heads, dh 128, S 4096, causal,
// bf16): 137 GFLOP over the valid (row, key) pairs, 0.139 ms at the bf16
// tensor-core rate, against 0.040 ms of bytes, so mma is bound by
// operations; mma.sync reaches about two thirds of the rate wgmma reaches,
// and the exps and row sums (5 operations a pair on the CUDA cores) sit in
// its loop.  Decode (8 x 1 x 128 keys) is bound by bytes (16.8 MB of K and V,
// 0.005 ms): mma_decode reads each kv head's keys once for all its query
// heads, with one stage of cp.async in flight behind the one in use; one
// block streams a few tens of GB/s, so a long cache over few kv heads
// (qwen3-32b's 8, gemma3-1b's 1) needs the cluster split to reach the
// SMs.  f32 (simt) is bound by the 67 TFLOP/s of the CUDA cores and, with
// one shared-memory load per two FMAs, by shared memory at about half of
// that.
//
// Shapes: any Sq, Sk; dh <= 256; BH a multiple of BK.

#include <algorithm>

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 64;       // query rows a block
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }

template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

template <int DH, int BK>
constexpr int smem_floats() {
  return kBQ * (DH + 1)       // q tile
         + BK * (DH + 1)      // k tile
         + BK * DH            // v tile
         + kBQ * (BK + 1)     // scores, then T(p)
         + 3 * kBQ;           // running max, denominator, alpha
}

struct Params {
  int Sq, Sk, dh, rep;
  float scale;
  int causal, has_window, window, sk_valid, q_offset;
  int vec;   // dh % 8 == 0 and 16-byte-aligned pointers: cp.async rows (bf16 variants)
};

// rows r0 .. r0 + nrows - 1 of a (rows, dh) matrix into dst[nrows][stride] as
// f32, zero past `rows` and past dh
template <typename T, int DH>
__device__ __forceinline__ void load_tile(float* dst, int stride, const T* src, int r0,
                                          int nrows, int rows, int dh) {
  for (int e = threadIdx.x; e < nrows * DH; e += kThreads) {
    const int r = e / DH, d = e % DH;
    dst[r * stride + d] =
        (r0 + r < rows && d < dh) ? to_f(src[static_cast<size_t>(r0 + r) * dh + d]) : 0.f;
  }
}

template <typename T, int DH, int BK>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q,   // (BH, Sq, dh)
                       const T* __restrict__ k,   // (BK, Sk, dh)
                       const T* __restrict__ v,   // (BK, Sk, dh)
                       T* __restrict__ o,         // (BH, Sq, dh)
                       Params pr) {
  constexpr int DH1 = DH + 1, BK1 = BK + 1;
  constexpr int NC = BK / 16;    // score columns a thread
  constexpr int ND = DH / 16;    // output columns a thread
  extern __shared__ float smem[];
  float* qs = smem;                  // [kBQ][DH1]
  float* ks = qs + kBQ * DH1;        // [BK][DH1]
  float* vs = ks + BK * DH1;         // [BK][DH]
  float* ps = vs + BK * DH;          // [kBQ][BK1]
  float* m_s = ps + kBQ * BK1;       // [kBQ]
  float* l_s = m_s + kBQ;            // [kBQ]
  float* a_s = l_s + kBQ;            // [kBQ]

  const int Sq = pr.Sq, Sk = pr.Sk, dh = pr.dh;
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int ti = t / 16, tj = t % 16;
  const T* qh = q + static_cast<size_t>(bh) * Sq * dh;
  const T* kh = k + static_cast<size_t>(bh / pr.rep) * Sk * dh;
  const T* vh = v + static_cast<size_t>(bh / pr.rep) * Sk * dh;

  load_tile<T, DH>(qs, DH1, qh, q0, kBQ, Sq, dh);
  if (t < kBQ) {
    m_s[t] = kNegInf;
    l_s[t] = 0.f;
  }

  // the key range the tile's rows can see; all Sk keys if one row sees none
  const int skv = (pr.sk_valid > 0 && pr.sk_valid < Sk) ? pr.sk_valid : Sk;
  auto lo_of = [&](long long qi) -> long long {
    return pr.has_window ? (qi - pr.window + 1 > 0 ? qi - pr.window + 1 : 0) : 0;
  };
  auto hi_of = [&](long long qi) -> long long {   // exclusive
    const long long c = pr.causal ? qi + 1 : Sk;
    return c < skv ? c : skv;
  };
  const long long first = static_cast<long long>(q0) + pr.q_offset;
  const long long last = static_cast<long long>(min(q0 + kBQ, Sq) - 1) + pr.q_offset;
  // rows that see a key form an interval of positions, so the end rows decide
  long long k_begin = lo_of(first), k_end = hi_of(last);
  if (lo_of(first) >= hi_of(first) || lo_of(last) >= hi_of(last)) {
    k_begin = 0;
    k_end = Sk;
  }
  k_begin -= k_begin % BK;

  float acc[4][ND];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < ND; ++b) acc[a][b] = 0.f;

  for (int k0 = static_cast<int>(k_begin); k0 < k_end; k0 += BK) {
    load_tile<T, DH>(ks, DH1, kh, k0, BK, Sk, dh);
    load_tile<T, DH>(vs, DH, vh, k0, BK, Sk, dh);
    __syncthreads();

    // scores: rows ti + 16a, keys tj + 16c
    float s[4][NC];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < NC; ++c) s[a][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qv[4], kv[NC];
#pragma unroll
      for (int a = 0; a < 4; ++a) qv[a] = qs[(ti + 16 * a) * DH1 + d];
#pragma unroll
      for (int c = 0; c < NC; ++c) kv[c] = ks[(tj + 16 * c) * DH1 + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < NC; ++c) s[a][c] = fmaf(qv[a], kv[c], s[a][c]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const long long qi = static_cast<long long>(q0 + ti + 16 * a) + pr.q_offset;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int kj = k0 + tj + 16 * c;
        float val = s[a][c] * pr.scale;
        if (kj >= Sk) {
          val = -INFINITY;                     // no such key
        } else {
          bool ok = kj < skv;
          if (pr.causal) ok = ok && kj <= qi;
          if (pr.has_window) ok = ok && kj > qi - pr.window;
          if (!ok) val = kNegInf;
        }
        ps[(ti + 16 * a) * BK1 + tj + 16 * c] = val;
      }
    }
    __syncthreads();

    // online softmax, one warp a row
    for (int r = warp; r < kBQ; r += kWarps) {
      float sv[BK / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < BK / 32; ++u) {
        sv[u] = ps[r * BK1 + lane + 32 * u];
        mx = fmaxf(mx, sv[u]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < BK / 32; ++u) {
        const float p = expf(sv[u] - m_new);
        sum += p;
        ps[r * BK1 + lane + 32 * u] = round_to<T>(p);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        a_s[r] = alpha;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + T(p) . v: rows ti + 16a, columns tj + 16b
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float alpha = a_s[ti + 16 * a];
#pragma unroll
      for (int b = 0; b < ND; ++b) acc[a][b] *= alpha;
    }
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[4], vv[ND];
#pragma unroll
      for (int a = 0; a < 4; ++a) pv[a] = ps[(ti + 16 * a) * BK1 + j];
#pragma unroll
      for (int b = 0; b < ND; ++b) vv[b] = vs[j * DH + tj + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < ND; ++b) acc[a][b] = fmaf(pv[a], vv[b], acc[a][b]);
    }
    __syncthreads();   // ks, vs and ps are refilled next
  }

  T* oh = o + static_cast<size_t>(bh) * Sq * dh;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ti + 16 * a;
    if (q0 + r >= Sq) continue;
    const float inv_l = 1.f / fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int b = 0; b < ND; ++b) {
      const int d = tj + 16 * b;
      if (d < dh) oh[static_cast<size_t>(q0 + r) * dh + d] = from_f<T>(acc[a][b] * inv_l);
    }
  }
}


// ---------------------------------------------------------------------------
// bf16 on the tensor cores (mma and mma_decode)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// p = exp(s - m') as 2^(s log2(e) - m' log2(e)): the scale and log2(e) are
// applied together after the sum and MUFU.EX2 takes the difference
// (PERF.md bounds the change in p far below bf16's rounding of p)
constexpr float kLog2e = 1.4426950408889634f;
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

// byte offset of 16-byte chunk c of row r in a tile of DH bf16 a row; the
// chunk index is XORed with r % 8, so the 8 rows one ldmatrix phase reads at
// one logical chunk fall in 8 different 16-byte bank groups
template <int DH>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * (DH * 2) + ((c ^ (r & 7)) << 4));
}

// ROWS rows of DH bf16 into the swizzled tile at tile (shared memory);
// row r comes from src(r) (nullptr: a zero row), columns past dh are 0.
// vec: cp.async of 16 bytes (the caller commits); else plain loads.
template <int DH, int ROWS, int NT, typename RowFn>
__device__ __forceinline__ void load_tile(unsigned char* tile, RowFn src, int dh, bool vec) {
  constexpr int CH = DH / 8;
  for (int e = threadIdx.x; e < ROWS * CH; e += NT) {
    const int r = e / CH, c = e % CH;
    const bf16* row = src(r);
    const uint32_t off = swz<DH>(r, c);
    if (vec && row != nullptr && c * 8 < dh) {
      cp_async16(smem_addr(tile + off), row + c * 8);
    } else if (vec || row == nullptr) {
      *reinterpret_cast<uint4*>(tile + off) = make_uint4(0, 0, 0, 0);
    } else {
      const unsigned short* rs = reinterpret_cast<const unsigned short*>(row);
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = c * 8 + 2 * i;
        const uint32_t lo = d < dh ? rs[d] : 0u, hi = d + 1 < dh ? rs[d + 1] : 0u;
        w[i] = lo | (hi << 16);
      }
      *reinterpret_cast<uint4*>(tile + off) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// The key range [begin, end) a tile whose real rows sit at positions first
// .. last walks (begin rounded down to a multiple of BKN): every key a row
// can see, or all Sk keys if one of its rows sees none.
struct KeyRange {
  int begin, end;
};

template <int BKN>
__device__ __forceinline__ KeyRange key_range(const Params& pr, int skv, long long first,
                                              long long last) {
  auto lo_of = [&](long long qi) -> long long {
    return pr.has_window ? (qi - pr.window + 1 > 0 ? qi - pr.window + 1 : 0) : 0;
  };
  auto hi_of = [&](long long qi) -> long long {   // exclusive
    const long long c = pr.causal ? qi + 1 : pr.Sk;
    return c < skv ? c : skv;
  };
  if (lo_of(first) >= hi_of(first) || lo_of(last) >= hi_of(last)) return {0, pr.Sk};
  const int b = static_cast<int>(lo_of(first));
  return {b - b % BKN, static_cast<int>(hi_of(last))};
}

// true when every key of [k0, k0 + n) is valid for every row at positions
// first .. last, so the block needs no mask
__device__ __forceinline__ bool block_full(const Params& pr, int skv, int k0, int n,
                                           long long first, long long last) {
  const long long k1 = static_cast<long long>(k0) + n;   // exclusive
  if (k1 > pr.Sk || k1 > skv) return false;
  if (pr.causal && k1 - 1 > first) return false;
  if (pr.has_window && static_cast<long long>(k0) <= last - pr.window) return false;
  return true;
}

// One warp, one key block: keys k0 .. k0 + BKN - 1 of the K and V tiles at
// ks and vs (shared-memory addresses, rows 0 .. BKN - 1 of each), for the
// warp's 16 query rows (fragment qf in registers, or rows qrow .. qrow + 15
// of the q tile at qs); this thread's rows g = lane / 4 and g + 8 sit at key
// positions qi[0] and qi[1].  Updates m, l (this thread's share of the row
// sum) and acc (16 x DH, the m16n8 C layout, DH / 8 tiles).
template <int DH, int BKN, bool QREG, int QN>
__device__ __forceinline__ void attend_block(const uint32_t (&qf)[QN][4], uint32_t qs, int qrow,
                                             uint32_t ks, uint32_t vs, int k0, bool masked,
                                             const Params& pr, int skv, const long long (&qi)[2],
                                             float (&m)[2], float (&l)[2],
                                             float (&acc)[DH / 8][4]) {
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;

  // s = q . k^T
  float s[BKN / 8][4];
#pragma unroll
  for (int n = 0; n < BKN / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int kd = 0; kd < DH / 16; ++kd) {
    uint32_t a[4];
    if constexpr (QREG) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qf[kd][i];
    } else {
      ldmatrix_x4(a, qs + swz<DH>(qrow + (lane & 15), 2 * kd + (lane >> 4)));
    }
#pragma unroll
    for (int p = 0; p < BKN / 16; ++p) {
      uint32_t b[4];
      ldmatrix_x4(b, ks + swz<DH>(16 * p + (lane & 7) + ((lane >> 4) << 3),
                                  2 * kd + ((lane >> 3) & 1)));
      mma_bf16(s[2 * p], a, b[0], b[1]);
      mma_bf16(s[2 * p + 1], a, b[2], b[3]);
    }
  }

  // scale, mask, the block's row max
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < BKN / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float val = s[n][e] * (pr.scale * kLog2e);
      if (masked) {
        const int kj = k0 + 8 * n + 2 * t + (e & 1);
        const long long q = qi[e >> 1];
        if (kj >= pr.Sk) {
          val = -INFINITY;                     // no such key
        } else {
          bool ok = kj < skv;
          if (pr.causal) ok = ok && kj <= q;
          if (pr.has_window) ok = ok && kj > q - pr.window;
          if (!ok) val = kNegInf;
        }
      }
      s[n][e] = val;
      mx[e >> 1] = fmaxf(mx[e >> 1], val);
    }
  }
  float alpha[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h]);
    alpha[h] = exp2_approx(m[h] - m_new);
    m[h] = m_new;
  }

  // p = exp(s - m'), l = l * alpha + rowsum p (unrounded)
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < BKN / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2_approx(s[n][e] - m[e >> 1]);
      s[n][e] = p;
      rs[e >> 1] += p;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];

  // acc = acc * alpha + bf16(p) . v: the C fragments of s are the A
  // fragments of p
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    acc[n][0] *= alpha[0];
    acc[n][1] *= alpha[0];
    acc[n][2] *= alpha[1];
    acc[n][3] *= alpha[1];
  }
#pragma unroll
  for (int kk = 0; kk < BKN / 16; ++kk) {
    const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                           pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                           pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                           pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int p = 0; p < DH / 16; ++p) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, vs + swz<DH>(16 * kk + (lane & 15), 2 * p + (lane >> 4)));
      mma_bf16(acc[2 * p], a, b[0], b[1]);
      mma_bf16(acc[2 * p + 1], a, b[2], b[3]);
    }
  }
}

// the warp's q fragment, rows qrow .. qrow + 15 of the q tile at qs
template <int DH, int QN>
__device__ __forceinline__ void load_q_fragment(uint32_t (&qf)[QN][4], uint32_t qs, int qrow) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kd = 0; kd < QN; ++kd)
    ldmatrix_x4(qf[kd], qs + swz<DH>(qrow + (lane & 15), 2 * kd + (lane >> 4)));
}

template <int DH, int NW, int BKN>
constexpr int mma_smem_bytes() {
  return 2 * DH * (16 * NW + 4 * BKN);     // q tile, 2 stages of k and v
}

template <int DH, int NW, int BKN>
constexpr int decode_smem_bytes() {
  return 2 * DH * (16 + 4 * NW * BKN);     // q tile, 2 stages of k and v
}

// mma: grid (BH, query tiles of 16 * NW rows), NW warps
template <int DH, int NW, int BKN>
__global__ void __launch_bounds__(NW * 32)
flash_mma_prefill_kernel(const bf16* __restrict__ q,   // (BH, Sq, dh)
                         const bf16* __restrict__ k,   // (BK, Sk, dh)
                         const bf16* __restrict__ v,   // (BK, Sk, dh)
                         bf16* __restrict__ o,         // (BH, Sq, dh)
                         Params pr) {
  constexpr int NT = NW * 32, BQ = 16 * NW;
  constexpr bool QREG = DH <= 128;
  constexpr int QN = QREG ? DH / 16 : 1;
  constexpr int QBYTES = BQ * DH * 2, KVBYTES = BKN * DH * 2;
  extern __shared__ __align__(128) unsigned char fa_smem[];
  unsigned char* q_tile = fa_smem;
  auto k_tile = [&](int st) { return fa_smem + QBYTES + st * 2 * KVBYTES; };
  auto v_tile = [&](int st) { return fa_smem + QBYTES + st * 2 * KVBYTES + KVBYTES; };

  const int Sq = pr.Sq, Sk = pr.Sk, dh = pr.dh;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bool vec = pr.vec != 0;
  const bf16* qh = q + static_cast<size_t>(bh) * Sq * dh;
  const bf16* kh = k + static_cast<size_t>(bh / pr.rep) * Sk * dh;
  const bf16* vh = v + static_cast<size_t>(bh / pr.rep) * Sk * dh;

  const int skv = (pr.sk_valid > 0 && pr.sk_valid < Sk) ? pr.sk_valid : Sk;
  const KeyRange kr = key_range<BKN>(pr, skv, static_cast<long long>(q0) + pr.q_offset,
                                     static_cast<long long>(min(q0 + BQ, Sq) - 1) + pr.q_offset);
  auto load_kv = [&](int k0, int st) {
    auto rows = [&](const bf16* base) {
      return [=](int r) { return k0 + r < Sk ? base + static_cast<size_t>(k0 + r) * dh : nullptr; };
    };
    load_tile<DH, BKN, NT>(k_tile(st), rows(kh), dh, vec);
    load_tile<DH, BKN, NT>(v_tile(st), rows(vh), dh, vec);
  };
  load_tile<DH, BQ, NT>(
      q_tile, [=](int r) { return q0 + r < Sq ? qh + static_cast<size_t>(q0 + r) * dh : nullptr; },
      dh, vec);
  load_kv(kr.begin, 0);
  cp_async_commit();

  // this warp's rows and their positions
  const int qrow = 16 * warp;
  const long long wfirst = static_cast<long long>(q0 + qrow) + pr.q_offset;
  const long long wlast = static_cast<long long>(min(q0 + qrow + 15, Sq - 1)) + pr.q_offset;
  const long long qi[2] = {wfirst + g, wfirst + g + 8};

  uint32_t qf[QN][4];
  if constexpr (QREG) {
    cp_async_wait_all();
    __syncthreads();
    load_q_fragment<DH>(qf, smem_addr(q_tile), qrow);
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  int st = 0;
  for (int k0 = kr.begin; k0 < kr.end; k0 += BKN, st ^= 1) {
    cp_async_wait_all();
    __syncthreads();   // tile k0 is in; every warp is done with the other stage
    if (k0 + BKN < kr.end) load_kv(k0 + BKN, st ^ 1);
    cp_async_commit();
    const bool masked = !block_full(pr, skv, k0, BKN, wfirst, wlast);
    attend_block<DH, BKN, QREG>(qf, smem_addr(q_tile), qrow, smem_addr(k_tile(st)),
                                smem_addr(v_tile(st)), k0, masked, pr, skv, qi, m, l, acc);
  }

  // out = bf16(acc / max(l, 1e-30)), l summed over the quad
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + qrow + g + 8 * h;
    if (row >= Sq) continue;
    const float den = fmaxf(l[h], 1e-30f);
    bf16* orow = o + (static_cast<size_t>(bh) * Sq + row) * dh;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      const int d = 8 * n + 2 * t;
      const float y0 = acc[n][2 * h] / den, y1 = acc[n][2 * h + 1] / den;
      if (vec) {
        if (d < dh) *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(y0, y1);
      } else {
        if (d < dh) orow[d] = __float2bfloat16(y0);
        if (d + 1 < dh) orow[d + 1] = __float2bfloat16(y1);
      }
    }
  }
}

// mma_decode: grid (BK, groups of 16 packed rows, split), NW warps, in
// clusters of (1, 1, split).  Packed row r of kv head kvh is query head
// kvh * rep + r / Sq at position r % Sq.  The split blocks of a cluster take
// runs of whole stages of the tile's key range; each merges its warps, then
// the cluster merges its blocks through distributed shared memory.
template <int DH, int NW, int BKN>
__global__ void __launch_bounds__(NW * 32)
flash_mma_decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ o, Params pr) {
  constexpr int NT = NW * 32, STAGE = NW * BKN;   // keys a stage
  constexpr bool QREG = DH <= 128;
  constexpr int QN = QREG ? DH / 16 : 1;
  constexpr int QBYTES = 16 * DH * 2, KVBYTES = STAGE * DH * 2;
  constexpr int ACC_LD = DH + 4;                   // floats a merged row
  static_assert((NW * 16 * (ACC_LD + 3) + 16 * (ACC_LD + 2)) * 4 <= 4 * KVBYTES,
                "merge scratch fits the stages");
  extern __shared__ __align__(128) unsigned char fa_smem[];
  unsigned char* q_tile = fa_smem;
  auto k_tile = [&](int st) { return fa_smem + QBYTES + st * 2 * KVBYTES; };
  auto v_tile = [&](int st) { return fa_smem + QBYTES + st * 2 * KVBYTES + KVBYTES; };

  const int Sq = pr.Sq, Sk = pr.Sk, dh = pr.dh, rep = pr.rep;
  const int kvh = blockIdx.x, r0 = blockIdx.y * 16, nrows = rep * Sq;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bool vec = pr.vec != 0;
  const bf16* kh = k + static_cast<size_t>(kvh) * Sk * dh;
  const bf16* vh = v + static_cast<size_t>(kvh) * Sk * dh;
  auto q_row = [=](int r) -> size_t {   // packed row → row of (BH * Sq, dh)
    return static_cast<size_t>(kvh * rep + r / Sq) * Sq + r % Sq;
  };

  const int skv = (pr.sk_valid > 0 && pr.sk_valid < Sk) ? pr.sk_valid : Sk;
  const long long first = pr.q_offset, last = static_cast<long long>(Sq - 1) + pr.q_offset;
  const KeyRange kr = key_range<BKN>(pr, skv, first, last);
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int per = ((kr.end - kr.begin + STAGE - 1) / STAGE + split - 1) / split;   // stages
  const int kb = min(kr.end, kr.begin + rank * per * STAGE);
  const int ke = min(kr.end, kb + per * STAGE);     // this block's keys [kb, ke)
  auto load_kv = [&](int s0, int st) {
    auto rows = [&](const bf16* base) {
      return [=](int r) { return s0 + r < Sk ? base + static_cast<size_t>(s0 + r) * dh : nullptr; };
    };
    load_tile<DH, STAGE, NT>(k_tile(st), rows(kh), dh, vec);
    load_tile<DH, STAGE, NT>(v_tile(st), rows(vh), dh, vec);
  };
  load_tile<DH, 16, NT>(
      q_tile, [=](int r) { return r0 + r < nrows ? q + q_row(r0 + r) * dh : nullptr; }, dh, vec);
  if (kb < ke) load_kv(kb, 0);
  cp_async_commit();

  long long qi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) qi[h] = static_cast<long long>((r0 + g + 8 * h) % Sq) + pr.q_offset;

  uint32_t qf[QN][4];
  if constexpr (QREG) {
    cp_async_wait_all();
    __syncthreads();
    load_q_fragment<DH>(qf, smem_addr(q_tile), 0);
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  int st = 0;
  for (int s0 = kb; s0 < ke; s0 += STAGE, st ^= 1) {
    cp_async_wait_all();
    __syncthreads();
    if (s0 + STAGE < ke) load_kv(s0 + STAGE, st ^ 1);
    cp_async_commit();
    const int k0 = s0 + warp * BKN;
    if (k0 < ke) {
      const bool masked = !block_full(pr, skv, k0, BKN, first, last);
      const uint32_t off = warp * BKN * DH * 2;
      attend_block<DH, BKN, QREG>(qf, smem_addr(q_tile), 0, smem_addr(k_tile(st)) + off,
                                  smem_addr(v_tile(st)) + off, k0, masked, pr, skv, qi, m, l,
                                  acc);
    }
  }

  // merge the warps, then the blocks: M = max m, out = sum e^(m - M) acc /
  // sum e^(m - M) l.  A warp or block that saw no key has m = -1e30, l = 0
  // and acc = 0, so it weighs nothing unless no one saw a key.
  cp_async_wait_all();
  __syncthreads();   // the stages are free
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  float* red = reinterpret_cast<float*>(fa_smem + QBYTES);
  float* acc_s = red;                              // [NW][16][ACC_LD]
  float* m_s = red + NW * 16 * ACC_LD;             // [NW][16]
  float* l_s = m_s + NW * 16;                      // [NW][16]
  float* w_s = l_s + NW * 16;                      // [NW][16]: e^(m_w - m_b)
  float* bacc = w_s + NW * 16;                     // [16][ACC_LD]: the block's sum
  float* bm = bacc + 16 * ACC_LD;                  // [16]: the block's m
  float* bl = bm + 16;                             // [16]: the block's l
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = g + 8 * h;
    if (t == 0) {
      m_s[warp * 16 + row] = m[h];
      l_s[warp * 16 + row] = l[h];
    }
    float* dst = acc_s + (warp * 16 + row) * ACC_LD;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n + 2 * t) =
          make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
  }
  __syncthreads();
  if (threadIdx.x < 16) {
    const int row = threadIdx.x;
    float mm = kNegInf;
    for (int w = 0; w < NW; ++w) mm = fmaxf(mm, m_s[w * 16 + row]);
    float ll = 0.f;
    for (int w = 0; w < NW; ++w) {
      const float e = exp2_approx(m_s[w * 16 + row] - mm);
      w_s[w * 16 + row] = e;
      ll += e * l_s[w * 16 + row];
    }
    bm[row] = mm;
    bl[row] = ll;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 16 * DH; e += NT) {
    const int row = e / DH, d = e % DH;
    float y = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) y += w_s[w * 16 + row] * acc_s[(w * 16 + row) * ACC_LD + d];
    if (split == 1) {   // no other block: this is the output
      if (r0 + row < nrows && d < dh)
        o[q_row(r0 + row) * dh + d] = __float2bfloat16(y / fmaxf(bl[row], 1e-30f));
    } else {
      bacc[row * ACC_LD + d] = y;
    }
  }
  if (split == 1) return;
  cluster.sync();   // every block's bm, bl and bacc are written
  for (int e = rank * NT + threadIdx.x; e < 16 * DH; e += split * NT) {
    const int row = e / DH, d = e % DH;
    if (r0 + row >= nrows || d >= dh) continue;
    float mm = kNegInf;
    for (int c = 0; c < split; ++c) mm = fmaxf(mm, cluster.map_shared_rank(bm, c)[row]);
    float ll = 0.f, y = 0.f;
    for (int c = 0; c < split; ++c) {
      const float w = exp2_approx(cluster.map_shared_rank(bm, c)[row] - mm);
      ll += w * cluster.map_shared_rank(bl, c)[row];
      y += w * cluster.map_shared_rank(bacc, c)[row * ACC_LD + d];
    }
    o[q_row(r0 + row) * dh + d] = __float2bfloat16(y / fmaxf(ll, 1e-30f));
  }
  cluster.sync();   // no block leaves while another reads its shared memory
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// warps a block and keys a warp's key block, of the bf16 variants, and the
// longest query that takes mma_decode
constexpr int kMmaWarps = 8, kMmaKeys = 64, kMmaKeys256 = 32;
constexpr int kDecWarps = 4, kDecKeys = 16, kDecodeMaxSq = 16, kMaxSplit = 8;

int bucket(int dh) { return dh <= 64 ? 64 : dh <= 128 ? 128 : 256; }

template <typename T, typename K>
int run(K kernel, dim3 grid, int threads, int bytes, cudaStream_t st, const void* q,
        const void* k, const void* v, void* o, const Params& pr) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, bytes, st>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                       static_cast<const T*>(v), static_cast<T*>(o), pr);
  return static_cast<int>(cudaGetLastError());
}

template <int DH, int BK>
int launch_simt(const void* q, const void* k, const void* v, void* o, int BH, const Params& pr,
                cudaStream_t st) {
  const dim3 grid((pr.Sq + kBQ - 1) / kBQ, BH);
  return run<float>(flash_attention_kernel<float, DH, BK>, grid, kThreads,
                    smem_floats<DH, BK>() * 4, st, q, k, v, o, pr);
}

template <int DH, int BKN>
int launch_mma(const void* q, const void* k, const void* v, void* o, int BH, const Params& pr,
               cudaStream_t st) {
  const dim3 grid(BH, (pr.Sq + 16 * kMmaWarps - 1) / (16 * kMmaWarps));
  return run<bf16>(flash_mma_prefill_kernel<DH, kMmaWarps, BKN>, grid, 32 * kMmaWarps,
                   mma_smem_bytes<DH, kMmaWarps, BKN>(), st, q, k, v, o, pr);
}

// BK x groups blocks that leave SMs idle split each tile's keys over a
// cluster of up to kMaxSplit blocks, each with 2 stages or more
template <int DH>
int launch_decode(const void* q, const void* k, const void* v, void* o, int BKV,
                  const Params& pr, cudaStream_t st) {
  auto kernel = flash_mma_decode_kernel<DH, kDecWarps, kDecKeys>;
  constexpr int bytes = decode_smem_bytes<DH, kDecWarps, kDecKeys>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = (pr.rep * pr.Sq + 15) / 16, blocks = BKV * groups;
  const int stages = (pr.Sk + kDecWarps * kDecKeys - 1) / (kDecWarps * kDecKeys);
  const int split = blocks >= sms ? 1 : std::max(1, std::min({kMaxSplit, sms / blocks, stages / 2}));
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(BKV, groups, split);
  cfg.blockDim = dim3(32 * kDecWarps);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1;   // no cluster: one block a tile
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                           static_cast<const bf16*>(v), static_cast<bf16*>(o), pr);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int BH, int BKV, int Sq,
           int Sk, int dh, float scale, int causal, int has_window, int window, int sk_valid,
           int q_offset, void* stream) {
  constexpr bool f32 = sizeof(T) == 4;
  const bool decode = !f32 && Sq <= kDecodeMaxSq;
  if (BH <= 0 || BKV <= 0 || BH % BKV || Sq <= 0 || Sk <= 0 || dh <= 0 || dh > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rep = BH / BKV;
  if ((f32 && BH > 65535) ||
      (!f32 && !decode && (Sq + 16 * kMmaWarps - 1) / (16 * kMmaWarps) > 65535) ||
      (decode && (static_cast<long long>(rep) * Sq + 15) / 16 > 65535))
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = dh % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o);
  const Params pr{Sq, Sk, dh, rep, scale, causal, has_window, window, sk_valid, q_offset, vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int b = bucket(dh);
  if (f32) {
    if (b == 64) return launch_simt<64, 64>(q, k, v, o, BH, pr, st);
    if (b == 128) return launch_simt<128, 64>(q, k, v, o, BH, pr, st);
    return launch_simt<256, 32>(q, k, v, o, BH, pr, st);
  }
  if (!decode) {
    if (b == 64) return launch_mma<64, kMmaKeys>(q, k, v, o, BH, pr, st);
    if (b == 128) return launch_mma<128, kMmaKeys>(q, k, v, o, BH, pr, st);
    return launch_mma<256, kMmaKeys256>(q, k, v, o, BH, pr, st);
  }
  if (b == 64) return launch_decode<64>(q, k, v, o, BKV, pr, st);
  if (b == 128) return launch_decode<128>(q, k, v, o, BKV, pr, st);
  return launch_decode<256>(q, k, v, o, BKV, pr, st);
}

}  // namespace

extern "C" {

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#define FA_ENTRY(NAME, T)                                                                 \
  int NAME(const void* q, const void* k, const void* v, void* o, int BH, int BKV, int Sq,  \
           int Sk, int dh, float scale, int causal, int has_window, int window,           \
           int sk_valid, int q_offset, void* stream) {                                    \
    return launch<T>(q, k, v, o, BH, BKV, Sq, Sk, dh, scale, causal, has_window, window,  \
                     sk_valid, q_offset, stream);                                         \
  }

FA_ENTRY(flash_attention_f32, float)
FA_ENTRY(flash_attention_bf16, __nv_bfloat16)

#undef FA_ENTRY

}  // extern "C"

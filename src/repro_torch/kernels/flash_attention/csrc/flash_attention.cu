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
// The Pallas grid walks key blocks in order with m, l and acc in VMEM
// scratch; here one block owns 64 query rows of one head and loops over key
// blocks of 64 (32 at head dim 256), with q, k and v tiles staged in shared
// memory as f32, the scores and then T(p) in shared memory, m and l in shared
// memory and acc in registers.  Both products are register tiles per thread
// (4 rows x 4 keys of the scores, 4 rows x dh / 16 columns of acc), rows of
// q and k stored with an odd stride so that 16 rows read in one step fall in
// 16 banks.  Query tiles are issued last-first so that the long causal tiles
// start early.
//
// What bounds it.  At llama2-7b prefill (32 heads, dh 128, S 4096, causal,
// bf16): 137 GFLOP over the valid (row, key) pairs, 0.139 ms at the bf16
// tensor-core rate and 2.05 ms at the 67 TFLOP/s f32 rate, against 0.040 ms of
// bytes.  This first version runs on the CUDA cores in f32 (exact products of
// bf16 operands, as the MXU's, with f32 sums); a tensor-core (wgmma) mainloop
// is later work.
//
// Shapes: any Sq, Sk; dh <= 256 (compiled for dh buckets 64, 128 and 256,
// zero-padded); BH a multiple of BK.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 64;       // query rows a block
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

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

template <typename T, int DH, int BK>
int launch_dh(const void* q, const void* k, const void* v, void* o, int BH,
              const Params& pr, cudaStream_t st) {
  const size_t bytes = smem_floats<DH, BK>() * sizeof(float);
  auto kernel = flash_attention_kernel<T, DH, BK>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((pr.Sq + kBQ - 1) / kBQ, BH);
  kernel<<<grid, kThreads, bytes, st>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                        static_cast<const T*>(v), static_cast<T*>(o), pr);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int BH, int BKV, int Sq,
           int Sk, int dh, float scale, int causal, int has_window, int window, int sk_valid,
           int q_offset, void* stream) {
  if (BH <= 0 || BKV <= 0 || BH % BKV || BH > 65535 || Sq <= 0 || Sk <= 0 || dh <= 0 ||
      dh > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params pr{Sq, Sk, dh, BH / BKV, scale, causal, has_window, window, sk_valid, q_offset};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh <= 64) return launch_dh<T, 64, 64>(q, k, v, o, BH, pr, st);
  if (dh <= 128) return launch_dh<T, 128, 64>(q, k, v, o, BH, pr, st);
  return launch_dh<T, 256, 32>(q, k, v, o, BH, pr, st);
}

}  // namespace

extern "C" {

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#define FA_ENTRY(NAME, T)                                                                \
  int NAME(const void* q, const void* k, const void* v, void* o, int BH, int BKV, int Sq, \
           int Sk, int dh, float scale, int causal, int has_window, int window,          \
           int sk_valid, int q_offset, void* stream) {                                   \
    return launch<T>(q, k, v, o, BH, BKV, Sq, Sk, dh, scale, causal, has_window, window, \
                     sk_valid, q_offset, stream);                                        \
  }

FA_ENTRY(flash_attention_f32, float)
FA_ENTRY(flash_attention_bf16, __nv_bfloat16)

#undef FA_ENTRY

}  // extern "C"

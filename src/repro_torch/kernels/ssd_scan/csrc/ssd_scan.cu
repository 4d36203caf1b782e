// Hand-written Hopper (sm_90a) Mamba-2 SSD chunked scan.
//
// Replaces the Pallas TPU kernel ssd_scan_bh (body _kernel) of
// src/repro/kernels/ssd_scan/ssd_scan.py.  It computes what the Pallas body
// computes, per head h and chunk of Q steps, everything in f32:
//
//   a    = -exp(a_log[h]) * dt                  log-decay, l = cumsum(a)
//   xdt  = x * dt
//   y    = ((C . B^T) o L) . xdt                L[i,j] = exp(l_i - l_j), i >= j
//        + (C o exp(l)) . state                 the state entering the chunk
//   state = exp(l_Q) * state + (B o exp(l_Q - l))^T . xdt
//
// with B and C those of the head's group h / rep, x, B and C (one type T)
// loaded into f32, y written in T and the final state (N, P) in f32.  exp(l_i - l_j)
// overflows for i < j, so it is evaluated only where i >= j (the Pallas body
// selects it away with jnp.where; a 0/1 mask would give inf * 0 = NaN).
//
// The Pallas grid walks the chunks in order with the state in VMEM scratch;
// here one block owns one head and loops over its chunks, the (N, P) state in
// shared memory.  A chunk's Q x Q decay tile does not fit (256 KB in f32 at
// Q = 256, more than an SM's 227 KB), so the chunk is walked in tiles of 64
// rows: for each row tile I, the state term, then for each column tile J <= I
// the 64 x 64 tile of (C_I . B_J^T) o L in shared memory and its product with
// xdt_J, accumulated in registers; then the state update over the column
// tiles, after every row of the chunk has read the old state.  Every product
// is a 4 x 4 register tile per thread over shared memory; rows of C and B are
// stored with an odd stride (N + 1) so that 16 rows read in one step fall in
// 16 banks.
//
// What bounds it.  At mamba2-2.7b (H 80, P 64, N 128, chunk 128; b 1, S 4096):
// about 19 GFLOP of the triangle's products, 0.019 ms at the bf16 tensor-core
// rate and 0.28 ms at the 67 TFLOP/s f32 rate, against about 0.05 ms of bytes
// (x, B, C, y in f32).  This first version runs on the CUDA cores in f32, with
// one block a head: 80 blocks on 132 SMs at b = 1, one block an SM (about
// 131 KB of shared memory at N 128, P 64, Q 128).  A tensor-core product and
// more blocks a head are later work.
//
// Shapes: P <= 64; N and Q as far as the block's shared memory (smem_floats)
// stays within the card's opt-in limit, 227 KB on an H100 (N 128 and Q 256
// take 134 KB), else the launch is refused; S a multiple of Q; ragged tiles
// are masked.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kT = 64;        // rows (and columns) of a tile of the chunk
constexpr int kMaxP = 64;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// floats of shared memory for one block
constexpr long long smem_floats(int P, int N, int Q) {
  return static_cast<long long>(N) * P         // state
         + 2LL * kT * (N + 1)                  // C rows of a row tile, B rows of a column tile
         + static_cast<long long>(kT) * P      // x * dt of a column tile
         + static_cast<long long>(kT) * (kT + 1)  // the decayed C . B^T tile
         + 2LL * Q                             // dt, cumulative log-decay
         + kT                                  // segment decays
         + 2LL * kWarps;                       // f64 scan partials
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x,         // (BH, S, P)
                const float* __restrict__ dt,    // (BH, S)
                const float* __restrict__ a_log, // (BH,)
                const T* __restrict__ B,         // (BG, S, N)
                const T* __restrict__ C,         // (BG, S, N)
                T* __restrict__ y,              // (BH, S, P)
                float* __restrict__ state,       // (BH, N, P)
                int S, int P, int N, int Q, int rep) {
  extern __shared__ double smem_d[];
  double* red = smem_d;             // [kWarps] scan partials
  float* smem = reinterpret_cast<float*>(red + kWarps);
  const int N1 = N + 1, T1 = kT + 1;
  float* st = smem;                 // [N][P]
  float* cs = st + N * P;           // [kT][N1]
  float* bs = cs + kT * N1;         // [kT][N1]
  float* xs = bs + kT * N1;         // [kT][P]
  float* mt = xs + kT * P;          // [kT][T1]
  float* dts = mt + kT * T1;        // [Q]
  float* ld = dts + Q;              // [Q]
  float* seg = ld + Q;              // [kT]

  const int bh = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int ti = t / 16, tj = t % 16;   // 4 x 4 register tile: rows ti + 16a, columns tj + 16b
  const float A = -expf(a_log[bh]);
  const T* xh = x + static_cast<size_t>(bh) * S * P;
  const float* dth = dt + static_cast<size_t>(bh) * S;
  const T* Bg = B + static_cast<size_t>(bh / rep) * S * N;
  const T* Cg = C + static_cast<size_t>(bh / rep) * S * N;
  T* yh = y + static_cast<size_t>(bh) * S * P;

  for (int e = t; e < N * P; e += kThreads) st[e] = 0.f;

  // x * dt rows j0 .. j0 + kT - 1 of the chunk into xs (0 past the chunk)
  auto load_xdt = [&](int s0, int j0) {
    for (int e = t; e < kT * P; e += kThreads) {
      const int r = e / P, p = e % P;
      xs[e] = (j0 + r < Q) ? to_f(xh[static_cast<size_t>(s0 + j0 + r) * P + p]) * dts[j0 + r] : 0.f;
    }
  };
  // rows i0 .. i0 + kT - 1 of a (S, N) group matrix into dst[kT][N1], each row times
  // scale[r] when scale is given
  auto load_rows = [&](float* dst, const T* src, int s0, int i0, const float* scale) {
    for (int e = t; e < kT * N; e += kThreads) {
      const int r = e / N, n = e % N;
      float v = 0.f;
      if (i0 + r < Q) {
        v = to_f(src[static_cast<size_t>(s0 + i0 + r) * N + n]);
        if (scale) v *= scale[r];
      }
      dst[r * N1 + n] = v;
    }
  };

  const int nc = S / Q;
  for (int c = 0; c < nc; ++c) {
    const int s0 = c * Q;

    // dt and the inclusive cumulative sum of the log-decay over the chunk,
    // summed in f64 and rounded once to f32 (as the plain version does), so
    // that both hold the same l: at mamba2's init |l| reaches several
    // hundred within a chunk, and an ulp of it moves exp(l_i - l_j)
    double carry = 0.0;
    for (int q0 = 0; q0 < Q; q0 += kThreads) {
      const int q = q0 + t;
      double v = 0.0;
      if (q < Q) {
        const float d = dth[s0 + q];
        dts[q] = d;
        v = static_cast<double>(A * d);
      }
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      if (lane == 31) red[warp] = v;
      __syncthreads();
      double off = carry, tot = carry;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        if (w < warp) off += red[w];
        tot += red[w];
      }
      if (q < Q) ld[q] = static_cast<float>(v + off);
      carry = tot;
      __syncthreads();
    }

    // y, one row tile at a time (every row reads the state entering the chunk)
    for (int i0 = 0; i0 < Q; i0 += kT) {
      load_rows(cs, Cg, s0, i0, nullptr);
      __syncthreads();

      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

      // (C o exp(l)) . state
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = cs[(ti + 16 * a) * N1 + n];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int p = tj + 16 * b;
          sv[b] = p < P ? st[n * P + p] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(cv[a], sv[b], acc[a][b]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ti + 16 * a;
        const float el = i < Q ? expf(ld[i]) : 0.f;
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] *= el;
      }

      // ((C . B^T) o L) . xdt over the column tiles up to the diagonal
      for (int j0 = 0; j0 <= i0; j0 += kT) {
        load_rows(bs, Bg, s0, j0, nullptr);
        load_xdt(s0, j0);
        __syncthreads();
        float m[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) m[a][b] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) cv[a] = cs[(ti + 16 * a) * N1 + n];
#pragma unroll
          for (int b = 0; b < 4; ++b) bv[b] = bs[(tj + 16 * b) * N1 + n];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) m[a][b] = fmaf(cv[a], bv[b], m[a][b]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = i0 + ti + 16 * a;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int j = j0 + tj + 16 * b;
            // the exp only where i >= j: above the diagonal it overflows
            mt[(ti + 16 * a) * T1 + tj + 16 * b] =
                (i >= j && i < Q) ? m[a][b] * expf(ld[i] - ld[j]) : 0.f;
          }
        }
        __syncthreads();
        for (int jj = 0; jj < kT; ++jj) {
          float mv[4], xv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) mv[a] = mt[(ti + 16 * a) * T1 + jj];
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int p = tj + 16 * b;
            xv[b] = p < P ? xs[jj * P + p] : 0.f;
          }
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(mv[a], xv[b], acc[a][b]);
        }
        __syncthreads();   // bs, xs and mt are refilled next
      }

#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ti + 16 * a;
        if (i >= Q) continue;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int p = tj + 16 * b;
          if (p < P) yh[static_cast<size_t>(s0 + i) * P + p] = from_f<T>(acc[a][b]);
        }
      }
    }

    // state = exp(l_Q) * state + (B o exp(l_Q - l))^T . xdt, over the column tiles;
    // each (n, p) entry belongs to one thread
    const float lQ = ld[Q - 1];
    const float dQ = expf(lQ);
    for (int j0 = 0; j0 < Q; j0 += kT) {
      if (t < kT) seg[t] = (j0 + t < Q) ? expf(lQ - ld[j0 + t]) : 0.f;
      __syncthreads();
      load_rows(bs, Bg, s0, j0, seg);
      load_xdt(s0, j0);
      __syncthreads();
      for (int n0 = 0; n0 < N; n0 += kT) {
        float u[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int n = n0 + ti + 16 * a;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int p = tj + 16 * b;
            u[a][b] = (n < N && p < P) ? st[n * P + p] * (j0 == 0 ? dQ : 1.f) : 0.f;
          }
        }
        for (int jj = 0; jj < kT; ++jj) {
          float bv[4], xv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const int n = n0 + ti + 16 * a;
            bv[a] = n < N ? bs[jj * N1 + n] : 0.f;
          }
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int p = tj + 16 * b;
            xv[b] = p < P ? xs[jj * P + p] : 0.f;
          }
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) u[a][b] = fmaf(bv[a], xv[b], u[a][b]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int n = n0 + ti + 16 * a;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int p = tj + 16 * b;
            if (n < N && p < P) st[n * P + p] = u[a][b];
          }
        }
      }
      __syncthreads();   // bs, xs and seg are refilled next, st is read next chunk
    }
  }

  float* sth = state + static_cast<size_t>(bh) * N * P;
  for (int e = t; e < N * P; e += kThreads) sth[e] = st[e];
}

template <typename T>
int launch(const void* x, const float* dt, const float* a_log, const void* B, const void* C,
           void* y, float* state, int BH, int BG, int S, int P, int N, int Q, void* stream) {
  if (BH <= 0 || BG <= 0 || BH % BG || S <= 0 || Q <= 0 || S % Q || P <= 0 || P > kMaxP ||
      N <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = static_cast<size_t>(smem_floats(P, N, Q)) * sizeof(float);
  int dev = 0, most = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bytes > static_cast<size_t>(most)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = ssd_scan_kernel<T>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<BH, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), dt, a_log, static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<T*>(y), state, S, P, N, Q, BH / BG);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#define SSD_ENTRY(NAME, T)                                                               \
  int NAME(const void* x, const float* dt, const float* a_log, const void* B,            \
           const void* C, void* y, float* state, int BH, int BG, int S, int P, int N,    \
           int Q, void* stream) {                                                        \
    return launch<T>(x, dt, a_log, B, C, y, state, BH, BG, S, P, N, Q, stream);          \
  }

SSD_ENTRY(ssd_scan_f32, float)
SSD_ENTRY(ssd_scan_bf16, __nv_bfloat16)

#undef SSD_ENTRY

}  // extern "C"

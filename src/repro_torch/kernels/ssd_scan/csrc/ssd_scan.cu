// Hand-written Hopper (sm_90a) Mamba-2 SSD chunked scan.
//
// Replaces the Pallas TPU kernel ssd_scan_bh (body _kernel) of
// src/repro/kernels/ssd_scan/ssd_scan.py.  Per head h (of group h / rep) and
// chunk of Q steps it computes what the Pallas body computes:
//
//   a     = -exp(a_log[h]) * dt                 log-decay, l = cumsum(a)
//   xdt   = x * dt
//   y     = ((C . B^T) o L) . xdt               L[i,j] = exp(l_i - l_j), i >= j
//         + (C o exp(l)) . s_in                 s_in: the state entering the chunk
//   s_out = exp(l_Q) * s_in + (B o exp(l_Q - l))^T . xdt
//
// with x, B and C of one type T, y written in T and the final state (N, P) in
// f32.  l is summed in f64 and rounded once to f32, as the plain version does.
// exp(l_i - l_j) overflows for i < j, so it is evaluated only where i >= j.
//
// The Pallas grid walks the chunks of a head in order with the state in VMEM.
// Here the chunks run in parallel, as the plain version writes the scan
// (src/repro_torch/models/ssm.py), in four launches on one stream:
//
//   ssd_cb      per (group, chunk, 64 x 64 tile of the lower triangle):
//               C . B^T, once a group and chunk and not once a head, into a
//               (BG, nc, Q, Q) workspace in T.
//   ssd_states  per (head, chunk): the f64 scan of the log-decay (its f32 l
//               into a (BH, S) workspace), then the chunk's own end state
//               sum_j exp(l_Q - l_j) B_j xdt_j^T into a (BH, nc, N, P) f32
//               workspace W.
//   ssd_pass    per (head, 256 chunks of 8 state entries): walks the chunks in
//               order, s = exp(l_Q) s + W[c], and writes the state entering
//               each chunk (bf16: split into bf16 hi + lo tiles laid out as
//               ssd_y_mma's shared memory holds them; f32: in place in W) and
//               the final state.  The heads go last first, so that the chunk
//               states ssd_states wrote last are read while still in L2.
//   ssd_y       per (head, chunk, 128 rows; 64 in f32): the state term, then
//               the triangle's column tiles up to the diagonal; the chunks go
//               last first, for the same reason.
//
// The wrapper allocates the workspaces with torch.empty; the kernels allocate
// nothing, use no atomics and add every sum in a fixed order, so a CUDA-graph
// replay equals the eager call bit for bit.
//
// bf16 runs every product on the tensor cores (mma.sync m16n8k16, bf16
// operands, f32 sums) at the cast points of the reference's chunked form
// (src/repro/models/ssm.py::_ssd_chunked): T(C . B^T) from f32 sums of exact
// products; M = T(T(C.B^T) * T(exp(l_i - l_j))) (one bf16x2 multiply of two
// bf16 values, rounded once) against T(x * dt) for the triangle;
// T(exp(l_Q - l_j) * B_j) against T(x * dt) for the end state (one rounding
// more than the reference's f32 three-operand product); and, for the state
// term, C against the f32 state split into two bf16 terms s = hi + lo
// (|s - hi - lo| <= 2^-16 |s|), exp(l_i) applied to the f32 row sums.
// ssd_scan/ref.py::bf16_bound bounds the result elementwise.  Where a
// factor underflows to exactly 0 (exp(l_i) for all 16 rows of a warp in
// ssd_y, the segment decays of 16 steps in ssd_states), the products it
// would scale are skipped: they add exactly 0.
//
// A block issues all of its loads first (16-byte cp.async into XOR-swizzled
// shared memory, read by ldmatrix; whole tiles by a loop of two increments),
// waits once, applies x * dt, the segment decays and the decayed triangle M
// in shared memory in one pass, and then runs its products without a further
// barrier: a warp owns 16 rows and every column, so an A fragment serves all
// of them.  Every index is a shift and a mask: tile rows are a power of two
// of 16-byte chunks.  f32 keeps f32-exact products on the CUDA cores (4 x 4
// register tiles over shared memory) in the same four launches.
//
// What bounds it.  At mamba2-2.7b (H 80, P 64, N 128, one group, chunk 128;
// b 1, S 4096): 89.9 MB of x, dt, B, C, y and the state, 0.02684 ms at
// 3.35 TB/s, against 13.6 GFLOP once C . B^T is counted once a group
// (0.0138 ms at the bf16 tensor-core rate, 0.2036 ms at 67 TFLOP/s in f32).
// The design adds the chunk states: 84 MB written by ssd_states, read by
// ssd_pass, 84 MB written by ssd_pass and read by ssd_y, about 0.10 ms of
// device memory where they miss L2, and the state term's second (lo) product.
// Measured there by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W: 0.269
// ms in bf16 (the one-block-a-head CUDA-core kernel this replaces: 3.63 ms),
// 1.07 ms in f32 (3.79 ms); by kernel (torch.profiler, bf16) ssd_cb 0.004,
// ssd_states 0.077, ssd_pass 0.066, ssd_y 0.119 ms.  The blocks are bound by
// latency and issue, not by bytes or tensor-core rate: 2-3 resident blocks an
// SM wait on each memory round trip, and ssd_y's state term (hi and lo) and
// the decayed triangle's exps take most of its issue slots.
//
// Shapes: P <= 64, N <= 256, any chunk Q that divides S (ragged tiles are
// zero-filled in shared memory), BH <= 65535; the launch is refused past them
// or past the card's shared memory (ssd_y and ssd_states keep 2 and 3 x Q
// floats).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxP = 64;
constexpr int kMaxN = 256;
constexpr int kTile = 64;        // C.B^T tiles (64 x 64); q steps of ssd_states; f32 row tiles
constexpr int kRowsY = 128;      // rows of a chunk one bf16 ssd_y block takes (16 a warp)
constexpr int kColsY = 128;      // columns of the triangle one stage of ssd_y holds

// v rounded to bf16 and back
__device__ __forceinline__ float rbf(float v) { return __bfloat162float(__float2bfloat16(v)); }

__host__ __device__ constexpr int align128(int bytes) { return (bytes + 127) / 128 * 128; }

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

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// log2 of the 16-byte chunks a row of a bf16 tile holds for nch chunks of
// data: rows are a power of two (at least 2) of chunks, so that every index
// of a tile is a shift and a mask
__host__ __device__ constexpr int row_lg(int nch) {
  int lg = 1;
  while ((1 << lg) < nch) ++lg;
  return lg;
}

// Byte offset of 16-byte chunk c of row r in a bf16 tile of 2^lg chunks a
// row: the chunk index XORed with a function of the row, so the 8 rows one
// ldmatrix phase reads fall in 8 different 16-byte bank groups.
__device__ __forceinline__ uint32_t swz(int r, int c, int lg) {
  const int f = lg >= 3 ? (r & 7) : ((r >> (3 - lg)) & ((1 << lg) - 1));
  return static_cast<uint32_t>(((r << lg) + (c ^ f)) << 4);
}

// Rows [0, R) of a swizzled bf16 tile of 2^lg chunks a row: tile row i is
// row row0 + i of the (rows x cols) matrix at src with ld elements a row,
// chunks [0, nch) of it, zeros past rows or cols (chunks past nch are never
// read and stay as they are).  vec: rows are whole 16-byte chunks at 16-byte
// aligned addresses, so a full chunk goes by cp.async (the caller commits);
// the rest by plain loads.
__device__ __forceinline__ void load_tile(unsigned char* tile, const bf16* src, int R, int row0,
                                          int rows, int cols, int ld, int nch, int lg, bool vec,
                                          int nthreads) {
  const int step = nthreads >> lg;   // rows a pass of the threads covers
  if (vec && nch == (1 << lg) && 8 * nch <= cols && row0 + R <= rows && (step & 7) == 0) {
    // a whole tile: each thread keeps its chunk column, and a step of a
    // multiple of 8 rows keeps its swizzle, so the loop is two increments
    const int i = threadIdx.x >> lg, c = threadIdx.x & ((1 << lg) - 1);
    const bf16* p = src + static_cast<size_t>(row0 + i) * ld + 8 * c;
    uint32_t dst = smem_addr(tile + swz(i, c, lg));
    for (int r = i; r < R; r += step) {
      cp_async16(dst, p);
      p += static_cast<size_t>(step) * ld;
      dst += (step << lg) * 16;
    }
    return;
  }
  for (int e = threadIdx.x; e < (R << lg); e += nthreads) {
    const int i = e >> lg, c = e & ((1 << lg) - 1);
    if (c >= nch) continue;
    const int row = row0 + i, col = 8 * c;
    unsigned char* dst = tile + swz(i, c, lg);
    if (row < rows && col < cols) {
      const bf16* p = src + static_cast<size_t>(row) * ld + col;
      if (vec && col + 8 <= cols) {
        cp_async16(smem_addr(dst), p);
        continue;
      }
      uint4 out = make_uint4(0, 0, 0, 0);
      bf16* o = reinterpret_cast<bf16*>(&out);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (col + k < cols) o[k] = p[k];
      *reinterpret_cast<uint4*>(dst) = out;
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  }
}

// the 8 bf16 of a shared-memory chunk times f, each rounded to bf16
__device__ __forceinline__ void scale_chunk(unsigned char* p, float f) {
  uint4 v = *reinterpret_cast<uint4*>(p);
  uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 e = unpack_bf16(w[k]);
    w[k] = pack_bf16(e.x * f, e.y * f);
  }
  *reinterpret_cast<uint4*>(p) = v;
}

// a pair of adjacent outputs at p, of which n >= 1 lie inside the row
__device__ __forceinline__ void store_pair(bf16* p, float a, float b, int n) {
  if (n >= 2 && (reinterpret_cast<uintptr_t>(p) & 3) == 0) {
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
    return;
  }
  p[0] = __float2bfloat16(a);
  if (n >= 2) p[1] = __float2bfloat16(b);
}

__device__ __forceinline__ void store_pair(float* p, float a, float b, int n) {
  if (n >= 2 && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
    return;
  }
  p[0] = a;
  if (n >= 2) p[1] = b;
}

// Rows [0, R) of an f32 shared tile dst (ldd floats a row): row i is row
// row0 + i of the (rows x cols, ld) matrix at src, columns [col0, col0 + W),
// times scale[row0 + i] when scale is given; zeros past rows or cols.  vec:
// 16-byte aligned rows and col0, so four columns come in one load.
__device__ __forceinline__ void stage_f32(float* dst, int ldd, const float* src, int R, int row0,
                                          int rows, int col0, int W, int cols, int ld,
                                          const float* scale, bool vec) {
  const int W4 = (W + 3) / 4;
  for (int e = threadIdx.x; e < R * W4; e += kThreads) {
    const int i = e / W4, j = 4 * (e % W4);
    const int row = row0 + i, col = col0 + j;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (row < rows) {
      const float* p = src + static_cast<size_t>(row) * ld + col;
      if (vec && col + 4 <= cols) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(p));
        v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (col + k < cols) v[k] = p[k];
      }
      if (scale) {
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] *= scale[row];
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (j + k < W) dst[i * ldd + j + k] = v[k];
  }
}

// (I, J), J <= I, of the t-th tile of a lower triangle taken row by row
__device__ __forceinline__ void tri_index(int t, int& I, int& J) {
  int i = static_cast<int>((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  while ((i + 1) * (i + 2) / 2 <= t) ++i;
  while (i * (i + 1) / 2 > t) --i;
  I = i;
  J = t - i * (i + 1) / 2;
}

// The inclusive cumulative log-decay of chunk steps [0, Q) into lds (and dt
// into dts), summed in f64 and rounded once to f32, as the plain version does:
// at mamba2's init |l| reaches several hundred within a chunk, and an ulp of
// it moves exp(l_i - l_j).  Every thread of the block calls it, with d0 =
// dth[threadIdx.x] (0 past Q) loaded ahead.
__device__ __forceinline__ void chunk_scan(const float* __restrict__ dth, float d0, float A,
                                           int Q, float* dts, float* lds, double* red) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  double carry = 0.0;
  for (int q0 = 0; q0 < Q; q0 += kThreads) {
    const int q = q0 + t;
    double v = 0.0;
    if (q < Q) {
      const float d = q0 == 0 ? d0 : dth[q];
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
    if (q < Q) lds[q] = static_cast<float>(v + off);
    carry = tot;
    __syncthreads();
  }
}

// shared-memory layouts, host and device
struct StatesLayout {
  int scan, ring, stage, bytes;   // byte offsets; ring stage size
};

__host__ __device__ inline StatesLayout states_layout(bool mma, int P, int N, int Q) {
  StatesLayout L;
  L.scan = kWarps * 8;                                  // red[kWarps] doubles first
  L.ring = align128(L.scan + 3 * Q * 4);                // dts, lds, seg
  if (mma) {
    const int chn = 1 << row_lg(2 * ((N + 15) / 16));
    const int chp = 1 << row_lg(2 * ((P + 15) / 16));
    L.stage = kTile * (chn + chp) * 16;                 // T(seg o B) rows, T(x dt) rows
    L.bytes = L.ring + 2 * L.stage;
  } else {
    L.stage = (kTile * (kTile + 1) + kTile * P) * 4;    // seg o B, x dt (f32)
    L.bytes = L.ring + L.stage;
  }
  return L;
}

struct YLayout {
  int cs, sh, sl, ring, stage, stages, bytes;
};

__host__ __device__ inline YLayout y_layout(bool mma, int P, int N, int Q) {
  YLayout L;
  L.cs = align128(2 * Q * 4);                           // lds, dts first
  if (mma) {
    const int nk = (N + 15) / 16;
    const int chn = 1 << row_lg(2 * nk), chp = 1 << row_lg(2 * ((P + 15) / 16));
    L.sh = L.cs + kRowsY * chn * 16;                    // C rows
    L.sl = L.sh + 16 * nk * chp * 16;                   // state hi, [n][p]
    L.ring = L.sl + 16 * nk * chp * 16;                 // state lo, right after hi
    L.stage = kRowsY * (kColsY / 8) * 16 + kColsY * chp * 16;   // M tile, x tile
    L.stages = Q > kColsY ? 2 : 1;
    L.bytes = L.ring + L.stages * L.stage;
  } else {
    L.sh = L.cs + kTile * (N + 1) * 4;                  // C rows (f32)
    L.sl = L.sh + N * P * 4;                            // state (f32)
    L.ring = L.sl;                                      // no lo term
    L.stage = (kTile * (kTile + 1) + kTile * P) * 4;    // (C.B^T o L) tile, x dt tile
    L.stages = 1;
    L.bytes = L.ring + L.stage;
  }
  return L;
}

__host__ __device__ inline int cb_bytes(bool mma, int N) {
  return mma ? 2 * kTile * (1 << row_lg(2 * ((N + 15) / 16))) * 16 : 2 * kTile * (N + 1) * 4;
}

// ---------------------------------------------------------------------------
// ssd_cb: C . B^T of one group and chunk, a 64 x 64 tile (I, J), J <= I, a
// block; grid (tiles x chunks, BG)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(128)
ssd_cb_mma(const bf16* __restrict__ B, const bf16* __restrict__ C, bf16* __restrict__ cb, int S,
           int N, int Q, int ntri, bool vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int nk = (N + 15) / 16, lg = row_lg(2 * nk);
  unsigned char* cs = smem;
  unsigned char* bs = smem + (kTile << lg) * 16;
  int I, J;
  tri_index(blockIdx.x % ntri, I, J);
  const int c = blockIdx.x / ntri, g = blockIdx.y, nc = S / Q;
  const size_t chunk0 = (static_cast<size_t>(g) * S + static_cast<size_t>(c) * Q) * N;
  load_tile(cs, C + chunk0, kTile, kTile * I, Q, N, N, 2 * nk, lg, vec, 128);
  load_tile(bs, B + chunk0, kTile, kTile * J, Q, N, N, 2 * nk, lg, vec, 128);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[nt][k] = 0.f;
  const uint32_t ca = smem_addr(cs), ba = smem_addr(bs);
  for (int ks = 0; ks < nk; ++ks) {
    uint32_t a[4];
    ldmatrix_x4(a, ca + swz(16 * warp + (lane & 15), 2 * ks + (lane >> 4), lg));
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, ba + swz(16 * np + ((lane >> 4) << 3) + (lane & 7),
                              2 * ks + ((lane >> 3) & 1), lg));
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
  bf16* out = cb + (static_cast<size_t>(g) * nc + c) * Q * Q;
  const int r = kTile * I + 16 * warp + (lane >> 2);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int j = kTile * J + 8 * nt + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = r + 8 * h;
      if (i < Q && j < Q)
        store_pair(out + static_cast<size_t>(i) * Q + j, acc[nt][2 * h], acc[nt][2 * h + 1],
                   Q - j);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
ssd_cb_simt(const float* __restrict__ B, const float* __restrict__ C, float* __restrict__ cb,
            int S, int N, int Q, int ntri, bool vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int N1 = N + 1;
  float* cs = reinterpret_cast<float*>(smem);
  float* bs = cs + kTile * N1;
  int I, J;
  tri_index(blockIdx.x % ntri, I, J);
  const int c = blockIdx.x / ntri, g = blockIdx.y, nc = S / Q;
  const size_t chunk0 = (static_cast<size_t>(g) * S + static_cast<size_t>(c) * Q) * N;
  stage_f32(cs, N1, C + chunk0, kTile, kTile * I, Q, 0, N, N, N, nullptr, vec);
  stage_f32(bs, N1, B + chunk0, kTile, kTile * J, Q, 0, N, N, N, nullptr, vec);
  __syncthreads();

  const int ti = threadIdx.x / 16, tj = threadIdx.x % 16;
  float acc[4][4] = {};
  for (int n = 0; n < N; ++n) {
    float cv[4], bv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) cv[a] = cs[(ti + 16 * a) * N1 + n];
#pragma unroll
    for (int b = 0; b < 4; ++b) bv[b] = bs[(tj + 16 * b) * N1 + n];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(cv[a], bv[b], acc[a][b]);
  }
  float* out = cb + (static_cast<size_t>(g) * nc + c) * Q * Q;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = kTile * I + ti + 16 * a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = kTile * J + tj + 16 * b;
      if (i < Q && j < Q) out[static_cast<size_t>(i) * Q + j] = acc[a][b];
    }
  }
}

// ---------------------------------------------------------------------------
// ssd_states: the log-decay scan and the chunk's own end state
// W[h, c] = sum_j exp(l_Q - l_j) B_j xdt_j^T, (N, P) f32; grid (chunks, BH)
// ---------------------------------------------------------------------------

// Warp w owns state rows 16 (w + kWarps t) .., t < MT, and every column of
// the (N, P) end state: MT is 1 for N <= 128, 2 up to 256
template <int MT>
__global__ void __launch_bounds__(kThreads, MT == 1 ? 3 : 2)
ssd_states_mma(const bf16* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a_log, const bf16* __restrict__ B,
               float* __restrict__ lw, float* __restrict__ W, int S, int P, int N, int Q,
               int rep, bool vec_x, bool vec_b) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int nk = (N + 15) / 16, pk = (P + 15) / 16;
  const int lgn = row_lg(2 * nk), lgp = row_lg(2 * pk);
  const StatesLayout L = states_layout(true, P, N, Q);
  double* red = reinterpret_cast<double*>(smem);
  float* dts = reinterpret_cast<float*>(smem + L.scan);
  float* lds = dts + Q;
  float* seg = lds + Q;
  unsigned char* ring = smem + L.ring;
  const int xoff = (kTile << lgn) * 16;   // the x rows after the B rows of a stage

  const int c = blockIdx.x, bh = blockIdx.y, nc = S / Q;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t row0 = static_cast<size_t>(bh) * S + static_cast<size_t>(c) * Q;
  const bf16* xc = x + row0 * P;
  const bf16* bc = B + (static_cast<size_t>(bh / rep) * S + static_cast<size_t>(c) * Q) * N;
  const int steps = (Q + kTile - 1) / kTile;
  auto issue = [&](int s) {   // steps of kTile rows: B rows and x rows
    if (s < steps) {
      unsigned char* st = ring + (s & 1) * L.stage;
      load_tile(st, bc, kTile, kTile * s, Q, N, N, 2 * nk, lgn, vec_b, kThreads);
      load_tile(st + xoff, xc, kTile, kTile * s, Q, P, P, 2 * pk, lgp, vec_x, kThreads);
    }
    cp_async_commit();
  };
  const float d0 = static_cast<int>(threadIdx.x) < Q ? dt[row0 + threadIdx.x] : 0.f;
  issue(0);   // both stages in flight during the scan
  issue(1);

  chunk_scan(dt + row0, d0, -expf(a_log[bh]), Q, dts, lds, red);
  for (int q = threadIdx.x; q < Q; q += kThreads) {
    lw[row0 + q] = lds[q];
    seg[q] = expf(lds[Q - 1] - lds[q]);
  }

  float acc[MT][4][2][4];
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int np = 0; np < 4; ++np)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[t][np][h][r] = 0.f;
  // this lane's row and chunk in the 8 x 8 blocks of an ldmatrix.trans: the
  // A operand (seg o B)^T and the B operand xdt are both stored step-major
  const int arow = (lane & 7) + ((lane >> 4) << 3), acol = (lane >> 3) & 1;
  const int brow = (lane & 7) + (((lane >> 3) & 1) << 3), bcol = lane >> 4;

  for (int s0 = 0; s0 < steps; s0 += 2) {
    cp_async_wait<0>();
    __syncthreads();
    // T(seg o B) and T(x dt), in place, over both stages
    for (int e = threadIdx.x; e < (2 * kTile) << lgn; e += kThreads) {
      const int rr = e >> lgn, cc = e & ((1 << lgn) - 1);
      const int st = rr / kTile, i = rr % kTile, q = kTile * (s0 + st) + i;
      if (cc < 2 * nk && s0 + st < steps && q < Q)
        scale_chunk(ring + st * L.stage + swz(i, cc, lgn), seg[q]);
    }
    for (int e = threadIdx.x; e < (2 * kTile) << lgp; e += kThreads) {
      const int rr = e >> lgp, cc = e & ((1 << lgp) - 1);
      const int st = rr / kTile, i = rr % kTile, q = kTile * (s0 + st) + i;
      if (cc < 2 * pk && s0 + st < steps && q < Q)
        scale_chunk(ring + st * L.stage + xoff + swz(i, cc, lgp), dts[q]);
    }
    __syncthreads();
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      const int s = s0 + st;
      if (s >= steps) break;
      const uint32_t ba = smem_addr(ring + st * L.stage), xa = ba + xoff;
#pragma unroll
      for (int ks = 0; ks < kTile / 16; ++ks) {
        const int q1 = kTile * s + 16 * ks;
        if (q1 >= Q) break;
        // 16 steps whose decays all underflow to 0 add exactly 0
        if (__all_sync(0xffffffffu, seg[min(q1 + (lane & 15), Q - 1)] == 0.f)) continue;
        uint32_t b[4][4];
#pragma unroll
        for (int np = 0; np < 4; ++np)
          if (np < pk) ldmatrix_x4_trans(b[np], xa + swz(16 * ks + brow, 2 * np + bcol, lgp));
#pragma unroll
        for (int t = 0; t < MT; ++t) {
          const int mt = warp + kWarps * t;
          if (mt >= nk) break;
          uint32_t a[4];
          ldmatrix_x4_trans(a, ba + swz(16 * ks + arow, 2 * mt + acol, lgn));
#pragma unroll
          for (int np = 0; np < 4; ++np)
            if (np < pk) {
              mma_bf16(acc[t][np][0], a, b[np][0], b[np][1]);
              mma_bf16(acc[t][np][1], a, b[np][2], b[np][3]);
            }
        }
      }
    }
    if (s0 + 2 < steps) {
      __syncthreads();   // both stages are refilled
      issue(s0 + 2);
      issue(s0 + 3);
    }
  }

  float* wc = W + (static_cast<size_t>(bh) * nc + c) * N * P;
#pragma unroll
  for (int t = 0; t < MT; ++t) {
    const int mt = warp + kWarps * t;
    if (mt >= nk) break;
#pragma unroll
    for (int np = 0; np < 4; ++np)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = 16 * np + 8 * half + 2 * (lane & 3);
        if (np >= pk || p >= P) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = 16 * mt + (lane >> 2) + 8 * h;
          if (n < N)
            store_pair(wc + static_cast<size_t>(n) * P + p, acc[t][np][half][2 * h],
                       acc[t][np][half][2 * h + 1], P - p);
        }
      }
  }
}

__global__ void __launch_bounds__(kThreads)
ssd_states_simt(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a_log, const float* __restrict__ B,
                float* __restrict__ lw, float* __restrict__ W, int S, int P, int N, int Q,
                int rep, bool vec_x, bool vec_b) {
  extern __shared__ __align__(128) unsigned char smem[];
  const StatesLayout L = states_layout(false, P, N, Q);
  constexpr int T1 = kTile + 1;
  double* red = reinterpret_cast<double*>(smem);
  float* dts = reinterpret_cast<float*>(smem + L.scan);
  float* lds = dts + Q;
  float* seg = lds + Q;
  float* bs = reinterpret_cast<float*>(smem + L.ring);   // [kTile steps][T1]
  float* xs = bs + kTile * T1;                           // [kTile steps][P]

  const int c = blockIdx.x, bh = blockIdx.y, nc = S / Q;
  const size_t row0 = static_cast<size_t>(bh) * S + static_cast<size_t>(c) * Q;
  const float* xc = x + row0 * P;
  const float* bc = B + (static_cast<size_t>(bh / rep) * S + static_cast<size_t>(c) * Q) * N;
  chunk_scan(dt + row0, static_cast<int>(threadIdx.x) < Q ? dt[row0 + threadIdx.x] : 0.f,
             -expf(a_log[bh]), Q, dts, lds, red);
  for (int q = threadIdx.x; q < Q; q += kThreads) {
    lw[row0 + q] = lds[q];
    seg[q] = expf(lds[Q - 1] - lds[q]);
  }
  __syncthreads();

  const int ti = threadIdx.x / 16, tj = threadIdx.x % 16;
  float* wc = W + (static_cast<size_t>(bh) * nc + c) * N * P;
  for (int n0 = 0; n0 < N; n0 += kTile) {
    float u[4][4] = {};
    for (int q0 = 0; q0 < Q; q0 += kTile) {
      stage_f32(bs, T1, bc, kTile, q0, Q, n0, kTile, N, N, seg, vec_b);
      stage_f32(xs, P, xc, kTile, q0, Q, 0, P, P, P, dts, vec_x);
      __syncthreads();
      for (int jj = 0; jj < kTile; ++jj) {
        float bv[4], xv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) bv[a] = bs[jj * T1 + ti + 16 * a];
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
      __syncthreads();
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int n = n0 + ti + 16 * a;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int p = tj + 16 * b;
        if (n < N && p < P) wc[static_cast<size_t>(n) * P + p] = u[a][b];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// ssd_pass: per head, s_{c+1} = exp(l_Q of chunk c) s_c + W[c], and the
// final state; grid (state chunks / kThreads, BH), the heads taken last
// first.  Each thread walks one chunk of 8 entries of a state row through
// the chunks, the loads of 8 chunks in flight together.  SPLIT (bf16): the
// state entering chunk c is written split into bf16 hi + lo, in the
// swizzled [state row][p] tiles ssd_y_mma copies as they are (Sin: per head
// and chunk the hi tile, then the lo tile, of 16 nk rows x 2^lgp chunks,
// zeros in the padding); otherwise W[c] is replaced by it, in f32.
// ---------------------------------------------------------------------------

template <bool SPLIT>
__global__ void __launch_bounds__(kThreads)
ssd_pass(const float* __restrict__ lw, float* __restrict__ W, unsigned char* __restrict__ Sin,
         float* __restrict__ state, int S, int P, int N, int Q) {
  constexpr int kBatch = SPLIT ? 8 : 4;   // f32: within the registers of a 2-block SM
  const int nk = (N + 15) / 16, lgp = row_lg(2 * ((P + 15) / 16));
  const int rows = SPLIT ? 16 * nk : N;                    // state rows walked
  const int lg = SPLIT ? lgp : row_lg((P + 7) / 8);        // 2^lg chunks of 8 a row
  // the heads last first: ssd_states wrote their chunk states last, so they
  // are the likeliest still in L2
  const int bh = gridDim.y - 1 - blockIdx.y, nc = S / Q;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= (rows << lg)) return;
  const int n = e >> lg, cp = e & ((1 << lg) - 1), p0 = 8 * cp;
  const int NP = N * P;
  const bool live = n < N && p0 < P, vec = P % 8 == 0;
  const int tile = (16 * nk) << lgp;                       // chunks of one bf16 tile
  float* w = W + static_cast<size_t>(bh) * nc * NP + static_cast<size_t>(n) * P + p0;
  const float* lq = lw + static_cast<size_t>(bh) * S + Q - 1;
  float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int c0 = 0; c0 < nc; c0 += kBatch) {
    float v[kBatch][8], d[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int c = c0 + u;
      if (c >= nc) break;
      const float* p = w + static_cast<size_t>(c) * NP;
#pragma unroll
      for (int k = 0; k < 8; ++k) v[u][k] = 0.f;
      if (live && vec) {
        const float4 a = reinterpret_cast<const float4*>(p)[0];
        const float4 b = reinterpret_cast<const float4*>(p)[1];
        v[u][0] = a.x, v[u][1] = a.y, v[u][2] = a.z, v[u][3] = a.w;
        v[u][4] = b.x, v[u][5] = b.y, v[u][6] = b.z, v[u][7] = b.w;
      } else if (live) {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (p0 + k < P) v[u][k] = p[k];
      }
      d[u] = expf(lq[static_cast<size_t>(c) * Q]);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int c = c0 + u;
      if (c >= nc) break;
      if constexpr (SPLIT) {
        uint4 hi, lo;
        uint32_t* h = reinterpret_cast<uint32_t*>(&hi);
        uint32_t* l = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float h0 = rbf(s[2 * k]), h1 = rbf(s[2 * k + 1]);
          h[k] = pack_bf16(h0, h1);
          l[k] = pack_bf16(s[2 * k] - h0, s[2 * k + 1] - h1);
        }
        unsigned char* t =
            Sin + (static_cast<size_t>(bh) * nc + c) * 2 * tile * 16 + swz(n, cp, lgp);
        *reinterpret_cast<uint4*>(t) = hi;
        *reinterpret_cast<uint4*>(t + tile * 16) = lo;
      } else if (live && vec) {
        float4* p = reinterpret_cast<float4*>(w + static_cast<size_t>(c) * NP);
        p[0] = make_float4(s[0], s[1], s[2], s[3]);
        p[1] = make_float4(s[4], s[5], s[6], s[7]);
      } else if (live) {
        float* p = w + static_cast<size_t>(c) * NP;
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (p0 + k < P) p[k] = s[k];
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) s[k] = fmaf(d[u], s[k], v[u][k]);
    }
  }
  if (live) {
    float* out = state + static_cast<size_t>(bh) * NP + static_cast<size_t>(n) * P + p0;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (p0 + k < P) out[k] = s[k];
  }
}

// ---------------------------------------------------------------------------
// ssd_y: y of kRowsY rows of one chunk of one head; grid (row tiles x chunks,
// BH), the chunks taken last first (the states written last are the likeliest
// still in L2)
// ---------------------------------------------------------------------------

// Warp w owns rows 16 w .. 16 w + 15 of the block's kRowsY and every column
// of y
__global__ void __launch_bounds__(kThreads, 2)
ssd_y_mma(const bf16* __restrict__ x, const float* __restrict__ dt, const bf16* __restrict__ C,
          const bf16* __restrict__ cb, const float* __restrict__ lw,
          const unsigned char* __restrict__ Sin, bf16* __restrict__ y, int S, int P, int N,
          int Q, int rep, bool vec_x, bool vec_c, bool vec_cb, bool vec_l) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int nk = (N + 15) / 16, pk = (P + 15) / 16;
  const int lgn = row_lg(2 * nk), lgp = row_lg(2 * pk);
  const YLayout L = y_layout(true, P, N, Q);
  float* lds = reinterpret_cast<float*>(smem);
  float* dts = lds + Q;
  unsigned char* cs = smem + L.cs;
  unsigned char* sh = smem + L.sh;
  unsigned char* sl = smem + L.sl;
  unsigned char* ring = smem + L.ring;
  constexpr int kLgM = 4;                          // an M tile row: 16 chunks (kColsY)
  constexpr int kMBytes = (kRowsY << kLgM) * 16;   // a stage's M tile

  const int nt = (Q + kRowsY - 1) / kRowsY, nc = S / Q;
  const int i0 = kRowsY * (blockIdx.x % nt);
  const int c = nc - 1 - static_cast<int>(blockIdx.x / nt);
  const int bh = blockIdx.y, g = bh / rep;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rows_hi = min(Q, i0 + kRowsY);   // chunk rows [0, rows_hi) are read
  const int nJ = (rows_hi + kColsY - 1) / kColsY;
  const size_t row0 = static_cast<size_t>(bh) * S + static_cast<size_t>(c) * Q;
  const bf16* xc = x + row0 * P;
  const bf16* cbc = cb + (static_cast<size_t>(g) * nc + c) * Q * Q;
  const bool has_state = c > 0;

  // every load of the block is issued before any is used: the entering
  // state's hi and lo tiles (written by ssd_pass in this layout) and the C
  // rows (both only past the first chunk), the first two column tiles of
  // C.B^T and their x rows
  if (has_state) {
    const int bytes = 2 * ((16 * nk) << lgp) * 16;   // sh, then sl
    const unsigned char* src = Sin + (static_cast<size_t>(bh) * nc + c) * bytes;
    for (int e = threadIdx.x; e < bytes / 16; e += kThreads)
      cp_async16(smem_addr(sh + 16 * e), src + 16 * e);
  }
  // l and dt of chunk rows [0, rows_hi), in the C rows' group when their
  // rows are whole 16-byte chunks, else by plain loads
  if (vec_l) {
    for (int e = threadIdx.x; e < rows_hi / 2; e += kThreads) {
      const int q = 4 * (e >> 1);
      cp_async16(smem_addr((e & 1) ? dts + q : lds + q), ((e & 1) ? dt : lw) + row0 + q);
    }
  } else {
    for (int q = threadIdx.x; q < rows_hi; q += kThreads) {
      lds[q] = lw[row0 + q];
      dts[q] = dt[row0 + q];
    }
  }
  if (has_state)
    load_tile(cs, C + (static_cast<size_t>(g) * S + static_cast<size_t>(c) * Q) * N, kRowsY,
              i0, Q, N, N, 2 * nk, lgn, vec_c, kThreads);
  cp_async_commit();
  auto issue = [&](int J) {   // column tile J: its C.B^T block and its x rows
    if (J < nJ) {
      unsigned char* st = ring + (J % L.stages) * L.stage;
      load_tile(st, cbc + kColsY * J, kRowsY, i0, Q, Q - kColsY * J, Q, 1 << kLgM, kLgM,
                vec_cb, kThreads);
      load_tile(st + kMBytes, xc, kColsY, kColsY * J, Q, P, P, 2 * pk, lgp, vec_x, kThreads);
    }
    cp_async_commit();
  };
  issue(0);
  issue(1);

  float acc[4][2][4];
#pragma unroll
  for (int np = 0; np < 4; ++np)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[np][h][r] = 0.f;
  const int wr = 16 * warp;                  // the warp's first row in the tile
  const int ra = i0 + wr + (lane >> 2);      // this lane's chunk rows: ra, ra + 8
  const bool live = i0 + wr < Q;
  // this lane's row and chunk in the 8 x 8 blocks of an ldmatrix: A row-major
  // (C rows, M rows), B through .trans (state rows, x rows)
  const int arow = lane & 15, acol = lane >> 4;
  const int brow = (lane & 7) + (((lane >> 3) & 1) << 3), bcol = lane >> 4;

  for (int J = 0; J < nJ; ++J) {
    cp_async_wait<1>();   // every group but the newest: the C rows and column tile J
    __syncthreads();
    unsigned char* mt_tile = ring + (J % L.stages) * L.stage;
    unsigned char* xt = mt_tile + kMBytes;
    const int jt = kColsY * J;
    // T(x dt), and M = T(T(C.B^T) * T(exp(l_i - l_j))) where i >= j, else 0,
    // both in place: the exp only where i >= j, above the diagonal it overflows
    for (int e = threadIdx.x; e < kColsY << lgp; e += kThreads) {
      const int r = e >> lgp, cc = e & ((1 << lgp) - 1), q = jt + r;
      if (cc < 2 * pk && q < Q) scale_chunk(xt + swz(r, cc, lgp), dts[q]);
    }
    // the tile that holds the diagonal: only the chunks the triangle reads,
    // 16 (2m + 2) of row block m, from 16 m (m + 1) on, column by column
    const bool diag = jt == i0;
    for (int e = threadIdx.x; e < (diag ? 16 * 72 : kRowsY << kLgM); e += kThreads) {
      int r, cc;
      if (diag) {
        int m = 0;
        while (16 * (m + 1) * (m + 2) <= e) ++m;
        const int local = e - 16 * m * (m + 1);
        r = 16 * m + (local & 15);
        cc = local >> 4;
      } else {
        r = e >> kLgM;
        cc = e & ((1 << kLgM) - 1);
      }
      const int i = i0 + r, j0 = jt + 8 * cc;
      uint4* ptr = reinterpret_cast<uint4*>(mt_tile + swz(r, cc, kLgM));
      if (i >= Q || j0 > i) {
        *ptr = make_uint4(0, 0, 0, 0);
        continue;
      }
      uint4 val = *ptr;
      uint32_t* w = reinterpret_cast<uint32_t*>(&val);
      const float li = lds[i];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = j0 + 2 * k;
        // T(exp) of both, then T(cb * T(exp)) in one bf16x2 multiply (the
        // product of two bf16 values rounded once); above the diagonal the
        // exp may overflow, and the mask sets those entries to 0
        const __nv_bfloat162 d2 =
            __floats2bfloat162_rn(__expf(li - lds[j]), __expf(li - lds[j + 1]));
        const __nv_bfloat162 m2 =
            __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&w[k]), d2);
        uint32_t m = *reinterpret_cast<const uint32_t*>(&m2);
        if (j > i) m &= 0xffff0000u;
        if (j + 1 > i) m &= 0x0000ffffu;
        w[k] = m;
      }
      *ptr = val;
    }
    __syncthreads();

    // (C o exp(l)) . s_in = exp(l) o (C . hi + C . lo), once, before the
    // triangle; skipped by a warp whose rows all have exp(l) = 0 (underflow),
    // where the term is exactly 0
    const float e0 = ra < Q ? expf(lds[ra]) : 0.f;
    const float e1 = ra + 8 < Q ? expf(lds[ra + 8]) : 0.f;
    if (J == 0 && has_state && live && !__all_sync(0xffffffffu, e0 == 0.f && e1 == 0.f)) {
      const uint32_t ca = smem_addr(cs), ha = smem_addr(sh), la = smem_addr(sl);
      for (int ks = 0; ks < nk; ++ks) {
        uint32_t a[4];
        ldmatrix_x4(a, ca + swz(wr + arow, 2 * ks + acol, lgn));
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          if (np >= pk) break;
          uint32_t b[4];
          ldmatrix_x4_trans(b, ha + swz(16 * ks + brow, 2 * np + bcol, lgp));
          mma_bf16(acc[np][0], a, b[0], b[1]);
          mma_bf16(acc[np][1], a, b[2], b[3]);
          ldmatrix_x4_trans(b, la + swz(16 * ks + brow, 2 * np + bcol, lgp));
          mma_bf16(acc[np][0], a, b[0], b[1]);
          mma_bf16(acc[np][1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int np = 0; np < 4; ++np)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          acc[np][h][0] *= e0, acc[np][h][1] *= e0;
          acc[np][h][2] *= e1, acc[np][h][3] *= e1;
        }
    }

    // M . xdt over this column tile, up to the diagonal
    if (live) {
      const uint32_t ma = smem_addr(mt_tile), xa = smem_addr(xt);
      const int last = min(i0 + wr + 15, rows_hi - 1);   // the warp's last row
#pragma unroll 2
      for (int ks = 0; ks < kColsY / 16; ++ks) {
        if (jt + 16 * ks > last) break;
        uint32_t a[4];
        ldmatrix_x4(a, ma + swz(wr + arow, 2 * ks + acol, kLgM));
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          if (np >= pk) break;
          uint32_t b[4];
          ldmatrix_x4_trans(b, xa + swz(16 * ks + brow, 2 * np + bcol, lgp));
          mma_bf16(acc[np][0], a, b[0], b[1]);
          mma_bf16(acc[np][1], a, b[2], b[3]);
        }
      }
    }
    if (J + 2 < nJ) {
      __syncthreads();   // this stage is refilled
      issue(J + 2);
    } else {
      cp_async_commit();
    }
  }

  bf16* yc = y + row0 * P;
#pragma unroll
  for (int np = 0; np < 4; ++np)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = 16 * np + 8 * half + 2 * (lane & 3);
      if (np >= pk || p >= P) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = ra + 8 * h;
        if (i < Q)
          store_pair(yc + static_cast<size_t>(i) * P + p, acc[np][half][2 * h],
                     acc[np][half][2 * h + 1], P - p);
      }
    }
}

__global__ void __launch_bounds__(kThreads)
ssd_y_simt(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ C, const float* __restrict__ cb,
           const float* __restrict__ lw, const float* __restrict__ W, float* __restrict__ y,
           int S, int P, int N, int Q, int rep, bool vec_x, bool vec_c) {
  extern __shared__ __align__(128) unsigned char smem[];
  const YLayout L = y_layout(false, P, N, Q);
  constexpr int T1 = kTile + 1;
  const int N1 = N + 1;
  float* lds = reinterpret_cast<float*>(smem);
  float* dts = lds + Q;
  float* cs = reinterpret_cast<float*>(smem + L.cs);      // [kTile rows][N1]
  float* st = reinterpret_cast<float*>(smem + L.sh);      // [N][P]
  float* mt = reinterpret_cast<float*>(smem + L.ring);    // [kTile rows][T1]
  float* xs = mt + kTile * T1;                            // [kTile steps][P]

  const int nt = (Q + kTile - 1) / kTile, nc = S / Q;
  const int i0 = kTile * (blockIdx.x % nt);
  const int c = nc - 1 - static_cast<int>(blockIdx.x / nt);
  const int bh = blockIdx.y, g = bh / rep;
  const int rows_hi = min(Q, i0 + kTile);
  const size_t row0 = static_cast<size_t>(bh) * S + static_cast<size_t>(c) * Q;
  const float* xc = x + row0 * P;
  const float* cbc = cb + (static_cast<size_t>(g) * nc + c) * Q * Q;
  const bool has_state = c > 0;

  for (int q = threadIdx.x; q < rows_hi; q += kThreads) {
    lds[q] = lw[row0 + q];
    dts[q] = dt[row0 + q];
  }
  stage_f32(cs, N1, C + (static_cast<size_t>(g) * S + static_cast<size_t>(c) * Q) * N, kTile,
            i0, Q, 0, N, N, N, nullptr, vec_c);
  if (has_state)
    stage_f32(st, P, W + (static_cast<size_t>(bh) * nc + c) * N * P, N, 0, N, 0, P, P, P,
              nullptr, P % 4 == 0);
  __syncthreads();

  const int ti = threadIdx.x / 16, tj = threadIdx.x % 16;
  float acc[4][4] = {};
  if (has_state) {
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
      const float el = i < Q ? expf(lds[i]) : 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] *= el;
    }
  }

  for (int j0 = 0; j0 < rows_hi; j0 += kTile) {
    for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
      const int r = e / kTile, k = e % kTile;
      const int i = i0 + r, j = j0 + k;
      // the exp only where i >= j: above the diagonal it overflows
      mt[r * T1 + k] = (i >= j && i < Q)
                           ? cbc[static_cast<size_t>(i) * Q + j] * expf(lds[i] - lds[j])
                           : 0.f;
    }
    stage_f32(xs, P, xc, kTile, j0, Q, 0, P, P, P, dts, vec_x);
    __syncthreads();
    for (int jj = 0; jj < kTile; ++jj) {
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
    __syncthreads();
  }

  float* yc = y + row0 * P;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ti + 16 * a;
    if (i >= Q) continue;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int p = tj + 16 * b;
      if (p < P) yc[static_cast<size_t>(i) * P + p] = acc[a][b];
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

struct Grid {
  int cb, states, pass, y;   // blocks of each launch
  dim3 g_cb, g_states, g_pass, g_y;
};

Grid grid(bool mma, int BH, int BG, int S, int P, int N, int Q) {
  const int nc = S / Q, t64 = (Q + kTile - 1) / kTile;
  const int ntri = t64 * (t64 + 1) / 2;
  const int ty = (Q + (mma ? kRowsY : kTile) - 1) / (mma ? kRowsY : kTile);
  Grid G;
  G.g_cb = dim3(ntri * nc, BG);
  G.g_states = dim3(nc, BH);
  G.g_y = dim3(ty * nc, BH);
  // ssd_pass: a thread a chunk of 8 entries of a state row (bf16: of the
  // padded hi / lo tile)
  const int nk = (N + 15) / 16;
  const int pchunks = mma ? (16 * nk) << row_lg(2 * ((P + 15) / 16))
                          : N << row_lg((P + 7) / 8);
  const int np = (pchunks + kThreads - 1) / kThreads;
  G.g_pass = dim3(np, BH);
  G.pass = np * BH;
  G.cb = ntri * nc * BG;
  G.states = nc * BH;
  G.y = ty * nc * BH;
  return G;
}

bool valid(int BH, int BG, int S, int P, int N, int Q) {
  return BH > 0 && BG > 0 && BH % BG == 0 && BH <= 65535 && S > 0 && Q > 0 && S % Q == 0 &&
         P > 0 && P <= kMaxP && N > 0 && N <= kMaxN;
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes, int most) {
  if (bytes > most) return cudaErrorInvalidValue;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  // as much of the SM's 256 KB as shared memory as it takes, so that two
  // blocks of ssd_y (113 KB each at N 128, P 64, chunk <= 128) fit an SM
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <typename T>
int launch(const void* x_, const float* dt, const float* a_log, const void* B_, const void* C_,
           void* y_, float* state, void* cb_, float* lw, float* W, void* Sin_, int BH, int BG,
           int S, int P, int N, int Q, void* stream_) {
  if (!valid(BH, BG, S, P, N, Q)) return static_cast<int>(cudaErrorInvalidValue);
  constexpr bool mma = sizeof(T) == 2;
  const T* x = static_cast<const T*>(x_);
  const T* B = static_cast<const T*>(B_);
  const T* C = static_cast<const T*>(C_);
  T* y = static_cast<T*>(y_);
  T* cb = static_cast<T*>(cb_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  constexpr int W16 = 16 / sizeof(T);   // elements of a 16-byte chunk
  const bool vec_x = P % W16 == 0 && aligned16(x_);
  const bool vec_b = N % W16 == 0 && aligned16(B_) && aligned16(C_);
  const bool vec_cb = Q % W16 == 0 && aligned16(cb_);
  const bool vec_l = S % 4 == 0 && Q % 4 == 0 && aligned16(lw) && aligned16(dt);
  const int rep = BH / BG, nc = S / Q, t64 = (Q + kTile - 1) / kTile;
  const int ntri = t64 * (t64 + 1) / 2;

  int dev = 0, most = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int b_cb = cb_bytes(mma, N);
  const int b_st = states_layout(mma, P, N, Q).bytes;
  const int b_y = y_layout(mma, P, N, Q).bytes;
  const Grid G = grid(mma, BH, BG, S, P, N, Q);

  if constexpr (mma) {
    auto states = (N + 15) / 16 > kWarps ? ssd_states_mma<2> : ssd_states_mma<1>;
    if ((err = allow_smem(ssd_cb_mma, b_cb, most)) != cudaSuccess ||
        (err = allow_smem(states, b_st, most)) != cudaSuccess ||
        (err = allow_smem(ssd_y_mma, b_y, most)) != cudaSuccess)
      return static_cast<int>(err);
    ssd_cb_mma<<<G.g_cb, 128, b_cb, stream>>>(B, C, cb, S, N, Q, ntri, vec_b);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    states<<<G.g_states, kThreads, b_st, stream>>>(x, dt, a_log, B, lw, W, S, P, N, Q, rep,
                                                    vec_x, vec_b);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  } else {
    if ((err = allow_smem(ssd_cb_simt, b_cb, most)) != cudaSuccess ||
        (err = allow_smem(ssd_states_simt, b_st, most)) != cudaSuccess ||
        (err = allow_smem(ssd_y_simt, b_y, most)) != cudaSuccess)
      return static_cast<int>(err);
    ssd_cb_simt<<<G.g_cb, kThreads, b_cb, stream>>>(B, C, cb, S, N, Q, ntri, vec_b);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    ssd_states_simt<<<G.g_states, kThreads, b_st, stream>>>(x, dt, a_log, B, lw, W, S, P, N, Q,
                                                             rep, vec_x, vec_b);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  unsigned char* Sin = static_cast<unsigned char*>(Sin_);
  if constexpr (mma)
    ssd_pass<true><<<G.g_pass, kThreads, 0, stream>>>(lw, W, Sin, state, S, P, N, Q);
  else
    ssd_pass<false><<<G.g_pass, kThreads, 0, stream>>>(lw, W, Sin, state, S, P, N, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if constexpr (mma)
    ssd_y_mma<<<G.g_y, kThreads, b_y, stream>>>(x, dt, C, cb, lw, Sin, y, S, P, N, Q, rep, vec_x,
                                                 vec_b, vec_cb, vec_l);
  else
    ssd_y_simt<<<G.g_y, kThreads, b_y, stream>>>(x, dt, C, cb, lw, W, y, S, P, N, Q, rep, vec_x,
                                                  vec_b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// 0: f32 on the CUDA cores ("simt"), 1: bf16 on the tensor cores ("mma")
int ssd_scan_variant(int is_bf16) { return is_bf16 ? 1 : 0; }

// the blocks of the four launches (ssd_cb, ssd_states, ssd_pass, ssd_y) into
// out[4]; cudaErrorInvalidValue for a shape the kernels do not take
int ssd_scan_blocks(int BH, int BG, int S, int P, int N, int Q, int is_bf16, int* out) {
  if (!valid(BH, BG, S, P, N, Q)) return static_cast<int>(cudaErrorInvalidValue);
  const Grid G = grid(is_bf16 != 0, BH, BG, S, P, N, Q);
  out[0] = G.cb, out[1] = G.states, out[2] = G.pass, out[3] = G.y;
  return 0;
}

// bytes of the split entering states of one head and chunk (bf16: the hi
// and lo tiles ssd_pass writes for ssd_y_mma; f32: 0, they stay in W)
int ssd_scan_state_bytes(int P, int N, int is_bf16) {
  return is_bf16 ? 2 * ((16 * ((N + 15) / 16)) << row_lg(2 * ((P + 15) / 16))) * 16 : 0;
}

#define SSD_ENTRY(NAME, T)                                                                 \
  int NAME(const void* x, const float* dt, const float* a_log, const void* B, const void* C, \
           void* y, float* state, void* cb, float* lw, float* W, void* Sin, int BH, int BG,   \
           int S, int P, int N, int Q, void* stream) {                                     \
    return launch<T>(x, dt, a_log, B, C, y, state, cb, lw, W, Sin, BH, BG, S, P, N, Q,      \
                     stream);                                                              \
  }

SSD_ENTRY(ssd_scan_f32, float)
SSD_ENTRY(ssd_scan_bf16, __nv_bfloat16)

#undef SSD_ENTRY

}  // extern "C"

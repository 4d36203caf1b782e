// Hand-written Hopper (sm_90a) BGMV kernels for mixed-tenant LoRA serving.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/batched_lora/bgmv.py:
//   bgmv_matmul     (_bgmv_kernel, _bgmv_ranked_kernel)          -> bgmv_kernel<T, RT, false, ...>
//   bgmv_mag_matmul (_bgmv_mag_kernel, _bgmv_mag_ranked_kernel)  -> bgmv_kernel<T, RT, true, ...>
// One kernel covers both Pallas variants of each: a null `ranks` pointer
// means full rank.
//
// Per token row (b, s) of x (B, S, d_in), with slot = idx[b]:
//   pairs      y = scale * ((x . A[slot]) . B[slot])
//   magnitude  y = scale * ((((x * a_mag) . a_dir) * (b_mag + dmag[slot])) . b_dir)
// and, with ranks, the rank-r intermediate zeroed at columns >= ranks[slot]
// (after the magnitude product), so a rank-0 slot gives exactly 0; a slot
// outside [0, L) gives a NaN row.  Cast points follow the Pallas bodies: the
// f32 factors are rounded to the activation type before each product, x *
// a_mag is taken in the activation type, the shrink and the expand
// accumulate in f32, the magnitude multiplies the f32 intermediate, h is
// rounded to the activation type before the expand, and y is scaled in f32
// and stored in the activation type.
//
// What bounds it: bytes, and at decode the latency of a launch.  A call does
// 2 * B * S * r * (d_in + d_out) operations on x, the factors and y, which
// it must read and write once each: at decode (B=8, S=1, d=4096, r=8) about
// 1 MFLOP against 128 KB of x and y (bf16) plus one (d_in, r) + (r, d_out)
// f32 pair per distinct slot (256 KB each) -- far below the card's ~295
// operations per byte.  What holds this kernel back is latency: a chain of
// dependent memory round trips and barriers, each worth about a microsecond.
//
// Design.  A token tile (rows that share one set of factors) goes to a
// cluster of blocks (8 at decode, 4 at prefill); block c of the cluster
// takes the c-th slice of d_in for the shrink and the c-th slice of d_out
// for the expand, so a call reads each factor byte once a tile, from many
// SMs at once:
//   1. every load of a pass over the block's d_in slice is issued before any
//      is used: the tile's x rows, A's rows, a_mag, the first B columns (at
//      r 8) and the slot's rank and magnitude; then x (T(x * T(a_mag)) on the
//      magnitude path) and T(A)^T go to shared memory, rows padded so that a
//      16-byte load phase hits distinct banks;
//   2. shrink: a bf16 prefill tile on the tensor cores (MMA: mma.sync
//      m16n8k16 on bf16 x and T(A)^T through ldmatrix, f32 sums; warps split
//      the k steps and their partials are added in warp order); otherwise
//      work items (token, rank column, part of the k chunks), one a thread:
//      an f32 prefill tile's (token, column) pairs, or a decode tile's few
//      tokens split over up to 32 parts that a warp adds by shuffles, each
//      item summing 8 f32 partials, added back in a fixed order;
//   3. each block pushes its partial h into every cluster block's shared
//      memory, one cluster barrier, then each block adds the partials in rank
//      order -- the same sums in the same order in every block, and no
//      atomics, so a CUDA-graph replay equals the eager call bit for bit --
//      and applies the magnitude, the rank mask and the rounding of h;
//   4. expand: each thread holds 2 columns of B (r <= 16; 1 above) and writes
//      them for every token of the tile.
// The kernel comes in two builds a type, bucket and shrink: VEC, for a call
// whose x, factors and y allow 16-byte access and whose r is its bucket's
// width (the model's shape), without the element-wise fallbacks -- a third
// smaller, which is most of a microsecond at decode -- and the general one.
// Variants (bgmv_variant): `decode` for B * S <= kDecodeMaxRows rows -- pairs
// take one cluster per batch row, the magnitude kind one cluster for all
// rows, since its factors are the same for every row -- and `prefill`, tiles
// of kPrefillTok tokens over clusters of 4 (one wave of 16 clusters at x
// (8, 64)): pairs tiles never straddle two batch rows (so they share a
// slot); magnitude tiles run over the flattened rows, since only dmag and
// the rank differ from row to row, and those are read per token.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRank = 64;
constexpr int kMaxCluster = 8;       // most blocks a tile: the d_in / d_out split (portable)
constexpr int kDecodeCluster = 8;    // blocks a `decode` tile
constexpr int kPrefillCluster = 4;   // blocks a `prefill` tile: one wave of 16 at x (8, 64)
constexpr int kTileTok = 32;         // most tokens a tile
constexpr int kDecodeMaxRows = 16;   // B * S at or below which a call takes `decode`
constexpr int kPrefillTok = 32;      // tokens a `prefill` tile
static_assert(kDecodeMaxRows <= kTileTok && kPrefillTok <= kTileTok, "a tile fits the block");

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

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// 16 bytes of T at p, raw, 0 past n values: VEC, one 16-byte load (the
// caller guarantees alignment, and n >= VE or n <= 0); else element by
// element
template <typename T, bool VEC>
__device__ __forceinline__ uint4 load_raw(const T* __restrict__ p, int n) {
  constexpr int VE = 16 / sizeof(T);
  if constexpr (VEC)
    return n >= VE ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0u, 0u, 0u, 0u);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < VE; ++i) {
    if (i >= n) continue;
    if constexpr (sizeof(T) == 2)
      w[i / 2] |= static_cast<uint32_t>(__ldg(reinterpret_cast<const unsigned short*>(p) + i))
                  << (16 * (i % 2));
    else
      w[i] = __float_as_uint(__ldg(reinterpret_cast<const float*>(p) + i));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// value i (a compile-time index) of a raw 16-byte chunk of T, as f32
template <typename T>
__device__ __forceinline__ float elem(const uint4& raw, int i) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  if constexpr (sizeof(T) == 2)
    return __uint_as_float(i % 2 ? w[i / 2] & 0xffff0000u : w[i / 2] << 16);
  else
    return __uint_as_float(w[i]);
}

// T(v * am[i]) for the VE values v of a raw chunk (the magnitude path's
// x * T(a_mag), rounded once to T)
template <typename T>
__device__ __forceinline__ uint4 scale_raw(const uint4& raw, const float* am) {
  uint32_t w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if constexpr (sizeof(T) == 2) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(elem<T>(raw, 2 * q) * am[2 * q],
                                                     elem<T>(raw, 2 * q + 1) * am[2 * q + 1]);
      w[q] = *reinterpret_cast<const uint32_t*>(&v);
    } else {
      w[q] = __float_as_uint(elem<T>(raw, q) * am[q]);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// OC f32 values at p, 0 past n: VEC, one load (n is OC or 0 and p is
// aligned); else element by element
template <int OC, bool VEC>
__device__ __forceinline__ void load_cols(const float* __restrict__ p, int n, float (&v)[OC]) {
  if (VEC && n < OC) {
#pragma unroll
    for (int q = 0; q < OC; ++q) v[q] = 0.f;
  } else if (VEC) {
    static_assert(OC == 1 || OC == 2, "a thread's columns");
    if constexpr (OC == 2) {
      const float2 f = __ldg(reinterpret_cast<const float2*>(p));
      v[0] = f.x, v[1] = f.y;
    } else {
      v[0] = __ldg(p);
    }
  } else {
#pragma unroll
    for (int q = 0; q < OC; ++q) v[q] = q < n ? __ldg(p + q) : 0.f;
  }
}

// B's columns [ob, ob + OC) of rows j < r (0 past r and past o1), raw f32
template <int RT, int OC, bool VEC>
__device__ __forceinline__ void load_b(float (&bv)[RT][OC], const float* __restrict__ Bf,
                                       int d_out, int ob, int o1, int r) {
  const int nv = min(OC, o1 - ob);
#pragma unroll
  for (int j = 0; j < RT; ++j) {
    if (VEC || j < r) {
      load_cols<OC, VEC>(Bf + static_cast<size_t>(j) * d_out + ob, nv, bv[j]);
    } else {
#pragma unroll
      for (int q = 0; q < OC; ++q) bv[j][q] = 0.f;
    }
  }
}

// OC outputs to p as T, n of them: VEC, one store (n is OC or 0 and p is
// aligned); else element by element
template <typename T, int OC, bool VEC>
__device__ __forceinline__ void store_cols(T* __restrict__ p, const float (&s)[OC], int n) {
  alignas(16) T out[OC];
#pragma unroll
  for (int q = 0; q < OC; ++q) out[q] = from_f<T>(s[q]);
  constexpr int BYTES = OC * static_cast<int>(sizeof(T));
  if (VEC && n < OC) return;
  if (VEC) {
    static_assert(BYTES <= 8, "a thread's columns");
    if constexpr (BYTES == 8) {
      *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(out);
    } else if constexpr (BYTES == 4) {
      *reinterpret_cast<uint32_t*>(p) = *reinterpret_cast<const uint32_t*>(out);
    } else {
      *p = out[0];
    }
  } else {
#pragma unroll
    for (int q = 0; q < OC; ++q)
      if (q < n) p[q] = out[q];
  }
}

// smem_addr, ldmatrix_x4 and mma_bf16 are copied from
// src/repro_torch/kernels/fused_dora/csrc/fused_dora.cu (each source builds
// alone)
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// the B fragment of one n-tile (k 16 x n 8) from an n-major tile (k
// contiguous); lanes 0-7 give rows n0 .. n0 + 7 at k0, lanes 8-15 at k0 + 8
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
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

// The block's dynamic shared memory, by offset in bytes.  A pass of `kch`
// rows of d_in: x (the tile's tokens, as T) and T(A)^T (RT rows; bf16 for
// the tensor cores, else f32), each row padded by 16 bytes so that the rows
// of a 16-byte load phase or of an ldmatrix fall on distinct banks; the
// tensor-core shrink's partials across warps; every cluster block's partial
// h (pushed here by each block before the cluster barrier); what each h
// element gets after the sums; T(a_mag) of the pass.  The tile's rounded h,
// f32 [kTileTok][RT], reuses the x rows.
template <bool B, typename X, typename Y> struct Pick { using type = X; };
template <typename X, typename Y> struct Pick<false, X, Y> { using type = Y; };

template <typename T, int RT, bool MMA> struct Smem {
  using AT = typename Pick<MMA, T, float>::type;                     // A^T's type
  static constexpr int ve = 16 / static_cast<int>(sizeof(T));
  static constexpr int xrows = 1024 / static_cast<int>(sizeof(T));   // 32 KB of x a pass
  static constexpr int kch = xrows < 8192 / RT ? xrows : 8192 / RT;   // A^T <= 32 KB
  static constexpr int xstr = kch + ve;                               // x rows, in T
  static constexpr int astr = kch + 16 / static_cast<int>(sizeof(AT)); // A^T rows
  static constexpr int h = kTileTok * RT;                             // h elements
  static constexpr int xs = 0;
  static constexpr int xbytes = kTileTok * xstr * static_cast<int>(sizeof(T));
  static constexpr int at = xs + xbytes;
  static constexpr int red = at + RT * astr * static_cast<int>(sizeof(AT));
  static constexpr int hall = red + (MMA ? kThreads * 4 * 4 : 0);
  static constexpr int mul = hall + kMaxCluster * h * 4;
  static constexpr int keep = mul + h * 4;
  static constexpr int amag = keep + h;
  static constexpr int bytes = amag + kch * 4;
  // loads a thread holds while it stages a pass: x's 16-byte chunks, A's float4
  static constexpr int xpt = kTileTok * kch * static_cast<int>(sizeof(T)) / 16 / kThreads;
  static constexpr int apt = kch * RT / 4 / kThreads;
  static_assert(kch % 16 == 0 && kch * RT / 4 % kThreads == 0 && h % kThreads == 0,
                "pass shape");
  static_assert(h * 4 <= xbytes, "h fits the x rows");
};

struct Params {
  int BS, S, d_in, d_out, r, L;
  int tok, tpr;          // tokens a tile; tiles a batch row (pairs)
  int cluster;           // blocks a tile (the launch's cluster size)
  float scale;
  int va;                // A's rows allow 16-byte loads (r a multiple of 4, aligned)
};

template <typename T, int RT, bool MAG, bool VEC, bool MMA>
__global__ void __launch_bounds__(kThreads, 1)
bgmv_kernel(const T* __restrict__ x,         // (B, S, d_in)
            const float* __restrict__ a,     // pairs: (L, d_in, r); mag: a_dir (d_in, r)
            const float* __restrict__ b,     // pairs: (L, r, d_out); mag: b_dir (r, d_out)
            const float* __restrict__ a_mag, // mag: (d_in,)
            const float* __restrict__ b_mag, // mag: (r,)
            const float* __restrict__ dmag,  // mag: (L, r)
            const int* __restrict__ idx,     // (B,)
            const int* __restrict__ ranks,   // (L,) or nullptr: full rank
            T* __restrict__ y,               // (B, S, d_out)
            Params pr) {
  using M = Smem<T, RT, MMA>;
  using AT = typename M::AT;
  constexpr int VE = M::ve;                  // x elements a 16-byte chunk
  constexpr int KCH = M::kch, XSTR = M::xstr, ASTR = M::astr;
  constexpr int OC = RT <= 16 ? 2 : 1;       // expand: columns a thread, for every token
  constexpr bool kEarlyB = RT <= 8;          // B's registers live through the shrink
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem + M::xs);          // [kTileTok][XSTR]
  AT* at = reinterpret_cast<AT*>(smem + M::at);        // [RT][ASTR]
  float* red = reinterpret_cast<float*>(smem + M::red);      // MMA: [8 warps][32][4]
  float* hall = reinterpret_cast<float*>(smem + M::hall);    // [kMaxCluster][kTileTok * RT]
  float* mul_s = reinterpret_cast<float*>(smem + M::mul);
  signed char* keep_s = reinterpret_cast<signed char*>(smem + M::keep);
  float* am_s = reinterpret_cast<float*>(smem + M::amag);   // T(a_mag) of the pass

  cg::cluster_group cluster = cg::this_cluster();
  const int C = pr.cluster;
  const int c = static_cast<int>(cluster.block_rank());
  const int tile = blockIdx.x / C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int S = pr.S, d_in = pr.d_in, d_out = pr.d_out, r = pr.r;

  int t0, n;   // the tile's rows [t0, t0 + n) of the flattened (B * S)
  if (MAG) {
    t0 = tile * pr.tok;
    n = min(pr.tok, pr.BS - t0);
  } else {
    const int s0 = (tile % pr.tpr) * pr.tok;
    t0 = (tile / pr.tpr) * S + s0;
    n = min(pr.tok, S - s0);
  }
  // this block's slices, each a multiple of 8 long
  const int kc_len = ((d_in + C - 1) / C + 7) & ~7;
  const int k0 = min(d_in, c * kc_len), k1 = min(d_in, k0 + kc_len);
  const int oc_len = ((d_out + C - 1) / C + 7) & ~7;
  const int o0 = min(d_out, c * oc_len), o1 = min(d_out, o0 + oc_len);

  const float* A = a;
  const float* Bf = b;
  int tile_slot = 0;
  if (!MAG) {
    tile_slot = idx[t0 / S];
    if (tile_slot < 0 || tile_slot >= pr.L) {
      // an out-of-range slot reads nothing: the rows come out NaN, so every
      // finiteness check downstream sees them (every block of the cluster
      // reads the same slot and leaves here)
      const int w = o1 - o0;
      for (int e = tid; e < n * w; e += kThreads)
        y[static_cast<size_t>(t0 + e / w) * d_out + o0 + e % w] =
            from_f<T>(__int_as_float(0x7fc00000));
      return;
    }
    A = a + static_cast<size_t>(tile_slot) * d_in * r;
    Bf = b + static_cast<size_t>(tile_slot) * r * d_out;
  }

  // the first pass of B columns, raw, in flight from here (RT <= 8) or from
  // the end of the shrink; rounded where they are used
  const int ob0 = o0 + tid * OC;
  float bv[RT][OC];
  if (kEarlyB) load_b<RT, OC, VEC>(bv, Bf, d_out, ob0, o1, r);

  // what each h element e = tid + i * kThreads gets after the sums: the
  // magnitude (1 for pairs), the rank mask (1 keep, 0 masked) or NaN for an
  // out-of-range slot (-1); the magnitude path's slots read from here
  constexpr int IPT = M::h / kThreads;   // h elements (and shrink items) a thread at most
  int pslot[MAG ? IPT : 1];
  if (MAG) {
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
      const int e = tid + i * kThreads;
      pslot[i] = e < n * RT ? __ldg(idx + (t0 + e / RT) / S) : 0;
    }
  }
  auto meta = [&](int i, float& m) -> int {
    const int e = tid + i * kThreads, j = e % RT;
    const int slot = MAG ? pslot[MAG ? i : 0] : tile_slot;
    m = 1.f;
    if (MAG && (slot < 0 || slot >= pr.L)) return -1;
    if (MAG && j < r) m = __ldg(b_mag + j) + __ldg(dmag + static_cast<size_t>(slot) * r + j);
    return j < (ranks ? min(__ldg(ranks + slot), r) : r);
  };

  // MMA (bf16 prefill): the shrink on the tensor cores: units (m-tile of 16
  // tokens, n-tile of 8 rank columns), each over the pass's k16 steps, WK
  // warps a unit taking every WK-th step (their partials added in warp
  // order after the passes)
  constexpr int kWarps = kThreads / 32;
  constexpr int NT = RT / 8;
  constexpr int UPW = 2 * NT > kWarps ? 2 * NT / kWarps : 1;   // units a warp at most
  const int MT = (n + 15) / 16;
  const int U = MT * NT;
  const int WK = U >= kWarps ? 1 : kWarps / U;
  const int kw = warp % WK, ug = warp / WK, ustep = kWarps / WK;
  float acc[UPW][4];
#pragma unroll
  for (int i = 0; i < UPW; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  // else the shrink on the CUDA cores: items (token t, rank column j, part
  // p of the k chunks): all of a prefill tile's (t, j), one a thread or a
  // few; a decode tile's few tokens split over P parts, P consecutive
  // lanes, added by shuffles
  int log_n = 0;
  while ((1 << log_n) < n) ++log_n;
  constexpr int kLogRT = RT == 8 ? 3 : RT == 16 ? 4 : RT == 32 ? 5 : 6;
  constexpr int kLogThreads = 8;
  static_assert(kThreads == 1 << kLogThreads, "a power of two");
  const int log_p = max(0, kLogThreads - log_n - kLogRT);
  const int P = 1 << log_p;
  const int items = 1 << (log_n + kLogRT + log_p);
  float hsum[IPT];                       // a part-0 lane's sums over the passes
#pragma unroll
  for (int i = 0; i < IPT; ++i) hsum[i] = 0.f;

  bool meta_done = false;
  for (int kb = k0; kb < k1; kb += KCH) {
    const int rows = min(KCH, k1 - kb);
    constexpr int XCH = KCH / VE;      // x chunks a token a pass (a power of two)
    const int nx = n * XCH;
    // every load of the pass in flight at once: x, A and a_mag
    uint4 xr[M::xpt];
#pragma unroll
    for (int i = 0; i < M::xpt; ++i) {
      const int e = tid + i * kThreads, t = e / XCH, k = (e % XCH) * VE;
      xr[i] = e < nx ? load_raw<T, VEC>(x + static_cast<size_t>(t0 + t) * d_in + kb + k, rows - k)
                     : make_uint4(0u, 0u, 0u, 0u);
    }
    float4 av[M::apt];
#pragma unroll
    for (int i = 0; i < M::apt; ++i) {
      const int e = tid + i * kThreads, row = e / (RT / 4), j = 4 * (e % (RT / 4));
      av[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < rows) {
        const float* src = A + static_cast<size_t>(kb + row) * r + j;
        if (VEC || (j + 4 <= r && pr.va)) {
          av[i] = __ldg(reinterpret_cast<const float4*>(src));
        } else {
          if (j < r) av[i].x = __ldg(src);
          if (j + 1 < r) av[i].y = __ldg(src + 1);
          if (j + 2 < r) av[i].z = __ldg(src + 2);
          if (j + 3 < r) av[i].w = __ldg(src + 3);
        }
      }
    }
    float amv[MAG ? (KCH + kThreads - 1) / kThreads : 1];
    if (MAG) {
#pragma unroll
      for (int i = 0; i < (KCH + kThreads - 1) / kThreads; ++i) {
        const int row = tid + i * kThreads;
        amv[i] = row < rows ? __ldg(a_mag + kb + row) : 0.f;
      }
    }
    if (!meta_done) {   // its loads in flight with the pass's
#pragma unroll
      for (int i = 0; i < IPT; ++i) {
        const int e = tid + i * kThreads;
        if (e >= n * RT) break;
        float m;
        keep_s[e] = static_cast<signed char>(meta(i, m));
        mul_s[e] = m;
      }
      meta_done = true;
    }
    if (kb != k0) __syncthreads();   // the previous pass is done with xs, at and am_s
#pragma unroll
    for (int i = 0; i < M::apt; ++i) {
      const int e = tid + i * kThreads, row = e / (RT / 4), j = 4 * (e % (RT / 4));
      at[(j + 0) * ASTR + row] = from_f<AT>(round_to<T>(av[i].x));
      at[(j + 1) * ASTR + row] = from_f<AT>(round_to<T>(av[i].y));
      at[(j + 2) * ASTR + row] = from_f<AT>(round_to<T>(av[i].z));
      at[(j + 3) * ASTR + row] = from_f<AT>(round_to<T>(av[i].w));
    }
    if (MAG) {
#pragma unroll
      for (int i = 0; i < (KCH + kThreads - 1) / kThreads; ++i) {
        const int row = tid + i * kThreads;
        if (row < KCH) am_s[row] = round_to<T>(amv[i]);
      }
      __syncthreads();   // am_s is complete
    }
#pragma unroll
    for (int i = 0; i < M::xpt; ++i) {
      const int e = tid + i * kThreads, t = e / XCH, k = (e % XCH) * VE;
      if (e >= nx) continue;
      *reinterpret_cast<uint4*>(xs + t * XSTR + k) = MAG ? scale_raw<T>(xr[i], am_s + k) : xr[i];
    }
    __syncthreads();

    if constexpr (MMA) {
      const int ks_n = (rows + 15) / 16;   // k16 steps (zeros past the pass's rows)
#pragma unroll
      for (int i = 0; i < UPW; ++i) {
        const int u = ug + i * ustep;
        if (u >= U) break;
        const int mt = u / NT, nt = u % NT;
        const T* xa = xs + (mt * 16 + (lane & 15)) * XSTR + (lane >> 4) * 8;
        const AT* ab = at + (nt * 8 + (lane & 7)) * ASTR + ((lane >> 3) & 1) * 8;
        for (int ks = kw; ks < ks_n; ks += WK) {
          uint32_t af[4], bf[2];
          ldmatrix_x4(af, smem_addr(xa + ks * 16));
          ldmatrix_x2(bf, smem_addr(ab + ks * 16));
          mma_bf16(acc[i], af, bf[0], bf[1]);
        }
      }
    } else {
      const int nch = (rows + 7) / 8;   // chunks of 8 k
#pragma unroll
      for (int i = 0; i < IPT; ++i) {
        const int it = tid + i * kThreads;
        if (it >= items) break;
        const int p = it & (P - 1), j = (it >> log_p) & (RT - 1), t = it >> (log_p + kLogRT);
        float s8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (t < n) {
          const T* xt = xs + t * XSTR;
          const float* aj = at + j * ASTR;
          for (int ch = p; ch < nch; ch += P) {
            float xv[8];
#pragma unroll
            for (int hh = 0; hh < 8 / VE; ++hh) {
              const uint4 raw = *reinterpret_cast<const uint4*>(xt + ch * 8 + hh * VE);
#pragma unroll
              for (int q = 0; q < VE; ++q) xv[hh * VE + q] = elem<T>(raw, q);
            }
            const float4 a0 = *reinterpret_cast<const float4*>(aj + ch * 8);
            const float4 a1 = *reinterpret_cast<const float4*>(aj + ch * 8 + 4);
            s8[0] = fmaf(xv[0], a0.x, s8[0]);
            s8[1] = fmaf(xv[1], a0.y, s8[1]);
            s8[2] = fmaf(xv[2], a0.z, s8[2]);
            s8[3] = fmaf(xv[3], a0.w, s8[3]);
            s8[4] = fmaf(xv[4], a1.x, s8[4]);
            s8[5] = fmaf(xv[5], a1.y, s8[5]);
            s8[6] = fmaf(xv[6], a1.z, s8[6]);
            s8[7] = fmaf(xv[7], a1.w, s8[7]);
          }
        }
        float v = ((s8[0] + s8[1]) + (s8[2] + s8[3])) + ((s8[4] + s8[5]) + (s8[6] + s8[7]));
        for (int off = 1; off < P; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
        hsum[i] += v;   // the same in each of the item's P lanes
      }
    }
  }
  if (!meta_done) {   // a block with no slice of d_in
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
      const int e = tid + i * kThreads;
      if (e >= n * RT) break;
      float m;
      keep_s[e] = static_cast<signed char>(meta(i, m));
      mul_s[e] = m;
    }
  }
  if (!kEarlyB) load_b<RT, OC, VEC>(bv, Bf, d_out, ob0, o1, r);

  // push this block's partial h into every cluster block's hall[c], then
  // one barrier; each block then adds the partials in rank order -- the
  // same sums in the same order in every block -- and applies the magnitude,
  // the rank mask and the rounding to T
  auto push = [&](int t, int j, float v) {
    if (t >= n) return;
    for (int cc = 0; cc < C; ++cc)
      cluster.map_shared_rank(hall, cc)[c * M::h + t * RT + j] = v;
  };
  if constexpr (MMA) {
    if (WK > 1) {   // one unit a warp: add the unit's WK warps in warp order
#pragma unroll
      for (int e = 0; e < 4; ++e) red[(warp * 32 + lane) * 4 + e] = acc[0][e];
      __syncthreads();
      if (kw == 0) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v = 0.f;
          for (int w = 0; w < WK; ++w) v += red[((warp + w) * 32 + lane) * 4 + e];
          acc[0][e] = v;
        }
      }
    }
    if (kw == 0) {   // lane (g, q) holds rows g, g + 8 and columns 2q, 2q + 1
      const int g = lane >> 2, q4 = lane & 3;
#pragma unroll
      for (int i = 0; i < UPW; ++i) {
        const int u = ug + i * ustep;
        if (u >= U) break;
        const int mt = u / NT, nt = u % NT;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          push(mt * 16 + g + 8 * (e >> 1), nt * 8 + 2 * q4 + (e & 1), acc[i][e]);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
      const int it = tid + i * kThreads;
      if (it >= items) break;
      const int e = it >> log_p;   // = t * RT + j
      if ((it & (P - 1)) == 0) push(e / RT, e % RT, hsum[i]);
    }
  }
  cluster.sync();

  float* hs = reinterpret_cast<float*>(smem + M::xs);   // [kTileTok][RT]
  for (int e = tid; e < n * RT; e += kThreads) {
    float v = 0.f;
    for (int cc = 0; cc < C; ++cc) v += hall[cc * M::h + e];
    const int k = keep_s[e];
    hs[e] = k < 0 ? __int_as_float(0x7fc00000) : k ? round_to<T>(v * mul_s[e]) : 0.f;
  }
  __syncthreads();   // hs is complete

  // expand on the CUDA cores: y[t][o] = T(scale * sum_j h[t][j] * T(B[j][o]))
  for (int ob = ob0; ob < o1; ob += kThreads * OC) {
    if (ob != ob0) load_b<RT, OC, VEC>(bv, Bf, d_out, ob, o1, r);
    const int nv = min(OC, o1 - ob);
    float bq[RT][OC];
#pragma unroll
    for (int j = 0; j < RT; ++j)
#pragma unroll
      for (int q = 0; q < OC; ++q) bq[j][q] = round_to<T>(bv[j][q]);
#pragma unroll 4
    for (int t = 0; t < n; ++t) {
      float sc[OC];
#pragma unroll
      for (int q = 0; q < OC; ++q) sc[q] = 0.f;
      const float4* h4 = reinterpret_cast<const float4*>(hs + t * RT);
#pragma unroll
      for (int j4 = 0; j4 < RT / 4; ++j4) {
        const float4 hv = h4[j4];
        const float hj[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int q = 0; q < OC; ++q) sc[q] = fmaf(hj[u], bq[4 * j4 + u][q], sc[q]);
      }
#pragma unroll
      for (int q = 0; q < OC; ++q) sc[q] *= pr.scale;
      store_cols<T, OC, VEC>(y + static_cast<size_t>(t0 + t) * d_out + ob, sc, nv);
    }
  }
}

// 0: `decode` (B * S <= kDecodeMaxRows), 1: `prefill`
int variant_of(int B, int S) {
  return static_cast<long long>(B) * S <= kDecodeMaxRows ? 0 : 1;
}

template <typename T, bool MAG, int RT, bool VEC, bool MMA>
int launch_rt(cudaLaunchConfig_t cfg, const T* x, const float* a, const float* b,
              const float* a_mag, const float* b_mag, const float* dmag, const int* idx,
              const int* ranks, T* y, const Params& pr) {
  auto kernel = bgmv_kernel<T, RT, MAG, VEC, MMA>;
  constexpr int bytes = Smem<T, RT, MMA>::bytes;
  cfg.dynamicSmemBytes = bytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bytes);
  if (err == cudaSuccess)
    err = cudaLaunchKernelEx(&cfg, kernel, x, a, b, a_mag, b_mag, dmag, idx, ranks, y, pr);
  return static_cast<int>(err);
}

template <typename T, bool MAG>
int launch(const void* x, const float* a, const float* b, const float* a_mag,
           const float* b_mag, const float* dmag, const int* idx,
           const int* ranks, void* y, int B, int S, int d_in, int d_out,
           int r, int L, float scale, void* stream) {
  if (B <= 0 || S <= 0 || d_in <= 0 || d_out <= 0 || r < 1 || r > kMaxRank || L < 1 ||
      static_cast<long long>(B) * S > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int VE = 16 / sizeof(T);
  const bool decode = variant_of(B, S) == 0;
  Params pr;
  pr.BS = B * S, pr.S = S, pr.d_in = d_in, pr.d_out = d_out, pr.r = r, pr.L = L;
  pr.tok = decode ? kDecodeMaxRows : kPrefillTok;
  pr.tpr = (S + pr.tok - 1) / pr.tok;
  pr.cluster = decode ? kDecodeCluster : kPrefillCluster;
  pr.scale = scale;
  pr.va = r % 4 == 0 && aligned16(a);
  // every access of a 16-byte-aligned call with r at its bucket's width
  // takes the vector path: the kernel without the element-wise fallbacks
  const bool vec = d_in % VE == 0 && d_out % 8 == 0 && aligned16(x) && aligned16(y) &&
                   pr.va && aligned16(b) && (r == 8 || r == 16 || r == 32 || r == 64);
  const long long tiles = MAG ? (static_cast<long long>(B) * S + pr.tok - 1) / pr.tok
                              : static_cast<long long>(B) * pr.tpr;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pr.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tiles * pr.cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  int rc;
  // bf16 prefill calls shrink on the tensor cores; decode calls, whose
  // tiles hold at most 16 tokens, and f32 calls on the CUDA cores
  const bool mma = sizeof(T) == 2 && !decode;
#define BGMV_RUN(RT, V, MM) \
  launch_rt<T, MAG, RT, V, MM>(cfg, xt, a, b, a_mag, b_mag, dmag, idx, ranks, yt, pr)
#define BGMV_LAUNCH(RT)                                                       \
  rc = mma ? (vec ? BGMV_RUN(RT, true, sizeof(T) == 2) : BGMV_RUN(RT, false, sizeof(T) == 2)) \
           : (vec ? BGMV_RUN(RT, true, false) : BGMV_RUN(RT, false, false))
  if (r <= 8) BGMV_LAUNCH(8);
  else if (r <= 16) BGMV_LAUNCH(16);
  else if (r <= 32) BGMV_LAUNCH(32);
  else BGMV_LAUNCH(64);
#undef BGMV_LAUNCH
#undef BGMV_RUN
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* bgmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// the variant a call with x (B, S, d_in) takes: 0 decode, 1 prefill
int bgmv_variant(int B, int S) { return variant_of(B, S); }

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

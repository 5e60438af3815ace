// The split-key walk of the bf16 chunk kernels: paged and dense decode (one
// query position), paged verify and paged prefill (a chunk of positions).
// One thread block of kWarps warps serves one (request, KV head) pair and a
// group of at most NT * 8 query columns of that KV head, where a column is
// one (chunk position i, query head) pair, packed position-major as the
// query-tile walk packs its rows: column c = i * m + head (m = h/g).
//
// Bound: bytes.  A decode or verify chunk reads every valid K/V row of its
// request once for about (columns) FLOPs a byte, so the walk must keep many
// 16-byte copies in flight.  The query-tile walk of `tile_walk.cuh` would
// put the columns on the rows of a 64-row query tile: 5 x 4 = 20 rows of a
// verify chunk keep one warp and a quarter busy, with two 17 KB tiles in
// flight a block.
//
// Here every warp walks keys (eight warps measured faster than four at hd
// 128, `PERF.md` section 6).  The request's keys [0, kend) are cut into
// 32-key units (one pool block at bs = 32: one table read), dealt to the
// warps in turn (unit u to warp u % kWarps), and each warp streams its
// units as 16-key tiles through its own ring of kStages tiles of 16-byte
// `cp.async` copies (rows padded by 16 bytes), synchronised by the warp
// alone: up to kWarps * (kStages - 1) tiles in flight a block.
// The products are transposed so that the 16 keys fill the M side of
// `mma.sync.m16n8k16` and the columns its N = 8 side, NT column tiles
// against each K or V fragment:
//   S^T [16 keys x 8 columns] = K Q^T    (K by `ldmatrix`, Q^T fragments
//                                         in registers, or in shared memory
//                                         where NT * HD > 384)
//   O^T [hd x 8 columns]     += V^T P^T  (V^T by `ldmatrix.trans`)
// P^T leaves the accumulator layout of S^T as the B operand of the second
// product through one `movmatrix.trans` per 8 keys, so it never leaves
// registers.  A thread holds two columns (2 * (lane % 4) + {0, 1}) of each
// column tile of both S^T and O^T, so the online softmax (exp2 units, fp32)
// rescales its own accumulators; a column's max over keys is a 3-step
// shuffle among the 8 lanes that share it.  Keys at or past kend copy as
// zeros and score -inf.  Which keys of [0, kend) a column sees is the key
// mask's (a template parameter): `KeyPrefix` (paged decode, linear dense
// rows) all of them, so only the tile that straddles kend is masked;
// `RowArc` (`decode_attn.cu`, rolling dense rows) a cyclic arc of the row;
// `ChunkKeys` (verify, prefill) those at or before the column's position,
// kend being the group's last position's limit.  A mask's `whole(k0, k1)`
// says that every column sees every key of a tile (no per-key test),
// `any(k0, k1)` that one key is valid: a tile with none is neither copied
// nor computed, but still commits its (empty) copy group, so the ring's
// commit/wait order is the same for every tile.
// At the end each warp leaves its un-normalized partial (O, m, l per
// column) in its own ring, and the block merges the kWarps partials in warp
// order: one thread a column turns the m and l into each warp's weight
// (exp2 units, over the column's l), then every thread sums four dims of
// the weighted partials; a warp that saw no key of a column has m = -inf
// and weight 0 there, and a column with no valid key gives exact zeros.
#pragma once

#include "tile_walk.cuh"

namespace repro {

constexpr int SW_KEYS = 16;     // keys of a ring tile: the M of S^T
constexpr int SW_UNIT = 32;     // keys a warp takes at a time
constexpr int SW_MAX_M = 8;     // query heads of the decode walk (NT = 1)

// The route of the bf16 chunk kernels (verify, prefill): a chunk of at most
// this many query columns takes this walk, in groups of at most 32 columns
// (`SplitGroups`), each group re-reading the keys it sees; a wider one takes
// the query-tile walk of `tile_walk.cuh`, which reads them once per 64 / m
// positions.  Measured on an H100 80GB HBM3 at 700 W (`chip_smoke.py
// --chunk-routes`, h=32 g=8 hd=128 bs=32), split / tile ms: verify (B=8,
// positions 0-440) at 36 columns 0.01207 / 0.02253, 64 0.01317 / 0.02391,
// 128 0.02437 / 0.02384, 256 0.03881 / 0.03020; prefill (B=5, 128 cached
// tokens) at 64 0.00748 / 0.01061, 128 0.01070 / 0.01072, 256 0.01818 /
// 0.01440.  The walks tie at 128 (within 3 %); from 256 the split walk
// loses.
constexpr int SW_SPLIT_COLS = 128;

// Column tiles a block can hold at head dim HD: NT * HD <= 512, so the O^T
// accumulators (4 * NT * HD / 16 a thread) stay at 128 or fewer.
__host__ __device__ constexpr int split_max_nt(int hd) {
  return 512 / hd < 4 ? 512 / hd : 4;
}

// Eight warps of three-stage rings up to hd 128 (208 KB at 128), four
// above; NT column tiles of 8 columns; the Q^T fragments in registers up to
// NT * HD = 384, else staged once in shared memory past the rings.
template <int HD, int NT = 1>
struct SplitWalk {
  static_assert(HD % 32 == 0 && HD <= 256, "head dim 32k <= 256");
  static_assert(NT >= 1 && NT <= split_max_nt(HD), "column tiles");
  static constexpr int kCols = NT * 8;
  static constexpr int kLd = HD + 8;
  static constexpr int kWarps = HD <= 128 ? 8 : 4;
  static constexpr int kStages = 3;
  static constexpr int kTile = 2 * SW_KEYS * kLd;     // K and V, elements
  static constexpr int kThreads = kWarps * 32;
  static constexpr bool kQRegs = NT * HD <= 384;
  static constexpr int kRing = kWarps * kStages * kTile;   // elements
  static constexpr size_t kSmem =
      static_cast<size_t>(kRing + (kQRegs ? 0 : kCols * kLd)) *
      sizeof(__nv_bfloat16);
  static_assert(kSmem <= 232448, "rings outgrow shared memory");
  // the merge's partials (rows padded by 4 floats) fit in each warp's
  // ring, and in warp 0's the merge's weights past them
  static constexpr int kPartLd = HD + 4;
  static_assert((kCols * kPartLd + 2 * kCols + kCols * kWarps) *
                        sizeof(float) <=
                    kStages * kTile * sizeof(__nv_bfloat16),
                "partials outgrow the ring");
};

// Calls f(std::integral_constant<int, NT>{}) for 1 <= nt <=
// split_max_nt(HD): the walk is compiled for each.
template <int HD, int NT = 1, typename F>
inline cudaError_t with_nt(int nt, F&& f) {
  if (nt == NT) return f(std::integral_constant<int, NT>{});
  if constexpr (NT < split_max_nt(HD))
    return with_nt<HD, NT + 1>(nt, std::forward<F>(f));
  return cudaErrorInvalidValue;
}

// n query columns of a (request, KV head) cut into `groups` blocks of `per`
// columns (at most 32, and what the walk holds at head dim HD), NT column
// tiles a block.
struct SplitGroups {
  int groups, per, nt;
  template <int HD>
  static SplitGroups of(int n) {
    constexpr int cap = 8 * split_max_nt(HD);
    const int groups = (n + cap - 1) / cap;
    const int per = (n + groups - 1) / groups;
    return {groups, per, (per + 7) / 8};
  }
};

// The query columns of one block: q and out are [B, sq, h, HD]; the block
// takes columns c0 .. c0 + n - 1 of the sq * m columns of its KV head.
struct Cols {
  int sq, c0, n;
  // group z of the sq * m columns cut into groups of `per`
  static __host__ __device__ Cols group(int sq, int m, int per, int z) {
    const int c0 = z * per, left = sq * m - c0;
    return {sq, c0, per < left ? per : left};
  }
};

// Keys [0, kend) all valid for every column: paged decode (kend = pos + 1)
// and linear dense rows (kend = min(pos + 1, S)).
struct KeyPrefix {
  int kend;
  __device__ __forceinline__ bool any(int, int) const { return true; }
  __device__ __forceinline__ bool whole(int, int k1) const {
    return k1 <= kend;
  }
  __device__ __forceinline__ bool operator()(int j, int) const {
    return j < kend;
  }
};

// Chunks of positions (verify, prefill): the column at chunk position i
// sits at position p0 + i and sees keys j <= p0 + i below vend.  For a
// group of positions i_lo .. i_hi the walk ends at kend = min(p0 + i_hi +
// 1, vend), and a tile below klo = min(p0 + i_lo + 1, vend) is whole.
struct ChunkKeys {
  int p0, vend, kend, klo;
  static __device__ __forceinline__ ChunkKeys of(int p0, int vend, int i_lo,
                                                 int i_hi) {
    return {p0, vend, max(0, min(p0 + i_hi + 1, vend)),
            min(p0 + i_lo + 1, vend)};
  }
  __device__ __forceinline__ bool any(int, int) const { return true; }
  __device__ __forceinline__ bool whole(int, int k1) const {
    return k1 <= klo;
  }
  __device__ __forceinline__ bool operator()(int j, int i) const {
    return j <= p0 + i && j < vend;
  }
};

// the transpose of an 8x8 b16 matrix held one 32-bit pair a thread
__device__ __forceinline__ unsigned movmatrix_t(unsigned x) {
  unsigned y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}

// The walk of KV head `kvh` of request `b` for the columns `cols` over the
// keys of `kv` that `mk` makes valid, all below mk.kend.  Launch with
// SplitWalk<HD, NT>::kThreads threads and kSmem bytes of shared memory.
template <int HD, int NT, typename Rows, typename Mask>
__device__ __forceinline__ void split_walk(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kp,
    const __nv_bfloat16* __restrict__ vp, const Rows& kv, const Mask& mk,
    const Cols& cols, __nv_bfloat16* __restrict__ out, __nv_bfloat16* sm,
    int b, int kvh, int h, int g, float scale) {
  using W = SplitWalk<HD, NT>;
  constexpr int LD = W::kLd;
  constexpr int S = W::kStages;
  constexpr int CH = HD / 8;       // 16-byte chunks a row
  constexpr int KC = HD / 16;      // k-steps of K Q^T, m-tiles of V^T P^T
  constexpr int NC = W::kCols;
  constexpr int SC = NT == 1 ? 2 : 1;   // K Q^T chains a column tile
  const int m = h / g;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __nv_bfloat16* ring = sm + warp * S * W::kTile;
  // element offset of column c of the group's row in q and out
  auto col_off = [&](int c) {
    const int cc = cols.c0 + c, i = cc / m;
    return ((static_cast<size_t>(b) * cols.sq + i) * h + kvh * m + cc -
            i * m) * HD;
  };

  const int kend = mk.kend;
  // the warp's i-th tile: half i % 2 of unit warp + kWarps * (i / 2)
  const int n_tiles = kend > 0 ? (kend + SW_KEYS - 1) / SW_KEYS : 0;
  auto tile_of = [&](int i) {
    return (warp + W::kWarps * (i >> 1)) * 2 + (i & 1);
  };
  const size_t stride = static_cast<size_t>(g) * HD;
  bool unit_run = false;       // the unit lies in one pool block ...
  size_t unit_base = 0;        // ... whose row 0 for this unit is here
  auto load = [&](int i, int stage) {   // in order of i
    __nv_bfloat16* Ks = ring + stage * W::kTile;
    __nv_bfloat16* Vs = Ks + SW_KEYS * LD;
    const int k0 = tile_of(i) * SW_KEYS;
    if ((i & 1) == 0) {
      unit_run = kv.contiguous(k0, SW_UNIT);
      unit_base = unit_run ? kv.row(k0, kvh) : 0;
    }
    const bool run = unit_run || kv.contiguous(k0, SW_KEYS);
    if (!mk.any(k0, k0 + SW_KEYS)) return;   // no valid key: no copy
    const size_t base = unit_run ? unit_base + (i & 1) * SW_KEYS * stride
                                 : (run ? kv.row(k0, kvh) : 0);
    for (int e = lane; e < SW_KEYS * CH; e += 32) {
      const int j = e / CH, c = e - j * CH;
      const int key = k0 + j;
      const bool ok = key < kend;
      const size_t off =
          ok ? (run ? base + j * stride : kv.row(key, kvh)) + c * 8 : 0;
      cp_async16(Ks + j * LD + c * 8, kp + off, ok);
      cp_async16(Vs + j * LD + c * 8, vp + off, ok);
    }
  };

  // Q^T as the B operand: column nt * 8 + lane / 4 of the group (zeros
  // past cols.n), dims 16 kc + 2 (lane % 4) + {0, 1} and 8 more; in shared
  // memory ([NC][LD] past the rings) the group's columns are one copy group
  // before the rings' first
  __nv_bfloat16* Qs = sm + W::kRing;
  if constexpr (!W::kQRegs) {
    for (int e = threadIdx.x; e < NC * CH; e += W::kThreads) {
      const int c = e / CH, ch = e - c * CH;
      const bool live = c < cols.n;
      cp_async16(Qs + c * LD + ch * 8, q + (live ? col_off(c) + ch * 8 : 0),
                 live);
    }
    cp_async_commit();
  }
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (tile_of(s) < n_tiles) load(s, s);
    cp_async_commit();
  }
  const int qn = lane >> 2;
  unsigned qf[W::kQRegs ? NT : 1][W::kQRegs ? KC : 1][2];
  if constexpr (W::kQRegs) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = nt * 8 + qn;
      const bool live = c < cols.n;
      const __nv_bfloat16* qr = q + (live ? col_off(c) : 0) + (lane & 3) * 2;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        qf[nt][kc][0] =
            live ? *reinterpret_cast<const unsigned*>(qr + kc * 16) : 0u;
        qf[nt][kc][1] =
            live ? *reinterpret_cast<const unsigned*>(qr + kc * 16 + 8) : 0u;
      }
    }
  } else {
    cp_async_wait<S - 1>();   // this thread's share of Q has landed ...
    __syncthreads();          // ... and every thread's
  }

  // the chunk position of each of this thread's columns (the masks of
  // chunks read it)
  int icol[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int hc = 0; hc < 2; ++hc)
      icol[nt][hc] = (cols.c0 + nt * 8 + 2 * (lane & 3) + hc) / m;

  const float sl2 = scale * 1.4426950408889634f;   // scores in log2 units
  float o[NT][KC][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < KC; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nt][i][e] = 0.f;
  float m_run[NT][2], l_run[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int hc = 0; hc < 2; ++hc) {
      m_run[nt][hc] = -INFINITY;
      l_run[nt][hc] = 0.f;
    }

  for (int i = 0; tile_of(i) < n_tiles; ++i) {
    const int nx = i + S - 1;
    if (tile_of(nx) < n_tiles) load(nx, nx % S);
    cp_async_commit();
    cp_async_wait<S - 1>();   // tile i has landed (this lane's copies) ...
    __syncwarp();             // ... and every lane's
    const int k0 = tile_of(i) * SW_KEYS;
    if (!mk.any(k0, k0 + SW_KEYS)) continue;   // nothing was copied or read
    const __nv_bfloat16* Ks = ring + (i % S) * W::kTile;
    const __nv_bfloat16* Vs = Ks + SW_KEYS * LD;

    // S^T = K Q^T: element e is key k0 + lane / 4 + 8 (e / 2), column
    // 2 (lane % 4) + e % 2 of each column tile; one column tile takes two
    // accumulators for independent mma chains
    float sacc[NT][SC][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < SC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[nt][c][e] = 0.f;
    const __nv_bfloat16* krow = Ks + (lane & 15) * LD + (lane >> 4) * 8;
    // Q^T fragments of k-steps kc and kc + 1 from shared memory: lanes
    // 0-7 / 8-15 / 16-23 / 24-31 address a column tile's 8 rows at dims
    // 0-7 / 8-15 / 16-23 / 24-31 of the pair
    const __nv_bfloat16* qrow = Qs + (lane & 7) * LD + (lane >> 3) * 8;
    unsigned qb[W::kQRegs ? 1 : NT][4];
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      unsigned a[4];
      ldsm_x4(krow + kc * 16, a[0], a[1], a[2], a[3]);
      if constexpr (!W::kQRegs) {
        if ((kc & 1) == 0) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            ldsm_x4(qrow + nt * 8 * LD + kc * 16, qb[nt][0], qb[nt][1],
                    qb[nt][2], qb[nt][3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if constexpr (W::kQRegs)
          mma_bf16(sacc[nt][kc % SC], a, qf[nt][kc][0], qf[nt][kc][1]);
        else
          mma_bf16(sacc[nt][kc % SC], a, qb[nt][2 * (kc & 1)],
                   qb[nt][2 * (kc & 1) + 1]);
      }
    }
    const bool whole = mk.whole(k0, k0 + SW_KEYS);
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sacc[nt][0][e];
#pragma unroll
        for (int c = 1; c < SC; ++c) x += sacc[nt][c][e];
        s[nt][e] = x * sl2;
        if (!whole && !mk(k0 + (lane >> 2) + 8 * (e >> 1), icol[nt][e & 1]))
          s[nt][e] = -INFINITY;
      }

    // online softmax of this thread's columns (column hc of a tile:
    // elements hc and hc + 2 of S^T and of every O^T tile)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int hc = 0; hc < 2; ++hc) {
        float mx = fmaxf(s[nt][hc], s[nt][hc + 2]);
        mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 16));
        const float m_new = fmaxf(m_run[nt][hc], mx);
        const float base = m_new == -INFINITY ? 0.f : m_new;
        const float corr = exp2f(m_run[nt][hc] - base);
        m_run[nt][hc] = m_new;
        s[nt][hc] = exp2f(s[nt][hc] - base);
        s[nt][hc + 2] = exp2f(s[nt][hc + 2] - base);
        l_run[nt][hc] = l_run[nt][hc] * corr + s[nt][hc] + s[nt][hc + 2];
#pragma unroll
        for (int i2 = 0; i2 < KC; ++i2) {
          o[nt][i2][hc] *= corr;
          o[nt][i2][hc + 2] *= corr;
        }
      }

    // O^T += V^T P^T: P^T [16 keys x 8 columns] of each column tile as the
    // B operand, V^T [16 dims x 16 keys] a tile by `ldmatrix.trans` of V's
    // rows, read once for the NT column tiles
    unsigned pb[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      pb[nt][0] = movmatrix_t(pack_bf16(s[nt][0], s[nt][1]));
      pb[nt][1] = movmatrix_t(pack_bf16(s[nt][2], s[nt][3]));
    }
    const __nv_bfloat16* vrow =
        Vs + ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int mt = 0; mt < KC; ++mt) {
      unsigned a[4];
      ldsm_x4_t(vrow + mt * 16, a[0], a[1], a[2], a[3]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma_bf16(o[nt][mt], a, pb[nt][0], pb[nt][1]);
    }
    __syncwarp();   // the stage is free for tile i + S
  }
  cp_async_wait<0>();
  __syncwarp();

  // the warp's partial, in its own ring: O [NC][PLD] un-normalized (rows
  // padded by 4 floats, so a warp's stores hit 32 banks), m (log2 units)
  // and l per column
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int hc = 0; hc < 2; ++hc) {
      float& l = l_run[nt][hc];
      l += __shfl_xor_sync(FULL_MASK, l, 4);
      l += __shfl_xor_sync(FULL_MASK, l, 8);
      l += __shfl_xor_sync(FULL_MASK, l, 16);
    }
  constexpr int PLD = W::kPartLd;
  float* wo = reinterpret_cast<float*>(ring);
  float* wm = wo + NC * PLD;
  float* wl = wm + NC;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int mt = 0; mt < KC; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * (lane & 3) + (e & 1);
        if (c < cols.n)
          wo[c * PLD + mt * 16 + (lane >> 2) + 8 * (e >> 1)] = o[nt][mt][e];
      }
  if (lane < 4) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int hc = 0; hc < 2; ++hc) {
        const int c = nt * 8 + 2 * lane + hc;
        wm[c] = m_run[nt][hc];
        wl[c] = l_run[nt][hc];
      }
  }
  __syncthreads();

  // the merge in warp order.  First each column's weight of each warp's
  // partial, 2^(m_w - max) / l (0 where the warp saw no key of the
  // column), [NC][kWarps] in warp 0's ring past its partial ...
  auto part = [&](int w) {
    return reinterpret_cast<const float*>(sm + w * S * W::kTile);
  };
  float* fw = reinterpret_cast<float*>(sm) + NC * PLD + 2 * NC;
  if (threadIdx.x < cols.n) {
    const int c = threadIdx.x;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < W::kWarps; ++w)
      mx = fmaxf(mx, part(w)[NC * PLD + c]);
    float f[W::kWarps], l = 0.f;
#pragma unroll
    for (int w = 0; w < W::kWarps; ++w) {
      const float mw = part(w)[NC * PLD + c];
      f[w] = mw == -INFINITY ? 0.f : exp2f(mw - mx);
      l += part(w)[NC * PLD + NC + c] * f[w];
    }
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int w = 0; w < W::kWarps; ++w) fw[c * W::kWarps + w] = f[w] * inv;
  }
  __syncthreads();
  // ... then the weighted sums, four dims a thread
  for (int e = threadIdx.x; e < cols.n * (HD / 4); e += W::kThreads) {
    const int c = e / (HD / 4), d = (e - c * (HD / 4)) * 4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < W::kWarps; ++w) {
      const float f = fw[c * W::kWarps + w];
      const float4 v =
          *reinterpret_cast<const float4*>(part(w) + c * PLD + d);
      acc.x += v.x * f;
      acc.y += v.y * f;
      acc.z += v.z * f;
      acc.w += v.w * f;
    }
    *reinterpret_cast<uint2*>(out + col_off(c) + d) =
        make_uint2(pack_bf16(acc.x, acc.y), pack_bf16(acc.z, acc.w));
  }
}

}  // namespace repro

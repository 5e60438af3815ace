// The split-key walk of the bf16 paged decode kernel: one query position
// per request, the m = h/g <= DW_MAX_M query heads of one KV head in one
// thread block of kWarps warps.
//
// Bound: bytes.  A decode reads every valid K/V row of its request once for
// about m FLOPs a byte, so the walk must keep many 16-byte copies in flight.
// The query-tile walk of `tile_walk.cuh` would put the group's m heads on
// rows 0..m-1 of a 64-row query tile: one warp of four busy, one 16 KB tile
// in flight a block.
//
// Here every warp walks keys (eight warps measured faster than four at hd
// 128, `PERF.md` section 6).  The request's keys [0, kend) are cut into
// 32-key units (one pool block at bs = 32: one table read), dealt to the
// warps in turn (unit u to warp u % kWarps), and each warp streams its
// units as 16-key tiles through its own ring of kStages tiles of 16-byte
// `cp.async` copies (rows padded by 16 bytes), synchronised by the warp
// alone: up to kWarps * (kStages - 1) tiles in flight a block.
// The products are transposed so that the 16 keys fill the M side of
// `mma.sync.m16n8k16` and the heads its N = 8 side (m <= 8 live):
//   S^T [16 keys x 8 heads] = K Q^T    (K by `ldmatrix`, Q^T in registers)
//   O^T [hd x 8 heads]     += V^T P^T  (V^T by `ldmatrix.trans`)
// P^T leaves the accumulator layout of S^T as the B operand of the second
// product through one `movmatrix.trans` per 8 keys, so it never leaves
// registers.  A thread holds two heads (columns 2 * (lane % 4) + {0, 1}) of
// both S^T and O^T, so the online softmax (exp2 units, fp32) rescales its
// own accumulators; a head's max over keys is a 3-step shuffle among the 8
// lanes that share the column.  Keys at or past kend copy as zeros and
// score -inf.  Which keys of [0, kend) are valid is the key mask's (a
// template parameter): `KeyPrefix` (paged rows, linear dense rows) makes
// all of them valid, so only the tile that straddles kend is masked;
// `RowArc` (`decode_attn.cu`, rolling dense rows) a cyclic arc of the row.
// A mask's `whole(k0, k1)` says that every key of a tile is valid (no
// per-key test), `any(k0, k1)` that one is: a tile with none is neither
// copied nor computed, but still commits its (empty) copy group, so the
// ring's commit/wait order is the same for every tile.
// At the end each warp leaves its un-normalized partial (O, m, l per head)
// in its own ring, and the block merges the kWarps partials in warp order
// with exp2 weights; a warp that walked no key has m = -inf and is skipped,
// and a row with no valid key gives exact zeros.
#pragma once

#include "tile_walk.cuh"

namespace repro {

constexpr int DW_KEYS = 16;     // keys of a ring tile: the M of S^T
constexpr int DW_UNIT = 32;     // keys a warp takes at a time
constexpr int DW_MAX_M = 8;     // heads: the N of both products

// Eight warps of three-stage rings up to hd 128 (208 KB at 128), four
// above.
template <int HD>
struct DecodeWalk {
  static_assert(HD % 32 == 0 && HD <= 256, "head dim 32k <= 256");
  static constexpr int kLd = HD + 8;
  static constexpr int kWarps = HD <= 128 ? 8 : 4;
  static constexpr int kStages = 3;
  static constexpr int kTile = 2 * DW_KEYS * kLd;     // K and V, elements
  static constexpr int kThreads = kWarps * 32;
  static constexpr size_t kSmem = static_cast<size_t>(kWarps) * kStages *
                                  kTile * sizeof(__nv_bfloat16);
  static_assert(kSmem <= 232448, "rings outgrow shared memory");
  // the merge's partials fit in each warp's ring
  static_assert((DW_MAX_M * HD + 2 * DW_MAX_M) * sizeof(float) <=
                    kStages * kTile * sizeof(__nv_bfloat16),
                "partials outgrow the ring");
};

// Keys [0, kend) all valid: the paged walk (kend = pos + 1) and linear
// dense rows (kend = min(pos + 1, S)).
struct KeyPrefix {
  int kend;
  __device__ __forceinline__ bool any(int, int) const { return true; }
  __device__ __forceinline__ bool whole(int, int k1) const {
    return k1 <= kend;
  }
  __device__ __forceinline__ bool operator()(int j) const { return j < kend; }
};

// the transpose of an 8x8 b16 matrix held one 32-bit pair a thread
__device__ __forceinline__ unsigned movmatrix_t(unsigned x) {
  unsigned y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}

// The walk of KV head `kvh` of request `b` over the keys of `kv` that `mk`
// makes valid, all below mk.kend: q and out are [B, h, HD].  Launch with
// DecodeWalk<HD>::kThreads threads and kSmem bytes of shared memory.
template <int HD, typename Rows, typename Mask>
__device__ __forceinline__ void decode_walk(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kp,
    const __nv_bfloat16* __restrict__ vp, const Rows& kv, const Mask& mk,
    __nv_bfloat16* __restrict__ out, __nv_bfloat16* sm, int b, int kvh,
    int h, int g, float scale) {
  using W = DecodeWalk<HD>;
  constexpr int LD = W::kLd;
  constexpr int S = W::kStages;
  constexpr int CH = HD / 8;       // 16-byte chunks a row
  constexpr int KC = HD / 16;      // k-steps of K Q^T, m-tiles of V^T P^T
  const int m = h / g;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __nv_bfloat16* ring = sm + warp * S * W::kTile;

  const int kend = mk.kend;
  // the warp's i-th tile: half i % 2 of unit warp + kWarps * (i / 2)
  const int n_tiles = kend > 0 ? (kend + DW_KEYS - 1) / DW_KEYS : 0;
  auto tile_of = [&](int i) {
    return (warp + W::kWarps * (i >> 1)) * 2 + (i & 1);
  };
  const size_t stride = static_cast<size_t>(g) * HD;
  bool unit_run = false;       // the unit lies in one pool block ...
  size_t unit_base = 0;        // ... whose row 0 for this unit is here
  auto load = [&](int i, int stage) {   // in order of i
    __nv_bfloat16* Ks = ring + stage * W::kTile;
    __nv_bfloat16* Vs = Ks + DW_KEYS * LD;
    const int k0 = tile_of(i) * DW_KEYS;
    if ((i & 1) == 0) {
      unit_run = kv.contiguous(k0, DW_UNIT);
      unit_base = unit_run ? kv.row(k0, kvh) : 0;
    }
    const bool run = unit_run || kv.contiguous(k0, DW_KEYS);
    if (!mk.any(k0, k0 + DW_KEYS)) return;   // no valid key: no copy
    const size_t base = unit_run ? unit_base + (i & 1) * DW_KEYS * stride
                                 : (run ? kv.row(k0, kvh) : 0);
    for (int e = lane; e < DW_KEYS * CH; e += 32) {
      const int j = e / CH, c = e - j * CH;
      const int key = k0 + j;
      const bool ok = key < kend;
      const size_t off =
          ok ? (run ? base + j * stride : kv.row(key, kvh)) + c * 8 : 0;
      cp_async16(Ks + j * LD + c * 8, kp + off, ok);
      cp_async16(Vs + j * LD + c * 8, vp + off, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (tile_of(s) < n_tiles) load(s, s);
    cp_async_commit();
  }

  // Q^T as the B operand: head lane / 4 (zeros past m), dims
  // 16 kc + 2 (lane % 4) + {0, 1} and 8 more
  const int qn = lane >> 2;
  const __nv_bfloat16* qr =
      q + (static_cast<size_t>(b) * h + kvh * m + min(qn, m - 1)) * HD +
      (lane & 3) * 2;
  unsigned qf[KC][2];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    qf[kc][0] = qn < m ? *reinterpret_cast<const unsigned*>(qr + kc * 16) : 0u;
    qf[kc][1] =
        qn < m ? *reinterpret_cast<const unsigned*>(qr + kc * 16 + 8) : 0u;
  }

  const float sl2 = scale * 1.4426950408889634f;   // scores in log2 units
  float o[KC][4];
#pragma unroll
  for (int i = 0; i < KC; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int i = 0; tile_of(i) < n_tiles; ++i) {
    const int nx = i + S - 1;
    if (tile_of(nx) < n_tiles) load(nx, nx % S);
    cp_async_commit();
    cp_async_wait<S - 1>();   // tile i has landed (this lane's copies) ...
    __syncwarp();             // ... and every lane's
    const int k0 = tile_of(i) * DW_KEYS;
    if (!mk.any(k0, k0 + DW_KEYS)) continue;   // nothing was copied or read
    const __nv_bfloat16* Ks = ring + (i % S) * W::kTile;
    const __nv_bfloat16* Vs = Ks + DW_KEYS * LD;

    // S^T = K Q^T: element e is key k0 + lane / 4 + 8 (e / 2), head
    // 2 (lane % 4) + e % 2; two accumulators for independent mma chains
    float sa[4] = {0.f, 0.f, 0.f, 0.f}, sb[4] = {0.f, 0.f, 0.f, 0.f};
    const __nv_bfloat16* krow = Ks + (lane & 15) * LD + (lane >> 4) * 8;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      unsigned a[4];
      ldsm_x4(krow + kc * 16, a[0], a[1], a[2], a[3]);
      if (kc & 1)
        mma_bf16(sb, a, qf[kc][0], qf[kc][1]);
      else
        mma_bf16(sa, a, qf[kc][0], qf[kc][1]);
    }
    const bool whole = mk.whole(k0, k0 + DW_KEYS);
    float s[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[e] = (sa[e] + sb[e]) * sl2;
      if (!whole && !mk(k0 + (lane >> 2) + 8 * (e >> 1))) s[e] = -INFINITY;
    }

    // online softmax of this thread's two heads (columns hc: elements hc
    // and hc + 2 of S^T and of every O^T tile)
#pragma unroll
    for (int hc = 0; hc < 2; ++hc) {
      float mx = fmaxf(s[hc], s[hc + 2]);
      mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 16));
      const float m_new = fmaxf(m_run[hc], mx);
      const float base = m_new == -INFINITY ? 0.f : m_new;
      const float corr = exp2f(m_run[hc] - base);
      m_run[hc] = m_new;
      s[hc] = exp2f(s[hc] - base);
      s[hc + 2] = exp2f(s[hc + 2] - base);
      l_run[hc] = l_run[hc] * corr + s[hc] + s[hc + 2];   // lane's share
#pragma unroll
      for (int i2 = 0; i2 < KC; ++i2) {
        o[i2][hc] *= corr;
        o[i2][hc + 2] *= corr;
      }
    }

    // O^T += V^T P^T: P^T [16 keys x 8 heads] as the B operand, V^T
    // [16 dims x 16 keys] a tile by `ldmatrix.trans` of V's rows
    const unsigned b0 = movmatrix_t(pack_bf16(s[0], s[1]));
    const unsigned b1 = movmatrix_t(pack_bf16(s[2], s[3]));
    const __nv_bfloat16* vrow =
        Vs + ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int mt = 0; mt < KC; ++mt) {
      unsigned a[4];
      ldsm_x4_t(vrow + mt * 16, a[0], a[1], a[2], a[3]);
      mma_bf16(o[mt], a, b0, b1);
    }
    __syncwarp();   // the stage is free for tile i + S
  }
  cp_async_wait<0>();
  __syncwarp();

  // the warp's partial, in its own ring: O [DW_MAX_M][HD] un-normalized,
  // m (log2 units) and l per head
#pragma unroll
  for (int hc = 0; hc < 2; ++hc) {
    l_run[hc] += __shfl_xor_sync(FULL_MASK, l_run[hc], 4);
    l_run[hc] += __shfl_xor_sync(FULL_MASK, l_run[hc], 8);
    l_run[hc] += __shfl_xor_sync(FULL_MASK, l_run[hc], 16);
  }
  float* wo = reinterpret_cast<float*>(ring);
  float* wm = wo + DW_MAX_M * HD;
  float* wl = wm + DW_MAX_M;
#pragma unroll
  for (int mt = 0; mt < KC; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int head = 2 * (lane & 3) + (e & 1);
      if (head < m)
        wo[head * HD + mt * 16 + (lane >> 2) + 8 * (e >> 1)] = o[mt][e];
    }
  if (lane < 4) {
#pragma unroll
    for (int hc = 0; hc < 2; ++hc) {
      const int head = 2 * lane + hc;
      wm[head] = m_run[hc];
      wl[head] = l_run[hc];
    }
  }
  __syncthreads();

  // merge the warps' partials in warp order; two dims a thread
  for (int e = threadIdx.x; e < m * (HD / 2); e += W::kThreads) {
    const int head = e / (HD / 2), d = (e - head * (HD / 2)) * 2;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < W::kWarps; ++w) {
      const float* pm =
          reinterpret_cast<const float*>(sm + w * S * W::kTile) +
          DW_MAX_M * HD;
      mx = fmaxf(mx, pm[head]);
    }
    float l = 0.f, o0 = 0.f, o1 = 0.f;
#pragma unroll
    for (int w = 0; w < W::kWarps; ++w) {
      const float* po = reinterpret_cast<const float*>(sm + w * S * W::kTile);
      const float mw = po[DW_MAX_M * HD + head];
      if (mw == -INFINITY) continue;      // walked no valid key
      const float f = exp2f(mw - mx);
      l += po[DW_MAX_M * HD + DW_MAX_M + head] * f;
      o0 += po[head * HD + d] * f;
      o1 += po[head * HD + d + 1] * f;
    }
    const float inv = 1.f / fmaxf(l, 1e-30f);
    *reinterpret_cast<unsigned*>(
        out + (static_cast<size_t>(b) * h + kvh * m + head) * HD + d) =
        pack_bf16(o0 * inv, o1 * inv);
  }
}

}  // namespace repro

// The query-tile walk of the paged prefill and flash attention kernels, and
// in bf16 of every attention kernel (the decode, verify and split-K chunks
// are query tiles of one or a few positions).
//
// One thread block serves query tile `iq` of request `b` for KV head `kvh`:
// bq = 64 / m query positions (rounded down) times the m = h/g query heads
// of the group, bq * m <= 64 query rows (row rr is position qi = rr / m,
// head qh = rr % m; when m does not divide 64, as at m = 5, rows bq * m ..
// 63 are padding: staged as zeros and never written), so each tile of keys (a pool block through the table, or a run of
// contiguous rows: `kv_rows.cuh`) is read once per query tile for the whole
// group.  Query row si sits at position c0 + si; which keys it sees is the
// mask's (`PosMask`: keys below a limit and, if causal, at most the row's
// position; a sliding window (`WinMask`, flash only) adds that the row sees
// only keys less than `window` positions back; a decode chunk of dense rows
// brings its own rolling mask).  The walk starts at the tile of the oldest
// key the tile's first position sees, stops at the last tile that the mask
// allows, and masks only the tiles that straddle a limit.  The finalize
// divides by l clamped at 1e-30, so a row with no valid key gives exact
// zeros (its running max stays -inf, its sum 0 and its output 0); a
// split-K run writes its un-normalized partial instead (`PartialOut`).
// Addressing, mask and output are template parameters: no kernel pays a
// runtime branch for another's case.
//
// The element type picks the walk at compile time:
//  * bf16, the tensor-core walk (`tile_walk` over `__nv_bfloat16`): four
//    warps of 16 query rows each.  S = Q K^T and O += P V are
//    `mma.sync.m16n8k16` products with fp32 accumulators, their operands
//    read from shared memory by `ldmatrix` (V transposed on the way); the
//    online softmax (running max, sum, rescale) stays in fp32 registers in
//    the accumulator layout, and P is rounded to bf16 only as the operand
//    of P V.  K/V tiles of BK keys go through a two-stage ring of 16-byte
//    `cp.async` copies, so the copy of tile t+1 overlaps the math of tile
//    t; rows are padded by 16 bytes, so `ldmatrix` reads are free of bank
//    conflicts.  Keys past the valid limit are copied as zeros.
//    (`wgmma`, the card's full tensor-core rate, is later work.)
//  * fp32, the CUDA-core walk (`tile_walk` over `float`): 8 warps of 8 rows,
//    K/V staged in shared memory as fp32 with a padded row; lane j scores
//    key j of a 32-key chunk against the warp's rows, and each lane owns
//    hd/32 output dims of each row.  The query tile is staged transposed,
//    [hd][64] with each warp's 8 rows adjacent, so a lane reads the warp's 8
//    query values of one dim with two broadcast 16-byte loads.  It keeps the
//    fp32 parity runs at 1e-4 (TF32 off).
#pragma once

#include <type_traits>
#include <utility>

#include "kv_rows.cuh"

namespace repro {

constexpr int TW_ROWS = 64;                   // query rows per thread block

// ------------------------------------------------- fp32: the CUDA-core walk
constexpr int TW_WARPS = 8;
constexpr int TW_RPW = TW_ROWS / TW_WARPS;    // rows per warp
constexpr int TW_MAX_NI = 8;                  // hd <= 256
static_assert(TW_RPW == 8, "the score loop reads a warp's rows as 2 float4");

// Floats before the query tile: the K and V tiles of `bs` keys, fp32 with a
// padded row, rounded up to 16 bytes for the query tile's vector loads.
__host__ __device__ inline size_t tile_walk_q_offset(int bs, int hd) {
  return (2 * static_cast<size_t>(bs) * (hd + 1) + 3) & ~static_cast<size_t>(3);
}

// Shared memory of one thread block: the K and V tiles and the query tile.
inline size_t tile_walk_smem_bytes(int bs, int hd) {
  return (tile_walk_q_offset(bs, hd) + static_cast<size_t>(TW_ROWS) * hd) *
         sizeof(float);
}

// The fp32 walk.  q and out are [B, Sq, h, hd]; `n_tiles` caps the walk
// (the table width, or the row's tile count); `window` > 0 limits each row
// to the keys less than `window` positions back (0: no window).  Launch with
// TW_WARPS * 32 threads.
template <typename Rows, bool CAUSAL>
__device__ __forceinline__ void tile_walk(
    const float* __restrict__ q, const float* __restrict__ kp,
    const float* __restrict__ vp, const Rows& kv, float* __restrict__ out,
    float* sm,
    int b, int iq, int kvh, int Sq, int h, int g, int c0, int kend,
    int n_tiles, float scale, int window = 0) {
  const int hd = kv.hd, bs = kv.bs;
  const int ldk = hd + 1;
  float* Ks = sm;                  // [bs][hd + 1]
  float* Vs = Ks + bs * ldk;       // [bs][hd + 1]
  float* Qs = sm + tile_walk_q_offset(bs, hd);   // [hd][TW_ROWS]
  const int m = h / g;
  const int bq = TW_ROWS / m;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ni = hd / 32;

  // stage the tile's queries: row rr = qi * m + qh belongs to warp
  // rr % TW_WARPS as its row rr / TW_WARPS, at column (rr % TW_WARPS) *
  // TW_RPW + rr / TW_WARPS of dim d's line (threads walk the rows of one dim,
  // so the transposed stores are at most 2-way bank conflicts)
  for (int i = threadIdx.x; i < TW_ROWS * hd; i += blockDim.x) {
    const int d = i / TW_ROWS, rr = i - d * TW_ROWS;
    const int qi = rr / m, qh = rr - qi * m;
    const int si = iq * bq + qi;
    const int col = (rr % TW_WARPS) * TW_RPW + rr / TW_WARPS;
    Qs[d * TW_ROWS + col] =
        qi < bq && si < Sq ? to_f(q[((static_cast<size_t>(b) * Sq + si) * h + kvh * m +
                          qh) * hd + d])
                : 0.f;
  }
  const float* qw = Qs + warp * TW_RPW;   // this warp's rows, stride TW_ROWS
  const int qpos_max = c0 + min((iq + 1) * bq, Sq) - 1;
  const int klimit = CAUSAL ? min(kend, qpos_max + 1) : kend;
  const int nblk = klimit <= 0 ? 0 : min(n_tiles, (klimit + bs - 1) / bs);
  // the first tile that holds a key inside the first position's window
  const int blk0 = window > 0 ? max(0, c0 + iq * bq - window + 1) / bs : 0;

  float acc[TW_RPW][TW_MAX_NI];
  float m_run[TW_RPW], l_run[TW_RPW];
  int qpos[TW_RPW];
#pragma unroll
  for (int r = 0; r < TW_RPW; ++r) {
    m_run[r] = NEG_INF;
    l_run[r] = 0.f;
    const int rr = warp + TW_WARPS * r;
    qpos[r] = c0 + iq * bq + rr / m;
#pragma unroll
    for (int i = 0; i < TW_MAX_NI; ++i) acc[r][i] = 0.f;
  }

  for (int ib = blk0; ib < nblk; ++ib) {
    __syncthreads();  // previous tile's reads (and the Q staging) are done
    stage_tile<float>(kp, vp, kv, ib, kvh, Ks, Vs, ldk);
    __syncthreads();
    for (int c = 0; c < bs; c += 32) {
      const int j = c + lane;
      const int jpos = ib * bs + j;
      float s[TW_RPW];
#pragma unroll
      for (int r = 0; r < TW_RPW; ++r) s[r] = 0.f;
      if (j < bs) {
        const float* kr = Ks + j * ldk;
        for (int d = 0; d < hd; ++d) {
          const float kx = kr[d];
          const float4 qa = *reinterpret_cast<const float4*>(qw + d * TW_ROWS);
          const float4 qb =
              *reinterpret_cast<const float4*>(qw + d * TW_ROWS + 4);
          s[0] += qa.x * kx;
          s[1] += qa.y * kx;
          s[2] += qa.z * kx;
          s[3] += qa.w * kx;
          s[4] += qb.x * kx;
          s[5] += qb.y * kx;
          s[6] += qb.z * kx;
          s[7] += qb.w * kx;
        }
      }
      float pr[TW_RPW];
#pragma unroll
      for (int r = 0; r < TW_RPW; ++r) {
        const bool valid =
            j < bs && jpos < kend && (!CAUSAL || jpos <= qpos[r]) &&
            (window <= 0 || qpos[r] - jpos < window);
        const float sv = valid ? s[r] * scale : NEG_INF;
        const float m_new = fmaxf(m_run[r], warp_max(sv));
        pr[r] = valid ? expf(sv - m_new) : 0.f;
        const float corr = expf(fminf(m_run[r] - m_new, 0.f));
        l_run[r] = l_run[r] * corr + warp_sum(pr[r]);
#pragma unroll
        for (int i = 0; i < TW_MAX_NI; ++i) acc[r][i] *= corr;
        m_run[r] = m_new;
      }
      const int nj = min(32, bs - c);
      for (int jj = 0; jj < nj; ++jj) {
        const float* vr = Vs + (c + jj) * ldk + lane;
        float pv[TW_RPW];
#pragma unroll
        for (int r = 0; r < TW_RPW; ++r)
          pv[r] = __shfl_sync(FULL_MASK, pr[r], jj);
#pragma unroll
        for (int i = 0; i < TW_MAX_NI; ++i) {
          if (i < ni) {
            const float vx = vr[32 * i];
#pragma unroll
            for (int r = 0; r < TW_RPW; ++r) acc[r][i] += pv[r] * vx;
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < TW_RPW; ++r) {
    const int rr = warp + TW_WARPS * r;
    const int qi = rr / m, qh = rr - qi * m;
    const int si = iq * bq + qi;
    if (qi >= bq || si >= Sq) continue;   // padding row
    const float l = fmaxf(l_run[r], 1e-30f);
    float* ob = out + ((static_cast<size_t>(b) * Sq + si) * h + kvh * m + qh) *
                      hd + lane;
#pragma unroll
    for (int i = 0; i < TW_MAX_NI; ++i)
      if (i < ni) ob[32 * i] = acc[r][i] / l;
  }
}

// ------------------------------------------------ bf16: the tensor-core walk
constexpr int TC_WARPS = TW_ROWS / 16;        // 16 query rows per warp
constexpr int TC_STAGES = 2;                  // K/V tiles in the ring

// Launch shape of the bf16 walk at head dim HD and key tile BK: the query
// tile and the ring of K/V tiles, bf16 rows padded to HD + 8 elements.
template <int HD, int BK>
struct TcWalk {
  static_assert(HD % 32 == 0 && HD <= 256 && BK % 16 == 0, "tile shape");
  static constexpr int kLd = HD + 8;
  static constexpr int kThreads = TC_WARPS * 32;
  static constexpr size_t kSmem =
      static_cast<size_t>(TW_ROWS + 2 * TC_STAGES * BK) * kLd *
      sizeof(__nv_bfloat16);
};

// Calls f(std::integral_constant<int, HD>{}) for the head dim hd (32k <=
// 256): the bf16 walk is compiled for each.
template <int HD = 32, typename F>
inline cudaError_t with_hd(int hd, F&& f) {
  if (hd == HD) return f(std::integral_constant<int, HD>{});
  if constexpr (HD < 256) return with_hd<HD + 32>(hd, std::forward<F>(f));
  return cudaErrorInvalidValue;
}

__device__ __forceinline__ void ldsm_x4(const void* p, unsigned& r0,
                                        unsigned& r1, unsigned& r2,
                                        unsigned& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(const void* p, unsigned& r0,
                                          unsigned& r1, unsigned& r2,
                                          unsigned& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Which keys a query row sees, for the bf16 walk: keys lo <= j < hi and,
// if CAUSAL, j <= the row's position.  `begin` and `end` bound the walk for
// a tile whose positions run from qpos_lo to qpos_max; `whole` says every
// key of [k0, k1) is valid for every row of positions qpos_lo .. qpos_hi
// (no mask needed).
template <bool CAUSAL>
struct PosMask {
  int lo, hi;
  __device__ __forceinline__ int begin(int) const { return lo; }
  __device__ __forceinline__ int end(int qpos_max) const {
    return CAUSAL ? min(hi, qpos_max + 1) : hi;
  }
  __device__ __forceinline__ bool operator()(int j, int qpos) const {
    return j >= lo && j < hi && (!CAUSAL || j <= qpos);
  }
  __device__ __forceinline__ bool whole(int k0, int k1, int qpos_lo,
                                        int) const {
    return k0 >= lo && k1 <= hi && (!CAUSAL || k1 - 1 <= qpos_lo);
  }
};

// PosMask with a sliding window: the row at qpos also needs qpos - j <
// window (window > 0), so the walk of a tile begins at its first
// position's oldest key, and a tile is whole only if its oldest key is
// inside the last position's window.
template <bool CAUSAL>
struct WinMask {
  PosMask<CAUSAL> pos;
  int window;
  __device__ __forceinline__ int begin(int qpos_lo) const {
    return max(pos.lo, qpos_lo - window + 1);
  }
  __device__ __forceinline__ int end(int qpos_max) const {
    return pos.end(qpos_max);
  }
  __device__ __forceinline__ bool operator()(int j, int qpos) const {
    return pos(j, qpos) && qpos - j < window;
  }
  __device__ __forceinline__ bool whole(int k0, int k1, int qpos_lo,
                                        int qpos_hi) const {
    return pos.whole(k0, k1, qpos_lo, qpos_hi) && qpos_hi - k0 < window;
  }
};

// Output of the bf16 walk: each row normalized, as bf16 [B, Sq, h, hd].
struct Bf16Out {
  __nv_bfloat16* out;
  int Sq, h;
  template <int DT>
  __device__ __forceinline__ void emit(int b, int si, int head,
                                       const float (&o)[DT][4], int hr,
                                       int lane, float, float l) const {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    __nv_bfloat16* ob =
        out + ((static_cast<size_t>(b) * Sq + si) * h + head) * (DT * 8) +
        (lane & 3) * 2;
#pragma unroll
    for (int i = 0; i < DT; ++i)
      *reinterpret_cast<unsigned*>(ob + i * 8) =
          pack_bf16(o[i][2 * hr] * inv, o[i][2 * hr + 1] * inv);
  }
};

// Output of the bf16 walk: run s's un-normalized fp32 partial, acc [B, ns,
// Sq, h, hd], its running max m (natural-log units, NEG_INF when the run
// saw no valid key) and row sum l [B, ns, Sq, h].
struct PartialOut {
  float* o;
  float* m;
  float* l;
  int ns, s, Sq, h;
  template <int DT>
  __device__ __forceinline__ void emit(int b, int si, int head,
                                       const float (&acc)[DT][4], int hr,
                                       int lane, float m_nat,
                                       float l_row) const {
    const size_t row =
        ((static_cast<size_t>(b) * ns + s) * Sq + si) * h + head;
    float* ob = o + row * (DT * 8) + (lane & 3) * 2;
#pragma unroll
    for (int i = 0; i < DT; ++i)
      *reinterpret_cast<float2*>(ob + i * 8) =
          make_float2(acc[i][2 * hr], acc[i][2 * hr + 1]);
    if ((lane & 3) == 0) {
      m[row] = m_nat;
      l[row] = l_row;
    }
  }
};

// The bf16 walk.  q is [B, Sq, h, hd = HD]; tile `iq` holds positions
// iq * bq .. iq * bq + bq - 1 (bq = 64 / m, rounded down: rows past bq * m
// are padding) at absolute positions c0 + si.  The keys walked are those
// `mask` allows, in tiles of BK keys, from the tile of `mask.begin` (the
// tile's first position) to that of `mask.end` (its last); `out` receives
// each row.  Launch with TcWalk<HD, BK>::kThreads threads and kSmem bytes of
// shared memory.  Thread (warp w, lane) holds, in the m16n8 accumulator
// layout, rows 16w + lane/4 and 16w + lane/4 + 8 of the tile, columns
// 2 * (lane % 4) and one more of every 8-wide slice of S (keys) and O
// (dims); a warp whose 16 rows are all padding skips the math.
template <int HD, int BK, typename Rows, typename Mask, typename Out>
__device__ __forceinline__ void tile_walk(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kp,
    const __nv_bfloat16* __restrict__ vp, const Rows& kv, const Mask& mask,
    const Out& out, __nv_bfloat16* sm, int b, int iq, int kvh, int Sq, int h,
    int g, int c0, float scale) {
  using W = TcWalk<HD, BK>;
  constexpr int LD = W::kLd;
  constexpr int CH = HD / 8;       // 16-byte chunks per row
  constexpr int NT = BK / 8;       // 8-key slices of S
  constexpr int DT = HD / 8;       // 8-dim slices of O
  constexpr int KC = HD / 16;      // k-steps of Q K^T
  constexpr bool Q_IN_REGS = HD <= 128;
  __nv_bfloat16* Qs = sm;                        // [64][LD]
  __nv_bfloat16* ring = sm + TW_ROWS * LD;       // stages x {K, V} [BK][LD]
  const int m = h / g, bq = TW_ROWS / m;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_pos = min(bq, Sq - iq * bq);       // positions of this tile
  const int live = n_pos * m;                    // rows 0 .. live - 1
  const int qpos_lo = c0 + iq * bq;              // the tile's first position
  const int qpos_hi = qpos_lo + n_pos - 1;       // and its last
  const int k_beg = mask.begin(qpos_lo);
  const int k_end = mask.end(qpos_hi);
  const int t_lo = k_beg / BK;
  const int t_hi = k_end > k_beg ? (k_end + BK - 1) / BK : t_lo;

  // the query tile (padding rows are zeros); the group's m heads of one
  // position are adjacent in q, so row rr starts at head kvh * m + rr % m
  for (int e = tid; e < TW_ROWS * CH; e += W::kThreads) {
    const int rr = e / CH, c = e - rr * CH;
    const int qi = rr / m, si = iq * bq + qi;
    const bool ok = rr < live;
    const size_t off =
        ok ? ((static_cast<size_t>(b) * Sq + si) * h + kvh * m + rr - qi * m) *
                     HD + c * 8
           : 0;
    cp_async16(Qs + rr * LD + c * 8, q + off, ok);
  }
  const size_t stride = static_cast<size_t>(g) * HD;
  auto load_tile = [&](int t, int stage) {
    __nv_bfloat16* Ks = ring + stage * 2 * BK * LD;
    __nv_bfloat16* Vs = Ks + BK * LD;
    // one table read for the tile when its keys share a pool block
    const bool run = kv.contiguous(t * BK, BK);
    const size_t base = run ? kv.row(t * BK, kvh) : 0;
    for (int e = tid; e < BK * CH; e += W::kThreads) {
      const int j = e / CH, c = e - j * CH;
      const int key = t * BK + j;
      const bool ok = key >= k_beg && key < k_end;
      const size_t off =
          ok ? (run ? base + j * stride : kv.row(key, kvh)) + c * 8 : 0;
      cp_async16(Ks + j * LD + c * 8, kp + off, ok);
      cp_async16(Vs + j * LD + c * 8, vp + off, ok);
    }
  };
  if (t_lo < t_hi) load_tile(t_lo, 0);
  cp_async_commit();   // group 0: the query tile and the first key tile

  const bool busy = warp * 16 < live;            // warp-uniform
  const int r0 = warp * 16 + (lane >> 2);        // rows r0 and r0 + 8
  const int qpos[2] = {qpos_lo + r0 / m, qpos_lo + (r0 + 8) / m};
  const float sl2 = scale * 1.4426950408889634f;  // scores in log2 units
  unsigned qf[Q_IN_REGS ? KC : 1][4];
  float o[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int t = t_lo; t < t_hi; ++t) {
    const int it = t - t_lo;
    if (t + 1 < t_hi) load_tile(t + 1, (it + 1) % TC_STAGES);
    cp_async_commit();
    cp_async_wait<1>();      // every group but the newest: tile t is in
    __syncthreads();
    const __nv_bfloat16* Ks = ring + (it % TC_STAGES) * 2 * BK * LD;
    const __nv_bfloat16* Vs = Ks + BK * LD;
    const __nv_bfloat16* qrow =
        Qs + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
    if (busy) {
      if constexpr (Q_IN_REGS) {
        if (it == 0) {
#pragma unroll
          for (int kc = 0; kc < KC; ++kc)
            ldsm_x4(qrow + kc * 16, qf[kc][0], qf[kc][1], qf[kc][2],
                    qf[kc][3]);
        }
      }

      // S = Q K^T: lanes 0-7 / 8-15 / 16-23 / 24-31 address keys 0-7 dims
      // 0-7 / keys 0-7 dims 8-15 / keys 8-15 dims 0-7 / keys 8-15 dims 8-15
      float s[NT][4];
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
      const __nv_bfloat16* krow =
          Ks + ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        unsigned a[4];
        if constexpr (Q_IN_REGS) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qf[kc][e];
        } else {
          ldsm_x4(qrow + kc * 16, a[0], a[1], a[2], a[3]);
        }
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          unsigned b0, b1, b2, b3;
          ldsm_x4(krow + np * 16 * LD + kc * 16, b0, b1, b2, b3);
          mma_bf16(s[2 * np], a, b0, b1);
          mma_bf16(s[2 * np + 1], a, b2, b3);
        }
      }

      // scale, and mask the tiles that straddle a limit
      const bool whole = mask.whole(t * BK, (t + 1) * BK, qpos_lo, qpos_hi);
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[i][e] * sl2;
          if (!whole &&
              !mask(t * BK + i * 8 + (lane & 3) * 2 + (e & 1), qpos[e >> 1]))
            x = -INFINITY;
          s[i][e] = x;
        }

      // online softmax of rows r0 (elements 0, 1) and r0 + 8 (elements 2,
      // 3); the four lanes of a row hold its 2 * NT scores of this tile
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = -INFINITY;
#pragma unroll
        for (int i = 0; i < NT; ++i)
          mx = fmaxf(mx, fmaxf(s[i][2 * hr], s[i][2 * hr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 2));
        const float m_new = fmaxf(m_run[hr], mx);
        const float base = m_new == -INFINITY ? 0.f : m_new;
        const float corr = exp2f(m_run[hr] - base);
        m_run[hr] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < NT; ++i)
#pragma unroll
          for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
            s[i][e] = exp2f(s[i][e] - base);
            sum += s[i][e];
          }
        l_run[hr] = l_run[hr] * corr + sum;   // this lane's share of the row
#pragma unroll
        for (int i = 0; i < DT; ++i) {
          o[i][2 * hr] *= corr;
          o[i][2 * hr + 1] *= corr;
        }
      }

      // O += P V: P's accumulator layout is the A operand's, 16 keys a
      // step; V's [key][dim] rows are read transposed
      const __nv_bfloat16* vrow =
          Vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) {
        const unsigned a[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                               pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                               pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                               pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
        for (int dp = 0; dp < DT / 2; ++dp) {
          unsigned b0, b1, b2, b3;
          ldsm_x4_t(vrow + kc * 16 * LD + dp * 16, b0, b1, b2, b3);
          mma_bf16(o[2 * dp], a, b0, b1);
          mma_bf16(o[2 * dp + 1], a, b2, b3);
        }
      }
    }
    __syncthreads();   // the stage is free for tile t + 2
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float l = l_run[hr];
    l += __shfl_xor_sync(FULL_MASK, l, 1);
    l += __shfl_xor_sync(FULL_MASK, l, 2);
    const int rr = r0 + 8 * hr;
    if (rr >= live) continue;
    const int qi = rr / m;
    const float m_nat = m_run[hr] == -INFINITY
                            ? NEG_INF
                            : m_run[hr] * 0.6931471805599453f;
    out.template emit<DT>(b, iq * bq + qi, kvh * m + rr - qi * m, o, hr,
                          lane, m_nat, l);
  }
}

}  // namespace repro

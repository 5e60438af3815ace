// The query-tile walk shared by the paged prefill and the flash attention
// kernels.
//
// One thread block serves query tile `iq` of request `b` for KV head `kvh`:
// bq = 64 / m query positions times the m = h/g query heads of the group,
// 64 query rows in all, 8 per warp (row rr is position qi = rr / m, head
// qh = rr % m).  Each tile of keys (a pool block through the table, or a run
// of contiguous rows: `kv_rows.cuh`) is read once per query tile and staged
// in shared memory as fp32 with a padded row; lane j scores key j of a
// 32-key chunk against the warp's rows, and the online softmax stays in fp32
// registers (each lane owns hd/32 output dims of each row).  The query tile
// is staged transposed, [hd][64] with each warp's 8 rows adjacent, so a lane
// reads the warp's 8 query values of one dim with two broadcast 16-byte
// loads.  Query row si sits at position c0 + si; key j is valid when
// j < kend and, if CAUSAL, j <= its query's position.  The walk stops at
// the last tile that those limits allow.  The finalize divides by l clamped
// at 1e-30, so a row with no valid key gives exact zeros.  Addressing and
// causality are template parameters: neither kernel pays a runtime branch
// for the other's case.
#pragma once

#include "kv_rows.cuh"

namespace repro {

constexpr int TW_WARPS = 8;
constexpr int TW_ROWS = 64;                   // query rows per thread block
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

// q and out are [B, Sq, h, hd]; `n_tiles` caps the walk (the table width,
// or the row's tile count).  Launch with TW_WARPS * 32 threads.
template <typename T, typename Rows, bool CAUSAL>
__device__ __forceinline__ void tile_walk(
    const T* __restrict__ q, const T* __restrict__ kp,
    const T* __restrict__ vp, const Rows& kv, T* __restrict__ out, float* sm,
    int b, int iq, int kvh, int Sq, int h, int g, int c0, int kend,
    int n_tiles, float scale) {
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
        si < Sq ? to_f(q[((static_cast<size_t>(b) * Sq + si) * h + kvh * m +
                          qh) * hd + d])
                : 0.f;
  }
  const float* qw = Qs + warp * TW_RPW;   // this warp's rows, stride TW_ROWS
  const int qpos_max = c0 + min((iq + 1) * bq, Sq) - 1;
  const int klimit = CAUSAL ? min(kend, qpos_max + 1) : kend;
  const int nblk = klimit <= 0 ? 0 : min(n_tiles, (klimit + bs - 1) / bs);

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

  for (int ib = 0; ib < nblk; ++ib) {
    __syncthreads();  // previous tile's reads (and the Q staging) are done
    stage_tile<T>(kp, vp, kv, ib, kvh, Ks, Vs, ldk);
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
            j < bs && jpos < kend && (!CAUSAL || jpos <= qpos[r]);
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
    if (si >= Sq) continue;
    const float l = fmaxf(l_run[r], 1e-30f);
    T* ob = out + ((static_cast<size_t>(b) * Sq + si) * h + kvh * m + qh) *
                      hd + lane;
#pragma unroll
    for (int i = 0; i < TW_MAX_NI; ++i)
      if (i < ni) ob[32 * i] = from_f<T>(acc[r][i] / l);
  }
}

}  // namespace repro

// K/V row addressing of the attention walks (`paged_walk.cuh`,
// `tile_walk.cuh`), chosen at compile time so that neither layout pays a
// runtime branch for the other.
//
// A walk visits the keys of one (request, KV head) in tiles of `bs` keys.
// `PagedRows` names pool blocks [n_blocks, bs, g, hd] through one request's
// block table (tile ib is block trow[ib]); `DenseRows` reads contiguous rows
// [B, T, g, hd] (tile ib holds keys ib*bs .. ib*bs + bs - 1, the last tile
// ragged when T % bs != 0).  `stage_tile` copies one tile of K and V into
// shared memory as fp32 with a padded row; keys past the end read as 0 (the
// masks exclude them).
#pragma once

#include "common.cuh"

namespace repro {

struct PagedRows {
  static constexpr bool kRagged = false;   // every block holds bs rows
  const int* trow;                         // this request's table row
  int bs, g, hd;

  // element offset of row 0 of tile ib for KV head kvh; a negative table
  // entry reads block 0, which the masks exclude
  __device__ __forceinline__ size_t tile(int ib, int kvh) const {
    int bid = trow[ib];
    bid = bid < 0 ? 0 : bid;
    return (static_cast<size_t>(bid) * bs * g + kvh) * hd;
  }
  __device__ __forceinline__ bool readable(int) const { return true; }
};

struct DenseRows {
  static constexpr bool kRagged = true;
  size_t base;                             // b * T * g * hd
  int T, bs, g, hd;

  __device__ __forceinline__ size_t tile(int ib, int kvh) const {
    return base + (static_cast<size_t>(ib) * bs * g + kvh) * hd;
  }
  __device__ __forceinline__ bool readable(int key) const { return key < T; }
};

// Every thread of the block stages tile ib: Ks/Vs are [bs][ld] fp32.
template <typename T, typename Rows>
__device__ __forceinline__ void stage_tile(const T* __restrict__ kp,
                                           const T* __restrict__ vp,
                                           const Rows& rows, int ib, int kvh,
                                           float* Ks, float* Vs, int ld) {
  const int bs = rows.bs, hd = rows.hd;
  const size_t t0 = rows.tile(ib, kvh);
  const size_t stride = static_cast<size_t>(rows.g) * hd;
  for (int e = threadIdx.x; e < bs * hd; e += blockDim.x) {
    const int j = e / hd, d = e - j * hd;
    float kx = 0.f, vx = 0.f;
    if (!Rows::kRagged || rows.readable(ib * bs + j)) {
      const size_t off = t0 + j * stride + d;
      kx = to_f(kp[off]);
      vx = to_f(vp[off]);
    }
    Ks[j * ld + d] = kx;
    Vs[j * ld + d] = vx;
  }
}

}  // namespace repro

// K/V row addressing of the attention walks (`paged_walk.cuh`,
// `tile_walk.cuh`), chosen at compile time so that neither layout pays a
// runtime branch for the other, and the asynchronous copies that fill the
// walks' shared-memory rings.
//
// A walk visits the keys of one (request, KV head) in tiles of `bs` keys.
// `PagedRows` names pool blocks [n_blocks, bs, g, hd] through one request's
// block table (tile ib is block trow[ib]); `DenseRows` reads contiguous rows
// [B, T, g, hd] (tile ib holds keys ib*bs .. ib*bs + bs - 1, the last tile
// ragged when T % bs != 0).  `row(key, kvh)` addresses one key's row, for a
// walk whose key tile is not the pool block; `contiguous` says when a run
// of keys is one stride apart, so the table is read once for the run.
// Every copy is a 16-byte `cp.async` (`cp_async16`): a row that may not be
// read is written as zeros instead (the masks exclude it, and zeros keep
// 0 * V finite).
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
  __device__ __forceinline__ size_t row(int key, int kvh) const {
    const int ib = key / bs;
    return tile(ib, kvh) + static_cast<size_t>(key - ib * bs) * g * hd;
  }
  // keys key0 .. key0 + n - 1 lie in one block: row(key0 + j) is row(key0)
  // + j * g * hd
  __device__ __forceinline__ bool contiguous(int key0, int n) const {
    return key0 % bs + n <= bs;
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
  __device__ __forceinline__ size_t row(int key, int kvh) const {
    return base + (static_cast<size_t>(key) * g + kvh) * hd;
  }
  __device__ __forceinline__ bool contiguous(int, int) const { return true; }
  __device__ __forceinline__ bool readable(int key) const { return key < T; }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; `ok` false writes 16 zero bytes
// (the source is not read).  Both addresses must be 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Every thread of the block issues its share of the copy of tile ib into
// Ks/Vs ([bs][ld] elements of T, ld * sizeof(T) a multiple of 16): the
// table is read once per tile, each row moves as 16-byte vectors.
template <typename T, typename Rows>
__device__ __forceinline__ void copy_tile_async(const T* __restrict__ kp,
                                                const T* __restrict__ vp,
                                                const Rows& rows, int ib,
                                                int kvh, T* Ks, T* Vs,
                                                int ld) {
  constexpr int VEC = 16 / sizeof(T);
  const int bs = rows.bs, cpr = rows.hd / VEC;   // vectors per row
  const size_t t0 = rows.tile(ib, kvh);
  const size_t stride = static_cast<size_t>(rows.g) * rows.hd;
  for (int e = threadIdx.x; e < bs * cpr; e += blockDim.x) {
    const int j = e / cpr, c = e - j * cpr;
    const bool ok = !Rows::kRagged || rows.readable(ib * bs + j);
    const size_t off = ok ? t0 + j * stride + c * VEC : 0;
    cp_async16(Ks + j * ld + c * VEC, kp + off, ok);
    cp_async16(Vs + j * ld + c * VEC, vp + off, ok);
  }
}

// Every thread of the block stages tile ib: Ks/Vs are [bs][ld] fp32 (the
// fp32 query-tile walk of `tile_walk.cuh`).
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

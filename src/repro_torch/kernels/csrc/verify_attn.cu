// Paged verify attention: an Sq-token chunk per request over its block table.
//
// Port of the Pallas kernel repro/kernels/decode_attn.py:254
// (`paged_verify_attention`, body `_paged_verify_kernel` :215).  The TPU grid
// (B, h, nbt) streams every K/V block once per QUERY head; here one thread
// block serves a (request, KV head) pair and the m = h/g query heads x Sq
// chunk positions of that group from one read of each K/V block.  Keys are
// valid for j <= pos + i and j < pos + lens; the walk stops at the key
// pos + lens - 1.  Bytes bound it (every valid K/V row read once for about
// Sq * m FLOPs a byte).  The element type and the chunk's Sq * m columns
// pick the walk:
//  * bf16, Sq * m <= SW_SPLIT_COLS (the crossover of `split_walk.cuh`;
//    the serving chunk is 5 positions x 4 heads): the split-key walk of
//    `split_walk.cuh`, grid (B, g, column groups of at most 32): every warp
//    walks keys in 32-key units through its own ring, the keys on the M
//    side of `mma.sync` and the group's columns on N (NT = ceil(columns /
//    8) column tiles), each column masked at its own position
//    (`ChunkKeys`), and the warps' partials merged at the end.  Above hd
//    128 a block holds fewer column tiles (`split_max_nt`), so the columns
//    take more groups;
//  * bf16 above the crossover: the tensor-core query-tile walk of
//    `tile_walk.cuh` (the chunk is a query tile of Sq positions x m heads,
//    64 / m positions a tile);
//  * fp32: the CUDA-core walk of `paged_walk.cuh` (several rows a warp;
//    more than 64 rows take several thread blocks).
// The finalize divides by l clamped at 1e-30, so a row with no valid key
// (pos = lens = 0: an inactive decode row on the null block) gives exact
// zeros.
#include "split_walk.cuh"
#include "paged_walk.cuh"

namespace {

using bf16 = __nv_bfloat16;

// grid (B, g, row groups or query tiles); HD: the bf16 walk's head dim (0
// for fp32)
template <typename T, int HD>
__global__ void __launch_bounds__(repro::ChunkThreads<T, HD>::value)
paged_verify_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ tables,
                    const int* __restrict__ pos, const int* __restrict__ lens,
                    T* __restrict__ out, int h, int g, int hd, int bs,
                    int nbt, int sq, int per, int rpw, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int m = h / g;
  const int p = pos[b];
  const int kend = p + lens[b];
  const repro::PagedRows kv{tables + static_cast<size_t>(b) * nbt, bs, g, hd};
  if constexpr (std::is_same<T, float>::value) {
    const int g0 = blockIdx.z * per;
    const int rows = min(per, m * sq - g0);
    const repro::WalkState st = repro::chunk_walk<T>(
        q, kp, vp, kv, repro::ChunkMask{p, kend}, smem, b, kvh, h, g, sq, g0,
        rows, rpw, 0, repro::walk_blocks(kend, bs, nbt), scale);
    const int ni = hd / 32;
#pragma unroll
    for (int r = 0; r < repro::WALK_RPW; ++r) {
      if (r >= st.nr) continue;
      const int row = g0 + st.row0 + r;
      const int qh = row / sq, i = row - qh * sq;
      const float l = fmaxf(st.l[r], 1e-30f);
      float* ob = out + ((static_cast<size_t>(b) * sq + i) * h + kvh * m +
                         qh) * hd + (threadIdx.x & 31);
#pragma unroll
      for (int k = 0; k < repro::WALK_MAX_NI; ++k)
        if (k < ni) ob[32 * k] = st.acc[r][k] / l;
    }
  } else {
    repro::tile_walk<HD, repro::CHUNK_TILE>(
        q, kp, vp, kv, repro::PosMask<true>{0, min(kend, nbt * bs)},
        repro::Bf16Out{out, sq, h}, reinterpret_cast<bf16*>(smem), b,
        blockIdx.z, kvh, sq, h, g, p, scale);
  }
}

// grid (B, g, column groups of `per`), bf16: the split-key walk
template <int HD, int NT>
__global__ void __launch_bounds__(repro::SplitWalk<HD, NT>::kThreads)
paged_verify_split_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ kp,
                          const bf16* __restrict__ vp,
                          const int* __restrict__ tables,
                          const int* __restrict__ pos,
                          const int* __restrict__ lens, bf16* __restrict__ out,
                          int h, int g, int bs, int nbt, int sq, int per,
                          float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, m = h / g;
  const int p = pos[b];
  const repro::PagedRows kv{tables + static_cast<size_t>(b) * nbt, bs, g, HD};
  const repro::Cols cols = repro::Cols::group(sq, m, per, blockIdx.z);
  repro::split_walk<HD, NT>(
      q, kp, vp, kv,
      repro::ChunkKeys::of(p, min(p + lens[b], nbt * bs), cols.c0 / m,
                           (cols.c0 + cols.n - 1) / m),
      cols, out, reinterpret_cast<bf16*>(smem), b, blockIdx.y, h, g, scale);
}

// The chunk's columns on the split walk in groups of at most 32
// (`SplitGroups`), one block each.
template <int HD>
cudaError_t launch_split(const void* q, const void* kp, const void* vp,
                         const int* tables, const int* pos, const int* lens,
                         void* out, int B, int h, int g, int bs, int nbt,
                         int sq, float scale, cudaStream_t stream) {
  const repro::SplitGroups sg = repro::SplitGroups::of<HD>(sq * (h / g));
  if (sg.groups > 65535) return cudaErrorInvalidValue;
  return repro::with_nt<HD>(sg.nt, [&](auto NT) {
    using W = repro::SplitWalk<HD, decltype(NT)::value>;
    auto kern = paged_verify_split_kernel<HD, decltype(NT)::value>;
    cudaError_t e = repro::allow_smem(kern, W::kSmem);
    if (e != cudaSuccess) return e;
    kern<<<dim3(B, g, sg.groups), W::kThreads, W::kSmem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(kp),
        static_cast<const bf16*>(vp), tables, pos, lens,
        static_cast<bf16*>(out), h, g, bs, nbt, sq, sg.per, scale);
    return cudaGetLastError();
  });
}

// `split`: bf16 on the split-key walk, else on the query-tile walk.
template <typename T>
cudaError_t launch_t(const void* q, const void* kp, const void* vp,
                     const int* tables, const int* pos, const int* lens,
                     void* out, int B, int h, int g, int hd, int bs, int nbt,
                     int sq, float scale, bool split, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (split)
      return repro::with_hd(hd, [&](auto HD) {
        return launch_split<decltype(HD)::value>(q, kp, vp, tables, pos, lens,
                                                 out, B, h, g, bs, nbt, sq,
                                                 scale, stream);
      });
  }
  auto go = [&](auto HD, int nz, int threads, size_t smem, int per,
                int rpw) {
    auto kern = paged_verify_kernel<T, decltype(HD)::value>;
    cudaError_t e = repro::allow_smem(kern, smem);
    if (e != cudaSuccess) return e;
    kern<<<dim3(B, g, nz), threads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(kp),
        static_cast<const T*>(vp), tables, pos, lens, static_cast<T*>(out), h,
        g, hd, bs, nbt, sq, per, rpw, scale);
    return cudaGetLastError();
  };
  return repro::launch_chunk<T>(h, g, hd, bs, sq, go);
}

// walk: 0 the split-key walk, 1 the query-tile walk (bf16 only), -1 the
// route of `SW_SPLIT_COLS`
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* tables, const void* pos, const void* lens, void* out,
           int B, int sq, int h, int g, int hd, int bs, int nbt, float scale,
           int dtype, int walk, void* stream) {
  if (B <= 0 || sq <= 0) return 0;
  if (g <= 0 || h % g != 0 || hd % 32 != 0 ||
      hd > 32 * repro::WALK_MAX_NI || bs <= 0 || nbt <= 0 || g > 65535 ||
      walk < -1 || walk > 1 || (walk >= 0 && dtype != DT_BF16))
    return cudaErrorInvalidValue;
  const bool split = walk < 0 ? sq * (h / g) <= repro::SW_SPLIT_COLS
                              : walk == 0;
  const int* tb = static_cast<const int*>(tables);
  const int* ps = static_cast<const int*>(pos);
  const int* ln = static_cast<const int*>(lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == DT_F32)
    e = launch_t<float>(q, k_pool, v_pool, tb, ps, ln, out, B, h, g, hd, bs,
                        nbt, sq, scale, false, s);
  else if (dtype == DT_BF16)
    e = launch_t<bf16>(q, k_pool, v_pool, tb, ps, ln, out, B, h, g, hd, bs,
                       nbt, sq, scale, split, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

}  // namespace

extern "C" int paged_verify_launch(const void* q, const void* k_pool,
                                   const void* v_pool, const void* tables,
                                   const void* pos, const void* lens,
                                   void* out, int B, int sq, int h, int g,
                                   int hd, int bs, int nbt, float scale,
                                   int dtype, void* stream) {
  return launch(q, k_pool, v_pool, tables, pos, lens, out, B, sq, h, g, hd,
                bs, nbt, scale, dtype, -1, stream);
}

// bf16 on the walk `walk` names (0 split-key, 1 query-tile) at any width:
// what `chip_smoke.py --chunk-routes` times on each side of the crossover.
extern "C" int paged_verify_walk_launch(const void* q, const void* k_pool,
                                        const void* v_pool,
                                        const void* tables, const void* pos,
                                        const void* lens, void* out, int B,
                                        int sq, int h, int g, int hd, int bs,
                                        int nbt, float scale, int walk,
                                        void* stream) {
  return launch(q, k_pool, v_pool, tables, pos, lens, out, B, sq, h, g, hd,
                bs, nbt, scale, DT_BF16, walk, stream);
}

// Paged prefill attention: suffix-only prefill over a block-table KV pool.
//
// Port of the Pallas kernel repro/kernels/prefill_attn.py:78
// (`paged_prefill_attention`, body :34).  Request b contributes Sq suffix
// queries at absolute positions cached[b] + i; its keys (shared prefix and
// this suffix, both already written to the pool) are valid for
// j < cached[b] + seg[b], and causal by absolute position (j <= q position).
// Bytes bound it at the suffix lengths of serving (about 2 * Sq * h/g FLOPs
// a byte of K/V).  The suffix's Sq * m columns (m = h/g query heads x Sq
// positions, packed position-major) pick the walk:
//  * bf16, Sq * m <= SW_SPLIT_COLS (the crossover of `split_walk.cuh`):
//    the split-key walk of `split_walk.cuh`, one thread block per (KV head,
//    request, group of at most 32 columns), grid (g, B, groups): every warp
//    walks keys in 32-key units through its own ring, with the keys on the
//    M side of `mma.sync` and the group's columns on N, each column masked
//    at its own position (`ChunkKeys`), and only the keys the group's last
//    position sees are read: a request's K/V once per group, the second
//    time mostly from L2;
//  * bf16 above the crossover: one block per (KV head, request, query
//    tile), the query-tile walk of `tile_walk.cuh` (shared with the flash
//    attention kernel) over 32-key tiles (one pool block at the engine's
//    block size): K/V read once per 64 / m positions;
//  * fp32: the CUDA-core query-tile walk, one pool block at a time.
// Later groups and tiles see more keys and are launched first.  Rows with
// no valid key (seg == 0 padding rows) finalize to 0.
#include "split_walk.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BF16_TILE = 32;   // keys per tile of the bf16 walk

template <typename T, int HD>
struct Shape;
template <int HD>
struct Shape<float, HD> {
  static constexpr int kThreads = repro::TW_WARPS * 32;
  static size_t smem(int bs, int hd) {
    return repro::tile_walk_smem_bytes(bs, hd);
  }
};
template <int HD>
struct Shape<bf16, HD> {
  using W = repro::TcWalk<HD, BF16_TILE>;
  static constexpr int kThreads = W::kThreads;
  static size_t smem(int, int) { return W::kSmem; }
};

template <typename T, int HD>
__global__ void __launch_bounds__(Shape<T, HD>::kThreads)
paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                     const T* __restrict__ vp, const int* __restrict__ tables,
                     const int* __restrict__ cached,
                     const int* __restrict__ seg, T* __restrict__ out, int Sq,
                     int h, int g, int hd, int bs, int nbt, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int iq = gridDim.z - 1 - blockIdx.z;
  const int c0 = cached[b];
  const repro::PagedRows kv{tables + static_cast<size_t>(b) * nbt, bs, g, hd};
  if constexpr (std::is_same<T, float>::value)
    repro::tile_walk<repro::PagedRows, true>(
        q, kp, vp, kv, out, reinterpret_cast<float*>(smem), b, iq, kvh, Sq,
        h, g, c0, c0 + seg[b], nbt, scale);
  else
    repro::tile_walk<HD, BF16_TILE>(
        q, kp, vp, kv, repro::PosMask<true>{0, min(c0 + seg[b], nbt * bs)},
        repro::Bf16Out{out, Sq, h}, reinterpret_cast<bf16*>(smem), b, iq, kvh,
        Sq, h, g, c0, scale);
}

// grid (g, B, column groups of `per`), bf16: the split-key walk
template <int HD, int NT>
__global__ void __launch_bounds__(repro::SplitWalk<HD, NT>::kThreads)
paged_prefill_split_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ kp,
                           const bf16* __restrict__ vp,
                           const int* __restrict__ tables,
                           const int* __restrict__ cached,
                           const int* __restrict__ seg,
                           bf16* __restrict__ out, int Sq, int h, int g,
                           int bs, int nbt, int per, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kvh = blockIdx.x, b = blockIdx.y, m = h / g;
  const int c0 = cached[b];
  const repro::PagedRows kv{tables + static_cast<size_t>(b) * nbt, bs, g, HD};
  const repro::Cols cols =
      repro::Cols::group(Sq, m, per, gridDim.z - 1 - blockIdx.z);
  repro::split_walk<HD, NT>(
      q, kp, vp, kv,
      repro::ChunkKeys::of(c0, min(c0 + seg[b], nbt * bs), cols.c0 / m,
                           (cols.c0 + cols.n - 1) / m),
      cols, out, reinterpret_cast<bf16*>(smem), b, kvh, h, g, scale);
}

// The columns of each request in groups of at most 32 (`SplitGroups`),
// one block each.
template <int HD>
cudaError_t launch_split(const void* q, const void* kp, const void* vp,
                         const int* tables, const int* cached,
                         const int* seg, void* out, int B, int Sq, int h,
                         int g, int bs, int nbt, float scale,
                         cudaStream_t stream) {
  const repro::SplitGroups sg = repro::SplitGroups::of<HD>(Sq * (h / g));
  if (sg.groups > 65535) return cudaErrorInvalidValue;
  return repro::with_nt<HD>(sg.nt, [&](auto NT) {
    using W = repro::SplitWalk<HD, decltype(NT)::value>;
    auto kern = paged_prefill_split_kernel<HD, decltype(NT)::value>;
    cudaError_t e = repro::allow_smem(kern, W::kSmem);
    if (e != cudaSuccess) return e;
    kern<<<dim3(g, B, sg.groups), W::kThreads, W::kSmem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(kp),
        static_cast<const bf16*>(vp), tables, cached, seg,
        static_cast<bf16*>(out), Sq, h, g, bs, nbt, sg.per, scale);
    return cudaGetLastError();
  });
}

template <typename T, int HD>
cudaError_t launch_t(const void* q, const void* kp, const void* vp,
                     const int* tables, const int* cached, const int* seg,
                     void* out, int B, int Sq, int h, int g, int hd, int bs,
                     int nbt, float scale, cudaStream_t stream) {
  const int bq = repro::TW_ROWS / (h / g);
  const size_t smem = Shape<T, HD>::smem(bs, hd);
  auto kern = paged_prefill_kernel<T, HD>;
  cudaError_t e = repro::allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(g, B, (Sq + bq - 1) / bq);
  kern<<<grid, Shape<T, HD>::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), tables, cached, seg, static_cast<T*>(out),
      Sq, h, g, hd, bs, nbt, scale);
  return cudaGetLastError();
}

// walk: 0 the split-key walk, 1 the query-tile walk (bf16 only), -1 the
// route of `SW_SPLIT_COLS`
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* tables, const void* cached, const void* seg, void* out,
           int B, int Sq, int h, int g, int hd, int bs, int nbt, float scale,
           int dtype, int walk, void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  if (g <= 0 || h % g != 0 || repro::TW_ROWS % (h / g) != 0 ||
      hd % 32 != 0 || hd > 32 * repro::TW_MAX_NI || bs <= 0 || nbt <= 0 ||
      g > 65535 || B > 65535 ||
      (Sq + repro::TW_ROWS / (h / g) - 1) / (repro::TW_ROWS / (h / g)) >
          65535 ||
      walk < -1 || walk > 1 || (walk >= 0 && dtype != DT_BF16))
    return cudaErrorInvalidValue;
  const bool split = walk < 0 ? Sq * (h / g) <= repro::SW_SPLIT_COLS
                              : walk == 0;
  const int* tb = static_cast<const int*>(tables);
  const int* cl = static_cast<const int*>(cached);
  const int* sl = static_cast<const int*>(seg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == DT_F32)
    e = launch_t<float, 0>(q, k_pool, v_pool, tb, cl, sl, out, B, Sq, h, g,
                           hd, bs, nbt, scale, s);
  else if (dtype == DT_BF16)
    e = repro::with_hd(hd, [&](auto HD) {
      if (split)
        return launch_split<decltype(HD)::value>(q, k_pool, v_pool, tb, cl,
                                                 sl, out, B, Sq, h, g, bs,
                                                 nbt, scale, s);
      return launch_t<bf16, decltype(HD)::value>(q, k_pool, v_pool, tb, cl,
                                                 sl, out, B, Sq, h, g, hd, bs,
                                                 nbt, scale, s);
    });
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

}  // namespace

extern "C" int paged_prefill_launch(const void* q, const void* k_pool,
                                    const void* v_pool, const void* tables,
                                    const void* cached, const void* seg,
                                    void* out, int B, int Sq, int h, int g,
                                    int hd, int bs, int nbt, float scale,
                                    int dtype, void* stream) {
  return launch(q, k_pool, v_pool, tables, cached, seg, out, B, Sq, h, g, hd,
                bs, nbt, scale, dtype, -1, stream);
}

// bf16 on the walk `walk` names (0 split-key, 1 query-tile) at any length:
// what `chip_smoke.py --chunk-routes` times on each side of the crossover.
extern "C" int paged_prefill_walk_launch(const void* q, const void* k_pool,
                                         const void* v_pool,
                                         const void* tables,
                                         const void* cached, const void* seg,
                                         void* out, int B, int Sq, int h,
                                         int g, int hd, int bs, int nbt,
                                         float scale, int walk,
                                         void* stream) {
  return launch(q, k_pool, v_pool, tables, cached, seg, out, B, Sq, h, g, hd,
                bs, nbt, scale, DT_BF16, walk, stream);
}

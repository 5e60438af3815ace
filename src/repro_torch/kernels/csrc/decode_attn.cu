// Decode attention, one query per request: over a block table (paged) or
// over the request's dense cache row (linear or rolling).
//
// Ports of the Pallas kernels in repro/kernels/decode_attn.py:
// `paged_decode_attention` (:154, body :117) and `decode_attention` (:67,
// body :23).  The TPU grids (B, h, ...) stream every K/V tile once per QUERY
// head; here one thread block serves a (request, KV head) pair and all m =
// h/g query heads of that group from one read of each K/V row:
//  * paged: pool blocks named by the table; keys j <= pos are valid, and the
//    walk stops at the key `pos` (table entries < 0 read block 0, which the
//    mask excludes);
//  * dense: the row's S slots in 32-slot tiles; slot j holds position k_pos
//    = j + S*floor((pos - j)/S) when window > 0 (rolling), else j; keys with
//    0 <= k_pos <= pos (and pos - k_pos < window) are valid.  With window 0
//    the walk stops at slot min(pos, S - 1); a rolling row walks all S
//    slots (the split-key walk skips its tiles that hold no valid slot).
// Both are bytes-bound (every valid K/V row read once for ~m FLOPs a byte).
// The element type and the group size pick the walk at compile time:
//  * bf16, m <= 8, paged and dense: the split-key walk of
//    `split_walk.cuh` with one column tile (NT = 1, the m heads of one
//    position): every warp (eight up to hd 128, four above) walks keys
//    (32-key units dealt in turn), each through its own three-stage ring
//    of 16-key `cp.async` tiles, with transposed `mma.sync` products (keys
//    on M, heads on N), and the warps' partials merged in warp order at
//    the end.  Paged units read the table once; a dense unit is one run
//    of rows (`DenseRows`), no slot >= S is read, and the key mask
//    `RowArc` admits the row's valid slots: a prefix (window 0) or the
//    rolling arc, whose tiles without a valid slot are skipped;
//  * bf16 with m > 8: the tensor-core query-tile walk of `tile_walk.cuh`
//    (the group's m heads are the rows of a one-position query tile);
//  * fp32: the CUDA-core walk of `paged_walk.cuh` (the m heads shared among
//    the block's warps).
// A row with no valid key finalizes to 0 (l clamped at 1e-30).
#include "split_walk.cuh"
#include "paged_walk.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int DENSE_TILE = 32;   // dense slots per tile of the fp32 walk

// Dense rows for the bf16 query-tile walk (m > 8): the rolling mask over
// slots [0, hi).
struct SlotMask {
  repro::RollingMask roll;
  int lo, hi;
  __device__ __forceinline__ int end(int) const { return hi; }
  __device__ __forceinline__ bool operator()(int j, int) const {
    return j < hi && roll(j, 0);
  }
  __device__ __forceinline__ bool whole(int, int, int) const { return false; }
};

// Each warp of the fp32 walk writes its rows (query heads: the chunk is
// one token).
__device__ __forceinline__ void write_out(const repro::WalkState& st,
                                          float* __restrict__ out, int b,
                                          int h, int g, int hd) {
  const int m = h / g;
  const int ni = hd / 32;
#pragma unroll
  for (int r = 0; r < repro::WALK_RPW; ++r) {
    if (r >= st.nr) continue;
    const float l = fmaxf(st.l[r], 1e-30f);
    float* ob = out + (static_cast<size_t>(b) * h + blockIdx.y * m +
                       st.row0 + r) * hd + (threadIdx.x & 31);
#pragma unroll
    for (int i = 0; i < repro::WALK_MAX_NI; ++i)
      if (i < ni) ob[32 * i] = st.acc[r][i] / l;
  }
}

// grid (B, g); q [B, h, hd] is the [B, 1, h, hd] chunk of one token at
// pos.  HD: the bf16 walk's head dim (0 for fp32).
template <typename T, int HD>
__global__ void __launch_bounds__(repro::ChunkThreads<T, HD>::value)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ tables,
                    const int* __restrict__ pos, T* __restrict__ out, int h,
                    int g, int hd, int bs, int nbt, int rpw, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int p = pos[b];
  const repro::PagedRows kv{tables + static_cast<size_t>(b) * nbt, bs, g, hd};
  if constexpr (std::is_same<T, float>::value) {
    const repro::WalkState st = repro::chunk_walk<T>(
        q, kp, vp, kv, repro::ChunkMask{p, p + 1}, smem, b, kvh, h, g, 1, 0,
        h / g, rpw, 0, repro::walk_blocks(p + 1, bs, nbt), scale);
    write_out(st, out, b, h, g, hd);
  } else {
    repro::tile_walk<HD, repro::CHUNK_TILE>(
        q, kp, vp, kv, repro::PosMask<true>{0, min(p + 1, nbt * bs)},
        repro::Bf16Out{out, 1, h}, reinterpret_cast<bf16*>(smem), b, 0, kvh,
        1, h, g, p, scale);
  }
}

// grid (B, g), bf16, m = h/g <= SW_MAX_M: the split-key walk
template <int HD>
__global__ void __launch_bounds__(repro::SplitWalk<HD>::kThreads)
paged_decode_split_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ kp,
                          const bf16* __restrict__ vp,
                          const int* __restrict__ tables,
                          const int* __restrict__ pos, bf16* __restrict__ out,
                          int h, int g, int bs, int nbt, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const repro::PagedRows kv{tables + static_cast<size_t>(b) * nbt, bs, g, HD};
  repro::split_walk<HD, 1>(q, kp, vp, kv,
                           repro::KeyPrefix{min(pos[b] + 1, nbt * bs)},
                           repro::Cols{1, 0, h / g}, out,
                           reinterpret_cast<bf16*>(smem), b, blockIdx.y, h,
                           g, scale);
}

// The valid slots of a dense row for the query at pos, as the split-key
// walk's key mask: [0, a) and [c, kend), a <= c <= kend.  They are the
// slots `RollingMask` admits: with window 0 the prefix [0, min(pos + 1,
// S)); with window > 0 the slots holding positions pos - window + 1 ..
// pos, an arc of the row that wraps past slot S - 1 to slot 0 once pos >=
// S (then [0, pos % S] and [pos % S - window + 1 + S, S)).
struct RowArc {
  int a, c, kend;
  static __device__ __forceinline__ RowArc of(int pos, int S, int window) {
    if (pos < 0) return {0, 0, 0};
    if (window <= 0) return {0, 0, min(pos + 1, S)};
    if (pos < S) return {0, max(0, pos - window + 1), pos + 1};
    if (window >= S) return {0, 0, S};
    const int p = pos % S, lo = p - window + 1;
    return lo >= 0 ? RowArc{0, lo, p + 1} : RowArc{p + 1, lo + S, S};
  }
  __device__ __forceinline__ bool any(int k0, int k1) const {
    return k0 < a || (k1 > c && k0 < kend);
  }
  __device__ __forceinline__ bool whole(int k0, int k1) const {
    return k1 <= a || (k0 >= c && k1 <= kend);
  }
  __device__ __forceinline__ bool operator()(int j, int) const {
    return j < a || (j >= c && j < kend);
  }
};

// grid (B, g), bf16, m = h/g <= SW_MAX_M: the split-key walk over dense
// rows (every 32-slot unit one run of rows: no table)
template <int HD>
__global__ void __launch_bounds__(repro::SplitWalk<HD>::kThreads)
dense_decode_split_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const int* __restrict__ pos, bf16* __restrict__ out,
                          int h, int g, int S, int window, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const repro::DenseRows kv{static_cast<size_t>(b) * S * g * HD, S,
                            repro::SW_UNIT, g, HD};
  repro::split_walk<HD, 1>(q, k, v, kv, RowArc::of(pos[b], S, window),
                           repro::Cols{1, 0, h / g}, out,
                           reinterpret_cast<bf16*>(smem), b, blockIdx.y, h,
                           g, scale);
}

template <typename T, int HD>
__global__ void __launch_bounds__(repro::ChunkThreads<T, HD>::value)
dense_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ pos,
                    T* __restrict__ out, int h, int g, int hd, int S,
                    int window, int rpw, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int p = pos[b];
  const int span = window > 0 ? S : min(p + 1, S);
  const repro::RollingMask roll{p, S, window};
  const size_t base = static_cast<size_t>(b) * S * g * hd;
  if constexpr (std::is_same<T, float>::value) {
    const repro::DenseRows kv{base, S, DENSE_TILE, g, hd};
    const repro::WalkState st = repro::chunk_walk<T>(
        q, k, v, kv, roll, smem, b, kvh, h, g, 1, 0, h / g, rpw, 0,
        repro::walk_blocks(span, DENSE_TILE,
                           (S + DENSE_TILE - 1) / DENSE_TILE),
        scale);
    write_out(st, out, b, h, g, hd);
  } else {
    const repro::DenseRows kv{base, S, repro::CHUNK_TILE, g, hd};
    repro::tile_walk<HD, repro::CHUNK_TILE>(
        q, k, v, kv, SlotMask{roll, 0, span}, repro::Bf16Out{out, 1, h},
        reinterpret_cast<bf16*>(smem), b, 0, kvh, 1, h, g, p, scale);
  }
}

template <typename T>
cudaError_t paged_t(const void* q, const void* kp, const void* vp,
                    const int* tables, const int* pos, void* out, int B,
                    int h, int g, int hd, int bs, int nbt, float scale,
                    cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (h / g <= repro::SW_MAX_M) {
      return repro::with_hd(hd, [&](auto HD) {
        using W = repro::SplitWalk<decltype(HD)::value>;
        auto kern = paged_decode_split_kernel<decltype(HD)::value>;
        cudaError_t e = repro::allow_smem(kern, W::kSmem);
        if (e != cudaSuccess) return e;
        kern<<<dim3(B, g), W::kThreads, W::kSmem, stream>>>(
            static_cast<const bf16*>(q), static_cast<const bf16*>(kp),
            static_cast<const bf16*>(vp), tables, pos,
            static_cast<bf16*>(out), h, g, bs, nbt, scale);
        return cudaGetLastError();
      });
    }
  }
  auto go = [&](auto HD, int nz, int threads, size_t smem, int, int rpw) {
    auto kern = paged_decode_kernel<T, decltype(HD)::value>;
    cudaError_t e = repro::allow_smem(kern, smem);
    if (e != cudaSuccess) return e;
    kern<<<dim3(B, g, nz), threads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(kp),
        static_cast<const T*>(vp), tables, pos, static_cast<T*>(out), h, g,
        hd, bs, nbt, rpw, scale);
    return cudaGetLastError();
  };
  return repro::launch_chunk<T>(h, g, hd, bs, 1, go);
}

template <typename T>
cudaError_t dense_t(const void* q, const void* k, const void* v,
                    const int* pos, void* out, int B, int h, int g, int hd,
                    int S, int window, float scale, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (h / g <= repro::SW_MAX_M) {
      return repro::with_hd(hd, [&](auto HD) {
        using W = repro::SplitWalk<decltype(HD)::value>;
        auto kern = dense_decode_split_kernel<decltype(HD)::value>;
        cudaError_t e = repro::allow_smem(kern, W::kSmem);
        if (e != cudaSuccess) return e;
        kern<<<dim3(B, g), W::kThreads, W::kSmem, stream>>>(
            static_cast<const bf16*>(q), static_cast<const bf16*>(k),
            static_cast<const bf16*>(v), pos, static_cast<bf16*>(out), h, g,
            S, window, scale);
        return cudaGetLastError();
      });
    }
  }
  auto go = [&](auto HD, int nz, int threads, size_t smem, int, int rpw) {
    auto kern = dense_decode_kernel<T, decltype(HD)::value>;
    cudaError_t e = repro::allow_smem(kern, smem);
    if (e != cudaSuccess) return e;
    kern<<<dim3(B, g, nz), threads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), pos, static_cast<T*>(out), h, g, hd, S,
        window, rpw, scale);
    return cudaGetLastError();
  };
  return repro::launch_chunk<T>(h, g, hd, DENSE_TILE, 1, go);
}

bool bad_heads(int h, int g, int hd) {
  return g <= 0 || h % g != 0 || h / g > 32 || hd % 32 != 0 ||
         hd > 32 * repro::WALK_MAX_NI || g > 65535;
}

}  // namespace

extern "C" int paged_decode_launch(const void* q, const void* k_pool,
                                   const void* v_pool, const void* tables,
                                   const void* pos, void* out, int B, int h,
                                   int g, int hd, int bs, int nbt,
                                   float scale, int dtype, void* stream) {
  if (B <= 0) return 0;
  if (bad_heads(h, g, hd) || bs <= 0 || nbt <= 0)
    return cudaErrorInvalidValue;
  const int* tb = static_cast<const int*>(tables);
  const int* ps = static_cast<const int*>(pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == DT_F32)
    e = paged_t<float>(q, k_pool, v_pool, tb, ps, out, B, h, g, hd, bs, nbt, scale, s);
  else if (dtype == DT_BF16)
    e = paged_t<bf16>(q, k_pool, v_pool, tb, ps, out, B, h, g, hd, bs, nbt, scale, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

extern "C" int dense_decode_launch(const void* q, const void* k,
                                   const void* v, const void* pos, void* out,
                                   int B, int h, int g, int hd, int S,
                                   int window, float scale, int dtype,
                                   void* stream) {
  if (B <= 0) return 0;
  if (bad_heads(h, g, hd) || S <= 0) return cudaErrorInvalidValue;
  const int* ps = static_cast<const int*>(pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == DT_F32)
    e = dense_t<float>(q, k, v, ps, out, B, h, g, hd, S, window, scale, s);
  else if (dtype == DT_BF16)
    e = dense_t<bf16>(q, k, v, ps, out, B, h, g, hd, S, window, scale, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

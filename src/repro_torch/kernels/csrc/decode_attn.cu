// Decode attention, one query per request: over a block table (paged) or
// over the request's dense cache row (linear or rolling).
//
// Ports of the Pallas kernels in repro/kernels/decode_attn.py:
// `paged_decode_attention` (:154, body :117) and `decode_attention` (:67,
// body :23).  The TPU grids (B, h, ...) stream every K/V tile once per QUERY
// head; here one thread block serves a (request, KV head) pair and all m =
// h/g query heads of that group (one warp each) from one read of each tile.
// Both are the walk of `paged_walk.cuh` with a one-token chunk:
//  * paged: 32-key pool blocks named by the table; keys j <= pos are valid,
//    and the walk stops at the block holding `pos` (table entries < 0 read
//    block 0, which the mask excludes);
//  * dense: the row's S slots in 32-slot tiles; slot j holds position k_pos
//    = j + S*floor((pos - j)/S) when window > 0 (rolling), else j; keys with
//    0 <= k_pos <= pos (and pos - k_pos < window) are valid.  With window 0
//    the walk stops at the tile holding slot min(pos, S - 1); a rolling row
//    walks all S slots.
// A row with no valid key finalizes to 0 (l clamped at 1e-30).
#include "paged_walk.cuh"

namespace {

constexpr int DENSE_TILE = 32;   // dense slots staged per step

template <typename T>
__device__ __forceinline__ void write_out(const repro::WalkState& st,
                                          T* __restrict__ out, int b, int h,
                                          int g, int hd) {
  const int m = h / g;
  const int qh = threadIdx.x >> 5;   // this warp's query head in the group
  const float l = fmaxf(st.l, 1e-30f);
  T* ob = out + (static_cast<size_t>(b) * h + blockIdx.y * m + qh) * hd +
          (threadIdx.x & 31);
  const int ni = hd / 32;
#pragma unroll
  for (int i = 0; i < repro::WALK_MAX_NI; ++i)
    if (i < ni) ob[32 * i] = repro::from_f<T>(st.acc[i] / l);
}

template <typename T>
__global__ void paged_decode_kernel(const T* __restrict__ q,
                                    const T* __restrict__ kp,
                                    const T* __restrict__ vp,
                                    const int* __restrict__ tables,
                                    const int* __restrict__ pos,
                                    T* __restrict__ out, int h, int g, int hd,
                                    int bs, int nbt, float scale) {
  extern __shared__ float sm[];
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int p = pos[b];
  // q [B, h, hd] is the [B, 1, h, hd] chunk of one token at pos
  const repro::PagedRows kv{tables + static_cast<size_t>(b) * nbt, bs, g, hd};
  const repro::WalkState st = repro::chunk_walk<T>(
      q, kp, vp, kv, repro::ChunkMask{p, p + 1}, sm, b, kvh, h, g, 1, 0,
      h / g, 0, repro::walk_blocks(p + 1, bs, nbt), scale);
  write_out<T>(st, out, b, h, g, hd);
}

template <typename T>
__global__ void dense_decode_kernel(const T* __restrict__ q,
                                    const T* __restrict__ k,
                                    const T* __restrict__ v,
                                    const int* __restrict__ pos,
                                    T* __restrict__ out, int h, int g, int hd,
                                    int S, int window, float scale) {
  extern __shared__ float sm[];
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int p = pos[b];
  const int span = window > 0 ? S : min(p + 1, S);
  const repro::DenseRows kv{static_cast<size_t>(b) * S * g * hd, S,
                            DENSE_TILE, g, hd};
  const repro::WalkState st = repro::chunk_walk<T>(
      q, k, v, kv, repro::RollingMask{p, S, window}, sm, b, kvh, h, g, 1, 0,
      h / g, 0,
      repro::walk_blocks(span, DENSE_TILE, (S + DENSE_TILE - 1) / DENSE_TILE),
      scale);
  write_out<T>(st, out, b, h, g, hd);
}

template <typename T>
cudaError_t paged_t(const void* q, const void* kp, const void* vp,
                    const int* tables, const int* pos, void* out, int B,
                    int h, int g, int hd, int bs, int nbt, float scale,
                    cudaStream_t stream) {
  const int m = h / g;
  const size_t smem = repro::walk_smem_bytes(bs, hd, m);
  cudaError_t e = repro::allow_smem(paged_decode_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  paged_decode_kernel<T><<<dim3(B, g), 32 * m, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), tables, pos, static_cast<T*>(out), h, g, hd,
      bs, nbt, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dense_t(const void* q, const void* k, const void* v,
                    const int* pos, void* out, int B, int h, int g, int hd,
                    int S, int window, float scale, cudaStream_t stream) {
  const int m = h / g;
  const size_t smem = repro::walk_smem_bytes(DENSE_TILE, hd, m);
  cudaError_t e = repro::allow_smem(dense_decode_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  dense_decode_kernel<T><<<dim3(B, g), 32 * m, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos, static_cast<T*>(out), h, g, hd, S,
      window, scale);
  return cudaGetLastError();
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
    e = paged_t<__nv_bfloat16>(q, k_pool, v_pool, tb, ps, out, B, h, g, hd, bs, nbt, scale, s);
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
    e = dense_t<__nv_bfloat16>(q, k, v, ps, out, B, h, g, hd, S, window, scale, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

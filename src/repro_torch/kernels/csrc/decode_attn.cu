// Paged decode attention: one query per request over its block table.
//
// Port of the Pallas kernel repro/kernels/decode_attn.py:154
// (`paged_decode_attention`, body :117).  The TPU grid (B, h, nbt) streams
// every K/V block once per QUERY head; here one block serves a (request, KV
// head) pair and all m = h/g query heads of that group (one warp each) from
// one read of each K/V block.  The walk is the verify kernel's
// (`paged_walk.cuh`) with a one-token chunk: it stops at the block holding
// `pos`, and keys j <= pos are valid.  A row with no valid key finalizes to 0
// (l clamped at 1e-30).  Table entries < 0 read block 0.
#include "paged_walk.cuh"

namespace {

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
  const int m = h / g;
  const int p = pos[b];
  // q [B, h, hd] is the [B, 1, h, hd] chunk of one token at pos
  const repro::WalkState st = repro::chunk_walk<T>(
      q, kp, vp, tables + static_cast<size_t>(b) * nbt, sm, b, kvh, h, g, hd,
      bs, 1, 0, m, p, p + 1, 0, repro::walk_blocks(p + 1, bs, nbt), scale);
  const int qh = threadIdx.x >> 5;   // this warp's query head in the group
  const float l = fmaxf(st.l, 1e-30f);
  T* ob = out + (static_cast<size_t>(b) * h + kvh * m + qh) * hd +
          (threadIdx.x & 31);
  const int ni = hd / 32;
#pragma unroll
  for (int i = 0; i < repro::WALK_MAX_NI; ++i)
    if (i < ni) ob[32 * i] = repro::from_f<T>(st.acc[i] / l);
}

template <typename T>
cudaError_t launch_t(const void* q, const void* kp, const void* vp,
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

}  // namespace

extern "C" int paged_decode_launch(const void* q, const void* k_pool,
                                   const void* v_pool, const void* tables,
                                   const void* pos, void* out, int B, int h,
                                   int g, int hd, int bs, int nbt,
                                   float scale, int dtype, void* stream) {
  if (B <= 0) return 0;
  if (g <= 0 || h % g != 0 || h / g > 32 || hd % 32 != 0 ||
      hd > 32 * repro::WALK_MAX_NI || bs <= 0 || nbt <= 0)
    return cudaErrorInvalidValue;
  const int* tb = static_cast<const int*>(tables);
  const int* ps = static_cast<const int*>(pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == DT_F32)
    e = launch_t<float>(q, k_pool, v_pool, tb, ps, out, B, h, g, hd, bs, nbt, scale, s);
  else if (dtype == DT_BF16)
    e = launch_t<__nv_bfloat16>(q, k_pool, v_pool, tb, ps, out, B, h, g, hd, bs, nbt, scale, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

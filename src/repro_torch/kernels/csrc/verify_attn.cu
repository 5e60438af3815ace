// Paged verify attention: an Sq-token chunk per request over its block table.
//
// Port of the Pallas kernel repro/kernels/decode_attn.py:254
// (`paged_verify_attention`, body `_paged_verify_kernel` :215).  The TPU grid
// (B, h, nbt) streams every K/V block once per QUERY head; here one thread
// block serves a (request, KV head) pair and all m = h/g query heads x Sq
// chunk rows of that group (one warp per row, at most 16 rows per thread
// block) from one read of each K/V block (`paged_walk.cuh`).  The walk stops
// at the block holding key pos + lens - 1; keys are valid for j <= pos + i
// and j < pos + lens.  The finalize divides by l clamped at 1e-30, so a row
// with no valid key (pos = lens = 0: an inactive decode row on the null
// block) gives exact zeros.
#include "paged_walk.cuh"

namespace {

template <typename T>
__global__ void paged_verify_kernel(const T* __restrict__ q,
                                    const T* __restrict__ kp,
                                    const T* __restrict__ vp,
                                    const int* __restrict__ tables,
                                    const int* __restrict__ pos,
                                    const int* __restrict__ lens,
                                    T* __restrict__ out, int h, int g, int hd,
                                    int bs, int nbt, int sq, int per,
                                    float scale) {
  extern __shared__ float sm[];
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int m = h / g;
  const int row0 = blockIdx.z * per;
  const int rows = min(per, m * sq - row0);
  const int p = pos[b];
  const int kend = p + lens[b];
  const int nblk = repro::walk_blocks(kend, bs, nbt);
  const repro::PagedRows kv{tables + static_cast<size_t>(b) * nbt, bs, g, hd};
  const repro::WalkState st = repro::chunk_walk<T>(
      q, kp, vp, kv, repro::ChunkMask{p, kend}, sm, b, kvh, h, g, sq, row0,
      rows, 0, nblk, scale);
  const int w = threadIdx.x >> 5;
  if (w >= rows) return;
  const int r = row0 + w;
  const int qh = r / sq, i = r - qh * sq;
  const float l = fmaxf(st.l, 1e-30f);
  T* ob = out + ((static_cast<size_t>(b) * sq + i) * h + kvh * m + qh) * hd +
          (threadIdx.x & 31);
  const int ni = hd / 32;
#pragma unroll
  for (int k = 0; k < repro::WALK_MAX_NI; ++k)
    if (k < ni) ob[32 * k] = repro::from_f<T>(st.acc[k] / l);
}

template <typename T>
cudaError_t launch_t(const void* q, const void* kp, const void* vp,
                     const int* tables, const int* pos, const int* lens,
                     void* out, int B, int h, int g, int hd, int bs, int nbt,
                     int sq, float scale, cudaStream_t stream) {
  int nz, per;
  repro::row_groups((h / g) * sq, &nz, &per);
  const size_t smem = repro::walk_smem_bytes(bs, hd, per);
  cudaError_t e = repro::allow_smem(paged_verify_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  paged_verify_kernel<T><<<dim3(B, g, nz), 32 * per, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), tables, pos, lens, static_cast<T*>(out), h, g,
      hd, bs, nbt, sq, per, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int paged_verify_launch(const void* q, const void* k_pool,
                                   const void* v_pool, const void* tables,
                                   const void* pos, const void* lens,
                                   void* out, int B, int sq, int h, int g,
                                   int hd, int bs, int nbt, float scale,
                                   int dtype, void* stream) {
  if (B <= 0 || sq <= 0) return 0;
  if (g <= 0 || h % g != 0 || hd % 32 != 0 ||
      hd > 32 * repro::WALK_MAX_NI || bs <= 0 || nbt <= 0)
    return cudaErrorInvalidValue;
  const int* tb = static_cast<const int*>(tables);
  const int* ps = static_cast<const int*>(pos);
  const int* ln = static_cast<const int*>(lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == DT_F32)
    e = launch_t<float>(q, k_pool, v_pool, tb, ps, ln, out, B, h, g, hd, bs,
                        nbt, sq, scale, s);
  else if (dtype == DT_BF16)
    e = launch_t<__nv_bfloat16>(q, k_pool, v_pool, tb, ps, ln, out, B, h, g,
                                hd, bs, nbt, sq, scale, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

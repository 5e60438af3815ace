// Paged prefill attention: suffix-only prefill over a block-table KV pool.
//
// Port of the Pallas kernel repro/kernels/prefill_attn.py:78
// (`paged_prefill_attention`, body :34).  Request b contributes Sq suffix
// queries at absolute positions cached[b] + i; its keys (shared prefix and
// this suffix, both already written to the pool) are valid for
// j < cached[b] + seg[b], and causal by absolute position (j <= q position).
//
// One block per (KV head, request, query tile): the query-tile walk of
// `tile_walk.cuh` (shared with the flash attention kernel) over the pool
// blocks the request's table names, causal, stopping at the last key that
// the causal and valid limits allow.  In bf16 the walk runs on the tensor
// cores in 32-key tiles (one pool block at the engine's block size), in
// fp32 on the CUDA cores one pool block at a time.  Rows with no valid key
// (seg == 0 padding rows) finalize to 0.
#include "tile_walk.cuh"

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

}  // namespace

extern "C" int paged_prefill_launch(const void* q, const void* k_pool,
                                    const void* v_pool, const void* tables,
                                    const void* cached, const void* seg,
                                    void* out, int B, int Sq, int h, int g,
                                    int hd, int bs, int nbt, float scale,
                                    int dtype, void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  if (g <= 0 || h % g != 0 || repro::TW_ROWS % (h / g) != 0 ||
      hd % 32 != 0 || hd > 32 * repro::TW_MAX_NI || bs <= 0 || nbt <= 0 ||
      g > 65535 || B > 65535 ||
      (Sq + repro::TW_ROWS / (h / g) - 1) / (repro::TW_ROWS / (h / g)) > 65535)
    return cudaErrorInvalidValue;
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
      return launch_t<bf16, decltype(HD)::value>(q, k_pool, v_pool, tb, cl,
                                                 sl, out, B, Sq, h, g, hd, bs,
                                                 nbt, scale, s);
    });
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

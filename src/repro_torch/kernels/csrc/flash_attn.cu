// Flash attention over contiguous K/V rows (every cold prefill).
//
// Port of the Pallas kernel repro/kernels/flash_attn.py:67
// (`flash_attention`, body `_flash_kernel` :21): q [B, S, h, hd] against
// k/v [B, T, g, hd]; query row i of request b sees keys j < lengths[b] (and
// j <= i when causal).  Rows at or past lengths[b] are computed as the
// Pallas kernel computes them (they see every valid key at or before their
// position), not zeroed; a row with no valid key (length 0) gives exact
// zeros.
//
// The TPU grid (B, h, nq, nk) reads each K/V tile once per QUERY head and
// carries the online softmax in VMEM scratch across the sequential nk axis.
// Here one thread block per (request, query tile, KV head) walks the keys in
// a loop: the query-tile walk of `tile_walk.cuh` (shared with the paged
// prefill kernel) over contiguous rows in 32-key tiles, so one read of each
// K/V tile serves the group's h/g query heads x 64/(h/g) positions.  The
// causal walk stops at the last tile the tile's last query position allows.
#include "tile_walk.cuh"

namespace {

constexpr int FLASH_TILE = 32;   // keys staged per step

template <typename T, bool CAUSAL>
__global__ void __launch_bounds__(repro::TW_WARPS * 32)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const int* __restrict__ lengths, T* __restrict__ out,
                       int S, int T_, int h, int g, int hd, float scale) {
  extern __shared__ float sm[];
  const int b = blockIdx.x;
  const repro::DenseRows kv{static_cast<size_t>(b) * T_ * g * hd, T_,
                            FLASH_TILE, g, hd};
  const int kend = min(lengths[b], T_);
  repro::tile_walk<T, repro::DenseRows, CAUSAL>(
      q, k, v, kv, out, sm, b, blockIdx.y, blockIdx.z, S, h, g, 0, kend,
      (T_ + FLASH_TILE - 1) / FLASH_TILE, scale);
}

template <typename T, bool CAUSAL>
cudaError_t launch_t(const void* q, const void* k, const void* v,
                     const int* lengths, void* out, int B, int S, int T_,
                     int h, int g, int hd, float scale, cudaStream_t stream) {
  const int bq = repro::TW_ROWS / (h / g);
  const size_t smem = repro::tile_walk_smem_bytes(FLASH_TILE, hd);
  cudaError_t e = repro::allow_smem(flash_attention_kernel<T, CAUSAL>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(B, (S + bq - 1) / bq, g);
  flash_attention_kernel<T, CAUSAL>
      <<<grid, repro::TW_WARPS * 32, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), lengths, static_cast<T*>(out), S, T_, h,
          g, hd, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_c(const void* q, const void* k, const void* v,
                     const int* lengths, void* out, int B, int S, int T_,
                     int h, int g, int hd, int causal, float scale,
                     cudaStream_t stream) {
  return causal ? launch_t<T, true>(q, k, v, lengths, out, B, S, T_, h, g,
                                    hd, scale, stream)
                : launch_t<T, false>(q, k, v, lengths, out, B, S, T_, h, g,
                                     hd, scale, stream);
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, const void* lengths,
                                      void* out, int B, int S, int T_, int h,
                                      int g, int hd, int causal, float scale,
                                      int dtype, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (g <= 0 || h % g != 0 || repro::TW_ROWS % (h / g) != 0 ||
      hd % 32 != 0 || hd > 32 * repro::TW_MAX_NI || T_ < 0 || g > 65535 ||
      (S + repro::TW_ROWS / (h / g) - 1) / (repro::TW_ROWS / (h / g)) > 65535)
    return cudaErrorInvalidValue;
  const int* ln = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == DT_F32)
    e = launch_c<float>(q, k, v, ln, out, B, S, T_, h, g, hd, causal, scale, s);
  else if (dtype == DT_BF16)
    e = launch_c<__nv_bfloat16>(q, k, v, ln, out, B, S, T_, h, g, hd, causal, scale, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

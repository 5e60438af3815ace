// SMLM: segmented multi-LoRA multiplication over a tile-aligned token stream.
//
//   Y[t] = scale[tile(t)] * (X[t] @ A[id[tile(t)]]) @ B[id[tile(t)]]
//
// Port of the Pallas kernel repro/kernels/smlm.py:39 (`smlm`, body :28).
// One block per (token tile, output tile of SMLM_BO columns).  The block
// reads its tile's adapter id and scale itself, computes the [block_t, r]
// shrink in fp32 into shared memory while streaming d_in (one warp per token
// row, lanes striding d_in, a warp reduction per rank column), then expands
// SMLM_COLS output columns per thread, masked at the d_out edge.  Each
// output tile recomputes its token tile's shrink, so wide output tiles keep
// that redundancy low.  A tile whose scale is 0 (base-only rows, invalid
// ids) writes zeros without reading A/B.
#include "common.cuh"

namespace {

constexpr int SMLM_THREADS = 256;
constexpr int SMLM_COLS = 4;                         // columns per thread
constexpr int SMLM_BO = SMLM_THREADS * SMLM_COLS;    // columns per block

template <typename T, int RP>
__global__ void __launch_bounds__(SMLM_THREADS)
smlm_kernel(const T* __restrict__ x, const T* __restrict__ a,
            const T* __restrict__ b, const int* __restrict__ tile_ids,
            const float* __restrict__ tile_scale, T* __restrict__ out,
            int n, int d_in, int r, int d_out, int block_t) {
  extern __shared__ float xa[];  // [block_t][r], fp32
  const int tile = blockIdx.x;
  const int o0 = blockIdx.y * SMLM_BO + threadIdx.x;
  const size_t t0 = static_cast<size_t>(tile) * block_t;
  const float sc = tile_scale[tile];
  if (sc == 0.f) {
    for (int c = 0; c < SMLM_COLS; ++c) {
      const int o = o0 + c * SMLM_THREADS;
      if (o < d_out)
        for (int t = 0; t < block_t; ++t)
          out[(t0 + t) * d_out + o] = repro::from_f<T>(0.f);
    }
    return;
  }
  int id = tile_ids[tile];
  id = id < 0 ? 0 : (id >= n ? n - 1 : id);
  const T* A = a + static_cast<size_t>(id) * d_in * r;
  const T* B = b + static_cast<size_t>(id) * r * d_out;

  // shrink: warp w handles rows w, w + nwarps, ...
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int NWARPS = SMLM_THREADS / 32;
  for (int t = warp; t < block_t; t += NWARPS) {
    const T* X = x + (t0 + t) * d_in;
    float acc[RP];
#pragma unroll
    for (int k = 0; k < RP; ++k) acc[k] = 0.f;
    for (int d = lane; d < d_in; d += 32) {
      const float xv = repro::to_f(X[d]);
      const T* Ad = A + static_cast<size_t>(d) * r;
#pragma unroll
      for (int k = 0; k < RP; ++k)
        if (k < r) acc[k] += xv * repro::to_f(Ad[k]);
    }
#pragma unroll
    for (int k = 0; k < RP; ++k) {
      if (k < r) {
        const float v = repro::warp_sum(acc[k]);
        if (lane == 0) xa[t * r + k] = v * sc;
      }
    }
  }
  __syncthreads();

  // expand: SMLM_COLS output columns per thread, coalesced across threads
  for (int c = 0; c < SMLM_COLS; ++c) {
    const int o = o0 + c * SMLM_THREADS;
    if (o >= d_out) break;
    float bk[RP];
#pragma unroll
    for (int k = 0; k < RP; ++k)
      bk[k] = k < r ? repro::to_f(B[static_cast<size_t>(k) * d_out + o])
                    : 0.f;
    for (int t = 0; t < block_t; ++t) {
      float y = 0.f;
#pragma unroll
      for (int k = 0; k < RP; ++k)
        if (k < r) y += xa[t * r + k] * bk[k];
      out[(t0 + t) * d_out + o] = repro::from_f<T>(y);
    }
  }
}

template <typename T, int RP>
cudaError_t launch_rp(const void* x, const void* a, const void* b,
                      const int* ids, const float* scale, void* out, int T_,
                      int n, int d_in, int r, int d_out, int block_t,
                      cudaStream_t stream) {
  const dim3 grid(T_ / block_t, (d_out + SMLM_BO - 1) / SMLM_BO);
  const size_t smem = static_cast<size_t>(block_t) * r * sizeof(float);
  cudaError_t e = repro::allow_smem(smlm_kernel<T, RP>, smem);
  if (e != cudaSuccess) return e;
  smlm_kernel<T, RP><<<grid, SMLM_THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a),
      static_cast<const T*>(b), ids, scale, static_cast<T*>(out), n, d_in, r,
      d_out, block_t);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const void* x, const void* a, const void* b,
                     const int* ids, const float* scale, void* out, int T_,
                     int n, int d_in, int r, int d_out, int block_t,
                     cudaStream_t s) {
  if (r <= 4) return launch_rp<T, 4>(x, a, b, ids, scale, out, T_, n, d_in, r, d_out, block_t, s);
  if (r <= 8) return launch_rp<T, 8>(x, a, b, ids, scale, out, T_, n, d_in, r, d_out, block_t, s);
  if (r <= 16) return launch_rp<T, 16>(x, a, b, ids, scale, out, T_, n, d_in, r, d_out, block_t, s);
  if (r <= 32) return launch_rp<T, 32>(x, a, b, ids, scale, out, T_, n, d_in, r, d_out, block_t, s);
  if (r <= 64) return launch_rp<T, 64>(x, a, b, ids, scale, out, T_, n, d_in, r, d_out, block_t, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int smlm_launch(const void* x, const void* a, const void* b,
                           const void* tile_ids, const void* tile_scale,
                           void* out, int T_, int n, int d_in, int r,
                           int d_out, int block_t, int dtype, void* stream) {
  if (T_ <= 0 || d_out <= 0) return 0;
  if (block_t <= 0 || T_ % block_t != 0 || r <= 0) return cudaErrorInvalidValue;
  const int* ids = static_cast<const int*>(tile_ids);
  const float* sc = static_cast<const float*>(tile_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == DT_F32)
    e = launch_t<float>(x, a, b, ids, sc, out, T_, n, d_in, r, d_out, block_t, s);
  else if (dtype == DT_BF16)
    e = launch_t<__nv_bfloat16>(x, a, b, ids, sc, out, T_, n, d_in, r, d_out, block_t, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

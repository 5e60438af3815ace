// BGMV: per-token gathered multi-LoRA multiplication (the decode bucket).
//
//   y[t] = scale[t] * (x[t] @ A[ids[t]]) @ B[ids[t]]
//
// Port of the Pallas kernel repro/kernels/bgmv.py:30 (`bgmv`, body :20).
// The TPU grid (T, d_out / bo) recomputes the rank-r shrink once per output
// tile; here it is computed once per token.  Two launches:
//   shrink  grid (T, n_split): each block reduces one d_in chunk of
//           x[t] @ A[id] into fp32 partials [T, n_split, r] (no atomics, so
//           the sum order is fixed);
//   expand  grid (T, d_out / BO): sums the partials, scales, and writes one
//           output column per thread, masked at the d_out edge.
// A token whose scale is 0 (base-only row, invalid id) writes zeros and its
// partials are never read.
#include "common.cuh"

namespace {

constexpr int SHRINK_THREADS = 128;
constexpr int EXPAND_THREADS = 256;

template <typename T, int RP>
__global__ void __launch_bounds__(SHRINK_THREADS)
bgmv_shrink(const T* __restrict__ x, const T* __restrict__ a,
            const int* __restrict__ ids, const float* __restrict__ scale,
            float* __restrict__ part, int n, int d_in, int r, int chunk) {
  const int t = blockIdx.x;
  const int s = blockIdx.y;
  if (scale[t] == 0.f) return;
  int id = ids[t];
  id = id < 0 ? 0 : (id >= n ? n - 1 : id);
  const T* A = a + static_cast<size_t>(id) * d_in * r;
  const T* X = x + static_cast<size_t>(t) * d_in;
  const int d0 = s * chunk;
  const int d1 = min(d_in, d0 + chunk);
  float acc[RP];
#pragma unroll
  for (int k = 0; k < RP; ++k) acc[k] = 0.f;
  for (int d = d0 + threadIdx.x; d < d1; d += SHRINK_THREADS) {
    const float xv = repro::to_f(X[d]);
    const T* Ad = A + static_cast<size_t>(d) * r;
#pragma unroll
    for (int k = 0; k < RP; ++k)
      if (k < r) acc[k] += xv * repro::to_f(Ad[k]);
  }
  __shared__ float red[SHRINK_THREADS / 32][RP];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < RP; ++k) {
    const float v = repro::warp_sum(acc[k]);
    if (lane == 0) red[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < r) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < SHRINK_THREADS / 32; ++w) v += red[w][threadIdx.x];
    part[(static_cast<size_t>(t) * gridDim.y + s) * r + threadIdx.x] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(EXPAND_THREADS)
bgmv_expand(const float* __restrict__ part, const T* __restrict__ b,
            const int* __restrict__ ids, const float* __restrict__ scale,
            T* __restrict__ out, int n, int r, int d_out, int n_split) {
  extern __shared__ float xa[];  // [r]
  const int t = blockIdx.x;
  const int o = blockIdx.y * EXPAND_THREADS + threadIdx.x;
  const float sc = scale[t];
  if (sc == 0.f) {
    if (o < d_out)
      out[static_cast<size_t>(t) * d_out + o] = repro::from_f<T>(0.f);
    return;
  }
  for (int k = threadIdx.x; k < r; k += EXPAND_THREADS) {
    float v = 0.f;
    for (int s = 0; s < n_split; ++s)
      v += part[(static_cast<size_t>(t) * n_split + s) * r + k];
    xa[k] = v * sc;
  }
  __syncthreads();
  if (o >= d_out) return;
  int id = ids[t];
  id = id < 0 ? 0 : (id >= n ? n - 1 : id);
  const T* B = b + static_cast<size_t>(id) * r * d_out + o;
  float y = 0.f;
  for (int k = 0; k < r; ++k)
    y += xa[k] * repro::to_f(B[static_cast<size_t>(k) * d_out]);
  out[static_cast<size_t>(t) * d_out + o] = repro::from_f<T>(y);
}

template <typename T, int RP>
cudaError_t launch_rp(const void* x, const void* a, const void* b,
                      const int* ids, const float* scale, float* part,
                      void* out, int T_, int n, int d_in, int r, int d_out,
                      int n_split, cudaStream_t stream) {
  const int chunk = (d_in + n_split - 1) / n_split;
  bgmv_shrink<T, RP><<<dim3(T_, n_split), SHRINK_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a), ids, scale, part,
      n, d_in, r, chunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 grid(T_, (d_out + EXPAND_THREADS - 1) / EXPAND_THREADS);
  bgmv_expand<T><<<grid, EXPAND_THREADS, r * sizeof(float), stream>>>(
      part, static_cast<const T*>(b), ids, scale, static_cast<T*>(out), n, r,
      d_out, n_split);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const void* x, const void* a, const void* b,
                     const int* ids, const float* scale, float* part,
                     void* out, int T_, int n, int d_in, int r, int d_out,
                     int n_split, cudaStream_t s) {
  if (r <= 4) return launch_rp<T, 4>(x, a, b, ids, scale, part, out, T_, n, d_in, r, d_out, n_split, s);
  if (r <= 8) return launch_rp<T, 8>(x, a, b, ids, scale, part, out, T_, n, d_in, r, d_out, n_split, s);
  if (r <= 16) return launch_rp<T, 16>(x, a, b, ids, scale, part, out, T_, n, d_in, r, d_out, n_split, s);
  if (r <= 32) return launch_rp<T, 32>(x, a, b, ids, scale, part, out, T_, n, d_in, r, d_out, n_split, s);
  if (r <= 64) return launch_rp<T, 64>(x, a, b, ids, scale, part, out, T_, n, d_in, r, d_out, n_split, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int bgmv_launch(const void* x, const void* a, const void* b,
                           const void* ids, const void* scale, void* part,
                           void* out, int T_, int n, int d_in, int r,
                           int d_out, int n_split, int dtype, void* stream) {
  if (T_ <= 0 || d_out <= 0) return 0;
  if (r <= 0 || n_split <= 0 || n_split > 65535) return cudaErrorInvalidValue;
  const int* i = static_cast<const int*>(ids);
  const float* sc = static_cast<const float*>(scale);
  float* p = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == DT_F32)
    e = launch_t<float>(x, a, b, i, sc, p, out, T_, n, d_in, r, d_out, n_split, s);
  else if (dtype == DT_BF16)
    e = launch_t<__nv_bfloat16>(x, a, b, i, sc, p, out, T_, n, d_in, r, d_out, n_split, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

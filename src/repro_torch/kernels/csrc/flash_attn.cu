// Flash attention over contiguous K/V rows (every cold prefill).
//
// Port of the Pallas kernel repro/kernels/flash_attn.py:67
// (`flash_attention`, body `_flash_kernel` :21): q [B, S, h, hd] against
// k/v [B, T, g, hd]; query row i of request b sees keys j < lengths[b] (and
// j <= i when causal, and i - j < window when window > 0: the sliding window
// of the JAX model's `_build_mask`, which the Pallas kernel lacks).  Rows at
// or past lengths[b] are computed as the Pallas kernel computes them (they
// see every valid key at or before their position, inside the window), not
// zeroed; a row with no valid key (length 0, or a padding row at least
// lengths[b] + window - 1 positions in) gives exact zeros.
//
// The TPU grid (B, h, nq, nk) reads each K/V tile once per QUERY head and
// carries the online softmax in VMEM scratch across the sequential nk axis.
// Here one thread block per (KV head, request, query tile) walks the keys in
// a loop: the query-tile walk of `tile_walk.cuh` (shared with the paged
// prefill kernel) over contiguous rows, so one read of each K/V tile serves
// the group's h/g query heads x 64/(h/g) positions.  In bf16 the walk runs
// on the tensor cores (`mma.sync`, 64-key tiles through a two-stage
// `cp.async` ring; 32-key tiles above hd 128, where the registers run out);
// in fp32 it runs on the CUDA cores in 32-key tiles.  The causal walk stops
// at the last tile the tile's last query position allows, and the query
// tiles are launched last-first, so the longest walks start first.  With a
// window the walk also starts late, at the tile of the oldest key the tile's
// first position sees (`WinMask`), so a prompt of S > W tokens walks about
// W * (S - W / 2) keys, not S^2 / 2, and every tile past W walks about W;
// the window is a template flag of the bf16 walk (window 0 compiles the
// walk without it) and a runtime argument of the fp32 one.
#include "tile_walk.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int F32_TILE = 32;   // keys per tile of the fp32 walk

// keys per tile of the bf16 walk
__host__ __device__ constexpr int bf16_tile(int hd) {
  return hd <= 128 ? 64 : 32;
}

template <typename T, int HD>
struct Shape;
template <int HD>
struct Shape<float, HD> {
  static constexpr int kThreads = repro::TW_WARPS * 32;
  static size_t smem(int hd) {
    return repro::tile_walk_smem_bytes(F32_TILE, hd);
  }
};
template <int HD>
struct Shape<bf16, HD> {
  using W = repro::TcWalk<HD, bf16_tile(HD)>;
  static constexpr int kThreads = W::kThreads;
  static size_t smem(int) { return W::kSmem; }
};

template <typename T, int HD, bool CAUSAL, bool WIN>
__global__ void __launch_bounds__(Shape<T, HD>::kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const int* __restrict__ lengths, T* __restrict__ out,
                       int S, int T_, int h, int g, int hd, int window,
                       float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int iq = gridDim.z - 1 - blockIdx.z;
  const int kend = min(lengths[b], T_);
  const size_t base = static_cast<size_t>(b) * T_ * g * hd;
  if constexpr (std::is_same<T, float>::value) {
    const repro::DenseRows kv{base, T_, F32_TILE, g, hd};
    repro::tile_walk<repro::DenseRows, CAUSAL>(
        q, k, v, kv, out, reinterpret_cast<float*>(smem), b, iq, kvh, S, h,
        g, 0, kend, (T_ + F32_TILE - 1) / F32_TILE, scale, window);
  } else {
    constexpr int BK = bf16_tile(HD);
    const repro::DenseRows kv{base, T_, BK, g, HD};
    const repro::PosMask<CAUSAL> pos{0, kend};
    const repro::Bf16Out o{out, S, h};
    bf16* sm = reinterpret_cast<bf16*>(smem);
    if constexpr (WIN)
      repro::tile_walk<HD, BK>(q, k, v, kv,
                               repro::WinMask<CAUSAL>{pos, window}, o, sm, b,
                               iq, kvh, S, h, g, 0, scale);
    else
      repro::tile_walk<HD, BK>(q, k, v, kv, pos, o, sm, b, iq, kvh, S, h, g,
                               0, scale);
  }
}

template <typename T, int HD, bool CAUSAL, bool WIN>
cudaError_t launch_t(const void* q, const void* k, const void* v,
                     const int* lengths, void* out, int B, int S, int T_,
                     int h, int g, int hd, int window, float scale,
                     cudaStream_t stream) {
  const int bq = repro::TW_ROWS / (h / g);
  const size_t smem = Shape<T, HD>::smem(hd);
  auto kern = flash_attention_kernel<T, HD, CAUSAL, WIN>;
  cudaError_t e = repro::allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(g, B, (S + bq - 1) / bq);
  kern<<<grid, Shape<T, HD>::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), S, T_, h, g,
      hd, window, scale);
  return cudaGetLastError();
}

// a window is causal (the model's only use of it); the fp32 walk takes it
// at run time
template <typename T, int HD>
cudaError_t launch_c(const void* q, const void* k, const void* v,
                     const int* lengths, void* out, int B, int S, int T_,
                     int h, int g, int hd, int causal, int window,
                     float scale, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (window > 0)
      return launch_t<T, HD, true, true>(q, k, v, lengths, out, B, S, T_, h,
                                         g, hd, window, scale, stream);
  }
  return causal ? launch_t<T, HD, true, false>(q, k, v, lengths, out, B, S,
                                               T_, h, g, hd, window, scale,
                                               stream)
                : launch_t<T, HD, false, false>(q, k, v, lengths, out, B, S,
                                                T_, h, g, hd, window, scale,
                                                stream);
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, const void* lengths,
                                      void* out, int B, int S, int T_, int h,
                                      int g, int hd, int causal, int window,
                                      float scale, int dtype, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (g <= 0 || h % g != 0 || h / g > repro::TW_ROWS ||
      window < 0 || (window > 0 && !causal) ||
      hd % 32 != 0 || hd > 32 * repro::TW_MAX_NI || T_ < 0 || g > 65535 ||
      B > 65535 ||
      (S + repro::TW_ROWS / (h / g) - 1) / (repro::TW_ROWS / (h / g)) > 65535)
    return cudaErrorInvalidValue;
  const int* ln = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == DT_F32)
    e = launch_c<float, 0>(q, k, v, ln, out, B, S, T_, h, g, hd, causal,
                           window, scale, s);
  else if (dtype == DT_BF16)
    e = repro::with_hd(hd, [&](auto HD) {
      return launch_c<bf16, decltype(HD)::value>(q, k, v, ln, out, B, S, T_,
                                                 h, g, hd, causal, window,
                                                 scale, s);
    });
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

// SMLM weight gradient: the segmented outer-product reductions of the LoRA
// backward over a tile-aligned token stream,
//
//   dA[n] = sum_{t in n} X[t]^T Gs[t]      ([n, d_in, r])
//   dB[n] = sum_{t in n} S[t]^T dY[t]      ([n, r, d_out])
//
// over the tokens of tiles whose id is n and whose scale is nonzero, with
// S = scale * X A the forward's shrink and Gs = scale * dY B^T the shrink of
// the dX product (itself an SMLM call with B^T and A^T), both in the SMLM
// kernel's fp32 layout [tiles][groups][RP][8].  The Pallas package has no
// backward kernel (JAX differentiates its plain `lora_apply_ref`); this one
// is what the port's `SMLMFunction` runs on the card.
//
// Bound: bytes.  It reads X and dY once and both shrinks, and writes dA and
// dB, for 2 * T * r * (d_in + d_out) FLOPs: r FLOPs a byte read at r = 8.
//
// Design, one launch: grid (column blocks of d_in, then of d_out; bank
// slots), a block 32 lanes' columns of dA (rows of d_in) or of dB and eight
// warps.  A lane owns CPL adjacent columns (2 up to RP = 16, else 1) and
// their r fp32 accumulators each.  A block whose slot has no live tile
// writes its zeros and leaves.  Warp w walks the stream's tiles w, w + 8,
// ... in order, skips the tiles of other slots and those of scale 0 (their
// shrink is never written), stages each 8-token group's shrink [RP][8] in
// its own slice of shared memory and adds the group's 8 outer-product terms,
// reading the 8 tokens' values of its columns first (8 * CPL loads in
// flight a lane).  The eight warps' partials are then summed in warp order,
// one rank at a time, and written.  The order of every sum is fixed: no
// atomics, the same bits on every run.  Two earlier forms measured slower
// (`PERF.md` section 6): one block of 128 columns walking a slot's tokens
// serially, and this walk with one column a lane and no early exit.
#include "common.cuh"

namespace {

constexpr int WG_WARPS = 8;
constexpr int WG_THREADS = WG_WARPS * 32;

template <int RP>
struct Cpl {
  static constexpr int value = RP <= 16 ? 2 : 1;   // columns a lane
};

template <typename T, int RP>
__global__ void __launch_bounds__(WG_THREADS)
smlm_wgrad(const T* __restrict__ x, const T* __restrict__ dy,
           const float* __restrict__ s, const float* __restrict__ gs,
           const int* __restrict__ tile_ids,
           const float* __restrict__ tile_scale, T* __restrict__ da,
           T* __restrict__ db, int T_, int n, int d_in, int r, int d_out,
           int block_t) {
  constexpr int CPL = Cpl<RP>::value;
  constexpr int COLS = 32 * CPL;                // columns a block
  __shared__ float sh[WG_WARPS][RP * 8];        // each warp's group shrink
  __shared__ float red[WG_WARPS][CPL][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int slot = blockIdx.y;
  const int n_a = (d_in + COLS - 1) / COLS;
  const bool is_a = blockIdx.x < n_a;
  const int c0 = (is_a ? blockIdx.x : blockIdx.x - n_a) * COLS + lane * CPL;
  const int width = is_a ? d_in : d_out;
  const T* src = is_a ? x : dy;
  const float* shrink = is_a ? gs : s;
  const int tiles = T_ / block_t;
  auto live = [&](int tile) {
    int id = tile_ids[tile];
    id = id < 0 ? 0 : (id >= n ? n - 1 : id);
    return id == slot && tile_scale[tile] != 0.f;
  };
  auto store = [&](int col, int k, float v) {
    if (is_a)
      da[(static_cast<size_t>(slot) * d_in + col) * r + k] =
          repro::from_f<T>(v);
    else
      db[(static_cast<size_t>(slot) * r + k) * d_out + col] =
          repro::from_f<T>(v);
  };
  bool any = false;
  for (int tile = threadIdx.x; tile < tiles && !any; tile += WG_THREADS)
    any = live(tile);
  if (!__syncthreads_or(any)) {   // no live tile of this slot: zeros
    for (int e = threadIdx.x; e < COLS * r; e += WG_THREADS) {
      const int col = (c0 - lane * CPL) + e / r;
      if (col < width) store(col, e % r, 0.f);
    }
    return;
  }
  float acc[CPL][RP];
#pragma unroll
  for (int j = 0; j < CPL; ++j)
#pragma unroll
    for (int k = 0; k < RP; ++k) acc[j][k] = 0.f;
  const int groups = (block_t + 7) / 8;
  float* my = sh[warp];
  for (int tile = warp; tile < tiles; tile += WG_WARPS) {
    if (!live(tile)) continue;   // uniform over the warp
    for (int g = 0; g < groups; ++g) {
      const int nt = min(8, block_t - g * 8);
      const float* sg =
          shrink + (static_cast<size_t>(tile) * groups + g) * RP * 8;
      for (int e = lane; e < RP * 8; e += 32) my[e] = sg[e];
      const size_t t0 = static_cast<size_t>(tile) * block_t + g * 8;
      float v[CPL][8];
#pragma unroll
      for (int j = 0; j < CPL; ++j)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          v[j][i] = (c0 + j < width && i < nt)
                        ? repro::to_f(src[(t0 + i) * width + c0 + j])
                        : 0.f;
      __syncwarp();
#pragma unroll
      for (int k = 0; k < RP; ++k) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float sk = my[k * 8 + i];
#pragma unroll
          for (int j = 0; j < CPL; ++j) acc[j][k] += v[j][i] * sk;
        }
      }
      __syncwarp();   // my is the next group's
    }
  }
  // the warps' partials, summed in warp order a rank at a time
#pragma unroll
  for (int k = 0; k < RP; ++k) {
#pragma unroll
    for (int j = 0; j < CPL; ++j) red[warp][j][lane] = acc[j][k];
    __syncthreads();
    if (warp == 0 && k < r) {
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < WG_WARPS; ++w) v += red[w][j][lane];
        if (c0 + j < width) store(c0 + j, k, v);
      }
    }
    __syncthreads();   // red is the next rank's
  }
}

template <typename T, int RP>
cudaError_t launch_rp(const void* x, const void* dy, const float* s,
                      const float* gs, const int* ids, const float* scale,
                      void* da, void* db, int T_, int n, int d_in, int r,
                      int d_out, int block_t, cudaStream_t st) {
  constexpr int COLS = 32 * Cpl<RP>::value;
  const int cols = (d_in + COLS - 1) / COLS + (d_out + COLS - 1) / COLS;
  smlm_wgrad<T, RP><<<dim3(cols, n), WG_THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), s, gs, ids, scale,
      static_cast<T*>(da), static_cast<T*>(db), T_, n, d_in, r, d_out,
      block_t);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const void* x, const void* dy, const float* s,
                     const float* gs, const int* ids, const float* scale,
                     void* da, void* db, int T_, int n, int d_in, int r,
                     int d_out, int block_t, cudaStream_t st) {
  if (r <= 4) return launch_rp<T, 4>(x, dy, s, gs, ids, scale, da, db, T_, n, d_in, r, d_out, block_t, st);
  if (r <= 8) return launch_rp<T, 8>(x, dy, s, gs, ids, scale, da, db, T_, n, d_in, r, d_out, block_t, st);
  if (r <= 16) return launch_rp<T, 16>(x, dy, s, gs, ids, scale, da, db, T_, n, d_in, r, d_out, block_t, st);
  if (r <= 32) return launch_rp<T, 32>(x, dy, s, gs, ids, scale, da, db, T_, n, d_in, r, d_out, block_t, st);
  if (r <= 64) return launch_rp<T, 64>(x, dy, s, gs, ids, scale, da, db, T_, n, d_in, r, d_out, block_t, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// x: [T, d_in], dy: [T, d_out] (one dtype); s, gs: fp32 shrink buffers of
// the SMLM layout covering the T tokens' tiles; tile_ids, tile_scale: [T /
// block_t]; da: [n, d_in, r], db: [n, r, d_out] in x's dtype, every element
// written.
extern "C" int smlm_wgrad_launch(const void* x, const void* dy, const void* s,
                                 const void* gs, const void* tile_ids,
                                 const void* tile_scale, void* da, void* db,
                                 int T_, int n, int d_in, int r, int d_out,
                                 int block_t, int dtype, void* stream) {
  if (n <= 0 || d_in <= 0 || d_out <= 0) return 0;
  if (T_ < 0 || block_t <= 0 || T_ % block_t != 0 || r <= 0 || n > 65535)
    return cudaErrorInvalidValue;
  const float* sp = static_cast<const float*>(s);
  const float* gp = static_cast<const float*>(gs);
  const int* ids = static_cast<const int*>(tile_ids);
  const float* sc = static_cast<const float*>(tile_scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == DT_F32)
    e = launch_t<float>(x, dy, sp, gp, ids, sc, da, db, T_, n, d_in, r, d_out, block_t, st);
  else if (dtype == DT_BF16)
    e = launch_t<__nv_bfloat16>(x, dy, sp, gp, ids, sc, da, db, T_, n, d_in, r, d_out, block_t, st);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

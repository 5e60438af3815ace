// The block walk shared by the paged decode, verify and split-K kernels and
// the dense-row decode kernel.
//
// One thread block serves one (request, KV head) pair and a group of query
// rows of that KV head: row r of the group is query head `r / sq` of the
// group's m = h/g heads at chunk position `r % sq`, one warp each.  Each
// tile of keys (a pool block, or a run of dense rows: `kv_rows.cuh`) is read
// once per thread block and staged in shared memory as fp32 with a padded
// row (conflict-free column reads); every warp then scores its own query row
// against it with an online softmax in fp32 registers: lane j scores key j
// of a 32-key chunk, and each lane owns hd/32 output dims.  Which keys are
// valid is the mask policy's: `ChunkMask` (paged chunks: j <= pos + i and
// j < kend = pos + lens, the mask of the Pallas kernels) or `RollingMask`
// (dense rows, linear or rolling).  Addressing and mask are template
// parameters, so each kernel compiles only its own.
#pragma once

#include "kv_rows.cuh"

namespace repro {

constexpr int WALK_MAX_NI = 8;      // hd / 32 <= 8, i.e. hd <= 256
constexpr int WALK_MAX_WARPS = 16;  // query rows per thread block

// Shared memory of one thread block: K and V of one tile of `bs` keys, fp32
// with a padded row, and the group's query rows.
inline size_t walk_smem_bytes(int bs, int hd, int rows) {
  return (2 * static_cast<size_t>(bs) * (hd + 1) +
          static_cast<size_t>(rows) * hd) * sizeof(float);
}

// Paged chunks: chunk row i sits at position pos + i; keys j <= pos + i
// (causal within the chunk) that are written (j < kend) are valid.
struct ChunkMask {
  int pos, kend;
  __device__ __forceinline__ bool operator()(int j, int i) const {
    return j <= pos + i && j < kend;
  }
};

// Dense rows of S slots, one query at `pos`: slot j holds position k_pos =
// j + S*floor((pos - j)/S) when window > 0 (a rolling buffer), else j.  Keys
// with 0 <= k_pos <= pos (and pos - k_pos < window when window > 0) are
// valid.  For j < S, C's truncating `/` gives the same mask as floor: where
// they differ (j > pos) both k_pos exceed pos or fall below 0.
struct RollingMask {
  int pos, S, window;
  __device__ __forceinline__ bool operator()(int j, int) const {
    if (j >= S) return false;
    const int kpos = window > 0 ? j + S * ((pos - j) / S) : j;
    return kpos <= pos && kpos >= 0 && (window <= 0 || pos - kpos < window);
  }
};

struct WalkState {
  float acc[WALK_MAX_NI];
  float m;
  float l;
};

// Walks tiles [ib_lo, ib_hi) of `kv` for the calling warp's query row
// `row0 + warp` of the group (`rows` rows from `row0`).  Every thread of the
// block must call it with the same range (it synchronises).  `q` is [B, sq,
// h, hd]; the tile size is `kv.bs`.
template <typename T, typename Rows, typename Mask>
__device__ __forceinline__ WalkState chunk_walk(
    const T* __restrict__ q, const T* __restrict__ kp,
    const T* __restrict__ vp, const Rows& kv, const Mask& mask, float* sm,
    int b, int kvh, int h, int g, int sq, int row0, int rows, int ib_lo,
    int ib_hi, float scale) {
  const int hd = kv.hd, bs = kv.bs;
  const int ldk = hd + 1;
  float* Ks = sm;                 // [bs][hd + 1]
  float* Vs = Ks + bs * ldk;      // [bs][hd + 1]
  float* Qs = Vs + bs * ldk;      // [rows][hd]
  const int m = h / g;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int ni = hd / 32;

  for (int e = threadIdx.x; e < rows * hd; e += blockDim.x) {
    const int rr = row0 + e / hd, d = e - (e / hd) * hd;
    const int qh_ = rr / sq, i_ = rr - qh_ * sq;
    Qs[e] = to_f(q[((static_cast<size_t>(b) * sq + i_) * h + kvh * m + qh_) *
                       hd + d]);
  }
  // a warp past the group's last row repeats that row (its result is not
  // written): every warp must take part in the block's barriers
  const int wr = min(w, rows - 1);
  const int i = (row0 + wr) % sq;

  WalkState st;
#pragma unroll
  for (int k = 0; k < WALK_MAX_NI; ++k) st.acc[k] = 0.f;
  st.m = NEG_INF;
  st.l = 0.f;
  const float* qrow = Qs + wr * hd;

  for (int ib = ib_lo; ib < ib_hi; ++ib) {
    __syncthreads();  // Q is staged / the previous tile's reads are done
    stage_tile<T>(kp, vp, kv, ib, kvh, Ks, Vs, ldk);
    __syncthreads();
    for (int c = 0; c < bs; c += 32) {
      const int j = c + lane;
      const bool valid = j < bs && mask(ib * bs + j, i);
      float s = NEG_INF;
      if (valid) {
        const float* kr = Ks + j * ldk;
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot += qrow[d] * kr[d];
        s = dot * scale;
      }
      const float m_new = fmaxf(st.m, warp_max(s));
      const float pj = valid ? expf(s - m_new) : 0.f;
      const float corr = expf(fminf(st.m - m_new, 0.f));
      st.l = st.l * corr + warp_sum(pj);
#pragma unroll
      for (int k = 0; k < WALK_MAX_NI; ++k) st.acc[k] *= corr;
      const int nj = min(32, bs - c);
      for (int jj = 0; jj < nj; ++jj) {
        const float pv = __shfl_sync(FULL_MASK, pj, jj);
        const float* vr = Vs + (c + jj) * ldk + lane;
#pragma unroll
        for (int k = 0; k < WALK_MAX_NI; ++k)
          if (k < ni) st.acc[k] += pv * vr[32 * k];
      }
      st.m = m_new;
    }
  }
  return st;
}

// Tiles of the walk: those holding keys < kend, at most `nbt`.
__device__ __forceinline__ int walk_blocks(int kend, int bs, int nbt) {
  return kend <= 0 ? 0 : min(nbt, (kend - 1) / bs + 1);
}

// Row groups of a (request, KV head) pair: `rows` query rows in `nz` thread
// blocks of at most WALK_MAX_WARPS warps, balanced.
inline void row_groups(int rows, int* nz, int* per) {
  *nz = (rows + WALK_MAX_WARPS - 1) / WALK_MAX_WARPS;
  *per = (rows + *nz - 1) / *nz;
}

}  // namespace repro

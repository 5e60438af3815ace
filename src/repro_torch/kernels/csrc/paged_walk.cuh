// The fp32 block walk shared by the paged decode, verify and split-K kernels
// and the dense-row decode kernel (in bf16 they take the tensor-core walk of
// `tile_walk.cuh`, where the chunk is a query tile; the CUDA cores keep the
// fp32 parity runs at 1e-4).
//
// One thread block serves one (request, KV head) pair and every query row
// of that KV head: row r is query head `r / sq` of the group's m = h/g heads
// at chunk position `r % sq`, m * sq rows in all (4 for a decode, 20 for a
// 5-token verify chunk at m = 4), so each tile of keys (a pool block, or a
// run of dense rows: `kv_rows.cuh`) is read from device memory once.  The
// rows are shared among the block's warps, several rows a warp (`walk_shape`:
// at most 8 warps of at most 8 rows; a group of more than 64 rows takes
// several thread blocks).  `launch_chunk` gives the launch shape of a chunk
// kernel for either walk.
//
// Tiles stream through a ring of WALK_STAGES tiles in shared memory (fewer
// where that many would not fit beside the query rows: fp32 above hd 192),
// in the element type, by 16-byte `cp.async` copies, so two tiles are in
// flight while the block computes on a third; the table is read once per
// tile.
// Lane j scores key j of a 32-key chunk against each of its warp's rows: it
// reads its key's row as 16-byte vectors (rows padded by 16 bytes, so the
// lanes' reads do not conflict) and widens them to fp32 in registers,
// against the fp32 query rows read as broadcast 16-byte loads.  The online
// softmax stays in fp32 registers (the row sum as per-lane shares, summed
// once at the end); the chunk's probabilities go through a per-warp
// shared-memory row, and each lane accumulates hd/32 output dims of each of
// its rows from one read of each V row.  Which keys are valid is the mask
// policy's: `ChunkMask` (paged chunks: j <= pos + i and j < kend = pos +
// lens, the mask of the Pallas kernels) or `RollingMask` (dense rows, linear
// or rolling).  Addressing and mask are template parameters, so each kernel
// compiles only its own.
#pragma once

#include "tile_walk.cuh"

namespace repro {

constexpr int WALK_MAX_NI = 8;      // hd / 32 <= 8, i.e. hd <= 256
constexpr int CHUNK_TILE = 32;      // keys per tile of the bf16 chunk walk
constexpr int WALK_STAGES = 3;      // K/V tiles in the ring (at most)
static_assert(WALK_STAGES == 3, "chunk_walk waits on 2, 1 or 0 groups");
constexpr int WALK_MAX_WARPS = 8;
constexpr int WALK_RPW = 8;         // rows a warp can hold
constexpr int WALK_MAX_ROWS = WALK_MAX_WARPS * WALK_RPW;

// How a group of `rows` query rows is laid out: `nz` thread blocks of `per`
// rows (one unless rows > WALK_MAX_ROWS), each of `warps` warps of `rpw`
// rows.
struct WalkShape {
  int nz, per, warps, rpw;
};

__host__ __device__ inline WalkShape walk_shape(int rows) {
  WalkShape s;
  s.nz = (rows + WALK_MAX_ROWS - 1) / WALK_MAX_ROWS;
  s.per = (rows + s.nz - 1) / s.nz;
  s.warps = s.per < WALK_MAX_WARPS ? s.per : WALK_MAX_WARPS;
  s.rpw = (s.per + s.warps - 1) / s.warps;
  s.warps = (s.per + s.rpw - 1) / s.rpw;
  return s;
}

// Row length of a ring tile, in elements: hd plus 16 bytes.
template <typename T>
__host__ __device__ constexpr int walk_ld(int hd) {
  return hd + 16 / static_cast<int>(sizeof(T));
}

// Shared memory of one thread block beside the ring: the fp32 query rows,
// and each warp's row of probabilities per row it can hold.
__host__ __device__ inline size_t walk_rows_bytes(int hd, const WalkShape& s) {
  return (static_cast<size_t>(s.per) * hd +
          static_cast<size_t>(s.warps) * WALK_RPW * 32) *
         sizeof(float);
}

// Tiles in the ring: WALK_STAGES, or as many as fit in a block's 227 KB
// beside the rows (at least one).  Host and device compute it alike.
template <typename T>
__host__ __device__ inline int walk_stages(int bs, int hd,
                                           const WalkShape& s) {
  const size_t tile = static_cast<size_t>(2) * bs * walk_ld<T>(hd) * sizeof(T);
  int n = WALK_STAGES;
  while (n > 1 && n * tile + walk_rows_bytes(hd, s) > 232448) --n;
  return n;
}

// Shared memory of one thread block: the ring and the rows.
template <typename T>
inline size_t walk_smem_bytes(int bs, int hd, const WalkShape& s) {
  return static_cast<size_t>(walk_stages<T>(bs, hd, s)) * 2 * bs *
             walk_ld<T>(hd) * sizeof(T) +
         walk_rows_bytes(hd, s);
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

// The calling warp's rows row0 .. row0 + nr - 1 of the block's group:
// un-normalized output, running max and row sum of each.
struct WalkState {
  float acc[WALK_RPW][WALK_MAX_NI];
  float m[WALK_RPW];
  float l[WALK_RPW];
  int row0, nr;
};

// 8 consecutive elements of a ring row (16-byte aligned) as fp32
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// Walks tiles [ib_lo, ib_hi) of `kv` for rows [g0, g0 + per) of the group of
// KV head `kvh` (`per` rows, `rpw` a warp).  Every thread of the block must
// call it with the same arguments (it synchronises).  `q` is [B, sq, h, hd];
// the tile size is `kv.bs`; `smem` is laid out as `walk_smem_bytes` counts.
template <typename T, typename Rows, typename Mask>
__device__ __forceinline__ WalkState chunk_walk(
    const T* __restrict__ q, const T* __restrict__ kp,
    const T* __restrict__ vp, const Rows& kv, const Mask& mask,
    unsigned char* smem, int b, int kvh, int h, int g, int sq, int g0,
    int per, int rpw, int ib_lo, int ib_hi, float scale) {
  constexpr int RPW = WALK_RPW;
  const int hd = kv.hd, bs = kv.bs;
  const int ld = walk_ld<T>(hd);
  const int m = h / g;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int ni = hd / 32;
  const size_t tile_elems = static_cast<size_t>(2) * bs * ld;
  const int stages = walk_stages<T>(bs, hd, walk_shape(m * sq));
  T* ring = reinterpret_cast<T*>(smem);
  float* Qs = reinterpret_cast<float*>(smem + stages * tile_elems *
                                                  sizeof(T));   // [per][hd]
  float* Ps = Qs + static_cast<size_t>(per) * hd + w * RPW * 32;

  for (int e = threadIdx.x; e < per * hd; e += blockDim.x) {
    const int r = g0 + e / hd, d = e - (e / hd) * hd;
    const int qh = r / sq, i = r - qh * sq;
    Qs[e] = to_f(q[((static_cast<size_t>(b) * sq + i) * h + kvh * m + qh) *
                       hd + d]);
  }

  WalkState st;
  st.row0 = w * rpw;
  st.nr = max(0, min(rpw, per - st.row0));
  int ipos[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    st.m[r] = NEG_INF;
    st.l[r] = 0.f;
#pragma unroll
    for (int k = 0; k < WALK_MAX_NI; ++k) st.acc[r][k] = 0.f;
    ipos[r] = (g0 + st.row0 + r) % sq;   // chunk position of the row
  }

  const int n = ib_hi - ib_lo;
#pragma unroll
  for (int s = 0; s < stages - 1; ++s) {
    if (s < n) {
      T* Ks = ring + s * tile_elems;
      copy_tile_async<T>(kp, vp, kv, ib_lo + s, kvh, Ks, Ks + bs * ld, ld);
    }
    cp_async_commit();
  }
  for (int it = 0; it < n; ++it) {
    const int nxt = it + stages - 1;
    if (nxt < n) {
      T* Ks = ring + (nxt % stages) * tile_elems;
      copy_tile_async<T>(kp, vp, kv, ib_lo + nxt, kvh, Ks, Ks + bs * ld, ld);
    }
    cp_async_commit();
    if (stages == 3)                    // tile `it` has landed
      cp_async_wait<2>();
    else if (stages == 2)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();                    // ... for every thread (and Q)
    const T* Ks = ring + (it % stages) * tile_elems;
    const T* Vs = Ks + bs * ld;
    const int ib = ib_lo + it;
    if (st.nr > 0) {
      for (int c = 0; c < bs; c += 32) {
        const int j = c + lane;
        float s[RPW];
#pragma unroll
        for (int r = 0; r < RPW; ++r) s[r] = 0.f;
        if (j < bs) {
          const T* kr = Ks + j * ld;
          for (int d = 0; d < hd; d += 8) {
            float kx[8];
            load8(kr + d, kx);
#pragma unroll
            for (int r = 0; r < RPW; ++r) {
              if (r < st.nr) {
                float qx[8];
                load8(Qs + (st.row0 + r) * hd + d, qx);
#pragma unroll
                for (int u = 0; u < 8; ++u) s[r] += qx[u] * kx[u];
              }
            }
          }
        }
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          if (r < st.nr) {
            const bool valid = j < bs && mask(ib * bs + j, ipos[r]);
            const float sv = valid ? s[r] * scale : NEG_INF;
            const float m_new = fmaxf(st.m[r], warp_max(sv));
            const float p = valid ? expf(sv - m_new) : 0.f;
            const float corr = expf(fminf(st.m[r] - m_new, 0.f));
            st.l[r] = st.l[r] * corr + p;      // this lane's share
#pragma unroll
            for (int k = 0; k < WALK_MAX_NI; ++k) st.acc[r][k] *= corr;
            st.m[r] = m_new;
            Ps[r * 32 + lane] = p;
          }
        }
        __syncwarp();
        const int nj = min(32, bs - c);
        for (int jj = 0; jj < nj; ++jj) {
          const T* vr = Vs + (c + jj) * ld + lane;
          float vx[WALK_MAX_NI];
#pragma unroll
          for (int k = 0; k < WALK_MAX_NI; ++k)
            vx[k] = k < ni ? to_f(vr[32 * k]) : 0.f;
#pragma unroll
          for (int r = 0; r < RPW; ++r) {
            if (r < st.nr) {
              const float p = Ps[r * 32 + jj];
#pragma unroll
              for (int k = 0; k < WALK_MAX_NI; ++k)
                if (k < ni) st.acc[r][k] += p * vx[k];
            }
          }
        }
        __syncwarp();
      }
    }
    __syncthreads();   // the slot is free for tile it + stages
  }
  cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < RPW; ++r) st.l[r] = warp_sum(st.l[r]);
  return st;
}

// Tiles of the walk: those holding keys < kend, at most `nbt`.
__device__ __forceinline__ int walk_blocks(int kend, int bs, int nbt) {
  return kend <= 0 ? 0 : min(nbt, (kend - 1) / bs + 1);
}

// Threads of a chunk kernel (decode, verify, split-K): HD is the head dim
// of the bf16 walk, 0 for the fp32 walk.
template <typename T, int HD>
struct ChunkThreads {
  static constexpr int value = WALK_MAX_WARPS * 32;
};
template <int HD>
struct ChunkThreads<__nv_bfloat16, HD> {
  static constexpr int value = TcWalk<HD, CHUNK_TILE>::kThreads;
};

// Launch shape of a chunk kernel of m * sq query rows per (request, KV
// head): calls go(HD, nz, threads, smem, per, rpw), with nz thread blocks
// per pair.  fp32: the CUDA-core walk, nz row groups of `per` rows, `rpw` a
// warp, HD = 0.  bf16: the tensor-core walk compiled for the head dim HD,
// nz query tiles of 64 / m positions (m <= 64).
template <typename T, typename Go>
inline cudaError_t launch_chunk(int h, int g, int hd, int bs, int sq,
                                Go&& go) {
  const int m = h / g;
  if constexpr (std::is_same<T, float>::value) {
    const WalkShape ws = walk_shape(m * sq);
    return go(std::integral_constant<int, 0>{}, ws.nz, 32 * ws.warps,
              walk_smem_bytes<T>(bs, hd, ws), ws.per, ws.rpw);
  } else {
    const int bq = TW_ROWS / m;
    if (bq == 0) return cudaErrorInvalidValue;
    return with_hd(hd, [&](auto HD) {
      using W = TcWalk<decltype(HD)::value, CHUNK_TILE>;
      return go(HD, (sq + bq - 1) / bq, W::kThreads, W::kSmem, 0, 0);
    });
  }
}

}  // namespace repro

// SMLM: segmented multi-LoRA multiplication over a tile-aligned token stream.
//
//   Y[t] = scale[tile(t)] * (X[t] @ A[id[tile(t)]]) @ B[id[tile(t)]]
//
// Port of the Pallas kernel repro/kernels/smlm.py:39 (`smlm`, body :28).
//
// Bound: bytes.  At r = 8 a token reads d_in and writes d_out elements for
// 2 * r * (d_in + d_out) FLOPs, a few FLOPs a byte against the card's ~295,
// so the kernel has to read X once, write Y once, compute the rank-r shrink
// once a tile and keep many 16-byte accesses in flight.
//
// Design, two launches a call:
//  1. shrink: one thread-block cluster of SMLM_CLUSTER blocks a token tile.
//     Block `rank` reduces its slice [rank * d_span, ...) of d_in for the
//     tile's tokens, SMLM_GROUP at a time (`shrink_block`: in bf16 X and A
//     are staged by 16-byte `cp.async` copies and multiplied by
//     `mma.sync.m16n8k16` with the ranks on M and the 8 tokens on N, fp32
//     accumulators, the warps' partials summed in warp order).  After one
//     cluster barrier the cluster sums the SMLM_CLUSTER partials in rank
//     order through distributed shared memory (the same order in every run:
//     no atomics, identical bits), scales them and writes the fp32 shrink
//     s [tiles][groups][RP][8] (2 KB a 8-token tile at r = 8).
//  2. expand: a thread holds 8 columns of a token group's 8 rows in fp32,
//     reads B's rows as 16-byte vectors and s as 16-byte broadcasts, and
//     writes Y as 16-byte stores.  It is a programmatic dependent launch:
//     its blocks start while the shrink finishes and load B before they
//     wait for s, which hides the gap between the launches.
// So X and A are read once a tile, B once a tile, Y written once, and the
// shrink is computed once a tile.  The fused one-launch form (each cluster
// block expanding its own eighth of d_out after the barrier) measured
// slower at every main-path shape but T = 64: it held 128 registers a
// thread across the barrier, two blocks an SM (`PERF.md` section 6).  The
// tensor cores take the shrink because its A operand is shared by the 8
// tokens: read per lane from device memory, A's 16-byte rows sat 128 bytes
// apart across a warp.  The expand stays on the CUDA cores: at r = 8 its 8
// FMAs an output take about 4 us of the card at 1024 x 14336, under the
// ~9 us its bytes need, and its 16-byte stores keep the accumulator layout.
// In bf16 a d_in or d_out that is not a multiple of 8 (or an input that
// does not start on a 16-byte boundary), or a rank that is not 8, 16, 32
// or 64, takes element copies on that side, zero-padded or masked at the
// edge.  fp32 runs only the reduced-size parity runs: element loads and
// stores throughout, the shrink on the CUDA cores.  A
// tile whose scale is 0 (base-only rows, invalid ids) is skipped by the
// shrink and written as zeros by the expand without reading B.
//
// Split entries (`smlm_shrink_launch`, `smlm_expand_launch`): the same two
// kernels with PLAIN set, launched apart, so that a collective can sit
// between them (a rank's shrink over its slice of d_in is a partial sum,
// all-reduced over the mesh's model axis before the expand).  PLAIN keeps
// the scaled shrink as a plain fp32 [T, r] (a tile of scale 0 as zeros) in
// place of the packed [tiles][groups][RP][8], and the expand reads it from
// there; the expand is then an ordinary launch, not a programmatic
// dependent.
#include <cooperative_groups.h>

#include <type_traits>

#include "tile_walk.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int SMLM_THREADS = 256;
constexpr int SMLM_WARPS = SMLM_THREADS / 32;
constexpr int SMLM_CLUSTER = 8;           // blocks per token tile
constexpr int SMLM_GROUP = SMLM_WARPS;    // tokens shrunk and expanded at once

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void unpack2(unsigned w, float& lo, float& hi) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
  lo = f.x;
  hi = f.y;
}

// The first n of 8 elements as scalars, zeros past them (the ragged edge)
template <typename T>
__device__ __forceinline__ void ld8_edge(const T* p, int n, float (&x)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = i < n ? repro::to_f(p[i]) : 0.f;
}

// 8 output columns: one 16-byte store when VEC (bf16 only), else the first
// n as scalars
template <bool VEC>
__device__ __forceinline__ void st8(__nv_bfloat16* p, int n,
                                    const float (&y)[8]) {
  if constexpr (VEC) {
    __nv_bfloat162 h[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(y[2 * i], y[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(h);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i < n) p[i] = __float2bfloat16(y[i]);
  }
}
template <bool VEC>
__device__ __forceinline__ void st8(float* p, int n, const float (&y)[8]) {
  static_assert(!VEC, "fp32 takes scalar stores");
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (i < n) p[i] = y[i];
}

// 8 consecutive bf16 elements kept raw (one 16-byte vector) until they are
// used
struct Raw8 {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    u = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void unpack(float (&x)[8]) const {
    unpack2(u.x, x[0], x[1]);
    unpack2(u.y, x[2], x[3]);
    unpack2(u.z, x[4], x[5]);
    unpack2(u.w, x[6], x[7]);
  }
};
// fp32: one token row's share of this lane in sum_{d0 <= d < d1} X[d] *
// A[d][:], lanes over single elements (fp32 runs only the reduced-size
// parity runs: element loads throughout)
template <int RP>
__device__ __forceinline__ void shrink_row(const float* __restrict__ X,
                                           const float* __restrict__ A,
                                           int d0, int d1, int r, int lane,
                                           float (&acc)[RP]) {
#pragma unroll
  for (int k = 0; k < RP; ++k) acc[k] = 0.f;
  for (int d = d0 + lane; d < d1; d += 32) {
    const float xv = X[d];
    const float* Ad = A + static_cast<size_t>(d) * r;
#pragma unroll
    for (int k = 0; k < RP; ++k)
      if (k < r) acc[k] = fmaf(xv, Ad[k], acc[k]);
  }
}

__device__ __forceinline__ void ldsm_x2(const void* p, unsigned& r0,
                                        unsigned& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(repro::smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2_t(const void* p, unsigned& r0,
                                          unsigned& r1) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(repro::smem_addr(p)));
}

// Shared-memory layout of the bf16 shrink: a two-stage ring of DCH-wide
// slices of the group's X rows [SMLM_GROUP][LDX] and of A [DCH][LDA] (rank
// columns padded to RPA = max(8, RP) with zeros; rows padded so that
// `ldmatrix` reads are free of bank conflicts), then, in the same bytes, the
// warps' fp32 partials [SMLM_WARPS][MT * 16][SMLM_GROUP].
template <int RP>
struct ShrinkTile {
  static constexpr int RPA = RP < 8 ? 8 : RP;
  static constexpr int LDA = RPA == 8 ? 8 : RPA + 8;
  static constexpr int MT = (RPA + 15) / 16;          // m16 tiles of ranks
  static constexpr int DCH = RP <= 16 ? 256 : 128;    // d_in per stage
  static constexpr int KPW = DCH / 16 / SMLM_WARPS;   // k-steps a warp
  static constexpr int LDX = DCH + 8;
  static constexpr int XS = SMLM_GROUP * LDX;
  static constexpr int STAGE = XS + DCH * LDA;        // elements
  static constexpr size_t RING = 2 * STAGE * sizeof(__nv_bfloat16);
  static constexpr size_t RED =
      static_cast<size_t>(SMLM_WARPS) * MT * 16 * SMLM_GROUP * sizeof(float);
  static constexpr size_t BYTES = RING > RED ? RING : RED;
  static_assert(KPW >= 1, "a k-step a warp at least");
};

template <typename T, int RP>
struct ShrinkBytes {
  static constexpr size_t value =
      std::is_same<T, float>::value ? 16 : ShrinkTile<RP>::BYTES;
};

// The block's partial shrink of one token group: pg[t][k] = sum over
// d0 <= d < d1 of X[t_row + t][d] * A[d][k], for t < nt (all threads call
// it; it synchronises).  bf16: `mma.sync.m16n8k16` with the ranks on M and
// the group's 8 tokens on N (C^T = A^T X^T), both operands by `ldmatrix`
// from a two-stage `cp.async` ring (X and A as 16-byte copies when VIN,
// else staged element by element), warp w taking k-steps w*KPW.. of each
// stage, the warps' partials summed in warp order.  fp32: one warp a token
// on the CUDA cores (`shrink_row`).
template <typename T, int RP, bool VIN>
__device__ __forceinline__ void shrink_block(
    const T* __restrict__ x, const T* __restrict__ A, size_t t_row, int nt,
    int d_in, int d0, int d1, int r, float (*pg)[RP], unsigned char* sbuf) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if constexpr (std::is_same<T, float>::value) {
    if (warp < nt) {
      float acc[RP];
      shrink_row<RP>(x + (t_row + warp) * d_in, A, d0, d1, r, lane, acc);
#pragma unroll
      for (int k = 0; k < RP; ++k) {
        const float v = repro::warp_sum(acc[k]);
        if (lane == 0) pg[warp][k] = v;
      }
    }
    __syncthreads();
  } else {
    using S = ShrinkTile<RP>;
    using bf16 = __nv_bfloat16;
    bf16* ring = reinterpret_cast<bf16*>(sbuf);
    const int n_ch = d1 > d0 ? (d1 - d0 + S::DCH - 1) / S::DCH : 0;
    auto stage = [&](int c, int st) {
      bf16* Xs = ring + st * S::STAGE;
      bf16* As = Xs + S::XS;
      const int dc = d0 + c * S::DCH;
      constexpr int XV = S::DCH / 8;   // 8-element vectors of an X row
      for (int e = tid; e < SMLM_GROUP * XV; e += SMLM_THREADS) {
        const int t = e / XV, d = dc + (e - t * XV) * 8;
        bf16* dst = Xs + t * S::LDX + (d - dc);
        const bf16* src = x + (t_row + t) * d_in + d;
        if constexpr (VIN) {
          const bool ok = t < nt && d < d1;
          repro::cp_async16(dst, ok ? src : x, ok);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i)
            dst[i] = t < nt && d + i < d1 ? src[i] : __float2bfloat16(0.f);
        }
      }
      if constexpr (VIN) {   // r == RP >= 8: rows of RP/8 vectors
        constexpr int AV = RP / 8;
        for (int e = tid; e < S::DCH * AV; e += SMLM_THREADS) {
          const int j = e / AV, v = e - j * AV;
          const bool ok = dc + j < d1;
          repro::cp_async16(As + j * S::LDA + v * 8,
                            ok ? A + static_cast<size_t>(dc + j) * RP + v * 8
                               : A,
                            ok);
        }
      } else {
        for (int e = tid; e < S::DCH * S::RPA; e += SMLM_THREADS) {
          const int j = e / S::RPA, k = e - j * S::RPA;
          As[j * S::LDA + k] = dc + j < d1 && k < r
                                   ? A[static_cast<size_t>(dc + j) * r + k]
                                   : __float2bfloat16(0.f);
        }
      }
    };

    float c[S::MT][4];
#pragma unroll
    for (int mt = 0; mt < S::MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[mt][e] = 0.f;
    if (n_ch > 0) stage(0, 0);
    repro::cp_async_commit();
    for (int ch = 0; ch < n_ch; ++ch) {
      if (ch + 1 < n_ch) stage(ch + 1, (ch + 1) & 1);
      repro::cp_async_commit();
      repro::cp_async_wait<1>();   // stage ch has landed
      __syncthreads();
      const bf16* Xs = ring + (ch & 1) * S::STAGE;
      const bf16* As = Xs + S::XS;
#pragma unroll
      for (int kk = 0; kk < S::KPW; ++kk) {
        const int kb = (warp * S::KPW + kk) * 16;
        unsigned b0, b1;   // X^T [16 d x 8 tokens]
        ldsm_x2(Xs + (lane & 7) * S::LDX + kb + ((lane >> 3) & 1) * 8, b0,
                b1);
#pragma unroll
        for (int mt = 0; mt < S::MT; ++mt) {
          unsigned a[4];   // A^T [16 ranks x 16 d]
          if constexpr (S::RPA == 8) {
            ldsm_x2_t(As + (kb + (lane & 7) + ((lane >> 3) & 1) * 8) * S::LDA,
                      a[0], a[2]);
            a[1] = a[3] = 0u;
          } else {
            const int q = lane >> 3;
            repro::ldsm_x4_t(As + (kb + (lane & 7) + ((q >> 1) << 3)) * S::LDA +
                                 mt * 16 + (q & 1) * 8,
                             a[0], a[1], a[2], a[3]);
          }
          repro::mma_bf16(c[mt], a, b0, b1);
        }
      }
      __syncthreads();   // the stage is free for chunk ch + 2
    }
    repro::cp_async_wait<0>();

    // c[mt]: ranks mt*16 + lane/4 (+8), tokens 2 (lane % 4) + {0, 1}
    float* red = reinterpret_cast<float*>(sbuf);   // [warps][MT*16][8]
#pragma unroll
    for (int mt = 0; mt < S::MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(warp * S::MT * 16 + mt * 16 + (lane >> 2) + 8 * (e >> 1)) *
                SMLM_GROUP +
            2 * (lane & 3) + (e & 1)] = c[mt][e];
    __syncthreads();
    for (int e = tid; e < nt * RP; e += SMLM_THREADS) {
      const int t = e / RP, k = e - t * RP;
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < SMLM_WARPS; ++w)
        v += red[(w * S::MT * 16 + k) * SMLM_GROUP + t];
      pg[t][k] = v;
    }
    __syncthreads();   // sbuf is the next group's ring
  }
}

// Launch 1, the shrink: grid (tiles * SMLM_CLUSTER), clusters of
// SMLM_CLUSTER blocks along x, one cluster a token tile.  Block `rank`
// reduces its d_span slice of d_in for every token group of the tile into
// shared memory; after one cluster barrier the cluster sums the
// SMLM_CLUSTER partials in rank order through distributed shared memory and
// writes the scaled shrink s [tiles][groups][RP][SMLM_GROUP] (fp32, tokens
// past the tile's end as 0).  A tile of scale 0 does nothing.  RP: the rank
// padded to 4, 8, 16, 32 or 64; VIN (bf16 only): X and A as 16-byte
// copies (d_in % 8 == 0, r == RP >= 8, 16-byte aligned).
template <typename T, int RP, bool VIN, bool PLAIN>
__global__ void __launch_bounds__(SMLM_THREADS)
smlm_shrink(const T* __restrict__ x, const T* __restrict__ a,
            const int* __restrict__ tile_ids,
            const float* __restrict__ tile_scale, float* __restrict__ s,
            int n, int d_in, int r, int block_t, int d_span) {
  __shared__ float part[2][SMLM_GROUP][RP];   // this block's partials
  __shared__ __align__(16) unsigned char sbuf[ShrinkBytes<T, RP>::value];
  const int rank = blockIdx.x % SMLM_CLUSTER;   // the block's cluster rank
  const int tile = blockIdx.x / SMLM_CLUSTER;
  // the expand may launch now: its blocks wait for this grid before they
  // read s
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const float sc = tile_scale[tile];
  if (sc == 0.f) {   // uniform over the cluster: nobody waits
    if constexpr (PLAIN) {
      float* st = s + static_cast<size_t>(tile) * block_t * r;
      for (int e = rank * SMLM_THREADS + threadIdx.x; e < block_t * r;
           e += SMLM_CLUSTER * SMLM_THREADS)
        st[e] = 0.f;
    }
    return;
  }
  int id = tile_ids[tile];
  id = id < 0 ? 0 : (id >= n ? n - 1 : id);
  const T* A = a + static_cast<size_t>(id) * d_in * r;
  const size_t t0 = static_cast<size_t>(tile) * block_t;
  const int d0 = rank * d_span, d1 = min(d_in, d0 + d_span);
  const int groups = (block_t + SMLM_GROUP - 1) / SMLM_GROUP;
  cg::cluster_group cluster = cg::this_cluster();
  for (int grp = 0; grp < groups; ++grp) {
    const int g0 = grp * SMLM_GROUP;
    const int nt = min(SMLM_GROUP, block_t - g0);
    float (*pg)[RP] = part[grp & 1];   // double-buffered across groups
    shrink_block<T, RP, VIN>(x, A, t0 + g0, nt, d_in, d0, d1, r, pg, sbuf);
    cluster_arrive();   // every partial of the group is written ...
    cluster_wait();     // ... and visible to the whole cluster
    if constexpr (PLAIN) {   // s [T][r]: the group's nt rows
      float* sg = s + (t0 + g0) * r;
      for (int e = rank * SMLM_THREADS + threadIdx.x; e < nt * r;
           e += SMLM_CLUSTER * SMLM_THREADS) {
        const int t = e / r, k = e - t * r;
        float v = 0.f;
#pragma unroll
        for (int c = 0; c < SMLM_CLUSTER; ++c)
          v += *cluster.map_shared_rank(&pg[t][k], c);
        sg[e] = v * sc;
      }
    } else {
      float* sg = s + (static_cast<size_t>(tile) * groups + grp) * RP *
                          SMLM_GROUP;
      for (int e = rank * SMLM_THREADS + threadIdx.x; e < RP * SMLM_GROUP;
           e += SMLM_CLUSTER * SMLM_THREADS) {
        const int k = e / SMLM_GROUP, t = e - k * SMLM_GROUP;
        float v = 0.f;
        if (t < nt) {
#pragma unroll
          for (int c = 0; c < SMLM_CLUSTER; ++c)
            v += *cluster.map_shared_rank(&pg[t][k], c);
        }
        sg[e] = v * sc;
      }
    }
    if (grp + 1 == groups) cluster_arrive();   // done reading peers
  }
  cluster_wait();   // peers have read this block's partials
}

// Launch 2, the expand: grid (tiles * groups, column blocks).  A thread
// holds 8 columns of a token group's 8 rows in fp32:
// it reads the group's scaled shrink s[k][..] as 16-byte vectors (the same
// for the whole block: L1 broadcasts), KB rows of B at a time as 16-byte
// vectors (all in flight), and writes its rows as 16-byte stores (VOUT,
// bf16 only: d_out % 8 == 0, 16-byte aligned), else as scalars masked at
// the d_out edge.  A tile of scale 0 writes zeros without reading B.  It is launched
// as a programmatic dependent of the shrink: its blocks may start while the
// shrink runs, load their first rows of B, and wait (`griddepcontrol.wait`)
// for the whole shrink grid before they read s, through L2 (`ld.global.cg`).
template <typename T, int RP, bool VOUT, bool PLAIN>
__global__ void __launch_bounds__(SMLM_THREADS, 2)
smlm_expand(const T* __restrict__ b, const int* __restrict__ tile_ids,
            const float* __restrict__ tile_scale, const float* s,
            T* __restrict__ out, int n, int r, int d_out, int block_t) {
  constexpr int KB0 = sizeof(T) == 2 ? 8 : 4;
  constexpr int KB = RP < KB0 ? RP : KB0;   // rows of B in flight
  const int groups = (block_t + SMLM_GROUP - 1) / SMLM_GROUP;
  const int tile = blockIdx.x / groups, grp = blockIdx.x - tile * groups;
  const int o = (blockIdx.y * SMLM_THREADS + threadIdx.x) * 8;
  if (o >= d_out) return;
  const int ncol = d_out - o;
  const int nt = min(SMLM_GROUP, block_t - grp * SMLM_GROUP);
  T* Y = out + (static_cast<size_t>(tile) * block_t + grp * SMLM_GROUP) *
                   d_out + o;
  const float sc = tile_scale[tile];
  float acc[SMLM_GROUP][8];
#pragma unroll
  for (int i = 0; i < SMLM_GROUP; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  int id = tile_ids[tile];
  id = id < 0 ? 0 : (id >= n ? n - 1 : id);
  const T* B = b + static_cast<size_t>(id) * r * d_out + o;
  Raw8 raw[KB];
  if constexpr (VOUT) {
    if (sc != 0.f) {
#pragma unroll
      for (int k = 0; k < KB; ++k)
        if (k < r) raw[k].load(B + static_cast<size_t>(k) * d_out);
    }
  }
  asm volatile("griddepcontrol.wait;\n" ::: "memory");   // s is complete
  if (sc != 0.f) {
    const float* sg =
        PLAIN ? s + (static_cast<size_t>(tile) * block_t + grp * SMLM_GROUP) * r
              : s + (static_cast<size_t>(tile) * groups + grp) * RP *
                        SMLM_GROUP;
#pragma unroll 1
    for (int k0 = 0; k0 < RP; k0 += KB) {
      if constexpr (VOUT) {
        if (k0 > 0) {
#pragma unroll
          for (int k = 0; k < KB; ++k)
            if (k0 + k < r)
              raw[k].load(B + static_cast<size_t>(k0 + k) * d_out);
        }
      }
#pragma unroll
      for (int k = 0; k < KB; ++k) {
        if (k0 + k < r) {
          float bv[8], sv[SMLM_GROUP];
          if constexpr (VOUT)
            raw[k].unpack(bv);
          else
            ld8_edge(B + static_cast<size_t>(k0 + k) * d_out, ncol, bv);
          if constexpr (PLAIN) {
#pragma unroll
            for (int i = 0; i < SMLM_GROUP; ++i)
              sv[i] = i < nt ? __ldcg(sg + i * r + k0 + k) : 0.f;
          } else {
            const float4* sp =
                reinterpret_cast<const float4*>(sg + (k0 + k) * SMLM_GROUP);
            const float4 s0 = __ldcg(sp), s1 = __ldcg(sp + 1);
            sv[0] = s0.x; sv[1] = s0.y; sv[2] = s0.z; sv[3] = s0.w;
            sv[4] = s1.x; sv[5] = s1.y; sv[6] = s1.z; sv[7] = s1.w;
          }
#pragma unroll
          for (int i = 0; i < SMLM_GROUP; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(sv[i], bv[j], acc[i][j]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < SMLM_GROUP; ++i)
    if (i < nt) st8<VOUT>(Y + static_cast<size_t>(i) * d_out, ncol, acc[i]);
}

template <typename T, int RP, bool VIN, bool PLAIN>
cudaError_t launch_shrink(const void* x, const void* a, const int* ids,
                          const float* scale, float* s, int T_, int n,
                          int d_in, int r, int block_t, cudaStream_t stream) {
  // each block's slice of d_in, a multiple of 8 elements
  const int d_span = ((d_in + SMLM_CLUSTER - 1) / SMLM_CLUSTER + 7) / 8 * 8;
  const int tiles = T_ / block_t;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * SMLM_CLUSTER);
  cfg.blockDim = dim3(SMLM_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = SMLM_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, smlm_shrink<T, RP, VIN, PLAIN>, static_cast<const T*>(x),
      static_cast<const T*>(a), ids, scale, s, n, d_in, r, block_t, d_span);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// PDL: launched as a programmatic dependent of the shrink just before it
template <typename T, int RP, bool VOUT, bool PLAIN>
cudaError_t launch_expand(const void* b, const int* ids, const float* scale,
                          const float* s, void* out, int T_, int n, int r,
                          int d_out, int block_t, bool pdl,
                          cudaStream_t stream) {
  const int tiles = T_ / block_t;
  const int groups = (block_t + SMLM_GROUP - 1) / SMLM_GROUP;
  const int ncb = (d_out + 8 * SMLM_THREADS - 1) / (8 * SMLM_THREADS);
  cudaLaunchConfig_t ec = {};
  ec.gridDim = dim3(tiles * groups, ncb);
  ec.blockDim = dim3(SMLM_THREADS);
  ec.dynamicSmemBytes = 0;
  ec.stream = stream;
  cudaLaunchAttribute ea[1];
  ea[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  ea[0].val.programmaticStreamSerializationAllowed = 1;
  ec.attrs = ea;
  ec.numAttrs = pdl ? 1 : 0;
  cudaError_t e = cudaLaunchKernelEx(&ec, smlm_expand<T, RP, VOUT, PLAIN>,
                                     static_cast<const T*>(b), ids, scale, s,
                                     static_cast<T*>(out), n, r, d_out,
                                     block_t);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T, int RP, bool VIN, bool VOUT>
cudaError_t launch_v(const void* x, const void* a, const void* b,
                     const int* ids, const float* scale, float* s, void* out,
                     int T_, int n, int d_in, int r, int d_out, int block_t,
                     cudaStream_t stream) {
  cudaError_t e = launch_shrink<T, RP, VIN, false>(
      x, a, ids, scale, s, T_, n, d_in, r, block_t, stream);
  if (e != cudaSuccess) return e;
  return launch_expand<T, RP, VOUT, false>(b, ids, scale, s, out, T_, n, r,
                                           d_out, block_t, true, stream);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, int RP>
cudaError_t launch_rp(const void* x, const void* a, const void* b,
                      const int* ids, const float* scale, float* s,
                      void* out, int T_, int n, int d_in, int r, int d_out,
                      int block_t, cudaStream_t st) {
  if constexpr (std::is_same<T, float>::value) {
    return launch_v<T, RP, false, false>(x, a, b, ids, scale, s, out, T_, n, d_in, r, d_out, block_t, st);
  } else {
    const bool vin = d_in % 8 == 0 && r == RP && RP >= 8 && aligned16(x) &&
                     aligned16(a);
    const bool vout = d_out % 8 == 0 && aligned16(b) && aligned16(out);
    if (vin && vout)
      return launch_v<T, RP, true, true>(x, a, b, ids, scale, s, out, T_, n, d_in, r, d_out, block_t, st);
    if (vin)
      return launch_v<T, RP, true, false>(x, a, b, ids, scale, s, out, T_, n, d_in, r, d_out, block_t, st);
    if (vout)
      return launch_v<T, RP, false, true>(x, a, b, ids, scale, s, out, T_, n, d_in, r, d_out, block_t, st);
    return launch_v<T, RP, false, false>(x, a, b, ids, scale, s, out, T_, n, d_in, r, d_out, block_t, st);
  }
}

template <typename T>
cudaError_t launch_t(const void* x, const void* a, const void* b,
                     const int* ids, const float* scale, float* s,
                     void* out, int T_, int n, int d_in, int r, int d_out,
                     int block_t, cudaStream_t st) {
  if (r <= 4) return launch_rp<T, 4>(x, a, b, ids, scale, s, out, T_, n, d_in, r, d_out, block_t, st);
  if (r <= 8) return launch_rp<T, 8>(x, a, b, ids, scale, s, out, T_, n, d_in, r, d_out, block_t, st);
  if (r <= 16) return launch_rp<T, 16>(x, a, b, ids, scale, s, out, T_, n, d_in, r, d_out, block_t, st);
  if (r <= 32) return launch_rp<T, 32>(x, a, b, ids, scale, s, out, T_, n, d_in, r, d_out, block_t, st);
  if (r <= 64) return launch_rp<T, 64>(x, a, b, ids, scale, s, out, T_, n, d_in, r, d_out, block_t, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// s: fp32 scratch of (T / block_t) * ceil(block_t / 8) * RP * 8 floats, RP
// the rank padded to 4, 8, 16, 32 or 64 (the shrink, between the launches)
extern "C" int smlm_launch(const void* x, const void* a, const void* b,
                           const void* tile_ids, const void* tile_scale,
                           void* s, void* out, int T_, int n, int d_in,
                           int r, int d_out, int block_t, int dtype,
                           void* stream) {
  if (T_ <= 0 || d_out <= 0) return 0;
  if (block_t <= 0 || T_ % block_t != 0 || r <= 0 ||
      static_cast<long long>(T_ / block_t) * SMLM_CLUSTER > 0x7fffffffLL ||
      (d_out + 8 * SMLM_THREADS - 1) / (8 * SMLM_THREADS) > 65535)
    return cudaErrorInvalidValue;
  const int* ids = static_cast<const int*>(tile_ids);
  const float* sc = static_cast<const float*>(tile_scale);
  float* sp = static_cast<float*>(s);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == DT_F32)
    e = launch_t<float>(x, a, b, ids, sc, sp, out, T_, n, d_in, r, d_out, block_t, st);
  else if (dtype == DT_BF16)
    e = launch_t<__nv_bfloat16>(x, a, b, ids, sc, sp, out, T_, n, d_in, r, d_out, block_t, st);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

namespace {

template <typename T, int RP>
cudaError_t split_shrink_rp(const void* x, const void* a, const int* ids,
                            const float* scale, float* s, int T_, int n,
                            int d_in, int r, int block_t, cudaStream_t st) {
  if constexpr (!std::is_same<T, float>::value) {
    if (d_in % 8 == 0 && r == RP && RP >= 8 && aligned16(x) && aligned16(a))
      return launch_shrink<T, RP, true, true>(x, a, ids, scale, s, T_, n,
                                              d_in, r, block_t, st);
  }
  return launch_shrink<T, RP, false, true>(x, a, ids, scale, s, T_, n, d_in,
                                           r, block_t, st);
}

template <typename T, int RP>
cudaError_t split_expand_rp(const void* b, const int* ids, const float* scale,
                            const float* s, void* out, int T_, int n, int r,
                            int d_out, int block_t, cudaStream_t st) {
  if constexpr (!std::is_same<T, float>::value) {
    if (d_out % 8 == 0 && aligned16(b) && aligned16(out))
      return launch_expand<T, RP, true, true>(b, ids, scale, s, out, T_, n, r,
                                              d_out, block_t, false, st);
  }
  return launch_expand<T, RP, false, true>(b, ids, scale, s, out, T_, n, r,
                                           d_out, block_t, false, st);
}

#define SMLM_BY_RANK(FN, ...)                                  \
  (r <= 4 ? FN<T, 4>(__VA_ARGS__)                              \
   : r <= 8 ? FN<T, 8>(__VA_ARGS__)                            \
   : r <= 16 ? FN<T, 16>(__VA_ARGS__)                          \
   : r <= 32 ? FN<T, 32>(__VA_ARGS__)                          \
             : FN<T, 64>(__VA_ARGS__))

template <typename T>
cudaError_t split_shrink_t(const void* x, const void* a, const int* ids,
                           const float* scale, float* s, int T_, int n,
                           int d_in, int r, int block_t, cudaStream_t st) {
  return SMLM_BY_RANK(split_shrink_rp, x, a, ids, scale, s, T_, n, d_in, r,
                      block_t, st);
}

template <typename T>
cudaError_t split_expand_t(const void* b, const int* ids, const float* scale,
                           const float* s, void* out, int T_, int n, int r,
                           int d_out, int block_t, cudaStream_t st) {
  return SMLM_BY_RANK(split_expand_rp, b, ids, scale, s, out, T_, n, r, d_out,
                      block_t, st);
}

bool split_shape_ok(int T_, int r, int block_t) {
  return block_t > 0 && T_ % block_t == 0 && r > 0 && r <= 64 &&
         static_cast<long long>(T_ / block_t) * SMLM_CLUSTER <= 0x7fffffffLL;
}

}  // namespace

// The split shrink: s [T][r] fp32 = tile_scale * X @ A[tile_ids] (zeros on
// tiles of scale 0), summed over this call's d_in.
extern "C" int smlm_shrink_launch(const void* x, const void* a,
                                  const void* tile_ids,
                                  const void* tile_scale, void* s, int T_,
                                  int n, int d_in, int r, int block_t,
                                  int dtype, void* stream) {
  if (T_ <= 0) return 0;
  if (!split_shape_ok(T_, r, block_t) || d_in <= 0)
    return cudaErrorInvalidValue;
  const int* ids = static_cast<const int*>(tile_ids);
  const float* sc = static_cast<const float*>(tile_scale);
  float* sp = static_cast<float*>(s);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == DT_F32)
    e = split_shrink_t<float>(x, a, ids, sc, sp, T_, n, d_in, r, block_t, st);
  else if (dtype == DT_BF16)
    e = split_shrink_t<__nv_bfloat16>(x, a, ids, sc, sp, T_, n, d_in, r,
                                      block_t, st);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

// The split expand: out [T][d_out] = s @ B[tile_ids] (zeros on tiles of
// scale 0), s the plain fp32 [T][r] of `smlm_shrink_launch`, summed over
// the ranks that hold d_in.
extern "C" int smlm_expand_launch(const void* s, const void* b,
                                  const void* tile_ids,
                                  const void* tile_scale, void* out, int T_,
                                  int n, int r, int d_out, int block_t,
                                  int dtype, void* stream) {
  if (T_ <= 0 || d_out <= 0) return 0;
  if (!split_shape_ok(T_, r, block_t) ||
      (d_out + 8 * SMLM_THREADS - 1) / (8 * SMLM_THREADS) > 65535)
    return cudaErrorInvalidValue;
  const int* ids = static_cast<const int*>(tile_ids);
  const float* sc = static_cast<const float*>(tile_scale);
  const float* sp = static_cast<const float*>(s);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == DT_F32)
    e = split_expand_t<float>(b, ids, sc, sp, out, T_, n, r, d_out, block_t,
                              st);
  else if (dtype == DT_BF16)
    e = split_expand_t<__nv_bfloat16>(b, ids, sc, sp, out, T_, n, r, d_out,
                                      block_t, st);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

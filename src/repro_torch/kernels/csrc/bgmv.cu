// BGMV: per-token gathered multi-LoRA multiplication (the decode bucket).
//
//   y[t] = scale[t] * (x[t] @ A[ids[t]]) @ B[ids[t]]
//
// Port of the Pallas kernel repro/kernels/bgmv.py:30 (`bgmv`, body :20).
//
// Bound: latency.  At a decode tick's T = 8 tokens over a few adapters a
// call moves about 1.5 MB (x, each used adapter's A and B once, y), 0.44
// us of the card's bytes, while each launch and each dependent round trip
// to memory costs a sizeable part of a microsecond.  So the design keeps
// the chain of dependent steps short and every copy of a step in flight at
// once.
//
// A token with scale 0 or an id outside [0, n) uses no adapter and writes
// exact zeros.  Two launches:
//  * shrink: block (s, y) of the grid (ns, ceil(T / 8)) reduces slice s of
//    d_in for tokens 8y .. 8y + 7, one warp a token, lanes over 8-element
//    vectors of d (16-byte loads of x and of A's rows in bf16), the lanes'
//    sums reduced by shuffles in a fixed order, into fp32 partials
//    [ns][T][RP].  Above BG_CSUM_T tokens the blocks form clusters of
//    BG_CLUSTER along the slices, and each cluster sums its partials in
//    rank order through distributed shared memory before they leave the
//    chip: every expand block reads each token's partials, so for many
//    tokens those reads cost most, while for few the cluster barriers do;
//  * expand: block (c, y) owns d_out columns [c * BG_W, c * BG_W + BG_W)
//    for tokens 64y .. 64y + 63.  It lists the adapters they use (marks in
//    shared memory, compacted in slot order by one warp's ballots: no
//    atomics), copies each one's B slice into shared memory once (16-byte
//    `cp.async`), sums each token's ns partials in split order, scales
//    them (fp32: x @ A is never rounded to bf16), and applies each
//    adapter's slice to every token that names it, 8 columns a thread,
//    16-byte stores (masked at a ragged d_out edge).
// The expand is a programmatic dependent launch: its blocks start while
// the shrink runs, list the adapters and copy B, and wait
// (`griddepcontrol.wait`) only before they read the partials.
// No atomics: every sum has a fixed order, so two calls give the same bits.
// bf16 with d_in % 8 != 0 or r not in {4, 8, 16, 32, 64} (or an input not
// on a 16-byte boundary) takes element loads in the shrink; d_out % 8 != 0
// (or fp32, which only the reduced-size parity runs use) element copies of
// B and element stores.
//
// Split entries (`bgmv_shrink_launch`, `bgmv_expand_launch`): the same two
// kernels with PLAIN set, launched apart, so that a collective can sit
// between them (a rank's shrink over its slice of d_in is a partial sum,
// all-reduced over the mesh's model axis before the expand).  The split
// shrink always runs one cluster of BG_CLUSTER slices a token group and
// writes the cluster's sum, scaled, as a plain fp32 [T, r] (a token
// without an adapter as zeros); the split expand reads that (one partial,
// already scaled) and is an ordinary launch, not a programmatic dependent.
#include <cooperative_groups.h>

#include <algorithm>
#include <type_traits>

#include "kv_rows.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int BG_THREADS = 256;
constexpr int BG_WARPS = BG_THREADS / 32;   // shrink tokens a block
constexpr int BG_TOKENS = 64;               // expand tokens a block
constexpr int BG_SPLITS = 32;               // most shrink slices of d_in
constexpr int BG_CLUSTER = 8;               // shrink blocks summed on chip
constexpr int BG_CSUM_T = 16;               // ... above this many tokens
constexpr int BG_W = 64;                    // expand columns a block
constexpr int BG_MAX_SLOTS = 1024;          // adapters a bank may hold
constexpr size_t BG_B_SMEM = 96 * 1024;     // B slices staged at once

__device__ __forceinline__ bool has_adapter(int id, float sc, int n) {
  return sc != 0.f && id >= 0 && id < n;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

// Launch 1, the shrink: grid (ns, ceil(T / BG_WARPS)).  Warp w of block
// (s, y) computes token t = 8y + w's partial over d in [s * span, s * span
// + span): sum_d x[t][d] * A[id(t)][d][k] (zeros for a token without an
// adapter), and writes it to part[s][t][k]; with CSUM, clusters of
// BG_CLUSTER blocks along x (ns a multiple of BG_CLUSTER) sum theirs in
// rank order into part[s / BG_CLUSTER][t][k].  VIN (bf16, d_in % 8 == 0,
// r == RP): a lane takes 8 consecutive d at a time, x as one 16-byte load
// and A's 8 rows (8 * RP contiguous elements) as RP 16-byte loads, two
// such steps in flight; else element loads.
template <typename T, int RP, bool VIN, bool CSUM, bool PLAIN>
__global__ void __launch_bounds__(BG_THREADS)
bgmv_shrink(const T* __restrict__ x, const T* __restrict__ a,
            const int* __restrict__ ids, const float* __restrict__ scale,
            float* __restrict__ part, int T_, int n, int d_in, int r,
            int span) {
  // the expand may launch now: it waits for this grid before it reads part
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = blockIdx.y * BG_WARPS + warp;
  const int d0 = blockIdx.x * span, d1 = min(d_in, d0 + span);
  float acc[RP];
#pragma unroll
  for (int k = 0; k < RP; ++k) acc[k] = 0.f;
  const int id = t < T_ ? ids[t] : -1;
  if (t < T_ && has_adapter(id, scale[t], n)) {
    const T* X = x + static_cast<size_t>(t) * d_in;
    const T* A = a + static_cast<size_t>(id) * d_in * r;
    if constexpr (VIN) {
#pragma unroll 2
      for (int d = d0 + lane * 8; d < d1; d += 256) {
        float xf[8];
        unpack8(__ldg(reinterpret_cast<const uint4*>(X + d)), xf);
        const uint4* Ad =
            reinterpret_cast<const uint4*>(A + static_cast<size_t>(d) * RP);
#pragma unroll
        for (int qv = 0; qv < RP; ++qv) {   // elements 8 qv .. 8 qv + 7
          float av[8];
          unpack8(__ldg(Ad + qv), av);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[(8 * qv + j) % RP] =
                fmaf(xf[(8 * qv + j) / RP], av[j], acc[(8 * qv + j) % RP]);
        }
      }
    } else {
      for (int d = d0 + lane; d < d1; d += 32) {
        const float xv = repro::to_f(X[d]);
        const T* Ad = A + static_cast<size_t>(d) * r;
#pragma unroll
        for (int k = 0; k < RP; ++k)
          if (k < r) acc[k] = fmaf(xv, repro::to_f(Ad[k]), acc[k]);
      }
    }
  }
  __shared__ float pt[CSUM ? BG_WARPS : 1][RP];
#pragma unroll
  for (int k = 0; k < RP; ++k) {
    const float v = repro::warp_sum(acc[k]);
    if (CSUM && lane == 0) pt[warp][k] = v;
    if (!CSUM && lane == 0 && t < T_)
      part[(static_cast<size_t>(blockIdx.x) * T_ + t) * RP + k] = v;
  }
  if constexpr (CSUM) {
    cluster_arrive();   // every partial is written ...
    cluster_wait();     // ... and visible to the cluster
    cg::cluster_group cluster = cg::this_cluster();
    const int e = cluster.block_rank() * BG_THREADS + threadIdx.x;
    const int tw = e / RP, k = e - tw * RP;   // this thread's (token, k)
    const int te = blockIdx.y * BG_WARPS + tw;
    if (tw < BG_WARPS && te < T_) {
      float v = 0.f;
#pragma unroll
      for (int c = 0; c < BG_CLUSTER; ++c)
        v += *cluster.map_shared_rank(&pt[tw][k], c);
      if constexpr (PLAIN) {   // one cluster: the scaled sum, [T][r]
        if (k < r) {
          const float sc = scale[te];
          part[static_cast<size_t>(te) * r + k] =
              has_adapter(ids[te], sc, n) ? v * sc : 0.f;
        }
      } else {
        part[(static_cast<size_t>(blockIdx.x / BG_CLUSTER) * T_ + te) * RP +
             k] = v;
      }
    }
    cluster_arrive();   // done reading the peers' partials
    cluster_wait();     // the peers have read this block's
  }
}

// The expand block's tokens: per token its scale and the index of its
// adapter in `id` (-1: none), the used adapter ids in slot order, their
// count, and per slot whether a token uses it (then its index).
struct Groups {
  int slot[BG_TOKENS];
  float sc[BG_TOKENS];
  int id[BG_TOKENS];
  int n_used;
  int mark[BG_MAX_SLOTS];
};

// All threads call it; it synchronises.
__device__ __forceinline__ void group_tokens(const int* __restrict__ ids,
                                             const float* __restrict__ scale,
                                             int n, int t0, int nt,
                                             Groups& G) {
  for (int u = threadIdx.x; u < n; u += BG_THREADS) G.mark[u] = 0;
  int id = -1;   // thread t's token
  if (threadIdx.x < nt) {
    id = ids[t0 + threadIdx.x];
    const float sc = scale[t0 + threadIdx.x];
    G.sc[threadIdx.x] = sc;
    if (!has_adapter(id, sc, n)) id = -1;
  }
  __syncthreads();
  if (id >= 0) G.mark[id] = 1;   // the same value from every writer
  __syncthreads();
  if (threadIdx.x < 32) {   // compact the marks in slot order
    int used = 0;
    for (int base = 0; base < n; base += 32) {
      const int u = base + threadIdx.x;
      const bool m = u < n && G.mark[u];
      const unsigned bm = __ballot_sync(repro::FULL_MASK, m);
      if (m) {
        const int i = used + __popc(bm & ((1u << threadIdx.x) - 1u));
        G.mark[u] = i;
        G.id[i] = u;
      }
      used += __popc(bm);
    }
    if (threadIdx.x == 0) G.n_used = used;
  }
  __syncthreads();
  if (threadIdx.x < nt) G.slot[threadIdx.x] = id >= 0 ? G.mark[id] : -1;
  __syncthreads();
}

// Copy B's columns [c0, c0 + BG_W) of used adapters [u0, u1) into Bs
// [u1 - u0][RP][BG_W] (rows k >= r and columns >= d_out as zeros).  VOUT:
// 16-byte `cp.async` copies (d_out % 8 == 0, bf16), else element copies.
template <typename T, int RP, bool VOUT>
__device__ __forceinline__ void stage_b(const T* __restrict__ b,
                                        const Groups& G, int u0, int u1,
                                        int r, int d_out, int c0, T* Bs) {
  constexpr int NV = BG_W / 8;
  for (int e = threadIdx.x; e < (u1 - u0) * RP * NV; e += BG_THREADS) {
    const int row = e / NV, cv = e % NV;   // row = u * RP + k
    const int u = row / RP, k = row % RP;
    const int col = c0 + cv * 8;
    const T* src = b + (static_cast<size_t>(G.id[u0 + u]) * r + k) * d_out +
                   col;
    T* dst = Bs + row * BG_W + cv * 8;
    if constexpr (VOUT) {
      const bool ok = k < r && col < d_out;
      repro::cp_async16(dst, ok ? src : b, ok);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        dst[i] = k < r && col + i < d_out ? src[i] : repro::from_f<T>(0.f);
    }
  }
  repro::cp_async_commit();
}

// y for the block's tokens at columns [c0, c0 + BG_W) from the scaled
// shrink xa [BG_TOKENS][RP] and the staged B slices of used adapters [u0,
// u1) (the first batch also writes the zeros of tokens without one).
template <typename T, int RP, bool VOUT>
__device__ __forceinline__ void expand_slice(const Groups& G, const float* xa,
                                             const T* Bs, int u0, int u1,
                                             int t0, int nt, int r,
                                             int d_out, int c0,
                                             T* __restrict__ out) {
  constexpr int NV = BG_W / 8;
  for (int e = threadIdx.x; e < nt * NV; e += BG_THREADS) {
    const int t = e / NV, cv = e % NV;
    const int col = c0 + cv * 8;
    const int u = G.slot[t];
    if (col >= d_out || (u < 0 ? u0 > 0 : (u < u0 || u >= u1))) continue;
    float y[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) y[i] = 0.f;
    if (u >= 0) {
      const T* bs = Bs + (u - u0) * RP * BG_W + cv * 8;
      const float* xt = xa + t * RP;
#pragma unroll
      for (int k = 0; k < RP; ++k) {
        if (k < r) {
          float bv[8];
          if constexpr (VOUT) {
            unpack8(*reinterpret_cast<const uint4*>(bs + k * BG_W), bv);
          } else {
#pragma unroll
            for (int i = 0; i < 8; ++i) bv[i] = repro::to_f(bs[k * BG_W + i]);
          }
          const float xk = xt[k];
#pragma unroll
          for (int i = 0; i < 8; ++i) y[i] = fmaf(xk, bv[i], y[i]);
        }
      }
    }
    T* Y = out + static_cast<size_t>(t0 + t) * d_out + col;
    if constexpr (VOUT) {
      uint4 v;
      unsigned* w = reinterpret_cast<unsigned*>(&v);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(y[2 * i], y[2 * i + 1]);
        w[i] = *reinterpret_cast<const unsigned*>(&h);
      }
      *reinterpret_cast<uint4*>(Y) = v;
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (col + i < d_out) Y[i] = repro::from_f<T>(y[i]);
    }
  }
}

// Launch 2, a programmatic dependent of the shrink: grid (ceil(d_out /
// BG_W), ceil(T / BG_TOKENS)).  The used adapters' B slices go through
// shared memory in batches of ub (one batch unless many adapters at a wide
// rank); the first batch is copied before the wait.  NP: the most partials
// a token has (its loads are unrolled to it, each predicated on np).
template <typename T, int RP, bool VOUT, int NP, bool PLAIN>
__global__ void __launch_bounds__(BG_THREADS)
bgmv_expand(const float* part, const T* __restrict__ b,
            const int* __restrict__ ids, const float* __restrict__ scale,
            T* __restrict__ out, int T_, int n, int r, int d_out, int np,
            int ub) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Groups G;
  __shared__ float xa[BG_TOKENS * RP];
  T* Bs = reinterpret_cast<T*>(smem);
  const int t0 = blockIdx.y * BG_TOKENS, nt = min(BG_TOKENS, T_ - t0);
  const int c0 = blockIdx.x * BG_W;
  group_tokens(ids, scale, n, t0, nt, G);
  const int n_used = G.n_used;
  stage_b<T, RP, VOUT>(b, G, 0, min(n_used, ub), r, d_out, c0, Bs);
  asm volatile("griddepcontrol.wait;\n" ::: "memory");   // part is complete
  for (int e = threadIdx.x; e < nt * RP; e += BG_THREADS) {
    const int t = e / RP, k = e - t * RP;
    float v = 0.f;
    if (G.slot[t] >= 0 && k < r) {   // the np loads in flight, summed in order
      if constexpr (PLAIN) {   // the split shrink's scaled [T][r]
        v = __ldcg(part + static_cast<size_t>(t0 + t) * r + k);
      } else {
        const float* p = part + static_cast<size_t>(t0 + t) * RP + k;
        float pv[NP];
#pragma unroll
        for (int s = 0; s < NP; ++s)
          pv[s] = s < np ? __ldcg(p + static_cast<size_t>(s) * T_ * RP) : 0.f;
#pragma unroll
        for (int s = 0; s < NP; ++s) v += pv[s];
        v *= G.sc[t];
      }
    }
    xa[e] = v;
  }
  for (int u0 = 0; u0 == 0 || u0 < n_used; u0 += ub) {
    const int u1 = min(n_used, u0 + ub);
    if (u0 > 0) {
      __syncthreads();   // the previous batch's slices are read
      stage_b<T, RP, VOUT>(b, G, u0, u1, r, d_out, c0, Bs);
    }
    repro::cp_async_wait<0>();
    __syncthreads();
    expand_slice<T, RP, VOUT>(G, xa, Bs, u0, u1, t0, nt, r, d_out, c0, out);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, int RP, bool VIN, bool PLAIN>
cudaError_t launch_shrink(const void* x, const void* a, const int* ids,
                          const float* scale, float* part, int T_, int n,
                          int d_in, int r, int ns, bool csum,
                          cudaStream_t stream) {
  const int span = ((d_in + ns - 1) / ns + 7) / 8 * 8;
  cudaLaunchConfig_t sc = {};
  sc.gridDim = dim3(ns, (T_ + BG_WARPS - 1) / BG_WARPS);
  sc.blockDim = dim3(BG_THREADS);
  sc.stream = stream;
  cudaLaunchAttribute sa[1];
  sa[0].id = cudaLaunchAttributeClusterDimension;
  sa[0].val.clusterDim.x = BG_CLUSTER;
  sa[0].val.clusterDim.y = 1;
  sa[0].val.clusterDim.z = 1;
  sc.attrs = sa;
  sc.numAttrs = csum ? 1 : 0;
  cudaError_t e = cudaLaunchKernelEx(
      &sc,
      csum ? bgmv_shrink<T, RP, VIN, true, PLAIN>
           : bgmv_shrink<T, RP, VIN, false, PLAIN>,
      static_cast<const T*>(x), static_cast<const T*>(a), ids, scale, part,
      T_, n, d_in, r, span);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// np: partials a token (1 for PLAIN); pdl: launched as a programmatic
// dependent of the shrink just before it
template <typename T, int RP, bool VOUT, int NP, bool PLAIN>
cudaError_t launch_expand(const float* part, const void* b, const int* ids,
                          const float* scale, void* out, int T_, int n, int r,
                          int d_out, int np, bool pdl, cudaStream_t stream) {
  // ub: used adapters whose B slices fit BG_B_SMEM at once
  const int max_used = std::min(n, std::min(T_, BG_TOKENS));
  const size_t per = static_cast<size_t>(RP) * BG_W * sizeof(T);
  const int ub =
      std::max(1, std::min(max_used, static_cast<int>(BG_B_SMEM / per)));
  auto kern = bgmv_expand<T, RP, VOUT, NP, PLAIN>;
  cudaError_t e = repro::allow_smem(
      kern, ub * per + sizeof(Groups) + BG_TOKENS * RP * sizeof(float));
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t ec = {};
  ec.gridDim = dim3((d_out + BG_W - 1) / BG_W,
                    (T_ + BG_TOKENS - 1) / BG_TOKENS);
  ec.blockDim = dim3(BG_THREADS);
  ec.dynamicSmemBytes = ub * per;
  ec.stream = stream;
  cudaLaunchAttribute ea[1];
  ea[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  ea[0].val.programmaticStreamSerializationAllowed = 1;
  ec.attrs = ea;
  ec.numAttrs = pdl ? 1 : 0;
  e = cudaLaunchKernelEx(&ec, kern, part, static_cast<const T*>(b), ids,
                         scale, static_cast<T*>(out), T_, n, r, d_out, np,
                         ub);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T, int RP, bool VIN, bool VOUT>
cudaError_t launch_v(const void* x, const void* a, const void* b,
                     const int* ids, const float* scale, float* part,
                     void* out, int T_, int n, int d_in, int r, int d_out,
                     int ns, cudaStream_t stream) {
  const bool csum = T_ > BG_CSUM_T && ns % BG_CLUSTER == 0;
  cudaError_t e = launch_shrink<T, RP, VIN, false>(
      x, a, ids, scale, part, T_, n, d_in, r, ns, csum, stream);
  if (e != cudaSuccess) return e;
  // the cluster sums leave at most BG_SPLITS / BG_CLUSTER partials a token
  if (csum)
    return launch_expand<T, RP, VOUT, BG_SPLITS / BG_CLUSTER, false>(
        part, b, ids, scale, out, T_, n, r, d_out, ns / BG_CLUSTER, true,
        stream);
  return launch_expand<T, RP, VOUT, BG_SPLITS, false>(
      part, b, ids, scale, out, T_, n, r, d_out, ns, true, stream);
}

template <typename T, int RP>
cudaError_t launch_rp(const void* x, const void* a, const void* b,
                      const int* ids, const float* scale, float* part,
                      void* out, int T_, int n, int d_in, int r, int d_out,
                      int ns, cudaStream_t s) {
  if constexpr (std::is_same<T, float>::value) {
    return launch_v<T, RP, false, false>(x, a, b, ids, scale, part, out, T_, n, d_in, r, d_out, ns, s);
  } else {
    const bool vin = d_in % 8 == 0 && r == RP && aligned16(x) && aligned16(a);
    const bool vout = d_out % 8 == 0 && aligned16(b) && aligned16(out);
    if (vin && vout)
      return launch_v<T, RP, true, true>(x, a, b, ids, scale, part, out, T_, n, d_in, r, d_out, ns, s);
    if (vin)
      return launch_v<T, RP, true, false>(x, a, b, ids, scale, part, out, T_, n, d_in, r, d_out, ns, s);
    if (vout)
      return launch_v<T, RP, false, true>(x, a, b, ids, scale, part, out, T_, n, d_in, r, d_out, ns, s);
    return launch_v<T, RP, false, false>(x, a, b, ids, scale, part, out, T_, n, d_in, r, d_out, ns, s);
  }
}

template <typename T>
cudaError_t launch_t(const void* x, const void* a, const void* b,
                     const int* ids, const float* scale, float* part,
                     void* out, int T_, int n, int d_in, int r, int d_out,
                     int ns, cudaStream_t s) {
  if (r <= 4) return launch_rp<T, 4>(x, a, b, ids, scale, part, out, T_, n, d_in, r, d_out, ns, s);
  if (r <= 8) return launch_rp<T, 8>(x, a, b, ids, scale, part, out, T_, n, d_in, r, d_out, ns, s);
  if (r <= 16) return launch_rp<T, 16>(x, a, b, ids, scale, part, out, T_, n, d_in, r, d_out, ns, s);
  if (r <= 32) return launch_rp<T, 32>(x, a, b, ids, scale, part, out, T_, n, d_in, r, d_out, ns, s);
  if (r <= 64) return launch_rp<T, 64>(x, a, b, ids, scale, part, out, T_, n, d_in, r, d_out, ns, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// part: fp32 scratch of ns * T * RP floats, RP the rank padded to 4, 8,
// 16, 32 or 64 (the shrink's partials, between the launches); ns: the
// shrink's slices of d_in, at most BG_SPLITS (their sums on chip above
// BG_CSUM_T tokens when ns is a multiple of BG_CLUSTER)
extern "C" int bgmv_launch(const void* x, const void* a, const void* b,
                           const void* ids, const void* scale, void* part,
                           void* out, int T_, int n, int d_in, int r,
                           int d_out, int ns, int dtype, void* stream) {
  if (T_ <= 0 || d_out <= 0) return 0;
  if (r <= 0 || n <= 0 || n > BG_MAX_SLOTS || d_in <= 0 || ns <= 0 ||
      ns > BG_SPLITS ||
      (T_ + BG_WARPS - 1) / BG_WARPS > 65535)
    return cudaErrorInvalidValue;
  const int* i = static_cast<const int*>(ids);
  const float* sc = static_cast<const float*>(scale);
  float* p = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == DT_F32)
    e = launch_t<float>(x, a, b, i, sc, p, out, T_, n, d_in, r, d_out, ns, s);
  else if (dtype == DT_BF16)
    e = launch_t<bf16>(x, a, b, i, sc, p, out, T_, n, d_in, r, d_out, ns, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

namespace {

template <typename T, int RP>
cudaError_t split_shrink_rp(const void* x, const void* a, const int* ids,
                            const float* scale, float* s, int T_, int n,
                            int d_in, int r, cudaStream_t st) {
  if constexpr (!std::is_same<T, float>::value) {
    if (d_in % 8 == 0 && r == RP && aligned16(x) && aligned16(a))
      return launch_shrink<T, RP, true, true>(x, a, ids, scale, s, T_, n,
                                              d_in, r, BG_CLUSTER, true, st);
  }
  return launch_shrink<T, RP, false, true>(x, a, ids, scale, s, T_, n, d_in,
                                           r, BG_CLUSTER, true, st);
}

template <typename T, int RP>
cudaError_t split_expand_rp(const float* s, const void* b, const int* ids,
                            const float* scale, void* out, int T_, int n,
                            int r, int d_out, cudaStream_t st) {
  if constexpr (!std::is_same<T, float>::value) {
    if (d_out % 8 == 0 && aligned16(b) && aligned16(out))
      return launch_expand<T, RP, true, 1, true>(s, b, ids, scale, out, T_, n,
                                                 r, d_out, 1, false, st);
  }
  return launch_expand<T, RP, false, 1, true>(s, b, ids, scale, out, T_, n, r,
                                              d_out, 1, false, st);
}

#define BGMV_BY_RANK(FN, ...)                                  \
  (r <= 4 ? FN<T, 4>(__VA_ARGS__)                              \
   : r <= 8 ? FN<T, 8>(__VA_ARGS__)                            \
   : r <= 16 ? FN<T, 16>(__VA_ARGS__)                          \
   : r <= 32 ? FN<T, 32>(__VA_ARGS__)                          \
             : FN<T, 64>(__VA_ARGS__))

template <typename T>
cudaError_t split_shrink_t(const void* x, const void* a, const int* ids,
                           const float* scale, float* s, int T_, int n,
                           int d_in, int r, cudaStream_t st) {
  return BGMV_BY_RANK(split_shrink_rp, x, a, ids, scale, s, T_, n, d_in, r,
                      st);
}

template <typename T>
cudaError_t split_expand_t(const float* s, const void* b, const int* ids,
                           const float* scale, void* out, int T_, int n,
                           int r, int d_out, cudaStream_t st) {
  return BGMV_BY_RANK(split_expand_rp, s, b, ids, scale, out, T_, n, r, d_out,
                      st);
}

bool split_ok(int T_, int n, int r) {
  return r > 0 && r <= 64 && n > 0 && n <= BG_MAX_SLOTS &&
         (T_ + BG_WARPS - 1) / BG_WARPS <= 65535;
}

}  // namespace

// The split shrink: s [T][r] fp32 = scale * x @ A[ids] (zeros for a token
// without an adapter), summed over this call's d_in.
extern "C" int bgmv_shrink_launch(const void* x, const void* a,
                                  const void* ids, const void* scale,
                                  void* s, int T_, int n, int d_in, int r,
                                  int dtype, void* stream) {
  if (T_ <= 0) return 0;
  if (!split_ok(T_, n, r) || d_in <= 0) return cudaErrorInvalidValue;
  const int* i = static_cast<const int*>(ids);
  const float* sc = static_cast<const float*>(scale);
  float* sp = static_cast<float*>(s);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == DT_F32)
    e = split_shrink_t<float>(x, a, i, sc, sp, T_, n, d_in, r, st);
  else if (dtype == DT_BF16)
    e = split_shrink_t<bf16>(x, a, i, sc, sp, T_, n, d_in, r, st);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

// The split expand: out [T][d_out] = s @ B[ids] (zeros for a token without
// an adapter), s the plain fp32 [T][r] of `bgmv_shrink_launch`, summed over
// the ranks that hold d_in.
extern "C" int bgmv_expand_launch(const void* s, const void* b,
                                  const void* ids, const void* scale,
                                  void* out, int T_, int n, int r, int d_out,
                                  int dtype, void* stream) {
  if (T_ <= 0 || d_out <= 0) return 0;
  if (!split_ok(T_, n, r)) return cudaErrorInvalidValue;
  const int* i = static_cast<const int*>(ids);
  const float* sc = static_cast<const float*>(scale);
  const float* sp = static_cast<const float*>(s);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == DT_F32)
    e = split_expand_t<float>(sp, b, i, sc, out, T_, n, r, d_out, st);
  else if (dtype == DT_BF16)
    e = split_expand_t<bf16>(sp, b, i, sc, out, T_, n, r, d_out, st);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

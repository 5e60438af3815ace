// Split-K (flash-decoding) paged attention: partials, then an LSE merge.
//
// Port of the Pallas kernel repro/kernels/splitk.py:107
// (`paged_verify_attention_splitk`, body `_splitk_kernel` :64) and of its
// jnp epilogue `lse_merge` (:40).  A long table walked by one thread block
// per (request, KV head) leaves most SMs idle at small batch; here the walk
// is cut into `ns` independent runs of npb = ceil(nbt / ns) table entries,
// grid (request, KV head, split), so B * g * ns thread blocks fill the card
// (the model picks ns from that count: `kernels/autotune.py`).  Each run
// walks its entries for every query row of the group (m heads x Sq chunk
// positions in one thread block, so no K/V tile is read twice), with the
// tiles streaming through a `cp.async` ring; the table is padded with null
// entries past nbt, which the mask excludes, so the walk stops at the block
// holding key pos + lens - 1.  The element type picks the walk at compile
// time: bf16 the tensor-core walk of `tile_walk.cuh` (the chunk is a query
// tile of 64 / m positions x m heads; a longer chunk takes several), fp32
// the CUDA-core walk of `paged_walk.cuh` (several rows a warp; more than 64
// rows take several thread blocks): grid z = split x (query tile or row
// group).  Each run writes its un-normalized fp32 partial (acc, m, l); a run
// with no valid key writes (0, NEG_INF, 0).
//
// The merge stays a second launch, one warp per (request, chunk row, query
// head), with weights exp(min(m - m_max, 0)) and l clamped at 1e-30, so
// all-empty rows give zeros: folding it into the last run of each (request,
// KV head) would need a global counter reset per call and a fence per block,
// for a pass over ns * hd floats a row that costs a few microseconds.
// Decode is the Sq = 1, lens = 1 case.
#include "paged_walk.cuh"

namespace {

using bf16 = __nv_bfloat16;

// grid (B, g, split x (row groups or query tiles)); HD: the bf16 walk's
// head dim (0 for fp32)
template <typename T, int HD>
__global__ void __launch_bounds__(repro::ChunkThreads<T, HD>::value)
splitk_partials_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp,
                       const int* __restrict__ tables,
                       const int* __restrict__ pos,
                       const int* __restrict__ lens,
                       float* __restrict__ o_part, float* __restrict__ m_part,
                       float* __restrict__ l_part, int h, int g, int hd,
                       int bs, int nbt, int sq, int ns, int npb, int nz,
                       int per, int rpw, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int s = blockIdx.z / nz;
  const int z = blockIdx.z - s * nz;
  const int m = h / g;
  const int p = pos[b];
  const int kend = p + lens[b];
  const int nblk = repro::walk_blocks(kend, bs, nbt);
  const int lo = s * npb;
  const int hi = min(lo + npb, nblk);   // empty when lo >= nblk
  const repro::PagedRows kv{tables + static_cast<size_t>(b) * nbt, bs, g, hd};
  if constexpr (std::is_same<T, float>::value) {
    const int g0 = z * per;
    const int rows = min(per, m * sq - g0);
    const repro::WalkState st = repro::chunk_walk<T>(
        q, kp, vp, kv, repro::ChunkMask{p, kend}, smem, b, kvh, h, g, sq, g0,
        rows, rpw, lo, hi, scale);
    const int lane = threadIdx.x & 31;
    const int ni = hd / 32;
#pragma unroll
    for (int r = 0; r < repro::WALK_RPW; ++r) {
      if (r >= st.nr) continue;
      const int gr = g0 + st.row0 + r;
      const int qh = gr / sq, i = gr - qh * sq;
      // [B, ns, sq, h] row of this (request, split, chunk row, query head)
      const size_t row = ((static_cast<size_t>(b) * ns + s) * sq + i) * h +
                         kvh * m + qh;
      float* ob = o_part + row * hd + lane;
#pragma unroll
      for (int k = 0; k < repro::WALK_MAX_NI; ++k)
        if (k < ni) ob[32 * k] = st.acc[r][k];
      if (lane == 0) {
        m_part[row] = st.m[r];
        l_part[row] = st.l[r];
      }
    }
  } else {
    // keys of this run's blocks, below pos + lens
    const repro::PosMask<true> mask{lo * bs, min(hi * bs, kend)};
    repro::tile_walk<HD, repro::CHUNK_TILE>(
        q, kp, vp, kv, mask,
        repro::PartialOut{o_part, m_part, l_part, ns, s, sq, h},
        reinterpret_cast<bf16*>(smem), b, z, kvh, sq, h, g, p, scale);
  }
}

// One warp per (request, chunk row, query head): combine its ns partials.
template <typename T>
__global__ void lse_merge_kernel(const float* __restrict__ o_part,
                                 const float* __restrict__ m_part,
                                 const float* __restrict__ l_part,
                                 T* __restrict__ out, int B, int ns, int rows,
                                 int hd) {
  const int lane = threadIdx.x & 31;
  const long long wid =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (wid >= static_cast<long long>(B) * rows) return;
  const int b = static_cast<int>(wid / rows);
  const int r = static_cast<int>(wid - static_cast<long long>(b) * rows);
  // rows = sq * h; partial row (b, s, r) sits at (b * ns + s) * rows + r
  float m_max = repro::NEG_INF;
  for (int s = lane; s < ns; s += 32)
    m_max = fmaxf(m_max, m_part[(static_cast<size_t>(b) * ns + s) * rows + r]);
  m_max = repro::warp_max(m_max);
  float l_tot = 0.f;
  float acc[repro::WALK_MAX_NI];
#pragma unroll
  for (int k = 0; k < repro::WALK_MAX_NI; ++k) acc[k] = 0.f;
  const int ni = hd / 32;
  for (int s = 0; s < ns; ++s) {
    const size_t row = (static_cast<size_t>(b) * ns + s) * rows + r;
    const float wgt = expf(fminf(m_part[row] - m_max, 0.f));
    l_tot += l_part[row] * wgt;
    const float* op = o_part + row * hd + lane;
#pragma unroll
    for (int k = 0; k < repro::WALK_MAX_NI; ++k)
      if (k < ni) acc[k] += op[32 * k] * wgt;
  }
  const float l = fmaxf(l_tot, 1e-30f);
  T* ob = out + (static_cast<size_t>(b) * rows + r) * hd + lane;
#pragma unroll
  for (int k = 0; k < repro::WALK_MAX_NI; ++k)
    if (k < ni) ob[32 * k] = repro::from_f<T>(acc[k] / l);
}

template <typename T>
cudaError_t partials_t(const void* q, const void* kp, const void* vp,
                       const int* tables, const int* pos, const int* lens,
                       float* o_part, float* m_part, float* l_part, int B,
                       int h, int g, int hd, int bs, int nbt, int sq, int ns,
                       float scale, cudaStream_t stream) {
  const int npb = (nbt + ns - 1) / ns;
  auto go = [&](auto HD, int nz, int threads, size_t smem, int per,
                int rpw) {
    if (static_cast<long long>(ns) * nz > 65535) return cudaErrorInvalidValue;
    auto kern = splitk_partials_kernel<T, decltype(HD)::value>;
    cudaError_t e = repro::allow_smem(kern, smem);
    if (e != cudaSuccess) return e;
    kern<<<dim3(B, g, ns * nz), threads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(kp),
        static_cast<const T*>(vp), tables, pos, lens, o_part, m_part, l_part,
        h, g, hd, bs, nbt, sq, ns, npb, nz, per, rpw, scale);
    return cudaGetLastError();
  };
  return repro::launch_chunk<T>(h, g, hd, bs, sq, go);
}

template <typename T>
cudaError_t merge_t(const float* o_part, const float* m_part,
                    const float* l_part, void* out, int B, int ns, int rows,
                    int hd, cudaStream_t stream) {
  const int threads = 128;  // four warps, one (request, row) each
  const long long warps = static_cast<long long>(B) * rows;
  const long long blocks = (warps * 32 + threads - 1) / threads;
  lse_merge_kernel<T><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      o_part, m_part, l_part, static_cast<T*>(out), B, ns, rows, hd);
  return cudaGetLastError();
}

bool bad_shape(int g, int h, int hd, int bs, int nbt) {
  return g <= 0 || h % g != 0 || hd % 32 != 0 ||
         hd > 32 * repro::WALK_MAX_NI || bs <= 0 || nbt <= 0;
}

}  // namespace

extern "C" int splitk_partials_launch(const void* q, const void* k_pool,
                                      const void* v_pool, const void* tables,
                                      const void* pos, const void* lens,
                                      void* o_part, void* m_part,
                                      void* l_part, int B, int sq, int h,
                                      int g, int hd, int bs, int nbt, int ns,
                                      float scale, int dtype, void* stream) {
  if (B <= 0 || sq <= 0) return 0;
  if (bad_shape(g, h, hd, bs, nbt) || ns <= 0) return cudaErrorInvalidValue;
  const int* tb = static_cast<const int*>(tables);
  const int* ps = static_cast<const int*>(pos);
  const int* ln = static_cast<const int*>(lens);
  float* o = static_cast<float*>(o_part);
  float* m = static_cast<float*>(m_part);
  float* l = static_cast<float*>(l_part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == DT_F32)
    e = partials_t<float>(q, k_pool, v_pool, tb, ps, ln, o, m, l, B, h, g, hd,
                          bs, nbt, sq, ns, scale, s);
  else if (dtype == DT_BF16)
    e = partials_t<bf16>(q, k_pool, v_pool, tb, ps, ln, o, m, l, B, h, g, hd,
                         bs, nbt, sq, ns, scale, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

extern "C" int lse_merge_launch(const void* o_part, const void* m_part,
                                const void* l_part, void* out, int B, int ns,
                                int rows, int hd, int dtype, void* stream) {
  if (B <= 0 || rows <= 0) return 0;
  if (ns <= 0 || hd % 32 != 0 || hd > 32 * repro::WALK_MAX_NI)
    return cudaErrorInvalidValue;
  const float* o = static_cast<const float*>(o_part);
  const float* m = static_cast<const float*>(m_part);
  const float* l = static_cast<const float*>(l_part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == DT_F32)
    e = merge_t<float>(o, m, l, out, B, ns, rows, hd, s);
  else if (dtype == DT_BF16)
    e = merge_t<bf16>(o, m, l, out, B, ns, rows, hd, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
